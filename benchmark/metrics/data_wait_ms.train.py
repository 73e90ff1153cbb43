"""Host ms a training step spends in ``Trainer._next_batch`` (the data
loader: the prefetch queue and, before its cache holds a view, the PNG
decode), the mean over every step of the window, from the harness's span."""


def read(rec: dict):
    v = rec.get("spans", {}).get("data") if rec.get("kind") == "train" else None
    return sum(v) / len(v) if v else None
