"""Host ms a training step spends in ``_model_update`` (the ADC blocks and
anchor updates on their cadence, the schedules every step), the mean over
every step of the window, from the harness's span."""


def read(rec: dict):
    v = rec.get("spans", {}).get("update") if rec.get("kind") == "train" else None
    return sum(v) / len(v) if v else None
