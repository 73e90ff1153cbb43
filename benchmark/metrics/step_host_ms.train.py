"""Host ms a training step spends in ``_train_step_dp`` (its enqueue, and
any synchronize inside it), the mean over every step of the window, from
the harness's span."""


def read(rec: dict):
    v = rec.get("spans", {}).get("step") if rec.get("kind") == "train" else None
    return sum(v) / len(v) if v else None
