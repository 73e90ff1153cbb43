"""The whole training step's share of the card's float32 peak (67 TFLOP/s,
H100 SXM at 700 W): the operations each step needs (``counts/steps.py`` on
the last traced step's frame, ``step_ops``) over the wall time of a step
in the unprofiled window (its steps and seconds, every step counted), in
percent. The profiled steps are not the divisor: the profiler slows the
host."""

from benchmark.counts import blend as B


def read(rec: dict):
    c = rec.get("counts")
    if rec.get("kind") != "train" or not c or not rec.get("steps") or not rec.get("wall_s"):
        return None
    return 100.0 * c["step_ops"] / (rec["wall_s"] / rec["steps"] * B.F32_OPS_PER_S)
