"""The whole frame's share of the card's float32 peak (67 TFLOP/s, H100
SXM at 700 W): the operations a frame needs (``counts/steps.py:
scaffold_render_frame``, ``step_ops``) over the wall time of a frame in
the unprofiled window (its frames and seconds), in percent. The profiled
frames are not the divisor: the profiler slows the host."""

from benchmark.counts import blend as B


def read(rec: dict):
    c = rec.get("counts")
    if rec.get("kind") != "render" or not c or not rec.get("frames") or not rec.get("wall_s"):
        return None
    return 100.0 * c["step_ops"] / (rec["wall_s"] / rec["frames"] * B.F32_OPS_PER_S)
