"""Kernel B2 (``blend_backward``, the blend's backward) against its
roofline: the least time its frame's work needs (``counts/blend.py:b2`` on
the last traced step's frame, recounted after the window) over its mean
device time a step in the traced window, in percent."""

from benchmark.counts import blend as B


def read(rec: dict):
    if rec.get("kind") != "train":
        return None
    t = sum(s for n, s in rec["trace"]["by_op"].items() if "blend_backward" in n)
    c = rec.get("counts")
    if t <= 0 or not c or not rec.get("traced_steps"):
        return None
    ops, nbytes = B.b2(c["variant"], c["rich"], c["gamma1"], c["evals"], c["pairs"],
                       c["tiles"], c["pixels"])
    return 100.0 * B.bound_s(nbytes, ops) / (t / rec["traced_steps"])
