"""Kernel B1 (``blend_forward``, "GS" rich) against its roofline in the
render loop: the least time a frame's blend needs (``counts/blend.py:b1``
on a traced frame's work) over B1's mean device time a frame in the traced
frames, in percent."""

from benchmark.counts import blend as B


def read(rec: dict):
    if rec.get("kind") != "render":
        return None
    t = sum(s for n, s in rec["trace"]["by_op"].items() if "blend_forward" in n)
    c = rec.get("counts")
    if t <= 0 or not c or not rec.get("traced_frames"):
        return None
    ops, nbytes = B.b1(c["variant"], c["rich"], c["gamma1"], c["evals"], c["pairs"], c["tiles"],
                       c["pixels"])
    return 100.0 * B.bound_s(nbytes, ops) / (t / rec["traced_frames"])
