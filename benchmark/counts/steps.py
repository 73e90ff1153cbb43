"""The operations one training step needs, for the utilization metrics:
the blend forward and backward at every evaluated (pair, pixel), the
per-primitive preprocess, the image losses and Adam over every live
parameter (see ``blend.py`` for each constant)."""

from __future__ import annotations

from . import blend as B


def mesh_train_step(c: dict) -> float:
    """A "3D" rich step of the mesh recipe on one view: ``c`` holds evals,
    pixels, prims (valid triangles) and params (live parameters), gamma1
    and the geometry flag."""
    g1 = c["gamma1"]
    ops = B.b1_ops_dense("3D", True, g1, c["evals"])
    ops += (B.BWD_OPS_PER_EVAL["3D"][g1] + B.RICH_BWD_OPS["3D"]) * c["evals"]
    ops += B.PRIM_OPS["3D"] * c["prims"]
    ops += (B.SSIM_OPS_PER_PIXEL_CHANNEL + B.L1_OPS_PER_PIXEL_CHANNEL) * 3 * c["pixels"]
    if c.get("geometry"):
        ops += B.DEPTH_NORMAL_OPS_PER_PIXEL * c["pixels"]
    ops += B.ADAM_OPS_PER_PARAM * c["params"]
    return float(ops)



def scaffold_train_step(c: dict) -> float:
    """A ScaffoldGS step on one view: the five heads over the alive anchors
    (two products each, forward and backward), the decode's elementwise
    terms and the EWA preprocess of their k offsets, the prefilter of the
    anchors, the "GS" blend forward and backward at every evaluated (pair,
    pixel), the image losses and Adam over every parameter."""
    alive, k = c["alive"], c["slots"] // c["anchors"]
    heads = 2 * (5 * c["feat_dim"] * c["hidden"] + c["hidden"] * c["head_out"])
    ops = 3 * heads * alive
    ops += 3 * (B.SCAFFOLD_DECODE_OPS + B.PRIM_OPS_FWD["GS"]) * alive * k
    ops += B.PRIM_OPS_FWD["GS"] * alive
    ops += (B.FWD_OPS_PER_EVAL["GS"][c["gamma1"]] + B.BWD_OPS_PER_EVAL["GS"][c["gamma1"]]) * c["evals"]
    ops += (B.SSIM_OPS_PER_PIXEL_CHANNEL + B.L1_OPS_PER_PIXEL_CHANNEL) * 3 * c["pixels"]
    ops += B.ADAM_OPS_PER_PARAM * c["params"]
    return float(ops)


def scaffold_render_frame(c: dict) -> float:
    """A ScaffoldGS frame with no backward: the heads' forward products
    over the alive anchors, the decode and EWA preprocess of their k
    offsets, the prefilter, and B1 ("GS" rich) at every evaluated (pair,
    pixel)."""
    alive, k = c["alive"], c["slots"] // c["anchors"]
    heads = 2 * (5 * c["feat_dim"] * c["hidden"] + c["hidden"] * c["head_out"])
    ops = heads * alive + (B.SCAFFOLD_DECODE_OPS + B.PRIM_OPS_FWD["GS"]) * alive * k
    ops += B.PRIM_OPS_FWD["GS"] * alive
    ops += B.b1_ops_dense("GS", True, c["gamma1"], c["evals"])
    return float(ops)
