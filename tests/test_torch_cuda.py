"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips when ``torch.cuda.is_available()`` is
false (decided in a fixture, never at import). On a machine with a GPU:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repository's conftest configures JAX, which the GPU
machine does not need.) chip_smoke.py checks the same kernels at the
800x800 / 100k-triangle bench shapes (and the 3D kernels at 1600x1600);
these tests cover what it does not: partial tiles, gamma != 1, opaque
stacks, NaN tails and the launch counts per variant.
"""

import numpy as np
import pytest
import torch

from triangle_splatting_tpu_torch.ops.binning import sort_pairs
from triangle_splatting_tpu_torch.ops.cuda import blend as KB
from triangle_splatting_tpu_torch.ops.cuda import streams as KS
from triangle_splatting_tpu_torch.ops.projection import (RasterSettings, preprocess_2d,
                                                         preprocess_3d)
from triangle_splatting_tpu_torch.ops.rasterize import (rasterize, triangle_field_matrix,
                                                        triangle_field_matrix_3d)
from triangle_splatting_tpu_torch.utils.testing import make_camera, make_random_scene

pytestmark = pytest.mark.cuda

CASES = [
    # (P, W, H, seed, gamma, opacity_range)
    (300, 64, 64, 0, 1.0, (0.3, 0.95)),
    (300, 64, 64, 1, 1.0, (0.8, 0.95)),    # opaque stack: T crosses 1e-4
    (400, 80, 48, 2, 3.7, (0.3, 0.95)),    # partial tiles, gamma != 1
    (400, 70, 90, 3, 50.0, (0.3, 0.95)),   # solidify gamma
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def pipeline_inputs(case, dev, variant="2D"):
    """Sorted pairs and packed fields of a random scene, on ``dev``."""
    P, W, H, seed, gamma, orange = case
    s = make_random_scene(P, seed=seed, opacity_range=orange)
    st = RasterSettings(image_width=W, image_height=H, rich_info=False,
                        rasterizer_type=variant)
    cam = make_camera(W, H, device=dev)
    op = torch.as_tensor(s["opacity"]).to(dev)
    pre = preprocess_2d if variant == "2D" else preprocess_3d
    with torch.no_grad():
        prep = pre(torch.as_tensor(s["vertex"]).to(dev), torch.zeros((P, 2), device=dev),
                   torch.as_tensor(s["rgb"]).to(dev), cam.world_view,
                   cam.full_proj, cam.tan_fovx, cam.tan_fovy, st,
                   opacity=op, gamma=torch.tensor(gamma, device=dev))
        sp = sort_pairs(prep, st, 128 * 40)
        assert not bool(sp.overflow)
        pair_tri = KS.relayout_pairs_plain(sp.sorted_tri, sp.raw_starts, sp.astarts,
                                           sp.tile_counts, sp.ma)
        if variant == "2D":
            fmat = triangle_field_matrix(prep, op)
        else:
            fmat = triangle_field_matrix_3d(prep, op, cam.tan_fovx, cam.tan_fovy, W, H)
        fields = torch.where((pair_tri >= 0)[:, None], fmat[pair_tri.clamp_min(0).long()],
                             torch.zeros((), device=dev)).t().contiguous()
    params = torch.tensor([gamma, 1.0, 0.9, 0.8, 10.0, 0, 0, 0], device=dev)
    return sp, pair_tri, fields, params


@pytest.mark.parametrize("case", CASES)
def test_relayout_kernel_exact(dev, case):
    sp, pair_tri, _, _ = pipeline_inputs(case, dev)
    n = KS.relayout_pairs.launches
    got = KS.relayout_pairs(sp.sorted_tri, sp.raw_starts, sp.astarts, sp.tile_counts, sp.ma)
    torch.cuda.synchronize()
    assert KS.relayout_pairs.launches == n + 1
    assert torch.equal(got, pair_tri)


CASES_3D = [
    (300, 64, 64, 0, 1.0, (0.3, 0.95)),
    (300, 64, 64, 1, 1.0, (0.8, 0.95)),    # opaque stack: T crosses 1e-4
    (400, 80, 48, 2, 7.3, (0.3, 0.95)),    # partial tiles, gamma != 1
    (400, 70, 90, 3, 50.0, (0.3, 0.95)),   # solidify gamma
]


@pytest.mark.parametrize("variant,case", [
    *(pytest.param("2D", c, id=f"case{i}") for i, c in enumerate(CASES)),
    *(pytest.param("3D", c, id=f"3d-case{i}") for i, c in enumerate(CASES_3D))])
def test_blend_rich_kernels_match_plain(dev, variant, case):
    """B1/B2 with rich info against their plain versions on the card: the
    rich forward's color, final_T and n_contrib bit-identical to the
    kernel without rich info, its depth and normal within rel 1e-5 of
    their max (sums in another order); the rich backward's live rows
    (16 "2D", 14 "3D") rel 1e-4 of each row's max; launches count under
    "<variant>_rich"."""
    P, W, H, seed, gamma, orange = case
    live = KB.LIVE_GRAD_ROWS[(variant, True)]
    sp, _, fields, params = pipeline_inputs(case, dev, variant)
    if variant == "3D":
        cam = make_camera(W, H, device=dev)
        params[5], params[6] = W / (2.0 * cam.tan_fovx), H / (2.0 * cam.tan_fovy)
    geo = dict(image_width=W, image_height=H, tile_h=32, tile_w=32, variant=variant)
    args = (fields, sp.astarts, sp.tile_counts, params)
    n_fwd, n_bwd = dict(KB.blend_forward.launches), dict(KB.blend_backward.launches)
    out = KB.blend_forward(*args, rich=True, **geo)
    off = KB.blend_forward(*args, **geo)
    ref = KB.blend_forward_plain(*args, rich=True, **geo)
    torch.cuda.synchronize()
    form = f"{variant}_rich"
    assert KB.blend_forward.launches == {**n_fwd, form: n_fwd[form] + 1,
                                         variant: n_fwd[variant] + 1}
    for k in (0, 3, 4):
        assert torch.equal(out[k], off[k]), k
    assert torch.equal(out[4], ref[4])
    for k in (0, 3):
        assert float((out[k] - ref[k]).abs().max()) <= 1e-5
    for k in (1, 2):
        scale = float(ref[k].abs().max())
        assert float((out[k] - ref[k]).abs().max()) <= 1e-5 * scale, k
    assert float(out[2].abs().max()) > 0

    gen = torch.Generator().manual_seed(seed)
    n = H * W
    cots = [(torch.randn(shape, generator=gen) / (c * n)).to(dev)
            for shape, c in (((3, H, W), 3), ((H, W), 1), ((H, W), 1), ((3, H, W), 3))]
    bw = args + (out[3], out[4], *cots)
    got = KB.blend_backward(*bw, rich=True, **geo)
    want = KB.blend_backward_plain(*bw, rich=True, **geo)
    torch.cuda.synchronize()
    assert KB.blend_backward.launches == {**n_bwd, form: n_bwd[form] + 1}
    assert bool(torch.isfinite(got).all())
    scale = want[:live].abs().amax(dim=1).clamp_min(1e-30)
    assert float(((got[:live] - want[:live]).abs().amax(dim=1) / scale).max()) <= 1e-4
    assert not bool(got[live:].any())               # "2D": all 16 rows are live
    assert float(got[live - 1].abs().max()) > 0     # the depth row reached the kernel
    ts, tc = sp.astarts.tolist(), sp.tile_counts.tolist()
    for t in range(len(tc)):
        assert not bool(got[:, ts[t] + tc[t]:ts[t + 1]].any())


@pytest.mark.parametrize("variant", ["2D", "3D"])
def test_rasterize_rich_cuda_matches_cpu(dev, variant):
    """rasterize(rich_info=True) on the card vs its plain versions on the
    CPU, forward and gradients of a loss that reads render, depth and
    normal, at gamma 1 ("2D") and 50 ("3D")."""
    s = make_random_scene(300, seed=7)
    st = RasterSettings(image_width=96, image_height=64, rich_info=True,
                        rasterizer_type=variant)
    gen = torch.Generator().manual_seed(1)
    target = torch.rand((3, 64, 96), generator=gen)
    w_d = torch.randn((64, 96), generator=gen) / (64 * 96)
    w_n = torch.randn((3, 64, 96), generator=gen) / (64 * 96)
    gamma = 1.0 if variant == "2D" else 50.0
    res = {}
    for d in ("cpu", dev):
        leaves = [torch.tensor(s[k], device=d, requires_grad=True)
                  for k in ("vertex", "opacity", "rgb")]
        out = rasterize(leaves[0], leaves[1], None, make_camera(96, 64, device=d), st,
                        gamma=gamma, background=torch.ones(3, device=d), bg_depth=10.0,
                        colors=leaves[2])
        loss = (((out["render"] - target.to(d)) ** 2).mean() + (out["depth"] * w_d.to(d)).sum()
                + (out["normal"] * w_n.to(d)).sum())
        res[str(d)] = (out, torch.autograd.grad(loss, leaves))
    (oc, gc), (og, gg) = res["cpu"], res["cuda"]
    for k in ("render", "depth", "normal"):
        a, b = og[k].detach().cpu(), oc[k].detach()
        assert float((a - b).abs().max()) <= 1e-3 * max(1.0, float(b.abs().max())), k
    assert int((og["n_contrib"].cpu() != oc["n_contrib"]).sum()) <= 2
    # the budgets of test_rasterize_3d_cuda_matches_cpu
    for a, b, tol in zip(gg, gc, (2e-2, 1e-3, 1e-3)):
        assert float((a.cpu() - b).norm() / b.norm()) <= tol


@pytest.mark.parametrize("variant,case", [
    *(pytest.param("2D", c, id=f"case{i}") for i, c in enumerate(CASES)),
    *(pytest.param("3D", c, id=f"3d-case{i}") for i, c in enumerate(CASES_3D))])
def test_blend_kernels_match_plain(dev, variant, case):
    """B1/B2 against their plain versions on the card, per variant ("3D":
    the quotients a = A/D with a correctly rounded divide); the launches
    count under the variant that ran."""
    P, W, H, seed, gamma, orange = case
    live = KB.LIVE_GRAD_ROWS[(variant, False)]
    sp, _, fields, params = pipeline_inputs(case, dev, variant)
    geo = dict(image_width=W, image_height=H, tile_h=32, tile_w=32, variant=variant)
    args = (fields, sp.astarts, sp.tile_counts, params)
    n_fwd, n_bwd = dict(KB.blend_forward.launches), dict(KB.blend_backward.launches)
    out = KB.blend_forward(*args, **geo)
    ref = KB.blend_forward_plain(*args, **geo)
    torch.cuda.synchronize()
    assert KB.blend_forward.launches == {**n_fwd, variant: n_fwd[variant] + 1}
    # same roundings per (pair, pixel); only the color sums are reordered
    for k in (0, 1, 3):
        assert float((out[k] - ref[k]).abs().max()) <= 1e-5 * (10.0 if k == 1 else 1.0)
    assert torch.equal(out[4], ref[4])
    assert float(out[2].abs().max()) == 0.0

    gen = torch.Generator().manual_seed(seed)
    g_color = (torch.randn((3, H, W), generator=gen) / (3 * H * W)).to(dev)
    g_T = (torch.randn((H, W), generator=gen) / (H * W)).to(dev)
    bw = args + (out[3], out[4], g_color, g_T)
    got = KB.blend_backward(*bw, **geo)
    want = KB.blend_backward_plain(*bw, **geo)
    torch.cuda.synchronize()
    assert KB.blend_backward.launches == {**n_bwd, variant: n_bwd[variant] + 1}
    assert bool(torch.isfinite(got).all())
    # pixel sums in another order (warp tree vs torch.sum): rel 1e-4 of
    # each live row's max; padding, tail and the other rows exactly zero
    scale = want[:live].abs().amax(dim=1).clamp_min(1e-30)
    assert float(((got[:live] - want[:live]).abs().amax(dim=1) / scale).max()) <= 1e-4
    assert float(got[live:].abs().max()) == 0.0
    ts, tc = sp.astarts.tolist(), sp.tile_counts.tolist()
    for t in range(len(tc)):
        assert not bool(got[:, ts[t] + tc[t]:ts[t + 1]].any())
    assert not bool(got[:, ts[-1]:].any())


@pytest.mark.parametrize("variant,case", [
    *(pytest.param("2D", c, id=f"case{i}") for i, c in enumerate(CASES)),
    *(pytest.param("3D", c, id=f"3d-case{i}") for i, c in enumerate(CASES_3D))])
def test_blend_forward_stats_matches_plain(dev, variant, case):
    """B1's stats form: color, final_T and n_contrib bit-identical to the
    stats-off kernel's (the stream is a side output); the per-pair stream
    against the plain version: the max exact (the same rounded per-pixel
    values), the sum within 1e-5 of its row's max (warp trees in another
    order); zeros where no pair is. Launches count under "<variant>_stats"."""
    P, W, H, seed, gamma, orange = case
    sp, _, fields, params = pipeline_inputs(case, dev, variant)
    geo = dict(image_width=W, image_height=H, tile_h=32, tile_w=32, variant=variant)
    args = (fields, sp.astarts, sp.tile_counts, params)
    n_fwd = dict(KB.blend_forward.launches)
    off = KB.blend_forward(*args, **geo)
    on = KB.blend_forward(*args, stats=True, **geo)
    ref = KB.blend_forward_plain(*args, stats=True, **geo)
    torch.cuda.synchronize()
    assert KB.blend_forward.launches == {**n_fwd, variant: n_fwd[variant] + 1,
                                         f"{variant}_stats": n_fwd[f"{variant}_stats"] + 1}
    for a, b in zip(on[:5], off):
        assert torch.equal(a, b)
    pc, want = on[5], ref[5]
    assert pc.shape == (2, fields.shape[1]) and bool(torch.isfinite(pc).all())
    assert torch.equal(pc[1], want[1])
    assert float((pc[0] - want[0]).abs().max()) <= 1e-5 * float(want[0].abs().max())
    assert float(want[0].max()) > 0 and not bool(pc[:, int(sp.astarts[-1]):].any())


@pytest.mark.parametrize("seed,M,P,maxlen", [
    (0, 128 * 37, 700, 12), (1, 128 * 8, 2000, 1), (2, 128 * 64, 9, 2000)])
def test_segment_reduce_stats_kernel_matches_plain(dev, seed, M, P, maxlen):
    """B5 against its plain version: sums within 1e-5 of the largest
    (float32 loop against a float64 prefix sum), maxes exact, NaN past
    nvalid never read, empty segments 0."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, maxlen + 1, P)
    nvalid = int(min(counts.sum(), M) * 0.9)
    offs = np.minimum(np.concatenate([[0], np.cumsum(counts)]), M)
    sc = rng.uniform(0, 2, M).astype(np.float32)
    mc = rng.uniform(0, 1, M).astype(np.float32)
    sc[nvalid:] = np.nan
    mc[nvalid:] = np.nan
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    args = (t(sc), t(mc), t(offs[:-1].astype(np.int32)), t(offs[1:].astype(np.int32)),
            torch.tensor(nvalid, dtype=torch.int32, device=dev))
    n = KS.segment_reduce_stats.launches
    gs, gm = KS.segment_reduce_stats(*args)
    ws, wm = KS.segment_reduce_stats_plain(*args)
    torch.cuda.synchronize()
    assert KS.segment_reduce_stats.launches == n + 1
    assert bool(torch.isfinite(gs).all()) and bool(torch.isfinite(gm).all())
    assert float((gs - ws).abs().max()) <= 1e-5 * float(ws.abs().max())
    assert torch.equal(gm, wm)
    empty = args[2] == args[3]
    assert not bool(gs[empty].any()) and not bool(gm[empty].any())


@pytest.mark.parametrize("variant", ["2D", "3D"])
def test_rasterize_stats_cuda_matches_cpu(dev, variant):
    """rasterize(need_stats=True) on the card (B1 stats form, owner sort,
    B5) vs its plain versions on the CPU. Two float32 pipelines on two
    devices (exp/log/sqrt differ by an ulp) may flip an isolated (pair,
    pixel) across the alpha >= 1/255 cut, as test_rasterize_cuda_matches_cpu
    allows: that moves the pair's contribution by < 1/255 and those of the
    pixel's later pairs by < 1/255 together (on the H100 one 2D triangle
    moved by 3.9e-3). So contrib_sum / contrib_max within the JAX package's
    5e-4 budget (tests/test_rasterize.py) for all but a few triangles, and
    within 2/255 for those."""
    s = make_random_scene(300, seed=6)
    st = RasterSettings(image_width=96, image_height=64, rich_info=False,
                        rasterizer_type=variant)
    res = {}
    for d in ("cpu", dev):
        out = rasterize(*(torch.as_tensor(s[k]).to(d) for k in ("vertex", "opacity")), None,
                        make_camera(96, 64, device=d), st, gamma=1.0,
                        background=torch.ones(3, device=d), bg_depth=10.0,
                        colors=torch.as_tensor(s["rgb"]).to(d), need_stats=True)
        res[str(d)] = {k: out[k].cpu() for k in ("contrib_sum", "contrib_max")}
    for k in ("contrib_sum", "contrib_max"):
        d = (res["cuda"][k] - res["cpu"][k]).abs()
        assert float(d.max()) <= 2 / 255
        assert int((d > 5e-4).sum()) <= 8
    assert float(res["cuda"]["contrib_sum"].max()) > 1.0


def test_rasterize_3d_cuda_matches_cpu(dev):
    """The 3D tile pipeline on the card vs its plain versions on the CPU,
    forward and gradients, at the solidify end of the anneal (gamma 50)."""
    s = make_random_scene(300, seed=5)
    st = RasterSettings(image_width=96, image_height=64, rich_info=False,
                        rasterizer_type="3D")
    target = torch.rand((3, 64, 96), generator=torch.Generator().manual_seed(0))
    res = {}
    for d in ("cpu", dev):
        leaves = [torch.tensor(s[k], device=d, requires_grad=True)
                  for k in ("vertex", "opacity", "rgb")]
        out = rasterize(leaves[0], leaves[1], None, make_camera(96, 64, device=d), st,
                        gamma=50.0, background=torch.ones(3, device=d), bg_depth=10.0,
                        colors=leaves[2])
        # a squared error: no L1 kink for two renders to straddle
        loss = ((out["render"] - target.to(d)) ** 2).mean() + 0.3 * out["final_T"].mean()
        res[str(d)] = (out, torch.autograd.grad(loss, leaves))
    (oc, gc), (og, gg) = res["cpu"], res["cuda"]
    assert float((og["render"].detach().cpu() - oc["render"].detach()).abs().max()) <= 1e-3
    assert int((og["n_contrib"].cpu() != oc["n_contrib"]).sum()) <= 2
    # At gamma 50 a pixel's gradient lives on a band a few pixels wide at
    # the triangle's edge, and an ulp of exp/log flips a pixel's alpha
    # masks (1/255, 0.99) there: vertex gradients in L2 as in
    # test_rasterize_cuda_matches_cpu, opacity / color in L2 at 1e-3
    for a, b, tol in zip(gg, gc, (2e-2, 1e-3, 1e-3)):
        assert float((a.cpu() - b).norm() / b.norm()) <= tol


@pytest.mark.parametrize("seed,M,P,maxlen,rows", [
    (0, 128 * 37, 700, 12, 16), (1, 128 * 8, 2000, 1, 10), (2, 128 * 64, 9, 2000, 10)])
def test_segment_reduce_kernel_matches_plain(dev, seed, M, P, maxlen, rows):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, maxlen + 1, P)
    nvalid = int(min(counts.sum(), M) * 0.9)
    offs = np.minimum(np.concatenate([[0], np.cumsum(counts)]), M)
    cols = rng.normal(size=(rows, M)).astype(np.float32)
    cols[:, nvalid:] = np.nan                       # never read past nvalid
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    args = (t(cols), t(offs[:-1].astype(np.int32)), t(offs[1:].astype(np.int32)),
            torch.tensor(nvalid, dtype=torch.int32, device=dev))
    got = KS.segment_reduce_pairs(*args)
    want = KS.segment_reduce_pairs_plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert not bool(got[rows:].any())


def test_rasterize_cuda_matches_cpu(dev):
    """The whole tile pipeline on the card vs its plain versions on the
    CPU: forward and the gradients w.r.t. vertex, opacity, colors."""
    s = make_random_scene(300, seed=4)
    st = RasterSettings(image_width=96, image_height=64, rich_info=False)
    target = torch.rand((3, 64, 96), generator=torch.Generator().manual_seed(0))
    res = {}
    for d in ("cpu", dev):
        leaves = [torch.tensor(s[k], device=d, requires_grad=True)
                  for k in ("vertex", "opacity", "rgb")]
        out = rasterize(leaves[0], leaves[1], None, make_camera(96, 64, device=d), st,
                        gamma=1.0, background=torch.ones(3, device=d), bg_depth=10.0,
                        colors=leaves[2])
        loss = (out["render"] - target.to(d)).abs().mean() + 0.3 * out["final_T"].mean()
        res[str(d)] = (out, torch.autograd.grad(loss, leaves))
    (oc, gc), (og, gg) = res["cpu"], res["cuda"]
    # Two float32 pipelines on two devices (exp/log/sqrt differ by an ulp)
    # may flip an isolated contributor boundary: the 1e-3/pixel budget.
    assert float((og["render"].detach().cpu() - oc["render"].detach()).abs().max()) <= 1e-3
    assert int((og["n_contrib"].cpu() != oc["n_contrib"]).sum()) <= 2
    # Vertex gradients are discontinuous per pixel: the ecc subgradient
    # lands on the argmin barycentric, which flips when two barycentrics
    # tie to an ulp. On this scene float32 vs float64 on the CPU differ by
    # 1.9e-2 of the max and 5.6e-3 in L2, so hold the vertex gradient in L2
    # (rel 2e-2) and the smooth opacity / color gradients at rel 1e-4.
    gv, cv = gg[0].cpu(), gc[0]
    assert float((gv - cv).norm() / cv.norm()) <= 2e-2
    for a, b in zip(gg[1:], gc[1:]):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_wrappers_reject_bad_inputs(dev):
    f = torch.zeros((16, 256), device=dev, dtype=torch.float64)
    ts = torch.zeros(5, dtype=torch.int32, device=dev)
    tc = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        KB.blend_forward(f, ts, tc, torch.zeros(8, device=dev), image_width=64,
                         image_height=64, tile_h=32, tile_w=32)
    with pytest.raises(ValueError):
        KB.blend_forward(f.float(), ts.cpu(), tc, torch.zeros(8, device=dev),
                         image_width=64, image_height=64, tile_h=32, tile_w=32)
    with pytest.raises(NotImplementedError):
        KB.blend_forward(f.float(), ts, tc, torch.zeros(8, device=dev), image_width=64,
                         image_height=64, tile_h=32, tile_w=32, variant="4D")


# ---------------------------------------------------------------------------
# variant "GS" (csrc/blend_gs.cu)
# ---------------------------------------------------------------------------

GS_CASES = [
    # (scene, P, W, H, seed, gamma); "stack": seed is the kill index
    ("scene", 300, 64, 64, 0, 1.0),
    ("scene", 400, 80, 48, 2, 2.5),       # partial tiles, gamma != 1
    ("scene", 400, 70, 90, 3, 1.0),
    ("stack", 400, 64, 64, 300, 1.0),     # kill entry past every staged batch
]
GS_FORMS = [(False, False), (True, False), (False, True), (True, True)]   # (stats, rich)


def gs_inputs(case, dev):
    """Sorted pairs and packed GS fields of a random scene (or a stack whose
    kill entry lies past the kernels' batches), on ``dev``."""
    from triangle_splatting_tpu_torch.ops.gaussian import (gaussian_field_matrix,
                                                           preprocess_gaussian)
    from triangle_splatting_tpu_torch.utils.testing import make_gs_scene, make_gs_stack_scene
    kind, P, W, H, seed, gamma = case
    s = make_gs_stack_scene(P, seed, 0.02) if kind == "stack" else make_gs_scene(P, seed=seed)
    xyz, scale, rot, op, rgb = (torch.as_tensor(s[k]).to(dev)
                                for k in ("xyz", "scale", "rot", "opacity", "rgb"))
    st = RasterSettings(image_width=W, image_height=H, rich_info=False, rasterizer_type="GS")
    cam = make_camera(W, H, device=dev)
    with torch.no_grad():
        prep = preprocess_gaussian(xyz, scale, rot, rgb, cam.world_view, cam.full_proj,
                                   cam.tan_fovx, cam.tan_fovy, st, opacity=op,
                                   gamma=torch.tensor(gamma, device=dev))
        sp = sort_pairs(prep, st, 128 * 200)
        assert not bool(sp.overflow)
        pair_tri = KS.relayout_pairs_plain(sp.sorted_tri, sp.raw_starts, sp.astarts,
                                           sp.tile_counts, sp.ma)
        fmat = gaussian_field_matrix(prep, op)
        fields = torch.where((pair_tri >= 0)[:, None], fmat[pair_tri.clamp_min(0).long()],
                             torch.zeros((), device=dev)).t().contiguous()
    params = torch.tensor([gamma, 1.0, 0.9, 0.8, 10.0, 0, 0, 0], device=dev)
    return sp, fields, params


@pytest.mark.parametrize("case", GS_CASES)
def test_blend_gs_forward_kernel_matches_plain(dev, case):
    """Each B1-GS form against the plain version on the card: n_contrib and
    final_T exact, color abs 1e-5, depth rel 1e-5, the stream's sums rel
    1e-5 and its maxes exact, one launch counted per form."""
    kind, P, W, H, seed, gamma = case
    sp, fields, params = gs_inputs(case, dev)
    geo = dict(image_width=W, image_height=H, tile_h=32, tile_w=32, variant="GS")
    args = (fields, sp.astarts, sp.tile_counts, params)
    ref = KB.blend_forward_plain(*args, stats=True, rich=True, **geo)
    for stats, rich in GS_FORMS:
        form = "GS" + ("_rich" if rich else "") + ("_stats" if stats else "")
        n = KB.blend_forward.launches[form]
        got = KB.blend_forward(*args, stats=stats, rich=rich, **geo)
        torch.cuda.synchronize()
        assert KB.blend_forward.launches[form] == n + 1
        assert torch.equal(got[4], ref[4]) and torch.equal(got[3], ref[3]), form
        assert float((got[0] - ref[0]).abs().max()) <= 1e-5, form
        if rich:
            assert float((got[1] - ref[1]).abs().max()) <= 1e-5 * float(ref[1].abs().max())
        if stats:
            assert float((got[5][0] - ref[5][0]).abs().max()) <= 1e-5 * float(ref[5][0].max())
            assert torch.equal(got[5][1], ref[5][1]), form
    if kind == "stack":
        assert int(ref[4][H // 2, W // 2]) == seed       # killed at the stack's entry 300


@pytest.mark.parametrize("rich", [False, True])
@pytest.mark.parametrize("case", GS_CASES)
def test_blend_gs_backward_kernel_matches_plain(dev, case, rich):
    """B2-GS against the plain version on the card: live rows rel 1e-4 of
    each row's max, row 5 and the rows past the live ones zero."""
    kind, P, W, H, seed, gamma = case
    sp, fields, params = gs_inputs(case, dev)
    geo = dict(image_width=W, image_height=H, tile_h=32, tile_w=32, variant="GS")
    args = (fields, sp.astarts, sp.tile_counts, params)
    out = KB.blend_forward(*args, **geo)
    gen = torch.Generator().manual_seed(seed)
    g_color = (torch.randn((3, H, W), generator=gen) / (3 * H * W)).to(dev)
    g_T = (torch.randn((H, W), generator=gen) / (H * W)).to(dev)
    g_depth = (torch.randn((H, W), generator=gen) / (H * W)).to(dev) if rich else None
    bw = args + (out[3], out[4], g_color, g_T, g_depth)
    form = "GS_rich" if rich else "GS"
    n = KB.blend_backward.launches[form]
    got = KB.blend_backward(*bw, rich=rich, **geo)
    ref = KB.blend_backward_plain(*bw, rich=rich, **geo)
    torch.cuda.synchronize()
    assert KB.blend_backward.launches[form] == n + 1
    live = KB.LIVE_GRAD_ROWS[("GS", rich)]
    rel = ((got - ref).abs().amax(dim=1) / ref.abs().amax(dim=1).clamp_min(1e-30))[:live]
    assert float(rel.max()) <= 1e-4 and torch.isfinite(got).all()
    assert not got[5].any() and not got[live:].any()


def test_rasterize_gaussian_card_matches_cpu(dev):
    """``rasterize_gaussian`` with statistics on the card against the CPU
    (plain versions): render and final_T within 1e-5, n_contrib within two
    pixels (exp/log differ by an ulp between the two devices), statistics
    5e-4; gradients of every input rel 1e-4 of their max."""
    from triangle_splatting_tpu_torch.ops.rasterize import rasterize_gaussian
    from triangle_splatting_tpu_torch.utils.testing import make_gs_scene
    s = make_gs_scene(300, seed=4)
    target = torch.rand((3, 64, 64), generator=torch.Generator().manual_seed(0))
    res = {}
    for d in (torch.device("cpu"), dev):
        leaves = [torch.tensor(s[k], device=d, requires_grad=True)
                  for k in ("xyz", "scale", "rot", "opacity", "rgb")]
        st = RasterSettings(image_width=64, image_height=64, rich_info=False,
                            rasterizer_type="GS", max_sh_degree=0)
        out = rasterize_gaussian(*leaves[:4], None, make_camera(64, 64, device=d), st,
                                 background=torch.ones(3, device=d), bg_depth=10.0,
                                 colors=leaves[4])
        loss = (out["render"] - target.to(d)).abs().mean() + 0.3 * out["final_T"].mean()
        res[str(d)] = (out, torch.autograd.grad(loss, leaves))
    (oc, gc), (og, gg) = res["cpu"], res["cuda"]
    for k in ("render", "final_T"):
        assert float((og[k].detach().cpu() - oc[k].detach()).abs().max()) <= 1e-5, k
    assert int((og["n_contrib"].cpu() != oc["n_contrib"]).sum()) <= 2
    for k in ("contrib_sum", "contrib_max"):
        assert float((og[k].cpu() - oc[k]).abs().max()) <= 5e-4, k
    for a, b in zip(gg, gc):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max())


# ---------------------------------------------------------------------------
# B1 with rich info and the contribution stream together
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,case", [
    *(pytest.param("2D", c, id=f"case{i}") for i, c in enumerate(CASES)),
    *(pytest.param("3D", c, id=f"3d-case{i}") for i, c in enumerate(CASES_3D))])
def test_blend_forward_rich_stats_matches_plain(dev, variant, case):
    """B1's rich + stats form (the triangle renderer facade's): color,
    final_T and n_contrib bit-identical to the plain form's, depth and
    normal to the rich form's, the stream to the stats form's; against the
    plain version depth and normal within rel 1e-5 of their max, the
    stream's maxes exact and its sums within 1e-5 of the row's max.
    Launches count under "<variant>_rich_stats"."""
    P, W, H, seed, gamma, orange = case
    sp, _, fields, params = pipeline_inputs(case, dev, variant)
    if variant == "3D":
        cam = make_camera(W, H, device=dev)
        params[5], params[6] = W / (2.0 * cam.tan_fovx), H / (2.0 * cam.tan_fovy)
    geo = dict(image_width=W, image_height=H, tile_h=32, tile_w=32, variant=variant)
    args = (fields, sp.astarts, sp.tile_counts, params)
    n_fwd = dict(KB.blend_forward.launches)
    both = KB.blend_forward(*args, rich=True, stats=True, **geo)
    torch.cuda.synchronize()
    form = f"{variant}_rich_stats"
    assert KB.blend_forward.launches == {**n_fwd, form: n_fwd[form] + 1}
    plain = KB.blend_forward(*args, **geo)
    rich = KB.blend_forward(*args, rich=True, **geo)
    stats = KB.blend_forward(*args, stats=True, **geo)
    ref = KB.blend_forward_plain(*args, rich=True, stats=True, **geo)
    torch.cuda.synchronize()
    for k in (0, 3, 4):
        assert torch.equal(both[k], plain[k]), k
    for k in (1, 2):
        assert torch.equal(both[k], rich[k]), k
    assert torch.equal(both[5], stats[5])
    assert torch.equal(both[4], ref[4])
    for k in (1, 2):
        scale = float(ref[k].abs().max())
        assert float((both[k] - ref[k]).abs().max()) <= 1e-5 * scale, k
    pc, want = both[5], ref[5]
    assert torch.equal(pc[1], want[1])
    assert float((pc[0] - want[0]).abs().max()) <= 1e-5 * float(want[0].abs().max())
    assert float(want[0].max()) > 0 and float(both[2].abs().max()) > 0


# ---------------------------------------------------------------------------
# the renderer facades
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["2D", "3D"])
def test_triangle_renderer_card_matches_cpu(dev, variant):
    """TriangleRenderer(rich_info=True) on the card runs B1's rich + stats
    form and B2's rich form once each, and agrees with the CPU (plain
    versions): exp/log an ulp apart on the two devices may keep an entry
    whose alpha lies an ulp from 1/255 on one device and drop it on the
    other, so n_contrib may differ in two pixels and render, depth and
    normal by more than 1e-3 of their scale in two pixels, there by at most
    T/255 (4e-3); the statistics as test_rasterize_stats_cuda_matches_cpu
    holds them (5e-4 but for a few triangles, 2/255 for those); gradients
    within the budgets of test_rasterize_rich_cuda_matches_cpu."""
    from triangle_splatting_tpu_torch.ops.cuda import launch_counts, reset_launches
    from triangle_splatting_tpu_torch.renderer import TriangleRenderer
    s = make_random_scene(300, seed=8)
    gen = torch.Generator().manual_seed(2)
    target = torch.rand((3, 64, 96), generator=gen)
    w_d = torch.randn((64, 96), generator=gen) / (64 * 96)
    gamma = 1.0 if variant == "2D" else 50.0
    res = {}
    for d in (torch.device("cpu"), dev):
        leaves = [torch.tensor(s[k], device=d, requires_grad=True)
                  for k in ("vertex", "opacity", "rgb")]
        r = TriangleRenderer(make_camera(96, 64, device=d), bg_color=(1.0, 1.0, 1.0),
                             bg_depth=10.0, gamma=gamma, rich_info=True,
                             rasterizer_type=variant)
        reset_launches()
        out = r.render(leaves[0], None, leaves[2], leaves[1])
        loss = ((out["render"] - target.to(d)) ** 2).mean() + (out["depth"] * w_d.to(d)).sum()
        grads = torch.autograd.grad(loss, leaves)
        res[d.type] = (out, grads, {k: n for k, n in launch_counts().items() if n})
    (oc, gc, lc), (og, gg, lg) = res["cpu"], res["cuda"]
    assert not lc
    assert {k: n for k, n in lg.items() if k[0].startswith("blend")} == {
        ("blend_forward", f"{variant}_rich_stats"): 1, ("blend_backward", f"{variant}_rich"): 1}
    assert lg[("segment_reduce_stats", None)] == 1
    assert int((og["n_contrib"].cpu() != oc["n_contrib"]).sum()) <= 2
    for k in ("render", "depth", "normal"):
        a, b = og[k].detach().cpu(), oc[k].detach()
        d = ((a - b).abs() / max(1.0, float(b.abs().max()))).reshape(-1, 64, 96).amax(dim=0)
        assert int((d > 1e-3).sum()) <= 2 and float(d.max()) <= 4e-3, (k, float(d.max()))
    for k in ("contrib_sum", "contrib_max"):
        d = (og[k].cpu() - oc[k]).abs()
        assert float(d.max()) <= 2 / 255 and int((d > 5e-4).sum()) <= 8, k
    for a, b, tol in zip(gg, gc, (2e-2, 1e-3, 1e-3)):
        assert float((a.cpu() - b).norm() / b.norm()) <= tol


def test_mesh_renderer_card_matches_cpu(dev, tmp_path):
    """MeshRenderer on a GLB: on the card one B1-3D rich launch and no
    stream, B5 or backward; render, mask and depth as on the CPU within
    1e-3 of their scale outside a 1e-3 share of pixels (edge flips at
    gamma 50)."""
    from triangle_splatting_tpu_torch.models.raw_triangle import RawTriangle
    from triangle_splatting_tpu_torch.ops.cuda import launch_counts, reset_launches
    from triangle_splatting_tpu_torch.renderer import MeshRenderer
    s = make_random_scene(300, seed=9, opacity_range=(0.9, 0.95))
    path = tmp_path / "mesh.glb"
    RawTriangle(s["vertex"], np.full((300, 1), 4.0, np.float32),
                ((s["rgb"] - 0.5) / 0.28209479177387814).astype(np.float32)).saveGLB(path)
    outs = {}
    for d in (torch.device("cpu"), dev):
        reset_launches()
        outs[d.type] = MeshRenderer(make_camera(96, 64, device=d)).render(mesh_path=str(path))
        torch.cuda.synchronize()
        launches = {k: n for k, n in launch_counts().items() if n}
    assert launches == {("blend_forward", "3D_rich"): 1, ("relayout_pairs", None): 1}
    assert float((outs["cuda"]["mask"] > 0.5).float().mean()) > 0.05
    for k in ("render", "mask", "depth"):
        a, b = outs["cuda"][k].cpu(), outs["cpu"][k]
        d = (a - b).abs() / max(1.0, float(b.abs().max()))
        assert float((d > 1e-3).float().mean()) <= 1e-3 and float(d.max()) <= 1e-2, k


# ---------------------------------------------------------------------------
# the probes P1-P3
# ---------------------------------------------------------------------------

PROBE_K = 64


def probe_block(dev, rows, cols, lo, hi, seed=0):
    x = np.random.default_rng(seed).uniform(lo, hi, size=(rows, cols)).astype(np.float32)
    return torch.as_tensor(x).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("op", ["mul", "fma", "min3", "exp"])
def test_vpu_probe_kernel_matches_plain(dev, op, dtype):
    """P1 at K = 64: mul and min3 exact (the same rounded operations); f32
    fma within rel 1e-5 of the max (one FFMA rounding against the plain
    version's two, an ulp a pass over 64 passes); exp within rel 1e-6 (an
    ulp of expf against torch.exp, not grown: the chain's derivative is
    1e-6). In bfloat16 the multiplier is exactly 1 and every value of the
    exp chain rounds to 1: all exact but exp (an ulp, 2^-8)."""
    from triangle_splatting_tpu_torch.ops.cuda import probes as KP
    x = probe_block(dev, 64, 256, -1.5, 1.5)
    n = KP.vpu_probe.launches
    got = KP.vpu_probe(x, op, dtype, PROBE_K)
    want = KP.vpu_probe_plain(x, op, dtype, PROBE_K)
    torch.cuda.synchronize()
    assert KP.vpu_probe.launches == n + 1
    err = float((got - want).abs().max()) / float(want.abs().max())
    if op in ("mul", "min3") or (dtype == torch.bfloat16 and op == "fma"):
        assert torch.equal(got, want)
    elif op == "fma":
        assert err <= 1e-5, err
    else:
        assert err <= (2 ** -8 if dtype == torch.bfloat16 else 1e-6), err
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("op", ["mul8", "exp", "fastexp", "exp_intrinsic"])
def test_exp_probe_kernel_matches_plain(dev, op):
    """P2 at K = 64: mul8 exact; expf, __expf and fast_exp (FFMA Horner
    steps against the plain version's products and sums) within rel 1e-6:
    a few ulps, not grown along the chain."""
    from triangle_splatting_tpu_torch.ops.cuda import probes as KP
    x = probe_block(dev, 64, 256, 0.5, 1.5, seed=1)
    n = KP.exp_probe.launches
    got = KP.exp_probe(x, op, PROBE_K)
    want = KP.exp_probe_plain(x, op, PROBE_K)
    torch.cuda.synchronize()
    assert KP.exp_probe.launches == n + 1
    if op == "mul8":
        assert torch.equal(got, want)
    else:
        assert float(((got - want).abs() / want).max()) <= 1e-6


def test_fast_exp_device_matches_plain_range(dev):
    """fast_exp on [-44, 0] on the card (K = 1 through the kernel would
    apply |v| * 1e-6 first, so this holds the plain function on CUDA
    tensors): within 1e-5 of exp, as on the CPU."""
    from triangle_splatting_tpu_torch.ops.cuda import probes as KP
    t = torch.linspace(0.0, 44.0, 8192, device=dev)
    ref = torch.exp(-t.double())
    assert float(((KP.fast_exp(-t).double() - ref).abs() / ref).max()) <= 1e-5


@pytest.mark.parametrize("variant", ["hs", "hs_roll", "two_level4", "two_level8",
                                     "two_level16", "two_level32", "mxu_log"])
def test_scan_probe_kernel_matches_cumprod_and_plain(dev, variant):
    """P3: one unclipped scan of linspace(0.9, 1) (the tool's check) within
    rel 2e-6 of float64 cumprod (mxu_log 2e-5), as the plain versions on
    the CPU; K = 64 clipped reps against the plain version within rel 5e-6
    (mxu_log 4e-5): two float32 orders, each within the first budget."""
    from triangle_splatting_tpu_torch.ops.cuda import probes as KP
    x = torch.linspace(0.9, 1.0, 256 * 256, device=dev).reshape(256, 256)
    ref = torch.cumprod(x.double(), dim=0)
    n = KP.scan_probe.launches
    one = KP.scan_probe(x, variant, k=1, clip=False)
    torch.cuda.synchronize()
    assert KP.scan_probe.launches == n + 1
    err = float(((one.double() - ref).abs() / ref).max())
    assert err <= (2e-5 if variant == "mxu_log" else 2e-6), err
    xr = probe_block(dev, 256, 256, 0.9, 1.0, seed=3)
    got = KP.scan_probe(xr, variant, PROBE_K)
    want = KP.scan_probe_plain(xr, variant, PROBE_K)
    torch.cuda.synchronize()
    err = float(((got - want).abs() / want).max())
    assert err <= (4e-5 if variant == "mxu_log" else 5e-6), err
    assert float(got.min()) >= float(np.float32(0.9)) and float(got.max()) <= 1.0
