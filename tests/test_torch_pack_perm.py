"""The port's owner-order map ``Binning.pack_perm`` (written by kernel B3)
and its two readers, against the JAX package's ``pack_perm`` route
(``bin_triangles(..., compute_pack_perm=True)``) on the same numpy inputs:
the map itself in "2D", "3D" and "GS", overflow included; B4 through the
map; the pack backward (``rasterize.py:_pack_bwd``); the contribution
statistics (``_contrib_stats``). And a spy: one rasterize forward +
backward sorts once (binning's key sort) on the CPU."""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.ops import gaussian as JGO
from triangle_splatting_tpu.ops import rasterize as JR
from triangle_splatting_tpu.ops.binning import bin_triangles as j_bin
from triangle_splatting_tpu.ops.pallas import streams as JS
from triangle_splatting_tpu.ops.projection import RasterSettings as JRS
from triangle_splatting_tpu.ops.projection import preprocess_2d, preprocess_3d
from triangle_splatting_tpu.utils.testing import make_camera as j_camera
from triangle_splatting_tpu.utils.testing import make_random_scene
from triangle_splatting_tpu_torch.ops import rasterize as TR
from triangle_splatting_tpu_torch.ops.binning import bin_triangles as t_bin
from triangle_splatting_tpu_torch.ops.cuda import blend as TB
from triangle_splatting_tpu_torch.ops.cuda import streams as TS
from triangle_splatting_tpu_torch.ops.projection import RasterSettings as TRS
from triangle_splatting_tpu_torch.utils.testing import make_camera as t_camera
from triangle_splatting_tpu_torch.utils.testing import make_gs_scene
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

BIN_FIELDS = ("depth", "valid", "tiles_touched", "rect_min", "rect_max")
W, H = 96, 64
# (variant, budget): "room" fits every pair, "overflow" drops a suffix
CASES = [(v, b) for v in ("2D", "3D", "GS") for b in ("room", "overflow")]


@functools.lru_cache(maxsize=None)
def binning_inputs(variant, P=200, seed=3):
    """The fields binning reads, from the JAX preprocess of ``variant`` on
    a random scene, as numpy arrays (cached: read-only)."""
    cam = j_camera(W, H)
    st = JRS(image_width=W, image_height=H, rasterizer_type=variant)
    if variant == "GS":
        s = make_gs_scene(P, seed=seed)
        prep = JGO.preprocess_gaussian(*(jnp.asarray(s[k]) for k in ("xyz", "scale", "rot", "rgb")),
                                       cam.world_view, cam.full_proj, cam.tan_fovx,
                                       cam.tan_fovy, st, opacity=jnp.asarray(s["opacity"]),
                                       gamma=jnp.float32(1.0))
    else:
        s = make_random_scene(P, seed=seed)
        pre = preprocess_2d if variant == "2D" else preprocess_3d
        prep = pre(jnp.asarray(s["vertex"]), jnp.zeros((P, 2)), jnp.asarray(s["rgb"]),
                   cam.world_view, cam.full_proj, cam.tan_fovx, cam.tan_fovy, st,
                   opacity=jnp.asarray(s["opacity"]), gamma=jnp.float32(1.0))
    return {k: np.array(getattr(prep, k)) for k in BIN_FIELDS}


def bin_both(variant, budget):
    """The JAX binning with its pack_perm and the port's, on one input."""
    arrs = binning_inputs(variant)
    demand = int(arrs["tiles_touched"].sum())
    max_pairs = 128 * (demand // 128 + 2) if budget == "room" else 128 * (demand // 256)
    assert (demand > max_pairs) == (budget == "overflow")
    jb = j_bin(SimpleNamespace(**{k: jnp.asarray(v) for k, v in arrs.items()}),
               JRS(image_width=W, image_height=H), max_pairs, interpret=True,
               compute_pack_perm=True)
    tb = t_bin(SimpleNamespace(**{k: torch.as_tensor(v) for k, v in arrs.items()}),
               TRS(image_width=W, image_height=H), max_pairs)
    return jb, tb


def old_pack_backward(d, binning, live):
    """The port's route before the map: a stable sort of the owner key
    over every aligned slot, the live gradient rows gathered by it, then
    B4 on the owner-sorted columns."""
    p = binning.tri_offsets.shape[0] - 1
    key = torch.where(binning.pair_tri >= 0, binning.pair_tri,
                      torch.full_like(binning.pair_tri, p))
    cols = d[:live].index_select(1, torch.sort(key, stable=True).indices).contiguous()
    starts = torch.minimum(binning.tri_offsets[:-1], binning.num_pairs).contiguous()
    ends = torch.minimum(binning.tri_offsets[1:], binning.num_pairs).contiguous()
    return TS.segment_reduce_pairs(cols, starts, ends, nvalid=binning.num_pairs)


def old_contrib_stats(pc, binning):
    """The statistics' route before the map: the same owner sort, both
    stream rows gathered by it, then B5."""
    p = binning.tri_offsets.shape[0] - 1
    key = torch.where(binning.pair_valid, binning.pair_tri, torch.full_like(binning.pair_tri, p))
    cols = pc.index_select(1, torch.sort(key, stable=True).indices)
    starts = torch.minimum(binning.tri_offsets[:-1], binning.num_pairs).contiguous()
    ends = torch.minimum(binning.tri_offsets[1:], binning.num_pairs).contiguous()
    return TS.segment_reduce_stats(cols[0], cols[1], starts, ends, nvalid=binning.num_pairs)


def rel(got, want):
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("variant,budget", CASES)
def test_pack_perm_matches_jax(variant, budget):
    """The map's first num_pairs entries equal the JAX route's exactly;
    they hit every filled slot once, and every later entry names an empty
    slot."""
    jb, tb = bin_both(variant, budget)
    n = int(tb.num_pairs)
    assert n == int(jb.num_pairs) and bool(tb.overflow) == (budget == "overflow")
    np.testing.assert_array_equal(tb.pair_tri.numpy(), np.asarray(jb.pair_tri))
    perm = tb.pack_perm.numpy()
    np.testing.assert_array_equal(perm[:n], np.asarray(jb.pack_perm)[:n])
    pair_tri = tb.pair_tri.numpy()
    np.testing.assert_array_equal(np.sort(perm[:n]), np.nonzero(pair_tri >= 0)[0])
    assert (pair_tri[perm[n:]] == -1).all()
    # raw pair r belongs to the triangle whose offsets range holds it
    owner = np.searchsorted(tb.tri_offsets.numpy(), np.arange(n), side="right") - 1
    np.testing.assert_array_equal(pair_tri[perm[:n]], owner)


@pytest.mark.parametrize("budget", ["room", "overflow"])
@pytest.mark.parametrize("live", [10, 13, 14, 16])
def test_segment_reduce_map_matches_sorted_and_jax(live, budget):
    """B4's map form equals its sorted form fed the gathered columns, and
    matches the JAX kernel on ``d.T[pack_perm]`` at B4's rel 1e-5; the
    empty slots hold NaN and are never read."""
    jb, tb = bin_both("2D", budget)
    ma = tb.pair_tri.shape[0]
    rng = np.random.default_rng(live)
    d = rng.normal(size=(16, ma)).astype(np.float32)
    d[:, tb.pair_tri.numpy() < 0] = np.nan
    dt = torch.as_tensor(d)
    starts = torch.minimum(tb.tri_offsets[:-1], tb.num_pairs).contiguous()
    ends = torch.minimum(tb.tri_offsets[1:], tb.num_pairs).contiguous()
    got = TS.segment_reduce_pairs(dt[:live], starts, ends, tb.num_pairs, perm=tb.pack_perm)
    sorted_cols = dt[:live][:, tb.pack_perm.long()].contiguous()
    assert torch.equal(got, TS.segment_reduce_pairs(sorted_cols, starts, ends, tb.num_pairs))
    assert bool(torch.isfinite(got).all()) and not bool(got[live:].any())
    g = jnp.asarray(d)[:live].T[jb.pack_perm]
    want = np.asarray(JS.segment_reduce_pairs(
        [g[:, i] for i in range(live)] + [jnp.zeros_like(g[:, 0])] * (16 - live),
        jnp.asarray(starts.numpy()), jnp.asarray(ends.numpy()),
        nvalid=jnp.int32(int(tb.num_pairs)), interpret=True))
    assert rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("variant,budget", CASES)
def test_pack_backward_matches_jax(variant, budget):
    """The port's pack gradient against JAX ``_pack_bwd`` on its pack_perm
    route (rel 1e-6 of the max), and equal to the port's old route (the
    owner sort + ``index_select`` + sorted B4) on the CPU."""
    jb, tb = bin_both(variant, budget)
    P, ma = tb.tri_offsets.shape[0] - 1, tb.pair_tri.shape[0]
    live = TB.LIVE_GRAD_ROWS[(variant, False)]
    rng = np.random.default_rng(11)
    fmat = rng.normal(size=(P, 16)).astype(np.float32)
    d = rng.normal(size=(16, ma)).astype(np.float32)
    _, vjp = jax.vjp(lambda f: JR.pack_pair_fields(f, jb, True, live), jnp.asarray(fmat))
    want = np.asarray(vjp(jnp.asarray(d))[0])
    leaf = torch.tensor(fmat, requires_grad=True)
    fields = TR.pack_pair_fields(leaf, tb, live)
    (grad,) = torch.autograd.grad(fields, leaf, torch.as_tensor(d))
    assert rel(grad.numpy(), want) <= 1e-6
    assert torch.equal(grad, old_pack_backward(torch.as_tensor(d), tb, live).t())
    assert not grad[:, live:].any()


@pytest.mark.parametrize("variant,budget", CASES)
def test_contrib_stats_match_jax(variant, budget):
    """The statistics through the map against JAX ``_contrib_stats``: maxes
    exact, sums rel 1e-6; equal to the old route's (the same columns)."""
    jb, tb = bin_both(variant, budget)
    P, ma = tb.tri_offsets.shape[0] - 1, tb.pair_tri.shape[0]
    rng = np.random.default_rng(7)
    pc = rng.uniform(0, 1, size=(2, ma)).astype(np.float32)
    pc[:, tb.pair_tri.numpy() < 0] = 0.0
    ws, wm = (np.asarray(x) for x in JR._contrib_stats(jnp.asarray(pc), jb, P, True))
    gs, gm = TR._contrib_stats(torch.as_tensor(pc), tb)
    np.testing.assert_array_equal(gm.numpy(), wm)
    assert rel(gs.numpy(), ws) <= 1e-6
    os_, om = old_contrib_stats(torch.as_tensor(pc), tb)
    assert torch.equal(gs, os_) and torch.equal(gm, om)


@pytest.mark.parametrize("variant,stats", [("2D", False), ("2D", True), ("3D", False),
                                           ("3D", True), ("GS", True)])
def test_rasterize_sorts_once(monkeypatch, variant, stats):
    """One rasterize forward + backward on the CPU calls ``torch.sort``
    exactly once (binning's key sort) and no other sort: the pack backward
    and the statistics read B3's map."""
    calls = []
    for mod, name in ((torch, "sort"), (torch, "argsort"), (torch.Tensor, "sort"),
                      (torch.Tensor, "argsort")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    cam = t_camera(W, H, device="cpu")
    st = TRS(image_width=W, image_height=H, rasterizer_type=variant)
    if variant == "GS":
        s = make_gs_scene(150, seed=4)
        leaves = [torch.tensor(s[k], requires_grad=True)
                  for k in ("xyz", "scale", "rot", "opacity", "rgb")]
        out = TR.rasterize_gaussian(*leaves[:4], None, cam, st, colors=leaves[4],
                                    need_stats=stats)
    else:
        s = make_random_scene(150, seed=4)
        leaves = [torch.tensor(s[k], requires_grad=True) for k in ("vertex", "opacity", "rgb")]
        out = TR.rasterize(leaves[0], leaves[1], None, cam, st, colors=leaves[2],
                           need_stats=stats)
    grads = torch.autograd.grad(out["render"].square().sum(), leaves)
    assert calls == ["sort"]
    assert any(float(g.abs().max()) > 0 for g in grads)
    if stats:
        assert float(out["contrib_sum"].max()) > 0
