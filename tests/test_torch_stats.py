"""The statistics slice of the port vs the JAX package: B1's per-pair
contribution stream (the plain version the CPU runs) against the Pallas
kernel in interpret mode, B5 ``segment_reduce_stats`` against its Pallas
twin, and ``rasterize(need_stats=True)`` in variants "2D" and "3D", with
rich info off and on, against the JAX Pallas pipeline and both dense
oracles."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.ops.binning import bin_triangles
from triangle_splatting_tpu.ops.pallas import blend as JB
from triangle_splatting_tpu.ops.pallas import streams as JS
from triangle_splatting_tpu.ops.projection import Preprocessed as JPrep
from triangle_splatting_tpu.ops.projection import RasterSettings as JRS
from triangle_splatting_tpu.ops.projection import preprocess_2d, preprocess_3d
from triangle_splatting_tpu.ops.rasterize import (pack_pair_fields, triangle_field_matrix,
                                                  triangle_field_matrix_3d)
from triangle_splatting_tpu.ops.rasterize import _contrib_stats as j_contrib_stats
from triangle_splatting_tpu.ops.rasterize import rasterize as j_rasterize
from triangle_splatting_tpu.utils.testing import make_camera as j_camera
from triangle_splatting_tpu.utils.testing import make_random_scene
from triangle_splatting_tpu_torch.ops.binning import bin_triangles as t_bin
from triangle_splatting_tpu_torch.ops.cuda import blend as TB
from triangle_splatting_tpu_torch.ops.cuda import streams as TS
from triangle_splatting_tpu_torch.ops.projection import Preprocessed as TPrep
from triangle_splatting_tpu_torch.ops.projection import RasterSettings as TRS
from triangle_splatting_tpu_torch.ops.rasterize import _contrib_stats as t_contrib_stats
from triangle_splatting_tpu_torch.ops.rasterize import rasterize as t_rasterize
from triangle_splatting_tpu_torch.utils.testing import make_camera as t_camera
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

GEO = dict(tile_h=32, tile_w=32)
# The JAX package's budget for the contribution statistics of its Pallas
# pipeline against the dense oracle (tests/test_rasterize.py
# test_contrib_stats): per-pixel T comes from a Hillis-Steele prefix
# product there and a sequential one here, so contributions differ by
# ulps, and such an ulp may flip an isolated (pair, pixel) across the
# alpha >= 1/255 or T > 1e-4 cut.
STATS_ATOL = 5e-4
CASES = [
    # (variant, P, W, H, seed, gamma, opacity_range)
    ("2D", 150, 64, 64, 0, 1.0, (0.3, 0.95)),
    ("2D", 150, 64, 64, 1, 1.0, (0.8, 0.95)),   # opaque stack: T crosses 1e-4
    ("2D", 200, 80, 48, 2, 50.0, (0.3, 0.95)),  # partial tiles, solidify gamma
    ("3D", 150, 64, 64, 0, 1.0, (0.3, 0.95)),
    ("3D", 150, 64, 64, 1, 1.0, (0.8, 0.95)),
    ("3D", 200, 80, 48, 3, 50.0, (0.3, 0.95)),
]


@functools.lru_cache(maxsize=None)
def packed_inputs(variant, P, W, H, seed, gamma, opacity_range):
    """Numpy (pairs, tile_starts, tile_counts, params) from the JAX
    pipeline (cached: read-only arrays shared by the tests)."""
    s = make_random_scene(P, seed=seed, opacity_range=opacity_range)
    st = JRS(image_width=W, image_height=H, rich_info=False, rasterizer_type=variant)
    cam = j_camera(W, H)
    op = jnp.asarray(s["opacity"])
    pre = preprocess_2d if variant == "2D" else preprocess_3d
    prep = pre(jnp.asarray(s["vertex"]), jnp.zeros((P, 2)), jnp.asarray(s["rgb"]),
               cam.world_view, cam.full_proj, cam.tan_fovx, cam.tan_fovy, st,
               opacity=op, gamma=jnp.float32(gamma))
    b = bin_triangles(prep, st, 128 * 16, interpret=True)
    assert not bool(b.overflow)
    if variant == "2D":
        fmat = triangle_field_matrix(prep, op)
    else:
        fmat = triangle_field_matrix_3d(prep, op, cam.tan_fovx, cam.tan_fovy, W, H)
    fields = pack_pair_fields(fmat, b, True, TB.LIVE_GRAD_ROWS[(variant, False)])
    params = np.array([gamma, 1.0, 0.9, 0.8, 10.0, 0, 0, 0], np.float32)
    return (np.array(fields), np.array(b.tile_starts), np.array(b.tile_counts), params)


def real_slots(ts, tc):
    return np.concatenate([np.arange(ts[t], ts[t] + tc[t]) for t in range(tc.shape[0])])


@pytest.mark.parametrize("case", CASES)
def test_stats_stream_plain_matches_jax(case):
    variant, P, W, H = case[:4]
    gamma = case[5]
    inp = packed_inputs(*case)
    geo = dict(image_width=W, image_height=H, variant=variant, **GEO)
    want = np.asarray(JB.blend_forward(
        *(jnp.asarray(a) for a in inp), rich=False, stats=True, interpret=True,
        **geo)[5])
    targs = [torch.as_tensor(a) for a in inp]
    got = TB.blend_forward(*targs, stats=True, **geo)
    plain_off = TB.blend_forward(*targs, **geo)
    # the stream is a side output: the blend outputs do not move
    for a, b in zip(got[:5], plain_off):
        assert torch.equal(a, b)
    pc = got[5].numpy()
    ts, tc = inp[1], inp[2]
    cols = real_slots(ts, tc)
    assert pc.shape == (2, inp[0].shape[1])
    # slots that hold no pair are zero
    mask = np.ones(pc.shape[1], bool)
    mask[cols] = False
    assert not pc[:, mask].any()
    assert (pc >= 0).all() and pc[0, cols].max() > 0
    tol = STATS_ATOL * max(1.0, gamma / 5.0)
    for r in (0, 1):
        d = np.abs(pc[r, cols] - want[r, cols])
        assert d.max() <= tol, (r, d.max())
    # the max is taken over the same per-pixel values as the sum
    assert (pc[1, cols] <= pc[0, cols] * (1 + 1e-6)).all()


def stats_jax(s, e, sc, mc, nvalid=None):
    return [np.asarray(x) for x in JS.segment_reduce_stats(
        jnp.asarray(sc), jnp.asarray(mc), jnp.asarray(s), jnp.asarray(e),
        nvalid=None if nvalid is None else jnp.int32(nvalid), interpret=True)]


def stats_torch(s, e, sc, mc, nvalid=None):
    return [x.numpy() for x in TS.segment_reduce_stats(
        torch.as_tensor(sc), torch.as_tensor(mc), torch.as_tensor(s), torch.as_tensor(e),
        None if nvalid is None else torch.tensor(nvalid, dtype=torch.int32))]


@pytest.mark.parametrize("seed,M,P,maxlen", [
    (0, 128 * 37, 700, 12),        # ~6 pairs per segment, P not a multiple of 256
    (1, 128 * 8, 2000, 1),         # many empty and length-1 segments
    (2, 128 * 64, 9, 2000),        # few giant segments
    (3, 128, 1, 128),              # one segment spanning everything
])
def test_segment_reduce_stats_plain_matches_jax(seed, M, P, maxlen):
    """Sums: float32 against the JAX kernel's three-term bf16 split (exact
    to ulps) and the plain version's float64 prefix sum: rel 1e-5 of the
    largest sum. Maxes: the same float32 values, exact."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, maxlen + 1, P)
    offs = np.minimum(np.concatenate([[0], np.cumsum(counts)]), M)
    s, e = offs[:-1].astype(np.int32), offs[1:].astype(np.int32)
    sc = rng.uniform(0, 2, M).astype(np.float32)
    mc = rng.uniform(0, 1, M).astype(np.float32)
    ws, wm = stats_jax(s, e, sc, mc)
    gs, gm = stats_torch(s, e, sc, mc)
    assert gs.shape == gm.shape == (P,)
    assert np.abs(gs - ws).max() <= 1e-5 * ws.max()
    np.testing.assert_array_equal(gm, wm)
    assert ((gs == 0) == (s == e)).all() and (gm[s == e] == 0).all()


def test_segment_reduce_stats_nan_tail_and_empty_segments():
    """Columns at or past nvalid count as 0 even when they hold NaN; empty
    segments give 0 for both reductions (max identity 0)."""
    M, P, nvalid = 128 * 4, 300, 333
    rng = np.random.default_rng(5)
    counts = np.full(P, 2)
    counts[::4] = 0
    offs = np.minimum(np.concatenate([[0], np.cumsum(counts)]), nvalid + 40)
    s, e = offs[:-1].astype(np.int32), offs[1:].astype(np.int32)
    sc = rng.uniform(0, 1, M).astype(np.float32)
    mc = rng.uniform(0, 1, M).astype(np.float32)
    sc[nvalid:] = np.nan
    mc[nvalid:] = np.nan
    ws, wm = stats_jax(s, e, sc, mc, nvalid)
    gs, gm = stats_torch(s, e, sc, mc, nvalid)
    assert np.isfinite(gs).all() and np.isfinite(gm).all()
    assert (gs[s == e] == 0).all() and (gm[s == e] == 0).all()
    assert (gs[s >= nvalid] == 0).all()
    assert np.abs(gs - ws).max() <= 1e-5 * ws.max()
    np.testing.assert_array_equal(gm, wm)


def test_segment_reduce_stats_rejects_bad_inputs():
    z = torch.zeros(128)
    i = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        TS.segment_reduce_stats(z, z, i.long(), i)
    with pytest.raises(ValueError):
        TS.segment_reduce_stats(z, torch.zeros(256), i, i)


# ---------------------------------------------------------------------------
# B5 through the owner-order map
# ---------------------------------------------------------------------------

MAP_W = MAP_H = 288     # 18 x 18 tiles of 16 x 16: a screen-filling triangle
MAP_TILE = dict(tile_h=16, tile_w=16)   # owns 324 pairs, past one staged round


@functools.lru_cache(maxsize=None)
def map_frame(kind, seed):
    """The port's and the JAX package's binning of one random scene (the
    same numpy preprocess), and a random (2, MA) stream over its slots with
    NaN in every slot that holds no binned pair. "long": triangle 0 covers
    every tile; "overflow": a budget of half the demand."""
    P = 200
    s = make_random_scene(P, seed=seed, size_range=(0.02, 0.2))
    s["vertex"][1:16, :, 2] = -50.0         # behind the camera: empty segments
    jst = JRS(image_width=MAP_W, image_height=MAP_H, rich_info=False, **MAP_TILE)
    cam = j_camera(MAP_W, MAP_H)
    prep = preprocess_2d(jnp.asarray(s["vertex"]), jnp.zeros((P, 2)), jnp.asarray(s["rgb"]),
                         cam.world_view, cam.full_proj, cam.tan_fovx, cam.tan_fovy, jst,
                         opacity=jnp.asarray(s["opacity"]), gamma=jnp.float32(1.0))
    arrs = {k: np.array(v) for k, v in vars(prep).items()}
    if kind == "long":
        arrs["rect_min"][0] = 0
        arrs["rect_max"][0] = (jst.grid_w, jst.grid_h)
        arrs["tiles_touched"][0] = jst.num_tiles
        arrs["valid"][0] = True
    demand = int(arrs["tiles_touched"].sum())
    max_pairs = 128 * (demand // 256 if kind == "overflow" else demand // 128 + 2)
    jb = bin_triangles(JPrep(**{k: jnp.asarray(v) for k, v in arrs.items()}), jst,
                       max_pairs, interpret=True)
    tst = TRS(image_width=MAP_W, image_height=MAP_H, rich_info=False, **MAP_TILE)
    tb = t_bin(TPrep(**{k: torch.as_tensor(v) for k, v in arrs.items()}), tst, max_pairs)
    assert bool(tb.overflow) == (kind == "overflow")
    pair_tri = tb.pair_tri.numpy()
    np.testing.assert_array_equal(pair_tri, np.asarray(jb.pair_tri))
    rng = np.random.default_rng(seed + 100)
    pc = rng.uniform(0.0, 1.0, (2, pair_tri.shape[0])).astype(np.float32)
    pc[:, pair_tri < 0] = np.nan
    return jb, tb, pc


@pytest.mark.parametrize("kind,seed", [("scene", 0), ("scene", 1), ("long", 2),
                                       ("overflow", 3)])
def test_segment_reduce_stats_map_plain_matches_jax_and_old_route(kind, seed):
    """B5's map form (the stream read through ``pack_perm``; on the CPU
    its plain version: the gather, then the owner-sorted plain version) on
    a stream over the port's binning: equal, bit for bit, to the old route
    (``index_select`` through the map, then B5 on the owner-sorted
    columns) and to ``_contrib_stats``, and within the statistics' 5e-4
    abs of the JAX ``_contrib_stats`` (owner sort, Pallas B5 in interpret
    mode), maxes exact. NaN in every slot without a binned pair (past
    num_pairs in owner order) never reaches an output; empty segments give
    0; "long" holds a triangle of 324 pairs (more than the kernel stages a
    round), "overflow" a budget of half the demand."""
    jb, tb, pc = map_frame(kind, seed)
    P = tb.tri_offsets.shape[0] - 1
    want = [np.asarray(x) for x in j_contrib_stats(jnp.asarray(pc), jb, P, True)]
    tpc = torch.as_tensor(pc)
    starts = torch.minimum(tb.tri_offsets[:-1], tb.num_pairs).contiguous()
    ends = torch.minimum(tb.tri_offsets[1:], tb.num_pairs).contiguous()
    got = TS.segment_reduce_stats(tpc[0], tpc[1], starts, ends, tb.num_pairs,
                                  perm=tb.pack_perm)
    cols = tpc.index_select(1, tb.pack_perm)
    old = TS.segment_reduce_stats(cols[0], cols[1], starts, ends, tb.num_pairs)
    piped = t_contrib_stats(tpc, tb)
    for g, o, p_ in zip(got, old, piped):
        assert torch.equal(g, o) and torch.equal(g, p_)
    gs, gm = (x.numpy() for x in got)
    assert np.isfinite(gs).all() and np.isfinite(gm).all()
    empty = (starts == ends).numpy()
    assert empty.sum() >= 15 and not gs[empty].any() and not gm[empty].any()
    assert np.abs(gs - want[0]).max() <= STATS_ATOL
    np.testing.assert_array_equal(gm, want[1])
    if kind == "long":
        assert int((ends - starts).max()) == 324
    if kind == "overflow":
        assert int(ends[-1]) == int(tb.num_pairs) < int(tb.tri_offsets[-1])


# ---------------------------------------------------------------------------
# rasterize(need_stats=True)
# ---------------------------------------------------------------------------

RW = RH = 64


@functools.lru_cache(maxsize=None)
def scene(seed):
    s = make_random_scene(150, seed=seed)
    return {k: s[k] for k in ("vertex", "opacity", "rgb")}


def jax_stats(s, variant, impl, gamma):
    st = JRS(image_width=RW, image_height=RH, rich_info=False, rasterizer_type=variant)
    out = j_rasterize(jnp.asarray(s["vertex"]), jnp.asarray(s["opacity"]), None,
                      j_camera(RW, RH), st, gamma=gamma, background=jnp.ones(3),
                      bg_depth=10.0, colors=jnp.asarray(s["rgb"]), impl=impl,
                      interpret=True, need_stats=True)
    return {k: np.asarray(out[k]) for k in ("contrib_sum", "contrib_max", "render")}


def torch_stats(s, variant, impl, gamma, need_stats=True):
    st = TRS(image_width=RW, image_height=RH, rich_info=False, rasterizer_type=variant)
    out = t_rasterize(torch.as_tensor(s["vertex"]), torch.as_tensor(s["opacity"]), None,
                      t_camera(RW, RH, device="cpu"), st, gamma=gamma,
                      background=torch.ones(3), bg_depth=10.0,
                      colors=torch.as_tensor(s["rgb"]), impl=impl, need_stats=need_stats)
    return {k: out[k].detach().numpy() for k in ("contrib_sum", "contrib_max", "render")}


@pytest.mark.parametrize("variant,seed,gamma", [
    ("2D", 2, 1.0), ("3D", 2, 1.0), ("3D", 4, 50.0)])
def test_rasterize_stats_match_jax_pallas_and_oracles(variant, seed, gamma):
    """contrib_sum / contrib_max of the port's tile pipeline (plain B1
    stream + owner sort + plain B5) against the JAX Pallas pipeline, the
    JAX dense oracle and the port's dense oracle: 5e-4 abs, the JAX
    package's Pallas-vs-oracle budget, widened by gamma / 5 past gamma 5
    (alpha's ecc^(2 gamma) multiplies an ulp of exp/log by 2 gamma)."""
    s = scene(seed)
    got = torch_stats(s, variant, "cuda", gamma)
    tol = STATS_ATOL * max(1.0, gamma / 5.0)
    refs = dict(pallas=jax_stats(s, variant, "pallas", gamma),
                jax_oracle=jax_stats(s, variant, "oracle", gamma),
                port_oracle=torch_stats(s, variant, "oracle", gamma))
    assert got["contrib_sum"].max() > 1.0 and (got["contrib_max"] > 0).sum() > 50
    for name, ref in refs.items():
        for k in ("contrib_sum", "contrib_max"):
            d = np.abs(got[k] - ref[k]).max()
            assert d <= tol, (name, k, d)


def rich_stats(s, variant, impl, gamma, jax):
    """render, depth, normal, n_contrib and the statistics of one render
    with rich info and statistics together."""
    keys = ("render", "depth", "normal", "n_contrib", "contrib_sum", "contrib_max")
    if jax:
        st = JRS(image_width=RW, image_height=RH, rich_info=True, rasterizer_type=variant)
        out = j_rasterize(jnp.asarray(s["vertex"]), jnp.asarray(s["opacity"]), None,
                          j_camera(RW, RH), st, gamma=gamma, background=jnp.ones(3),
                          bg_depth=10.0, colors=jnp.asarray(s["rgb"]), impl=impl,
                          interpret=True, need_stats=True)
        return {k: np.asarray(out[k]) for k in keys}
    st = TRS(image_width=RW, image_height=RH, rich_info=True, rasterizer_type=variant)
    with torch.no_grad():
        out = t_rasterize(torch.as_tensor(s["vertex"]), torch.as_tensor(s["opacity"]), None,
                          t_camera(RW, RH, device="cpu"), st, gamma=gamma,
                          background=torch.ones(3), bg_depth=10.0,
                          colors=torch.as_tensor(s["rgb"]), impl=impl, need_stats=True)
    return {k: out[k].numpy() for k in keys}


@pytest.mark.parametrize("variant,seed,gamma", [("2D", 2, 1.0), ("3D", 2, 1.0),
                                                ("3D", 4, 50.0)])
def test_rasterize_rich_stats_match_jax_pallas_and_oracles(variant, seed, gamma):
    """rasterize with rich info and statistics together (B1's rich form
    with the stream, then owner sort and B5) against the JAX Pallas
    pipeline and the JAX and port dense oracles, which run the same
    combination: n_contrib exact, render 1e-3 abs, depth and normal rel
    1e-3 of their max (test_torch_rich's budgets) and the statistics 5e-4
    abs, each widened by gamma / 5 past gamma 5 (an ulp of exp/log times
    2 gamma); and the same statistics as without rich info, bit for bit."""
    s = scene(seed)
    got = rich_stats(s, variant, "cuda", gamma, jax=False)
    widen = max(1.0, gamma / 5.0)
    tol = STATS_ATOL * widen
    refs = dict(pallas=rich_stats(s, variant, "pallas", gamma, jax=True),
                jax_oracle=rich_stats(s, variant, "oracle", gamma, jax=True),
                port_oracle=rich_stats(s, variant, "oracle", gamma, jax=False))
    assert got["contrib_sum"].max() > 1.0 and np.abs(got["normal"]).max() > 0.1
    for name, ref in refs.items():
        np.testing.assert_array_equal(got["n_contrib"], ref["n_contrib"], err_msg=name)
        d = np.abs(got["render"] - ref["render"]).max()
        assert d <= 1e-3 * widen, (name, d)
        for k in ("depth", "normal"):
            d = np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max()
            assert d <= 1e-3 * widen, (name, k, d)
        for k in ("contrib_sum", "contrib_max"):
            d = np.abs(got[k] - ref[k]).max()
            assert d <= tol, (name, k, d)
    plain = torch_stats(s, variant, "cuda", gamma)
    for k in ("contrib_sum", "contrib_max", "render"):
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)


def test_need_stats_changes_only_the_statistics():
    """need_stats=False changes only the statistics (zeros): the render and
    the gradients are those of the stats path bit for bit."""
    s = scene(2)
    res = {}
    for need in (True, False):
        leaves = [torch.tensor(s[k], requires_grad=True) for k in ("vertex", "opacity", "rgb")]
        st = TRS(image_width=RW, image_height=RH, rich_info=False, rasterizer_type="3D")
        out = t_rasterize(leaves[0], leaves[1], None, t_camera(RW, RH, device="cpu"), st,
                          gamma=1.0, background=torch.ones(3), bg_depth=10.0,
                          colors=leaves[2], need_stats=need)
        grads = torch.autograd.grad(out["render"].sum() + out["final_T"].sum(), leaves)
        res[need] = (out, grads)
    (o1, g1), (o2, g2) = res[True], res[False]
    for k in ("render", "final_T", "n_contrib"):
        assert torch.equal(o1[k], o2[k])
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    assert not o2["contrib_sum"].any() and not o2["contrib_max"].any()
    assert o1["contrib_sum"].any() and not o1["contrib_sum"].requires_grad
