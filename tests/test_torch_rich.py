"""Rich info (depth and normal) of kernels B1/B2 and of ``rasterize`` vs the
JAX package: the plain PyTorch versions (which the CPU runs) against the
JAX Pallas kernels in interpret mode and against float64 autograd of the
plain forward, in variants "2D" and "3D" at gamma 1 and 50; the rich
forms' color, final_T and n_contrib bit-identical to the forms without
rich info; ``rasterize(rich_info=True)`` against the JAX ``rasterize`` and
both dense oracles, forward and gradients; B1 with rich info and the
contribution stream together against Pallas."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.ops.binning import bin_triangles
from triangle_splatting_tpu.ops.pallas import blend as JB
from triangle_splatting_tpu.ops.projection import RasterSettings as JRS
from triangle_splatting_tpu.ops.projection import preprocess_2d, preprocess_3d
from triangle_splatting_tpu.ops.rasterize import (pack_pair_fields, triangle_field_matrix,
                                                  triangle_field_matrix_3d)
from triangle_splatting_tpu.ops.rasterize import rasterize as j_rasterize
from triangle_splatting_tpu.utils.testing import make_camera as j_camera
from triangle_splatting_tpu.utils.testing import make_random_scene
from triangle_splatting_tpu_torch.ops.cuda import blend as TB
from triangle_splatting_tpu_torch.ops.projection import RasterSettings as TRS
from triangle_splatting_tpu_torch.ops.rasterize import rasterize as t_rasterize
from triangle_splatting_tpu_torch.utils.testing import make_camera as t_camera
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

GEO = dict(tile_h=32, tile_w=32)
LIVE = {"2D": 16, "3D": 14}
CASES = [
    # (variant, P, W, H, seed, gamma, opacity_range)
    ("2D", 150, 64, 64, 0, 1.0, (0.3, 0.95)),
    ("2D", 200, 80, 48, 2, 50.0, (0.3, 0.95)),   # partial tiles
    ("3D", 150, 64, 64, 1, 1.0, (0.8, 0.95)),    # opaque stack: T crosses 1e-4
    ("3D", 200, 64, 64, 3, 50.0, (0.3, 0.95)),
]


def rel(got, want):
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


@functools.lru_cache(maxsize=None)
def packed_inputs(variant, P, W, H, seed, gamma, opacity_range):
    """Numpy (pairs, tile_starts, tile_counts, params) with every rich
    field, from the JAX pipeline (cached: read-only arrays)."""
    s = make_random_scene(P, seed=seed, opacity_range=opacity_range)
    st = JRS(image_width=W, image_height=H, rich_info=True, rasterizer_type=variant)
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
        sx = sy = 0.0
    else:
        fmat = triangle_field_matrix_3d(prep, op, cam.tan_fovx, cam.tan_fovy, W, H)
        sx, sy = W / (2.0 * float(cam.tan_fovx)), H / (2.0 * float(cam.tan_fovy))
    fields = pack_pair_fields(fmat, b, True, LIVE[variant])
    params = np.array([gamma, 1.0, 0.9, 0.8, 10.0, sx, sy, 0], np.float32)
    return (np.array(fields), np.array(b.tile_starts), np.array(b.tile_counts), params)


def torch_args(inp, dtype=torch.float32):
    pairs, ts, tc, params = inp
    return (torch.as_tensor(pairs).to(dtype), torch.as_tensor(ts),
            torch.as_tensor(tc), torch.as_tensor(params).to(dtype))


def jax_forward(inp, variant, W, H, rich=True):
    return [np.asarray(x) for x in JB.blend_forward(
        *(jnp.asarray(a) for a in inp), image_width=W, image_height=H, rich=rich,
        variant=variant, stats=False, interpret=True, **GEO)[:5]]


def cotangents(W, H, seed=5):
    """Random cotangents of color, final_T, depth and normal."""
    rng = np.random.default_rng(seed)
    n = H * W
    return (rng.normal(size=(3, H, W)).astype(np.float32) / (3 * n),
            rng.normal(size=(H, W)).astype(np.float32) / n,
            rng.normal(size=(H, W)).astype(np.float32) / n,
            rng.normal(size=(3, H, W)).astype(np.float32) / (3 * n))


def real_slots(ts, tc):
    return np.concatenate([np.arange(ts[t], ts[t] + tc[t]) for t in range(tc.shape[0])])


def row_rel_err(got, want, cols, rows):
    """max |got - want| per field row over that row's max |want|."""
    got, want = got[:rows, cols], want[:rows, cols]
    scale = np.maximum(np.abs(want).max(axis=1), 1e-30)
    return float((np.abs(got - want).max(axis=1) / scale).max())


@pytest.mark.parametrize("case", CASES)
def test_forward_rich_plain_matches_jax(case):
    variant, P, W, H, seed, gamma, _ = case
    inp = packed_inputs(*case)
    want = jax_forward(inp, variant, W, H)
    before = dict(TB.blend_forward.launches)
    got = [x.numpy() for x in TB.blend_forward(
        *torch_args(inp), image_width=W, image_height=H, variant=variant, rich=True, **GEO)]
    assert TB.blend_forward.launches == before      # CPU: plain version
    np.testing.assert_array_equal(got[4], want[4])
    assert want[4].max() > 2
    # color / final_T: the budget of the forms without rich info (an ulp
    # of XLA's exp/log times 2 gamma past gamma 5; an isolated 1/255 flip
    # may move a pixel by <= T/255). Depth and normal are sums of the same
    # contributions times their fields, so they take the same budget
    # relative to their largest value (depth: bg_depth 10; the 3D normal
    # is a raw sum of unit normals; the 2D one of the normal fields).
    tol = 2e-5 * max(1.0, gamma / 5.0)
    for k in (0, 3):
        d = np.abs(got[k] - want[k]).reshape(-1, H, W).max(axis=0)
        assert (d > tol).mean() <= 1e-3 and d.max() <= 1e-3, (k, d.max())
    for k in (1, 2):
        scale = float(np.abs(want[k]).max())
        d = np.abs(got[k] - want[k]).reshape(-1, H, W).max(axis=0) / scale
        assert (d > tol).mean() <= 1e-3 and d.max() <= 1e-3, (k, d.max())
    assert np.abs(got[2]).max() > 0.1 and not np.allclose(got[1], got[3] * 10.0)


@pytest.mark.parametrize("case", CASES)
def test_backward_rich_plain_matches_jax(case):
    variant, P, W, H, seed, gamma, _ = case
    inp = packed_inputs(*case)
    _, _, _, final_T, n_contrib = jax_forward(inp, variant, W, H)
    g_color, g_T, g_depth, g_normal = cotangents(W, H)
    want = np.asarray(JB.blend_backward(
        *(jnp.asarray(a) for a in inp), jnp.asarray(final_T), jnp.asarray(n_contrib),
        jnp.asarray(g_color), jnp.asarray(g_depth), jnp.asarray(g_normal),
        jnp.asarray(g_T), image_width=W, image_height=H, rich=True,
        variant=variant, interpret=True, **GEO))
    got = TB.blend_backward(
        *torch_args(inp), torch.as_tensor(final_T), torch.as_tensor(n_contrib),
        torch.as_tensor(g_color), torch.as_tensor(g_T), torch.as_tensor(g_depth),
        torch.as_tensor(g_normal), image_width=W, image_height=H, variant=variant,
        rich=True, **GEO).numpy()
    pairs, ts, tc, _ = inp
    cols = real_slots(ts, tc)
    live = LIVE[variant]
    # The JAX backward sums over pixels with bf16 matmuls (unit roundoff
    # 2^-9 per operand) and the random cotangents make the sums cancel:
    # rel 5e-3 of each row's max, the budget of the forms without rich
    # info. In "3D" the D rows 0..2 are there the sum of two such products
    # (the quotient chain against [1, px, py] and contrib against the
    # normal rows gn0..gn2, whose entries reach |cH| ~ 30 times the
    # cotangent), which cancel further: 2e-2 for them (measured up to
    # 1.2e-2). The float64 test below holds the recurrence to 1e-9.
    first = 3 if variant == "3D" else 0
    assert row_rel_err(got[first:], want[first:], cols, live - first) <= 5e-3
    if first:
        assert row_rel_err(got, want, cols, first) <= 2e-2
    assert (got[live:] == 0).all()
    for t in range(tc.shape[0]):
        assert (got[:, ts[t] + tc[t]:ts[t + 1]] == 0).all()
    assert np.abs(got[live - 1 if variant == "3D" else 15, cols]).max() > 0


@pytest.mark.parametrize("case", CASES)
def test_backward_rich_plain_matches_float64_autograd(case):
    """The explicit back-to-front recurrence with the depth and normal
    cotangents equals autograd through the dense plain forward; in
    float64 the only difference is rounding."""
    variant, P, W, H, seed, gamma, _ = case
    pairs, ts, tc, params = torch_args(packed_inputs(*case), torch.float64)
    pairs.requires_grad_(True)
    geo = dict(image_width=W, image_height=H, variant=variant, **GEO)
    color, depth, normal, final_T, n_contrib = TB.blend_forward_plain(
        pairs, ts, tc, params, rich=True, **geo)
    g_color, g_T, g_depth, g_normal = (torch.as_tensor(g).double() for g in cotangents(W, H))
    value = ((color * g_color).sum() + (final_T * g_T).sum() + (depth * g_depth).sum()
             + (normal * g_normal).sum())
    want = torch.autograd.grad(value, pairs)[0]
    got = TB.blend_backward(pairs.detach(), ts, tc, params, final_T.detach(), n_contrib,
                            g_color, g_T, g_depth, g_normal, rich=True, **geo)
    cols = real_slots(ts.numpy(), tc.numpy())
    live = LIVE[variant]
    assert row_rel_err(got.numpy(), want.numpy(), cols, live) <= 1e-9
    assert not got[live:].any()


@pytest.mark.parametrize("case", CASES)
def test_rich_leaves_color_final_T_n_contrib_bit_identical(case):
    """Rich info only adds accumulators: the rich form's color, final_T and
    n_contrib are those of the form without it, bit for bit; its depth
    and normal are not the rich-off placeholders."""
    variant, P, W, H, seed, gamma, _ = case
    args = torch_args(packed_inputs(*case))
    geo = dict(image_width=W, image_height=H, variant=variant, **GEO)
    on = TB.blend_forward(*args, rich=True, **geo)
    off = TB.blend_forward(*args, **geo)
    for k in (0, 3, 4):
        assert torch.equal(on[k], off[k]), k
    assert not torch.equal(on[1], off[1]) and not off[2].any() and on[2].any()


@pytest.mark.parametrize("case", CASES)
def test_forward_rich_stats_plain_matches_jax(case):
    """Rich info with the contribution stream (one B1 launch, the form the
    triangle renderer facade runs with rich_info) against the Pallas kernel
    in interpret mode, which computes both at once: the outputs of the rich
    form and the stream of the stats form, bit for bit, each within its
    form's budget of Pallas."""
    variant, P, W, H, seed, gamma, _ = case
    inp = packed_inputs(*case)
    geo = dict(image_width=W, image_height=H, variant=variant, **GEO)
    want = [np.asarray(x) for x in JB.blend_forward(
        *(jnp.asarray(a) for a in inp), rich=True, stats=True, interpret=True, **geo)]
    args = torch_args(inp)
    before = dict(TB.blend_forward.launches)
    got = TB.blend_forward(*args, rich=True, stats=True, **geo)
    assert TB.blend_forward.launches == before      # CPU: plain version
    rich = TB.blend_forward(*args, rich=True, **geo)
    stats = TB.blend_forward(*args, stats=True, **geo)
    for k in range(5):
        assert torch.equal(got[k], rich[k]), k
    assert torch.equal(got[5], stats[5])
    got = [x.numpy() for x in got]
    np.testing.assert_array_equal(got[4], want[4])
    # color / final_T, depth / normal: test_forward_rich_plain_matches_jax's
    # budgets; the stream: the stats form's (tests/test_torch_stats.py,
    # 5e-4 abs, widened by gamma / 5)
    tol = 2e-5 * max(1.0, gamma / 5.0)
    for k in (0, 1, 2, 3):
        scale = 1.0 if k in (0, 3) else float(np.abs(want[k]).max())
        d = np.abs(got[k] - want[k]).reshape(-1, H, W).max(axis=0) / scale
        assert (d > tol).mean() <= 1e-3 and d.max() <= 1e-3, (k, d.max())
    pairs, ts, tc, _ = inp
    cols = real_slots(ts, tc)
    empty = np.ones(pairs.shape[1], bool)
    empty[cols] = False
    assert not got[5][:, empty].any() and got[5][0, cols].max() > 0
    assert np.abs(got[5][:, cols] - want[5][:, cols]).max() <= 5e-4 * max(1.0, gamma / 5.0)


# ---------------------------------------------------------------------------
# rasterize(rich_info=True)
# ---------------------------------------------------------------------------

RW = RH = 64
RP = 150
ARGS = ("vertex", "opacity", "rgb", "c2d")


@functools.lru_cache(maxsize=None)
def raster_inputs(seed):
    s = make_random_scene(RP, seed=seed)
    rng = np.random.default_rng(seed + 100)
    n = RH * RW
    return dict(vertex=s["vertex"], opacity=s["opacity"], rgb=s["rgb"],
                c2d=np.zeros((RP, 2), np.float32),
                target=rng.uniform(size=(3, RH, RW)).astype(np.float32),
                w_depth=rng.normal(size=(RH, RW)).astype(np.float32) / n,
                w_normal=rng.normal(size=(3, RH, RW)).astype(np.float32) / n)


def loss_terms(out, inp, xp):
    """L1 against the target (clear of its kink on these scenes), the mean
    final_T, and fixed random linear functionals of depth and normal."""
    return (xp.abs(out["render"] - inp["target"]).mean() + 0.3 * out["final_T"].mean()
            + (out["depth"] * inp["w_depth"]).sum() + (out["normal"] * inp["w_normal"]).sum())


def jax_raster(inp, impl, variant, gamma):
    st = JRS(image_width=RW, image_height=RH, rich_info=True, rasterizer_type=variant)
    cam = j_camera(RW, RH)

    def loss(vertex, opacity, rgb, c2d):
        out = j_rasterize(vertex, opacity, None, cam, st, gamma=gamma,
                          background=jnp.ones(3), bg_depth=10.0, colors=rgb,
                          center2d_offset=c2d, impl=impl, interpret=True,
                          need_stats=False)
        return loss_terms(out, inp, jnp), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(inp[k]) for k in ARGS))
    return ({k: np.asarray(out[k]) for k in ("render", "depth", "normal", "final_T",
                                             "n_contrib")},
            [np.asarray(g) for g in grads])


def torch_raster(inp, impl, variant, gamma):
    st = TRS(image_width=RW, image_height=RH, rich_info=True, rasterizer_type=variant)
    leaves = [torch.tensor(inp[k], requires_grad=True) for k in ARGS]
    out = t_rasterize(leaves[0], leaves[1], None, t_camera(RW, RH, device="cpu"), st,
                      gamma=gamma, background=torch.ones(3), bg_depth=10.0,
                      colors=leaves[2], center2d_offset=leaves[3], impl=impl)
    t_inp = {k: torch.as_tensor(v) for k, v in inp.items()}
    grads = torch.autograd.grad(loss_terms(out, t_inp, torch), leaves)
    return ({k: out[k].detach().numpy() for k in ("render", "depth", "normal", "final_T",
                                                  "n_contrib")},
            [g.numpy() for g in grads])


@pytest.mark.parametrize("variant,seed,gamma", [("2D", 0, 1.0), ("3D", 0, 1.0),
                                                ("3D", 5, 7.3)])
def test_rasterize_rich_matches_jax_pallas_and_oracle(variant, seed, gamma):
    """The port's tile pipeline with rich info (plain kernel versions on
    the CPU) vs the JAX Pallas pipeline and the JAX dense oracle: render,
    depth, normal, final_T, n_contrib and the gradients of a loss that
    reads all four outputs."""
    inp = raster_inputs(seed)
    t_out, t_g = torch_raster(inp, "cuda", variant, gamma)
    for impl, grad_tol in (("pallas", 5e-3), ("oracle", 2e-3)):
        j_out, j_g = jax_raster(inp, impl, variant, gamma)
        np.testing.assert_array_equal(t_out["n_contrib"], j_out["n_contrib"])
        # the budgets of the pipelines without rich info (test_torch_mesh),
        # depth and normal relative to their largest value
        for k in ("render", "final_T"):
            assert np.abs(t_out[k] - j_out[k]).max() <= 1e-3, (impl, k)
        for k in ("depth", "normal"):
            assert rel(t_out[k], j_out[k]) <= 1e-3, (impl, k, rel(t_out[k], j_out[k]))
        # vs Pallas its bf16 pixel sums plus contributor-boundary flips; vs
        # the oracle's AD the flips only
        for name, g, w in zip(ARGS, t_g, j_g):
            assert rel(g, w) <= grad_tol, (impl, name, rel(g, w))


@pytest.mark.parametrize("variant", ["2D", "3D"])
def test_rasterize_rich_matches_port_oracle(variant):
    """The port's own dense oracle (which composites depth and normal
    directly from the preprocessed triangles) against its tile pipeline."""
    inp = raster_inputs(1)
    t_out, t_g = torch_raster(inp, "cuda", variant, 1.0)
    o_out, o_g = torch_raster(inp, "oracle", variant, 1.0)
    np.testing.assert_array_equal(t_out["n_contrib"], o_out["n_contrib"])
    for k in ("render", "depth", "normal", "final_T"):
        assert rel(t_out[k], o_out[k]) <= 1e-4, (k, rel(t_out[k], o_out[k]))
    for name, g, w in zip(ARGS, t_g, o_g):
        assert rel(g, w) <= 2e-3, (name, rel(g, w))


@pytest.mark.parametrize("variant", ["2D", "3D"])
def test_rasterize_rich_off_bit_identical(variant):
    """rich_info only adds outputs: render, final_T and n_contrib of the
    tile pipeline are the same bits with it on and off."""
    inp = raster_inputs(2)
    outs = {}
    for rich in (False, True):
        st = TRS(image_width=RW, image_height=RH, rich_info=rich, rasterizer_type=variant)
        with torch.no_grad():
            outs[rich] = t_rasterize(
                torch.as_tensor(inp["vertex"]), torch.as_tensor(inp["opacity"]), None,
                t_camera(RW, RH, device="cpu"), st, gamma=1.0, background=torch.ones(3),
                bg_depth=10.0, colors=torch.as_tensor(inp["rgb"]))
    for k in ("render", "final_T", "n_contrib"):
        assert torch.equal(outs[True][k], outs[False][k]), k
