"""Port kernels B1 (blend_forward) and B2 (blend_backward): the plain PyTorch
versions the CPU runs, held against the JAX Pallas kernels (interpret mode)
on identical packed pair buffers built by the JAX pipeline, and B2 against
float64 autograd of the plain B1."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.ops.binning import bin_triangles
from triangle_splatting_tpu.ops.pallas import blend as JB
from triangle_splatting_tpu.ops.projection import RasterSettings, preprocess_2d
from triangle_splatting_tpu.ops.rasterize import pack_pair_fields, triangle_field_matrix
from triangle_splatting_tpu.utils.testing import make_camera, make_random_scene
from triangle_splatting_tpu_torch.ops.cuda import blend as TB
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CASES = [
    # (P, W, H, seed, gamma, opacity_range)
    (150, 64, 64, 0, 1.0, (0.3, 0.95)),
    (150, 64, 64, 1, 1.0, (0.8, 0.95)),    # opaque stack: T crosses 1e-4
    (200, 80, 48, 2, 3.7, (0.3, 0.95)),    # partial tiles, gamma != 1
]


@functools.lru_cache(maxsize=None)
def packed_inputs(P, W, H, seed, gamma, opacity_range):
    """Numpy (pairs, tile_starts, tile_counts, params) from the JAX pipeline
    (cached: read-only arrays shared by the tests of one case)."""
    s = make_random_scene(P, seed=seed, opacity_range=opacity_range)
    st = RasterSettings(image_width=W, image_height=H, rich_info=False)
    cam = make_camera(W, H)
    op = jnp.asarray(s["opacity"])
    prep = preprocess_2d(jnp.asarray(s["vertex"]), jnp.zeros((P, 2)),
                         jnp.asarray(s["rgb"]), cam.world_view, cam.full_proj,
                         cam.tan_fovx, cam.tan_fovy, st, opacity=op,
                         gamma=jnp.float32(gamma))
    b = bin_triangles(prep, st, 128 * 16, interpret=True)
    assert not bool(b.overflow)
    fields = pack_pair_fields(triangle_field_matrix(prep, op), b, True, 10)
    params = np.array([gamma, 1.0, 0.9, 0.8, 10.0, 0, 0, 0], np.float32)
    return (np.asarray(fields), np.asarray(b.tile_starts),
            np.asarray(b.tile_counts), params)


def jax_forward(inp, W, H):
    return [np.asarray(x) for x in JB.blend_forward(
        *(jnp.asarray(a) for a in inp), image_width=W, image_height=H,
        tile_h=32, tile_w=32, rich=False, stats=False, interpret=True)[:5]]


def torch_args(inp, dtype=torch.float32):
    pairs, ts, tc, params = inp
    return (torch.as_tensor(np.array(pairs)).to(dtype), torch.as_tensor(np.array(ts)),
            torch.as_tensor(np.array(tc)), torch.as_tensor(params).to(dtype))


def cotangents(W, H, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, H, W)).astype(np.float32) / (3 * H * W),
            rng.normal(size=(H, W)).astype(np.float32) / (H * W))


def real_slots(ts, tc):
    """Columns of the real pairs (the JAX backward leaves the slots past the
    last tile unwritten)."""
    return np.concatenate([np.arange(ts[t], ts[t] + tc[t]) for t in range(tc.shape[0])])


def row_rel_err(got, want, cols, rows=10):
    """max |got - want| per field row over that row's max |want|."""
    got, want = got[:rows, cols], want[:rows, cols]
    scale = np.maximum(np.abs(want).max(axis=1), 1e-30)
    return float((np.abs(got - want).max(axis=1) / scale).max())


@pytest.mark.parametrize("case", CASES)
def test_forward_plain_matches_jax(case):
    P, W, H, seed, gamma, orange = case
    inp = packed_inputs(*case)
    want = jax_forward(inp, W, H)
    before = dict(TB.blend_forward.launches)
    got = [x.numpy() for x in TB.blend_forward(
        *torch_args(inp), image_width=W, image_height=H, tile_h=32, tile_w=32)]
    assert TB.blend_forward.launches == before      # CPU: plain version
    # color / final_T: abs 1e-5 (f32 sums in another order than the MXU
    # accumulation, Hillis-Steele vs sequential transmittance products).
    # XLA's exp differs from PyTorch's by an ulp on ~10% of inputs, which
    # can flip the alpha >= 1/255 mask of a single (pair, pixel); such a
    # flip moves its pixel by <= T/255, so a few isolated pixels (<= 0.1%)
    # may exceed 1e-5 but stay inside the 1e-3/pixel budget (PARITY.md).
    for k in (0, 3):
        d = np.abs(got[k] - want[k]).reshape(-1, H, W).max(axis=0)
        assert (d > 1e-5).mean() <= 1e-3 and d.max() <= 1e-3, (k, d.max())
    np.testing.assert_allclose(got[1], got[3] * 10.0, rtol=1e-6)  # T * bg_depth
    assert (got[2] == 0).all()
    # n_contrib: the early-termination count is bit-exact
    np.testing.assert_array_equal(got[4], want[4])


@pytest.mark.parametrize("case", CASES)
def test_backward_plain_matches_jax(case):
    P, W, H, seed, gamma, orange = case
    inp = packed_inputs(*case)
    _, _, _, final_T, n_contrib = jax_forward(inp, W, H)
    g_color, g_T = cotangents(W, H)
    want = np.asarray(JB.blend_backward(
        *(jnp.asarray(a) for a in inp), jnp.asarray(final_T), jnp.asarray(n_contrib),
        jnp.asarray(g_color), jnp.zeros((H, W)), jnp.zeros((3, H, W)),
        jnp.asarray(g_T), image_width=W, image_height=H, tile_h=32, tile_w=32,
        rich=False, interpret=True))
    got = TB.blend_backward(
        *torch_args(inp), torch.as_tensor(np.array(final_T)), torch.as_tensor(np.array(n_contrib)),
        torch.as_tensor(g_color), torch.as_tensor(g_T), image_width=W,
        image_height=H, tile_h=32, tile_w=32).numpy()
    # the JAX backward sums pixels with bf16 matmuls (blend.py:791-918):
    # both operands of each product are rounded to bf16 (unit roundoff
    # 2^-9 each), so rel 2 * 2^-9 ~ 4e-3 of each row's max
    pairs, ts, tc, _ = inp
    assert row_rel_err(got, want, real_slots(ts, tc)) <= 4e-3
    assert (got[10:] == 0).all()
    # padding slots and the tail past the last tile carry no gradient
    for t in range(tc.shape[0]):
        assert (got[:, ts[t] + tc[t]:ts[t + 1]] == 0).all()
    assert (got[:, ts[-1]:] == 0).all()


@pytest.mark.parametrize("case", CASES)
def test_backward_plain_matches_float64_autograd(case):
    """The explicit back-to-front recurrence equals autograd through the
    dense forward; in float64 the only difference is rounding."""
    P, W, H, seed, gamma, orange = case
    inp = packed_inputs(*case)
    pairs, ts, tc, params = torch_args(inp, torch.float64)
    pairs.requires_grad_(True)
    geo = dict(image_width=W, image_height=H, tile_h=32, tile_w=32)
    color, _, _, final_T, n_contrib = TB.blend_forward_plain(pairs, ts, tc, params, **geo)
    g_color, g_T = (torch.as_tensor(g).double() for g in cotangents(W, H))
    want = torch.autograd.grad((color * g_color).sum() + (final_T * g_T).sum(), pairs)[0]
    got = TB.blend_backward(pairs.detach(), ts, tc, params, final_T.detach(),
                            n_contrib, g_color, g_T, **geo)
    cols = real_slots(ts.numpy(), tc.numpy())
    assert row_rel_err(got.numpy(), want.numpy(), cols) <= 1e-9


@pytest.mark.parametrize("mangled,name", [
    ("_ZN48_GLOBAL__N__0b5508f7_15_parent_blend_cu_db7cfa6a20blend_forward_kernelEPKfiPKiS3_S1_iiiiiPfS4_S4_S4_Pi",
     "blend_forward_kernel"),
    ("_ZN40_GLOBAL__N__230fffe1_8_blend_cu_db7cfa6a21blend_backward_kernelILb0EEEvPKfiPKiS4_S2_iiiiiiS2_S4_S2_S2_Pf",
     "blend_backward_kernel<false>"),
    ("_ZN40_GLOBAL__N__230fffe1_8_blend_cu_db7cfa6a20blend_forward_kernelILb1EEEvPKfiPKiS4_S2_iiiiiPfS5_S5_S5_Pi",
     "blend_forward_kernel<true>"),
    ("_ZN40_GLOBAL__N__230fffe1_8_blend_cu_db7cfa6a20blend_forward_kernelILb1ELb0EEEvPKfiPKiS4_S2_iiiiiPfS5_S5_S5_PiS5_",
     "blend_forward_kernel<true, false>"),
    ("_ZN40_GLOBAL__N__230fffe1_8_blend_cu_db7cfa6a20blend_forward_kernelILb1ELb0ELb1EEEvPKfiPKiS4_S2_iiiiiPfS5_S5_S5_PiS5_",
     "blend_forward_kernel<true, false, true>"),
])
def test_kernel_name_reads_mangled_entries(mangled, name):
    """The names ptxas and cuobjdump print for the blend kernels, before
    and after they became ``template <bool k3D>`` and the forward
    ``template <bool k3D, bool kStats>``, then ``<..., bool kRich>``; an
    old kernel's counterpart is the instantiation with one more, trailing,
    ``false``."""
    from triangle_splatting_tpu_torch.ops.cuda.compare_sass import counterpart, kernel_name
    assert kernel_name(mangled) == name
    assert counterpart("blend_forward_kernel<true>") == "blend_forward_kernel<true, false>"
    assert counterpart("blend_forward_kernel") == "blend_forward_kernel<false>"
    assert counterpart("blend_forward_kernel<true, true>") == \
        "blend_forward_kernel<true, true, false>"


def test_launch_counts_by_kernel_and_variant():
    from triangle_splatting_tpu_torch.ops.cuda import launch_counts, reset_launches
    from triangle_splatting_tpu_torch.ops.cuda import streams as TS
    saved = {fn: fn.launches for fn in (TB.blend_forward, TB.blend_backward,
                                        TS.relayout_pairs, TS.segment_reduce_pairs,
                                        TS.segment_reduce_stats)}
    try:
        TB.blend_backward.launches = dict(TB.blend_backward.launches, **{"2D": 2, "3D": 5,
                                                                          "3D_rich": 6})
        TB.blend_forward.launches = dict(TB.blend_forward.launches, **{"3D_stats": 3,
                                                                        "2D_rich": 1})
        TS.segment_reduce_pairs.launches = 7
        TS.segment_reduce_stats.launches = 4
        counts = launch_counts()
        assert counts[("blend_backward", "3D")] == 5 and counts[("blend_backward", "2D")] == 2
        assert counts[("blend_forward", "3D_stats")] == 3
        assert counts[("blend_forward", "2D_rich")] == 1
        assert counts[("blend_backward", "3D_rich")] == 6
        assert counts[("segment_reduce_pairs", None)] == 7
        assert counts[("segment_reduce_stats", None)] == 4
        reset_launches()
        forms = {"blend_forward": [*TB.VARIANTS, *(f"{v}_stats" for v in TB.VARIANTS),
                                   *(f"{v}_rich" for v in TB.VARIANTS), "GS_rich_stats"],
                 "blend_backward": [*TB.VARIANTS, *(f"{v}_rich" for v in TB.VARIANTS)]}
        assert set(launch_counts()) == {(k, v) for k, vs in forms.items() for v in vs} | {
            ("relayout_pairs", None), ("segment_reduce_pairs", None),
            ("segment_reduce_stats", None)}
        assert not any(launch_counts().values())
    finally:
        for fn, n in saved.items():
            fn.launches = n
