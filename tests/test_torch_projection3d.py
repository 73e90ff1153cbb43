"""Port 3D-variant geometry vs the JAX package on the same numpy inputs:
``preprocess_3d``, ``triangle_field_matrix_3d`` and its VJP, binning at the
mesh recipe's 2,500 tiles (1600x1600 in 32x32 tiles) and the dense
``blend_oracle_3d``."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.ops.binning import bin_triangles as j_bin
from triangle_splatting_tpu.ops.oracle import blend_oracle_3d as j_oracle
from triangle_splatting_tpu.ops.projection import Preprocessed3D as JPrep
from triangle_splatting_tpu.ops.projection import RasterSettings as JRS
from triangle_splatting_tpu.ops.projection import preprocess_3d as j_pre
from triangle_splatting_tpu.ops.rasterize import triangle_field_matrix_3d as j_fmat
from triangle_splatting_tpu.utils.camera import Camera as JCamera
from triangle_splatting_tpu.utils.testing import make_random_scene
from triangle_splatting_tpu_torch.ops.binning import bin_triangles as t_bin
from triangle_splatting_tpu_torch.ops.binning import depth_bits_for
from triangle_splatting_tpu_torch.ops.oracle import blend_oracle_3d as t_oracle
from triangle_splatting_tpu_torch.ops.projection import Preprocessed3D as TPrep
from triangle_splatting_tpu_torch.ops.projection import RasterSettings as TRS
from triangle_splatting_tpu_torch.ops.projection import preprocess_3d as t_pre
from triangle_splatting_tpu_torch.ops.rasterize import triangle_field_matrix_3d as t_fmat
from triangle_splatting_tpu_torch.utils.camera import Camera as TCamera
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FLOAT_FIELDS = ("v1_view", "v2_view", "v3_view", "normal_view", "rgb")


def orbit_pose(theta):
    """A non-trivial camera (R, T) looking at the random scene's center
    (0, 0, 4.5) from radius 4."""
    center = np.array([0.0, 0.0, 4.5])
    eye = center + np.array([-4 * np.sin(theta), 0.7, -4 * np.cos(theta)])
    fwd = (center - eye) / np.linalg.norm(center - eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, -up, fwd, eye
    w2c = np.linalg.inv(c2w)
    return w2c[:3, :3].T, w2c[:3, 3]


def both_cameras(W=64, H=48, theta=0.4):
    R, T = orbit_pose(theta)
    kw = dict(R=R, T=T, fovx=math.radians(55), image_width=W, image_height=H)
    return JCamera.create(**kw), TCamera.create(**kw, device="cpu")


def rel(got, want):
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


@functools.lru_cache(maxsize=None)
def jax_prep(P, W, H, seed, gamma, back=False, alive_every=0, theta=0.4):
    """The JAX ``preprocess_3d`` of a random scene as numpy arrays, plus
    the scene and the settings (cached: read-only, shared by tests)."""
    s = make_random_scene(P, seed=seed)
    s["vertex"][:10] = 0.0                     # dead zero triangles
    jc, _ = both_cameras(W, H, theta)
    alive = np.arange(P) % alive_every != 0 if alive_every else None
    st = JRS(image_width=W, image_height=H, back_culling=back,
             rasterizer_type="3D", rich_info=False)
    prep = j_pre(jnp.asarray(s["vertex"]), jnp.zeros((P, 2)), jnp.asarray(s["rgb"]),
                 jc.world_view, jc.full_proj, jc.tan_fovx, jc.tan_fovy, st,
                 alive_mask=None if alive is None else jnp.asarray(alive),
                 opacity=jnp.asarray(s["opacity"]), gamma=jnp.float32(gamma))
    arrs = {f.name: np.array(getattr(prep, f.name)) for f in dataclasses.fields(prep)}
    return s, alive, arrs


@pytest.mark.parametrize("gamma,back,alive_every", [(1.0, False, 7), (50.0, True, 0)])
def test_preprocess_3d_matches_jax(gamma, back, alive_every):
    P, W, H = 400, 64, 48
    s, alive, want = jax_prep(P, W, H, 3, gamma, back, alive_every)
    _, tc = both_cameras(W, H)
    got = t_pre(torch.as_tensor(s["vertex"]), torch.zeros((P, 2)),
                torch.as_tensor(s["rgb"]), tc.world_view, tc.full_proj,
                tc.tan_fovx, tc.tan_fovy,
                TRS(image_width=W, image_height=H, back_culling=back,
                    rasterizer_type="3D", rich_info=False),
                alive_mask=None if alive is None else torch.as_tensor(alive),
                opacity=torch.as_tensor(s["opacity"]), gamma=torch.tensor(gamma))
    valid = want["valid"]
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert P // 4 < valid.sum() < P - 10
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name).numpy(), want[f.name]
        if w.dtype.kind in "iub":
            # culling, tile rects, counts and radii: exact on every triangle
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            # the same float32 operations in the same order; XLA may
            # contract a*b+c into one FMA, so a few ulp of each field's scale
            assert rel(g[valid], w[valid]) <= 1e-5, (f.name, rel(g[valid], w[valid]))


def test_center2d_offset_gradient_is_view_xy_vertex_gradient():
    """The statistics hook shifts every vertex's view-space xy: its
    gradient is the sum of the three view-space xy vertex gradients."""
    P, W, H = 60, 64, 48
    s = make_random_scene(P, seed=2)
    _, tc = both_cameras(W, H)
    c2d = torch.zeros((P, 2), requires_grad=True)
    prep = t_pre(torch.as_tensor(s["vertex"]), c2d, torch.as_tensor(s["rgb"]),
                 tc.world_view, tc.full_proj, tc.tan_fovx, tc.tan_fovy,
                 TRS(image_width=W, image_height=H, rasterizer_type="3D"))
    w = torch.as_tensor(np.random.default_rng(0).normal(size=(P, 3, 3)), dtype=torch.float32)
    vv = torch.stack([prep.v1_view, prep.v2_view, prep.v3_view], 1)
    g, gv = torch.autograd.grad((vv * w).sum(), [c2d, vv])
    torch.testing.assert_close(g, gv[..., :2].sum(1), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("gamma", [1.0, 7.3])
def test_field_matrix_3d_and_vjp_match_jax(gamma):
    P, W, H = 400, 64, 48
    _, _, arrs = jax_prep(P, W, H, 3, gamma)
    jc, tc = both_cameras(W, H)
    rng = np.random.default_rng(11)
    opac = rng.uniform(0.2, 0.9, P).astype(np.float32)
    ct = rng.normal(size=(P, 16)).astype(np.float32)
    ct[:, 14:] = 0.0

    def jfn(v1, v2, v3, n, rgb, o):
        prep = JPrep(**{**{k: jnp.asarray(v) for k, v in arrs.items()},
                        "v1_view": v1, "v2_view": v2, "v3_view": v3,
                        "normal_view": n, "rgb": rgb})
        return j_fmat(prep, o, jc.tan_fovx, jc.tan_fovy, W, H)

    jargs = [jnp.asarray(arrs[k]) for k in FLOAT_FIELDS] + [jnp.asarray(opac)]
    want, vjp = jax.vjp(jfn, *jargs)
    want_g = vjp(jnp.asarray(ct))

    targs = [torch.tensor(arrs[k], requires_grad=True) for k in FLOAT_FIELDS]
    targs.append(torch.tensor(opac, requires_grad=True))
    prep = TPrep(**{**{k: torch.as_tensor(v) for k, v in arrs.items()},
                    **dict(zip(FLOAT_FIELDS, targs[:5]))})
    got = t_fmat(prep, targs[5], tc.tan_fovx, tc.tan_fovy, W, H)
    got_g = torch.autograd.grad(got, targs, torch.as_tensor(ct))

    valid = arrs["valid"]
    got_v, want_v = got.detach().numpy(), np.asarray(want)
    assert not got_v[~valid].any()
    for k in range(16):
        # per field: u1/u2 cancel C23*n against k*(n x (v2 - v3)), so each
        # field is held to its own scale
        assert rel(got_v[valid, k], want_v[valid, k]) <= 1e-5, (k, rel(got_v[valid, k], want_v[valid, k]))
    for name, g, w in zip(FLOAT_FIELDS + ("opacity",), got_g, want_g):
        assert rel(g.numpy(), np.asarray(w)) <= 1e-5, (name, rel(g.numpy(), np.asarray(w)))


def test_binning_at_2500_tiles_integer_exact():
    """The mesh recipe renders 800^2 views at 1600^2: 2,500 tiles, so the
    fused (tile, depth) key keeps 18 depth bits. Every ``Binning`` field
    matches the JAX function on the same 3D preprocess."""
    P, W, H = 300, 1600, 1600
    assert depth_bits_for(2500) == 18 and (2500 << 18) < 2 ** 31
    _, _, arrs = jax_prep(P, W, H, 5, 1.0, theta=0.1)
    assert int(arrs["tiles_touched"].max()) > 50
    max_pairs = 128 * (int(arrs["tiles_touched"].sum()) // 128 + 2)
    jb = j_bin(JPrep(**{k: jnp.asarray(v) for k, v in arrs.items()}),
               JRS(image_width=W, image_height=H), max_pairs, interpret=True,
               compute_pack_perm=True)
    tb = t_bin(TPrep(**{k: torch.as_tensor(v) for k, v in arrs.items()}),
               TRS(image_width=W, image_height=H), max_pairs)
    assert not bool(jb.overflow)
    n = int(tb.num_pairs)
    for f in dataclasses.fields(tb):
        want, got = np.asarray(getattr(jb, f.name)), getattr(tb, f.name).numpy()
        assert got.dtype == want.dtype, f.name
        if f.name == "pack_perm":
            # the owner-order map: defined on the binned pairs
            want, got = want[:n], got[:n]
        np.testing.assert_array_equal(got, want, err_msg=f.name)


@pytest.mark.parametrize("gamma", [1.0, 7.3, 50.0])
def test_blend_oracle_3d_matches_jax(gamma):
    """The two direct ray-plane oracles: the same float32 arithmetic, a few
    ulp apart; n_contrib exact. XLA's log/exp differ from PyTorch's by an
    ulp, and alpha = o * exp(-0.5 * ecc^(2 gamma)) multiplies a relative
    error of ecc by 2 gamma, so the budget is 2e-5 (the 2D kernels' budget)
    widened by gamma / 5 past gamma = 5."""
    P, W, H = 150, 64, 48
    _, _, arrs = jax_prep(P, W, H, 1, gamma)
    jc, tc = both_cameras(W, H)
    opac = np.random.default_rng(4).uniform(0.3, 0.95, P).astype(np.float32)
    st = dict(image_width=W, image_height=H, rasterizer_type="3D")
    want = j_oracle(JPrep(**{k: jnp.asarray(v) for k, v in arrs.items()}),
                    jnp.asarray(opac), gamma, jnp.ones(3), 10.0, jc.tan_fovx,
                    jc.tan_fovy, JRS(**st))
    got = t_oracle(TPrep(**{k: torch.as_tensor(v) for k, v in arrs.items()}),
                   torch.as_tensor(opac), gamma, torch.ones(3), 10.0,
                   tc.tan_fovx, tc.tan_fovy, TRS(**st))
    np.testing.assert_array_equal(got.n_contrib.numpy(), np.asarray(want.n_contrib))
    assert int(np.asarray(want.n_contrib).max()) > 1
    tol = 2e-5 * max(1.0, gamma / 5.0)
    # color, final_T in [0, 1]; depth (bg 10), normal (raw, |n| ~0.1) and
    # the per-triangle contribution sums (up to ~30) against their scale
    for name in ("color", "final_T", "depth", "normal", "contrib_sum"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert rel(g, w) <= tol, (name, rel(g, w))
