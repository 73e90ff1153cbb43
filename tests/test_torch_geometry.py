"""The geometry slice of the MatrixCity mesh recipe in the port vs the JAX
package: the Scharr gradients, the ``jax.image.resize`` "linear"
counterpart (shrinking and growing, odd sizes), ``depth_to_normal`` and
the depth-normal consistency loss (values and gradients), the grid
sampling of the initial point cloud (exact), and opacity pruning and
clipping (exact masks, parameters and Adam moments)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_adc import assert_models_equal, midpoint_of_gap, random_model, to_jax, to_torch
from triangle_splatting_tpu.models import model_utils as JU
from triangle_splatting_tpu.models import triangle as JM
from triangle_splatting_tpu.trainers import losses as JL
from triangle_splatting_tpu_torch.models import model_utils as TU
from triangle_splatting_tpu_torch.models import triangle as TM
from triangle_splatting_tpu_torch.trainers import losses as TL
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TAN = (0.55, 0.32)    # tan(fovx / 2), tan(fovy / 2) of a 1600x900-like view


def rel(got, want):
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def vjp_both(jfn, tfn, x, cot):
    """Value and the VJP of ``cot`` of the JAX and the port function at x."""
    jy, jvjp = jax.vjp(jfn, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty = tfn(tx)
    (tg,) = torch.autograd.grad(ty, tx, torch.as_tensor(cot))
    return (np.asarray(jy), np.asarray(jvjp(jnp.asarray(cot))[0]),
            ty.detach().numpy(), tg.numpy())


def depth_map(H, W, seed=0):
    """A smooth positive depth with two steps (discontinuities the mask
    removes)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    d = 4.0 + 0.3 * np.sin(x / 7.0) + 0.2 * np.cos(y / 5.0) + 0.01 * rng.normal(size=(H, W))
    d[H // 4:H // 2, W // 3:2 * W // 3] -= 1.0
    d[2 * H // 3:, :W // 4] += 0.7
    return d.astype(np.float32)


def test_scharr_matches_jax():
    """conv2d against the JAX separable shift-adds: a few ulp."""
    x = np.random.default_rng(0).uniform(size=(2, 23, 31)).astype(np.float32)
    cot = np.random.default_rng(1).normal(size=(4, 23, 31)).astype(np.float32)
    jy, jg, ty, tg = vjp_both(JL.scharr, TL.scharr, x, cot)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-6)
    jn = np.asarray(JL.scharr(jnp.asarray(x), ret_norm=True))
    np.testing.assert_allclose(TL.scharr(torch.as_tensor(x), ret_norm=True).numpy(), jn,
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape,out", [
    ((3, 64, 48), (32, 24)),      # the loss's scale factor 0.5
    ((45, 61), (22, 30)),         # odd sizes: int(H * 0.5)
    ((1, 22, 30), (45, 61)),      # and back up
    ((2, 16, 16), (32, 40)),      # growing by non-integer factors
    ((2, 40, 16), (17, 37)),      # one axis shrinks, the other grows
])
def test_resize_matches_jax_image_resize(shape, out):
    """Values and the transpose (the VJP) of ``resize_linear`` (the port's
    ``_resize``) against ``jax.image.resize(..., "linear")``: a few ulp of
    the inputs."""
    rng = np.random.default_rng(2)
    x = rng.uniform(size=shape).astype(np.float32)
    cot = rng.normal(size=shape[:-2] + out).astype(np.float32)
    jy, jg, ty, tg = vjp_both(lambda a: JL._resize(a, out),
                              lambda a: TU.resize_linear(a, *out), x, cot)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=4e-6)


@pytest.mark.parametrize("scale_factor", [0.5, None])
def test_depth_to_normal_matches_jax(scale_factor):
    """Normals within 2e-5 (a quotient of Scharr gradients by the depth,
    normalized), the masks equal, and the VJP of a random cotangent of
    the normals within rel 1e-4 of its max."""
    d = depth_map(45, 61)
    cot = np.random.default_rng(3).normal(size=(3, 45, 61)).astype(np.float32)
    jn, jm = JL.depth_to_normal(jnp.asarray(d), *TAN, scale_factor)
    tn, tm = TL.depth_to_normal(torch.as_tensor(d), *TAN, scale_factor)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert 0.05 < 1 - float(tm.mean()) < 0.2 and not tm.requires_grad
    jy, jg, ty, tg = vjp_both(lambda a: JL.depth_to_normal(a, *TAN, scale_factor)[0],
                              lambda a: TL.depth_to_normal(a, *TAN, scale_factor)[0], d, cot)
    assert rel(tg, jg) <= 1e-4, rel(tg, jg)


@pytest.mark.parametrize("scale_factor", [0.5, None])
def test_depth_normal_loss_matches_jax(scale_factor):
    """The loss within rel 1e-6 and its gradients with respect to the
    depth and the rendered normal within rel 1e-4 of their max."""
    d = depth_map(45, 61, seed=1)
    n = np.random.default_rng(4).normal(size=(3, 45, 61)).astype(np.float32)
    n[2] -= 2.0                                   # mostly facing the camera
    jl, (jgd, jgn) = jax.value_and_grad(
        lambda a, b: JL.depth_normal_loss(a, b, *TAN, scale_factor), argnums=(0, 1))(
        jnp.asarray(d), jnp.asarray(n))
    td, tn = torch.tensor(d, requires_grad=True), torch.tensor(n, requires_grad=True)
    tl = TL.depth_normal_loss(td, tn, *TAN, scale_factor)
    tgd, tgn = torch.autograd.grad(tl, [td, tn])
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert rel(tgd.numpy(), np.asarray(jgd)) <= 1e-4
    assert rel(tgn.numpy(), np.asarray(jgn)) <= 1e-4


def test_depth_normal_loss_zero_normal_gradient():
    """Where the rendered normal is exactly 0 (no contributor) the JAX
    gradient is NaN (d|n|/dn of ``jnp.linalg.norm`` at 0, times the zero
    cotangent the 1e-8 clamp leaves it); the port's is finite (PyTorch's
    norm subgradient is 0 there, which leaves the clamp's 1 / 1e-8 times
    the cotangent; the blend backward multiplies it by a zero
    contribution). Elsewhere they agree."""
    d = depth_map(32, 40, seed=2)
    n = np.random.default_rng(5).normal(size=(3, 32, 40)).astype(np.float32)
    n[:, :6, :5] = 0.0
    jg = np.asarray(jax.grad(lambda b: JL.depth_normal_loss(jnp.asarray(d), b, *TAN, 0.5))(
        jnp.asarray(n)))
    tn = torch.tensor(n, requires_grad=True)
    (tg,) = torch.autograd.grad(TL.depth_normal_loss(torch.as_tensor(d), tn, *TAN, 0.5), tn)
    zero = (n == 0).all(0)
    assert np.isnan(jg[:, zero]).all() and np.isfinite(tg.numpy()).all()
    assert rel(tg.numpy()[:, ~zero], jg[:, ~zero]) <= 1e-4


@pytest.mark.parametrize("grid_size", [0.05, 0.21, 1e-7])
def test_grid_sampling_matches_jax(grid_size):
    """Same voxels, same order, same means, bit for bit; 1e-7 overflows the
    mixed-radix key and takes the packed-record keys."""
    rng = np.random.default_rng(6)
    pts = rng.uniform(-1.5, 2.0, (4000, 3)).astype(np.float32)
    cols = rng.uniform(size=(4000, 3)).astype(np.float32)
    nrm = rng.normal(size=(4000, 3)).astype(np.float32)
    np.testing.assert_array_equal(TU._flat_voxel_keys(pts, grid_size),
                                  JU._flat_voxel_keys(pts, grid_size))
    got, want = TU.grid_sampling(pts, cols, nrm, grid_size), JU.grid_sampling(pts, cols, nrm,
                                                                             grid_size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) < 4000 or grid_size == 1e-7


def test_grid_size_search_matches_jax():
    pts = np.random.default_rng(7).uniform(-1, 1, (5000, 3)).astype(np.float32)
    for n in (300, 1200):
        got = TU.grid_size_search(pts, n)
        assert got == JU.grid_size_search(pts, n)
        assert abs(len(TU.grid_sampling(pts, pts, pts, got)[0]) - n) <= 0.1 * n


def test_opacity_pruning_matches_jax():
    p, s, m, v = random_model(8)
    jp, js, jo = to_jax(p, s, m, v)
    tp, ts, to = to_torch(p, s, m, v)
    op = TM.get_opacity(tp)[:, 0].numpy()
    thr, gap = midpoint_of_gap(op[s["alive"]], 0.3)
    assert gap > 1e-5
    *jout, jn = JM.opacity_pruning(jp, jo, js, np.float32(thr))
    *tout, tn = TM.opacity_pruning(tp, to, ts, thr)
    assert_models_equal(jout, tout)
    assert int(tn) == int(jn) == int(((op < thr) & s["alive"]).sum()) > 0


def test_opacity_clipping_matches_jax():
    """Clipped rows get logit 10 and zero opacity moments; every other
    group's moments and every dead row stay as they were."""
    p, s, m, v = random_model(9)
    jp, js, jo = to_jax(p, s, m, v)
    tp, ts, to = to_torch(p, s, m, v)
    op = TM.get_opacity(tp)[:, 0].numpy()
    thr, gap = midpoint_of_gap(op[s["alive"]], 0.8)
    assert gap > 1e-5
    *jout, jn = JM.opacity_clipping(jp, jo, js, np.float32(thr))
    tp2, to2, ts2, tn = TM.opacity_clipping(tp, to, ts, thr)
    assert_models_equal(jout, (tp2, to2, ts2))
    mask = (op > thr) & s["alive"]
    assert int(tn) == int(jn) == int(mask.sum()) > 0
    assert (tp2.opacity[torch.as_tensor(mask)] == 10.0).all()
    assert torch.equal(tp2.opacity[~torch.as_tensor(mask)], tp.opacity[~torch.as_tensor(mask)])
    assert torch.equal(to2.m.vertex, to.m.vertex) and torch.equal(ts2.alive, ts.alive)
