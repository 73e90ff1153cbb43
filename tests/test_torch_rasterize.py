"""Port ``rasterize`` (the tile pipeline through the kernels' plain versions
on the CPU, and the dense oracle) vs the JAX ``rasterize`` (Pallas kernels
in interpret mode) and the JAX dense oracle: render, final_T, n_contrib and
the gradients w.r.t. vertex, opacity, shs and center2d_offset."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.ops.projection import RasterSettings as JRS
from triangle_splatting_tpu.ops.rasterize import rasterize as j_rasterize
from triangle_splatting_tpu.utils.testing import make_camera as j_camera
from triangle_splatting_tpu.utils.testing import make_random_scene
from triangle_splatting_tpu_torch.ops.projection import RasterSettings as TRS
from triangle_splatting_tpu_torch.ops.rasterize import rasterize as t_rasterize
from triangle_splatting_tpu_torch.utils.testing import make_camera as t_camera
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

W = H = 64
P = 150
ARGS = ("vertex", "opacity", "shs", "c2d")


@functools.lru_cache(maxsize=None)
def inputs(seed):
    s = make_random_scene(P, seed=seed)
    rng = np.random.default_rng(seed + 100)
    shs = np.concatenate([s["sh_dc"], 0.2 * rng.normal(size=(P, 15, 3))], 1)
    target = rng.uniform(size=(3, H, W)).astype(np.float32)
    return dict(vertex=s["vertex"], opacity=s["opacity"],
                shs=shs.astype(np.float32), c2d=np.zeros((P, 2), np.float32),
                target=target)


def jax_run(inp, impl):
    st = JRS(image_width=W, image_height=H, rich_info=False)
    cam = j_camera(W, H)

    def loss(vertex, opacity, shs, c2d):
        out = j_rasterize(vertex, opacity, shs, cam, st, gamma=1.0,
                          background=jnp.ones(3), bg_depth=10.0,
                          active_sh_degree=3, center2d_offset=c2d, impl=impl,
                          interpret=True, need_stats=False)
        value = jnp.abs(out["render"] - inp["target"]).mean() + 0.3 * out["final_T"].mean()
        return value, out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(inp[k]) for k in ARGS))
    return ({k: np.asarray(out[k]) for k in ("render", "final_T", "n_contrib")},
            [np.asarray(g) for g in grads])


def torch_run(inp, impl):
    st = TRS(image_width=W, image_height=H, rich_info=False)
    cam = t_camera(W, H, device="cpu")
    leaves = [torch.tensor(inp[k], requires_grad=True) for k in ARGS]
    out = t_rasterize(leaves[0], leaves[1], leaves[2], cam, st, gamma=1.0,
                      background=torch.ones(3), bg_depth=10.0, active_sh_degree=3,
                      center2d_offset=leaves[3], impl=impl)
    value = (out["render"] - torch.as_tensor(inp["target"])).abs().mean() \
        + 0.3 * out["final_T"].mean()
    grads = torch.autograd.grad(value, leaves)
    return ({k: out[k].detach().numpy() for k in ("render", "final_T", "n_contrib")},
            [g.numpy() for g in grads])


def rel(got, want):
    """max |got - want| over max |want| (gradients of a whole argument)."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_path_matches_jax_pallas_and_oracle(seed):
    inp = inputs(seed)
    t_out, t_g = torch_run(inp, "cuda")
    for impl, grad_tol in (("pallas", 5e-3), ("oracle", 2e-3)):
        j_out, j_g = jax_run(inp, impl)
        # forward: the 1e-3/pixel spec budget; n_contrib bit-exact
        for k in ("render", "final_T"):
            assert np.abs(t_out[k] - j_out[k]).max() <= 1e-3, (impl, k)
        np.testing.assert_array_equal(t_out["n_contrib"], j_out["n_contrib"])
        # gradients: vs Pallas its bf16 pixel sums (~4e-3 per pair) plus
        # contributor-boundary flips; vs the oracle's AD the flips only
        for name, g, w in zip(ARGS, t_g, j_g):
            assert rel(g, w) <= grad_tol, (impl, name, rel(g, w))
    # the center2d_offset gradient is the sum of the screen-vertex grads:
    # nonzero for visible triangles
    assert np.abs(t_g[3]).sum() > 0


def test_oracle_matches_jax_oracle():
    """The dense oracles share no code with the tile pipelines: the same
    float32 arithmetic in the same order, a few ulp apart."""
    inp = inputs(0)
    t_out, t_g = torch_run(inp, "oracle")
    j_out, j_g = jax_run(inp, "oracle")
    np.testing.assert_allclose(t_out["render"], j_out["render"], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(t_out["n_contrib"], j_out["n_contrib"])
    for name, g, w in zip(ARGS, t_g, j_g):
        assert rel(g, w) <= 5e-4, (name, rel(g, w))


def test_unported_variants_raise():
    inp = inputs(0)
    cam = t_camera(W, H, device="cpu")
    v, o = torch.as_tensor(inp["vertex"]), torch.as_tensor(inp["opacity"])
    c = torch.full((P, 3), 0.5)
    # rich info, the statistics and both at once are ported
    # (tests/test_torch_rich.py, tests/test_torch_stats.py); "GS" goes
    # through rasterize_gaussian
    with pytest.raises(NotImplementedError):
        t_rasterize(v, o, None, cam, TRS(W, H, rich_info=False,
                                         rasterizer_type="GS"), colors=c)
