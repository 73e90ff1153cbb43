"""The port's renderer facades vs the JAX package's: ``TriangleRenderer``
("2D" and "3D", rich info on and off, colors or SH) against the JAX
``TriangleRenderer`` with ``impl="oracle"`` and with the Pallas kernels in
interpret mode (``debug=True``), outputs and gradients; ``MeshRenderer``
against the JAX ``MeshRenderer`` on the same GLB."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.models.raw_triangle import RawTriangle as JRaw
from triangle_splatting_tpu.renderer import MeshRenderer as JMesh
from triangle_splatting_tpu.renderer import TriangleRenderer as JTri
from triangle_splatting_tpu.utils.testing import make_camera as j_camera
from triangle_splatting_tpu.utils.testing import make_random_scene
from triangle_splatting_tpu_torch.ops.cuda import launch_counts
from triangle_splatting_tpu_torch.renderer import MeshRenderer as TMesh
from triangle_splatting_tpu_torch.renderer import TriangleRenderer as TTri
from triangle_splatting_tpu_torch.utils.testing import make_camera as t_camera
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

W = H = 64
P = 150
RICH_KEYS = ("depth", "normal", "contrib_sum", "contrib_max")


def rel(got, want):
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


@functools.lru_cache(maxsize=None)
def inputs(seed, sh):
    s = make_random_scene(P, seed=seed)
    rng = np.random.default_rng(seed + 50)
    d = dict(vertex=s["vertex"], opacity=s["opacity"], center2d=np.zeros((P, 2), np.float32),
             target=rng.uniform(size=(3, H, W)).astype(np.float32),
             w_depth=rng.normal(size=(H, W)).astype(np.float32) / (H * W),
             w_normal=rng.normal(size=(3, H, W)).astype(np.float32) / (H * W))
    if sh:
        d["shs"] = (rng.normal(size=(P, 4, 3)) * 0.4).astype(np.float32)
    else:
        d["color"] = s["rgb"]
    return d


def loss_terms(out, inp, rich, xp):
    loss = xp.abs(out["render"] - inp["target"]).mean() + 0.3 * out["final_T"].mean()
    if rich:
        loss = loss + (out["depth"] * inp["w_depth"]).sum() + (out["normal"] * inp["w_normal"]).sum()
    return loss


def argnames(inp):
    return ("vertex", "shs" if "shs" in inp else "color", "opacity", "center2d")


def jax_render(inp, variant, rich, gamma, impl):
    r = JTri(j_camera(W, H), bg_color=(1.0, 1.0, 1.0), bg_depth=10.0, sh_degree=1,
             gamma=gamma, rich_info=rich, rasterizer_type=variant, impl=impl,
             debug=impl == "pallas")
    names = argnames(inp)

    def loss(vertex, col, opacity, center2d):
        shs, color = (col, None) if "shs" in inp else (None, col)
        out = r.render(vertex, shs, color, opacity, center2d=center2d)
        return loss_terms(out, inp, rich, jnp), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(inp[k]) for k in names))
    return {k: np.asarray(v) for k, v in out.items()}, [np.asarray(g) for g in grads]


def torch_render(inp, variant, rich, gamma, impl="cuda"):
    r = TTri(t_camera(W, H, device="cpu"), bg_color=(1.0, 1.0, 1.0), bg_depth=10.0,
             sh_degree=1, gamma=gamma, rich_info=rich, rasterizer_type=variant, impl=impl)
    names = argnames(inp)
    leaves = [torch.tensor(inp[k], requires_grad=True) for k in names]
    shs, color = (leaves[1], None) if "shs" in inp else (None, leaves[1])
    out = r.render(leaves[0], shs, color, leaves[2], center2d=leaves[3])
    t_inp = {k: torch.as_tensor(v) for k, v in inp.items()}
    grads = torch.autograd.grad(loss_terms(out, t_inp, rich, torch), leaves)
    return ({k: v.detach().numpy() for k, v in out.items()}, [g.numpy() for g in grads])


CASES = [
    # (variant, rich, gamma, seed, sh)
    ("2D", False, 1.0, 0, False),
    ("2D", True, 1.0, 0, False),
    ("3D", False, 1.0, 1, True),
    ("3D", True, 1.0, 0, False),
    ("3D", True, 7.3, 5, False),
]


@pytest.mark.parametrize("variant,rich,gamma,seed,sh", CASES)
def test_triangle_renderer_matches_jax(variant, rich, gamma, seed, sh):
    """The port's facade (plain kernel versions on the CPU; with rich info
    B1's rich form with the stream) against the JAX facade over the Pallas
    kernels in interpret mode and over its dense oracle. The keys are the
    JAX facade's; n_contrib exact; render and final_T 1e-3 abs, depth and
    normal rel 1e-3 of their max (test_torch_rich's budgets); the
    statistics 5e-4 abs widened by gamma / 5 past gamma 5
    (test_torch_stats'); gradients of a loss that reads every output rel
    5e-3 against Pallas (its bf16 pixel sums) and 2e-3 against the
    oracle's AD (contributor-boundary flips)."""
    inp = inputs(seed, sh)
    before = launch_counts()
    t_out, t_g = torch_render(inp, variant, rich, gamma)
    assert launch_counts() == before                # CPU: the plain versions
    widen = max(1.0, gamma / 5.0)
    for impl, grad_tol in (("pallas", 5e-3), ("oracle", 2e-3)):
        j_out, j_g = jax_render(inp, variant, rich, gamma, impl)
        assert set(t_out) == set(j_out) | {"pairs_needed"}, (impl, set(t_out) ^ set(j_out))
        assert rich == all(k in t_out for k in RICH_KEYS)
        np.testing.assert_array_equal(t_out["n_contrib"], j_out["n_contrib"])
        np.testing.assert_array_equal(t_out["radii"], j_out["radii"])
        for k in ("render", "final_T"):
            assert np.abs(t_out[k] - j_out[k]).max() <= 1e-3, (impl, k)
        if rich:
            for k in ("depth", "normal"):
                assert rel(t_out[k], j_out[k]) <= 1e-3, (impl, k, rel(t_out[k], j_out[k]))
            for k in ("contrib_sum", "contrib_max"):
                d = np.abs(t_out[k] - j_out[k]).max()
                assert d <= 5e-4 * widen, (impl, k, d)
            assert t_out["contrib_sum"].max() > 0.5
        for name, g, w in zip(argnames(inp), t_g, j_g):
            assert rel(g, w) <= grad_tol, (impl, name, rel(g, w))
    np.testing.assert_array_equal(t_out["center2D"], inp["center2d"])


def test_triangle_renderer_rich_changes_only_the_extra_outputs():
    """rich_info adds depth, normal and the statistics: the render, final_T
    and n_contrib are those of the facade without it, bit for bit."""
    inp = inputs(2, False)
    outs = {}
    for rich in (False, True):
        r = TTri(t_camera(W, H, device="cpu"), bg_color=(1.0, 1.0, 1.0), rich_info=rich,
                 rasterizer_type="3D")
        with torch.no_grad():
            outs[rich] = r.render(inp["vertex"], None, inp["color"], inp["opacity"])
    for k in ("render", "final_T", "n_contrib"):
        assert torch.equal(outs[True][k], outs[False][k]), k


def test_triangle_renderer_rejects_gs():
    with pytest.raises(ValueError):
        TTri(t_camera(W, H, device="cpu"), rasterizer_type="GS")


# ---------------------------------------------------------------------------
# MeshRenderer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def mesh_arrays(seed=7, n=120):
    """An opaque random triangle soup as RawTriangle arrays (the SH DC
    band of colors in [0.1, 0.9])."""
    s = make_random_scene(n, seed=seed, opacity_range=(0.9, 0.95))
    sh_dc = (s["rgb"] - 0.5) / 0.28209479177387814
    return s["vertex"], np.full((n, 1), 4.0, np.float32), sh_dc.astype(np.float32)


@pytest.mark.parametrize("save_back", [True, False])
def test_mesh_renderer_matches_jax_on_a_glb(tmp_path, save_back):
    """Both packages render one GLB (written by the JAX RawTriangle) opaque
    at gamma 50: the port's tile pipeline (plain B1-3D rich form) and its
    oracle against the JAX MeshRenderer over its dense oracle. render and
    depth within the forward budget of gamma 50 (2e-5 widened by gamma / 5
    = 2e-4, with a 1e-3 share of pixels up to 1e-2 at edge flips, and depth
    relative to its max), mask likewise."""
    path = tmp_path / "mesh.glb"
    JRaw(*mesh_arrays()).saveGLB(path, save_back=save_back)
    want = {k: np.asarray(v) for k, v in JMesh(
        j_camera(W, H), bg_color=(1.0, 1.0, 1.0), impl="oracle").render(
            mesh_path=str(path)).items()}
    assert set(want) == {"render", "mask", "depth"}
    assert (want["mask"] > 0.5).mean() > 0.05
    before = launch_counts()
    for impl in ("cuda", "oracle"):
        got = {k: v.numpy() for k, v in TMesh(t_camera(W, H, device="cpu"),
                                             bg_color=(1.0, 1.0, 1.0), impl=impl).render(
                                                 mesh_path=str(path)).items()}
        assert set(got) == set(want)
        for k in ("render", "mask", "depth"):
            assert got[k].shape == want[k].shape, k
            scale = float(np.abs(want[k]).max()) if k == "depth" else 1.0
            d = np.abs(got[k] - want[k]).reshape(-1, H, W).max(axis=0) / scale
            assert (d > 2e-4).mean() <= 1e-3 and d.max() <= 1e-2, (impl, k, d.max())
    assert launch_counts() == before


def test_mesh_renderer_arrays_equal_path(tmp_path):
    """render(vertices, faces, faces_color) is render(mesh_path=...) of the
    same mesh; a call with neither raises."""
    from triangle_splatting_tpu_torch.models.raw_triangle import RawTriangle as TRaw
    from triangle_splatting_tpu_torch.renderer.mesh_renderer import _load_mesh
    path = tmp_path / "mesh.glb"
    TRaw(*mesh_arrays()).saveGLB(path)
    r = TMesh(t_camera(W, H, device="cpu"))
    a = r.render(mesh_path=str(path))
    b = r.render(*_load_mesh(str(path)))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError):
        r.render()
