"""The mesh-training slice of the port vs the JAX package: kernels B1/B2 in
variant "3D" (their plain PyTorch versions, which the CPU runs) against the
JAX Pallas kernels in interpret mode and against float64 autograd, the 3D
``rasterize`` forward and gradients, ``forward`` with ``render_up_scale``
2, and one train step of the mesh recipe without its ADC blocks."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.models import triangle as JM
from triangle_splatting_tpu.ops.binning import bin_triangles
from triangle_splatting_tpu.ops.pallas import blend as JB
from triangle_splatting_tpu.ops.projection import RasterSettings as JRS
from triangle_splatting_tpu.ops.projection import preprocess_3d
from triangle_splatting_tpu.ops.rasterize import pack_pair_fields, triangle_field_matrix_3d
from triangle_splatting_tpu.ops.rasterize import rasterize as j_rasterize
from triangle_splatting_tpu.utils.testing import make_camera as j_camera
from triangle_splatting_tpu.utils.testing import make_random_scene
from triangle_splatting_tpu_torch.convert import triangle_from_numpy
from triangle_splatting_tpu_torch.models import triangle as TM
from triangle_splatting_tpu_torch.ops.cuda import blend as TB
from triangle_splatting_tpu_torch.ops.projection import RasterSettings as TRS
from triangle_splatting_tpu_torch.ops.rasterize import rasterize as t_rasterize
from triangle_splatting_tpu_torch.trainers import build_trainer
from triangle_splatting_tpu_torch.utils.config import dict_to_config, loadConfig
from triangle_splatting_tpu_torch.utils.testing import make_camera as t_camera
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

GEO = dict(tile_h=32, tile_w=32)
CASES = [
    # (P, W, H, seed, gamma, opacity_range)
    (150, 64, 64, 0, 1.0, (0.3, 0.95)),
    (150, 64, 64, 1, 1.0, (0.8, 0.95)),    # opaque stack: T crosses 1e-4
    (200, 80, 48, 2, 7.3, (0.3, 0.95)),    # partial tiles, gamma != 1
    (200, 64, 64, 3, 50.0, (0.3, 0.95)),   # the solidified end of the anneal
]


def leaves(tree):
    """numpy leaves of a JAX params/state dataclass keyed by field name."""
    return {f.name: None if getattr(tree, f.name) is None else np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def rel(got, want):
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


@functools.lru_cache(maxsize=None)
def packed_inputs(P, W, H, seed, gamma, opacity_range):
    """Numpy (pairs, tile_starts, tile_counts, params) of the 3D variant
    from the JAX pipeline (cached: read-only arrays shared by the tests)."""
    s = make_random_scene(P, seed=seed, opacity_range=opacity_range)
    st = JRS(image_width=W, image_height=H, rich_info=False, rasterizer_type="3D")
    cam = j_camera(W, H)
    op = jnp.asarray(s["opacity"])
    prep = preprocess_3d(jnp.asarray(s["vertex"]), jnp.zeros((P, 2)),
                         jnp.asarray(s["rgb"]), cam.world_view, cam.full_proj,
                         cam.tan_fovx, cam.tan_fovy, st, opacity=op,
                         gamma=jnp.float32(gamma))
    b = bin_triangles(prep, st, 128 * 16, interpret=True)
    assert not bool(b.overflow)
    fmat = triangle_field_matrix_3d(prep, op, cam.tan_fovx, cam.tan_fovy, W, H)
    fields = pack_pair_fields(fmat, b, True, 13)
    sx = W / (2.0 * float(cam.tan_fovx))
    sy = H / (2.0 * float(cam.tan_fovy))
    params = np.array([gamma, 1.0, 0.9, 0.8, 10.0, sx, sy, 0], np.float32)
    return (np.array(fields), np.array(b.tile_starts), np.array(b.tile_counts), params)


def jax_forward(inp, W, H):
    return [np.asarray(x) for x in JB.blend_forward(
        *(jnp.asarray(a) for a in inp), image_width=W, image_height=H, rich=False,
        variant="3D", stats=False, interpret=True, **GEO)[:5]]


def torch_args(inp, dtype=torch.float32):
    pairs, ts, tc, params = inp
    return (torch.as_tensor(pairs).to(dtype), torch.as_tensor(ts),
            torch.as_tensor(tc), torch.as_tensor(params).to(dtype))


def cotangents(W, H, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, H, W)).astype(np.float32) / (3 * H * W),
            rng.normal(size=(H, W)).astype(np.float32) / (H * W))


def real_slots(ts, tc):
    return np.concatenate([np.arange(ts[t], ts[t] + tc[t]) for t in range(tc.shape[0])])


def row_rel_err(got, want, cols, rows=13):
    """max |got - want| per field row over that row's max |want|."""
    got, want = got[:rows, cols], want[:rows, cols]
    scale = np.maximum(np.abs(want).max(axis=1), 1e-30)
    return float((np.abs(got - want).max(axis=1) / scale).max())


@pytest.mark.parametrize("case", CASES)
def test_forward_3d_plain_matches_jax(case):
    P, W, H, seed, gamma, orange = case
    inp = packed_inputs(*case)
    want = jax_forward(inp, W, H)
    before = dict(TB.blend_forward.launches)
    got = [x.numpy() for x in TB.blend_forward(
        *torch_args(inp), image_width=W, image_height=H, variant="3D", **GEO)]
    assert TB.blend_forward.launches == before      # CPU: plain version
    # n_contrib: the early-termination count is bit-exact
    np.testing.assert_array_equal(got[4], want[4])
    assert want[4].max() > 2
    # color / final_T: f32 sums in another order than the MXU accumulation,
    # and XLA's exp/log an ulp from PyTorch's, which alpha's ecc^(2 gamma)
    # multiplies by 2 gamma: 2e-5 widened by gamma / 5 past gamma = 5. Such
    # an ulp may also flip the 1/255 mask of an isolated (pair, pixel),
    # which moves its pixel by <= T/255: at most 0.1% of the pixels past
    # the budget, none past the 1e-3/pixel spec budget
    tol = 2e-5 * max(1.0, gamma / 5.0)
    for k in (0, 3):
        d = np.abs(got[k] - want[k]).reshape(-1, H, W).max(axis=0)
        assert (d > tol).mean() <= 1e-3 and d.max() <= 1e-3, (k, d.max())
    np.testing.assert_allclose(got[1], got[3] * 10.0, rtol=1e-6)  # T * bg_depth
    assert (got[2] == 0).all()


@pytest.mark.parametrize("case", CASES)
def test_backward_3d_plain_matches_jax(case):
    P, W, H, seed, gamma, orange = case
    inp = packed_inputs(*case)
    _, _, _, final_T, n_contrib = jax_forward(inp, W, H)
    g_color, g_T = cotangents(W, H)
    want = np.asarray(JB.blend_backward(
        *(jnp.asarray(a) for a in inp), jnp.asarray(final_T), jnp.asarray(n_contrib),
        jnp.asarray(g_color), jnp.zeros((H, W)), jnp.zeros((3, H, W)),
        jnp.asarray(g_T), image_width=W, image_height=H, rich=False,
        variant="3D", interpret=True, **GEO))
    got = TB.blend_backward(
        *torch_args(inp), torch.as_tensor(final_T), torch.as_tensor(n_contrib),
        torch.as_tensor(g_color), torch.as_tensor(g_T), image_width=W,
        image_height=H, variant="3D", **GEO).numpy()
    pairs, ts, tc, _ = inp
    cols = real_slots(ts, tc)
    # The JAX backward reduces over pixels with bf16 matmuls (both operands
    # rounded, unit roundoff 2^-9 each: 3.9e-3 per product), and the random
    # cotangents make the pixel sums cancel, so a row's error against its
    # max may pass 2 * 2^-9: rel 5e-3 of each row's max, the 2D pipeline's
    # budget against Pallas (test_torch_rasterize). The float64 test below
    # holds the recurrence itself to 1e-9.
    assert row_rel_err(got, want, cols) <= 5e-3
    assert (got[13:] == 0).all()
    for t in range(tc.shape[0]):
        assert (got[:, ts[t] + tc[t]:ts[t + 1]] == 0).all()
    assert (got[:, ts[-1]:] == 0).all()


@pytest.mark.parametrize("case", CASES)
def test_backward_3d_plain_matches_float64_autograd(case):
    """The explicit back-to-front recurrence through the quotients a = A/D
    equals autograd through the dense forward; in float64 the only
    difference is rounding."""
    P, W, H, seed, gamma, orange = case
    pairs, ts, tc, params = torch_args(packed_inputs(*case), torch.float64)
    pairs.requires_grad_(True)
    geo = dict(image_width=W, image_height=H, variant="3D", **GEO)
    color, _, _, final_T, n_contrib = TB.blend_forward_plain(pairs, ts, tc, params, **geo)
    g_color, g_T = (torch.as_tensor(g).double() for g in cotangents(W, H))
    want = torch.autograd.grad((color * g_color).sum() + (final_T * g_T).sum(), pairs)[0]
    got = TB.blend_backward(pairs.detach(), ts, tc, params, final_T.detach(),
                            n_contrib, g_color, g_T, **geo)
    cols = real_slots(ts.numpy(), tc.numpy())
    assert row_rel_err(got.numpy(), want.numpy(), cols) <= 1e-9
    assert not got[13:].any()


# ---------------------------------------------------------------------------
# rasterize, forward with render_up_scale
# ---------------------------------------------------------------------------

RW = RH = 64
RP = 150
ARGS = ("vertex", "opacity", "rgb", "c2d")


@functools.lru_cache(maxsize=None)
def raster_inputs(seed):
    s = make_random_scene(RP, seed=seed)
    rng = np.random.default_rng(seed + 100)
    return dict(vertex=s["vertex"], opacity=s["opacity"], rgb=s["rgb"],
                c2d=np.zeros((RP, 2), np.float32),
                target=rng.uniform(size=(3, RH, RW)).astype(np.float32))


def jax_raster(inp, impl, gamma):
    st = JRS(image_width=RW, image_height=RH, rich_info=False, rasterizer_type="3D")
    cam = j_camera(RW, RH)

    def loss(vertex, opacity, rgb, c2d):
        out = j_rasterize(vertex, opacity, None, cam, st, gamma=gamma,
                          background=jnp.ones(3), bg_depth=10.0, colors=rgb,
                          center2d_offset=c2d, impl=impl, interpret=True,
                          need_stats=False)
        value = jnp.abs(out["render"] - inp["target"]).mean() + 0.3 * out["final_T"].mean()
        return value, out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(inp[k]) for k in ARGS))
    return ({k: np.asarray(out[k]) for k in ("render", "final_T", "n_contrib")},
            [np.asarray(g) for g in grads])


def torch_raster(inp, impl, gamma):
    st = TRS(image_width=RW, image_height=RH, rich_info=False, rasterizer_type="3D")
    leaves_ = [torch.tensor(inp[k], requires_grad=True) for k in ARGS]
    out = t_rasterize(leaves_[0], leaves_[1], None, t_camera(RW, RH, device="cpu"), st,
                      gamma=gamma, background=torch.ones(3), bg_depth=10.0,
                      colors=leaves_[2], center2d_offset=leaves_[3], impl=impl)
    value = (out["render"] - torch.as_tensor(inp["target"])).abs().mean() \
        + 0.3 * out["final_T"].mean()
    grads = torch.autograd.grad(value, leaves_)
    return ({k: out[k].detach().numpy() for k in ("render", "final_T", "n_contrib")},
            [g.numpy() for g in grads])


@pytest.mark.parametrize("seed,gamma", [(0, 1.0), (5, 7.3)])
def test_rasterize_3d_matches_jax_pallas_and_oracle(seed, gamma):
    """The port's 3D tile pipeline (plain kernel versions on the CPU) vs
    the JAX Pallas pipeline and the JAX direct ray-plane oracle. The loss
    is L1 against a random target: where two pipelines' renders straddle a
    target value (at gamma 7.3 they differ by up to ~2e-4 at steep edges),
    the L1 subgradient flips sign, so the scenes are ones whose renders
    stay clear of that kink."""
    inp = raster_inputs(seed)
    t_out, t_g = torch_raster(inp, "cuda", gamma)
    for impl, grad_tol in (("pallas", 5e-3), ("oracle", 2e-3)):
        j_out, j_g = jax_raster(inp, impl, gamma)
        for k in ("render", "final_T"):
            assert np.abs(t_out[k] - j_out[k]).max() <= 1e-3, (impl, k)
        np.testing.assert_array_equal(t_out["n_contrib"], j_out["n_contrib"])
        # vs Pallas its bf16 pixel sums plus contributor-boundary flips; vs
        # the oracle's AD the flips only (the 2D pipeline's budgets)
        for name, g, w in zip(ARGS, t_g, j_g):
            assert rel(g, w) <= grad_tol, (impl, name, rel(g, w))
    assert np.abs(t_g[3]).sum() > 0


def test_rasterize_3d_oracle_matches_jax_oracle():
    inp = raster_inputs(0)
    t_out, t_g = torch_raster(inp, "oracle", 1.0)
    j_out, j_g = jax_raster(inp, "oracle", 1.0)
    np.testing.assert_allclose(t_out["render"], j_out["render"], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(t_out["n_contrib"], j_out["n_contrib"])
    for name, g, w in zip(ARGS, t_g, j_g):
        assert rel(g, w) <= 5e-4, (name, rel(g, w))


def test_surface_scene_matches_jax():
    """The mesh phase's opaque-surface GT scene is the JAX builder's."""
    from triangle_splatting_tpu.utils.testing import make_surface_scene as j_surface
    from triangle_splatting_tpu_torch.utils.testing import make_surface_scene as t_surface
    want, got = j_surface(5000, seed=3), t_surface(5000, seed=3)
    assert got["vertex"].shape == (4970, 3, 3)      # 2 * 35 * 71 faces
    for k in ("vertex", "opacity", "rgb", "sh_dc"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_downsample_matches_jax_image_resize():
    """The antialiased bilinear downsample against ``jax.image.resize``
    "linear" at the mesh recipe's factor 2 (and an odd size); a plain
    bilinear (no antialias) misses it by ~0.1."""
    rng = np.random.default_rng(0)
    for shape, out in (((3, 64, 48), (3, 32, 24)), ((30, 22), (15, 11))):
        x = rng.uniform(size=shape).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), out, "linear"))
        got = TM._downsample(torch.as_tensor(x), *out[-2:]).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    plain = torch.nn.functional.interpolate(torch.as_tensor(x)[None, None], size=out,
                                            mode="bilinear", align_corners=False)[0, 0]
    assert float(np.abs(plain.numpy() - want).max()) > 0.05


def test_forward_render_up_scale_matches_jax():
    """``forward`` of the mesh model config (3D, STE, gamma rescale,
    render_up_scale 2): a 32x32 camera rendered at 64x64 and resized back;
    render, depth, radii // 2 and the vertex / opacity gradients against
    the JAX function, both through their dense oracles (the tile pipelines
    are held to them above)."""
    P, res, gamma = 120, 32, 7.3
    s = make_random_scene(P, seed=6)
    pts = s["vertex"].mean(1)
    kw = dict(max_sh_degree=0, rasterizer_type="3D", ste_threshold=0.3,
              gamma_rescale=True, render_up_scale=2)
    jcfg, tcfg = JM.ModelConfig(**kw), TM.ModelConfig(**kw)
    jp, js = JM.create_from_points(pts, s["rgb"], None, jcfg, init_opacity=0.5, seed=1)
    js = dataclasses.replace(js, gamma=jnp.float32(gamma))
    rng = np.random.default_rng(2)
    op = np.asarray(jp.opacity) + rng.normal(0, 1.5, size=jp.opacity.shape).astype(np.float32)
    jp = dataclasses.replace(jp, opacity=jnp.asarray(op))
    tp, ts_, _ = triangle_from_numpy(leaves(jp), leaves(js), device="cpu")
    target = rng.uniform(size=(3, res, res)).astype(np.float32)

    def jloss(vertex, opacity):
        p = dataclasses.replace(jp, vertex=vertex, opacity=opacity)
        out = JM.forward(p, js, j_camera(res, res), jnp.ones(3), jcfg,
                         JRS(image_width=res, image_height=res, max_sh_degree=0,
                             rasterizer_type="3D", rich_info=False),
                         impl="oracle", need_stats=False)
        return jnp.abs(out["render"] - target).mean(), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jp.vertex, jp.opacity)
    v = tp.vertex.clone().requires_grad_(True)
    o = tp.opacity.clone().requires_grad_(True)
    tout = TM.forward(TM.TriangleParams(vertex=v, opacity=o, f_dc=tp.f_dc, f_rest=tp.f_rest),
                      ts_, t_camera(res, res, device="cpu"), torch.ones(3), tcfg,
                      TRS(image_width=res, image_height=res, max_sh_degree=0,
                          rasterizer_type="3D", rich_info=False), impl="oracle")
    tg = torch.autograd.grad((tout["render"] - torch.as_tensor(target)).abs().mean(), [v, o])
    assert tuple(tout["render"].shape) == (3, res, res)
    assert tuple(tout["depth"].shape) == (res, res)
    # the oracles' budget (test_torch_projection3d): 2e-5 widened by gamma / 5
    tol = 2e-5 * max(1.0, gamma / 5.0)
    for name in ("render", "depth"):
        g, w = tout[name].detach().numpy(), np.asarray(jout[name])
        assert rel(g, w) <= tol, (name, rel(g, w))
    np.testing.assert_array_equal(tout["radii"].numpy(), np.asarray(jout["radii"]))
    assert int(np.asarray(jout["radii"]).max()) > 0
    # the opacity STE passes its gradient through unchanged (o = 0.5 -> 1)
    for name, g, w in zip(("vertex", "opacity"), tg, jg):
        assert rel(g.numpy(), np.asarray(w)) <= 5e-4, (name, rel(g.numpy(), np.asarray(w)))


# ---------------------------------------------------------------------------
# one train step of the mesh recipe
# ---------------------------------------------------------------------------

def mesh_config(root, out_dir, iters=20, anneal=(5, 15)):
    """config/NerfSynthetic_VanillaTS_mesh.yaml without its statistic,
    scale_pruning and contribution_pruning blocks, on the tiny dataset,
    with the gamma anneal moved to steps ``anneal``."""
    from pathlib import Path
    cfg = loadConfig(Path(__file__).resolve().parents[1] / "config"
                     / "NerfSynthetic_VanillaTS_mesh.yaml").to_dict()
    mu = cfg["model"]["model_update"]
    for name in ("statistic", "scale_pruning", "contribution_pruning"):
        del mu[name]
    mu["gamma_schedule"].update(start_iter=anneal[0], end_iter=anneal[1])
    cfg["dataset"]["local_dir"] = str(root)
    cfg["trainer"].update(output_dir=str(out_dir), iterations=iters, seed=0,
                          initial_eval=False, log_interval_iter=5,
                          eval_interval_iter=0, histogram_interval_iter=0,
                          use_tensorboard=False)
    return dict_to_config(cfg)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from triangle_splatting_tpu_torch.utils.testing import build_synthetic_nerf_dataset
    return build_synthetic_nerf_dataset(tmp_path_factory.mktemp("mesh_mini_torch"),
                                        res=32, n_tri=80, device="cpu")


def test_one_mesh_train_step_matches_jax(dataset, tmp_path):
    """Loss and gradients of one step of the mesh recipe (3D, SH 0, STE,
    gamma rescale, render_up_scale 2, L1 + 0.2 SSIM) inside the anneal
    (gamma 7.3), weights carried from the JAX trainer's initialization by
    ``convert``. The GT images are 8-bit: where two renders straddle a GT
    value the L1 subgradient flips sign, and at a gamma 7.3 edge one such
    pixel moves a vertex gradient by a third, so the opacity draw is one
    whose renders stay clear of that kink."""
    from triangle_splatting_tpu.trainers.vanilla_ts import VanillaTSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
    cfg = mesh_config(dataset, tmp_path / "j")
    jt = JT(j_dict_to_config(cfg.to_dict()), impl="pallas", interpret=True, log_file=False)
    jt._init_model()
    rng = np.random.default_rng(0)
    # spread the opacities across the STE threshold 0.3
    op = np.asarray(jt.params.opacity) + rng.normal(0, 1.5, jt.params.opacity.shape)
    jt.params = dataclasses.replace(jt.params, opacity=jnp.asarray(op.astype(np.float32)))
    jt.state = dataclasses.replace(jt.state, gamma=jnp.float32(7.3))
    jcam = jt.dataset.getTrainDataset()[0]
    settings = jt._settings_for(jcam)
    weights = jt._loss_weights(1)
    c2d = jnp.zeros((jt.params.capacity, 2))

    def jloss(p):
        return jt._camera_loss(settings, p, c2d, jt.state, jcam.strip_static(),
                               jnp.ones(3), weights, None)[0]
    jl, jg = jax.value_and_grad(jloss)(jt.params)

    tt = build_trainer(mesh_config(dataset, tmp_path / "t"), device="cpu", log_file=False)
    p, s, o = triangle_from_numpy(leaves(jt.params), leaves(jt.state),
                                  dict(m=leaves(jt.opt.m), v=leaves(jt.opt.v), step=0),
                                  device="cpu")
    tcam = tt.dataset.getTrainDataset()[0]
    tl, tg, aux = tt._loss_and_grads(tt._settings_for(tcam), p, s, tcam,
                                     torch.ones(3), tt._loss_weights(1))
    # the render matches to ~1e-6; SSIM's cancelling variance terms on the
    # flat background differ by ~1e-5 between conv2d and the JAX shift-adds
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
    for name in ("vertex", "opacity", "f_dc"):
        g, w = getattr(tg, name).numpy(), np.asarray(getattr(jg, name))
        assert rel(g, w) <= 5e-3, (name, rel(g, w))
    assert not bool(aux["overflow"])
    # and the step itself: Adam moves the parameters, the STE count is logged
    p2, _, _, loss2, _ = tt._train_step(tt._settings_for(tcam), p, o, s, tcam,
                                        tt._loss_weights(1), tt._lrs(1), torch.ones(3), 1)
    assert float(loss2) == float(tl)
    assert not torch.equal(p2.vertex, p.vertex)
    tt.params, tt.state = p2, s
    hard = (torch.sigmoid(p2.opacity[:, 0]) > 0.3) & s.alive
    assert tt.triangle_count() == int(hard.sum()) < int(s.alive.sum())


def test_mesh_anneal_losses_match_jax(dataset, tmp_path):
    """The mesh phase's schedule (50 steps, gamma 1 -> 50 over steps
    10-40) on the soup of semi-transparent triangles: the port's trainer
    and the JAX trainer step in lockstep from the same weights over the
    same views, and their losses agree at every step, gamma 1, the anneal
    and gamma 50 alike (rel 1e-4, the one-step budget). So a loss that
    rises through the anneal on this scene is the recipe's, not the
    port's: both trainers' last-10 mean lies above their first-10 mean."""
    from triangle_splatting_tpu.trainers.vanilla_ts import VanillaTSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
    iters = 50
    cfg = mesh_config(dataset, tmp_path / "j", iters=iters, anneal=(10, 40))
    jt = JT(j_dict_to_config(cfg.to_dict()), impl="pallas", interpret=True, log_file=False)
    jt._init_model()
    tt = build_trainer(mesh_config(dataset, tmp_path / "t", iters=iters, anneal=(10, 40)),
                       device="cpu", log_file=False)
    tt.params, tt.state, tt.opt = triangle_from_numpy(
        leaves(jt.params), leaves(jt.state), dict(m=leaves(jt.opt.m), v=leaves(jt.opt.v), step=0),
        device="cpu")
    jviews, tviews = jt.dataset.getTrainDataset(), tt.dataset.getTrainDataset()
    losses = np.zeros((2, iters))
    for it in range(1, iters + 1):
        k = (it - 1) % len(tviews)
        sched = jt._pack.pack(jt._loss_weights(it), jt._lrs(it), np.ones(3, np.float32), it)
        jt.params, jt.opt, jt.state, jl, _ = jt._train_step(
            jt._settings_for(jviews[k]), jt.params, jt.opt, jt.state,
            jviews[k].strip_static(), sched, None)
        jt._model_update(it)
        tt.params, tt.opt, tt.state, tl, _ = tt._train_step(
            tt._settings_for(tviews[k]), tt.params, tt.opt, tt.state, tviews[k],
            tt._loss_weights(it), tt._lrs(it), torch.ones(3), it)
        tt._model_update(it)
        losses[:, it - 1] = float(jl), float(tl)
        assert float(tt.state.gamma) == pytest.approx(float(jt.state.gamma), rel=1e-6)
    assert float(tt.state.gamma) == pytest.approx(50.0)
    step_rel = np.abs(losses[1] - losses[0]) / losses[0]
    first, last = losses[:, :10].mean(axis=1), losses[:, -10:].mean(axis=1)
    print(f"JAX first10 {first[0]:.6f} last10 {last[0]:.6f}; port first10 {first[1]:.6f} "
          f"last10 {last[1]:.6f}; max per-step loss rel diff {step_rel.max():.3e}")
    assert step_rel.max() <= 1e-4, step_rel
    assert (last > first).all()


def test_mesh_trainer_runs_the_anneal(dataset, tmp_path):
    """build_trainer on the mesh recipe (without ADC) trains through the
    gamma anneal to 50 on the CPU with finite losses."""
    tr = build_trainer(mesh_config(dataset, tmp_path / "out"), device="cpu", log_file=False)
    tr.train()
    losses = torch.stack(tr.loss_history).numpy()
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert float(tr.state.gamma) == pytest.approx(50.0)
