"""Port model + trainer vs the JAX package: Adam on identical gradients,
weights carried across by ``convert``, one VanillaTS train step (loss and
gradients), and the port trainer end to end on a tiny synthetic
NeRF-Synthetic scene (48x48, 120 triangles)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.models import triangle as JM
from triangle_splatting_tpu_torch.convert import triangle_from_numpy, triangle_to_numpy
from triangle_splatting_tpu_torch.models import triangle as TM
from triangle_splatting_tpu_torch.trainers import build_trainer
from triangle_splatting_tpu_torch.utils.config import dict_to_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

RES, N_TRI = 48, 120


def leaves(tree):
    """numpy leaves of a JAX params/state dataclass keyed by field name."""
    import dataclasses
    return {f.name: None if getattr(tree, f.name) is None else np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from triangle_splatting_tpu_torch.utils.testing import build_synthetic_nerf_dataset
    return build_synthetic_nerf_dataset(tmp_path_factory.mktemp("lego_mini_torch"),
                                        res=RES, n_tri=N_TRI, device="cpu")


def make_config(root, out_dir, iters=60, sh_degree=1, reg=0.0):
    return dict_to_config({
        "dataset": {"type": "NerfSynthetic", "local_dir": str(root),
                    "background": "white", "use_alpha_mask": False,
                    "num_workers": 2, "pcd_path": "point_cloud.ply",
                    "hold_test_set": True},
        "model": {
            "max_sh_degree": sh_degree, "rasterizer_type": "2D",
            "pairs_per_triangle": 8,
            "sampling": {"sample_method": "direct", "init_opacity": 0.3},
            "optimizer": {
                "vertex": {"v_init": 0.002, "v_final": 0.0005, "max_steps": iters},
                "opacity": {"v_init": 0.05, "v_final": 0.05, "max_steps": iters},
                "f_dc": {"v_init": 0.02, "v_final": 0.01, "max_steps": iters},
                "f_rest": {"v_init": 0.001, "v_final": 0.001, "max_steps": iters},
            },
            "model_update": {"sh_schedule": {"one_up_iters": [10]}},
        },
        "trainer": {
            "output_dir": str(out_dir), "iterations": iters,
            "initial_eval": False, "log_interval_iter": 10,
            "eval_interval_iter": 0, "histogram_interval_iter": 0,
            "save_iterations": [], "checkpoint_iterations": [],
            "train_background": "white", "eval_background": "white",
            "w_ssim": 0.2, "w_scaling_reg": reg, "use_tensorboard": False,
            "w_opacity_reg": {"quad_reg": reg, "linear_reg": 0.0,
                              "quad_start_iter": 0, "linear_start_iter": 100},
            "seed": 0,
        },
    })


def random_params(rng, C=64, K=16):
    return dict(vertex=rng.normal(size=(C, 3, 3)), opacity=rng.normal(size=(C, 1)),
                f_dc=rng.normal(size=(C, 1, 3)), f_rest=rng.normal(size=(C, K - 1, 3)))


def test_adam_update_matches_jax_on_identical_gradients():
    """eps=1e-15 turns an early step into ~±lr per nonzero gradient, so the
    comparison feeds both sides the same numpy gradients (some exactly 0)."""
    rng = np.random.default_rng(0)
    f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}  # noqa: E731
    p, m, v, g = (f32(random_params(rng)) for _ in range(4))
    v = {k: np.abs(x) for k, x in v.items()}
    g["f_rest"][::3] = 0.0
    lrs = {k: float(np.float32(x)) for k, x in
           dict(vertex=1.6e-4, opacity=0.025, f_dc=0.0025, f_rest=2e-4).items()}
    jp = JM.TriangleParams(**{k: jnp.asarray(x) for k, x in p.items()})
    jopt = JM.AdamState(m=JM.TriangleParams(**{k: jnp.asarray(x) for k, x in m.items()}),
                        v=JM.TriangleParams(**{k: jnp.asarray(x) for k, x in v.items()}),
                        step=jnp.int32(6))
    jp2, jopt2 = JM.adam_update(jp, jopt, JM.TriangleParams(**{k: jnp.asarray(x) for k, x in g.items()}),
                                {k: np.float32(x) for k, x in lrs.items()})
    t = lambda d: TM.TriangleParams(**{k: torch.as_tensor(x) for k, x in d.items()})  # noqa: E731
    tp2, topt2 = TM.adam_update(t(p), TM.AdamState(m=t(m), v=t(v), step=6), t(g), lrs)
    assert topt2.step == int(jopt2.step) == 7
    for name in ("vertex", "opacity", "f_dc", "f_rest"):
        # float32 elementwise math; pow of the bias corrections may differ
        # by an ulp between XLA and numpy
        np.testing.assert_allclose(getattr(tp2, name).numpy(),
                                   np.asarray(getattr(jp2, name)), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(getattr(topt2.m, name).numpy(),
                                   np.asarray(getattr(jopt2.m, name)), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(getattr(topt2.v, name).numpy(),
                                   np.asarray(getattr(jopt2.v, name)), rtol=1e-6, atol=1e-7)


def test_convert_round_trip_from_jax_init():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    cols = rng.uniform(size=(300, 3)).astype(np.float32)
    cfg_j, cfg_t = JM.ModelConfig(max_sh_degree=3), TM.ModelConfig(max_sh_degree=3)
    jp, js = JM.create_from_points(pts, cols, None, cfg_j, seed=3)
    tp, ts = TM.create_from_points(pts, cols, None, cfg_t, seed=3, device="cpu")
    # the same host numpy initialization on both sides: identical
    for name, x in leaves(jp).items():
        if x is not None:
            np.testing.assert_array_equal(getattr(tp, name).numpy(), x)
    jopt = JM.AdamState.create(jp)
    p2, s2, o2 = triangle_from_numpy(leaves(jp), leaves(js),
                                     dict(m=leaves(jopt.m), v=leaves(jopt.v), step=jopt.step),
                                     device="cpu")
    np.testing.assert_array_equal(s2.alive.numpy(), ts.alive.numpy())
    back_p, back_s, back_o = triangle_to_numpy(p2, s2, o2)
    for name, x in leaves(jp).items():
        if x is not None:
            np.testing.assert_array_equal(back_p[name], x)
    for name, x in leaves(js).items():
        np.testing.assert_array_equal(back_s[name], x)
    assert int(back_o["step"]) == 0 and back_s["active_sh_degree"].dtype == np.int32


@pytest.mark.parametrize("impl,grad_tol", [("pallas", 5e-3), ("oracle", 2e-3)])
def test_one_train_step_matches_jax(dataset, tmp_path, impl, grad_tol):
    """Loss and gradients of one VanillaTS step (L1 + 0.2 SSIM + the
    scaling / opacity regularizers, SH degree 3 all bands live), weights
    carried from the JAX trainer's initialization by ``convert``."""
    from triangle_splatting_tpu.trainers.vanilla_ts import VanillaTSTrainer as JT
    cfg = make_config(dataset, tmp_path / "j", sh_degree=3, reg=0.01)
    jt = JT(cfg, impl=impl, interpret=True, log_file=False)
    jt._init_model()
    rng = np.random.default_rng(5)
    # non-trivial higher bands so every SH coefficient carries gradient
    jt.params = JM.TriangleParams(
        vertex=jt.params.vertex, opacity=jt.params.opacity, f_dc=jt.params.f_dc,
        f_rest=jnp.asarray(0.1 * rng.normal(size=jt.params.f_rest.shape).astype(np.float32)))
    from dataclasses import replace
    jt.state = replace(jt.state, active_sh_degree=jnp.int32(3))
    jcam = jt.dataset.getTrainDataset()[0]
    settings = jt._settings_for(jcam)
    weights = jt._loss_weights(1)
    bg = jnp.ones(3)
    c2d = jnp.zeros((jt.params.capacity, 2))

    def jloss(p):
        return jt._camera_loss(settings, p, c2d, jt.state, jcam.strip_static(), bg,
                               weights, None)[0]
    jl, jg = jax.value_and_grad(jloss)(jt.params)

    tt = build_trainer(make_config(dataset, tmp_path / "t", sh_degree=3, reg=0.01),
                       device="cpu", impl="cuda" if impl == "pallas" else "oracle",
                       log_file=False)
    p, s, _ = triangle_from_numpy(leaves(jt.params), leaves(jt.state), device="cpu")
    tcam = tt.dataset.getTrainDataset()[0]
    tl, tg, aux = tt._loss_and_grads(tt._settings_for(tcam), p, s, tcam,
                                     torch.ones(3), tt._loss_weights(1))
    # renders agree to ~1e-6; the loss differs more through SSIM, whose
    # variance terms E[x^2] - mu^2 cancel in the flat white background
    # where only C2 = 9e-4 sets the scale: conv2d and the JAX separable
    # shift-adds round differently there (~1e-5 in SSIM). rel 1e-4.
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
    for name in ("vertex", "opacity", "f_dc", "f_rest"):
        g, w = getattr(tg, name).numpy(), np.asarray(getattr(jg, name))
        err = float(np.abs(g - w).max() / np.abs(w).max())
        assert err <= grad_tol, (name, err)
    assert not bool(aux["overflow"])


def test_trainer_e2e_loss_falls(dataset, tmp_path):
    """The port trainer through build_trainer on the CPU: the loss falls and
    the test-view PSNR climbs over 60 steps (the JAX test_loss_decreases)."""
    tr = build_trainer(make_config(dataset, tmp_path / "out", iters=60),
                       device="cpu", log_file=False)
    tr._init_model()
    psnr0 = tr._evaluate(0)
    tr.train()
    psnr1 = tr._evaluate(1)
    losses = torch.stack(tr.loss_history).numpy()
    assert len(losses) == 60 and np.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean()
    assert psnr1 > psnr0 + 0.5, (psnr0, psnr1)
    assert int(tr.state.active_sh_degree) == 1


@pytest.mark.parametrize("patch", [
    {"trainer": {"data_parallel": 2}},
    {"model": {"sampling": {"sample_method": "poisson"}}},
    {"model": {"rasterizer_type": "GS"}},
    {"trainer": {"ckpt_format": "orbax"}},
    {"trainer": {"profile_start_iter": 5}},
])
def test_unported_config_blocks_raise(dataset, tmp_path, patch):
    base = make_config(dataset, tmp_path / "out").to_dict()

    def merge(a, b):
        for k, v in b.items():
            a[k] = merge(a.get(k) or {}, v) if isinstance(v, dict) else v
        return a
    cfg = merge(base, patch)
    # the refusal names the block
    block = next(iter(cfg["model"]["model_update"].keys() - {"sh_schedule"}), None)
    if "profile_start_iter" in patch.get("trainer", {}):
        # served since the host-side slice: a torch.profiler window
        tr = build_trainer(dict_to_config(cfg), device="cpu", log_file=False)
        assert tr.config.trainer.profile_start_iter == 5 and tr._profiler is None
        return
    with pytest.raises(NotImplementedError, match=block):
        build_trainer(dict_to_config(cfg), device="cpu", log_file=False)


def test_mesh_recipe_builds(dataset, tmp_path):
    """The shipped mesh recipe builds with its statistic, scale_pruning
    and contribution_pruning blocks (3D, render_up_scale 2, STE, gamma
    rescale). It ships target_point_num: null, and the first contribution
    pruning raises the JAX trainer's ValueError
    (tests/test_trainer_e2e.py::test_contribution_pruning_null_target_actionable)."""
    from pathlib import Path

    from triangle_splatting_tpu_torch.utils.config import loadConfig
    cfg = loadConfig(Path(__file__).resolve().parents[1] / "config"
                     / "NerfSynthetic_VanillaTS_mesh.yaml")
    cfg.dataset.local_dir = str(dataset)
    cfg.trainer.output_dir = str(tmp_path / "out")
    cfg.trainer.iterations = 50       # the saves at 20k / 60k lie beyond
    tr = build_trainer(cfg, device="cpu", log_file=False)
    assert tr.model_cfg.rasterizer_type == "3D" and tr.model_cfg.render_up_scale == 2
    assert tr._track_stats and tr.scene_bbox is None
    tr._init_model()
    cp = cfg.model.model_update.contribution_pruning
    assert cp.target_point_num is None
    tr._model_update(cp.start_iter)             # not a firing: start is exclusive
    with pytest.raises(ValueError, match="target_point_num"):
        tr._model_update(cp.start_iter + cp.interval_iter)
