"""The MatrixCity mesh recipe (``config/MatrixCity_VanillaTS_mesh.yaml``) in
the port vs the JAX package, at 32x32 on a synthetic city written in
MatrixCity's layout: the grid-sampled initialization (~300 triangles) is
the same bits, and the two trainers step in lockstep through 30 steps of
the recipe (3D rasterizer with rich info, the depth-normal consistency
term from step 3, both opacity regularizers) while opacity pruning,
opacity clipping and scale pruning fire on a compressed cadence; and the
recipe with a statistic window added, whose renders carry rich info and
the contribution statistics together."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_adc import STATE_FIELDS, leaves, midpoint_of_gap, stat_tol
from triangle_splatting_tpu.models import triangle as JM
from triangle_splatting_tpu_torch.convert import triangle_from_numpy
from triangle_splatting_tpu_torch.models import triangle as TM
from triangle_splatting_tpu_torch.trainers import build_trainer
from triangle_splatting_tpu_torch.utils.config import dict_to_config, loadConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ITERS = 30
RES = 32
GRID = 0.165           # the recipe's grid_size_inside, scaled to ~300 voxels
OPACITY_AT = (8, 16, 24)
SCALE_AT = (10,)
SEED = 1               # the trainer seed; it draws the initial opacities. Seed 0
                       # leaves one 4.4e-5 from the step-16 clipping threshold, 8x
                       # its own difference between the models (the cut would need
                       # 10x); with seed 1 every cut is >= 39x clear


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    """A 2.4 x 2.4 ground with three buildings, seen from 1.5 above by 6
    train / 2 test views that it fills (every pixel has a contributor, so
    the JAX reference's geometry gradient stays finite: it is NaN where a
    rendered normal is exactly 0, tests/test_torch_geometry.py)."""
    from triangle_splatting_tpu_torch.utils import testing as TT
    root = tmp_path_factory.mktemp("city")
    scene = TT.make_city_scene(0, extent=1.2, n_buildings=3, cell=0.1)
    TT.write_matrix_city(   # steep views over the middle of the ground
        root, scene, width=RES, height=RES, fovx_deg=40.0, n_train=6, n_test=2,
        n_points=6000, seed=1, device="cpu",
        pose=lambda theta: TT.aerial_pose(theta, radius=0.4, height=1.5, target=(0, 0, 0)))
    return root


def city_config(root, out_dir, scale_threshold=0.1):
    """The recipe as shipped on the tiny city, with its cadences compressed
    into 30 steps: opacity pruning and clipping every 8 steps over (2, 30]
    on the thresholds' schedules over (2, 40], scale pruning at step 10,
    the geometry term from step 3, the quadratic opacity regularizer from
    step 5 and the linear one from step 20. The initial opacities are
    random (uniform in (0, 1), the recipe's option "random") so that
    pruning and clipping both find rows within 30 steps."""
    cfg = loadConfig(Path(__file__).resolve().parents[1] / "config"
                     / "MatrixCity_VanillaTS_mesh.yaml").to_dict()
    cfg["dataset"].update(local_dir=str(root), num_workers=1)
    cfg["model"]["sampling"].update(grid_size_inside=GRID, init_opacity="random")
    mu = cfg["model"]["model_update"]
    for name in ("opacity_pruning", "opacity_clipping"):
        mu[name].update(start_iter=2, end_iter=40, hold_iter=30, interval_iter=8)
    mu["scale_pruning"].update(start_iter=2, end_iter=10, interval_iter=10,
                               scale_threshold=scale_threshold)
    t = cfg["trainer"]
    t["geometry_loss"]["start_iter"] = 2
    t["w_opacity_reg"].update(quad_start_iter=5, linear_start_iter=20)
    t.update(output_dir=str(out_dir), iterations=ITERS, seed=SEED, initial_eval=False,
             log_interval_iter=10, eval_interval_iter=0, histogram_interval_iter=0,
             use_tensorboard=False)
    return cfg


def test_city_recipe_builds_with_rich_info(city, tmp_path):
    """build_trainer takes the shipped recipe's blocks (opacity pruning and
    clipping, scale pruning, the geometry term, grid sampling) and renders
    with rich info in training and evaluation."""
    cfg = dict_to_config(city_config(city, tmp_path / "out"))
    tr = build_trainer(cfg, device="cpu", log_file=False)
    cam = tr.dataset.getTrainDataset()[0]
    st = tr._settings_for(cam)
    assert st.rich_info and st.rasterizer_type == "3D"
    assert tr._loss_weights(2)["geometry"] == 0.0 and tr._loss_weights(3)["geometry"] == \
        np.float32(0.05)
    tr._init_model()
    assert 250 <= int(tr.state.alive.sum()) <= 350


def test_city_lockstep_matches_jax(city, tmp_path):
    """The JAX trainer (Pallas in interpret mode) and the port's (plain
    kernel versions) build the same initial model from the grid-sampled
    cloud, then step together over the same views and backgrounds: the
    losses agree within rel 1e-4 a step (the one-step budget of the mesh
    and ADC locksteps) and the geometry terms within rel 1e-4; at every
    opacity pruning or clipping cut and the scale cut no alive row lies
    within 10x its own difference between the models of the threshold,
    and after every firing the alive masks and the clipped rows are
    equal."""
    from triangle_splatting_tpu.trainers.vanilla_ts import VanillaTSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
    jt = JT(j_dict_to_config(city_config(city, tmp_path / "j")), impl="pallas",
            interpret=True, log_file=False)
    jt._init_model()
    # scale pruning takes ~3% of the initial triangles, cut in a wide gap
    scaling0 = np.asarray(JM.get_scaling(jt.params))[np.asarray(jt.state.alive)]
    scale_thr, gap = midpoint_of_gap(scaling0, 0.97)
    assert gap > 1e-3
    jt.config.model.model_update.scale_pruning.scale_threshold = scale_thr
    tt = build_trainer(dict_to_config(city_config(city, tmp_path / "t", scale_thr)),
                       device="cpu", log_file=False)
    tt._init_model()
    # the port's own grid sampling and initialization: the same bits
    for name, x in leaves(jt.params).items():
        if x is not None:
            np.testing.assert_array_equal(getattr(tt.params, name).numpy(), x, err_msg=name)
    np.testing.assert_array_equal(tt.state.alive.numpy(), np.asarray(jt.state.alive))
    tt.params, tt.state, tt.opt = triangle_from_numpy(
        leaves(jt.params), leaves(jt.state), dict(m=leaves(jt.opt.m), v=leaves(jt.opt.v), step=0),
        device="cpu")
    n0 = int(tt.state.alive.sum())
    assert 250 <= n0 <= 350
    mu = tt.config.model.model_update
    jviews, tviews = jt.dataset.getTrainDataset(), tt.dataset.getTrainDataset()
    rng = np.random.default_rng(3)
    losses, geos, clipped, margins, devs = np.zeros((2, ITERS)), np.zeros((2, ITERS)), [], [], []
    for it in range(1, ITERS + 1):
        k = (it - 1) % len(tviews)
        bg = rng.uniform(size=3).astype(np.float32)       # train_background "random"
        sched = jt._pack.pack(jt._loss_weights(it), jt._lrs(it), bg, it)
        jt.params, jt.opt, jt.state, jl, jaux = jt._train_step(
            jt._settings_for(jviews[k]), jt.params, jt.opt, jt.state,
            jviews[k].strip_static(), sched, None)
        tt.params, tt.opt, tt.state, tl, taux = tt._train_step(
            tt._settings_for(tviews[k]), tt.params, tt.opt, tt.state, tviews[k],
            tt._loss_weights(it), tt._lrs(it), torch.as_tensor(bg), it)
        losses[:, it - 1] = float(jl), float(tl)
        geos[:, it - 1] = float(jaux["geo_loss"]), float(taux["geo_loss"])
        alive = np.asarray(jt.state.alive)
        op_j = np.asarray(JM.get_opacity(jt.params))[:, 0]
        op_t = torch.sigmoid(tt.params.opacity[:, 0]).numpy()
        # the two models' opacities and scalings differ by float noise,
        # which Adam's normalized steps spread row by row; a cut is well
        # posed when every alive row lies farther than 10x its own
        # difference between the models from the threshold
        def clear_margin(x_j, x_t, thr):
            x_j, x_t = x_j[alive], x_t[alive]
            return float((np.abs(x_j - thr) / np.maximum(np.abs(x_j - x_t), 1e-12)).min())

        for name, block in (("opacity_pruning", mu.opacity_pruning),
                            ("opacity_clipping", mu.opacity_clipping)):
            if it in OPACITY_AT:
                thr = getattr(tt, f"{name}_scheduler")(it - block.start_iter)
                margins.append(clear_margin(op_j, op_t, thr))
                assert margins[-1] > 10, (it, name, margins[-1])
        if it in SCALE_AT:
            margins.append(clear_margin(np.asarray(JM.get_scaling(jt.params)),
                                        TM.get_scaling(tt.params).numpy(), scale_thr))
            assert margins[-1] > 10, (it, margins[-1])
        devs.append(float(np.abs(op_j - op_t)[alive].max()))
        jt._model_update(it)
        tt._model_update(it)
        np.testing.assert_array_equal(tt.state.alive.numpy(), np.asarray(jt.state.alive),
                                      err_msg=f"alive masks differ after step {it}")
        if it in OPACITY_AT:
            jc = (np.asarray(jt.params.opacity)[:, 0] == 10.0) & np.asarray(jt.state.alive)
            tc = (tt.params.opacity[:, 0] == 10.0).numpy() & tt.state.alive.numpy()
            np.testing.assert_array_equal(tc, jc, err_msg=f"clipped rows differ after {it}")
            clipped.append(int(tc.sum()))
    step_rel = np.abs(losses[1] - losses[0]) / losses[0]
    geo_rel = np.abs(geos[1] - geos[0]) / np.maximum(geos[0], 1e-30)
    print(f"max per-step loss rel diff {step_rel.max():.3e}, geometry {geo_rel.max():.3e}; "
          f"prune history {tt.prune_history}; clipped rows {clipped}; cut margins {margins}; "
          f"max opacity difference per step {devs}")
    assert step_rel.max() <= 1e-4, step_rel
    assert geo_rel.max() <= 1e-4, geo_rel
    assert (geos[:, :2] > 0).all() and np.isfinite(losses).all()
    assert losses[1, 2:].max() > 0
    hist = tt.prune_history
    for kind, at in (("opacity", OPACITY_AT), ("clipping", OPACITY_AT), ("scale", SCALE_AT)):
        fired = [(i, n) for i, kd, n in hist if kd == kind]
        assert [i for i, _ in fired] == list(at), (kind, fired)
        assert any(n > 0 for _, n in fired), (kind, fired)
    assert [n for i, kd, n in hist if kd == "clipping"] == clipped
    pruned = sum(n for _, kd, n in hist if kd in ("opacity", "scale"))
    assert int(tt.state.alive.sum()) == n0 - pruned


def test_city_with_statistic_window_matches_jax(city, tmp_path):
    """The recipe with a ``statistic`` block added: every render carries
    rich info (the geometry term) and the contribution statistics together,
    B1's rich + stats form (the port refused the pair before it had that
    form). Seven steps in lockstep with the JAX trainer, before the first
    pruning: losses and geometry terms within rel 1e-4 a step, and the
    accumulated statistics within test_torch_adc's per-field tolerances."""
    from triangle_splatting_tpu.trainers.vanilla_ts import VanillaTSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
    steps = OPACITY_AT[0] - 1

    def config(out):
        cfg = city_config(city, out)
        cfg["model"]["model_update"]["statistic"] = dict(start_iter=0, end_iter=steps)
        return cfg
    jt = JT(j_dict_to_config(config(tmp_path / "j")), impl="pallas", interpret=True,
            log_file=False)
    jt._init_model()
    tt = build_trainer(dict_to_config(config(tmp_path / "t")), device="cpu", log_file=False)
    assert tt._track_stats and tt._rich
    tt.params, tt.state, tt.opt = triangle_from_numpy(
        leaves(jt.params), leaves(jt.state), dict(m=leaves(jt.opt.m), v=leaves(jt.opt.v), step=0),
        device="cpu")
    jviews, tviews = jt.dataset.getTrainDataset(), tt.dataset.getTrainDataset()
    rng = np.random.default_rng(3)
    for it in range(1, steps + 1):
        k = (it - 1) % len(tviews)
        bg = rng.uniform(size=3).astype(np.float32)
        sched = jt._pack.pack(jt._loss_weights(it), jt._lrs(it), bg, it)
        jt.params, jt.opt, jt.state, jl, jaux = jt._train_step(
            jt._settings_for(jviews[k]), jt.params, jt.opt, jt.state,
            jviews[k].strip_static(), sched, None)
        tt.params, tt.opt, tt.state, tl, taux = tt._train_step(
            tt._settings_for(tviews[k]), tt.params, tt.opt, tt.state, tviews[k],
            tt._loss_weights(it), tt._lrs(it), torch.as_tensor(bg), it)
        assert abs(float(tl) - float(jl)) <= 1e-4 * float(jl), (it, float(tl), float(jl))
        jg, tg = float(jaux["geo_loss"]), float(taux["geo_loss"])
        assert abs(tg - jg) <= 1e-4 * max(jg, 1e-30), (it, tg, jg)
        jt._model_update(it)
        tt._model_update(it)
    assert tg > 0                                   # the geometry term was on
    assert float(tt.state.contrib_denom.max()) == steps
    for name in STATE_FIELDS:
        got, want = getattr(tt.state, name).numpy(), np.asarray(getattr(jt.state, name))
        assert (np.abs(got - want) <= stat_tol(name, want)).all(), \
            (name, np.abs(got - want).max())
    assert float(tt.state.contrib_sum.max()) > 0.5
