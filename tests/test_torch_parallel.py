"""The port's camera data parallelism (``triangle_splatting_tpu_torch/parallel/mesh.py``
and the trainers' ``_train_step_dp``) in one process on the CPU, against the
JAX package on the conftest's virtual 8-device CPU mesh:

- ``dp_layout`` over a grid of (data_parallel, devices), the raising cases
  included; the mixed-resolution refusal; the view-statistic helpers;
- each trainer's data-parallel step with B views on one rank against JAX's
  ``_train_step_dp`` on ``make_mesh(B)`` (the JAX trainers on their dense
  oracle), and against the port's own sequential mean-gradient reference;
- the data-parallel evaluation against the sequential one.

The gradients are read from Adam's first moment after the step (m = 0.1 g
at step 1): with eps 1e-15 the first update is +-lr per nonzero gradient
whatever its size, so the parameters themselves only say the signs agree.
Scenes are 32x32 with 80 GT triangles."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.parallel import mesh as JP
from triangle_splatting_tpu_torch.convert import (gaussian_from_numpy, scaffold_from_numpy,
                                                  triangle_from_numpy)
from triangle_splatting_tpu_torch.parallel import mesh as TP
from triangle_splatting_tpu_torch.trainers import build_trainer
from triangle_splatting_tpu_torch.trainers.smoke import make_smoke_config
from triangle_splatting_tpu_torch.utils.config import dict_to_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

RES = 32
STAT_IT = 5          # inside every recipe's statistics window


def leaves(tree):
    return {f.name: None if getattr(tree, f.name) is None else np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def tree_np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: tree_np(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: tree_np(v) for k, v in x.items()}
    return None if x is None else np.asarray(x)


def flat(tree, prefix=""):
    """numpy leaves of a params / moments tree of either package by dotted name."""
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
        return out
    if tree is None or isinstance(tree, int):
        return {}
    return {prefix[:-1]: np.asarray(tree.detach().cpu() if torch.is_tensor(tree) else tree)}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """80 GT triangles at 32x32, 4 train and 3 test views, a 200-point
    cloud (the triangle and the Gaussian recipes init from it)."""
    from triangle_splatting_tpu_torch.utils.testing import build_synthetic_nerf_dataset
    return build_synthetic_nerf_dataset(tmp_path_factory.mktemp("dp_torch"), res=RES, n_tri=80,
                                        n_train=4, n_test=3, pcd_points=200, seed=5,
                                        device="cpu")


@pytest.mark.parametrize("dp_n", [1, 2, 3, 4, 6, 7, 8, 16])
@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 8])
def test_dp_layout_matches_jax(dp_n, n_devices):
    try:
        want = JP.dp_layout(dp_n, n_devices)
    except ValueError as e:
        with pytest.raises(ValueError, match="no divisor"):
            TP.dp_layout(dp_n, n_devices)
        assert "no divisor" in str(e)
        return
    assert TP.dp_layout(dp_n, n_devices) == want


def test_dp_layout_and_mesh_refusals():
    with pytest.raises(ValueError, match=">= 1"):
        TP.dp_layout(0, 4)
    # one process: a world of one rank; a larger mesh never shrinks
    assert TP.dp_layout(4) == (1, 4)
    assert TP.make_mesh().size == 1 and TP.make_mesh(1).group is None
    with pytest.raises(RuntimeError, match="requires 2 ranks"):
        TP.make_mesh(2)


def test_mixed_resolution_refused():
    from triangle_splatting_tpu_torch.utils.testing import make_camera
    with pytest.raises(ValueError, match="resolution"):
        TP.stack_dp_cameras([make_camera(32, 32, with_image=True, device="cpu"),
                             make_camera(64, 32, with_image=True, device="cpu")])
    cams = [make_camera(32, 32, with_image=True, device="cpu") for _ in range(3)]
    assert TP.stack_dp_cameras(cams) == cams


def test_view_statistic_helpers_match_jax():
    """view_stat_locals / accumulate_view_stat_locals / the reduce of two
    views' locals against JAX's (its reduce inside shard_map over a
    2-device mesh, one view a device): equal bit for bit (one add, maxima)."""
    from triangle_splatting_tpu.models import triangle as JM
    from triangle_splatting_tpu_torch.models import triangle as TM
    rng = np.random.default_rng(3)
    C = 50
    views = [dict(vis=rng.random(C) < 0.6, g=rng.random(C).astype(np.float32),
                  cs=rng.random(C).astype(np.float32), cm=rng.random(C).astype(np.float32),
                  r=rng.integers(0, 9, C).astype(np.int32)) for _ in range(2)]
    jl = [JP.view_stat_locals(jnp.asarray(v["vis"]), jnp.asarray(v["g"]), jnp.asarray(v["cs"]),
                              jnp.asarray(v["cm"]), jnp.asarray(v["r"])) for v in views]
    tl = [TP.view_stat_locals(torch.as_tensor(v["vis"]), torch.as_tensor(v["g"]),
                              torch.as_tensor(v["cs"]), torch.as_tensor(v["cm"]),
                              torch.as_tensor(v["r"])) for v in views]
    for a, b in zip(jl[0], tl[0]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jacc = JP.accumulate_view_stat_locals(JP.zero_view_stat_locals(C), jl[0])
    jacc = JP.accumulate_view_stat_locals(jacc, jl[1])
    tacc = TP.accumulate_view_stat_locals(TP.zero_view_stat_locals(C), tl[0])
    tacc = TP.accumulate_view_stat_locals(tacc, tl[1])
    for a, b in zip(jacc, tacc):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    st = dict(gradient_accum=rng.random(C), gradient_denom=rng.integers(0, 4, C),
              contrib_sum=rng.random(C), contrib_max=rng.random(C),
              contrib_denom=rng.integers(0, 4, C), max_radii2d=rng.integers(0, 6, C))
    st = {k: v.astype(np.float32) for k, v in st.items()}
    jstate = dataclasses.replace(JM.TriangleState.create(C), **{k: jnp.asarray(v)
                                                                for k, v in st.items()})
    mesh = JP.make_mesh(2)
    P = jax.sharding.PartitionSpec
    stacked = tuple(jnp.stack([a, b]) for a, b in zip(*jl))
    fn = JP.get_shard_map()(
        lambda s, loc: JP.reduce_view_statistics_local(s, tuple(x[0] for x in loc), "data"),
        mesh=mesh, in_specs=(P(), P("data")), out_specs=P(), check_vma=False)
    jout = fn(jstate, stacked)
    tstate = dataclasses.replace(TM.TriangleState.create(C, device="cpu"),
                                 **{k: torch.as_tensor(v) for k, v in st.items()})
    tout = TP.reduce_view_statistics_local(tstate, tacc, TP.make_mesh(1))
    for k in st:
        np.testing.assert_array_equal(getattr(tout, k).numpy(), np.asarray(getattr(jout, k)),
                                      err_msg=k)


# -- the trainers' data-parallel steps ----------------------------------------

def ts_pair(dataset, tmp_path, n_views):
    """JAX and port VanillaTS trainers (both on their dense oracle) on the
    smoke recipe (statistics every step), the port's weights converted
    from JAX's init; data_parallel = n_views."""
    from triangle_splatting_tpu.trainers.vanilla_ts import VanillaTSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as jcfg
    d = make_smoke_config(dataset, tmp_path / "j", 40).to_dict()
    d["trainer"]["data_parallel"] = n_views
    jt = JT(jcfg(d), impl="oracle", log_file=False)
    jt._init_model()
    d["trainer"]["output_dir"] = str(tmp_path / "t")
    tt = build_trainer(dict_to_config(d), device="cpu", impl="oracle", log_file=False)
    tt.params, tt.state, tt.opt = triangle_from_numpy(
        leaves(jt.params), leaves(jt.state),
        dict(m=leaves(jt.opt.m), v=leaves(jt.opt.v), step=jt.opt.step), device="cpu")
    return jt, tt


def gs_pair(dataset, tmp_path, n_views):
    from test_torch_gs_model import gs_config
    from triangle_splatting_tpu.trainers.vanilla_gs import VanillaGSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as jcfg
    jt = JT(jcfg(gs_config(dataset, tmp_path / "j", **{"trainer.data_parallel": n_views})),
            impl="oracle", log_file=False)
    jt._init_model()
    tt = build_trainer(dict_to_config(gs_config(dataset, tmp_path / "t",
                                                **{"trainer.data_parallel": n_views})),
                       device="cpu", log_file=False)
    tt.params, tt.state, tt.opt = gaussian_from_numpy(
        leaves(jt.params), leaves(jt.state),
        dict(m=leaves(jt.opt.m), v=leaves(jt.opt.v), step=0), device="cpu")
    return jt, tt


def scaffold_pair(dataset, tmp_path, n_views):
    from test_torch_scaffold_trainer import scaffold_config
    from triangle_splatting_tpu.trainers.scaffold_gs import ScaffoldGSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as jcfg
    patch = {"trainer.data_parallel": n_views}
    jt = JT(jcfg(scaffold_config(dataset, tmp_path / "j", **patch)), impl="oracle",
            log_file=False)
    jt._init_model()
    tt = build_trainer(dict_to_config(scaffold_config(dataset, tmp_path / "t", **patch)),
                       device="cpu", log_file=False)
    tt.params, tt.state, tt.opt = scaffold_from_numpy(
        tree_np(jt.params), tree_np(jt.state), tree_np(jt.opt), device="cpu")
    return jt, tt


PAIRS = dict(ts=ts_pair, gs=gs_pair, scaffold=scaffold_pair)

# Per-trainer budgets against JAX, those of the single-step and lockstep
# tests of each trainer: the loss within rel 1e-4 (tests/test_torch_trainer.py,
# test_torch_gs_model.py, test_torch_scaffold_trainer.py); the summed
# gradient (Adam's m) within GRAD_TOL of each leaf's largest (the oracle
# step's 2e-3 of test_torch_trainer.py; the Gaussian and scaffold pairs run
# JAX's oracle against the port's plain kernel versions, where an (entry,
# pixel) at the 1/255 alpha cut on one side only moves a gradient by up to
# 1e-2 of the largest, the scaffold lockstep's center-gradient budget); the
# view counts and radii exact; the accumulated center-gradient norms within
# ACC_TOL of their largest, the contributions within 4e-3 / 8e-3 (max / sum,
# test_torch_gs_model.stat_tol).
GRAD_TOL = dict(ts=2e-3, gs=1e-2, scaffold=1e-2)
ACC_TOL = dict(ts=2e-3, gs=1e-2, scaffold=1e-2)


def jax_dp_step(kind, jt, views, it):
    """JAX's _train_step_dp on make_mesh(len(views)), one view a device."""
    jt._mesh, jt._dp_b = JP.make_mesh(len(views)), 1
    if kind == "ts":
        w = {n: np.float32(x) for n, x in jt._loss_weights(it).items()}
        sched = jt._pack.pack(w, jt._lrs(it), np.ones(3, np.float32), it)
        return jt._train_step_dp(jt._settings_for(views[0]), jt.params, jt.opt, jt.state,
                                 JP.stack_dp_cameras(views), sched, None)
    t = jt.config.trainer
    w = {"l1": np.float32(1.0 - (t.w_ssim or 0.0)), "ssim": np.float32(t.w_ssim or 0.0)}
    if kind == "scaffold":
        w.update(scaling=np.float32(t.w_scaling_reg or 0.0),
                 opacity=np.float32(t.w_opacity_reg or 0.0))
    sched = jt._pack.pack(w, jt._lrs(it), np.ones(3, np.float32), it)
    return jt._train_step_dp(jt._settings_for(views[0]), jt.params, jt.opt, jt.state,
                             JP.stack_dp_cameras(views), sched)


def port_dp_step(tt, views, it):
    tt._dp_group, tt._dp_b = TP.make_mesh(1), len(views)
    args = (tt._settings_for(views[0]), tt.params, tt.opt, tt.state, views,
            tt._loss_weights(it), tt._lrs(it), torch.ones(3), it)
    return tt._train_step_dp(*args)


STAT_FIELDS = dict(
    ts=("gradient_accum", "gradient_denom", "contrib_sum", "contrib_max", "max_radii2d"),
    gs=("gradient_accum", "gradient_denom", "contrib_sum", "contrib_max", "max_radii2d"),
    scaffold=("offset_grad_accum", "offset_denom", "opacity_accum", "anchor_denom"))


@pytest.mark.parametrize("kind,n_views", [("ts", 2), ("ts", 4), ("gs", 2), ("scaffold", 2)])
def test_dp_step_matches_jax(dataset, tmp_path, kind, n_views):
    jt, tt = PAIRS[kind](dataset, tmp_path, n_views)
    jviews = [jt.dataset.getTrainDataset()[i].strip_static() for i in range(n_views)]
    tviews = [tt.dataset.getTrainDataset()[i] for i in range(n_views)]
    jp, jo, js, jl, _ = jax_dp_step(kind, jt, jviews, STAT_IT)
    tp, to, ts, tl, taux = port_dp_step(tt, tviews, STAT_IT)
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl)), (float(tl), float(jl))
    jm, tm = flat(jo.m), flat(to.m)
    assert set(jm) == set(tm)
    for name, want in jm.items():
        err = np.abs(tm[name] - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= GRAD_TOL[kind], (name, err)
    for name in STAT_FIELDS[kind]:
        want, got = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        if "denom" in name or "radii" in name:
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name in ("gradient_accum", "offset_grad_accum"):
            assert np.abs(got - want).max() <= ACC_TOL[kind] * np.abs(want).max(), name
        elif name == "contrib_max":
            assert np.abs(got - want).max() <= 4e-3, name
        elif name == "contrib_sum":
            assert (np.abs(got - want) <= 8e-3 + 5e-4 * np.abs(want)).all(), name
        else:           # opacity_accum: the scaffold lockstep's 1e-3 of the largest
            assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), name
    denom = "offset_denom" if kind == "scaffold" else "gradient_denom"
    assert float(getattr(ts, denom).sum()) > 0
    assert not bool(taux["overflow"])


@pytest.mark.parametrize("kind,n_views", [("ts", 2), ("ts", 4), ("gs", 2), ("scaffold", 2)])
def test_dp_step_matches_sequential_mean(dataset, tmp_path, kind, n_views):
    """The port's step against its own reference: n single-view
    ``_loss_and_grads``, their mean, one ``adam_update`` and sequential
    statistics updates. The step scales each view's loss by 1/n before the
    backward, a power of two here, so both sides round alike: params,
    moments and accumulated norms within JAX's own budget
    (tests/test_multichip.py: rtol 2e-5, atol 1e-6 / 1e-7), view counts and
    radii exact."""
    _, tt = PAIRS[kind](dataset, tmp_path, n_views)
    views = [tt.dataset.getTrainDataset()[i] for i in range(n_views)]
    it = STAT_IT
    settings, w, lrs, bg = tt._settings_for(views[0]), tt._loss_weights(it), tt._lrs(it), \
        torch.ones(3)
    grads, state, loss = [], tt.state, 0.0
    for cam in views:
        l, g, aux = tt._loss_and_grads(settings, tt.params, tt.state, cam, bg, w)
        grads.append(g)
        loss = loss + l
        if kind == "ts":
            from triangle_splatting_tpu_torch.models.triangle import update_statistics
            state = update_statistics(state, aux["center2d_grad"], aux["radii"],
                                      aux["contrib_sum"], aux["contrib_max"],
                                      aux["visible_mask"])
        elif kind == "gs":
            from triangle_splatting_tpu_torch.models.gaussian_model import update_statistics
            state = update_statistics(state, aux["mean2d_grad"], aux["radii"],
                                      aux["contrib_sum"], aux["contrib_max"],
                                      aux["visible_mask"])
        else:
            from triangle_splatting_tpu_torch.models.scaffold import update_statistics
            state = update_statistics(state, aux["mean2d_grad"], aux["pkg"],
                                      tt.model_cfg.n_offsets)
    if kind == "scaffold":
        mean = type(grads[0]).from_leaves({n: sum(g.leaves()[n] for g in grads) / n_views
                                           for n in grads[0].leaves()})
    else:
        mean = type(grads[0])(**{n: sum(getattr(g, n) for g in grads) / n_views
                                 for n in grads[0].tensors()})
    mod = {"ts": "triangle", "gs": "gaussian_model", "scaffold": "scaffold"}[kind]
    import importlib
    M = importlib.import_module(f"triangle_splatting_tpu_torch.models.{mod}")
    ref_p, ref_o = M.adam_update(tt.params, tt.opt, mean, lrs)
    tp, to, ts, tl, _ = port_dp_step(tt, views, it)
    assert abs(float(tl) - float(loss) / n_views) <= 1e-6 * abs(float(loss))
    for want, got in ((flat(ref_p), flat(tp)), (flat(ref_o.m), flat(to.m)),
                      (flat(ref_o.v), flat(to.v))):
        assert set(want) == set(got)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=2e-5, atol=1e-6,
                                       err_msg=name)
    for name in STAT_FIELDS[kind]:
        want, got = getattr(state, name).numpy(), getattr(ts, name).numpy()
        if "denom" in name or "radii" in name:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("kind", ["ts", "gs", "scaffold"])
def test_dp_eval_matches_sequential(dataset, tmp_path, kind):
    """Evaluation over the data group (3 test views, 2 a pass: the last
    pass padded) scores as the sequential evaluation, within 1e-3 dB."""
    _, tt = PAIRS[kind](dataset, tmp_path, 2)
    tt._dp_group, tt._dp_b = TP.make_mesh(1), 2
    psnr_dp = tt._evaluate(1)
    tt._dp_n = 1                 # no data parallelism: one view after the other
    psnr_seq = tt._evaluate(1)
    assert abs(psnr_dp - psnr_seq) < 1e-3, (psnr_dp, psnr_seq)


def test_dp_eval_scores_pads_and_orders():
    """dp_eval_scores over a world of one rank, B = 2, 5 views: every real
    view once in order, the padded repeat dropped, images only for the
    first n_images."""
    cams = list(range(5))
    out = list(TP.dp_eval_scores(TP.make_mesh(1), lambda c: (torch.full((2, 2), float(c)),
                                                              torch.tensor([c, 10.0 * c])),
                                 cams, cameras_per_device=2, n_images=3))
    assert [i for i, *_ in out] == [0, 1, 2, 3, 4]
    assert [float(s[1]) for *_, s in out] == [0.0, 10.0, 20.0, 30.0, 40.0]
    assert [im is not None for _, _, im, _ in out] == [True, True, True, False, False]
    assert float(out[2][2][0, 0]) == 2.0


@pytest.mark.parametrize("kind", ["ts", "gs", "scaffold"])
def test_dp_trainer_trains(dataset, tmp_path, kind):
    """train() with data_parallel 2 in one process: 2 views a step, finite
    losses, statistics accumulated, the DP evaluation path taken."""
    if kind == "ts":
        cfg = make_smoke_config(dataset, tmp_path / "out", 6)
    elif kind == "gs":
        from test_torch_gs_model import gs_config
        cfg = dict_to_config(gs_config(dataset, tmp_path / "out", **{"trainer.iterations": 6}))
    else:
        from test_torch_scaffold_trainer import scaffold_config
        cfg = dict_to_config(scaffold_config(dataset, tmp_path / "out", iters=6))
    cfg.trainer.data_parallel = 2
    cfg.trainer.save_iterations, cfg.trainer.checkpoint_iterations = [], []
    tr = build_trainer(cfg, device="cpu", log_file=False)
    tr.train()
    assert tr._dp_group is not None and tr._dp_b == 2 and tr._dp_group.size == 1
    losses = torch.stack(tr.loss_history).numpy()
    assert len(losses) == 6 and np.isfinite(losses).all()
    denom = tr.state.offset_denom if kind == "scaffold" else tr.state.gradient_denom
    assert float(denom.sum()) > 0
    assert np.isfinite(tr._evaluate(6))


def test_make_dp_train_step_matches_jax():
    """make_dp_train_step with B = 2 views on one rank against JAX's on a
    2-device mesh (both on their dense oracle), learning rates 0: the
    summed loss within rel 1e-4 and the summed centroid gradient within
    2e-3 of its largest (test_torch_trainer.py's oracle budgets); with
    learning rates, the first step moves the parameters."""
    from triangle_splatting_tpu.models import triangle as JM
    from triangle_splatting_tpu.ops.projection import RasterSettings as JSettings
    from triangle_splatting_tpu.trainers import losses as JL
    from triangle_splatting_tpu.utils.testing import make_camera as j_camera
    from triangle_splatting_tpu.utils.testing import make_random_scene
    from triangle_splatting_tpu_torch.models import triangle as TM
    from triangle_splatting_tpu_torch.ops.projection import RasterSettings
    from triangle_splatting_tpu_torch.trainers import losses as TL
    from triangle_splatting_tpu_torch.utils.testing import make_camera

    s = make_random_scene(64, seed=1)
    rng = np.random.default_rng(2)
    gts = [rng.random((3, 32, 32), np.float32) for _ in range(2)]
    jcfg, tcfg = JM.ModelConfig(max_sh_degree=0), TM.ModelConfig(max_sh_degree=0)
    jp, js = JM.create_from_points(s["vertex"].mean(1), s["rgb"], None, jcfg, init_opacity=0.5)
    tp, ts = TM.create_from_points(s["vertex"].mean(1), s["rgb"], None, tcfg, init_opacity=0.5,
                                   device="cpu")
    jcams = [dataclasses.replace(j_camera(32, 32, fov, with_image=True), gt_image=jnp.asarray(g))
             for fov, g in zip((50.0, 60.0), gts)]
    tcams = [dataclasses.replace(make_camera(32, 32, fov, with_image=True, device="cpu"),
                                 gt_image=torch.as_tensor(g)) for fov, g in zip((50.0, 60.0), gts)]
    names = ("vertex", "opacity", "f_dc", "f_rest", "affine")
    jstep = JP.make_dp_train_step(JP.make_mesh(2), JSettings(image_width=32, image_height=32),
                                  jcfg, lambda pkg, c, p, st, w: JL.l1(pkg["render"], c.gt_image),
                                  impl="oracle", donate=False)
    _, _, _, jl, jg = jstep(jp, JM.AdamState.create(jp), js, JP.stack_cameras(jcams),
                            jnp.ones(3), {k: np.float32(0.0) for k in names}, {})
    tstep = TP.make_dp_train_step(TP.make_mesh(1), RasterSettings(image_width=32, image_height=32),
                                  tcfg, lambda pkg, c, p, st, w: TL.l1(pkg["render"], c.gt_image),
                                  impl="oracle", cameras_per_device=2)
    p2, _, _, tl, tg = tstep(tp, TM.AdamState.create(tp), ts, tcams, torch.ones(3),
                             {k: 0.0 for k in names}, {})
    assert abs(float(tl) - float(jl)) <= 1e-4 * float(jl)
    jg = np.asarray(jg)
    assert np.abs(tg.numpy() - jg).max() <= 2e-3 * np.abs(jg).max()
    assert torch.equal(p2.vertex, tp.vertex)
    p3, *_ = tstep(tp, TM.AdamState.create(tp), ts, tcams, torch.ones(3),
                   {k: 1e-3 for k in names}, {})
    assert float((p3.vertex - tp.vertex).abs().max()) > 0
