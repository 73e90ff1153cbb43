"""The VanillaGS model and trainer of the port vs the JAX package:
``create_from_points``, Adam, the statistics update and each pruning or
clipping stage on one numpy state, the ``convert.py`` round trip,
``build_trainer``'s refusals, and the JAX VanillaGS trainer (Pallas in
interpret mode) and the port's trainer (plain kernel versions) stepping
in lockstep from the same converted weights through the statistic window
with contribution pruning and opacity pruning firing."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.models import adc_common as JA
from triangle_splatting_tpu.models import gaussian_model as JG
from triangle_splatting_tpu.trainers import adc_utils as JU
from triangle_splatting_tpu_torch.convert import gaussian_from_numpy, gaussian_to_numpy
from triangle_splatting_tpu_torch.models import gaussian_model as TG
from triangle_splatting_tpu_torch.trainers import build_trainer
from triangle_splatting_tpu_torch.utils.config import dict_to_config
from triangle_splatting_tpu_torch.utils.testing import make_gs_scene
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

C = 300
GROUPS = TG.GS_PARAM_GROUPS
STATE_FIELDS = ("gradient_accum", "gradient_denom", "max_radii2d", "contrib_sum",
                "contrib_max", "contrib_denom")


def leaves(tree):
    """numpy leaves of a JAX dataclass keyed by field name."""
    return {f.name: np.asarray(getattr(tree, f.name)) for f in dataclasses.fields(tree)}


def random_model(seed, K=3):
    """Numpy params / state / Adam moments of a capacity-C Gaussian model
    with dead rows, distinct float statistics and integer view counts."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    p = dict(xyz=f(C, 3), scaling=f(C, 3) * 0.5 - 2.0, rotation=f(C, 4), opacity=f(C, 1),
             f_dc=f(C, 1, 3), f_rest=f(C, K, 3))
    s = dict(alive=rng.random(C) < 0.85,
             gradient_accum=rng.uniform(0, 1, C).astype(np.float32),
             gradient_denom=rng.integers(0, 4, C).astype(np.float32),
             max_radii2d=rng.integers(0, 40, C).astype(np.float32),
             contrib_sum=rng.uniform(0, 20, C).astype(np.float32),
             contrib_max=rng.uniform(0, 1, C).astype(np.float32),
             contrib_denom=rng.integers(0, 3, C).astype(np.float32),
             gamma=np.float32(1.0), active_sh_degree=np.int32(1))
    m = {k: f(*v.shape) for k, v in p.items()}
    v = {k: np.abs(f(*x.shape)) for k, x in p.items()}
    return p, s, m, v


def to_jax(p, s, m, v, step=3):
    tp = lambda d: JG.GaussianParams(**{k: jnp.asarray(x) for k, x in d.items()})  # noqa: E731
    return (tp(p), JG.GaussianState(**{k: jnp.asarray(x) for k, x in s.items()}),
            JG.GSAdamState(m=tp(m), v=tp(v), step=jnp.int32(step)))


def to_torch(p, s, m, v, step=3):
    return gaussian_from_numpy(p, s, dict(m=m, v=v, step=step), device="cpu")


def assert_models_equal(jout, tout, rtol=0.0):
    """(params, opt, state) of the JAX and the port function: alive and
    counts exact, the floats to ``rtol``."""
    (jp, jo, js), (tp, to, ts) = jout, tout
    bp, bs, bo = gaussian_to_numpy(tp, ts, to)
    for name, x in leaves(jp).items():
        np.testing.assert_allclose(bp[name], x, rtol=rtol, atol=0, err_msg=name)
    for which in ("m", "v"):
        for name, x in leaves(getattr(jo, which)).items():
            np.testing.assert_allclose(bo[which][name], x, rtol=rtol, atol=0,
                                       err_msg=f"{which}.{name}")
    np.testing.assert_array_equal(bs["alive"], np.asarray(js.alive))
    for name in STATE_FIELDS:
        np.testing.assert_allclose(bs[name], np.asarray(getattr(js, name)), rtol=rtol, atol=0,
                                   err_msg=name)


def midpoint_of_gap(values, quantile):
    """A threshold in the middle of the widest gap between sorted values
    near the quantile: float32 noise cannot move a row across it."""
    v = np.sort(values)
    i = int(len(v) * quantile)
    lo, hi = max(i - 10, 0), min(i + 10, len(v) - 1)
    j = lo + int(np.argmax(np.diff(v[lo:hi + 1])))
    return float((v[j] + v[j + 1]) / 2), float(v[j + 1] - v[j])


# ---------------------------------------------------------------------------
# the model functions on one numpy state
# ---------------------------------------------------------------------------

def test_create_from_points_matches_jax():
    """The host initialization (3-NN scales, identity rotations also in the
    dead slots, SH DC from the colors, capacity rounded to 256): equal."""
    s = make_gs_scene(500, seed=2)
    cfg_j, cfg_t = JG.GSModelConfig(max_sh_degree=3), TG.GSModelConfig(max_sh_degree=3)
    jp, js = JG.create_from_points(s["xyz"], s["rgb"], cfg_j, init_opacity=0.3,
                                   capacity_factor=1.7)
    tp, ts = TG.create_from_points(s["xyz"], s["rgb"], cfg_t, init_opacity=0.3,
                                   capacity_factor=1.7, device="cpu")
    bp, bs, _ = gaussian_to_numpy(tp, ts)
    assert tp.capacity == jp.capacity == 1024 and bp["f_rest"].shape == (1024, 15, 3)
    for name, x in leaves(jp).items():
        np.testing.assert_array_equal(bp[name], x, err_msg=name)
    for name, x in leaves(js).items():
        np.testing.assert_array_equal(bs[name], x, err_msg=name)
    assert (bp["rotation"][500:, 0] == 1).all()


def test_convert_round_trip_from_jax_init():
    s = make_gs_scene(100, seed=5)
    jp, js = JG.create_from_points(s["xyz"], s["rgb"], JG.GSModelConfig(), capacity=256)
    jo = JG.GSAdamState.create(jp)
    p, st, o = gaussian_from_numpy(leaves(jp), leaves(js), dict(
        m=leaves(jo.m), v=leaves(jo.v), step=np.asarray(jo.step)), device="cpu")
    assert st.alive.dtype == torch.bool and st.active_sh_degree.dtype == torch.int32
    bp, bs, bo = gaussian_to_numpy(p, st, o)
    for name, x in leaves(jp).items():
        np.testing.assert_array_equal(bp[name], x)
    for name, x in leaves(js).items():
        np.testing.assert_array_equal(bs[name], x)
    for name, x in leaves(jo.m).items():
        np.testing.assert_array_equal(bo["m"][name], x)
    assert int(bo["step"]) == 0


def test_getters_match_jax():
    p, s, m, v = random_model(1)
    jp, _, _ = to_jax(p, s, m, v)
    tp, _, _ = to_torch(p, s, m, v)
    for name in ("get_scaling", "get_rotation", "get_opacity", "get_features"):
        np.testing.assert_allclose(getattr(TG, name)(tp).numpy(),
                                   np.asarray(getattr(JG, name)(jp)), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_adam_update_matches_jax():
    """One Adam step (eps 1e-15, float32 bias corrections) on every group."""
    p, s, m, v = random_model(3)
    rng = np.random.default_rng(4)
    g = {k: rng.normal(size=x.shape).astype(np.float32) * 1e-3 for k, x in p.items()}
    lrs = {k: np.float32(lr) for k, lr in zip(GROUPS, (1.6e-4, 5e-3, 1e-3, 0.05, 2.5e-3, 1e-4))}
    jp, _, jo = to_jax(p, s, m, v)
    tp, _, to = to_torch(p, s, m, v)
    jp2, jo2 = JG.adam_update(jp, jo, JG.GaussianParams(**{k: jnp.asarray(x)
                                                           for k, x in g.items()}), lrs)
    tp2, to2 = TG.adam_update(tp, to, TG.GaussianParams(**{k: torch.as_tensor(x)
                                                           for k, x in g.items()}),
                              {k: float(x) for k, x in lrs.items()})
    assert to2.step == int(jo2.step) == 4
    for name in GROUPS:
        np.testing.assert_allclose(getattr(tp2, name).numpy(), np.asarray(getattr(jp2, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        for which in ("m", "v"):
            np.testing.assert_allclose(getattr(getattr(to2, which), name).numpy(),
                                       np.asarray(getattr(getattr(jo2, which), name)),
                                       rtol=1e-6, atol=1e-12, err_msg=f"{which}.{name}")


def test_update_statistics_matches_jax():
    p, s, m, v = random_model(5)
    rng = np.random.default_rng(6)
    g = rng.normal(size=(C, 2)).astype(np.float32) * 1e-3
    radii = rng.integers(0, 60, C).astype(np.int32)
    cs = rng.uniform(0, 25, C).astype(np.float32)
    cm = rng.uniform(0, 1, C).astype(np.float32)
    vis = (rng.random(C) < 0.6) & s["alive"]
    _, js, _ = to_jax(p, s, m, v)
    _, ts, _ = to_torch(p, s, m, v)
    jout = JG.update_statistics(js, jnp.asarray(g), jnp.asarray(radii), jnp.asarray(cs),
                                jnp.asarray(cm), jnp.asarray(vis))
    tout = TG.update_statistics(ts, torch.as_tensor(g), torch.as_tensor(radii),
                                torch.as_tensor(cs), torch.as_tensor(cm), torch.as_tensor(vis))
    for name in STATE_FIELDS:
        tol = 1e-6 if name == "gradient_accum" else 0.0
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                                   rtol=tol, atol=0, err_msg=name)


class TestGSADCStages:
    """Each stage the VanillaGS trainer runs, against the JAX function on
    one state: rows, moments and statistics equal."""

    def test_prune_and_zero_moments(self):
        p, s, m, v = random_model(7)
        mask = np.random.default_rng(8).random(C) < 0.3
        jp, js, jo = to_jax(p, s, m, v)
        tp, ts, to = to_torch(p, s, m, v)
        assert_models_equal(JG.prune(jp, jo, js, jnp.asarray(mask)),
                            TG.prune(tp, to, ts, torch.as_tensor(mask)))

    @pytest.mark.parametrize("kind", ["opacity_pruning", "opacity_clipping"])
    def test_opacity_stages(self, kind):
        p, s, m, v = random_model(9)
        jp, js, jo = to_jax(p, s, m, v)
        tp, ts, to = to_torch(p, s, m, v)
        op = TG.get_opacity(tp)[:, 0].numpy()[s["alive"]]
        thr, gap = midpoint_of_gap(op, 0.3 if kind == "opacity_pruning" else 0.7)
        assert gap > 1e-5
        *jout, jn = getattr(JG, kind)(jp, jo, js, np.float32(thr))
        *tout, tn = getattr(TG, kind)(tp, to, ts, thr)
        assert_models_equal(jout, tout)
        assert int(tn) == int(jn) > 10

    def test_scale_pruning(self):
        p, s, m, v = random_model(10)
        jp, js, jo = to_jax(p, s, m, v)
        tp, ts, to = to_torch(p, s, m, v)
        smax = TG.get_scaling(tp).amax(dim=1).numpy()[s["alive"]]
        thr, gap = midpoint_of_gap(smax, 0.9)
        assert gap > 1e-5
        *jout, jn = JG.scale_pruning(jp, jo, js, np.float32(35.5), np.float32(thr))
        *tout, tn = TG.scale_pruning(tp, to, ts, 35.5, thr)
        assert_models_equal(jout, tout)
        assert int(tn) == int(jn) > 20

    @pytest.mark.parametrize("retain", [0.0, 0.25])
    def test_contribution_pruning(self, retain):
        """With a 6-value scene box and, with ``retain``, the sparsity
        distances of the alive centers (a host cKDTree in both)."""
        p, s, m, v = random_model(11)
        jp, js, jo = to_jax(p, s, m, v)
        tp, ts, to = to_torch(p, s, m, v)
        box = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
        j_ipd = JU.alive_inter_point_dist(jp.xyz, js.alive) if retain else None
        from triangle_splatting_tpu_torch.trainers.adc_utils import alive_inter_point_dist
        t_ipd = alive_inter_point_dist(tp.xyz, ts.alive) if retain else None
        kw = dict(min_view_count=1, prune_ratio=0.15, max_prune_ratio=0.2,
                  contrib_max_ratio=0.1, scene_bbox=box, sparsity_retain_ratio=retain)
        *jout, jn = JG.contribution_pruning(jp, jo, js, target_point_num=np.int32(60),
                                            inter_point_dist=j_ipd, **kw)
        *tout, tn = TG.contribution_pruning(tp, to, ts, target_point_num=60,
                                            inter_point_dist=t_ipd, **kw)
        assert_models_equal(jout, tout)
        assert int(tn) == int(jn) > 0


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

ITERS = 30
# toward 266 of the 300 initial Gaussians: each firing prunes four rows by
# contrib_sum (none by contrib_max) and retains one of them, at cuts clear of
# the statistics' tolerances on this scene (see ``dataset``)
TARGET = 266
CONTRIB_AT = (12, 24)
OPACITY_AT = (30,)


def gs_config(root, out_dir, **patch):
    """The gs-800-100k cell's recipe (the JAX smoke's VanillaGS config
    without densification, SH degree 3, with contribution pruning) scaled
    to 30 steps: statistic over (0, 30], SH bands at 6 / 12 / 18,
    contribution pruning at 12 and 24 toward 266 Gaussians, opacity pruning
    (threshold 0.005) at step 30."""
    lr = lambda a, b: dict(v_init=a, v_final=b, max_steps=ITERS)  # noqa: E731
    cfg = dict(
        dataset=dict(type="NerfSynthetic", local_dir=str(root), background="white",
                     use_alpha_mask=False, num_workers=2, pcd_path="point_cloud.ply",
                     hold_test_set=True),
        model=dict(
            max_sh_degree=3, pairs_per_triangle=16,
            sampling=dict(sample_method="direct", init_opacity=0.3),
            optimizer=dict(xyz=lr(0.002, 0.0002), scaling=lr(0.005, 0.005),
                           rotation=lr(0.001, 0.001), opacity=lr(0.05, 0.02),
                           f_dc=lr(0.02, 0.005), f_rest=lr(0.001, 0.001)),
            model_update=dict(
                sh_schedule=dict(one_up_iters=[6, 12, 18]),
                statistic=dict(start_iter=0, end_iter=ITERS),
                opacity_pruning=dict(start_iter=7, end_iter=ITERS, hold_iter=ITERS,
                                     interval_iter=ITERS, opacity_threshold_init=0.005,
                                     opacity_threshold_final=0.005),
                contribution_pruning=dict(
                    start_iter=3, end_iter=24, interval_iter=12, min_view_count=1,
                    target_point_num=TARGET, downsample_iteration=[],
                    downsample_point_num=[], prune_ratio=0.15, max_prune_ratio=0.2,
                    contrib_max_ratio=0.1, sparsity_retain_ratio=0.25))),
        trainer=dict(type="VanillaGS", output_dir=str(out_dir), iterations=ITERS,
                     initial_eval=False, log_interval_iter=5, eval_interval_iter=0,
                     histogram_interval_iter=0, train_background="white",
                     eval_background="white", w_ssim=0.2, use_tensorboard=False, seed=0))
    for path, value in patch.items():
        d = cfg
        *head, last = path.split(".")
        for k in head:
            d = d.setdefault(k, {})
        d[last] = value
    return cfg


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """80 GT triangles at 32x32 and a 300-point cloud. Scene seed 5: of
    seeds 2-7 and targets 180-293 it is one whose contribution cuts (the
    4th / 5th lowest contrib_sum at both firings, the retained row's kNN
    distance) lie clear of the statistics' tolerances; a change of scene,
    recipe or target must keep the test's gap assertions passing."""
    from triangle_splatting_tpu_torch.utils.testing import build_synthetic_nerf_dataset
    return build_synthetic_nerf_dataset(tmp_path_factory.mktemp("gs_mini_torch"), res=32,
                                        n_tri=80, pcd_points=300, seed=5, device="cpu")


@pytest.mark.parametrize("path,value,block", [
    ("trainer.ckpt_format", "orbax", "orbax"),
    ("trainer.data_parallel", 2, "data_parallel"),
    ("trainer.profile_start_iter", 5, "profile_start_iter"),
])
def test_build_trainer_refuses_unported_blocks(dataset, tmp_path, path, value, block):
    if block == "profile_start_iter":
        # served since the host-side slice: a torch.profiler window
        tr = build_trainer(dict_to_config(gs_config(dataset, tmp_path, **{path: value})),
                           device="cpu", log_file=False)
        assert tr.config.trainer.profile_start_iter == value and tr._profiler is None
        return
    if block == "data_parallel":
        # served since the parallel slice: 2 views a step in one process
        tr = build_trainer(dict_to_config(gs_config(dataset, tmp_path, **{
            path: value, "trainer.iterations": 4})), device="cpu", log_file=False)
        tr.train()
        losses = torch.stack(tr.loss_history).numpy()
        assert tr._dp_b == 2 and len(losses) == 4 and np.isfinite(losses).all()
        assert float(tr.state.gradient_denom.sum()) > 0
        return
    with pytest.raises(NotImplementedError, match=block):
        build_trainer(dict_to_config(gs_config(dataset, tmp_path, **{path: value})),
                      device="cpu", log_file=False)


def test_build_trainer_dispatch(dataset, tmp_path):
    """VanillaGS builds; ScaffoldGS builds its own trainer."""
    from triangle_splatting_tpu_torch.trainers.scaffold_gs import ScaffoldGSTrainer
    from triangle_splatting_tpu_torch.trainers.vanilla_gs import VanillaGSTrainer
    tr = build_trainer(dict_to_config(gs_config(dataset, tmp_path,
                                                **{"trainer.save_iterations": [ITERS + 1]})),
                       device="cpu", log_file=False)
    assert isinstance(tr, VanillaGSTrainer) and tr._track_stats
    assert tr._settings_for(tr.dataset.getTrainDataset()[0]).rasterizer_type == "GS"
    tr = build_trainer(dict_to_config(gs_config(dataset, tmp_path,
                                                **{"trainer.type": "ScaffoldGS"})),
                       device="cpu", log_file=False)
    assert isinstance(tr, ScaffoldGSTrainer)


def test_color_affine_and_lpips_left_unread_as_jax(dataset, tmp_path):
    """A VanillaGS config with ``model.use_color_affine`` and
    ``trainer.eval_lpips`` set builds and trains one step in both packages
    (the JAX VanillaGS trainer reads neither), and the two steps' losses
    agree within rel 1e-4 from the same converted weights."""
    from triangle_splatting_tpu.trainers.vanilla_gs import VanillaGSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
    patch = {"model.use_color_affine": True, "trainer.eval_lpips": True,
             "trainer.iterations": 1, "trainer.log_interval_iter": 1}
    jt = JT(j_dict_to_config(gs_config(dataset, tmp_path / "j", **patch)), impl="oracle",
            log_file=False)
    jt._init_model()
    tt = build_trainer(dict_to_config(gs_config(dataset, tmp_path / "t", **patch)),
                       device="cpu", log_file=False)
    tt.params, tt.state, tt.opt = gaussian_from_numpy(
        leaves(jt.params), leaves(jt.state), dict(m=leaves(jt.opt.m), v=leaves(jt.opt.v),
                                                  step=0), device="cpu")
    jt.train()
    tt.train()
    assert tt.params.capacity == jt.params.capacity and tt.opt.step == 1
    assert not hasattr(tt.params, "affine_weight")
    jv, tv = jt.dataset.getTrainDataset()[0], tt.dataset.getTrainDataset()[0]
    weights = tt._loss_weights(2)
    sched = jt._pack.pack({n: np.float32(w) for n, w in weights.items()}, jt._lrs(2),
                          np.ones(3, np.float32), 2)
    _, _, _, jl, _ = jt._train_step(jt._settings_for(jv), jt.params, jt.opt, jt.state,
                                    jv.strip_static(), sched)
    _, _, _, tl, _ = tt._train_step(tt._settings_for(tv), tt.params, tt.opt, tt.state, tv,
                                    weights, tt._lrs(2), torch.ones(3), 2)
    assert abs(float(tl) - float(jl)) <= 1e-4 * float(jl)


def stat_tol(name, want):
    """Per-row tolerance of a statistics field of the two trainers. View
    counts and radii: exact. Contributions: the Pallas transmittance (a
    Hillis-Steele product) sits ulps from the sequential one and an ulp
    may flip an isolated (pair, pixel) across the alpha >= 1/255 cut,
    which moves its contribution by alpha * T < 1/255: 4e-3 for a max, 8e-3
    for a sum, plus rel 5e-4 for 30 steps of weight drift. The center
    gradient norms: the Pallas backward's bf16 suffix sums (rel ~3e-3 per
    step) over 30 steps: 2e-2 of the largest."""
    if name == "contrib_max":
        return 4e-3
    if name == "contrib_sum":
        return 8e-3 + 5e-4 * np.abs(want)
    if name == "gradient_accum":
        return 2e-2 * float(np.abs(want).max())
    return 0.0


def assert_cut_clear(name, want, select, n):
    """The gap between the n-th and (n+1)-th smallest of ``want[select]`` is
    wider than the two rows' tolerances. Returns the gap."""
    w = want[select]
    order = np.argsort(w, kind="stable")
    if n <= 0 or n >= len(w):
        return np.inf
    lo, hi = order[n - 1], order[n]
    gap = float(w[hi] - w[lo])
    tol = np.broadcast_to(stat_tol(name, w), w.shape)
    assert gap > tol[lo] + tol[hi], (name, n, gap, w[lo], w[hi])
    return gap


def contribution_cuts(params, state, cp):
    """The JAX function's cuts on its own state before a contribution
    pruning: the contrib_max and contrib_sum ranks at the float32 counts,
    and the retention rank of the kNN distances among the rows to prune,
    each clear of the tolerances. Returns the counts and the gaps."""
    alive = np.asarray(state.alive)
    select = (np.asarray(state.contrib_denom) >= cp.min_view_count) & alive
    f = np.float32
    valid = total = f(alive.sum())
    diff = max(f(0), valid - f(cp.target_point_num) * f(0.99)) * total / max(valid, f(1))
    count = min(diff * f(cp.prune_ratio), f(select.sum()) * f(cp.max_prune_ratio))
    n_max = int(count * f(cp.contrib_max_ratio))
    n_sum = int(count * (f(1) - f(cp.contrib_max_ratio)))
    gaps = {name: assert_cut_clear(name, np.asarray(getattr(state, name)), select, n)
            for name, n in (("contrib_max", n_max), ("contrib_sum", n_sum))}
    mask, _ = JA.contribution_prune_mask(
        state, jnp.asarray(alive), min_view_count=cp.min_view_count,
        target_point_num=np.int32(cp.target_point_num), prune_ratio=cp.prune_ratio,
        max_prune_ratio=cp.max_prune_ratio, contrib_max_ratio=cp.contrib_max_ratio)
    mask = np.asarray(mask)
    ipd = np.sort(-np.asarray(JU.alive_inter_point_dist(params.xyz, state.alive))[mask])
    retain = int(f(cp.sparsity_retain_ratio) * f(mask.sum()))
    gaps["ipd"] = float(ipd[retain] - ipd[retain - 1]) if 0 < retain < len(ipd) else np.inf
    assert gaps["ipd"] > 1e-4, gaps
    return (n_max, n_sum, retain), gaps


def test_gs_lockstep_losses_and_masks_match_jax(dataset, tmp_path):
    """The JAX VanillaGS trainer (Pallas in interpret mode) and the port's
    trainer (plain kernel versions) step together from the same converted
    weights over the same views: per step the losses agree within rel
    1e-4 and the statistics within ``stat_tol``; every contribution cut
    and the opacity-pruning threshold lie clear of those tolerances; after
    every firing the alive masks are equal. The loss budget is the one
    step budget of the triangle lockstep (tests/test_torch_adc.py): the
    first step, from equal weights, already differs by rel 1.3e-5 (the
    SSIM term; against the JAX trainer on its dense oracle too), and the
    Pallas backward's bf16 sums move Adam's steps after it (measured
    5.2e-5 over the 30 steps)."""
    from triangle_splatting_tpu.trainers.vanilla_gs import VanillaGSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
    jt = JT(j_dict_to_config(gs_config(dataset, tmp_path / "j")), impl="pallas",
            interpret=True, log_file=False)
    jt._init_model()
    tt = build_trainer(dict_to_config(gs_config(dataset, tmp_path / "t")), device="cpu",
                       log_file=False)
    tt.params, tt.state, tt.opt = gaussian_from_numpy(
        leaves(jt.params), leaves(jt.state), dict(m=leaves(jt.opt.m), v=leaves(jt.opt.v),
                                                  step=0), device="cpu")
    cp = tt.config.model.model_update.contribution_pruning
    op = tt.config.model.model_update.opacity_pruning
    jviews, tviews = jt.dataset.getTrainDataset(), tt.dataset.getTrainDataset()
    n0 = int(tt.state.alive.sum())
    losses, fired = np.zeros((2, ITERS)), []
    for it in range(1, ITERS + 1):
        k = (it - 1) % len(tviews)
        weights = tt._loss_weights(it)
        sched = jt._pack.pack({n: np.float32(w) for n, w in weights.items()}, jt._lrs(it),
                              np.ones(3, np.float32), it)
        jt.params, jt.opt, jt.state, jl, _ = jt._train_step(
            jt._settings_for(jviews[k]), jt.params, jt.opt, jt.state,
            jviews[k].strip_static(), sched)
        tt.params, tt.opt, tt.state, tl, _ = tt._train_step(
            tt._settings_for(tviews[k]), tt.params, tt.opt, tt.state, tviews[k], weights,
            tt._lrs(it), torch.ones(3), it)
        losses[:, it - 1] = float(jl), float(tl)
        for name in STATE_FIELDS:
            got, want = getattr(tt.state, name).numpy(), np.asarray(getattr(jt.state, name))
            assert (np.abs(got - want) <= stat_tol(name, want)).all(), \
                (it, name, np.abs(got - want).max())
        if it in CONTRIB_AT:
            fired.append(contribution_cuts(jt.params, jt.state, cp))
        if it in OPACITY_AT:
            alive = np.asarray(jt.state.alive)
            opac = np.asarray(JG.get_opacity(jt.params))[alive, 0]
            assert np.abs(opac - op.opacity_threshold_final).min() > 1e-5
        jt._model_update(it)
        tt._model_update(it)
        np.testing.assert_array_equal(tt.state.alive.numpy(), np.asarray(jt.state.alive),
                                      err_msg=f"alive masks differ after step {it}")
        assert int(tt.state.active_sh_degree) == int(jt.state.active_sh_degree)
    step_rel = np.abs(losses[1] - losses[0]) / losses[0]
    print(f"max per-step loss rel diff {step_rel.max():.3e}; prune history "
          f"{tt.prune_history}; cuts ((n_by_max, n_by_sum, retained), gaps) {fired}")
    assert step_rel.max() <= 1e-4, step_rel
    assert losses[1, -5:].mean() < losses[1, :5].mean()
    hist = tt.prune_history
    assert [it for it, kind, _ in hist if kind == "contribution"] == list(CONTRIB_AT)
    assert all(n > 0 for _, kind, n in hist if kind == "contribution")
    assert [it for it, kind, _ in hist if kind == "opacity"] == list(OPACITY_AT)
    assert int(tt.state.active_sh_degree) == 3
    assert int(tt.state.alive.sum()) == n0 - sum(n for _, _, n in hist)
