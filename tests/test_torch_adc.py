"""The mesh recipe's adaptive density control in the port vs the JAX
package: the statistics update, pruning with its Adam-moment surgery,
scale and contribution pruning (with and without sparsity retention), the
contribution-pruning schedule, the bbox filter and the sparsity distances,
each on the same numpy state; then the JAX trainer and the port's trainer
stepping in lockstep through the recipe's statistic window with both
prunings firing. Pruned masks are compared exactly."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.models import adc_common as JA
from triangle_splatting_tpu.models import triangle as JM
from triangle_splatting_tpu.models.model_utils import get_inside_mask as j_inside
from triangle_splatting_tpu.trainers import adc_utils as JU
from triangle_splatting_tpu_torch.convert import triangle_from_numpy, triangle_to_numpy
from triangle_splatting_tpu_torch.models import adc_common as TA
from triangle_splatting_tpu_torch.models import triangle as TM
from triangle_splatting_tpu_torch.models.model_utils import get_inside_mask as t_inside
from triangle_splatting_tpu_torch.trainers import adc_utils as TU
from triangle_splatting_tpu_torch.trainers import build_trainer
from triangle_splatting_tpu_torch.utils.config import dict_to_config, loadConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

C = 300
STATE_FIELDS = ("gradient_accum", "gradient_denom", "max_radii2d", "contrib_sum",
                "contrib_max", "contrib_denom")


def leaves(tree):
    """numpy leaves of a JAX params/state dataclass keyed by field name."""
    return {f.name: None if getattr(tree, f.name) is None else np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def random_model(seed, K=1):
    """Numpy params / state / Adam moments of a capacity-C model with dead
    rows, distinct float statistics and integer view counts."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    p = dict(vertex=f(C, 3, 3) * 0.3, opacity=f(C, 1), f_dc=f(C, 1, 3), f_rest=f(C, K, 3))
    s = dict(alive=rng.random(C) < 0.85,
             gradient_accum=rng.uniform(0, 1, C).astype(np.float32),
             gradient_denom=rng.integers(0, 4, C).astype(np.float32),
             max_radii2d=rng.integers(0, 40, C).astype(np.float32),
             contrib_sum=rng.uniform(0, 20, C).astype(np.float32),
             contrib_max=rng.uniform(0, 1, C).astype(np.float32),
             contrib_denom=rng.integers(0, 3, C).astype(np.float32),
             gamma=np.float32(1.0), active_sh_degree=np.int32(0))
    m = {k: f(*v.shape) for k, v in p.items()}
    v = {k: np.abs(f(*x.shape)) for k, x in p.items()}
    return p, s, m, v


def to_jax(p, s, m, v):
    tp = lambda d: JM.TriangleParams(**{k: jnp.asarray(x) for k, x in d.items()})  # noqa: E731
    return (tp(p), JM.TriangleState(**{k: jnp.asarray(x) for k, x in s.items()}),
            JM.AdamState(m=tp(m), v=tp(v), step=jnp.int32(3)))


def to_torch(p, s, m, v):
    return triangle_from_numpy(p, s, dict(m=m, v=v, step=3), device="cpu")


def assert_models_equal(jout, tout, rtol=0.0):
    """(params, opt, state) of the JAX and the port function: alive and the
    counts exact, the floats to ``rtol``."""
    (jp, jo, js), (tp, to, ts) = jout, tout
    bp, bs, bo = triangle_to_numpy(tp, ts, to)
    for name, x in leaves(jp).items():
        if x is not None:
            np.testing.assert_array_equal(bp[name], x, err_msg=name)
    for which in ("m", "v"):
        for name, x in leaves(getattr(jo, which)).items():
            if x is not None:
                np.testing.assert_array_equal(bo[which][name], x, err_msg=f"{which}.{name}")
    np.testing.assert_array_equal(bs["alive"], np.asarray(js.alive))
    for name in STATE_FIELDS:
        np.testing.assert_allclose(bs[name], np.asarray(getattr(js, name)), rtol=rtol,
                                   atol=0, err_msg=name)


def test_update_statistics_matches_jax():
    """Counts and running maxima exact; the gradient norm within 1e-6
    (sqrt(x^2 + y^2) may round differently in the two libraries)."""
    p, s, m, v = random_model(0)
    rng = np.random.default_rng(1)
    g = rng.normal(size=(C, 2)).astype(np.float32) * 1e-3
    radii = rng.integers(0, 60, C).astype(np.int32)
    cs = rng.uniform(0, 25, C).astype(np.float32)
    cm = rng.uniform(0, 1, C).astype(np.float32)
    vis = (rng.random(C) < 0.6) & s["alive"]
    _, js, _ = to_jax(p, s, m, v)
    _, ts, _ = to_torch(p, s, m, v)
    jout = JM.update_statistics(js, jnp.asarray(g), jnp.asarray(radii), jnp.asarray(cs),
                                jnp.asarray(cm), jnp.asarray(vis))
    tout = TM.update_statistics(ts, torch.as_tensor(g), torch.as_tensor(radii),
                                torch.as_tensor(cs), torch.as_tensor(cm), torch.as_tensor(vis))
    for name in STATE_FIELDS:
        tol = 1e-6 if name == "gradient_accum" else 0.0
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                                   rtol=tol, atol=0, err_msg=name)
    # invisible rows keep their statistics
    assert torch.equal(tout.contrib_sum[~torch.as_tensor(vis)],
                       ts.contrib_sum[~torch.as_tensor(vis)])


def test_prune_and_zero_moments_match_jax():
    """prune clears the rows' statistics and Adam moments and never
    touches a dead row; zero_moments on a subset of the groups."""
    p, s, m, v = random_model(2)
    mask = np.random.default_rng(3).random(C) < 0.3
    jp, js, jo = to_jax(p, s, m, v)
    tp, ts, to = to_torch(p, s, m, v)
    jp2, jo2, js2 = JM.prune(jp, jo, js, jnp.asarray(mask))
    tp2, to2, ts2 = TM.prune(tp, to, ts, torch.as_tensor(mask))
    assert_models_equal((jp2, jo2, js2), (tp2, to2, ts2))
    assert int(ts2.alive.sum()) == int((s["alive"] & ~mask).sum())
    jz = JM.zero_moments(jo, jnp.asarray(mask), groups=("opacity",))
    tz = TM.zero_moments(to, torch.as_tensor(mask), groups=("opacity",))
    for which in ("m", "v"):
        for name, x in leaves(getattr(jz, which)).items():
            if x is not None:
                np.testing.assert_array_equal(getattr(getattr(tz, which), name).numpy(), x)


def midpoint_of_gap(values, quantile):
    """A threshold in the middle of the widest gap between sorted values
    around the quantile: far from every value, so float32 noise cannot
    move a row across it."""
    v = np.sort(values)
    i = int(len(v) * quantile)
    lo, hi = max(i - 10, 0), min(i + 10, len(v) - 1)
    j = lo + int(np.argmax(np.diff(v[lo:hi + 1])))
    return float((v[j] + v[j + 1]) / 2), float(v[j + 1] - v[j])


def test_scale_pruning_matches_jax():
    p, s, m, v = random_model(4)
    jp, js, jo = to_jax(p, s, m, v)
    tp, ts, to = to_torch(p, s, m, v)
    scaling = TM.get_scaling(tp).numpy()
    np.testing.assert_allclose(scaling, np.asarray(JM.get_scaling(jp)), rtol=1e-6)
    scale_thr, gap = midpoint_of_gap(scaling[s["alive"]], 0.9)
    assert gap > 1e-4
    radii_thr = 35.5                       # max_radii2d holds integers
    *jout, jn = JM.scale_pruning(jp, jo, js, np.float32(radii_thr), np.float32(scale_thr))
    *tout, tn = TM.scale_pruning(tp, to, ts, radii_thr, scale_thr)
    assert_models_equal(jout, tout)
    assert int(tn) == int(jn) > 0


def test_get_inside_mask_matches_jax():
    pts = np.random.default_rng(5).uniform(-2, 2, (500, 3)).astype(np.float32)
    for box in (None, [-1.0, -0.5, 1.2, 0.8], [-1.0, -0.5, -1.5, 1.2, 0.8, 0.3]):
        got = t_inside(torch.as_tensor(pts), box).numpy()
        want = np.asarray(j_inside(jnp.asarray(pts), box))
        np.testing.assert_array_equal(got, want)
        assert got.any() and (box is None or not got.all())


def prune_args(target, retain=0.0, ipd=None):
    return dict(min_view_count=1, target_point_num=target, prune_ratio=0.15,
                max_prune_ratio=0.2, contrib_max_ratio=0.1, inter_point_dist=ipd,
                sparsity_retain_ratio=retain)


@pytest.mark.parametrize("retain", [0.0, 0.25])
def test_contribution_prune_mask_matches_jax(retain):
    """The float32 counts and the stable argsort ranks of the JAX function,
    over targets that sweep the prune count through many integer cuts of
    n_by_max / n_by_sum: the masks and the selected rows are equal."""
    p, s, m, v = random_model(6)
    _, js, _ = to_jax(p, s, m, v)
    _, ts, _ = to_torch(p, s, m, v)
    rng = np.random.default_rng(7)
    inside = s["alive"] & (rng.random(C) < 0.9)
    ipd = rng.uniform(0.01, 0.2, C).astype(np.float32)
    counts = set()
    for target in range(0, 260, 7):
        jm, jsel = JA.contribution_prune_mask(
            js, jnp.asarray(inside), **prune_args(np.int32(target), retain,
                                                  jnp.asarray(ipd) if retain else None))
        tm, tsel = TA.contribution_prune_mask(
            ts, torch.as_tensor(inside), **prune_args(target, retain,
                                                      torch.as_tensor(ipd) if retain else None))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm), err_msg=str(target))
        np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
        counts.add(int(tm.sum()))
    assert len(counts) > 5 and max(counts) > 20


def test_contribution_pruning_matches_jax():
    """The whole operation with a 6-value scene box, the STE filter and
    sparsity retention: pruned rows, reset statistics, Adam moments."""
    p, s, m, v = random_model(8)
    jp, js, jo = to_jax(p, s, m, v)
    tp, ts, to = to_torch(p, s, m, v)
    box = [-0.4, -0.4, -0.4, 0.4, 0.4, 0.4]
    ipd = TU.alive_inter_point_dist(TM.get_xyz(tp), ts.alive)
    j_ipd = JU.alive_inter_point_dist(JM.get_xyz(jp), js.alive)
    np.testing.assert_allclose(ipd.numpy(), np.asarray(j_ipd), rtol=1e-6)
    kw = dict(prune_args(60, 0.25), scene_bbox=box, ste_threshold=0.3)
    *jout, jn = JM.contribution_pruning(jp, jo, js, **dict(kw, inter_point_dist=j_ipd,
                                                           target_point_num=np.int32(60)))
    *tout, tn = TM.contribution_pruning(tp, to, ts, **dict(kw, inter_point_dist=ipd))
    assert_models_equal(jout, tout)
    assert int(tn) == int(jn) > 0


def test_resolve_contribution_pruning_matches_jax():
    cp = dict(target_point_num=None, contrib_max_ratio=0.1, prune_ratio=0.15,
              sparsity_retain_ratio=0.25, downsample_iteration=[10, 20],
              downsample_point_num=[500, 300])
    tcp = dict_to_config(cp)
    from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
    jcp = j_dict_to_config(cp)
    seen = set()
    for it in (5, 10, 11, 20, 25):
        got = TU.resolve_contribution_pruning(tcp, it)
        assert got == JU.resolve_contribution_pruning(jcp, it)
        seen.add(got[0])
    assert seen == {None, 500, 300}


# ---------------------------------------------------------------------------
# the JAX trainer and the port in lockstep through the statistic window
# ---------------------------------------------------------------------------

ITERS = 30
TARGET = 200
SCALE_AT = (10, 20, 30)
CONTRIB_AT = (12, 24)


def stat_tol(name, want):
    """Per-row tolerance of a statistics field of the two trainers.

    View counts and radii: exact. Contributions: the Pallas pipeline's T
    (a Hillis-Steele product) sits ulps from the sequential one, and an
    ulp flips an isolated (pair, pixel) across the alpha >= 1/255 cut,
    which moves its contribution by alpha * T < 1/255: 4e-3 for a max
    (one flipped pixel), 8e-3 for a sum (two), plus rel 5e-4 for the ~1e-6
    drift of 30 steps of weights magnified by the anneal's ecc^(2 gamma).
    The centroid-gradient sums: the Pallas backward's bf16 pixel sums
    (rel 5e-3 per step, test_torch_mesh) over 28 steps, and past gamma 5
    an edge pixel's gradient jumps with an ulp: 2.5e-2 of the largest."""
    if name == "contrib_max":
        return 4e-3
    if name == "contrib_sum":
        return 8e-3 + 5e-4 * np.abs(want)
    if name == "gradient_accum":
        return 2.5e-2 * float(np.abs(want).max())
    return 0.0


def adc_config(root, out_dir):
    """config/NerfSynthetic_VanillaTS_mesh.yaml with its three ADC blocks,
    windows compressed to 30 steps (statistic over (2, 30], scale pruning
    at 10/20/30, contribution pruning at 12/24 toward 200 triangles), the
    gamma anneal at steps 5-25, on the tiny dataset."""
    cfg = loadConfig(Path(__file__).resolve().parents[1] / "config"
                     / "NerfSynthetic_VanillaTS_mesh.yaml").to_dict()
    mu = cfg["model"]["model_update"]
    mu["statistic"].update(start_iter=2, end_iter=ITERS)
    mu["scale_pruning"].update(start_iter=2, end_iter=ITERS, interval_iter=10)
    mu["contribution_pruning"].update(start_iter=2, end_iter=ITERS, interval_iter=12,
                                      target_point_num=TARGET)
    mu["gamma_schedule"].update(start_iter=5, end_iter=25)
    cfg["dataset"]["local_dir"] = str(root)
    cfg["trainer"].update(output_dir=str(out_dir), iterations=ITERS, seed=0,
                          initial_eval=False, log_interval_iter=5,
                          eval_interval_iter=0, histogram_interval_iter=0,
                          use_tensorboard=False)
    return cfg


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """80 GT triangles at 32x32 and a 300-point cloud: 300 initial
    triangles small enough that the recipe's scale threshold (0.5) takes
    only a few."""
    from triangle_splatting_tpu_torch.utils.testing import build_synthetic_nerf_dataset
    return build_synthetic_nerf_dataset(tmp_path_factory.mktemp("adc_mini_torch"),
                                        res=32, n_tri=80, pcd_points=300, device="cpu")


def assert_cut_clear(name, want, got, select, n):
    """The n smallest rows of ``want[select]`` are those of ``got[select]``:
    the gap at the cut is wider than the two rows' tolerances, or the last
    row cut holds an exact 0 (a row whose STE opacity is 0 contributes
    nothing) and both trainers hold exact zeros at the same rows, which
    both rank by index. Returns the gap."""
    w, g = want[select], got[select]
    order = np.argsort(w, kind="stable")
    if n <= 0 or n >= len(w):
        return np.inf
    lo, hi = order[n - 1], order[n]
    gap = float(w[hi] - w[lo])
    tol = np.broadcast_to(stat_tol(name, w), w.shape)
    if gap <= tol[lo] + tol[hi]:
        assert w[lo] == 0.0, (name, n, gap, w[lo], w[hi])
        np.testing.assert_array_equal(w == 0.0, g == 0.0)
    return gap


def contribution_cuts(params, state, tstate, cp, ste):
    """Check the JAX function's cuts on its own state against the port's
    state before a contribution-pruning firing: the contrib_max and
    contrib_sum ranks (float32 counts in its order) and the retention rank
    of the kNN distances among the rows to prune. Returns the counts and
    the gaps."""
    alive = np.asarray(state.alive)
    inside = alive & (np.asarray(JM.get_opacity(params))[:, 0] > ste)
    select = (np.asarray(state.contrib_denom) >= cp.min_view_count) & alive
    f = np.float32
    valid, total = f(inside.sum()), f(alive.sum())
    diff = max(f(0), valid - f(cp.target_point_num) * f(0.99)) * total / max(valid, f(1))
    count = min(diff * f(cp.prune_ratio), f(select.sum()) * f(cp.max_prune_ratio))
    n_max = int(count * f(cp.contrib_max_ratio))
    n_sum = int(count * (f(1) - f(cp.contrib_max_ratio)))
    gaps = {name: assert_cut_clear(name, np.asarray(getattr(state, name)),
                                   getattr(tstate, name).numpy(), select, n)
            for name, n in (("contrib_max", n_max), ("contrib_sum", n_sum))}
    mask, _ = JA.contribution_prune_mask(
        state, jnp.asarray(inside), **prune_args(np.int32(cp.target_point_num)))
    mask = np.asarray(mask)
    ipd = np.sort(-np.asarray(JU.alive_inter_point_dist(JM.get_xyz(params), state.alive))[mask])
    retain = int(f(cp.sparsity_retain_ratio) * f(mask.sum()))
    # kNN distances of centroids that agree to ~1e-6
    gaps["ipd"] = float(ipd[retain] - ipd[retain - 1]) if 0 < retain < len(ipd) else np.inf
    assert gaps["ipd"] > 1e-4, gaps
    return (n_max, n_sum, retain), gaps


def test_adc_lockstep_masks_match_jax(dataset, tmp_path):
    """The mesh recipe with its statistic, scale_pruning and
    contribution_pruning blocks: the JAX trainer (Pallas in interpret
    mode) and the port's trainer (plain kernel versions) step together
    from the same converted weights over the same views. Per step the
    losses agree (rel 1e-4, the one-step budget) and the statistics within
    ``stat_tol``; at every contribution cut the gap between the last
    pruned and the first kept value is wider than the two rows'
    tolerances (or the cut lies in a run of exact zeros both hold), and
    after every firing the alive masks are equal."""
    from triangle_splatting_tpu.trainers.vanilla_ts import VanillaTSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
    cfg = adc_config(dataset, tmp_path / "j")
    jt = JT(j_dict_to_config(cfg), impl="pallas", interpret=True, log_file=False)
    jt._init_model()
    tt = build_trainer(dict_to_config(adc_config(dataset, tmp_path / "t")), device="cpu",
                       log_file=False)
    tt.params, tt.state, tt.opt = triangle_from_numpy(
        leaves(jt.params), leaves(jt.state), dict(m=leaves(jt.opt.m), v=leaves(jt.opt.v), step=0),
        device="cpu")
    cp = tt.config.model.model_update.contribution_pruning
    sp = tt.config.model.model_update.scale_pruning
    ste = tt.model_cfg.ste_threshold
    jviews, tviews = jt.dataset.getTrainDataset(), tt.dataset.getTrainDataset()
    n0 = int(tt.state.alive.sum())
    losses, fired = np.zeros((2, ITERS)), []
    for it in range(1, ITERS + 1):
        k = (it - 1) % len(tviews)
        sched = jt._pack.pack(jt._loss_weights(it), jt._lrs(it), np.ones(3, np.float32), it)
        jt.params, jt.opt, jt.state, jl, _ = jt._train_step(
            jt._settings_for(jviews[k]), jt.params, jt.opt, jt.state,
            jviews[k].strip_static(), sched, None)
        tt.params, tt.opt, tt.state, tl, _ = tt._train_step(
            tt._settings_for(tviews[k]), tt.params, tt.opt, tt.state, tviews[k],
            tt._loss_weights(it), tt._lrs(it), torch.ones(3), it)
        losses[:, it - 1] = float(jl), float(tl)
        for name in STATE_FIELDS:
            got, want = getattr(tt.state, name).numpy(), np.asarray(getattr(jt.state, name))
            assert (np.abs(got - want) <= stat_tol(name, want)).all(), \
                (it, name, np.abs(got - want).max())
        if it in CONTRIB_AT:
            fired.append(contribution_cuts(jt.params, jt.state, tt.state, cp, ste))
        if it in SCALE_AT:
            # no alive row within the float noise of either threshold
            alive = np.asarray(jt.state.alive)
            scaling = np.asarray(JM.get_scaling(jt.params))[alive]
            assert np.abs(scaling - sp.scale_threshold).min() > 1e-4
            radii = np.asarray(jt.state.max_radii2d)[alive]
            assert np.abs(radii - sp.radii_threshold).min() >= 1.0
        jt._model_update(it)
        tt._model_update(it)
        np.testing.assert_array_equal(tt.state.alive.numpy(), np.asarray(jt.state.alive),
                                      err_msg=f"alive masks differ after step {it}")
        assert float(tt.state.gamma) == pytest.approx(float(jt.state.gamma), rel=1e-6)
    step_rel = np.abs(losses[1] - losses[0]) / losses[0]
    print(f"max per-step loss rel diff {step_rel.max():.3e}; prune history {tt.prune_history}; "
          f"cuts ((n_by_max, n_by_sum, retained), gaps) {fired}")
    assert step_rel.max() <= 1e-4, step_rel
    contrib = [n for it, kind, n in tt.prune_history if kind == "contribution"]
    assert [it for it, kind, _ in tt.prune_history if kind == "contribution"] == list(CONTRIB_AT)
    assert [it for it, kind, _ in tt.prune_history if kind == "scale"] == list(SCALE_AT)
    assert all(n > 0 for n in contrib)
    assert int(tt.state.alive.sum()) == n0 - sum(n for _, _, n in tt.prune_history)
