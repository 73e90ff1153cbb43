"""The port's ScaffoldGS trainer against the JAX package's on the CPU, at
the JAX tests' small widths (feat 8, hidden 16, k 4) on a 32x32 synthetic
scene:

- ``build_trainer`` dispatch, the shipped ``config/Colmap_ScaffoldGS.yaml``
  at its own widths, and the refusals;
- the two trainers in lockstep for 30 steps from the same converted
  weights (the JAX trainer on its dense oracle, the port's on its plain
  kernel versions) with one anchor update in the window, the port's coin
  flips handed JAX's draws: the loss within rel 1e-4 a step, the
  statistics within their tolerance, equal anchor counts;
- the checkpoint both ways and the PLY against JAX's ``savePLY``;
- the MLP pretrain in lockstep;
- the smoke ``--model scaffold`` quick check at 48x48 and its config
  against the JAX smoke's.
"""

import dataclasses
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.models import scaffold as JS
from triangle_splatting_tpu_torch.convert import scaffold_from_numpy, scaffold_to_numpy
from triangle_splatting_tpu_torch.models import scaffold as TS
from triangle_splatting_tpu_torch.models.raw_gaussian import RawGaussian
from triangle_splatting_tpu_torch.trainers import build_trainer, smoke
from triangle_splatting_tpu_torch.utils import checkpoint as TC
from triangle_splatting_tpu_torch.utils.config import dict_to_config, loadConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ITERS = 30
UPDATE_AT = 20          # the one anchor update: window (4, 30], every 20 steps
REPO = Path(__file__).resolve().parents[1]


def tree_np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: tree_np(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: tree_np(v) for k, v in x.items()}
    return None if x is None else np.asarray(x)


def assert_trees(want, got, rtol=0.0, atol=0.0, path=""):
    if isinstance(want, dict):
        assert set(want) == set(got), (path, set(want) ^ set(got))
        for k in want:
            assert_trees(want[k], got[k], rtol, atol, f"{path}.{k}")
    elif want is None:
        assert got is None, path
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                                   err_msg=path)


def scaffold_config(root, out_dir, iters=ITERS, **patch):
    """The smoke's ScaffoldGS recipe at the JAX tests' widths, scaled to 30
    steps: statistics in (4, 30], one grow / prune at step 20 (min view
    counts 1), thresholds 1e-4 and 0.005, a log step every 10 (the pair
    budget re-sizes)."""
    lr = lambda v: dict(v_init=v, v_final=v, max_steps=iters)  # noqa: E731
    cfg = dict(
        dataset=dict(type="NerfSynthetic", local_dir=str(root), background="white",
                     use_alpha_mask=False, num_workers=2, pcd_path="point_cloud.ply",
                     hold_test_set=True),
        model=dict(
            feat_dim=8, hidden_dim=16, n_offsets=4, voxel_size=0.1, max_offset_scale=1.0,
            max_scaling_scale=1.0, capacity_factor=4.0, pairs_per_triangle=8,
            optimizer=dict(anchor=lr(0.0), anchor_feat=lr(0.05), mlp_offset=lr(0.01),
                           mlp_opacity=lr(0.01), mlp_cov=lr(0.01), mlp_color=lr(0.01),
                           mlp_scaling=lr(0.01)),
            anchor_update=dict(start_iter=4, end_iter=iters, interval_iter=UPDATE_AT,
                               grad_threshold_init=1e-4, grad_threshold_final=1e-4,
                               opacity_threshold_init=0.005, opacity_threshold_final=0.005,
                               grad_min_view_count=1, opacity_min_view_count=1,
                               update_depth=2, update_init_factor=4,
                               update_hierachy_factor=4)),
        trainer=dict(type="ScaffoldGS", output_dir=str(out_dir), iterations=iters,
                     initial_eval=False, log_interval_iter=10, eval_interval_iter=0,
                     w_ssim=0.2, w_scaling_reg=0.01, w_opacity_reg=0.01,
                     save_iterations=[], checkpoint_iterations=[],
                     train_background="white", eval_background="white",
                     use_tensorboard=False, seed=0))
    for path, value in patch.items():
        d = cfg
        *head, last = path.split(".")
        for k in head:
            d = d.setdefault(k, {})
        d[last] = value
    return cfg


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """80 GT triangles at 32x32 and a 300-point cloud. Scene seed 6 (with the
    trainer's seed 0): of scene seeds 5-6 and trainer seeds 0-3 it is one
    where no decoded Gaussian crosses the selection's opacity threshold or
    a pixel's alpha cut in one trainer and not the other over the 30
    steps. Such a crossing gives a row a gradient on one side only, and
    Adam (eps 1e-15) turns any gradient into a step of the full learning
    rate: the features part, and after the next anchor update the loss
    differs by rel 1e-4 to 2e-3 (seeds 0/5, 1/5, 1/6, 2/6). A change of
    scene or recipe must keep the test's budgets and margin assertions
    passing, not loosen them."""
    from triangle_splatting_tpu_torch.utils.testing import build_synthetic_nerf_dataset
    return build_synthetic_nerf_dataset(tmp_path_factory.mktemp("scaffold_torch"), res=32,
                                        n_tri=80, pcd_points=300, seed=6, device="cpu")


def both_trainers(dataset, tmp_path, jax_impl="oracle", **patch):
    """The JAX trainer (its dense oracle, or ``jax_impl="pallas"`` in
    interpret mode) and the port's (plain kernel versions) on one config,
    the port's weights converted from the JAX init."""
    from triangle_splatting_tpu.trainers.scaffold_gs import ScaffoldGSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
    jt = JT(j_dict_to_config(scaffold_config(dataset, tmp_path / "j", **patch)),
            impl=jax_impl, interpret=jax_impl == "pallas", log_file=False)
    jt._init_model()
    tt = build_trainer(dict_to_config(scaffold_config(dataset, tmp_path / "t", **patch)),
                       device="cpu", log_file=False)
    tt.params, tt.state, tt.opt = scaffold_from_numpy(
        tree_np(jt.params), tree_np(jt.state), tree_np(jt.opt), device="cpu")
    return jt, tt


def test_build_trainer_dispatch_and_shipped_config(dataset, tmp_path):
    """ScaffoldGS builds through build_trainer; the shipped COLMAP recipe
    keeps its widths (feat 32, hidden 32, k 10, voxel 0.001, capacity
    factor 4, 8 pairs a Gaussian); data parallelism is refused by name."""
    from triangle_splatting_tpu_torch.trainers.scaffold_gs import LR_GROUPS, ScaffoldGSTrainer
    tr = build_trainer(dict_to_config(scaffold_config(dataset, tmp_path)), device="cpu",
                       log_file=False)
    assert isinstance(tr, ScaffoldGSTrainer) and tr._track_stats
    assert set(tr._lrs(1)) == set(LR_GROUPS)
    cfg = loadConfig(REPO / "config" / "Colmap_ScaffoldGS.yaml")
    m = cfg.model
    assert (m.feat_dim, m.hidden_dim, m.n_offsets, m.voxel_size, m.capacity_factor,
            m.pairs_per_triangle) == (32, 32, 10, 0.001, 4.0, 8)
    cfg.dataset = dict_to_config(scaffold_config(dataset, tmp_path)["dataset"])
    cfg.trainer.output_dir = str(tmp_path / "shipped")
    shipped = build_trainer(cfg, device="cpu", log_file=False)
    assert shipped.model_cfg == TS.ScaffoldConfig()          # the JAX defaults
    assert shipped._ppt == 8 and shipped._u.grad_min_view_count == 100
    shipped._init_model()
    assert shipped.params.anchor_feat.shape[1] == 32
    with pytest.raises(NotImplementedError, match="data_parallel"):
        build_trainer(dict_to_config(scaffold_config(dataset, tmp_path,
                                                     **{"trainer.data_parallel": 2})),
                      device="cpu", log_file=False)


def jax_coins(prng, C, k, depth):
    """The coins the JAX trainer's next anchor update draws."""
    _, key = jax.random.split(prng)
    out = []
    for _ in range(depth):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.uniform(sub, (C, k))))
    return out


def check_growth_margins(jt, tt, thr):
    """Before the anchor update: each examined offset's mean gradient lies
    further from each level's threshold than four times its own difference
    between the trainers (so both pick the same candidates), and each
    candidate's decoded coordinates lie further from a voxel boundary (.5
    of a voxel) than four times their own difference between the two
    decodes (so both round them into the same voxel; the anchors do not
    move: lr 0, as the shipped recipe). Returns the margins."""
    cfg = jt.model_cfg
    jx = np.asarray(JS.generate_gaussians(jt.params, jt.state, cfg)["xyz"]).reshape(-1, 3)
    tx = TS.generate_gaussians(tt.params, tt.state, tt.model_cfg)["xyz"].reshape(-1, 3)
    st = jt.state
    examined = np.asarray(st.alive)[:, None] & (np.asarray(st.offset_denom) > 1.0)
    jg = np.asarray(st.offset_grad_accum) / (1e-15 + np.asarray(st.offset_denom))
    tg = (tt.state.offset_grad_accum / (1e-15 + tt.state.offset_denom)).numpy()
    gdiff = np.abs(jg - tg)[examined]
    out = dict(grad_diff_max=float(gdiff.max()))
    for level in range(cfg.update_depth):
        lthr = thr * (cfg.update_hierachy_factor // 2) ** level
        gap = np.abs(jg[examined] - lthr)
        assert (gap > 4 * gdiff).all(), (level, gap.min(), gdiff[np.argmin(gap / gdiff)])
        cand = (examined & (jg >= lthr)).reshape(-1)
        size = float(st.voxel_size) * max(cfg.update_init_factor
                                          // cfg.update_hierachy_factor ** level, 1)
        frac = np.abs(np.abs((jx[cand] / size) % 1.0) - 0.5) * size
        xdiff = np.abs(jx - tx.detach().numpy())[cand]
        assert (frac > 4 * xdiff).all(), (level, frac.min(), xdiff.max())
        out[f"level{level}"] = dict(
            candidates=int(cand.sum()), grad_gap_ratio=float((gap / np.maximum(gdiff, 1e-30)).min()),
            voxel_gap_ratio=float((frac / np.maximum(xdiff, 1e-30)).min()))
    return out


def test_scaffold_lockstep_matches_jax(dataset, tmp_path):
    """30 steps of both trainers over the same views: per step the losses
    agree within rel 1e-4 (the budget of the VanillaGS lockstep) and the
    statistics within 1e-3 (opacities) and 1e-2 (center-gradient norms) of
    their largest: a (Gaussian, pixel) pair whose alpha sits at the 1/255
    cut in the dense oracle and not in the tile pipeline moves one row's
    center gradient by up to 7e-3 of the largest; the growth below asserts
    its own per-row margins. The anchor update at
    step 20, with JAX's coin flips handed to the port and every candidate
    clear of its voxel boundary and threshold, grows and prunes the same
    anchors; the pair budget re-sizes equally. Then the checkpoints both
    ways, the test PSNR of both, and the PLY against JAX's."""
    jt, tt = both_trainers(dataset, tmp_path)
    jviews, tviews = jt.dataset.getTrainDataset(), tt.dataset.getTrainDataset()
    C, k = tt.params.capacity, tt.model_cfg.n_offsets
    losses, margins = np.zeros((2, ITERS)), None
    for it in range(1, ITERS + 1):
        i = (it - 1) % len(tviews)
        weights = tt._loss_weights(it)
        sched = jt._pack.pack({n: np.float32(w) for n, w in weights.items()}, jt._lrs(it),
                              np.ones(3, np.float32), it)
        jt.params, jt.opt, jt.state, jl, jaux = jt._train_step(
            jt._settings_for(jviews[i]), jt.params, jt.opt, jt.state,
            jviews[i].strip_static(), sched)
        tt.params, tt.opt, tt.state, tl, taux = tt._train_step(
            tt._settings_for(tviews[i]), tt.params, tt.opt, tt.state, tviews[i], weights,
            tt._lrs(it), torch.ones(3), it)
        losses[:, it - 1] = float(jl), float(tl)
        for name, rel in (("opacity_accum", 1e-3), ("offset_grad_accum", 1e-2)):
            want, got = np.asarray(getattr(jt.state, name)), getattr(tt.state, name).numpy()
            assert np.abs(got - want).max() <= rel * np.abs(want).max() + 1e-12, (it, name)
        for name in ("anchor_denom", "offset_denom"):
            np.testing.assert_array_equal(getattr(tt.state, name).numpy(),
                                          np.asarray(getattr(jt.state, name)), err_msg=name)
        jt._maintain_constraints(it)
        tt._maintain_constraints(it)
        coins = None
        if it == UPDATE_AT:
            margins = check_growth_margins(jt, tt, np.float32(1e-4))
            coins = jax_coins(jt._prng, C, k, tt.model_cfg.update_depth)
        jt._anchor_update(it)
        tt._anchor_update(it, coins=coins)
        np.testing.assert_array_equal(tt.state.alive.numpy(), np.asarray(jt.state.alive),
                                      err_msg=f"alive after step {it}")
        if it % 10 == 0:
            tt._resize_pair_budget(int(taux["num_pairs"]), C * k, bool(taux["overflow"]))
    step_rel = np.abs(losses[1] - losses[0]) / losses[0]
    print(f"max per-step loss rel diff {step_rel.max():.3e}; anchor updates "
          f"{tt.anchor_history}; margins {margins}")
    assert step_rel.max() <= 1e-4, step_rel
    assert losses[1, -5:].mean() < losses[1, :5].mean()
    (upd,) = tt.anchor_history
    assert upd["iteration"] == UPDATE_AT and upd["added"] == upd["placed"] > 0
    n0 = int(np.asarray(JS.create_from_points(
        tt.dataset.getPointCloud().points, jt.model_cfg, voxel_size=0.1)[1].alive.sum()))
    assert upd["alive"] == n0 + upd["placed"] - upd["removed"] == int(tt.state.alive.sum())

    # the checkpoints both ways: the port's blob has the JAX blob's layout
    # (keys, shapes, dtypes), the JAX blob goes through the port's
    # containers and back unchanged, and each package renders the other's
    # model at the same test PSNR as the package that trained it
    jt.save_ckpt(tmp_path / "j.ckpt")
    tt.save_ckpt(tmp_path / "t.ckpt")
    with open(tmp_path / "j.ckpt", "rb") as f:
        want = tree_np(pickle.load(f))
    got = TC.load_ckpt(tmp_path / "t.ckpt")
    layout = lambda b: {k: layout(v) for k, v in b.items()} if isinstance(b, dict) \
        else None if b is None else (b.shape, b.dtype.str)  # noqa: E731
    assert layout(got) == layout(want)
    p, st, o = scaffold_from_numpy(want["params"], want["state"], want["opt"], device="cpu")
    assert_trees(want, TC.model_blob(*scaffold_to_numpy(p, st, o), want["scene_bbox"]))
    t2 = build_trainer(dict_to_config(scaffold_config(dataset, tmp_path / "t2")), device="cpu",
                       log_file=False)
    t2.params, t2.state, t2.opt = p, st, o
    p_jax, p_port_of_jax = jt._evaluate(ITERS), t2._evaluate(ITERS)
    jt.params = JS.ScaffoldParams(**{n: jax.tree_util.tree_map(jax.numpy.asarray, v)
                                     for n, v in got["params"].items()})
    jt.state = JS.ScaffoldState(**{n: jax.numpy.asarray(v) for n, v in got["state"].items()})
    p_port, p_jax_of_port = tt._evaluate(ITERS), jt._evaluate(ITERS)
    assert abs(p_port_of_jax - p_jax) < 1e-3 and abs(p_jax_of_port - p_port) < 1e-3

    # the PLY of one model: the port's against JAX's savePLY
    jt.savePLY(tmp_path / "j.ply")
    tt.savePLY(tmp_path / "t.ply")
    jg, tg = RawGaussian(ply_path=str(tmp_path / "j.ply")), RawGaussian(
        ply_path=str(tmp_path / "t.ply"))
    assert len(tg) == len(jg) > 0
    for name in ("xyz", "shs", "scale", "rotation", "opacity"):
        np.testing.assert_allclose(getattr(tg, name), getattr(jg, name), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_mlp_pretrain_matches_jax(dataset, tmp_path):
    """The distillation on a 60-Gaussian GT PLY for 30 steps in both
    packages: the GT package and the init equal, the losses within rel 1e-5
    a step and falling, the heads within rel 1e-4 at the end."""
    rng = np.random.default_rng(1)
    n = 60
    gt = RawGaussian(xyz=rng.normal(size=(n, 3)).astype(np.float32),
                     opacity=rng.normal(size=(n, 1)).astype(np.float32),
                     shs=rng.normal(size=(n, 3)).astype(np.float32),
                     scale=(rng.normal(size=(n, 3)) - 2).astype(np.float32),
                     rotation=np.tile([1, 0, 0, 0.0], (n, 1)).astype(np.float32))
    gt.savePLY(tmp_path / "gt.ply")
    patch = {"dataset.gt_gaussian_path": str(tmp_path / "gt.ply"), "model.voxel_size": 0.5,
             "trainer.pretrain": {"iterations": 30, "log_interval_iter": 0}}
    jt, tt = both_trainers(dataset, tmp_path, **patch)
    jl = []
    orig = jt._pretrain_step

    def spy(*args):
        out = orig(*args)
        jl.append(float(out[2]))
        return out
    jt._pretrain_step = spy
    jt.mlp_pretrain()
    tt.mlp_pretrain()
    tl = np.array([float(x) for x in tt.pretrain_losses])
    assert len(tl) == len(jl) == 30
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    p, s, _ = scaffold_to_numpy(tt.params, tt.state)
    assert_trees(tree_np(jt.state), s)
    assert_trees(tree_np(jt.params), p, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("iters", [80, 400])
@pytest.mark.parametrize("densify", [True, False])
def test_smoke_scaffold_config_equals_jax(iters, densify):
    from triangle_splatting_tpu.trainers.smoke import make_smoke_config as j_smoke_config
    assert smoke.make_smoke_config("/d", "/o", iters, densify=densify, model="scaffold") \
        .to_dict() == j_smoke_config("/d", "/o", iters, densify=densify,
                                     model="scaffold").to_dict()


def test_cpu_smoke_scaffold(tmp_path):
    """``smoke --model scaffold`` at the README's CPU quick-check size on the
    plain kernel versions: the anchor update at 50 grows anchors, the alive
    count moves by the logged placements and removals, the PLY and the
    checkpoint are written at 80, and the PSNR climbs by the smoke's 2 dB
    (main's exit)."""
    argv = "--res 48 --iters 80 --n_tri 120 --views 6 --device cpu --model scaffold".split()
    trainer, rec = smoke.run(smoke.parse_args(argv + ["--root", str(tmp_path)]))
    hist = trainer.anchor_history
    assert [h["iteration"] for h in hist] == [50]
    assert hist[0]["added"] == hist[0]["placed"] > 0
    pts = trainer.dataset.getPointCloud().points
    n0 = int(TS.create_from_points(pts, trainer.model_cfg, voxel_size=0.1,
                                   device="cpu")[1].alive.sum())
    assert rec["alive_triangles"] == n0 + sum(h["placed"] - h["removed"] for h in hist)
    for f in ("point_cloud/80.ply", "ckpt/80.ckpt"):
        assert (tmp_path / "out" / f).exists(), f
    assert rec["psnr_final"] >= rec["psnr_init"] + 2.0, rec
    losses = torch.stack(trainer.loss_history).numpy()
    assert np.isfinite(losses).all() and losses[-10:].mean() < losses[:10].mean()
