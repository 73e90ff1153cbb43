"""The port's twin of ``trainers/smoke.py``: its config against the JAX
function's, the refusals of the parts not ported, the CPU smoke of the
photo and the Gaussian recipes (48x48, 80 iterations, 120 GT triangles, 6
views: the README's CPU quick check, on the plain kernel versions), and
the JAX and the port trainers in lockstep up to the smoke's first
densification firing.

The smoke's own thresholds grow rows at this size (13 triangles and 5
Gaussians at iteration 50), so none is lowered. In the lockstep the grown
counts agree, and a row that grows on one side only must have its mean
gradient within 1e-4 relative of the threshold (the per-step budget of
the losses, which the statistics inherit)."""

import numpy as np
import pytest

from triangle_splatting_tpu.trainers.smoke import make_smoke_config as j_smoke_config
from triangle_splatting_tpu_torch.convert import triangle_from_numpy
from triangle_splatting_tpu_torch.trainers import build_trainer, smoke
from triangle_splatting_tpu_torch.trainers.smoke import make_smoke_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

QUICK = "--res 48 --iters 80 --n_tri 120 --views 6 --device cpu".split()


@pytest.mark.parametrize("kw", [dict(), dict(mesh=True), dict(model="gs"),
                                dict(densify=False), dict(model="gs", densify=False)],
                         ids=["ts", "mesh", "gs", "no_densify", "gs_no_densify"])
@pytest.mark.parametrize("iters", [80, 400])
def test_smoke_config_equals_jax(kw, iters):
    assert make_smoke_config("/d", "/o", iters, **kw).to_dict() == \
        j_smoke_config("/d", "/o", iters, **kw).to_dict()


def test_smoke_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="dp"):
        smoke.main(QUICK + ["--dp", "2", "--root", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="dp"):
        smoke.main(QUICK + ["--model", "scaffold", "--dp", "2", "--root", str(tmp_path)])
    with pytest.raises(ValueError, match="mesh"):
        make_smoke_config("/d", "/o", 80, model="gs", mesh=True)
    with pytest.raises(ValueError, match="mesh"):
        make_smoke_config("/d", "/o", 80, model="scaffold", mesh=True)


@pytest.mark.parametrize("model", ["ts", "gs"])
def test_cpu_smoke_densifies_saves_and_climbs(tmp_path, model, capsys):
    """The quick check end to end: densification grows rows, the alive
    count moves by exactly the logged placements, split originals and
    prunings, the PLY and the checkpoint are written at the last
    iteration, and the PSNR climbs by the smoke's 2 dB (main's exit)."""
    argv = QUICK + ["--model", model, "--root", str(tmp_path)]
    trainer, rec = smoke.run(smoke.parse_args(argv))
    dens = trainer.densify_history
    assert [d["iteration"] for d in dens] == [50]
    assert sum(d["grown"] for d in dens) > 0 and sum(d["placed"] for d in dens) > 0
    n0 = 100                                   # the smoke's point cloud (n_tri // 2)
    pruned = sum(n for _, kind, n in trainer.prune_history if kind != "clipping")
    assert [(it, kind) for it, kind, _ in trainer.prune_history] == [(50, "opacity")]
    assert rec["alive_triangles"] == n0 + sum(d["placed"] - d["split_pruned"] for d in dens) \
        - pruned
    out = tmp_path / "out"
    assert (out / "point_cloud" / "80.ply").exists() and (out / "ckpt" / "80.ckpt").exists()
    assert rec["psnr_final"] >= rec["psnr_init"] + 2.0, rec
    # main prints the record and exits 0 only past the gain
    smoke.main(argv)
    assert '"metric": "smoke_overfit"' in capsys.readouterr().out


def test_lockstep_to_the_first_densification_matches_jax(tmp_path):
    """The JAX trainer (dense oracle) and the port's (plain kernel
    versions) from one initialization over the smoke's first 50 steps and
    its densification at 50: the same rows grow but for those within 1e-4
    of the threshold, the grown counts agree, and so do the alive masks
    after the firing."""
    import dataclasses

    import torch
    from triangle_splatting_tpu.trainers.vanilla_ts import VanillaTSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
    from triangle_splatting_tpu_torch.utils.config import dict_to_config
    from triangle_splatting_tpu_torch.utils.testing import build_synthetic_nerf_dataset

    data = build_synthetic_nerf_dataset(tmp_path / "data", res=48, n_tri=120, n_train=6,
                                        n_test=4, pcd_points=100, pcd_noise=0.1, device="cpu")
    iters = 80
    jt = JT(j_dict_to_config(j_smoke_config(data, tmp_path / "j", iters)), impl="oracle",
            log_file=False)
    jt._init_model()
    tt = build_trainer(dict_to_config(make_smoke_config(data, tmp_path / "t", iters).to_dict()),
                       device="cpu", log_file=False)
    leaves = lambda tree: {f.name: None if getattr(tree, f.name) is None  # noqa: E731
                           else np.asarray(getattr(tree, f.name))
                           for f in dataclasses.fields(tree)}
    tt.params, tt.state, tt.opt = triangle_from_numpy(
        leaves(jt.params), leaves(jt.state),
        dict(m=leaves(jt.opt.m), v=leaves(jt.opt.v), step=0), device="cpu")
    d = tt.config.model.model_update.densification
    first = next(it for it in range(1, iters + 1) if tt._fires(d, it))
    assert first == 50
    vj, vt = jt.dataset.getTrainDataset(), tt.dataset.getTrainDataset()
    losses = []
    for it in range(1, first + 1):
        i = (it - 1) % len(vt)
        sched = jt._pack.pack(jt._loss_weights(it), jt._lrs(it), np.ones(3, np.float32), it)
        jt.params, jt.opt, jt.state, jl, _ = jt._train_step(
            jt._settings_for(vj[i]), jt.params, jt.opt, jt.state, vj[i].strip_static(),
            sched, None)
        tt.params, tt.opt, tt.state, tl, _ = tt._train_step(
            tt._settings_for(vt[i]), tt.params, tt.opt, tt.state, vt[i],
            tt._loss_weights(it), tt._lrs(it), torch.ones(3), it)
        losses.append((float(jl), float(tl)))
        if it < first:
            jt._model_update(it)
            tt._model_update(it)
    rel = np.abs(np.diff(np.asarray(losses), axis=1)[:, 0]) / np.asarray(losses)[:, 0]
    assert rel.max() <= 1e-4, rel.max()

    thr = np.float32(tt.grad_threshold_scheduler(first - d.start_iter))

    def grows(acc, den, alive):
        return (den >= d.min_view_count) & (acc > thr * den) & alive
    ja, jd = np.asarray(jt.state.gradient_accum), np.asarray(jt.state.gradient_denom)
    g_j = grows(ja, jd, np.asarray(jt.state.alive))
    g_t = grows(tt.state.gradient_accum.numpy(), tt.state.gradient_denom.numpy(),
                tt.state.alive.numpy())
    for r in np.nonzero(g_j != g_t)[0]:
        assert abs(ja[r] / jd[r] - thr) <= 1e-4 * thr, (r, ja[r] / jd[r], thr)
    alive0 = tt.state.alive.clone()
    jt._model_update(first)
    tt._model_update(first)
    grown = tt.densify_history[0]["grown"]
    assert grown == int(g_j.sum()) > 0
    np.testing.assert_array_equal(tt.state.alive.numpy(), np.asarray(jt.state.alive))
    assert int(tt.state.alive.sum()) - int(alive0.sum()) == \
        tt.densify_history[0]["placed"] - tt.densify_history[0]["split_pruned"] \
        - sum(n for _, _, n in tt.prune_history)
