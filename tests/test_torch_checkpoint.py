"""Checkpoints, resumes and the Gaussian PLY of the port against the JAX
package.

- The JAX and the port's ``save_ckpt`` on one state (carried across by
  ``convert``): the JAX blob, converted to arrays by the test (it pickles
  the JAX package's dataclasses), equals the port's blob array for array,
  bit for bit and dtype for dtype; the port's own round trip is bit for
  bit, ``None`` leaves and a zero-size ``f_rest`` (SH degree 0) included;
  the orbax format is refused by name.
- The resume of ``tests/test_trainer_e2e.py``: a JAX and a port trainer
  step in lockstep from one initialization for 15 steps, each writes its
  checkpoint, and a new trainer of each resumes from its own checkpoint
  through ``start_checkpoint`` (the loaded state equal to the saved one
  bit for bit) and steps on to 30 over the restarted camera order; the
  resumed losses agree per step within rel 1e-4 (the one-step budget of
  ``tests/test_torch_trainer.py``, set by SSIM). ``start_pointcloud``
  resumes from a saved PLY. The cadences (``checkpoint_iterations``,
  ``ckpt_interval_iter``) write their files through ``train()``.
- The VanillaGS trainer's PLY (the 3DGS schema) against the JAX trainer's
  bytes, read back both ways, and its checkpoint against the JAX one.
"""

import dataclasses
import pickle
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.models import gaussian_model as JG
from triangle_splatting_tpu.models import raw_gaussian as JRG
from triangle_splatting_tpu_torch.convert import gaussian_from_numpy, triangle_from_numpy
from triangle_splatting_tpu_torch.models import raw_gaussian as TRG
from triangle_splatting_tpu_torch.trainers import build_trainer
from triangle_splatting_tpu_torch.utils import checkpoint as TC
from triangle_splatting_tpu_torch.utils.config import dict_to_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

RES, N_TRI = 48, 120
ITERS, RESUME_AT = 30, 15


def leaves(tree):
    return {f.name: None if getattr(tree, f.name) is None else np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def blob_arrays(blob):
    """A checkpoint blob with every dataclass turned into a dict of field
    name -> array (the JAX blob pickles the JAX package's dataclasses)."""
    if dataclasses.is_dataclass(blob):
        return {f.name: blob_arrays(getattr(blob, f.name)) for f in dataclasses.fields(blob)}
    if isinstance(blob, dict):
        return {k: blob_arrays(v) for k, v in blob.items()}
    return blob


def assert_blobs_equal(want, got, path="blob"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_blobs_equal(want[k], got[k], f"{path}.{k}")
    elif want is None:
        assert got is None, path
    else:
        want, got = np.asarray(want), np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from triangle_splatting_tpu_torch.utils.testing import build_synthetic_nerf_dataset
    return build_synthetic_nerf_dataset(tmp_path_factory.mktemp("ckpt_scene"), res=RES,
                                        n_tri=N_TRI, device="cpu")


def ts_config(root, out_dir, iters=ITERS, sh_degree=1, **trainer):
    return {
        "dataset": {"type": "NerfSynthetic", "local_dir": str(root), "background": "white",
                    "use_alpha_mask": False, "num_workers": 2, "pcd_path": "point_cloud.ply",
                    "hold_test_set": True},
        "model": {
            "max_sh_degree": sh_degree, "rasterizer_type": "2D", "pairs_per_triangle": 8,
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
            "output_dir": str(out_dir), "iterations": iters, "initial_eval": False,
            "log_interval_iter": 10, "eval_interval_iter": 0, "histogram_interval_iter": 0,
            "save_iterations": [], "checkpoint_iterations": [], "train_background": "white",
            "eval_background": "white", "w_ssim": 0.2, "use_tensorboard": False, "seed": 0,
            **trainer,
        },
    }


def jax_trainer(cfg, impl="oracle"):
    from triangle_splatting_tpu.trainers import build_trainer as j_build
    from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
    return j_build(j_dict_to_config(cfg), impl=impl, log_file=False)


def port_twin(jt, cfg):
    """A port trainer holding the JAX trainer's model, moments and step."""
    tt = build_trainer(dict_to_config(cfg), device="cpu", log_file=False)
    conv = triangle_from_numpy if hasattr(jt.params, "vertex") else gaussian_from_numpy
    tt.params, tt.state, tt.opt = conv(
        leaves(jt.params), leaves(jt.state),
        dict(m=leaves(jt.opt.m), v=leaves(jt.opt.v), step=jt.opt.step), device="cpu")
    return tt


# ---------------------------------------------------------------------------
# the format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sh_degree", [0, 1])
def test_checkpoint_blob_equals_jax_and_round_trips(dataset, tmp_path, sh_degree):
    """One state (the JAX init with random moments, a quarter of the rows
    dead, step 9), saved by both trainers: the blobs equal array for
    array. The port's file loads back bit for bit into a new trainer."""
    jt = jax_trainer(ts_config(dataset, tmp_path / "j", sh_degree=sh_degree))
    jt._init_model()
    rng = np.random.default_rng(0)
    rand = lambda tp: dataclasses.replace(tp, **{  # noqa: E731
        k: jnp.asarray(rng.normal(size=np.shape(x)).astype(np.float32))
        for k, x in leaves(tp).items() if x is not None})
    jt.opt = dataclasses.replace(jt.opt, m=rand(jt.opt.m), v=rand(jt.opt.v), step=jnp.int32(9))
    alive = np.asarray(jt.state.alive).copy()
    alive[::4] = False
    jt.state = dataclasses.replace(jt.state, alive=jnp.asarray(alive), gamma=jnp.float32(3.5))
    tt = port_twin(jt, ts_config(dataset, tmp_path / "t", sh_degree=sh_degree))
    jt.save_ckpt(tmp_path / "j.ckpt")
    tt.save_ckpt(tmp_path / "t.ckpt")
    with open(tmp_path / "j.ckpt", "rb") as f:
        want = blob_arrays(pickle.load(f))
    got = TC.load_ckpt(tmp_path / "t.ckpt")
    assert_blobs_equal(want, got)
    assert got["params"]["affine_weight"] is None
    assert got["params"]["f_rest"].shape[1] == (sh_degree + 1) ** 2 - 1

    t2 = build_trainer(dict_to_config(ts_config(dataset, tmp_path / "t2", sh_degree=sh_degree)),
                       device="cpu", log_file=False)
    t2.load_ckpt(tmp_path / "t.ckpt")
    t2.save_ckpt(tmp_path / "t2.ckpt")
    assert_blobs_equal(got, TC.load_ckpt(tmp_path / "t2.ckpt"))
    assert t2.opt.step == 9 and t2.params.affine_weight is None


def test_orbax_is_refused_by_name(dataset, tmp_path):
    with pytest.raises(NotImplementedError, match="orbax"):
        TC.save_ckpt(tmp_path / "x.ckpt", {"params": {}}, fmt="orbax")
    with open(tmp_path / "o.ckpt", "wb") as f:
        pickle.dump({"__orbax__": True, "treedef": None, "empty": {}}, f)
    with pytest.raises(NotImplementedError, match="orbax"):
        TC.load_ckpt(tmp_path / "o.ckpt")
    for kind in ("VanillaTS", "VanillaGS"):
        cfg = ts_config(dataset, tmp_path / kind, ckpt_format="orbax", type=kind)
        with pytest.raises(NotImplementedError, match="orbax"):
            build_trainer(dict_to_config(cfg), device="cpu", log_file=False)


# ---------------------------------------------------------------------------
# resumes
# ---------------------------------------------------------------------------

def lockstep(jt, tt, first, last, views_j, views_t):
    """Steps first..last of both trainers over the same views in order
    (from the first view), each followed by its model update. Returns the
    (2, n) losses."""
    out = []
    for k, it in enumerate(range(first, last + 1)):
        i = k % len(views_t)
        sched = jt._pack.pack(jt._loss_weights(it), jt._lrs(it), np.ones(3, np.float32), it)
        jt.params, jt.opt, jt.state, jl, _ = jt._train_step(
            jt._settings_for(views_j[i]), jt.params, jt.opt, jt.state,
            views_j[i].strip_static(), sched, None)
        tt.params, tt.opt, tt.state, tl, _ = tt._train_step(
            tt._settings_for(views_t[i]), tt.params, tt.opt, tt.state, views_t[i],
            tt._loss_weights(it), tt._lrs(it), torch.ones(3), it)
        jt._model_update(it)
        tt._model_update(it)
        out.append((float(jl), float(tl)))
    return np.asarray(out).T


def test_resume_from_checkpoint_follows_jax(dataset, tmp_path):
    """start_checkpoint: iterations numbered on from 15, Adam moments and
    step, alive mask, SH degree restored bit for bit; the resumed JAX and
    port runs agree per step (they restart the camera order, as the JAX
    trainer's resume does)."""
    cfg_j = ts_config(dataset, tmp_path / "j")
    cfg_t = ts_config(dataset, tmp_path / "t")
    jt = jax_trainer(cfg_j)
    jt._init_model()
    tt = port_twin(jt, cfg_t)
    vj, vt = jt.dataset.getTrainDataset(), tt.dataset.getTrainDataset()
    losses = lockstep(jt, tt, 1, RESUME_AT, vj, vt)
    jt.save_ckpt(tmp_path / "j" / "ckpt" / f"{RESUME_AT}.ckpt")
    tt.save_ckpt(tmp_path / "t" / "ckpt" / f"{RESUME_AT}.ckpt")
    saved = TC.load_ckpt(tmp_path / "t" / "ckpt" / f"{RESUME_AT}.ckpt")

    j2 = jax_trainer(dict(cfg_j, trainer=dict(cfg_j["trainer"], start_checkpoint=RESUME_AT)))
    t2 = build_trainer(dict_to_config(dict(cfg_t, trainer=dict(
        cfg_t["trainer"], start_checkpoint=RESUME_AT))), device="cpu", log_file=False)
    assert j2._init_model() == t2._init_model() == RESUME_AT
    for name, x in leaves(tt.params).items():
        if x is not None:
            assert torch.equal(getattr(t2.params, name), getattr(tt.params, name)), name
            assert torch.equal(getattr(t2.opt.m, name), getattr(tt.opt.m, name)), name
            assert torch.equal(getattr(t2.opt.v, name), getattr(tt.opt.v, name)), name
    for name in leaves(tt.state):
        assert torch.equal(getattr(t2.state, name), getattr(tt.state, name)), name
    assert t2.opt.step == tt.opt.step == RESUME_AT and int(t2.state.active_sh_degree) == 1
    assert_blobs_equal(saved["state"], {k: x.numpy() for k, x in vars(t2.state).items()})

    resumed = lockstep(j2, t2, RESUME_AT + 1, ITERS, vj, vt)
    for ls in (losses, resumed):
        rel = np.abs(ls[1] - ls[0]) / ls[0]
        assert rel.max() <= 1e-4, rel
    assert t2.opt.step == ITERS and int(j2.opt.step) == ITERS


def test_resume_through_train_and_the_checkpoint_cadence(dataset, tmp_path):
    """checkpoint_iterations and ckpt_interval_iter write through train();
    a run restarted with start_checkpoint trains only the steps after it
    (the JAX test_resume_from_checkpoint: it lands in the uninterrupted
    run's quality range)."""
    cfg = ts_config(dataset, tmp_path / "out", checkpoint_iterations=[15], ckpt_interval_iter=20,
                    save_iterations=[ITERS])
    t1 = build_trainer(dict_to_config(cfg), device="cpu", log_file=False)
    t1.train()
    ckpts = sorted(p.name for p in (tmp_path / "out" / "ckpt").iterdir())
    assert ckpts == ["15.ckpt", "20.ckpt"]
    psnr_full = t1._evaluate(ITERS)
    cfg["trainer"]["start_checkpoint"] = 15
    t2 = build_trainer(dict_to_config(cfg), device="cpu", log_file=False)
    t2.train()
    assert len(t2.loss_history) == ITERS - 15
    psnr_resumed = t2._evaluate(ITERS + 1)
    assert np.isfinite(psnr_resumed) and psnr_resumed > psnr_full - 2.0


def test_resume_from_pointcloud(dataset, tmp_path):
    """start_pointcloud reloads the PLY saved at 10 (fresh moments, the
    JAX trainer's loadPLY of that file) and trains steps 11..20."""
    from triangle_splatting_tpu.trainers.vanilla_ts import VanillaTSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
    cfg = ts_config(dataset, tmp_path / "out", iters=20, save_iterations=[10, 20])
    t1 = build_trainer(dict_to_config(cfg), device="cpu", log_file=False)
    t1.train()
    cfg["trainer"]["start_pointcloud"] = 10
    t2 = build_trainer(dict_to_config(cfg), device="cpu", log_file=False)
    assert t2._init_model() == 10
    jt = JT(j_dict_to_config(cfg), impl="oracle", log_file=False)
    jt.loadPLY(tmp_path / "out" / "point_cloud" / "10.ply")
    for name, x in leaves(jt.params).items():
        if x is not None:
            np.testing.assert_array_equal(getattr(t2.params, name).numpy(), x, err_msg=name)
    np.testing.assert_array_equal(t2.state.alive.numpy(), np.asarray(jt.state.alive))
    assert t2.opt.step == 0
    t2.train()
    assert len(t2.loss_history) == 10
    assert np.isfinite(t2._evaluate(21))
    assert int(t2.state.alive.sum()) == int(t1.state.alive.sum())


# ---------------------------------------------------------------------------
# the Gaussian trainer's PLY and checkpoint
# ---------------------------------------------------------------------------

def gs_twins(dataset, tmp_path, **trainer):
    from triangle_splatting_tpu.trainers.vanilla_gs import VanillaGSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
    cfg = ts_config(dataset, tmp_path / "j", type="VanillaGS", **trainer)
    cfg["model"]["max_sh_degree"] = 2
    cfg["model"]["optimizer"] = {n: {"v_init": 1e-3, "v_final": 1e-3, "max_steps": ITERS}
                                 for n in JG.GS_PARAM_GROUPS}
    jt = JT(j_dict_to_config(cfg), impl="oracle", log_file=False)
    jt._init_model()
    rng = np.random.default_rng(2)
    jt.params = dataclasses.replace(
        jt.params, rotation=jnp.asarray(rng.normal(size=jt.params.rotation.shape), jnp.float32),
        f_rest=jnp.asarray(rng.normal(size=jt.params.f_rest.shape), jnp.float32))
    alive = np.asarray(jt.state.alive).copy()
    alive[1::3] = False
    jt.state = dataclasses.replace(jt.state, alive=jnp.asarray(alive))
    tcfg = dict(cfg, trainer=dict(cfg["trainer"], output_dir=str(tmp_path / "t")))
    return jt, port_twin(jt, tcfg), tcfg


def test_gaussian_ply_bytes_equal_jax_and_read_back(dataset, tmp_path):
    jt, tt, _ = gs_twins(dataset, tmp_path)
    jt.savePLY(tmp_path / "j.ply")
    tt.savePLY(tmp_path / "t.ply")
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    tt.loadPLY(tmp_path / "j.ply")
    jt.loadPLY(tmp_path / "t.ply")
    for name, x in leaves(jt.params).items():
        np.testing.assert_array_equal(getattr(tt.params, name).numpy(), x, err_msg=name)
    np.testing.assert_array_equal(tt.state.alive.numpy(), np.asarray(jt.state.alive))
    g = TRG.RawGaussian(ply_path=str(tmp_path / "t.ply"))
    K = 9
    np.testing.assert_array_equal(TRG.unpack_sh_features(g.shs, K),
                                  JRG.unpack_sh_features(g.shs, K))
    np.testing.assert_array_equal(TRG.pack_sh_features(TRG.unpack_sh_features(g.shs, K)), g.shs)
    np.testing.assert_array_equal(TRG.morton_order(g.xyz), JRG.morton_order(g.xyz))


def test_gaussian_checkpoint_equals_jax_and_saves_through_train(dataset, tmp_path):
    """The VanillaGS blob equals the JAX trainer's; save_iterations and
    checkpoint_iterations write through train() and the files hold the
    final model, while save_interval_iter and ckpt_interval_iter are left
    unread as the JAX VanillaGS trainer leaves them; a run resumed from
    step 2 trains steps 3 and 4."""
    jt, tt, tcfg = gs_twins(dataset, tmp_path)
    jt.save_ckpt(tmp_path / "j.ckpt")
    tt.save_ckpt(tmp_path / "t.ckpt")
    with open(tmp_path / "j.ckpt", "rb") as f:
        assert_blobs_equal(blob_arrays(pickle.load(f)), TC.load_ckpt(tmp_path / "t.ckpt"))

    tcfg["trainer"].update(iterations=4, save_iterations=[4], checkpoint_iterations=[2, 4],
                           save_interval_iter=3, ckpt_interval_iter=3)
    t2 = build_trainer(dict_to_config(tcfg), device="cpu", log_file=False)
    t2.train()
    out = Path(t2.output_dir)
    assert sorted(p.name for p in (out / "ckpt").iterdir()) == ["2.ckpt", "4.ckpt"]
    assert sorted(p.name for p in (out / "point_cloud").iterdir()) == ["4.ply"]
    t3 = build_trainer(dict_to_config(tcfg), device="cpu", log_file=False)
    t3.load_ckpt(out / "ckpt" / "4.ckpt")
    for name in JG.GS_PARAM_GROUPS:
        assert torch.equal(getattr(t3.params, name), getattr(t2.params, name)), name
    t3.loadPLY(out / "point_cloud" / "4.ply")
    assert int(t3.state.alive.sum()) == int(t2.state.alive.sum())
    np.testing.assert_array_equal(t3.params.xyz[t3.state.alive].numpy(),
                                  t2.params.xyz[t2.state.alive].numpy())
    # start_checkpoint, served as the VanillaTS trainer serves it (the JAX
    # VanillaGS trainer does not read the key; the slice asks for it)
    tcfg["trainer"]["start_checkpoint"] = 2
    t4 = build_trainer(dict_to_config(tcfg), device="cpu", log_file=False)
    t4.train()
    assert len(t4.loss_history) == 2 and t4.opt.step == 4
