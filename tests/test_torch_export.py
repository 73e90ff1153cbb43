"""GLB / PLY export of the port vs the JAX package: ``utils/gltf.py`` and
``models/raw_triangle.py`` write the same bytes as the JAX writers for the
same arrays, and each package reads the other's files; the VanillaTS
trainer's ``toRawTriangle`` / ``savePLY`` / ``saveGLB`` / ``loadPLY`` give
the JAX trainer's files and arrays on the same state; the saves fire at
``save_iterations`` / ``save_interval_iter`` / ``save_glb_iterations``
(checkpoints and resumes: ``tests/test_torch_checkpoint.py``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from triangle_splatting_tpu.models.raw_triangle import RawTriangle as JRaw
from triangle_splatting_tpu.utils import gltf as jgltf
from triangle_splatting_tpu_torch.convert import triangle_from_numpy
from triangle_splatting_tpu_torch.models.raw_triangle import RawTriangle as TRaw
from triangle_splatting_tpu_torch.trainers import build_trainer
from triangle_splatting_tpu_torch.utils import gltf as tgltf
from triangle_splatting_tpu_torch.utils.config import dict_to_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

RES, N_TRI = 48, 120


def raw_arrays(n=50, k=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3, 3)).astype(np.float32),
            rng.normal(size=(n, 1)).astype(np.float32),
            rng.normal(size=(n, 3 * k)).astype(np.float32) * 0.5)


def same_raw(a, b):
    for name in ("vertex", "opacity", "shs"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


# ---------------------------------------------------------------------------
# gltf / RawTriangle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("colors", [True, False])
def test_write_glb_bytes_equal_jax(tmp_path, colors):
    rng = np.random.default_rng(1)
    v = rng.normal(size=(30, 3)).astype(np.float32)
    f = rng.integers(0, 30, size=(17, 3))
    c = rng.uniform(size=(30, 4)).astype(np.float32) if colors else None
    jgltf.write_glb(tmp_path / "j.glb", v, f, c)
    tgltf.write_glb(tmp_path / "t.glb", v, f, c)
    assert (tmp_path / "t.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()
    for want, got in zip(jgltf.read_glb(tmp_path / "j.glb"), tgltf.read_glb(tmp_path / "j.glb")):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("save_extra", [True, False])
def test_raw_triangle_ply_bytes_and_cross_read(tmp_path, save_extra):
    v, o, s = raw_arrays()
    JRaw(v, o, s).savePLY(tmp_path / "j.ply", save_extra=save_extra)
    TRaw(v, o, s).savePLY(tmp_path / "t.ply", save_extra=save_extra)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    same_raw(TRaw(ply_path=tmp_path / "j.ply"), JRaw(ply_path=tmp_path / "t.ply"))
    back = TRaw(ply_path=tmp_path / "t.ply")
    np.testing.assert_array_equal(back.vertex, v)
    np.testing.assert_array_equal(back.shs, s if save_extra else s[:, :3])


@pytest.mark.parametrize("save_back", [True, False])
def test_raw_triangle_glb_bytes_and_cross_read(tmp_path, save_back):
    v, o, s = raw_arrays(seed=2)
    JRaw(v, o, s).saveGLB(tmp_path / "j.glb", save_back=save_back)
    TRaw(v, o, s).saveGLB(tmp_path / "t.glb", save_back=save_back)
    assert (tmp_path / "t.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()
    same_raw(TRaw(glb_path=tmp_path / "j.glb"), JRaw(glb_path=tmp_path / "t.glb"))
    back = TRaw(glb_path=tmp_path / "t.glb")
    np.testing.assert_array_equal(back.vertex, v)
    # the GLB keeps the DC color (clipped to [0, 1]) and the opacity
    # through a float32 sigmoid and its inverse
    np.testing.assert_allclose(back.opacity, o, atol=1e-3)


def test_raw_triangle_empty_and_arithmetic(tmp_path):
    v, o, s = raw_arrays(n=40, seed=3)
    TRaw().savePLY(tmp_path / "empty.ply")
    assert not (tmp_path / "empty.ply").exists()
    TRaw().savePLY(tmp_path / "empty.ply", save_empty=True)
    JRaw().savePLY(tmp_path / "jempty.ply", save_empty=True)
    assert (tmp_path / "empty.ply").read_bytes() == (tmp_path / "jempty.ply").read_bytes()
    t, j = TRaw(v[:30], o[:30], s[:30]), JRaw(v[:30], o[:30], s[:30])
    t += TRaw(v[30:], o[30:], s[30:])
    j += JRaw(v[30:], o[30:], s[30:])
    same_raw(t, j)
    assert len(t) == 40
    t -= TRaw(v[5:15], o[5:15], s[5:15])
    j -= JRaw(v[5:15], o[5:15], s[5:15])
    same_raw(t, j)
    assert len(t) == 30


# ---------------------------------------------------------------------------
# the trainer's export
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from triangle_splatting_tpu_torch.utils.testing import build_synthetic_nerf_dataset
    return build_synthetic_nerf_dataset(tmp_path_factory.mktemp("export_scene"),
                                        res=RES, n_tri=N_TRI, device="cpu")


def make_config(root, out_dir, iters=4, ste=None, back_culling=False, trainer=None):
    cfg = {
        "dataset": {"type": "NerfSynthetic", "local_dir": str(root),
                    "background": "white", "use_alpha_mask": False,
                    "num_workers": 2, "pcd_path": "point_cloud.ply",
                    "hold_test_set": True},
        "model": {
            "max_sh_degree": 1, "rasterizer_type": "2D", "pairs_per_triangle": 8,
            "ste_threshold": ste, "back_culling": back_culling,
            "sampling": {"sample_method": "direct", "init_opacity": 0.3},
            "optimizer": {
                "vertex": {"v_init": 0.002, "v_final": 0.0005, "max_steps": iters},
                "opacity": {"v_init": 0.05, "v_final": 0.05, "max_steps": iters},
                "f_dc": {"v_init": 0.02, "v_final": 0.01, "max_steps": iters},
                "f_rest": {"v_init": 0.001, "v_final": 0.001, "max_steps": iters},
            },
            "model_update": {"sh_schedule": {"one_up_iters": [1]}},
        },
        "trainer": {
            "output_dir": str(out_dir), "iterations": iters,
            "initial_eval": False, "log_interval_iter": 10,
            "eval_interval_iter": 0, "histogram_interval_iter": 0,
            "save_iterations": [], "checkpoint_iterations": [],
            "train_background": "white", "eval_background": "white",
            "w_ssim": 0.2, "use_tensorboard": False, "seed": 0,
            **(trainer or {}),
        },
    }
    return cfg


def leaves(tree):
    return {f.name: None if getattr(tree, f.name) is None else np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def twin_trainers(dataset, tmp_path, ste, back_culling, bbox):
    """A JAX and a port trainer on one state: the JAX init with random
    opacities carried across, a quarter of the rows dead, the same scene
    bounding box."""
    from triangle_splatting_tpu.trainers.vanilla_ts import VanillaTSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
    jt = JT(j_dict_to_config(make_config(dataset, tmp_path / "j", ste=ste,
                                         back_culling=back_culling)),
            impl="oracle", log_file=False)
    jt._init_model()
    logits = np.random.default_rng(4).normal(size=jt.params.opacity.shape).astype(np.float32)
    jt.params = dataclasses.replace(jt.params, opacity=jnp.asarray(logits))
    alive = np.asarray(jt.state.alive).copy()
    alive[::4] = False
    jt.state = dataclasses.replace(jt.state, alive=jnp.asarray(alive))
    tt = build_trainer(dict_to_config(make_config(dataset, tmp_path / "t", ste=ste,
                                                  back_culling=back_culling)),
                       device="cpu", log_file=False)
    tt.params, tt.state, tt.opt = triangle_from_numpy(
        leaves(jt.params), leaves(jt.state), dict(m=leaves(jt.opt.m), v=leaves(jt.opt.v), step=0),
        device="cpu")
    jt.scene_bbox = tt.scene_bbox = bbox
    return jt, tt


@pytest.mark.parametrize("ste,back_culling,bbox", [
    (None, False, None),
    (0.3, False, [-0.5, -0.5, -0.5, 0.5, 0.5, 0.5]),
    (0.3, True, [-0.6, -0.4, 0.4, 0.6]),          # a 2D (x, y) box
])
def test_trainer_export_matches_jax(dataset, tmp_path, ste, back_culling, bbox):
    jt, tt = twin_trainers(dataset, tmp_path, ste, back_culling, bbox)
    jraw, traw = jt.toRawTriangle(), tt.toRawTriangle()
    same_raw(traw, jraw)
    n_alive = int(tt.state.alive.sum())
    assert 0 < len(traw) <= n_alive
    if bbox is not None:
        assert len(traw) < n_alive                   # the box and the STE cut rows
    if ste is not None:
        assert (traw.opacity == 10.0).all()
    jt.savePLY(tmp_path / "j.ply")
    tt.savePLY(tmp_path / "t.ply")
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    jt.saveGLB(tmp_path / "j.glb")
    tt.saveGLB(tmp_path / "t.glb")
    assert (tmp_path / "t.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()
    faces = TRaw(glb_path=tmp_path / "t.glb")
    assert len(faces) == len(traw)
    # loadPLY: the same model on both sides, the JAX file read by the port
    jt.loadPLY(str(tmp_path / "t.ply"))
    tt.loadPLY(str(tmp_path / "j.ply"))
    for name, want in leaves(jt.params).items():
        if want is not None:
            np.testing.assert_array_equal(getattr(tt.params, name).numpy(), want, err_msg=name)
    np.testing.assert_array_equal(tt.state.alive.numpy(), np.asarray(jt.state.alive))
    assert tt.params.capacity % 256 == 0 and int(tt.state.alive.sum()) == len(traw)
    assert tt.opt.step == 0 and not tt.opt.m.vertex.any()


def test_trainer_saves_at_their_iterations(dataset, tmp_path):
    """save_iterations, save_interval_iter and save_glb_iterations are no
    longer refused: the run writes its PLYs and GLB at those steps, and
    the last ones hold the trained model."""
    from pathlib import Path
    cfg = make_config(dataset, tmp_path / "out", iters=4, trainer={
        "save_iterations": [1], "save_interval_iter": 2, "save_glb_iterations": [4]})
    tt = build_trainer(dict_to_config(cfg), device="cpu", log_file=False)
    tt.train()
    out = Path(tt.output_dir)
    assert sorted(p.name for p in (out / "point_cloud").iterdir()) == ["1.ply", "2.ply", "4.ply"]
    assert [p.name for p in (out / "glb").iterdir()] == ["4.glb"]
    raw = tt.toRawTriangle()
    tt.toRawTriangle().savePLY(tmp_path / "now.ply", save_extra=True)
    assert (out / "point_cloud" / "4.ply").read_bytes() == (tmp_path / "now.ply").read_bytes()
    glb = TRaw(glb_path=out / "glb" / "4.glb")
    np.testing.assert_array_equal(glb.vertex, raw.vertex)
    assert (out / "point_cloud" / "1.ply").read_bytes() != (tmp_path / "now.ply").read_bytes()
