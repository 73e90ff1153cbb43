"""The port's model facades (``models/facade.py``) against the JAX package's
(``tests/test_model_facade.py``): ``VanillaTSModel``, ``VanillaGSModel`` and
``ScaffoldGSModel`` render the same weights, carried across through
``convert.py`` and through the same PLY / GLB files, into the JAX facade's
keys. Budgets (``tests/test_torch_renderer.py``'s): render and final_T 1e-3
abs, n_contrib exact, depth and normal rel 1e-3 of their max, the
contribution statistics 5e-4 abs. The JAX facades run their Pallas kernels
in interpret mode (Scaffold: its dense oracle, as the JAX facade test)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import triangle_splatting_tpu as jts
import triangle_splatting_tpu_torch as tts
from triangle_splatting_tpu.utils.config import dict_to_config as j_cfg
from triangle_splatting_tpu.utils.testing import make_camera as j_camera
from triangle_splatting_tpu_torch.convert import (gaussian_from_numpy, scaffold_from_numpy,
                                                  triangle_from_numpy)
from triangle_splatting_tpu_torch.ops.cuda import launch_counts
from triangle_splatting_tpu_torch.utils.config import dict_to_config as t_cfg
from triangle_splatting_tpu_torch.utils.testing import make_camera as t_camera
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

W = H = 48
CPU = dict(device="cpu")


def pcd(cls, n=80, seed=0):
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3), np.float32) - 0.5) * 2
    pts[:, 2] += 4.0
    cols = rng.random((n, 3), np.float32)
    nrm = np.tile(np.array([0, 0, 1], np.float32), (n, 1))
    return cls(points=pts, colors=cols, normals=nrm)


def j_pcd(n=80, seed=0):
    from triangle_splatting_tpu.models.point_cloud import PointCloud
    return pcd(PointCloud, n, seed)


def host(out) -> dict:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


def rel(got, want):
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def assert_pkg(t_out, j_out, stats=True):
    """The JAX facade's keys, and its outputs within the stated budgets."""
    t, j = host(t_out), host(j_out)
    assert set(t) == set(j), set(t) ^ set(j)
    np.testing.assert_array_equal(t["n_contrib"], j["n_contrib"])
    np.testing.assert_array_equal(t["radii"], j["radii"])
    for k in ("render", "final_T"):
        assert np.abs(t[k] - j[k]).max() <= 1e-3, k
    for k in ("depth", "normal"):
        assert rel(t[k], j[k]) <= 1e-3, (k, rel(t[k], j[k]))
    if stats:
        for k in ("contrib_sum", "contrib_max"):
            assert np.abs(t[k] - j[k]).max() <= 5e-4, k
        assert t["contrib_sum"].max() > 0.1
    assert t["render"].std() > 0


def tri_numpy(m) -> tuple[dict, dict]:
    p = {f.name: np.asarray(getattr(m.params, f.name))
         for f in dataclasses.fields(m.params) if getattr(m.params, f.name) is not None}
    s = {f.name: np.asarray(getattr(m.state, f.name)) for f in dataclasses.fields(m.state)}
    return p, s


@pytest.fixture(scope="module")
def ts_models():
    """A JAX triangle facade (SH 1, live rest bands) and the port's facade on
    the same arrays through ``convert.triangle_from_numpy``."""
    cfg = {"max_sh_degree": 1}
    jm = jts.VanillaTSModel(j_cfg(cfg), impl="pallas", interpret=True)
    jm.create_from_pcd(j_pcd(), init_opacity=0.4)
    rng = np.random.default_rng(3)
    jm.params = dataclasses.replace(jm.params, f_rest=jnp.asarray(
        0.3 * rng.standard_normal(jm.params.f_rest.shape).astype(np.float32)))
    jm.state = dataclasses.replace(jm.state, active_sh_degree=jnp.int32(1))
    tm = tts.VanillaTSModel(t_cfg(cfg), **CPU)
    tm.params, tm.state = triangle_from_numpy(*tri_numpy(jm), **CPU)[:2]
    return jm, tm


def test_ts_facade_matches_jax_through_convert(ts_models):
    """The triangle facade renders B1's "2D" rich + stats form (the JAX
    ``forward``'s ``need_stats=True`` default, where the port's core
    defaults to False) and returns the JAX keys, on white and on the default
    black background; no kernel launches on the CPU."""
    jm, tm = ts_models
    before = launch_counts()
    for bg in (None, (1.0, 1.0, 1.0)):
        t_out = tm.forward(t_camera(W, H, **CPU), background=bg)
        j_out = jm.forward(j_camera(W, H), background=None if bg is None else jnp.asarray(bg))
        assert_pkg(t_out, j_out)
        assert not t_out["render"].requires_grad
    assert launch_counts() == before


def test_ts_facade_ply_and_glb_files_cross(ts_models, tmp_path):
    """The same PLY read by both facades renders the same; the port's PLY
    and GLB read back by the JAX facade hold the JAX arrays; the GLB at
    gamma 50 renders the same in both (render budget widened by gamma / 5
    past gamma 5: XLA's exp and log differ from torch's by an ulp there)."""
    jm, tm = ts_models
    cfg = {"max_sh_degree": 1}
    jm.savePLY(tmp_path / "j.ply")
    tm.savePLY(tmp_path / "t.ply")
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    j2 = jts.VanillaTSModel(j_cfg(cfg), impl="pallas", interpret=True).loadPLY(tmp_path / "t.ply")
    t2 = tts.VanillaTSModel(t_cfg(cfg), **CPU).loadPLY(tmp_path / "j.ply")
    assert t2.point_count == j2.point_count == jm.point_count
    p_j, s_j = tri_numpy(j2)
    for name, t in (("vertex", t2.params.vertex), ("opacity", t2.params.opacity),
                    ("f_dc", t2.params.f_dc), ("f_rest", t2.params.f_rest)):
        np.testing.assert_array_equal(t.numpy(), p_j[name], err_msg=name)
    np.testing.assert_array_equal(t2.state.alive.numpy(), s_j["alive"])
    assert_pkg(t2.forward(t_camera(W, H, **CPU), (1.0, 1.0, 1.0)),
               j2.forward(j_camera(W, H), jnp.ones(3)))

    cfg0 = {"max_sh_degree": 0}
    tm0 = tts.VanillaTSModel(t_cfg(cfg0), **CPU)
    tm0.state = tm.state
    tm0.params = dataclasses.replace(tm.params, f_rest=tm.params.f_rest[:, :0],
                                     opacity=torch.full_like(tm.params.opacity, 3.0))
    tm0.saveGLB(tmp_path / "t.glb")
    jg = jts.VanillaTSModel(j_cfg(cfg0), impl="pallas", interpret=True).loadGLB(tmp_path / "t.glb")
    tg = tts.VanillaTSModel(t_cfg(cfg0), **CPU).loadGLB(tmp_path / "t.glb")
    assert tg.point_count == jg.point_count > 0
    jg.set_gamma(50.0)
    tg.set_gamma(50.0)
    assert float(tg.state.gamma) == 50.0
    t_out, j_out = host(tg.forward(t_camera(W, H, **CPU))), host(jg.forward(j_camera(W, H)))
    assert set(t_out) == set(j_out)
    np.testing.assert_array_equal(t_out["n_contrib"], j_out["n_contrib"])
    assert np.abs(t_out["render"] - j_out["render"]).max() <= 1e-3 * 10
    assert t_out["render"].std() > 0


def test_loaded_ply_renders_its_dc_band_only_as_jax(ts_models, tmp_path):
    """Pinned: a PLY loaded through either facade starts at
    ``active_sh_degree`` 0 (the JAX ``_from_raw`` keeps
    ``TriangleState.create``'s 0), so a model saved with live rest bands
    renders its DC band only: the same as the source rendered at degree 0,
    not as the source at degree 1."""
    jm, tm = ts_models
    tm.savePLY(tmp_path / "m.ply")
    t2 = tts.VanillaTSModel(t_cfg({"max_sh_degree": 1}), **CPU).loadPLY(tmp_path / "m.ply")
    j2 = jts.VanillaTSModel(j_cfg({"max_sh_degree": 1}), impl="pallas",
                            interpret=True).loadPLY(tmp_path / "m.ply")
    assert int(t2.state.active_sh_degree) == int(j2.state.active_sh_degree) == 0
    np.testing.assert_array_equal(t2.params.f_rest.numpy()[:80], tm.params.f_rest.numpy()[:80])
    cam = t_camera(W, H, **CPU)
    loaded = t2.forward(cam)["render"]
    src1 = tm.forward(cam)["render"]
    src0 = dataclasses.replace(tm.state, active_sh_degree=torch.tensor(0, dtype=torch.int32))
    tm_state, tm.state = tm.state, src0
    try:
        src_dc = tm.forward(cam)["render"]
    finally:
        tm.state = tm_state
    assert torch.equal(loaded, src_dc)
    assert float((loaded - src1).abs().max()) > 1e-3
    assert np.abs(loaded.numpy() - np.asarray(j2.forward(j_camera(W, H))["render"])).max() <= 1e-3


def test_gs_facade_matches_jax_and_f_rest_crosses_channel_major(tmp_path):
    """The Gaussian facade renders B1-GS's rich + stats form with the JAX
    keys on arrays carried by ``convert.gaussian_from_numpy``; a PLY with
    nonzero rest bands written by either facade reads back into the other's
    ``f_rest`` bit for bit (3DGS stores it channel-major), and renders the
    same."""
    cfg = {"max_sh_degree": 2}
    jm = jts.VanillaGSModel(j_cfg(cfg), impl="pallas", interpret=True)
    jm.create_from_pcd(j_pcd(30), init_opacity=0.5)
    rng = np.random.default_rng(5)
    jm.params = dataclasses.replace(jm.params, f_rest=jnp.asarray(
        0.2 * rng.standard_normal(jm.params.f_rest.shape).astype(np.float32)))
    jm.state = dataclasses.replace(jm.state, active_sh_degree=jnp.int32(2))
    tm = tts.VanillaGSModel(t_cfg(cfg), **CPU)
    p, s = tri_numpy(jm)
    tm.params, tm.state = gaussian_from_numpy(p, s, **CPU)[:2]
    cam_t, cam_j = t_camera(32, 32, **CPU), j_camera(32, 32)
    assert_pkg(tm.forward(cam_t, (1.0, 1.0, 1.0)), jm.forward(cam_j, jnp.ones(3)))

    jm.savePLY(tmp_path / "j.ply")
    tm.savePLY(tmp_path / "t.ply")
    t2 = tts.VanillaGSModel(t_cfg(cfg), **CPU).loadPLY(tmp_path / "j.ply")
    j2 = jts.VanillaGSModel(j_cfg(cfg), impl="pallas", interpret=True).loadPLY(tmp_path / "t.ply")
    alive = np.asarray(jm.state.alive)
    np.testing.assert_array_equal(t2.params.f_rest.numpy()[t2.state.alive.numpy()],
                                  np.asarray(jm.params.f_rest)[alive])
    np.testing.assert_array_equal(np.asarray(j2.params.f_rest)[np.asarray(j2.state.alive)],
                                  np.asarray(jm.params.f_rest)[alive])
    assert t2.point_count == j2.point_count == 30
    assert_pkg(t2.forward(cam_t, (1.0, 1.0, 1.0)), j2.forward(cam_j, jnp.ones(3)))


def test_scaffold_facade_matches_jax():
    """The Scaffold facade renders B1-GS's rich form without statistics (the
    JAX Scaffold core's default) with the JAX keys, on the JAX facade's
    anchors and heads carried by ``convert.scaffold_from_numpy``."""
    from triangle_splatting_tpu.models.point_cloud import PointCloud as JPC
    from triangle_splatting_tpu_torch.models.point_cloud import PointCloud as TPC
    cfg = {"feat_dim": 8, "hidden_dim": 16, "n_offsets": 3}
    jm = jts.ScaffoldGSModel(j_cfg(cfg), impl="oracle").create_from_pcd(
        pcd(JPC, 60), voxel_size=0.2)
    tm = tts.ScaffoldGSModel(t_cfg(cfg), **CPU).create_from_pcd(pcd(TPC, 60), voxel_size=0.2)
    assert tm.anchor_count == jm.anchor_count > 0
    np.testing.assert_array_equal(tm.params.anchor.numpy(), np.asarray(jm.params.anchor))

    def tree(x):
        if dataclasses.is_dataclass(x):
            return {f.name: tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        return np.asarray(x)
    tm.params, tm.state = scaffold_from_numpy(tree(jm.params), tree(jm.state), **CPU)[:2]
    t_out = tm.forward(t_camera(32, 32, **CPU), (1.0, 1.0, 1.0))
    j_out = jm.forward(j_camera(32, 32), jnp.ones(3))
    assert_pkg(t_out, j_out, stats=False)
    assert float(t_out["contrib_sum"].abs().max()) == 0.0


def test_facades_default_to_cuda(monkeypatch):
    """Each facade defaults to ``device="cuda"`` and raises without a GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (tts.VanillaTSModel, tts.VanillaGSModel, tts.ScaffoldGSModel):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls()
        assert cls(device="cpu").device.type == "cpu"
