"""Port foundations vs the JAX package on the same numpy inputs: camera
matrices, SH evaluation, the 2D preprocess, losses, schedules and config;
plus import hygiene (the port pulls in no JAX) and the device rule (entry
points run on CUDA unless asked for the CPU, and raise without a GPU)."""

import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.ops import sh as j_sh
from triangle_splatting_tpu.ops.projection import RasterSettings as JRS
from triangle_splatting_tpu.ops.projection import preprocess_2d as j_pre
from triangle_splatting_tpu.trainers import losses as j_losses
from triangle_splatting_tpu.utils import scheduler as j_sched
from triangle_splatting_tpu.utils.camera import Camera as JCamera
from triangle_splatting_tpu.utils.testing import make_random_scene
from triangle_splatting_tpu_torch.ops import sh as t_sh
from triangle_splatting_tpu_torch.ops.projection import RasterSettings as TRS
from triangle_splatting_tpu_torch.ops.projection import preprocess_2d as t_pre
from triangle_splatting_tpu_torch.trainers import losses as t_losses
from triangle_splatting_tpu_torch.utils import scheduler as t_sched
from triangle_splatting_tpu_torch.utils.camera import Camera as TCamera
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]


def orbit_pose(theta):
    """A non-trivial camera (R, T) looking at the random scene's center
    (0, 0, 4.5) from radius 4."""
    center = np.array([0.0, 0.0, 4.5])
    eye = center + np.array([-4 * np.sin(theta), 0.7, -4 * np.cos(theta)])
    fwd = (center - eye) / np.linalg.norm(center - eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, -up, fwd, eye
    w2c = np.linalg.inv(c2w)
    return w2c[:3, :3].T, w2c[:3, 3]


def both_cameras(W=64, H=48, theta=0.4):
    R, T = orbit_pose(theta)
    kw = dict(R=R, T=T, fovx=math.radians(55), image_width=W, image_height=H)
    return JCamera.create(**kw), TCamera.create(**kw, device="cpu")


def test_camera_matrices_identical():
    jc, tc = both_cameras()
    for name in ("world_view", "full_proj", "camera_center", "tan_fovx", "tan_fovy"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), err_msg=name)
    assert tc.tan_fovx.dtype == torch.float32


@pytest.mark.parametrize("active", [0, 1, 2, 3])
def test_eval_sh_matches_jax(active):
    rng = np.random.default_rng(active)
    P = 257
    sh = rng.normal(size=(P, 16, 3)).astype(np.float32) * 0.3
    pos = rng.normal(size=(P, 3)).astype(np.float32)
    campos = np.array([0.3, -0.2, -4.0], np.float32)
    want = np.asarray(j_sh.eval_sh(jnp.asarray(sh), jnp.asarray(pos),
                                   jnp.asarray(campos), active, 3))
    got = t_sh.eval_sh(torch.as_tensor(sh), torch.as_tensor(pos),
                       torch.as_tensor(campos), torch.tensor(active), 3).numpy()
    # same f32 arithmetic, summed in another order: a few ulp
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(t_sh.band_mask(active, 3).numpy(),
                                  np.asarray(j_sh.band_mask(active, 3)))
    assert t_sh.RGB2SH(0.75) == j_sh.RGB2SH(0.75) and t_sh.SH_C0 == j_sh.SH_C0


@pytest.mark.parametrize("gamma,back", [(1.0, False), (2.5, True)])
def test_preprocess_2d_matches_jax(gamma, back):
    P = 400
    s = make_random_scene(P, seed=3)
    s["vertex"][:20] = 0.0                    # dead zero triangles
    jc, tc = both_cameras()
    alive = np.arange(P) % 7 != 0
    kw = dict(image_width=64, image_height=48, back_culling=back)
    want = j_pre(jnp.asarray(s["vertex"]), jnp.zeros((P, 2)), jnp.asarray(s["rgb"]),
                 jc.world_view, jc.full_proj, jc.tan_fovx, jc.tan_fovy, JRS(**kw),
                 alive_mask=jnp.asarray(alive), opacity=jnp.asarray(s["opacity"]),
                 gamma=jnp.float32(gamma))
    got = t_pre(torch.as_tensor(s["vertex"]), torch.zeros((P, 2)),
                torch.as_tensor(s["rgb"]), tc.world_view, tc.full_proj,
                tc.tan_fovx, tc.tan_fovy, TRS(**kw), alive_mask=torch.as_tensor(alive),
                opacity=torch.as_tensor(s["opacity"]), gamma=torch.tensor(gamma))
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > P // 3
    for f in dataclasses.fields(got):
        w = np.asarray(getattr(want, f.name))[valid]
        g = getattr(got, f.name).numpy()[valid]
        if w.dtype.kind in "iub":
            # integer tile rects / counts / radii: exact
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            # XLA may contract a*b+c into one FMA, so the two differ by
            # ulps; the centroid-relative vectors (vertex - center, sizes
            # ~0.05-0.25 at depth ~5) amplify them ~100x: 5e-5 absolute
            # plus 1e-6 of the field's scale (pixel coordinates up to ~1e2)
            scale = float(np.abs(w).max())
            assert float(np.abs(g - w).max()) <= 5e-5 + 1e-6 * scale, f.name


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(3, 40, 52)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    mask = (rng.uniform(size=(1, 40, 52)) > 0.3).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    # float32 convolution (conv2d vs separable shifts): a few ulp
    assert abs(float(t_losses.ssim(ta, tb)) - float(j_losses.ssim(ja, jb))) <= 2e-6
    assert abs(float(t_losses.l1(ta, tb)) - float(j_losses.l1(ja, jb))) <= 1e-7
    assert abs(float(t_losses.psnr(ta, tb, torch.as_tensor(mask)))
               - float(j_losses.psnr(ja, jb, jnp.asarray(mask)))) <= 1e-4


def test_schedulers_match_jax():
    kw = dict(v_init=0.025, v_final=0.001, max_steps=30000, delay_steps=2000,
              delay_mult=0.1)
    tf, jf = t_sched.exponential_scheduler(**kw), j_sched.exponential_scheduler(**kw)
    for it in (0, 1, 17, 1999, 2000, 15000, 29999, 30000, 40000):
        assert tf(it) == jf(it)
    ts = t_sched.exponential_step_scheduler(1.0, 50.0, 1000, n_stage=5)
    js = j_sched.exponential_step_scheduler(1.0, 50.0, 1000, n_stage=5)
    assert [ts(i) for i in range(0, 1100, 50)] == [js(i) for i in range(0, 1100, 50)]


def test_config_loads_the_photo_config():
    from triangle_splatting_tpu.utils.config import loadConfig as j_load
    from triangle_splatting_tpu_torch.utils.config import config_to_dict, loadConfig
    path = REPO / "config" / "NerfSynthetic_VanillaTS.yaml"
    cfg = loadConfig(path)
    assert config_to_dict(cfg) == j_load(path).to_dict()
    assert cfg.model.pairs_per_triangle == 8 and cfg.trainer.w_ssim == 0.2
    assert cfg.model.model_update.statistic is None


def test_port_imports_no_jax():
    """Importing every module of the port pulls in no ``jax`` and no module
    of the JAX package (a prefix test would also match the port's own
    name, so names are compared exactly)."""
    code = r"""
import importlib, pkgutil, sys
import triangle_splatting_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = [n for n in sys.modules
       if n in ("jax", "jaxlib", "triangle_splatting_tpu")
       or n.startswith(("jax.", "jaxlib.", "triangle_splatting_tpu."))]
assert not bad, bad
print(len([n for n in sys.modules if n.startswith("triangle_splatting_tpu_torch")]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def test_chip_smoke_imports_no_jax():
    src = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in src and "triangle_splatting_tpu." not in src.replace(
        "triangle_splatting_tpu_torch", "").replace("triangle_splatting_tpu/", "")


def test_entry_points_default_to_cuda_and_raise_without_gpu(monkeypatch):
    """Every entry point defaults to device='cuda'; without a GPU it raises
    (forced here even on a machine with one), and only device='cpu' runs."""
    from triangle_splatting_tpu_torch.convert import triangle_from_numpy
    from triangle_splatting_tpu_torch.models.triangle import ModelConfig, create_from_points
    from triangle_splatting_tpu_torch.trainers import build_trainer
    from triangle_splatting_tpu_torch.utils.config import dict_to_config
    from triangle_splatting_tpu_torch.utils.testing import make_camera
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    calls = [
        lambda: make_camera(32, 32),
        lambda: create_from_points(pts, np.full((8, 3), 0.5, np.float32), None,
                                   ModelConfig()),
        lambda: triangle_from_numpy({}, {}),
        lambda: build_trainer(dict_to_config({"trainer": {}, "dataset": {}})),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert make_camera(32, 32, device="cpu").device.type == "cpu"
