"""The mesh tools of the port against the JAX package: the blocked exact
kNN (``ops/knn.py``), the independent ray tracer (``ops/raytrace.py``) and
the chamfer / F-score metrics (``models/mesh_metrics.py``) on the same
numpy inputs, then the port's twin of the surface-solidify end to end of
``tests/test_synthetic_gt.py`` (the ``full_run --mesh --scene surface``
path at 48x48).

Tolerances: kNN indices equal and squared distances within 1e-6; the ray
tracer's render within 1e-5 (its depth within 1e-5 relative, the hit mask
equal); the metrics' counts equal and their means within 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.models import mesh_metrics as JMM
from triangle_splatting_tpu.ops import knn as JK
from triangle_splatting_tpu.ops.projection import RasterSettings as JSettings
from triangle_splatting_tpu.ops.raytrace import raytrace_soup as j_trace
from triangle_splatting_tpu.utils.testing import make_camera as j_camera
from triangle_splatting_tpu.utils.testing import make_random_scene
from triangle_splatting_tpu_torch.models import mesh_metrics as TMM
from triangle_splatting_tpu_torch.ops import knn as TK
from triangle_splatting_tpu_torch.ops.projection import RasterSettings
from triangle_splatting_tpu_torch.ops.raytrace import raytrace_soup as t_trace
from triangle_splatting_tpu_torch.utils.testing import make_camera as t_camera
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def assert_knn_equal(j, t):
    jd, ji = (np.asarray(x) for x in j)
    td, ti = (x.numpy() for x in t)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# kNN (tests/test_knn.py's cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,block", [(37, 8), (300, 64), (1000, 256)])
def test_knn_matches_jax(n, block):
    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    assert_knn_equal(JK.knn(pts, k=3, block=block),
                     TK.knn(pts, k=3, block=block, device="cpu"))


def test_knn_block_size_does_not_change_the_answer():
    """Ties go to the lower index whatever the tiling: a lattice (every
    neighbor distance tied) at three block sizes."""
    g = np.arange(6, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    want = JK.knn(pts, k=4, block=64)
    for block in (8, 32, 1024):
        assert_knn_equal(want, TK.knn(pts, k=4, block=block, device="cpu"))


def test_knn_valid_mask_and_distances_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    valid = np.arange(64) < 40
    j = JK.knn(pts, valid, k=3, block=32)
    t = TK.knn(pts, valid, k=3, block=32, device="cpu")
    assert_knn_equal(j, t)
    assert (t[1][:40] < 40).all()
    pts2 = rng.normal(size=(513, 3)).astype(np.float32)
    np.testing.assert_allclose(TK.inter_point_distance(pts2, block=128, device="cpu").numpy(),
                               np.asarray(JK.inter_point_distance(pts2, block=128)),
                               rtol=1e-6, atol=0)


def test_nearest_neighbor_group_exclusion_matches_jax():
    pts = np.random.default_rng(2).normal(size=(90, 3)).astype(np.float32)   # 30 triangles
    j = np.asarray(JK.nearest_neighbor(pts, 3, block=32))
    t = TK.nearest_neighbor(pts, 3, block=32, device="cpu").numpy()
    np.testing.assert_array_equal(t, j)
    groups = np.arange(90) // 3
    assert (groups[t] != groups).all()


def test_knn_fewer_than_k_targets_matches_jax():
    pts = np.zeros((3, 3), np.float32)
    pts[1] = [1, 0, 0]
    assert_knn_equal(JK.knn(pts[:2], k=3, block=8), TK.knn(pts[:2], k=3, block=8, device="cpu"))
    d2, idx = TK.knn(pts[:2], k=3, block=8, device="cpu")
    assert torch.isinf(d2[:, 1:]).all() and (idx[:, 1:] == -1).all()
    np.testing.assert_allclose(TK.mean_sq_dist(pts[:2], device="cpu").numpy(),
                               np.asarray(JK.mean_sq_dist(pts[:2])), rtol=1e-6)


# ---------------------------------------------------------------------------
# ray tracer (tests/test_raytrace.py's scenes)
# ---------------------------------------------------------------------------

def trace_both(tri, rgb, W, background=None, **kw):
    jcam, tcam = j_camera(W, W, **kw), t_camera(W, W, device="cpu", **kw)
    j = j_trace(jnp.asarray(tri), jnp.asarray(rgb), jcam, JSettings(image_width=W, image_height=W),
                background=None if background is None else jnp.asarray(background))
    t = t_trace(torch.as_tensor(tri), torch.as_tensor(rgb), tcam,
                RasterSettings(image_width=W, image_height=W),
                background=None if background is None else torch.as_tensor(background))
    np.testing.assert_allclose(t["render"].numpy(), np.asarray(j["render"]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t["hit"].numpy(), np.asarray(j["hit"]))
    hit = t["hit"].numpy()
    np.testing.assert_allclose(t["depth"].numpy()[hit], np.asarray(j["depth"])[hit], rtol=1e-5)
    return t


def square(z, s):
    a, b, c, d = [-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]
    return [[a, b, c], [a, c, d]]


def test_raytrace_square_matches_jax():
    t = trace_both(np.asarray(square(5.0, 1.0), np.float32),
                   np.asarray([[1.0, 0.0, 0.0]] * 2, np.float32), 64,
                   background=np.zeros(3, np.float32), fov_deg=60.0)
    assert t["hit"].float().mean() > 0.05
    np.testing.assert_allclose(t["depth"][t["hit"]].numpy(), 5.0, rtol=1e-5)


def test_raytrace_nearest_hit_matches_jax():
    tri = np.asarray(square(6.0, 2.0) + square(4.0, 0.5), np.float32)
    rgb = np.asarray([[1, 0, 0]] * 2 + [[0, 1, 0]] * 2, np.float32)
    t = trace_both(tri, rgb, 32)
    assert abs(float(t["depth"][16, 16]) - 4.0) < 1e-5 and float(t["render"][1, 16, 16]) == 1.0


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_raytrace_random_scene_matches_jax(chunk):
    """A random soup (overlapping triangles, nearest-hit ties between
    chunks and within one) at three chunk sizes."""
    s = make_random_scene(60, seed=5)
    W = 48
    jcam, tcam = j_camera(W, W), t_camera(W, W, device="cpu")
    j = j_trace(jnp.asarray(s["vertex"]), jnp.asarray(s["rgb"]), jcam,
                JSettings(image_width=W, image_height=W), background=jnp.ones(3))
    t = t_trace(torch.as_tensor(s["vertex"]), torch.as_tensor(s["rgb"]), tcam,
                RasterSettings(image_width=W, image_height=W), background=torch.ones(3),
                chunk=chunk)
    np.testing.assert_allclose(t["render"].numpy(), np.asarray(j["render"]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t["hit"].numpy(), np.asarray(j["hit"]))
    assert t["hit"].float().mean() > 0.02


# ---------------------------------------------------------------------------
# chamfer / F-score (tests/test_mesh_metrics.py's cases)
# ---------------------------------------------------------------------------

def _square(z=0.0, shift=(0.0, 0.0), size=1.0):
    a = np.array([0, 0, z]); b = np.array([size, 0, z])  # noqa: E702
    c = np.array([size, size, z]); d = np.array([0, size, z])  # noqa: E702
    tri = np.stack([np.stack([a, b, c]), np.stack([a, c, d])]).astype(np.float32)
    tri[..., 0] += shift[0]
    tri[..., 1] += shift[1]
    return tri


def assert_scores_equal(j, t):
    assert set(j) == set(t)
    for k in ("precision", "recall", "fscore", "tau"):
        assert t[k] == pytest.approx(j[k], rel=1e-12), k
    for k in ("chamfer", "chamfer_a2b", "chamfer_b2a"):
        assert t[k] == pytest.approx(j[k], rel=1e-6), k


@pytest.mark.parametrize("case", ["identical", "partial_overlap"])
def test_mesh_geometry_scores_match_jax(case):
    tri = _square()
    gt = tri if case == "identical" else np.concatenate([_square(), _square(shift=(2, 0))])
    assert_scores_equal(JMM.mesh_geometry_scores(tri, gt, n_samples=2000, tau=0.05),
                        TMM.mesh_geometry_scores(tri, gt, n_samples=2000, tau=0.05,
                                                 device="cpu"))


def test_chamfer_translated_planes_match_jax():
    a = TMM.sample_triangle_soup(_square(z=0.0), 1500, seed=0)
    b = TMM.sample_triangle_soup(_square(z=0.3), 1500, seed=1)
    np.testing.assert_array_equal(a, JMM.sample_triangle_soup(_square(z=0.0), 1500, seed=0))
    for tau in (0.1, 0.35):
        t = TMM.chamfer_and_fscore(a, b, tau=tau, device="cpu")
        assert_scores_equal(JMM.chamfer_and_fscore(a, b, tau=tau), t)
    assert abs(t["chamfer_a2b"] - 0.3) < 0.02 and t["fscore"] > 0.99
    with pytest.raises(ValueError, match="equal"):
        TMM.nn_dists_cross(np.zeros((10, 3), np.float32), np.zeros((11, 3), np.float32),
                           device="cpu")


# ---------------------------------------------------------------------------
# the surface solidify end to end (tests/test_synthetic_gt.py's twin)
# ---------------------------------------------------------------------------

def test_surface_solidify_end_to_end(tmp_path):
    """Train the solidify recipe on a surface dataset, export the GLB and
    score it against the exact GT soup: the training improves, the GLB is
    written, and the geometry lands inside the JAX test's sanity bounds;
    then the ray tracer's PSNR of the GLB on the test views is finite."""
    from triangle_splatting_tpu_torch.models.raw_triangle import RawTriangle
    from triangle_splatting_tpu_torch.trainers import losses as L
    from triangle_splatting_tpu_torch.trainers.smoke import make_smoke_config
    from triangle_splatting_tpu_torch.trainers.vanilla_ts import VanillaTSTrainer
    from triangle_splatting_tpu_torch.utils.testing import build_synthetic_nerf_dataset

    root = build_synthetic_nerf_dataset(
        tmp_path / "data", res=48, n_tri=400, n_train=6, n_test=2, impl="oracle",
        scene_kind="surface", pcd_points=300, pcd_noise=0.05, device="cpu")
    cfg = make_smoke_config(root, tmp_path / "out", 60, densify=False, mesh=True)
    cfg.trainer.save_glb_iterations = [60]
    trainer = VanillaTSTrainer(cfg, log_file=False, device="cpu")
    trainer._init_model()
    p0 = float(trainer._evaluate(0))
    trainer.train()
    p1 = float(trainer._evaluate(60))
    assert p1 > p0 + 1.0, (p0, p1)
    glb = tmp_path / "out" / "glb" / "60.glb"
    assert glb.exists()
    raw = RawTriangle(glb_path=str(glb))
    assert len(raw) > 0
    gt = np.load(root / "gt_scene.npz")
    geo = TMM.mesh_geometry_scores(raw.vertex, gt["vertex"], n_samples=2000, tau=0.2,
                                   device="cpu")
    assert np.isfinite(geo["chamfer"]) and geo["chamfer"] < 1.5, geo
    assert geo["recall"] > 0.3, geo
    cols = torch.as_tensor(np.clip(raw.shs[:, :3] * 0.28209479177387814 + 0.5, 0, 1))
    for cam in trainer.dataset.getTestDataset():
        out = t_trace(torch.as_tensor(raw.vertex), cols, cam, trainer._settings_for(cam),
                      background=torch.ones(3))
        assert np.isfinite(float(L.psnr(out["render"].clamp(0, 1), cam.gt_image)))
