"""The port's Qijing tile dataset (``datasets/qijing.py``) against the JAX
package's: the tile geometry, the train / test split of a COLMAP capture
fetched through a mirror, the scene info and the per-tile GT Gaussians,
and the trainer's dataset dispatch, which refused the type before."""

import json
import math

import numpy as np
import pytest
import torch

from triangle_splatting_tpu.datasets import qijing as JQ
from triangle_splatting_tpu.datasets.colmap_loader import CameraInfo as JInfo
from triangle_splatting_tpu.utils.config import dict_to_config as j_cfg
from triangle_splatting_tpu_torch.datasets import qijing as TQ
from triangle_splatting_tpu_torch.datasets.colmap_loader import CameraInfo as TInfo
from triangle_splatting_tpu_torch.utils.config import dict_to_config as t_cfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def info(cls, x, y, z=10.0, fov=math.radians(60), name="img"):
    """A camera at (x, y, z) looking straight down, tilted a little."""
    R = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1.0]])
    a = 0.05 * x
    tilt = np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)], [0, math.sin(a), math.cos(a)]])
    R = tilt @ R
    T = -R.T @ np.array([x, y, z])
    return cls(camera_id=0, R=R, T=T, FovY=fov, FovX=fov, image_path="", image_name=name,
               width=64, height=64)


def test_tile_geometry_matches_jax():
    for x, y, z in ((0.0, 0.0, 10.0), (3.0, -2.0, 7.0), (-8.0, 5.0, 20.0)):
        for g in (0.0, 1.5):
            pt = TQ.frustum_ground_polygon(info(TInfo, x, y, z), g)
            pj = JQ.frustum_ground_polygon(info(JInfo, x, y, z), g)
            np.testing.assert_array_equal(pt, pj)
            for bbox in ([-10, -10, 10, 10], [-5, -5, 5, 4], [0, 0, 30, 30]):
                assert TQ.polygon_in_bbox(pt, bbox) == JQ.polygon_in_bbox(pj, bbox)


def test_split_matches_jax():
    xs = np.linspace(-50, 50, 21)
    scene = {"bbox_xyz": [-20, -20, 20, 20], "ground_z": 0.0}
    splits = []
    for mod, cls, cfg in ((TQ, TInfo, t_cfg), (JQ, JInfo, j_cfg)):
        f = mod.QijingDatasetFactory.__new__(mod.QijingDatasetFactory)
        f._config = cfg({"n_test": 3})
        f._scene_info = scene
        tr, te = f._split_train_test_views([info(cls, x, 0.0, name=f"r_{i:03d}")
                                            for i, x in enumerate(xs)])
        splits.append(([c.image_name for c in tr], [c.image_name for c in te]))
    assert splits[0] == splits[1]
    assert len(splits[0][1]) == 3 and len(splits[0][0]) == 18


@pytest.fixture(scope="module")
def remote(tmp_path_factory):
    """A COLMAP capture of a small soup (10 views at 64x48) on a "remote"
    mirror root, with the tile's bbox and a GT Gaussian PLY."""
    from triangle_splatting_tpu_torch.models.raw_gaussian import RawGaussian
    from triangle_splatting_tpu_torch.utils.testing import make_random_scene, write_colmap_scene
    root = tmp_path_factory.mktemp("qijing") / "remote"
    tile = root / "tile_42"
    scene = make_random_scene(40, seed=2, z_range=(-0.5, 0.5))
    write_colmap_scene(tile, scene, width=64, height=48, n_views=10, n_points=500,
                       device="cpu")
    (tile / "tile_bbox.json").write_text(json.dumps({"bbox_xyz": [-40, -40, 40, 40],
                                                     "ground_z": -3.0}))
    rng = np.random.default_rng(0)
    g = RawGaussian(xyz=rng.normal(size=(5, 3)), opacity=np.zeros((5, 1)),
                    shs=np.zeros((5, 3)), scale=np.zeros((5, 3)),
                    rotation=np.tile([1, 0, 0, 0.0], (5, 1)))
    (tile / "models_z18").mkdir()
    g.savePLY(tile / "models_z18" / "tile_42.ply")
    return root


def dataset_cfg(remote, cache, n_test=3):
    return {"type": "Qijing", "remote_dir": str(remote), "local_dir": str(cache),
            "scene_id": "tile_42", "n_test": n_test, "hold_test_set": True,
            "pcd_path": "sparse/0/points3D.bin", "num_workers": 1}


def test_factory_through_the_mirror_matches_jax(remote, tmp_path):
    """Both factories fetch the sparse model and the images through the
    mirror into their caches and split the views the same way; the port's
    views load onto its device with the JAX camera poses and images; the
    scene info and the GT Gaussians come through the mirror (the point
    cloud does not: ``getPointCloud`` reads the local root, in both)."""
    from triangle_splatting_tpu_torch.trainers.base import build_dataset
    from triangle_splatting_tpu_torch.utils.logger import Logger
    t = build_dataset(t_cfg(dataset_cfg(remote, tmp_path / "t")), Logger("q"), "cpu")
    assert isinstance(t, TQ.QijingDatasetFactory)
    j = JQ.QijingDatasetFactory(j_cfg(dataset_cfg(remote, tmp_path / "j")))
    names = []
    for f in (t, j):
        names.append(([c.image_name for c in f._train_dataset.cam_infos],
                       [c.image_name for c in f._test_dataset.cam_infos]))
    assert names[0] == names[1]
    assert len(names[0][1]) == 3 and len(names[0][0]) == 7
    assert (tmp_path / "t" / "tile_42" / "images" / "view_000.png").exists()
    cam_t = next(iter(t.getTestDataset()))
    cam_j = next(iter(j.getTestDataset()))
    assert cam_t.gt_image.device.type == "cpu"
    np.testing.assert_allclose(cam_t.world_view.numpy(), np.asarray(cam_j.world_view),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(cam_t.gt_image.numpy(), np.asarray(cam_j.gt_image))
    assert t.getSceneInfo() == j.getSceneInfo() == {"bbox_xyz": [-40, -40, 40, 40],
                                                    "ground_z": -3.0}
    gt_t, gt_j = t.getGTGaussian(), j.getGTGaussian()
    assert len(gt_t) == len(gt_j) == 5
    np.testing.assert_array_equal(gt_t.xyz, gt_j.xyz)
    t.close()


def test_local_handler_without_remote(remote):
    """Without ``remote_dir`` the factory reads ``local_dir/scene_id`` in
    place, as JAX's does."""
    cfg = dataset_cfg(remote, remote)
    cfg.pop("remote_dir")
    t = TQ.QijingDatasetFactory(t_cfg(cfg), device="cpu")
    j = JQ.QijingDatasetFactory(j_cfg(cfg))
    assert [c.image_name for c in t._test_dataset.cam_infos] == \
        [c.image_name for c in j._test_dataset.cam_infos]
    assert torch.is_tensor(next(iter(t.getTestDataset())).gt_image)
    pc_t, pc_j = t.getPointCloud(), j.getPointCloud()
    assert len(pc_t) == 500
    np.testing.assert_array_equal(pc_t.points, pc_j.points)
    np.testing.assert_array_equal(pc_t.colors, pc_j.colors)
