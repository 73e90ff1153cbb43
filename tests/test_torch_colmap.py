"""The port's COLMAP and MatrixCity loading vs the JAX package: the text and
binary sparse-model readers on the same written files, ``readColmapCameras``,
the COLMAP factory's held-out split and ``.bin`` point clouds, the
MatrixCity factory on ``tests/test_matrix_city.py``'s layout, the dataset
dispatch of ``build_dataset``, and the synthetic city's MatrixCity writer
read back by both packages."""

import struct

import numpy as np
import pytest
import torch

from test_matrix_city import write_sparse_txt
from triangle_splatting_tpu.datasets import colmap_loader as JC
from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
from triangle_splatting_tpu_torch.datasets import colmap_loader as TC
from triangle_splatting_tpu_torch.utils.config import dict_to_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

pytest.importorskip("PIL")


def sparse_model(seed=0, n_img=10, n_pts=60):
    """Cameras (one PINHOLE, one SIMPLE_PINHOLE), images with unit
    quaternions and some 2D points, and a point cloud, from a seed."""
    rng = np.random.default_rng(seed)
    cams = {1: ("PINHOLE", 40, 30, [35.0, 33.5, 20.0, 15.0]),
            2: ("SIMPLE_PINHOLE", 32, 32, [30.0, 16.0, 16.0])}
    images = []
    for i in range(n_img):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        images.append((i + 1, q, rng.normal(size=3), 1 + i % 2, f"img_{(7 * i) % n_img:03d}.png",
                       rng.uniform(0, 30, size=(i % 3, 2))))
    pts = (rng.normal(size=(n_pts, 3)), rng.integers(0, 256, size=(n_pts, 3)),
           rng.uniform(0, 2, n_pts))
    return cams, images, pts


def write_text(d, model):
    cams, images, (xyz, rgb, err) = model
    d.mkdir(parents=True, exist_ok=True)
    (d / "cameras.txt").write_text("# Camera list\n" + "".join(
        f"{cid} {m} {w} {h} " + " ".join(repr(float(p)) for p in ps) + "\n"
        for cid, (m, w, h, ps) in cams.items()))
    lines = ["# Image list", "#   POINTS2D[] as (X, Y, POINT3D_ID)"]
    for iid, q, t, cid, name, p2 in images:
        lines.append(f"{iid} " + " ".join(repr(float(x)) for x in (*q, *t)) + f" {cid} {name}")
        lines.append(" ".join(f"{float(x)!r} {float(y)!r} -1" for x, y in p2))   # may be empty
    (d / "images.txt").write_text("\n".join(lines) + "\n")
    (d / "points3D.txt").write_text("# 3D point list\n" + "".join(
        f"{i + 1} " + " ".join(repr(float(v)) for v in xyz[i]) + " "
        + " ".join(str(int(c)) for c in rgb[i]) + f" {float(err[i])!r} 1 0\n" for i in range(len(xyz))))


def write_binary(d, model):
    cams, images, (xyz, rgb, err) = model
    d.mkdir(parents=True, exist_ok=True)
    with open(d / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cid, (m, w, h, ps) in cams.items():
            f.write(struct.pack("<iiQQ", cid, JC.CAMERA_MODEL_IDS[m], w, h))
            f.write(struct.pack(f"<{len(ps)}d", *ps))
    with open(d / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid, q, t, cid, name, p2 in images:
            f.write(struct.pack("<idddddddi", iid, *q, *t, cid))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(p2)))
            for x, y in p2:
                f.write(struct.pack("<ddq", x, y, -1))
    with open(d / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<qdddBBBd", i + 1, *xyz[i], *(int(c) for c in rgb[i]), err[i]))
            f.write(struct.pack("<Q", 2) + struct.pack("<iiii", 1, 0, 2, 1))


@pytest.fixture(scope="module")
def sparse(tmp_path_factory):
    root = tmp_path_factory.mktemp("colmap")
    model = sparse_model()
    write_text(root / "txt", model)
    write_binary(root / "bin", model)
    return root


@pytest.mark.parametrize("fmt", ["txt", "bin"])
def test_readers_match_jax(sparse, fmt):
    d = sparse / fmt
    cam_r = {"txt": "read_cameras_text", "bin": "read_cameras_binary"}[fmt]
    img_r = {"txt": "read_images_text", "bin": "read_images_binary"}[fmt]
    pts_r = {"txt": "read_points3D_text", "bin": "read_points3D_binary"}[fmt]
    tc, jc = getattr(TC, cam_r)(d / f"cameras.{fmt}"), getattr(JC, cam_r)(d / f"cameras.{fmt}")
    assert tc.keys() == jc.keys() == {1, 2}
    for k in tc:
        assert (tc[k].model, tc[k].width, tc[k].height) == (jc[k].model, jc[k].width, jc[k].height)
        np.testing.assert_array_equal(tc[k].params, jc[k].params)
    ti, ji = getattr(TC, img_r)(d / f"images.{fmt}"), getattr(JC, img_r)(d / f"images.{fmt}")
    assert ti.keys() == ji.keys() and len(ti) == 10
    for k in ti:
        assert (ti[k].camera_id, ti[k].name) == (ji[k].camera_id, ji[k].name)
        np.testing.assert_array_equal(ti[k].qvec, ji[k].qvec)
        np.testing.assert_array_equal(ti[k].tvec, ji[k].tvec)
    # the JAX binary reader may take its native float32 path; the port
    # reads float64 and the point cloud keeps float32, where they agree
    for g, w in zip(getattr(TC, pts_r)(d / f"points3D.{fmt}"),
                    getattr(JC, pts_r)(d / f"points3D.{fmt}")):
        np.testing.assert_array_equal(g.astype(np.float32), w.astype(np.float32))


@pytest.mark.parametrize("fmt", ["txt", "bin"])
def test_read_colmap_cameras_matches_jax(sparse, fmt):
    d = sparse / fmt
    got = TC.readColmapCameras(d / f"images.{fmt}", d / f"cameras.{fmt}", "images")
    want = JC.readColmapCameras(d / f"images.{fmt}", d / f"cameras.{fmt}", "images")
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert (g.camera_id, g.image_path, g.image_name, g.width, g.height) == \
            (w.camera_id, w.image_path, w.image_name, w.width, w.height)
        np.testing.assert_array_equal(g.R, w.R)
        np.testing.assert_array_equal(g.T, w.T)
        assert (g.FovX, g.FovY) == (w.FovX, w.FovY)
    q = np.array([0.5, 0.5, -0.5, 0.5])
    np.testing.assert_array_equal(TC.qvec2rotmat(q), JC.qvec2rotmat(q))


def assert_cameras_equal(tcam, jcam):
    assert (tcam.image_name, tcam.image_width, tcam.image_height) == \
        (jcam.image_name, jcam.image_width, jcam.image_height)
    for k in ("world_view", "full_proj", "camera_center", "tan_fovx", "tan_fovy", "gt_image"):
        np.testing.assert_array_equal(getattr(tcam, k).numpy(), np.asarray(getattr(jcam, k)),
                                      err_msg=k)


def test_colmap_factory_matches_jax(tmp_path):
    """sparse/0 as text, every 4th view held out, a points3D.bin cloud."""
    from PIL import Image
    from triangle_splatting_tpu.datasets.colmap import ColmapDatasetFactory as JF
    from triangle_splatting_tpu_torch.datasets.colmap import ColmapDatasetFactory as TF
    model = sparse_model(1, n_img=9)
    write_text(tmp_path / "sparse" / "0", model)
    write_binary(tmp_path / "pcd", model)
    (tmp_path / "images").mkdir()
    rng = np.random.default_rng(2)
    for _, _, _, cid, name, _ in model[1]:
        w, h = model[0][cid][1:3]
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / "images" / name)
    cfg = dict(local_dir=str(tmp_path), background="white", use_alpha_mask=False,
               num_workers=1, pcd_path="pcd/points3D.bin", hold_test_set=True,
               hold_interval=4)
    tf, jf = TF(dict_to_config(cfg), device="cpu"), JF(j_dict_to_config(cfg))
    assert (tf.getTrainDatasetSize(), tf.getTestDatasetSize()) == (6, 3)
    assert (jf.getTrainDatasetSize(), jf.getTestDatasetSize()) == (6, 3)
    for i in range(6):
        assert_cameras_equal(tf.getTrainDataset()[i], jf.getTrainDataset()[i])
    for tcam, jcam in zip(tf.getTestDataset(), jf.getTestDataset()):
        assert_cameras_equal(tcam, jcam)
    assert tf.cameras_extent == jf.cameras_extent
    tp, jp = tf.getPointCloud(), jf.getPointCloud()
    np.testing.assert_array_equal(tp.points, jp.points)
    np.testing.assert_array_equal(tp.colors, jp.colors)


@pytest.fixture()
def city(tmp_path):
    """tests/test_matrix_city.py's layout: 6 train / 2 test views at 32x32
    and a 50-point PLY cloud."""
    from triangle_splatting_tpu.models.point_cloud import PointCloud
    write_sparse_txt(tmp_path / "train" / "block_all", 6, "train")
    write_sparse_txt(tmp_path / "test" / "block_all_test", 2, "test")
    rng = np.random.default_rng(1)
    PointCloud(rng.normal(size=(50, 3)).astype(np.float32),
               rng.uniform(size=(50, 3)).astype(np.float32)).storePly(tmp_path / "pcd.ply")
    return tmp_path


@pytest.mark.parametrize("hold", [True, None])
def test_matrix_city_factory_matches_jax(city, hold):
    """Splits, cameras, GT images and the point cloud; without
    hold_test_set the test views join the training set."""
    from triangle_splatting_tpu.datasets.matrix_city import MatrixCityDatasetFactory as JF
    from triangle_splatting_tpu_torch.datasets.matrix_city import MatrixCityDatasetFactory as TF
    cfg = dict(local_dir=str(city), background="white", use_alpha_mask=False, num_workers=1,
               pcd_path="pcd.ply")
    if hold:
        cfg["hold_test_set"] = True
    tf, jf = TF(dict_to_config(cfg), device="cpu"), JF(j_dict_to_config(cfg))
    n_train = 6 if hold else 8
    assert tf.getTrainDatasetSize() == jf.getTrainDatasetSize() == n_train
    assert tf.getTestDatasetSize() == jf.getTestDatasetSize() == 2
    for i in range(n_train):
        assert_cameras_equal(tf.getTrainDataset()[i], jf.getTrainDataset()[i])
    for tcam, jcam in zip(tf.getTestDataset(), jf.getTestDataset()):
        assert_cameras_equal(tcam, jcam)
    assert abs(float(tf.getTrainDataset()[0].tan_fovx) - 1.0) < 1e-6
    tp, jp = tf.getPointCloud(), jf.getPointCloud()
    np.testing.assert_array_equal(tp.points, jp.points)
    np.testing.assert_array_equal(tp.colors, jp.colors)
    assert tf.getSceneInfo() is None


def test_build_dataset_dispatch(city, tmp_path):
    from triangle_splatting_tpu_torch.datasets.colmap import ColmapDatasetFactory
    from triangle_splatting_tpu_torch.datasets.matrix_city import MatrixCityDatasetFactory
    from triangle_splatting_tpu_torch.trainers.base import build_dataset
    from triangle_splatting_tpu_torch.utils.logger import Logger
    log = Logger("t", output_dir=None)
    base = dict(local_dir=str(city), background="white", use_alpha_mask=False, num_workers=1,
                pcd_path="pcd.ply", hold_test_set=True)
    ds = build_dataset(dict_to_config(dict(base, type="MatrixCity")), log, "cpu")
    assert type(ds) is MatrixCityDatasetFactory
    for kind in ("Colmap", "MipNerf360", "TanksAndBlending", "TanksAndTemples"):
        with pytest.raises(FileNotFoundError, match="sparse/0"):   # the COLMAP factory
            build_dataset(dict_to_config(dict(base, type=kind)), log, "cpu")
    assert issubclass(MatrixCityDatasetFactory, ColmapDatasetFactory)
    with pytest.raises(NotImplementedError, match="Qijing"):
        build_dataset(dict_to_config(dict(base, type="Qijing")), log, "cpu")
    with pytest.raises(ValueError, match="Unknown"):
        build_dataset(dict_to_config(dict(base, type="Nope")), log, "cpu")


def test_city_writer_reads_back_in_both_packages(tmp_path):
    """The synthetic city written in the MatrixCity layout at a small size:
    both factories read the same cameras and images, the cloud has the
    faces' colors and unit normals, and the rendered views are not empty."""
    from triangle_splatting_tpu.datasets.matrix_city import MatrixCityDatasetFactory as JF
    from triangle_splatting_tpu_torch.datasets.matrix_city import MatrixCityDatasetFactory as TF
    from triangle_splatting_tpu_torch.utils.testing import make_city_scene, write_matrix_city
    scene = make_city_scene(0, extent=1.5, n_buildings=4, cell=0.25)
    secs = write_matrix_city(tmp_path, scene, width=64, height=36, n_train=3, n_test=1,
                             n_points=3000, device="cpu")
    assert set(secs) == {"render", "png", "ply"}
    cfg = dict(local_dir=str(tmp_path), background=None, use_alpha_mask=False, num_workers=1,
               pcd_path="train/block_all/fused.ply", hold_test_set=True)
    tf, jf = TF(dict_to_config(cfg), device="cpu"), JF(j_dict_to_config(cfg))
    assert tf.getTrainDatasetSize() == 3 and tf.getTestDatasetSize() == 1
    for i in range(3):
        tcam = tf.getTrainDataset()[i]
        assert_cameras_equal(tcam, jf.getTrainDataset()[i])
        assert tcam.gt_image.shape == (3, 36, 64) and float(tcam.gt_image.std()) > 0.02
    pcd = tf.getPointCloud()
    assert pcd.points.shape == (3000, 3)
    np.testing.assert_allclose(np.linalg.norm(pcd.normals, axis=1), 1.0, atol=1e-6)
    assert pcd.points[:, 2].min() >= -1e-6 and (pcd.normals[:, 2] == 1).mean() > 0.5


def test_colmap_writer_reads_back_in_both_packages(tmp_path):
    """The synthetic COLMAP capture of the scaffold cell at a small size: both
    COLMAP factories read the same cameras and images (2 of 16 views held
    out by hold_interval 8) and the same points3D.bin cloud, whose points
    lie on the soup's faces with their colors (to the uint8 step)."""
    from triangle_splatting_tpu.datasets.colmap import ColmapDatasetFactory as JF
    from triangle_splatting_tpu_torch.datasets.colmap import ColmapDatasetFactory as TF
    from triangle_splatting_tpu_torch.utils.testing import make_random_scene, write_colmap_scene
    scene = make_random_scene(200, seed=7, z_range=(-0.8, 0.8), xy_extent=0.8,
                              size_range=(0.05, 0.2), opacity_range=(0.7, 0.95))
    secs = write_colmap_scene(tmp_path, scene, width=48, height=32, n_views=16, n_points=500,
                              device="cpu")
    assert set(secs) == {"render", "png", "ply"}
    cfg = dict(local_dir=str(tmp_path), background="white", use_alpha_mask=False,
               num_workers=1, pcd_path="sparse/0/points3D.bin", hold_test_set=True,
               hold_interval=8)
    tf, jf = TF(dict_to_config(cfg), device="cpu"), JF(j_dict_to_config(cfg))
    assert (tf.getTrainDatasetSize(), tf.getTestDatasetSize()) == (14, 2)
    for i in range(14):
        tcam = tf.getTrainDataset()[i]
        assert_cameras_equal(tcam, jf.getTrainDataset()[i])
        assert tcam.gt_image.shape == (3, 32, 48) and float(tcam.gt_image.std()) > 0.02
    tp, jp = tf.getPointCloud(), jf.getPointCloud()
    np.testing.assert_array_equal(tp.points, jp.points)
    assert tp.points.shape == (500, 3) and np.abs(tp.points).max() < 1.2
    assert ((tp.colors * 255) % 1 == 0).all() and tp.colors.max() <= 1.0
