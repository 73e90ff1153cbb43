"""The port's host-side modules against the JAX package's: the phase timer,
the logger (TensorBoard mirror, ``Logger_MP``, ``stdout_logger``),
``vis_utils`` on both of its cv2 routes, ``io_utils`` / ``file_handler``
over the in-memory fake ``oss2`` of ``tests/test_oss_io.py``, the 3DGS PLY
point cloud of the COLMAP loader, and the trainers' profile window."""

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# -- timer ----------------------------------------------------------------------

def test_timer_matches_jax(monkeypatch):
    """The same clock readings give the JAX timer's durations and message."""
    from triangle_splatting_tpu.utils import timer as JT
    from triangle_splatting_tpu_torch.utils import timer as TT
    out = {}
    for name, mod in (("j", JT), ("t", TT)):
        ticks = iter(np.arange(100, dtype=np.float64) * 0.25 + 1000.0)
        monkeypatch.setattr(mod.time, "time", lambda ticks=ticks: float(next(ticks)))
        t = mod.Timer("Training")
        for ch in ("data loading", "train step", "data loading", "train step", "logging"):
            t.log(ch)
        t.stop()
        t.stop()
        out[name] = (dict(t.durations), t.total_duration(), t.message())
        t.reset()
        assert t.total_duration() == 0.0
    assert out["t"] == out["j"]
    assert out["t"][0] == {"data loading": 0.5, "train step": 0.5, "logging": 0.25}


# -- logger -------------------------------------------------------------------------

def events(out: Path) -> list:
    return [json.loads(ln) for ln in (out / "log" / "events.jsonl").read_text().splitlines()]


def drive(logger) -> None:
    logger.add_scalar("Loss", 0.5, 3)
    logger.add_histogram("Opacity", np.linspace(0, 1, 50), 3)
    logger.add_image("Pred 0", np.full((3, 4, 5), 0.25, np.float32), 3)
    logger.debug("debug line")
    logger.info("info line")
    logger.warnOnce("once")
    logger.warnOnce("once")
    logger.close()


def tb_events(out: Path) -> list:
    return sorted(p.name.split(".")[0] for p in (out / "tb").glob("events.out.tfevents.*"))


def test_logger_mirrors_tensorboard_as_jax(tmp_path):
    """Repair: the JAX logger mirrors every scalar, histogram and image to a
    TensorBoard ``SummaryWriter`` under ``<out>/tb`` when it imports; the
    port's logger had no such flag and wrote none. Both now write an event
    file beside the same JSONL records, and ``use_tensorboard=False``
    writes none."""
    pytest.importorskip("torch.utils.tensorboard")
    from triangle_splatting_tpu.utils.logger import Logger as JLogger
    from triangle_splatting_tpu_torch.utils.logger import Logger as TLogger
    for name, cls in (("j", JLogger), ("t", TLogger)):
        drive(cls("x", output_dir=tmp_path / name, use_tensorboard=True))
        drive(cls("x", output_dir=tmp_path / f"{name}_off", use_tensorboard=False))
    assert tb_events(tmp_path / "t") == tb_events(tmp_path / "j") == ["events"]
    assert not (tmp_path / "t_off" / "tb").exists() and not (tmp_path / "j_off" / "tb").exists()

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "time"} for r in recs]
    assert strip(events(tmp_path / "t")) == strip(events(tmp_path / "j"))
    log = next((tmp_path / "t" / "log").glob("*_outputs.log")).read_text()
    assert "debug line" in log and log.count("once") == 1
    assert (tmp_path / "t" / "images" / "Pred_0_3.png").exists()


def test_trainer_passes_use_tensorboard(tmp_path, monkeypatch):
    """``BaseTrainer`` hands ``trainer.use_tensorboard`` to its logger, as the
    JAX trainer does."""
    from triangle_splatting_tpu_torch.trainers import base
    from triangle_splatting_tpu_torch.utils.config import dict_to_config
    monkeypatch.setattr(base, "build_dataset", lambda *a: None)
    from triangle_splatting_tpu_torch.utils import logger as L
    made = []
    monkeypatch.setattr(L, "_summary_writer", lambda d: made.append(d) or "writer")
    for flag in (True, False, None):
        cfg = dict_to_config({"trainer": {"output_dir": str(tmp_path / str(flag)),
                                          "use_tensorboard": flag}, "dataset": {}, "model": {}})
        tr = base.BaseTrainer(cfg, device="cpu")
        assert (tr.logger._tb == "writer") == bool(flag)
        tr.logger._tb = None
        tr.logger.close()
    assert made == [tmp_path / "True" / "tb"]


def test_logger_without_tensorboard_keeps_the_jsonl(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from triangle_splatting_tpu_torch.utils.logger import Logger
    lg = Logger("x", output_dir=tmp_path, use_tensorboard=True)
    assert lg._tb is None
    drive(lg)
    assert [e["kind"] for e in events(tmp_path)] == ["scalar", "histogram", "image"]


def test_logger_mp_and_stdout_logger(tmp_path):
    """``Logger_MP`` forwards every record to its spawned listener, which
    writes the records a plain ``Logger`` writes; ``stdout_logger`` is a
    console-only ``Logger``, as in JAX."""
    from triangle_splatting_tpu.utils import logger as JL
    from triangle_splatting_tpu_torch.utils import logger as TL
    mp = TL.Logger_MP("mp", output_dir=tmp_path / "mp", use_tensorboard=False)
    drive(mp)
    drive(TL.Logger("plain", output_dir=tmp_path / "plain", use_tensorboard=False))

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "time"} for r in recs]
    assert strip(events(tmp_path / "mp")) == strip(events(tmp_path / "plain"))
    assert not mp._listener.is_alive()
    assert isinstance(TL.stdout_logger, TL.Logger) and TL.stdout_logger.output_dir is None
    assert isinstance(JL.stdout_logger, JL.Logger)


# -- vis_utils ------------------------------------------------------------------------

@pytest.mark.parametrize("cv2_route", [True, False], ids=["cv2", "numpy"])
def test_vis_utils_match_jax(cv2_route, tmp_path, monkeypatch):
    """``depth_to_image`` (cv2's COLORMAP_JET, or the numpy JET map with cv2
    blocked), ``normal_to_image`` and ``save_image_tensor`` equal JAX's on
    the same route; ``camera_to_mesh`` writes the JAX file."""
    if cv2_route:
        pytest.importorskip("cv2")
    else:
        monkeypatch.setitem(sys.modules, "cv2", None)
    from triangle_splatting_tpu.utils import vis_utils as JV
    from triangle_splatting_tpu_torch.utils import vis_utils as TV
    rng = np.random.default_rng(0)
    depth = rng.uniform(1, 9, (24, 32)).astype(np.float32)
    d_t, d_j = TV.depth_to_image(depth), JV.depth_to_image(depth)
    assert d_t.dtype == np.uint8 and d_t.shape == (24, 32, 3)
    np.testing.assert_array_equal(d_t, d_j)
    normal = rng.uniform(-1, 1, (24, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(TV.normal_to_image(normal), JV.normal_to_image(normal))
    img = rng.uniform(0, 1, (3, 24, 32)).astype(np.float32)
    TV.save_image_tensor(img, str(tmp_path / "t" / "a.png"))
    JV.save_image_tensor(img, str(tmp_path / "j" / "a.png"))
    from PIL import Image
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t" / "a.png")),
                                  np.asarray(Image.open(tmp_path / "j" / "a.png")))
    w2c = np.stack([np.linalg.inv(np.array([[1, 0, 0, x], [0, 1, 0, 0], [0, 0, 1, 0],
                                            [0, 0, 0, 1.0]])) for x in (0.0, 1.0, 2.5)])
    fov = np.full(3, 0.8)
    p_t = TV.camera_to_mesh(w2c, fov, fov, out_dir=str(tmp_path / "t"))
    p_j = JV.camera_to_mesh(w2c, fov, fov, out_dir=str(tmp_path / "j"))
    assert Path(p_t).read_bytes() == Path(p_j).read_bytes()


def test_plot_camera_writes_a_png(tmp_path):
    pytest.importorskip("matplotlib")
    from triangle_splatting_tpu_torch.utils.vis_utils import plot_camera
    ring = np.array([[0, 0], [1, 0], [1, 1], [0, 1.0]])
    path = plot_camera(ring, ring * 2, np.array([0.5, 0.5]), out_dir=str(tmp_path))
    assert Path(path).stat().st_size > 1000


# -- io_utils / file_handler over the fake oss2 ------------------------------------------

@pytest.fixture()
def oss(monkeypatch):
    """The port's OSSIO over the fake sdk of tests/test_oss_io.py."""
    from test_oss_io import FakeService, _make_fake_oss2
    service = FakeService()
    fake = _make_fake_oss2(service)
    monkeypatch.setitem(sys.modules, "oss2", fake)
    monkeypatch.setitem(sys.modules, "oss2.models", fake.models)
    from triangle_splatting_tpu_torch.utils.io_utils import make_oss_io
    return make_oss_io("ak", "sk", "host.example", ["bucket-a", "bucket-b"]), service


def test_oss_io_and_the_port_registry(oss, tmp_path, monkeypatch):
    """The port's ``io`` registry routes ``oss://`` paths (one- and two-path
    methods) to the backend, and is its own: registering on it leaves the
    JAX package's ``io`` untouched."""
    from triangle_splatting_tpu.utils import io_utils as JIO
    from triangle_splatting_tpu_torch.utils import io_utils as TIO
    backend, svc = oss
    assert TIO.io is not JIO.io
    monkeypatch.setattr(TIO.io, "_backends", [])
    j_before = list(JIO.io._backends)
    TIO.io.register("oss://", backend)
    assert JIO.io._backends == j_before
    with TIO.io.open("oss://bucket-a/d/f.txt", "w") as f:
        f.write("via the port")
    assert svc.stores["bucket-a"]["d/f.txt"] == b"via the port"
    assert not TIO.io.islocal("oss://bucket-a/d/f.txt") and TIO.io.islocal(str(tmp_path))
    src = tmp_path / "u.txt"
    src.write_text("up")
    TIO.io.copy(str(src), "oss://bucket-b/u.txt")
    TIO.io.copy("oss://bucket-b/u.txt", str(tmp_path / "down.txt"))
    assert (tmp_path / "down.txt").read_text() == "up"
    assert TIO.io.listdir("oss://bucket-a/d/") == ["f.txt"]
    assert TIO.io.exists("oss://bucket-a/d/f.txt") and TIO.io.isfile("oss://bucket-a/d/f.txt")
    TIO.io.remove("oss://bucket-a/d/f.txt")
    assert not TIO.io.exists("oss://bucket-a/d/f.txt")
    b = TIO.set_oss_io({"ak_id": "a", "ak_secret": "s", "hosts": "h", "buckets": "bucket-a"})
    assert TIO.io._match("oss://bucket-a/x") is b


def test_oss_store_and_mirror_handler(oss, tmp_path, monkeypatch):
    from triangle_splatting_tpu_torch.utils import file_handler as FH
    from triangle_splatting_tpu_torch.utils import io_utils as TIO
    backend, svc = oss
    monkeypatch.setattr(TIO.io, "_backends", [])
    TIO.io.register("oss://", backend)
    assert FH.OSSHandler is FH.MirrorHandler
    store = FH.OSSStore("oss://bucket-a/runs", backend=backend)
    local = tmp_path / "ckpt.bin"
    local.write_bytes(b"state")
    store.put(str(local), "exp1/ckpt.bin")
    assert store.exists("exp1/ckpt.bin") and store.listdir("") == ["exp1"]
    store.get("exp1", str(tmp_path / "tree"))
    assert (tmp_path / "tree" / "ckpt.bin").read_bytes() == b"state"
    h = FH.OSSHandler("oss://bucket-a/share", str(tmp_path / "cache"), upload_lock=False)
    assert isinstance(h.remote, FH.OSSStore)
    p = h.getLocalPath("out.txt")
    Path(p).parent.mkdir(parents=True, exist_ok=True)
    Path(p).write_text("result")
    h.putFile(p, "out.txt", upload=True)
    assert svc.stores["bucket-a"]["share/out.txt"] == b"result"
    h2 = FH.MirrorHandler("oss://bucket-a/share", str(tmp_path / "c2"), upload_lock=False)
    assert Path(h2.getFilePath("out.txt")).read_text() == "result"
    h2.remoteSetDoneFlag("train")
    assert h2.remoteDone("train") and not h2.remoteFail("train")
    monkeypatch.setattr(TIO.io, "_backends", [])
    with pytest.raises(RuntimeError, match="set_oss_io"):
        FH.make_oss_store("oss://bucket-a/x")


def test_filesystem_mirror_and_local_handler(tmp_path):
    from triangle_splatting_tpu_torch.utils.file_handler import LocalHandler, MirrorHandler
    remote = tmp_path / "remote"
    (remote / "sub").mkdir(parents=True)
    (remote / "sub" / "a.txt").write_text("A")
    h = MirrorHandler(str(remote), str(tmp_path / "local"), upload_lock=False)
    assert h.hasFile("sub/a.txt") and not h.localExists("sub/a.txt")
    assert Path(h.getFilePath("sub/a.txt")).read_text() == "A"
    assert h.localExists("sub/a.txt")
    lh = LocalHandler(str(remote))
    assert lh.hasFile("sub/a.txt") and Path(lh.getFilePath("sub/a.txt")).read_text() == "A"


# -- the 3DGS PLY point cloud -----------------------------------------------------------

def test_gaussian_ply_point_cloud_gets_the_jax_colours(tmp_path):
    """Repair: the JAX COLMAP loader reads a ``.ply`` point cloud as a 3DGS
    Gaussian PLY first (colours ``clip(SH2RGB(f_dc))`` and its normals); the
    port read it as a plain cloud, whose missing ``red`` field gave black
    colours. Now both give the same cloud; a plain cloud still loads."""
    from triangle_splatting_tpu.datasets.colmap import ColmapDatasetFactory as JF
    from triangle_splatting_tpu.utils.config import dict_to_config as j_cfg
    from triangle_splatting_tpu_torch.datasets.colmap import ColmapDatasetFactory as TF
    from triangle_splatting_tpu_torch.models.point_cloud import PointCloud
    from triangle_splatting_tpu_torch.models.raw_gaussian import RawGaussian
    from triangle_splatting_tpu_torch.utils.config import dict_to_config as t_cfg
    rng = np.random.default_rng(4)
    n = 50
    g = RawGaussian(xyz=rng.normal(size=(n, 3)), opacity=np.zeros((n, 1)),
                    shs=rng.normal(size=(n, 48)), scale=np.zeros((n, 3)),
                    normals=rng.normal(size=(n, 3)))
    g.savePLY(tmp_path / "gs.ply")
    PointCloud(rng.normal(size=(n, 3)), rng.uniform(size=(n, 3)),
               rng.normal(size=(n, 3))).storePly(tmp_path / "plain.ply")
    for name in ("gs.ply", "plain.ply"):
        clouds = []
        for fac, cfg, kw in ((JF, j_cfg, {}), (TF, t_cfg, {})):
            f = fac.__new__(fac)
            f._config = cfg({"pcd_path": name})
            f.root = tmp_path
            f._logger = types.SimpleNamespace(info=lambda m: None)
            clouds.append(f.getPointCloud())
        t, j = clouds
        for attr in ("points", "colors", "normals"):
            np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr), err_msg=attr)
        assert t.colors.max() > 0.1
    from triangle_splatting_tpu_torch.ops.sh import SH2RGB
    want = np.clip(SH2RGB(g.shs[:, :3]), 0, 1)
    gs = TF.__new__(TF)
    gs._config, gs.root = t_cfg({"pcd_path": "gs.ply"}), tmp_path
    gs._logger = types.SimpleNamespace(info=lambda m: None)
    pc = gs.getPointCloud()
    np.testing.assert_array_equal(pc.colors, want.astype(np.float32))
    np.testing.assert_array_equal(pc.normals, g.normals)
    old = PointCloud().fetchPly(tmp_path / "gs.ply")
    assert old.colors.max() == 0.0          # the plain read: black triangles


# -- the profile window ---------------------------------------------------------------------

def test_profile_window_writes_a_trace_as_jax(tmp_path):
    """Repair: ``trainer.profile_start_iter`` / ``profile_end_iter`` were
    refused by the port; the JAX trainer opens a ``jax.profiler`` trace over
    the window into ``<output_dir>/profile``. The port opens a
    ``torch.profiler`` window over the same iterations and writes its Chrome
    trace there; no trace outside the window, none without the key."""
    from triangle_splatting_tpu.trainers.base import BaseTrainer as JBase
    from triangle_splatting_tpu.utils.config import dict_to_config as j_cfg
    from triangle_splatting_tpu_torch.trainers.base import BaseTrainer as TBase
    from triangle_splatting_tpu_torch.utils.config import dict_to_config as t_cfg
    lines = {}
    for name, base, cfg in (("j", JBase, j_cfg), ("t", TBase, t_cfg)):
        out = tmp_path / name
        lines[name] = []
        fake = types.SimpleNamespace(
            config=cfg({"trainer": {"profile_start_iter": 3, "profile_end_iter": 5}}),
            output_dir=str(out), device=torch.device("cpu"), _profiler=None,
            logger=types.SimpleNamespace(info=lines[name].append))
        for it in range(1, 8):
            base._profile_hooks(fake, it)
            if name == "t":
                torch.ones(64).sum()
        assert (out / "profile").is_dir()
        assert [ln.split("]")[0] for ln in lines[name]] == ["[ITER 3", "[ITER 5"]
    traces = list((tmp_path / "t" / "profile").glob("*.json"))
    assert [p.name for p in traces] == ["trace_3_5.json"]
    assert json.loads(traces[0].read_text())["traceEvents"]
    fake = types.SimpleNamespace(config=t_cfg({"trainer": {}}), output_dir=str(tmp_path / "n"),
                                 device=torch.device("cpu"), _profiler=None, logger=None)
    for it in range(1, 20):
        TBase._profile_hooks(fake, it)
    assert not (tmp_path / "n").exists()
