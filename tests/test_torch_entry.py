"""The port's entry surface against the JAX package's: the package module
``run_experiments`` (presets, aliases, jobs) against the root script, the
lazy export surface against ``triangle_splatting_tpu._LAZY``, the pipeline
fan-out (sequential, batches, a failing worker, a GPU each),
``render_utils`` (BEV, tour, compare) against the JAX helpers, and one CPU
run of the dispatch end to end. Module-level imports stay light: the
fan-out's spawned workers import this module."""

import json
import os
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent


# -- run_experiments ----------------------------------------------------------

def test_run_experiments_matches_the_root_script():
    """Every preset, alias and scene filter gives the root script's
    arguments and jobs; the presets are the same tables."""
    import run_experiments as J
    from triangle_splatting_tpu_torch import run_experiments as T
    for name in ("NERF_SYNTHETIC_SCENES", "NERF_SYNTHETIC_MESH_POINTS", "MIPNERF360_SCENES",
                 "TANKS_SCENES", "TYPE_ALIASES"):
        assert getattr(T, name) == getattr(J, name), name
    types = sorted(set(J.TYPE_ALIASES) | set(J.TYPE_ALIASES.values()))
    for t in types:
        for extra in ([], ["--scenes", "lego", "bicycle", "truck"], ["--num_workers", "2"]):
            argv = ["--type", t, "--dataset_path", "/d", *extra]
            a_t, a_j = T.parse_args(argv), J.parse_args(argv)
            assert vars(a_t) == vars(a_j), argv
            assert T.build_jobs(a_t) == J.build_jobs(a_j), argv
            assert T.build_jobs(a_t), argv
    for bad in (["--type", "NotAPreset", "--dataset_path", "/d"], ["--type", "NerfSynthetic"]):
        with pytest.raises(SystemExit):
            T.parse_args(bad)


# -- the export surface -------------------------------------------------------

def test_lazy_surface_is_the_jax_one_and_resolves_to_the_port():
    import triangle_splatting_tpu as J
    import triangle_splatting_tpu_torch as T
    assert T._LAZY == J._LAZY
    for name in T._LAZY:
        obj = getattr(T, name)
        assert obj.__module__.startswith("triangle_splatting_tpu_torch."), (name, obj.__module__)
    for name in ("Config", "loadConfig", "saveConfig", "Camera", "RasterSettings"):
        assert getattr(T, name).__module__.startswith("triangle_splatting_tpu_torch."), name
        assert hasattr(J, name), name
    assert set(T._LAZY) <= set(dir(T))
    with pytest.raises(AttributeError):
        T.NotAName  # noqa: B018


def test_save_config_roundtrip(tmp_path):
    from triangle_splatting_tpu.utils.config import loadConfig as j_load
    from triangle_splatting_tpu_torch import loadConfig, saveConfig
    from triangle_splatting_tpu_torch.utils.config import config_to_dict
    cfg = loadConfig(REPO / "config" / "NerfSynthetic_VanillaTS.yaml")
    for suffix in (".yaml", ".json"):
        saveConfig(cfg, tmp_path / f"c{suffix}")
        assert config_to_dict(loadConfig(tmp_path / f"c{suffix}")) == \
            j_load(tmp_path / f"c{suffix}").to_dict()
    with pytest.raises(ValueError):
        saveConfig(cfg, tmp_path / "c.txt")


# -- the pipeline fan-out -------------------------------------------------------

def _stamp(path: str, i: int) -> None:
    """A worker: record its start and end (wall clock) in ``path``."""
    t0 = time.time()
    time.sleep(0.4)
    Path(path).write_text(json.dumps([i, t0, time.time()]))


def _fail(code: int) -> None:
    sys.exit(code)


def _gpu(path: str) -> None:
    """A worker: record the GPUs it was given."""
    Path(path).write_text(os.environ.get("CUDA_VISIBLE_DEVICES", "unset"))


def test_pipeline_runs_sequentially_without_enough_gpus(capsys):
    """More workers than visible GPUs (none here): JAX's line, then every
    scene in order in this process."""
    from triangle_splatting_tpu_torch.utils import pipeline_utils as P
    done = []
    P.run_exp_with_args(lambda *a: done.append(a), [(1, "a"), (2, "b"), (3, "c")],
                        num_workers=3)
    assert done == [(1, "a"), (2, "b"), (3, "c")]
    assert "pipeline: 0 device(s) < 3 workers — running scenes sequentially" in \
        capsys.readouterr().out


def test_pipeline_batches_wait_and_a_failing_worker_raises(tmp_path, monkeypatch):
    """With as many GPUs as workers, scenes run in spawned processes, a
    batch at a time: the second batch starts after the first has ended. A
    worker's exit code other than 0 raises."""
    from triangle_splatting_tpu_torch.utils import pipeline_utils as P
    monkeypatch.setattr(P, "visible_gpu_count", lambda: 2)
    jobs = [(str(tmp_path / f"{i}.json"), i) for i in range(4)]
    P.run_exp(_stamp, jobs, num_workers=2)
    rec = sorted(json.loads((tmp_path / f"{i}.json").read_text()) for i in range(4))
    assert [r[0] for r in rec] == [0, 1, 2, 3]
    assert max(r[2] for r in rec[:2]) <= min(r[1] for r in rec[2:])
    with pytest.raises(RuntimeError, match="exit 3"):
        P.run_exp(_fail, [(0,), (3,)], num_workers=2)


@pytest.mark.parametrize("visible", [None, "5,7,2"])
def test_pipeline_gives_each_worker_its_own_gpu(tmp_path, monkeypatch, visible):
    """Worker j of a batch sees only GPU j of this process's visible ones
    (so its default ``device="cuda"`` is its own card), in every batch."""
    from triangle_splatting_tpu_torch.utils import pipeline_utils as P
    monkeypatch.setattr(P, "visible_gpu_count", lambda: 3)
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    P.run_exp(_gpu, [(str(tmp_path / f"{i}.txt"),) for i in range(5)], num_workers=2)
    got = [(tmp_path / f"{i}.txt").read_text() for i in range(5)]
    want = ["0", "1"] if visible is None else ["5", "7"]
    assert got == want * 2 + want[:1]


# -- render_utils --------------------------------------------------------------

def city_scene(n=160, seed=0):
    """Triangles spread over MatrixCity's metric footprint (the BEV camera
    flies 1200 above the center, the tour orbits 800 x 400 at 400)."""
    rng = np.random.default_rng(seed)
    centers = np.stack([rng.uniform(-300, 300, n), rng.uniform(-150, 150, n),
                        rng.uniform(0, 40, n)], 1).astype(np.float32)
    vertex = centers[:, None] + rng.normal(0, 30, (n, 3, 3)).astype(np.float32)
    return dict(vertex=vertex, opacity=np.full((n, 1), 1.5, np.float32),
                f_dc=rng.normal(0, 1, (n, 1, 3)).astype(np.float32),
                f_rest=np.zeros((n, 0, 3), np.float32))


def render_fns(rtype="2D"):
    import jax.numpy as jnp
    from triangle_splatting_tpu.models import triangle as JM
    from triangle_splatting_tpu.utils import render_utils as JR
    from triangle_splatting_tpu_torch.convert import triangle_from_numpy
    from triangle_splatting_tpu_torch.models import triangle as TM
    from triangle_splatting_tpu_torch.utils import render_utils as TR
    s = city_scene()
    cap = 256
    pad = {k: np.concatenate([v, np.zeros((cap - len(v),) + v.shape[1:], v.dtype)])
           for k, v in s.items()}
    alive = np.arange(cap) < len(s["vertex"])
    jp = JM.TriangleParams(**{k: jnp.asarray(v) for k, v in pad.items()})
    js = JM.TriangleState.create(cap)
    js = type(js)(**{**js.__dict__, "alive": jnp.asarray(alive)})
    cfg_kw = dict(max_sh_degree=0, rasterizer_type=rtype)
    j_fn = JR.make_render_fn(jp, js, JM.ModelConfig(**cfg_kw))
    state = {k: np.asarray(v) for k, v in js.__dict__.items()}
    tp, ts_ = triangle_from_numpy(pad, state, device="cpu")[:2]
    t_fn = TR.make_render_fn(tp, ts_, TM.ModelConfig(**cfg_kw), device="cpu")
    return j_fn, t_fn


class FrameSink:
    def __init__(self):
        self.frames = []

    def write(self, frame):
        self.frames.append(np.array(frame))

    def release(self):
        pass


def test_bev_and_tours_match_jax(monkeypatch, tmp_path):
    """``make_render_fn``'s center, the BEV image (1e-3 abs) and the tour
    and comparison frames (the BGR 8-bit frames handed to the video writer:
    within one level, a level flipping at a quantization edge on at most
    1% of the values) against the JAX helpers on the same triangles."""
    from triangle_splatting_tpu.utils import render_utils as JR
    from triangle_splatting_tpu_torch.utils import render_utils as TR
    j_fn, t_fn = render_fns()
    np.testing.assert_allclose(t_fn.center, j_fn.center, rtol=1e-6)   # an ulp of the mean
    size = (64, 48)
    t_bev = TR.render_BEV_image(t_fn, img_size=size)
    j_bev = np.asarray(JR.render_BEV_image(j_fn, img_size=size))
    assert t_bev.shape == (3, 48, 64)
    assert np.abs(t_bev - j_bev).max() <= 1e-3 and t_bev.std() > 0.01
    R, T = TR.pos_target_to_RT(np.array([1.0, 2.0, 3.0]), np.array([0.0, 0.0, 0.0]))
    for a, b in zip((R, T), JR.pos_target_to_RT(np.array([1.0, 2.0, 3.0]), np.zeros(3))):
        np.testing.assert_array_equal(a, b)

    sinks = {}
    for name, mod in (("t", TR), ("j", JR)):
        sinks[name] = []

        def opener(path, fps, img_size, name=name):
            sink = FrameSink()
            sinks[name].append(sink)
            return sink
        monkeypatch.setattr(mod, "_open_video", opener)
    TR.render_tour(t_fn, str(tmp_path / "t.mp4"), img_size=size, fps=2, duration=2)
    JR.render_tour(j_fn, str(tmp_path / "j.mp4"), img_size=size, fps=2, duration=2)
    pytest.importorskip("cv2")
    TR.render_tour_compare(t_fn, t_fn, str(tmp_path / "tc.mp4"), img_size=size, fps=1,
                           duration=2, name1="a", name2="b")
    JR.render_tour_compare(j_fn, j_fn, str(tmp_path / "jc.mp4"), img_size=size, fps=1,
                           duration=2, name1="a", name2="b")
    assert [len(s.frames) for s in sinks["t"]] == [len(s.frames) for s in sinks["j"]] == [4, 2]
    lit = 0
    for ts_, js_ in zip(sinks["t"], sinks["j"]):
        for a, b in zip(ts_.frames, js_.frames):
            assert a.shape == b.shape == (48, 64, 3) and a.dtype == np.uint8
            d = np.abs(a.astype(int) - b.astype(int))
            assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())
            lit += int(a.std() > 1)
    assert lit >= 3


def test_render_fn_renders_gaussians_where_the_jax_one_raises():
    """The JAX ``make_render_fn`` passes ``apply_color_affine`` to every core,
    and the Gaussian core takes none: on Gaussian params it raises
    TypeError. The port passes it to the triangle core only; its Gaussian
    frames equal the JAX Gaussian ``forward`` called directly (render 1e-3
    abs, n_contrib exact)."""
    import jax.numpy as jnp
    from triangle_splatting_tpu.models import gaussian_model as JG
    from triangle_splatting_tpu.models.point_cloud import PointCloud
    from triangle_splatting_tpu.ops.projection import RasterSettings as JRS
    from triangle_splatting_tpu.utils import render_utils as JR
    from triangle_splatting_tpu.utils.testing import make_camera as j_camera
    from triangle_splatting_tpu_torch.convert import gaussian_from_numpy
    from triangle_splatting_tpu_torch.models import gaussian_model as TG
    from triangle_splatting_tpu_torch.utils import render_utils as TR
    from triangle_splatting_tpu_torch.utils.testing import make_camera as t_camera
    rng = np.random.default_rng(2)
    pts = (rng.random((40, 3)).astype(np.float32) - 0.5) * 2
    pts[:, 2] += 4.0
    jp, js = JG.create_from_points(pts, rng.random((40, 3)).astype(np.float32),
                                   JG.GSModelConfig(max_sh_degree=0), init_opacity=0.5)
    j_fn = JR.make_render_fn(jp, js, JG.GSModelConfig(max_sh_degree=0))
    with pytest.raises(TypeError, match="apply_color_affine"):
        j_fn(j_camera(32, 32))
    tp, ts_ = gaussian_from_numpy({k: np.asarray(v) for k, v in jp.__dict__.items()},
                                  {k: np.asarray(v) for k, v in js.__dict__.items()},
                                  device="cpu")[:2]
    t_out = TR.make_render_fn(tp, ts_, TG.GSModelConfig(max_sh_degree=0),
                              device="cpu")(t_camera(32, 32, device="cpu"))
    j_out = JG.forward(jp, js, j_camera(32, 32), jnp.zeros(3), JG.GSModelConfig(max_sh_degree=0),
                       JRS(image_width=32, image_height=32, max_sh_degree=0), is_training=False)
    assert np.abs(t_out["render"].numpy() - np.asarray(j_out["render"])).max() <= 1e-3
    np.testing.assert_array_equal(t_out["n_contrib"].numpy(), np.asarray(j_out["n_contrib"]))
    assert set(t_out) == set(j_out)


# -- the dispatch end to end -----------------------------------------------------

def test_run_experiments_dispatch_trains_on_the_cpu(tmp_path, monkeypatch):
    """``parse_args`` -> ``build_jobs`` -> ``run_exp_with_args(exp)`` from a
    working directory whose ``config/NerfSynthetic_VanillaTS.yaml`` is the
    shipped one cut to 8 iterations with a profile window at 3-5, on a
    synthetic NeRF-Synthetic scene at 32x32 (``exp`` with
    ``device="cpu"``): the loss is logged, the timer's breakdown ends the
    log, the profile trace lies under ``profile/``."""
    import yaml

    from triangle_splatting_tpu_torch import run_experiments as T
    from triangle_splatting_tpu_torch.utils.pipeline_utils import run_exp_with_args
    from triangle_splatting_tpu_torch.utils.testing import build_synthetic_nerf_dataset
    data = tmp_path / "data" / "soup"
    build_synthetic_nerf_dataset(data, res=32, n_tri=60, n_train=4, n_test=2, device="cpu")
    cfg = yaml.safe_load((REPO / "config" / "NerfSynthetic_VanillaTS.yaml").read_text())
    cfg["trainer"].update(iterations=8, log_interval_iter=2, eval_interval_iter=4,
                          save_iterations=[8], checkpoint_iterations=[], seed=0,
                          use_tensorboard=False, profile_start_iter=3, profile_end_iter=5,
                          output_dir="outputs/ns")
    cfg["dataset"]["num_workers"] = 1
    (tmp_path / "config").mkdir()
    (tmp_path / "config" / "NerfSynthetic_VanillaTS.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    args = T.parse_args(["--type", "NerfSynthetic", "--dataset_path", str(data.parent),
                         "--scenes", "soup"])
    run_exp_with_args(partial(T.exp, device="cpu"), T.build_jobs(args), args.num_workers)
    out = tmp_path / "outputs" / "ns" / "soup"
    events = [json.loads(ln) for ln in (out / "log" / "events.jsonl").read_text().splitlines()]
    losses = [e["value"] for e in events if e["tag"] == "Loss"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    log = next((out / "log").glob("*_outputs.log")).read_text()
    for channel in ("[Training] total", "data loading", "train step", "evaluation",
                    "model update", "device drain", "logging", "point cloud saving"):
        assert channel in log, channel
    assert list((out / "profile").glob("trace_3_5.json"))
    assert (out / "point_cloud" / "8.ply").exists()
    minutes = [e["value"] for e in events if e["tag"] == "Training Time (min)"]
    assert minutes == sorted(minutes) and minutes[-1] > 0
