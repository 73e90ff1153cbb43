"""Shared fixtures of the benchmark's tests: the tiny CPU sizes of each
cell and a temporary scene cache."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_SCENES = {
    "city": dict(width=96, height=64, init_triangles=3000, init_large=5, cell=0.5, chunk=1 << 22),
    "colmap_soup": dict(width=96, height=64, gt_triangles=800, n_points=300, chunk=1 << 22),
}


def tiny(files: dict) -> dict:
    """A cell's files cut to a CPU-sized scene and slice."""
    files["config"]["scene"].update(TINY_SCENES[files["config"]["scene"]["generator"]])
    if files["traffic"]["kind"] == "render":
        files["traffic"].update(orbit_poses=4, trace_frames=3, reference_chunk=1 << 22)
    else:
        files["traffic"].update(warmup_steps=2, trace_steps=3, reference_chunk=1 << 22)
    return files


@pytest.fixture(autouse=True)
def scene_cache(tmp_path, monkeypatch):
    """Scenes and run folders of a test go to its own directory."""
    from benchmark.drivers import train as D
    from benchmark.scenes import common as C
    monkeypatch.setattr(C, "CACHE", tmp_path / "cache")
    monkeypatch.setattr(D, "CACHE", tmp_path / "cache")
    return tmp_path / "cache"


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest -m cuda benchmark/tests)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


# the city cell's files stay under benchmark/ for the change that adds it
# back once the program's "3D" gradients are repaired (PERF.md, Open
# questions); the tests keep its harness working
CITY_CONFIG = dict(name="matrixcity-mesh-1m", source="config/MatrixCity_VanillaTS_mesh.yaml",
                   file="benchmark/configs/matrixcity-mesh-1m.json",
                   reduced=["train_views", "start_model"], why="the city mesh recipe")
CITY_CELL = dict(name="city-mesh-train", config="matrixcity-mesh-1m", traffic="train-slice-30k",
                 chips=1, why="the city mesh recipe's training slice")


def spec() -> dict:
    """BENCHMARK.json with the city cell added."""
    from benchmark.run import load_spec
    b = load_spec()
    if CITY_CELL["name"] not in {w["name"] for w in b["workloads"]}:
        b["configs"].append(dict(CITY_CONFIG))
        b["workloads"].append(dict(CITY_CELL))
        for m in b["end_to_end"] + b["per_layer"]:
            if "workloads" in m and "scaffold-train" in m["workloads"]:
                m["workloads"] = m["workloads"] + [CITY_CELL["name"]]
    return b
