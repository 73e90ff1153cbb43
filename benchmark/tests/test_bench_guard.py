"""What a run loads, and what a run does without a card.

- A run of each cell (on the CPU, at a tiny size, in its own process)
  loads neither ``jax``, ``jaxlib``, ``flax`` nor ``triangle_splatting_tpu``
  (top-level names compared whole: the port's name begins with the JAX
  package's), and the plain reference with the scene generators and counts
  loads nothing of ``triangle_splatting_tpu_torch``.
- Without a CUDA device a measuring run exits non-zero with a message and
  prints no result; a checkout without the program does the same; a
  result names the device and its power limit.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "triangle_splatting_tpu"}


def _modules(code: str, cwd=ROOT) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(cwd),
                                           "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


TOP = "import json, sys; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"


def test_reference_scenes_and_counts_load_nothing_of_the_program():
    mods = _modules("import sys; sys.path.insert(0, '.')\n"
                    "import benchmark.reference.vanilla_ts_mesh, benchmark.reference.scaffold_gs\n"
                    "import benchmark.scenes.city, benchmark.scenes.colmap_soup\n"
                    "import benchmark.counts.steps, benchmark.control\n" + TOP)
    assert "triangle_splatting_tpu_torch" not in mods
    assert not mods & FORBIDDEN


@pytest.mark.parametrize("cell", ["city-mesh-train", "scaffold-train", "scaffold-render"])
def test_a_run_loads_no_jax(cell, tmp_path):
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import torch; torch.set_num_threads(2)\n"
            "from benchmark.tests import conftest as T\n"
            "from benchmark.scenes import common as C\n"
            "from benchmark.drivers import train as D\n"
            "from pathlib import Path\n"
            f"C.CACHE = D.CACHE = Path({str(tmp_path)!r})\n"
            "from benchmark import run as R\n"
            f"r = R.run_cell({cell!r}, 77, 0.5, True, 'cpu', overrides=T.tiny, spec=T.spec())\n"
            "assert r['attempted'] >= 3 and r['metrics'], r\n" + TOP)
    mods = _modules(code)
    assert "triangle_splatting_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def _run(args, cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(cwd)})


ARGS = ["--workload", "scaffold-train", "--seed", "5000000000", "--seconds", "1", "--trace", "0"]


def test_no_card_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(ARGS, ROOT)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    out = _run(ARGS, tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_result_line_names_the_device_and_its_power_limit(monkeypatch, capsys):
    import torch
    from benchmark import run as R
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(R, "power_limit_w", lambda: 700.0)
    canned = dict(correct=True, attempted=3, failed=0,
                  metrics={"setup_s": {"value": 1.0, "unit": "s"}},
                  device=dict(platform="gpu", kind="NVIDIA H100 80GB HBM3", count=1,
                              memory_peak_bytes=1), checks={"loss_gap": dict(value=0.0, limit=1.0)})
    monkeypatch.setattr(R, "run_cell", lambda *a, **k: dict(canned))
    assert R.main(ARGS) == 0
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    assert last["device"]["kind"] == "NVIDIA H100 80GB HBM3"
    assert last["device"]["power_limit_w"] == 700.0
    assert list(last)[-1] == "checks"
    assert "check loss_gap" in out.err
