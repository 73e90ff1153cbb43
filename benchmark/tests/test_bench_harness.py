"""BENCHMARK.json against the benchmark's rules, and the harness driven by
data: a cell, a configuration, a mix and a per-layer metric added as new
files are found by name without editing an existing file."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    b = spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/")
                                              and ".." not in p for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(line(w) for w in b["command"])
    for w in b["command"]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in b["paths"]), w
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024


def test_configs_and_cells():
    b = spec()
    used = {w["config"] for w in b["workloads"]}
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names) and set(names) == used
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"]) and (ROOT / c["file"]).exists()
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert set(data["assumed"]) >= set(c["reduced"])
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells) and 1 <= len(cells) <= 24
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").exists()
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)


def test_metrics():
    b = spec()
    cells = {w["name"] for w in b["workloads"]}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    reports = {c: {n for n, m in e2e.items() if c in m.get("workloads", cells)} for c in cells}
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and line(m["layer"]) and m["moves"] in e2e
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        # every cell that reads it reports the end-to-end metric it moves
        for c in m.get("workloads", cells):
            assert c in cells and m["moves"] in reports[c], (m["name"], c)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    for c in cells:
        assert any(c in m.get("workloads", cells) for m in b["per_layer"])
    assert any("mfu" in m["name"] for m in b["per_layer"])


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "benchmark").rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or rel.startswith("benchmark/cache"):
            continue
        assert PATH.match(rel), rel


def _hashes(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_config_mix_and_metric_added_as_files_are_found(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    before = _hashes(tmp_path)
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "scaffold-colmap-100k.json").read_text())
    cfg["name"] = "city-wide-views"
    cfg["scene"]["fovx_deg"] = 75.0
    (bench / "configs" / "city-wide-views.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "train-slice-5k.json").read_text())
    mix["start_iter"] = 40198
    (bench / "traffic" / "train-slice-40k.json").write_text(json.dumps(mix))
    (bench / "limits" / "city-wide-train.json").write_text(json.dumps({"loss_gap": 1e-3}))
    (bench / "metrics" / "steps_in_window.train.py").write_text(
        '"""Steps in the window."""\n\n\ndef read(rec):\n    return float(rec.get("steps", 0)) or None\n')
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="city-wide-views",
                             file="benchmark/configs/city-wide-views.json"))
    b["workloads"].append(dict(name="city-wide-train", config="city-wide-views",
                               traffic="train-slice-40k", chips=1, why="wider views"))
    b["per_layer"].append(dict(name="steps_in_window.train", unit="steps", better="higher",
                               source="program_counter", layer="trainer step",
                               moves="setup_s", workloads=["city-wide-train"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import json, sys; sys.path.insert(0, '.')\n"
        "from benchmark import run as R\n"
        "f = R.cell_files(R.load_spec(), 'city-wide-train')\n"
        "print(json.dumps(dict(cfg=f['config']['name'], fov=f['config']['scene']['fovx_deg'],\n"
        "    start=f['traffic']['start_iter'], limits=f['limits'],\n"
        "    layer=[m['name'] for m in f['per_layer']],\n"
        "    value=R.read_metric('steps_in_window.train', dict(steps=7)))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == dict(cfg="city-wide-views", fov=75.0, start=40198, limits={"loss_gap": 1e-3},
                       layer=got["layer"], value=7.0)
    assert "steps_in_window.train" in got["layer"]
    after = _hashes(tmp_path)
    changed = [k for k, v in before.items() if after.get(k) != v and k != "BENCHMARK.json"]
    assert changed == []


@pytest.mark.parametrize("name", ["a b", "x,y", "p/q", ".hidden", "é"])
def test_names_outside_the_rules_are_refused(name):
    assert not NAME.match(name)
