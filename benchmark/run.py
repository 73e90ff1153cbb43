#!/usr/bin/env python3
"""The benchmark of ``triangle_splatting_tpu_torch`` on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, from the root of a checkout: the
cell names a configuration (``benchmark/configs/<config>.json``) and a
traffic mix (``benchmark/traffic/<traffic>.json``, whose ``kind`` picks the
driver ``benchmark/drivers/<kind>.py``); the per-layer metrics of a traced
run are read by ``benchmark/metrics/<metric>.py``. A cell, configuration,
mix or metric is added by adding files and entries, never by editing one.

Every build and kernel cache stays inside the checkout. The last line on
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``); the numbers
that decided ``correct`` come last in it and on standard error. Without a
CUDA device (or with fewer than the cell asks for) the run exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "triangle_splatting_tpu")
PROGRAM = "triangle_splatting_tpu_torch"


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def load_spec() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        fail(f"no BENCHMARK.json at {ROOT}")
    return json.loads(path.read_text())


def cell_files(spec: dict, workload: str) -> dict:
    """The cell's entry, its configuration and traffic files (parsed) and
    the metrics it reports, by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        fail(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    confs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / confs[cell["config"]]["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    limits_path = BENCH / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}

    def here(m):
        return "workloads" not in m or workload in m["workloads"]
    return dict(cell=cell, config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in spec["end_to_end"] if here(m)],
                per_layer=[m for m in spec["per_layer"] if here(m)])


def set_cache_dirs() -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    cache = BENCH / "cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_compute")):
        os.environ[var] = str(cache / sub)


def read_metric(name: str, record: dict):
    """The value of per-layer metric ``name`` from ``benchmark/metrics/<name>.py``
    (None when it finds nothing to read)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_w():
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except Exception:
        return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides=None, spec: dict | None = None) -> dict:
    """Run one cell and return the result (without printing it). The tests
    call this with ``device="cpu"`` and ``overrides``, a function that cuts
    the cell's files to a small size; a measuring run goes through
    ``main``."""
    set_cache_dirs()
    spec = spec or load_spec()
    files = cell_files(spec, workload)
    if overrides:
        files = overrides(files)
    traffic = files["traffic"]
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    ctx = dict(workload=workload, seed=int(seed), seconds=float(seconds), trace=bool(trace),
               device=device, t_start=T_START, **files)
    out = driver.run(ctx)
    checks = out.pop("checks")
    correct = bool(out.pop("correct")) and all(
        c["value"] is not None and c["value"] == c["value"] and c["value"] <= c["limit"]
        for c in checks.values())
    if trace:
        metrics = {}
        for m in files["per_layer"]:
            v = read_metric(m["name"], out["record"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in files["end_to_end"]}
    result = dict(correct=correct, attempted=out["attempted"], failed=out["failed"],
                  metrics=metrics, device=out["device"])
    if trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["notes"] = out.get("notes", {})
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    spec = load_spec()
    cell = cell_files(spec, a.workload)["cell"]
    if not (BENCH / "drivers").is_dir() or not (ROOT / PROGRAM).is_dir():
        fail(f"this checkout lacks {PROGRAM}/ or the benchmark's drivers", 4)
    sys.path.insert(0, str(ROOT))
    set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the port on a GPU and never falls back "
             "to the CPU", 3)
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"the cell needs {cell['chips']} GPU(s), {torch.cuda.device_count()} visible", 3)
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda", spec=spec)
    bad = forbidden_modules()
    if bad:
        fail(f"the run loaded {bad}: the benchmark measures {PROGRAM} alone", 5)
    result["device"]["power_limit_w"] = power_limit_w()
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
