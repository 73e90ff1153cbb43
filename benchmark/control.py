#!/usr/bin/env python3
"""The control and the planted faults of a training cell's check.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed <n> ...]

puts the cell's plain reference in the program's place and reads the
check's numbers (loss gap, worst-leaf first-gradient gap, median-leaf
change gap, alive-rows gap) of:

- ``control``: the reference with TF32 on for its convolutions and
  products (the configurations state float32 with TF32 off, and the
  trainers turn it off), against the reference in float32;
- ``half_batch``: a step whose image loss takes half of the pixel rows and
  averages over those;
- ``altered``: a step whose render is altered where it is produced (one
  tile of the image raised by 0.05).

A render cell reads the control and ``altered`` on its sampled frames (a
frame has no batch to halve and no state to leave unchanged).

A step that returns its state unchanged reads a change gap of exactly 1
by construction and needs no run.

Each at the cell's own size, on the views and backgrounds the cell's
driver would draw, one JSON line per seed. The benchmark's own runs never
run this; it sets the upper readings of the limits (PERF.md).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FAULTS = ("control", "half_batch", "altered")


@contextmanager
def tf32(on: bool):
    import torch
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@contextmanager
def planted(ref, fault: str):
    """Break the reference module where the fault says, for one follower."""
    from benchmark.reference import losses as LS
    from benchmark.reference import tiles as TL
    saved = {}
    if fault == "half_batch":
        saved["l1"], saved["ssim"] = LS.l1, LS.ssim
        LS.l1 = lambda a, b, f=saved["l1"]: f(a[:, : a.shape[1] // 2], b[:, : b.shape[1] // 2])
        LS.ssim = lambda a, b, f=saved["ssim"]: f(a[:, : a.shape[1] // 2], b[:, : b.shape[1] // 2])
    elif fault == "altered":
        saved["render"] = TL.render

        def render(*a, f=saved["render"], **kw):
            out = f(*a, **kw)
            out[0][:, :32, :32] += 0.05
            return out
        TL.render = render
    try:
        yield
    finally:
        for k, v in saved.items():
            if k in ("l1", "ssim"):
                setattr(LS, k, v)
            else:
                TL.render = v


def follow(ref, recipe, start, steps, scene, dev, budget):
    """Run a follower over the recorded steps; returns (losses, first
    grads, masked params after, alive rows after, their keys)."""
    import torch
    from benchmark.drivers import train as D
    from benchmark.scenes.common import camera_tensors
    f = ref.Follower(recipe, start, dev, budget)
    cams = {r["name"]: r for r in scene["train"]}
    losses, g1 = [], None
    for j, s in enumerate(steps):
        rec = cams[s["view"]]
        loss, grads, _ = f.step(s["it"], camera_tensors(rec, dev), scene["gt"](rec), s["bg"])
        losses.append(loss)
        if j == 0:
            g1 = {k: v.detach().clone() for k, v in grads.items()}
        torch.cuda.synchronize() if dev.type == "cuda" else None
    keys = D._row_keys(ref, f.model.p, getattr(f.model, "s", {}))
    return losses, g1, f.masked(), f.model.alive.cpu(), keys


def render_readings(files: dict, seed: int, faults, dev) -> dict:
    """A render cell's check numbers (worst sampled frame's mean and largest
    pixel difference) of the reference with TF32 on, and of an image
    altered where it is produced, against the reference in float32."""
    import numpy as np
    import torch
    from benchmark.scenes.common import camera_tensors
    cfg, mix = files["config"], files["traffic"]
    ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    scene = importlib.import_module(f"benchmark.scenes.{cfg['scene']['generator']}").build(
        dict(cfg["scene"], model=cfg["recipe"]["model"]), seed, dev, images=False)
    poses = (list(scene["test"]) if mix.get("held_out", True) else []) + scene["orbit"](
        mix["orbit_poses"])
    rng = np.random.default_rng([seed, 3])
    sampled = sorted(rng.choice(len(poses), size=min(mix["sample_frames"], len(poses)),
                                replace=False).tolist())
    start = scene["start"]
    bg = torch.full((3,), 1.0 if mix.get("background", "white") == "white" else 0.0, device=dev)
    budget = int(mix.get("reference_chunk", 1 << 25))
    out = {f: dict(image_mae=0.0, image_max=0.0) for f in faults if f in ("control", "altered")}
    for k in sampled:
        cam = camera_tensors(poses[k], dev)
        with tf32(False):
            base = ref.render_frame(cfg["recipe"], start, cam, bg, budget)
        for fault in out:
            if fault == "control":
                with tf32(True):
                    got = ref.render_frame(cfg["recipe"], start, cam, bg, budget)
            else:
                got = base.clone()
                got[:, :32, :32] += 0.05
            d = (got - base).abs()
            out[fault]["image_mae"] = max(out[fault]["image_mae"], float(d.mean()))
            out[fault]["image_max"] = max(out[fault]["image_max"], float(d.max()))
    return out


def readings(workload: str, seed: int, faults=FAULTS, device: str = "cuda", overrides=None,
             spec=None) -> dict:
    """The check's numbers of each fault on one seed."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    from benchmark import run as R
    from benchmark.drivers import train as D
    from benchmark.drivers.compare import alive_gap, median_gap, norm_gaps
    files = R.cell_files(spec or R.load_spec(), workload)
    if overrides:
        files = overrides(files)
    cfg, mix = files["config"], files["traffic"]
    dev = torch.device(device)
    if mix["kind"] == "render":
        return render_readings(files, seed, faults, dev)
    ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    scene = importlib.import_module(f"benchmark.scenes.{cfg['scene']['generator']}").build(
        dict(cfg["scene"], model=cfg["recipe"]["model"]), seed, dev)
    recipe = D._recipe(cfg, mix, scene, D.CACHE / "runs" / f"{workload}.control", seed)
    start = D._start_arrays(scene)
    bg_rng = np.random.default_rng([seed, 2])
    kind = recipe["trainer"].get("train_background") or "random"
    order = np.random.default_rng(0).permutation(len(scene["train"]))
    steps = []
    for j in range(mix["reference_steps"]):
        bg = (torch.as_tensor(bg_rng.uniform(size=3).astype(np.float32), device=dev) if kind == "random"
              else torch.full((3,), 1.0 if kind == "white" else 0.0, device=dev))
        steps.append(dict(it=mix["start_iter"] + 1 + j, bg=bg,
                          view=sorted(scene["train"], key=lambda r: r["name"])[order[j]]["name"]))
    budget = int(mix.get("reference_chunk", 1 << 25))
    with tf32(False):
        base = follow(ref, recipe, start, steps, scene, dev, budget)
    start_ref = ref.Follower.start_masked(start, dev)
    alive0 = np.asarray(start["s.alive"]) if "s.alive" in start else \
        np.ones(next(v for k, v in start.items() if k.startswith("p.")).shape[0], bool)
    out = {}
    for fault in faults:
        t0 = time.perf_counter()
        with tf32(fault == "control"), planted(ref, fault):
            got = follow(ref, recipe, start, steps, scene, dev, budget)
        loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(got[0], base[0]))
        grad_gap = norm_gaps(got[1], base[1])[0]
        d_got = {k: got[2][k] - start_ref[k] for k in base[2]}
        d_ref = {k: base[2][k] - start_ref[k] for k in base[2]}
        change_worst, detail = norm_gaps(d_got, d_ref)
        out[fault] = dict(loss_gap=loss_gap, grad_gap=grad_gap, change_gap=median_gap(detail),
                          change_worst_leaf=change_worst,
                          alive_gap=alive_gap(got[3], base[3], alive0, got[4], base[4]),
                          seconds=time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--fault", action="append", choices=FAULTS)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for seed in a.seed:
        r = readings(a.workload, seed, tuple(a.fault or FAULTS))
        print(json.dumps(dict(workload=a.workload, seed=seed, device=torch.cuda.get_device_name(0),
                              readings=r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
