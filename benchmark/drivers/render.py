"""The render-loop driver (traffic ``kind: "render"``).

One client in a closed loop, as a viewer or a tour renders: the held-out
views of the configuration's scene and then ``orbit_poses`` novel poses on
its capture circle, in order and repeating. Each frame is the program's
model facade ``forward(camera)`` and ends when its image is on the host.

Set-up builds the scene from the seed, loads the start model into the
facade (the program's checkpoint layout through ``convert``), and renders
every pose once. The window renders for ``--seconds``; each frame is timed
on the host clock from the call to its image on the host. The images of
``sample_frames`` poses drawn from the seed are kept (their first frame in
the window), and after the window the configuration's plain reference
renders the same poses from the same start arrays for the check.

With ``--trace 1`` the profiler covers ``trace_frames`` frames before the
window, and the work of a frame is counted by the reference's
``render_counts``.
"""

from __future__ import annotations

import gc
import importlib
import time

import numpy as np
import torch

from . import trace as TRACE
from .train import CACHE


def _camera(rec: dict, device):
    """The program's camera of a pose record (COLMAP convention)."""
    import math
    from triangle_splatting_tpu_torch.utils.camera import Camera
    from benchmark.scenes.common import qvec2rotmat
    W, H, fx = rec["width"], rec["height"], rec["fx"]
    return Camera.create(R=qvec2rotmat(np.asarray(rec["q"], np.float64)).T,
                         T=np.asarray(rec["t"], np.float64), fovx=2 * math.atan(W / (2 * fx)),
                         fovy=2 * math.atan(H / (2 * fx)), image_width=W, image_height=H,
                         image_name=rec["name"], device=device)


def _p95(xs: list) -> float:
    """The 95th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(xs, np.float64), 95))


def run(ctx: dict) -> dict:
    cfg, mix = ctx["config"], ctx["traffic"]
    seed, seconds, traced = ctx["seed"], ctx["seconds"], ctx["trace"]
    dev = torch.device(ctx["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    phase, mark_t = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase[name] = now - mark_t[0]
        mark_t[0] = now
    ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    scene = importlib.import_module(f"benchmark.scenes.{cfg['scene']['generator']}").build(
        dict(cfg["scene"], model=cfg["recipe"]["model"]), seed, dev, images=False)
    poses = (list(scene["test"]) if mix.get("held_out", True) else []) + scene["orbit"](
        mix["orbit_poses"])
    recipe = cfg["recipe"]
    lap("scene")

    from triangle_splatting_tpu_torch.convert import scaffold_from_numpy
    from triangle_splatting_tpu_torch.models.facade import ScaffoldGSModel
    from triangle_splatting_tpu_torch.utils.config import dict_to_config
    model = ScaffoldGSModel(dict_to_config(recipe["model"]), device=str(dev))
    blob = scene.pop("start_blob")
    model.params, model.state, _ = scaffold_from_numpy(blob["params"], blob["state"], None,
                                                       device=str(dev))
    del blob
    bg_kind = mix.get("background", "white")
    background = torch.full((3,), 1.0 if bg_kind == "white" else 0.0, device=dev)
    cams = [_camera(r, dev) for r in poses]
    rng = np.random.default_rng([seed, 3])
    sampled = sorted(rng.choice(len(poses), size=min(mix["sample_frames"], len(poses)),
                                replace=False).tolist())

    def frame(cam):
        out = model.forward(cam, background)
        return out["render"].cpu()

    lap("model")
    for cam in cams:                      # every pose once: allocator and kernels warm
        frame(cam)
    sync()
    lap("warmup")

    red, n_traced = None, 0
    if traced:
        prof = TRACE.start()
        win = torch.profiler.record_function("bench.window")
        win.__enter__()
        tw0 = time.perf_counter()
        for i in range(mix["trace_frames"]):
            with torch.profiler.record_function("bench.frame"):
                frame(cams[i % len(cams)])
        sync()
        tw1 = time.perf_counter()
        win.__exit__(None, None, None)
        red = TRACE.finish(prof, CACHE / "runs" / f"{ctx['workload']}.trace.json")
        n_traced = mix["trace_frames"]

    lat, kept = [], {}
    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_start"]
    i = 0
    while True:
        k = i % len(cams)
        c0 = time.perf_counter()
        img = frame(cams[k])
        lat.append((time.perf_counter() - c0) * 1e3)
        if k in sampled and k not in kept:
            kept[k] = img
        i += 1
        if time.perf_counter() - t0 >= seconds and len(kept) == len(sampled):
            break
    window_s = time.perf_counter() - t0
    mark_t[0] = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    device = dict(platform="gpu" if cuda else "cpu",
                  kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                  count=1, memory_peak_bytes=int(peak))

    # free the program; the reference renders the sampled poses
    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from benchmark.scenes.common import camera_tensors
    start = scene["start"]
    budget = int(mix.get("reference_chunk", 1 << 25))
    mae, worst = 0.0, 0.0
    for k in sampled:
        want = ref.render_frame(recipe, start, camera_tensors(poses[k], dev), background, budget)
        d = (kept[k].to(dev) - want).abs()
        mae = max(mae, float(d.mean()))
        worst = max(worst, float(d.max()))
    lap("reference")
    lim = ctx["limits"]
    checks = {"image_mae": dict(value=mae, limit=lim.get("image_mae", 0.0)),
              "image_max": dict(value=worst, limit=lim.get("image_max", 0.0))}
    by_pose = [lat[j::len(cams)] for j in range(len(cams))]
    notes = dict(frames=i, sampled=[poses[k]["name"] for k in sampled],
                 p50_ms=float(np.percentile(lat, 50)), window_s=window_s, phase_s=phase,
                 pose_ms=[float(np.mean(x)) if x else None for x in by_pose],
                 pose_max_ms=[float(np.max(x)) if x else None for x in by_pose])
    out = dict(correct=True, attempted=len(sampled), failed=0, device=device, checks=checks,
               notes=notes, end_to_end=dict(render_ms_p95=_p95(lat), setup_s=setup_s))
    if traced:
        counts = ref.render_counts(recipe, start, camera_tensors(poses[(n_traced - 1) % len(poses)],
                                                                 dev), budget)
        device.update(busy_s=red["busy_s"], window_s=tw1 - tw0)
        out["record"] = dict(kind="render", frames=i, wall_s=window_s, traced_frames=n_traced,
                             window_s=tw1 - tw0, trace=red, counts=counts, latency_ms=lat)
        out["breakdown"] = TRACE.breakdown(red)
        notes["counts"] = counts
    return out
