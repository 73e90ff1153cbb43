"""The training-slice driver (traffic ``kind: "train"``).

Set-up builds the configuration's scene from the seed (``benchmark/scenes``),
writes the start model where the trainer resumes from it, builds ONE trainer
through the program's ``build_trainer`` and drives it through the iteration
body of the trainer's ``_train`` loop, numbered from the mix's
``start_iter``: ``_next_batch``, ``_settings_for``, ``_train_step_dp``,
``_model_update`` and, at the recipe's ``log_interval_iter``, the loss read
and ``_resize_pair_budget``. The first ``reference_steps`` iterations are
recorded for the check (each step's loss, the first gradient as Adam's
first moment holds it, the parameters and alive rows before and after);
``warmup_steps``
more fill the loader's cache and the allocator; then the window runs the
same body for ``--seconds`` and ends on a synchronize. After the window
(and the peak memory read), the program is freed and the configuration's
plain reference follows the recorded steps from the same start, views and
backgrounds.

With ``--trace 1`` the profiler covers ``trace_steps`` steps before the
window (the window's host spans are then read on unprofiled steps), and the
work of the last traced step's frame is recounted after the window by the
reference's ``frame_counts``.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import importlib
import os
import shutil
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

from . import trace as TRACE
from .compare import alive_gap, median_gap, norm_gaps

CACHE = Path(__file__).resolve().parents[1] / "cache"
BETA1 = 0.9


def _leaves(p) -> dict:
    """A program parameter container's tensors by name."""
    return dict(p.leaves()) if hasattr(p, "leaves") else dict(p.tensors())


def _masked(tr) -> dict:
    """The program's leaves with rows that are not alive set to 0 (leaves
    whose first axis is the capacity)."""
    alive = tr.state.alive
    out = {}
    for k, v in _leaves(tr.params).items():
        if v.dim() >= 1 and v.shape[0] == alive.shape[0]:
            v = torch.where(alive.reshape((-1,) + (1,) * (v.dim() - 1)), v, torch.zeros_like(v))
        out[k] = v.detach().clone()
    return out


def _rows(prog: torch.Tensor, like) -> torch.Tensor:
    """A program leaf cut to the reference's rows (the program pads its
    capacity)."""
    return prog[:like.shape[0]] if prog.dim() and prog.shape[0] > like.shape[0] else prog


def _recipe(cfg: dict, mix: dict, scene: dict, run_dir: Path, seed: int) -> dict:
    recipe = copy.deepcopy(cfg["recipe"])
    recipe["dataset"]["local_dir"] = str(scene["root"])
    t = recipe["trainer"]
    t.update(output_dir=str(run_dir), use_tensorboard=False, initial_eval=False,
             eval_interval_iter=0, histogram_interval_iter=0, save_interval_iter=0,
             ckpt_interval_iter=0, save_iterations=[], checkpoint_iterations=[],
             save_glb_iterations=[], seed=int(seed % (2 ** 31 - 1)),
             iterations=mix["start_iter"] + 10 ** 8)
    return recipe


def _state(tr) -> dict:
    """The program's model state as a dict of tensor copies."""
    return {f.name: getattr(tr.state, f.name).detach().clone()
            for f in dataclasses.fields(tr.state) if torch.is_tensor(getattr(tr.state, f.name))}


def _place_start(cfg: dict, mix: dict, scene: dict, recipe: dict, run_dir: Path) -> None:
    """Put the scene's start model where the trainer resumes from it: a
    PLY it resumes from (``start_pointcloud``), or arrays in the checkpoint
    layout that ``_load_arrays`` hands the trainer once it is built."""
    how = cfg["start"]
    if how == "arrays":
        return
    if how == "point_cloud":
        dst = run_dir / "point_cloud" / f"{mix['start_iter']}.ply"
        dst.parent.mkdir(parents=True, exist_ok=True)
        try:
            os.link(scene["start_ply"], dst)
        except OSError:
            shutil.copyfile(scene["start_ply"], dst)
        recipe["trainer"]["start_pointcloud"] = mix["start_iter"]
    else:
        raise ValueError(f"unknown start {how!r}")


def _load_arrays(tr, cfg: dict, blob: dict, dev) -> None:
    """What the trainer's ``load_ckpt`` does with a checkpoint's blob, from
    memory: the configuration's ``from_arrays`` converter of the program
    (``convert.scaffold_from_numpy``, say) builds its containers."""
    conv = getattr(importlib.import_module("triangle_splatting_tpu_torch.convert"),
                   cfg["from_arrays"])
    tr.params, tr.state, tr.opt = conv(blob["params"], blob["state"], blob["opt"], device=str(dev))
    tr.scene_bbox = blob.get("scene_bbox")


def _start_arrays(scene: dict) -> dict:
    """The start model as flat host arrays ("p.<leaf>", "s.<field>")."""
    if "start" in scene:
        return scene["start"]
    return {k: np.asarray(v) for k, v in np.load(scene["start_npz"]).items()}


def _row_keys(ref, leaves: dict, state: dict):
    """The reference's keys of a model's rows (an anchor's voxel), where
    it has any."""
    fn = getattr(ref, "row_keys", None)
    return None if fn is None else fn(leaves, state)


def run(ctx: dict) -> dict:
    cfg, mix = ctx["config"], ctx["traffic"]
    seed, seconds, traced = ctx["seed"], ctx["seconds"], ctx["trace"]
    dev = torch.device(ctx["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    phase = {}
    mark_t = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase[name] = now - mark_t[0]
        mark_t[0] = now
    ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    scene = importlib.import_module(f"benchmark.scenes.{cfg['scene']['generator']}").build(
        dict(cfg["scene"], model=cfg["recipe"]["model"]), seed, dev)
    lap("scene")
    run_dir = CACHE / "runs" / ctx["workload"]
    shutil.rmtree(run_dir, ignore_errors=True)
    recipe = _recipe(cfg, mix, scene, run_dir, seed)
    _place_start(cfg, mix, scene, recipe, run_dir)

    from triangle_splatting_tpu_torch.trainers import build_trainer
    from triangle_splatting_tpu_torch.utils.config import dict_to_config
    tr = build_trainer(dict_to_config(copy.deepcopy(recipe)), log_file=False, device=str(dev))
    if cfg["start"] == "arrays":
        _load_arrays(tr, cfg, scene.pop("start_blob"), dev)
    tr._init_model()
    lap("trainer")

    t = recipe["trainer"]
    bg_kind = t.get("train_background") or "random"
    bg_rng = np.random.default_rng([seed, 2])
    log_every = t.get("log_interval_iter") or 0
    n_off = getattr(tr.model_cfg, "n_offsets", 1)
    spans = {k: [] for k in ("data", "step", "update", "log")}
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def background():
        if bg_kind == "random":
            return torch.as_tensor(bg_rng.uniform(size=3).astype(np.float32), device=dev)
        return torch.full((3,), 1.0 if bg_kind == "white" else 0.0, device=dev)

    def body(it: int, record: bool, annotate: bool):
        mark = (lambda n: torch.profiler.record_function(f"bench.{n}")) if annotate else \
            (lambda n: nullcontext())
        c0 = time.perf_counter()
        with mark("data"):
            camera, local_views, idle = tr._next_batch()
        c1 = time.perf_counter()
        with mark("step"):
            settings = tr._settings_for(camera)
            bg = background()
            n_prim = tr.params.capacity * n_off
            extra = {}
            if hasattr(tr, "_refresh_nearest"):
                tr._refresh_nearest(it)
                extra["nearest_idx"] = tr._nearest_idx
            tr.params, tr.opt, tr.state, loss, aux = tr._train_step_dp(
                settings, tr.params, tr.opt, tr.state, local_views, tr._loss_weights(it),
                tr._lrs(it), bg, it, idle_camera=idle, **extra)
            tr._note_overflow(aux["overflow"])
        c2 = time.perf_counter()
        with mark("update"):
            tr._model_update(it)
        c3 = time.perf_counter()
        if log_every and it % log_every == 0:
            with mark("log"):
                float(loss)
                tr._resize_pair_budget(int(aux["num_pairs"]), n_prim, bool(aux["overflow"]))
        c4 = time.perf_counter()
        if record:
            for k, a, b in (("data", c0, c1), ("step", c1, c2), ("update", c2, c3), ("log", c3, c4)):
                spans[k].append((b - a) * 1e3)
        return camera, bg, loss

    # the steps the reference follows: the window's own body and feed
    start_arrays = _start_arrays(scene)
    n0 = start_arrays[next(k for k in start_arrays if k.startswith("p."))].shape[0]
    prog0 = _leaves(tr.params)
    start_gap = max(float((_rows(prog0[k[2:]], v).detach().cpu() - torch.as_tensor(v)).abs().max())
                    for k, v in start_arrays.items() if k.startswith("p."))
    alive0 = tr.state.alive.cpu()
    start_alive = torch.as_tensor(start_arrays["s.alive"]) if "s.alive" in start_arrays else \
        torch.ones(n0, dtype=torch.bool)
    start_gap = max(start_gap, float(alive0[n0:].sum()),
                    float((alive0[:n0] != start_alive).sum()))
    before = _masked(tr)
    steps = []
    it = mix["start_iter"]
    for j in range(mix["reference_steps"]):
        it += 1
        camera, bg, loss = body(it, record=False, annotate=False)
        steps.append(dict(it=it, view=camera.image_name, bg=bg.clone(), loss=float(loss)))
        if j == 0:
            grad1 = {k: (m / (1.0 - BETA1)).detach().clone() for k, m in _leaves(tr.opt.m).items()}
    after = _masked(tr)
    alive_after = tr.state.alive.cpu()
    keys_after = _row_keys(ref, _leaves(tr.params), _state(tr))
    lap("reference_steps")
    fired = [list(x) for x in getattr(tr, "prune_history", [])] + \
        [dict(x) for x in getattr(tr, "anchor_history", [])]
    for _ in range(mix["warmup_steps"]):
        it += 1
        body(it, record=False, annotate=False)
    sync()
    lap("warmup")

    # the traced steps come first, under the profiler; the host spans and
    # the rate are read on the untraced steps of the window after them
    red, snap, n_traced = None, None, 0
    if traced:
        prof = TRACE.start()
        win = torch.profiler.record_function("bench.window")
        win.__enter__()
        tw0 = time.perf_counter()
        for _ in range(mix["trace_steps"]):
            it += 1
            camera, _, _ = body(it, record=False, annotate=True)
        snap = dict(leaves={k: v.detach().clone() for k, v in _leaves(tr.params).items()},
                    state=_state(tr), view=camera.image_name)
        sync()
        tw1 = time.perf_counter()
        win.__exit__(None, None, None)
        red = TRACE.finish(prof, CACHE / "runs" / f"{ctx['workload']}.trace.json")
        n_traced = mix["trace_steps"]
        sync()
    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_start"]
    n_steps = 0
    while True:
        it += 1
        body(it, record=True, annotate=False)
        n_steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    views = n_steps * (getattr(tr, "_dp_n", 1) or 1)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    device = dict(platform="gpu" if cuda else "cpu",
                  kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                  count=1, memory_peak_bytes=int(peak))

    # free the program, then follow its recorded steps with the reference
    budget = int(mix.get("reference_chunk", 1 << 25))
    tr.dataset.close()
    del tr, prog0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    lap("window")
    follower = ref.Follower(recipe, start_arrays, dev, budget)
    cams = {r["name"]: r for r in scene["train"]}
    from benchmark.scenes.common import camera_tensors
    ref_losses, ref_fired = [], []
    for j, s in enumerate(steps):
        rec = cams[s["view"]]
        loss_r, grads_r, fired_r = follower.step(s["it"], camera_tensors(rec, dev), scene["gt"](rec),
                                                 s["bg"])
        ref_losses.append(loss_r)
        ref_fired.append(fired_r)
        if j == 0:
            grad1_ref = {k: g.detach().clone() for k, g in grads_r.items()}
    masked_ref = follower.masked()
    lap("reference")
    start_ref = follower.start_masked(start_arrays, dev)

    loss_gap = max(abs(p["loss"] - r) / max(abs(r), 1e-30) for p, r in zip(steps, ref_losses))
    missing = [k for k, v in grad1.items() if v.numel() and k not in grad1_ref]
    if missing:
        raise RuntimeError(f"the reference has no leaf {missing}")
    grad_gap, grad_detail = norm_gaps({k: _rows(grad1[k], v) for k, v in grad1_ref.items()},
                                      grad1_ref)
    d_prog = {k: _rows(after[k], v) - _rows(before[k], v) for k, v in masked_ref.items()}
    d_ref = {k: masked_ref[k] - start_ref[k] for k in masked_ref}
    change_worst, change_detail = norm_gaps(d_prog, d_ref)
    keys_ref = _row_keys(ref, follower.model.p, getattr(follower.model, "s", {}))
    lim = ctx["limits"]
    checks = {
        "start_gap": dict(value=start_gap, limit=0.0),
        "loss_gap": dict(value=loss_gap, limit=lim.get("loss_gap", 0.0)),
        "grad_gap": dict(value=grad_gap, limit=lim.get("grad_gap", 0.0)),
        "change_gap": dict(value=median_gap(change_detail), limit=lim.get("change_gap", 0.0)),
        "alive_gap": dict(value=alive_gap(alive_after, follower.model.alive, start_alive, keys_after,
                                          keys_ref), limit=lim.get("alive_gap", 0.0)),
    }
    notes = dict(losses=[s["loss"] for s in steps], ref_losses=ref_losses, fired_program=fired,
                 change_worst_leaf=change_worst,
                 fired_reference=ref_fired, grad_leaves=grad_detail, change_leaves=change_detail,
                 window_steps=n_steps, phase_s=phase, first_iter=mix["start_iter"] + 1, last_iter=it)
    out = dict(correct=True, attempted=len(steps), failed=0, device=device, checks=checks,
               notes=notes, end_to_end=dict(train_views_per_s=views / window_s, setup_s=setup_s))
    if traced:
        rec = cams[snap["view"]]
        counts = ref.frame_counts(recipe, snap["leaves"], snap["state"], camera_tensors(rec, dev),
                                  budget)
        device.update(busy_s=red["busy_s"], window_s=tw1 - tw0)
        out["record"] = dict(kind="train", spans=spans, steps=n_steps, wall_s=window_s,
                             traced_steps=n_traced, window_s=tw1 - tw0, trace=red, counts=counts)
        out["breakdown"] = TRACE.breakdown(red)
        notes["counts"] = counts
        lap("counts")
    return out
