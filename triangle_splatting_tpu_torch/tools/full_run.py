"""Full-length training run at reference scale (the port's twin of the
repository's ``tools/full_run.py``).

Replays ``config/NerfSynthetic_VanillaTS.yaml`` on a synthetic scene:
direct init from a 100k-point cloud (the recipe trains a fixed count),
30k iterations at 800x800, SH up a degree at 4k / 10k / 16k.

``--adc`` runs the long-horizon densification rehearsal instead: a
20k-point init with the smoke recipe's statistic / densification /
opacity pruning blocks at the reference cadence (densify every 500 from
500 to 3/4 of ``--iters``, prune every 500 from 1,000), SH 3, the densify
threshold from ``--grad_threshold`` (each densify log line prints the
measured grad-stat quantiles to set it from); the capacity grows as the
model fills it.

``--mesh --scene surface`` runs config/NerfSynthetic_VanillaTS_mesh.yaml
on an opaque surface with every iteration window scaled by
``--iters`` / 60,000, exports the GLB and scores it: chamfer and F-score
against the dataset's exact GT soup (``gt_scene.npz``) and the test-view
PSNR of the GLB through the independent ray tracer (``ops/raytrace.py``).

Usage (on the GPU):
    python -m triangle_splatting_tpu_torch.tools.full_run --root runs/full
    python -m triangle_splatting_tpu_torch.tools.full_run --adc --iters 10000 --root runs/adc
    python -m triangle_splatting_tpu_torch.tools.full_run --mesh --scene surface --root runs/mesh
``--ckpt_every N`` writes a checkpoint every N iterations, ``--resume``
continues from the newest one, ``--cpu`` runs the plain kernel versions on
the CPU (scaled-down rehearsals).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from pathlib import Path

CONFIG_DIR = Path(__file__).resolve().parents[2] / "config"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="runs/full_run")
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--iters", type=int, default=30_000)
    ap.add_argument("--n_tri", type=int, default=100_000,
                    help="GT triangles in the synthetic scene")
    ap.add_argument("--views", type=int, default=100)
    ap.add_argument("--init_points", type=int, default=100_000)
    ap.add_argument("--adc", action="store_true",
                    help="ADC rehearsal: 20k init + densify/prune enabled")
    ap.add_argument("--model", default="ts", choices=["ts", "gs"],
                    help="--adc primitive: ts = VanillaTS triangles, gs = VanillaGS Gaussians")
    ap.add_argument("--mesh", action="store_true",
                    help="mesh/solidify rehearsal: NerfSynthetic_VanillaTS_mesh.yaml with "
                         "its windows scaled to --iters (reference: 60k total, solidify "
                         "20k-40k), GLB export and geometry metrics")
    ap.add_argument("--grad_threshold", type=float, default=1.5e-4,
                    help="--adc densify threshold (the densify log prints the observed "
                         "grad-stat quantiles to set this from)")
    ap.add_argument("--gt", default="cuda", choices=["cuda", "oracle"],
                    help="rasterizer that renders the dataset's GT images: the kernel "
                         "pipeline or the dense oracle (each gets its own dataset dir)")
    ap.add_argument("--geo_samples", type=int, default=100_000,
                    help="--mesh: surface samples per side for chamfer/F-score")
    ap.add_argument("--scene", default="soup", choices=["soup", "surface"],
                    help="GT scene: 'soup' = floating semi-transparent random triangles, "
                         "'surface' = a bumpy opaque closed surface (the mesh target)")
    ap.add_argument("--ckpt_every", type=int, default=5000,
                    help="checkpoint cadence (0 disables)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest checkpoint in --root/out")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain kernel versions)")
    return ap.parse_args(argv)


def scale_mesh_config(cfg, iters: int, n_tri: int):
    """Scale every iteration window of the mesh recipe by iters / 60,000
    (its total; solidify 20k-40k, lr decay over 20k) so a shorter run keeps
    its phase structure, and set the contribution-pruning target the yaml
    leaves null to a tenth of the GT count (at least 2,000). Returns the
    scaling function."""
    sc = iters / 60_000.0

    def s(v):
        return max(1, int(round(v * sc)))
    for name in ("vertex", "opacity", "f_dc", "f_rest", "color_affine"):
        opt = getattr(cfg.model.optimizer, name)
        opt.delay_steps = s(opt.delay_steps)
        opt.max_steps = s(opt.max_steps)
    mu = cfg.model.model_update
    mu.statistic.start_iter = s(mu.statistic.start_iter)
    mu.statistic.end_iter = s(mu.statistic.end_iter)
    for blk in (mu.scale_pruning, mu.contribution_pruning):
        blk.start_iter = s(blk.start_iter)
        blk.end_iter = s(blk.end_iter)
    mu.gamma_schedule.start_iter = s(mu.gamma_schedule.start_iter)
    mu.gamma_schedule.end_iter = s(mu.gamma_schedule.end_iter)
    mu.sh_schedule.one_up_iters = [s(v) for v in mu.sh_schedule.one_up_iters]
    mu.contribution_pruning.target_point_num = max(2000, n_tri // 10)
    return s


def adc_config(data_dir, out_dir, iters: int, grad_threshold: float, model: str = "ts"):
    """The smoke recipe at the reference's densification cadence (every 500
    from 500 to 3/4 of the run, at least 10 views; opacity pruning every
    500 from 1,000), the densify threshold ``grad_threshold`` -> 2/3 of it,
    SH 3 with a band at 1/8, 1/4 and 1/2 of the run, eval every 2,000 and a
    log every 250."""
    from ..trainers.smoke import make_smoke_config
    cfg = make_smoke_config(data_dir, out_dir, iters, densify=True, model=model)
    mu = cfg.model.model_update
    mu.densification.start_iter = 500
    mu.densification.end_iter = iters * 3 // 4
    mu.densification.interval_iter = 500
    mu.densification.min_view_count = 10
    mu.opacity_pruning.start_iter = 1000
    mu.opacity_pruning.interval_iter = 500
    # the smoke thresholds (0.0006 -> 0.0003) never fire at 800^2
    mu.densification.grad_threshold_init = grad_threshold
    mu.densification.grad_threshold_final = grad_threshold * 2 / 3
    cfg.trainer.eval_interval_iter = 2000
    cfg.trainer.log_interval_iter = 250
    cfg.model.max_sh_degree = 3
    mu.sh_schedule.one_up_iters = [iters // 8, iters // 4, iters // 2]
    return cfg


def build_config(args, data_dir: str):
    """The run's config for the mode of ``args``."""
    from ..utils.config import loadConfig
    out_dir = os.path.join(args.root, "out")
    if args.mesh:
        cfg = loadConfig(CONFIG_DIR / "NerfSynthetic_VanillaTS_mesh.yaml")
        s = scale_mesh_config(cfg, args.iters, args.n_tri)
        cfg.trainer.save_iterations = [s(20_000), args.iters]
        cfg.trainer.checkpoint_iterations = [args.iters]
        cfg.trainer.save_glb_iterations = [args.iters]
    elif args.adc:
        cfg = adc_config(data_dir, out_dir, args.iters, args.grad_threshold, args.model)
    else:
        cfg = loadConfig(CONFIG_DIR / "NerfSynthetic_VanillaTS.yaml")
    if args.mesh or not args.adc:
        cfg.dataset.local_dir = data_dir
        cfg.dataset.num_workers = 2
        cfg.trainer.output_dir = out_dir
        cfg.trainer.iterations = args.iters
        cfg.trainer.use_tensorboard = False
        cfg.trainer.seed = 0
    if args.ckpt_every:
        cfg.trainer.ckpt_interval_iter = args.ckpt_every
    if args.resume:
        ckpts = sorted((int(os.path.basename(p).split(".")[0]) for p in
                        glob.glob(os.path.join(out_dir, "ckpt", "*.ckpt"))), reverse=True)
        if ckpts:
            cfg.trainer.start_checkpoint = ckpts[0]
            cfg.trainer.clean_output_dir = False   # keep the ckpt dir
            print(f"[full_run] resuming from iteration {ckpts[0]}", flush=True)
        else:
            print("[full_run] --resume: no checkpoint found, starting fresh", flush=True)
    return cfg


def build_data(args, device) -> str:
    """The synthetic dataset of ``args`` (built once per GT renderer and
    scene kind under ``--root``). Returns its directory."""
    from ..utils.testing import build_synthetic_nerf_dataset
    suffix = "" if args.gt == "cuda" else f"_{args.gt}"
    if args.scene != "soup":
        suffix += f"_{args.scene}"
    data_dir = os.path.join(args.root, "data" + suffix)
    if not os.path.exists(os.path.join(data_dir, "transforms_train.json")):
        print(f"[full_run] building synthetic dataset ({args.views} views @ {args.res}^2, "
              f"{args.n_tri} GT triangles, gt={args.gt}, scene={args.scene}) in {data_dir}",
              flush=True)
        t0 = time.time()
        build_synthetic_nerf_dataset(
            data_dir, res=args.res, n_tri=args.n_tri, n_train=args.views, n_test=8,
            impl=args.gt, scene_kind=args.scene,
            pcd_points=(20_000 if args.adc else args.init_points), pcd_noise=0.05,
            device=device)
        print(f"[full_run] dataset built in {time.time() - t0:.0f}s", flush=True)
    return data_dir


def run(args: argparse.Namespace):
    """Build the data, train, score. Returns ``(trainer, record)``."""
    from ..trainers import build_trainer
    device = "cpu" if args.cpu else "cuda"
    data_dir = build_data(args, device)
    cfg = build_config(args, data_dir)
    trainer = build_trainer(cfg, log_file=True, device=device)
    trainer._init_model()
    psnr0 = float(trainer._evaluate(0))
    print(f"[full_run] init PSNR {psnr0:.2f}, alive {int(trainer.state.alive.sum())}",
          flush=True)
    t0 = time.time()
    trainer.train()
    wall = time.time() - t0
    psnr1 = float(trainer._evaluate(args.iters))
    extra = mesh_endpoint_metrics(trainer, data_dir, args) if args.mesh else {}
    record = {
        "metric": ("full_run_mesh" if args.mesh
                   else "full_run_adc" if args.adc else "full_run_30k"),
        "res": args.res, "iters": args.iters, "gt_triangles": args.n_tri,
        "psnr_init": round(psnr0, 2), "psnr_final": round(psnr1, 2),
        "alive_triangles": int(trainer.state.alive.sum()),
        "capacity": int(trainer.state.alive.shape[0]),
        "wall_s": round(wall, 1),
        "ms_per_step_incl_compile": round(wall / args.iters * 1000.0, 2),
        "gt_impl": args.gt, **extra}
    return trainer, record


def mesh_endpoint_metrics(trainer, data_dir, args) -> dict:
    """Score the exported GLB geometrically (chamfer and F-score against
    the GT soup the images were rendered from) and photometrically through
    the independent Moeller-Trumbore ray tracer (no code shared with the
    splatting rasterizers, so the score cannot inherit a forward fault of
    theirs)."""
    import numpy as np
    import torch

    from ..models.mesh_metrics import mesh_geometry_scores
    from ..models.raw_triangle import RawTriangle
    from ..ops.raytrace import raytrace_soup
    from ..ops.sh import SH2RGB
    from ..trainers import losses as L

    glb_path = os.path.join(args.root, "out", "glb", f"{args.iters}.glb")
    if not os.path.exists(glb_path):
        trainer.saveGLB(glb_path)
    raw = RawTriangle(glb_path=glb_path)
    gt = np.load(os.path.join(data_dir, "gt_scene.npz"))
    print(f"[full_run] geometry metrics: {len(raw)} exported vs "
          f"{gt['vertex'].shape[0]} GT triangles", flush=True)
    geo = mesh_geometry_scores(raw.vertex, gt["vertex"], n_samples=args.geo_samples,
                               tau=0.05, block=4096, device=trainer.device)
    dev = trainer.device
    cols = torch.as_tensor(np.clip(SH2RGB(raw.shs[:, :3]), 0, 1)).to(dev)
    verts = torch.as_tensor(raw.vertex).to(dev)
    cams = list(trainer.dataset.getTestDataset())
    settings = trainer._settings_for(cams[0])
    rt = []
    for cam in cams:
        out = raytrace_soup(verts, cols, cam, settings, background=torch.ones(3))
        rt.append(float(L.psnr(out["render"].clamp(0, 1), cam.gt_image)))
    print(f"[full_run] raytrace PSNR per view: {[round(v, 2) for v in rt]}", flush=True)
    return {"geometry": {k: round(v, 4) for k, v in geo.items()},
            "raytrace_psnr": round(float(np.mean(rt)), 2)}


def main(argv=None):
    _, record = run(parse_args(argv))
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
