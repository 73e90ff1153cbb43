"""Self-contained training smoke: synthetic scene -> overfit -> PSNR climbs
(port of ``triangle_splatting_tpu/trainers/smoke.py``).

``python -m triangle_splatting_tpu_torch.trainers.smoke [--res 400] [--iters 400]
[--mesh | --model gs | --model scaffold]``

Builds a NeRF-Synthetic-format dataset on disk by rendering a known random
triangle scene with the port's own rasterizer, then runs the whole trainer
loop (config -> dataset -> model init -> train steps -> densification and
opacity pruning -> eval -> PLY / checkpoint IO) and reports the test-view
PSNR before and after and the wall-clock per step. ``--mesh`` runs the
solidify recipe (3D rasterizer, gamma 1 -> 50, STE, GLB export), ``--model
gs`` the VanillaGS Gaussians, ``--model scaffold`` the ScaffoldGS anchors
and MLP heads (anchor growth and pruning instead of densification). On the GPU by default; ``--device cpu``
runs the plain kernel versions (the quick check: ``--res 48 --iters 80
--n_tri 120 --views 6 --impl oracle --device cpu``).

Prints ONE JSON line at the end with psnr_init / psnr_final /
ms_per_step_incl_compile; the exit code is 0 only if the PSNR climbed by
``--min-gain`` dB. ``--dp`` raises ``NotImplementedError``: data
parallelism is not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def make_smoke_config(root, out_dir, iters: int, densify: bool = True,
                      mesh: bool = False, model: str = "ts"):
    """The smoke recipe (the JAX function's config for the same
    arguments). ``mesh=True`` switches to the solidify pipeline: 3D
    rasterizer, gamma annealed 1->50 over the middle half, opacity STE +
    two-phase opacity regularization, GLB export at the end (the
    NerfSynthetic_VanillaTS_mesh recipe at smoke scale). ``model="gs"``
    trains the VanillaGS Gaussian baseline; ``model="scaffold"`` the
    ScaffoldGS anchors + MLPs model (with ``densify`` its anchor update)."""
    from ..utils.config import dict_to_config
    if model != "ts" and mesh:
        raise ValueError("mesh/solidify is a triangle-model pipeline")
    if model == "scaffold":
        lr = lambda v: {"v_init": v, "v_final": v, "max_steps": iters}  # noqa: E731
        return dict_to_config({
            "dataset": {"type": "NerfSynthetic", "local_dir": str(root),
                        "background": "white", "use_alpha_mask": False,
                        "num_workers": 2, "pcd_path": "point_cloud.ply",
                        "hold_test_set": True},
            "model": {
                "feat_dim": 16, "hidden_dim": 32, "n_offsets": 5,
                "voxel_size": 0.1, "max_offset_scale": 1.0,
                "max_scaling_scale": 1.0, "capacity_factor": 4.0,
                "optimizer": {
                    "anchor": lr(0.0001), "anchor_feat": lr(0.05),
                    "mlp_offset": lr(0.01), "mlp_opacity": lr(0.01),
                    "mlp_cov": lr(0.01), "mlp_color": lr(0.01),
                    "mlp_scaling": lr(0.01),
                },
                **({"anchor_update": {
                    "start_iter": iters // 8, "end_iter": iters,
                    "interval_iter": max(50, iters // 8),
                    "grad_threshold_init": 0.0002,
                    "grad_threshold_final": 0.0002,
                    "opacity_threshold_init": 0.005,
                    "opacity_threshold_final": 0.005,
                    "grad_min_view_count": 1, "opacity_min_view_count": 1,
                    "update_depth": 2, "update_init_factor": 4,
                    "update_hierachy_factor": 4,
                }} if densify else {}),
            },
            "trainer": {
                "type": "ScaffoldGS",
                "output_dir": str(out_dir), "iterations": iters,
                "initial_eval": False,
                "log_interval_iter": max(50, iters // 8),
                "eval_interval_iter": 0, "w_ssim": 0.2,
                "w_scaling_reg": 0.01, "w_opacity_reg": 0.01,
                "save_iterations": [iters],
                "checkpoint_iterations": [iters],
                "train_background": "white", "eval_background": "white",
                "use_tensorboard": False, "seed": 0,
            },
        })
    model_update = {"sh_schedule": {"one_up_iters": [iters // 4]}}
    if densify:
        model_update.update({
            "statistic": {"start_iter": 0, "end_iter": iters},
            "densification": {
                "start_iter": iters // 8, "end_iter": iters * 3 // 4,
                "interval_iter": max(50, iters // 8),
                "grad_threshold_init": 0.0006, "grad_threshold_final": 0.0003,
                "min_view_count": 2, "split_scale_threshold": 10.0,
            },
            "opacity_pruning": {
                "start_iter": iters // 4, "end_iter": iters,
                "hold_iter": iters, "interval_iter": max(50, iters // 8),
                "opacity_threshold_init": 0.005,
                "opacity_threshold_final": 0.005,
            },
        })
    if mesh:
        model_update["gamma_schedule"] = {
            "start_iter": iters // 4, "end_iter": iters * 3 // 4,
            "gamma_init": 1.0, "gamma_final": 50.0}
    if model == "gs":
        optimizer = {
            "xyz": {"v_init": 0.002, "v_final": 0.0002, "max_steps": iters},
            "scaling": {"v_init": 0.005, "v_final": 0.005, "max_steps": iters},
            "rotation": {"v_init": 0.001, "v_final": 0.001, "max_steps": iters},
            "opacity": {"v_init": 0.05, "v_final": 0.02, "max_steps": iters},
            "f_dc": {"v_init": 0.02, "v_final": 0.005, "max_steps": iters},
            "f_rest": {"v_init": 0.001, "v_final": 0.001, "max_steps": iters},
        }
    else:
        optimizer = {
            "vertex": {"v_init": 0.002, "v_final": 0.0002, "max_steps": iters},
            "opacity": {"v_init": 0.05, "v_final": 0.02, "max_steps": iters},
            "f_dc": {"v_init": 0.02, "v_final": 0.005, "max_steps": iters},
            "f_rest": {"v_init": 0.001, "v_final": 0.001, "max_steps": iters},
        }
    return dict_to_config({
        "dataset": {"type": "NerfSynthetic", "local_dir": str(root),
                    "background": "white", "use_alpha_mask": False,
                    "num_workers": 2, "pcd_path": "point_cloud.ply",
                    "hold_test_set": True},
        "model": {
            "max_sh_degree": 1,
            "rasterizer_type": "3D" if mesh else "2D",
            **({"ste_threshold": 0.3, "gamma_rescale": True} if mesh else {}),
            "pairs_per_triangle": 16,
            "sampling": {"sample_method": "direct", "init_opacity": 0.3},
            "optimizer": optimizer,
            "model_update": model_update,
        },
        "trainer": {
            "type": "VanillaGS" if model == "gs" else "VanillaTS",
            "output_dir": str(out_dir), "iterations": iters,
            "initial_eval": False, "log_interval_iter": max(50, iters // 8),
            "eval_interval_iter": 0, "histogram_interval_iter": 0,
            "save_iterations": [iters], "checkpoint_iterations": [iters],
            **({"save_glb_iterations": [iters],
                "w_opacity_reg": {
                    "quad_reg": 0.01, "linear_reg": 0.01,
                    "quad_start_iter": iters // 4,
                    "linear_start_iter": iters // 2}} if mesh else {}),
            "train_background": "white", "eval_background": "white",
            "w_ssim": 0.2, "use_tensorboard": False, "seed": 0,
        },
    })


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=400)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--n_tri", type=int, default=800)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--root", default=None,
                    help="dataset/output dir (default: a temp dir)")
    ap.add_argument("--impl", default="cuda", choices=["cuda", "oracle"],
                    help="renderer of the GT images and of training: the kernel "
                         "pipeline or the dense oracle")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-densify", action="store_true")
    ap.add_argument("--mesh", action="store_true",
                    help="solidify pipeline: 3D rasterizer, gamma anneal "
                         "1->50, STE, GLB export")
    ap.add_argument("--model", default="ts", choices=["ts", "gs", "scaffold"],
                    help="ts = VanillaTS triangles, gs = VanillaGS Gaussians, "
                         "scaffold = ScaffoldGS anchors + MLPs")
    ap.add_argument("--min-gain", type=float, default=2.0,
                    help="required PSNR gain (dB) for exit code 0")
    ap.add_argument("--dp", type=int, default=0,
                    help="trainer.data_parallel (not ported)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace):
    """Build the dataset, train, and return ``(trainer, record)``: the
    trained trainer and the JSON record ``main`` prints."""
    if args.dp:
        raise NotImplementedError(
            "smoke --dp (trainer.data_parallel) is not ported to "
            "triangle_splatting_tpu_torch yet")

    from ..utils.testing import build_synthetic_nerf_dataset
    from . import build_trainer

    root = args.root or tempfile.mkdtemp(prefix="ts_smoke_")
    data_dir = f"{root}/data"
    cfg = make_smoke_config(data_dir, f"{root}/out", args.iters,
                            densify=not args.no_densify, mesh=args.mesh,
                            model=args.model)
    print(f"[smoke] building synthetic dataset ({args.views} views @ "
          f"{args.res}x{args.res}, {args.n_tri} GT triangles) in {data_dir}", flush=True)
    build_synthetic_nerf_dataset(
        data_dir, res=args.res, n_tri=args.n_tri, n_train=args.views,
        n_test=4, impl=args.impl, pcd_points=max(args.n_tri // 2, 100),
        pcd_noise=0.1, device=args.device)

    trainer = build_trainer(cfg, impl=args.impl, log_file=False, device=args.device)
    trainer._init_model()
    psnr0 = float(trainer._evaluate(0))
    t0 = time.time()
    trainer.train()
    wall = time.time() - t0
    psnr1 = float(trainer._evaluate(args.iters))

    extra = {}
    if args.mesh:
        glb = f"{root}/out/glb/{args.iters}.glb"
        extra = {"gamma_final": round(float(trainer.state.gamma), 1),
                 "glb_exported": os.path.exists(glb)}
    record = {
        "metric": "smoke_overfit",
        "res": args.res, "iters": args.iters, "impl": args.impl,
        **extra,
        "psnr_init": round(psnr0, 2), "psnr_final": round(psnr1, 2),
        "alive_triangles": int(trainer.state.alive.sum()),
        "wall_s": round(wall, 1),
        "ms_per_step_incl_compile": round(wall / args.iters * 1000.0, 2),
    }
    return trainer, record


def main(argv=None):
    args = parse_args(argv)
    _, record = run(args)
    print(json.dumps(record), flush=True)
    psnr0, psnr1 = record["psnr_init"], record["psnr_final"]
    if psnr1 < psnr0 + args.min_gain:
        raise SystemExit(f"PSNR did not climb: {psnr0:.2f} -> {psnr1:.2f}")
    return psnr0, psnr1


if __name__ == "__main__":
    main()
