#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. build   — compile the hand-written CUDA kernels from
             triangle_splatting_tpu_torch/ops/cuda/csrc (one nvcc per source,
             in parallel) and print the card's name and power limit;
2. kernels — hold each kernel of the path against its plain PyTorch version
             at the shapes of the bench workload (800x800, 100k triangles,
             rich off, pair budget sized by a probe frame) and time both
             with CUDA events: B1 with stats off and on (the stats form's
             blend outputs bit-identical to the stats-off kernel's, its
             per-pair stream against the plain one), B2, B3, B4, and B5 on
             the stream after the owner sort; then B1 (both forms) and B2
             in variant "3D", B3/B4 on their pairs (2,500 tiles, 13 live
             gradient rows) and B5, on a 100k random scene at the mesh
             path's rendered size (1600x1600) at gamma 1 and 50, timed at
             gamma 50;
3. reference — the 2D and the 3D kernel pipelines against their dense
             oracles on a small scene, render and contribution statistics;
4. rasterize — time rasterize forward + backward on the bench workload;
5. train   — build the synthetic NeRF-Synthetic dataset at 800x800 from
             100k triangles, train config/NerfSynthetic_VanillaTS.yaml for 50
             steps (SH degree 3, all bands live) through build_trainer, check
             the loss falls and that every kernel of the path was launched;
             then profile 10 more steps (device time by kernel, busy share);
6. mesh    — train config/NerfSynthetic_VanillaTS_mesh.yaml without its
             statistic / scale_pruning / contribution_pruning blocks on a
             synthetic opaque surface (~100k GT triangles) for 50 steps (3D
             rasterizer, 800x800 views rendered at 1600x1600, STE opacity,
             gamma annealed 1 -> 50 over steps 10-40), check the loss falls,
             gamma reaches 50 and that B1/B2 ran once per step in variant
             "3D" and never in "2D"; then profile 10 more steps;
7. mesh_adc — train config/NerfSynthetic_VanillaTS_mesh.yaml with its
             statistic / scale_pruning / contribution_pruning blocks on the
             same surface for 50 steps (statistic window (5, 40], scale
             pruning every 10 and contribution pruning every 20 steps from
             5 to 40, target_point_num 93,000, the anneal at steps 10-40):
             B1-3D's stats form, B5, B2-3D, B3 and B4 once per step, both
             contribution prunings remove triangles, the alive count falls
             by the logged counts; then profile 10 more steps;
8. city    — write a synthetic city in MatrixCity's block_all layout (COLMAP
             text models, 8 train / 2 test aerial PNGs at 1600x900, a
             4M-point fused.ply) and train config/MatrixCity_VanillaTS_mesh.yaml
             on it through build_trainer for 50 steps: the MatrixCity factory
             and COLMAP readers, grid sampling at the recipe's 0.007 into
             ~1M triangles, the 3D rasterizer with rich info (B1/B2-3D's
             rich forms), the depth-normal consistency term from step 6,
             opacity pruning and clipping and scale pruning on compressed
             cadences, the gamma anneal to 50 over steps 10-40; then B1/B2
             rich, B3 and B4 held against their plain versions on the last
             step's own inputs, opacity clipping and pruning of a tenth or
             more of the trained rows on the card against a CPU copy, and
             10 profiled steps;
9. kernels_gs — the Gaussian renderer's kernels at bench-gs-800-100k (100k
             random Gaussians at 800x800, the budget sized by a probe frame):
             B1-GS in all four forms (stats x rich info) and B2-GS in both
             against their plain versions at gamma 1 and 2 (n_contrib and
             final_T exact), B3, B4 (10 / 11 rows) and B5 on their pairs,
             each form timed at gamma 1; and a stack of Gaussians whose kill
             entry lies past the first staged batch of every form;
10. gs     — train the gs-800-100k cell (the JAX smoke's VanillaGS recipe
             without densification, SH degree 3, with contribution pruning;
             cuts in GS_CUTS) on the photo phase's soup for 50 steps through
             build_trainer: B1-GS's stats form, B2-GS, B3, B4 and B5 once per
             step and no triangle form, the prunings logged and the alive
             count falling by them; then B1-GS stats, B2-GS, B3, B4 and B5
             held against their plain versions on the last step's own inputs,
             and 10 profiled steps;
11. renderer — the triangle renderer facade at bench-800-100k:
             TriangleRenderer(rich_info=True) renders once in "2D" (gamma 1)
             and once in "3D" (gamma 50), counted: B1's rich + stats form once
             in each variant and no other blend form; its outputs
             bit-identical to rasterize's plain, rich and stats forms; then
             the facade against the dense oracle on the reference phase's
             scene;
12. probes — the probe tools P1-P3 (triangle_splatting_tpu_torch/tools) at
             the JAX tools' shapes through their entry points, counted, each
             probe kernel against its plain version at K = 64 on those
             shapes, the opcodes of each probe kernel's SASS, and the rates.
The mesh phase's run saves the PLY (steps 10 and 50) and the GLB (step 50)
as the recipe does at its ends; the files are read back, and the GLB is
rendered through MeshRenderer on the card (its mask over the trained
surface's footprint) and at 200x200 on the card and the CPU.
The kernels phases also hold B1 with rich info and the stream together
(bit-identical to the plain, rich and stats forms), and B1/B2 with rich info (depth and normal) against
their plain versions, in "2D" at the bench shapes and in "3D" at gamma 1 and
50, their color, final_T and n_contrib bit-identical to the forms without
it, and B4 on their 16 / 14 live gradient rows; the reference phase runs
both pipelines with rich info against the oracles, and the Gaussian pipeline
(and its depth through the GaussianRenderer facade) against its oracle. The
photo and mesh phases also check that neither launched B5 or a stats form of
B1, none of the photo, mesh and mesh_adc phases launched a rich form, and
none of the triangle phases a GS form.

The build phase prints B1's and B2's registers, spills and shared memory
per form. With --blend-parent DIR (an earlier blend.cu and blend_gs.cu;
repeatable, the first is the parent), every site that times B1 or B2 also
times those builds in turns with the current one and holds the parent's
B1 outputs against the current ones (tools/blend_compare.py).

The last two lines are the per-kernel JSON record and
{"ok": true, "device": {...}}. Without a CUDA device, or without the
port package beside it, the script exits with code 2 and prints no
result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
RES = 800
MESH_RES = 2 * RES            # the mesh recipe's render_up_scale 2
N_TRI = 100_000
TRAIN_ITERS = 50

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32
# throughput outside the tensor cores. The bound of a kernel is the larger
# of its bytes over the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Arithmetic operations per evaluated (pair, pixel), counted from
# csrc/blend.cu at gamma == 1: the alpha terms (24) plus the blend update
# (9) forward; the alpha terms plus the gradient chain and the per-pixel
# sums of the ten live gradient rows (70) backward.
FWD_OPS_PER_EVAL = 33
BWD_OPS_PER_EVAL = 70
# Variant "3D": the barycentrics are quotients of three affine forms (D, A1,
# A2: 12 operations, a guard, a select and a divide, 18 against the 2D
# variant's 8), so the alpha terms take 34 at gamma == 1; gamma != 1 adds
# the log-space power (2 products, a log, a clamp and an exp: +5). The
# backward adds the quotient chain (dD, dA1, dA2: 7), two more pixel
# products and three more live rows (13) to sum, and at gamma != 1 the
# log-space ecc^(2 gamma - 1) (+7).
FWD_OPS_PER_EVAL_3D = {True: 43, False: 48}      # keyed by gamma == 1
BWD_OPS_PER_EVAL_3D = {True: 92, False: 104}
# Rich info. "2D" forward: depth d0 + d1*a1 + d2*a2 against contrib (5
# products, 3 adds) and three normal rows (3 + 3): +14; backward: d and
# the four terms of gdot (12), the depth's share of the a1/a2 gradients
# (5), six more rows (8 products) and their six pixel sums: +31. "3D"
# forward: the ray depth K * (contrib * invD) and its add (3), the three
# raw normal rows (6): +9; backward: t = K * invD and the four terms of
# gdot (9), the depth's share of the D gradient (4), the normal's of the
# three D rows (6), the K row (2) and its pixel sum (1): +22.
RICH_FWD_OPS = {"2D": 14, "3D": 9}
RICH_BWD_OPS = {"2D": 31, "3D": 22}
# Variant "GS" (csrc/blend_gs.cu), keyed by gamma == 1. Forward: the alpha
# terms (dx, dy: 2; q: 7 products and adds; the q >= 0 test, the clamp, the
# power product, its clamp, one exp, the opacity product, the 0.99 clamp,
# the 1/255 test and the select: 9; 20 in all) and the blend update (1 - alpha,
# test_T and its test, contrib, three color products and adds: 10): 30;
# gamma != 1 computes the power as -0.5 exp(clip(gamma log q)): +5.
# Backward: the alpha terms (20), 1/(1 - alpha) and the T update (3),
# contrib (1), gdot (5), dL/dalpha and the suffix A (5), the live select (2),
# dL/dq and its dx / dy products (4), the doubled conic (3), the nine
# nonzero rows (14) and their pixel sums (9): 66; gamma != 1 adds +5 in the
# alpha terms and the q^(gamma - 1) chain (+7). Rich info adds the depth
# field's product and add forward (+2) and to gdot, its row and its sum
# backward (+4). The backward's are counted per evaluated (pair, pixel),
# taken as the sum of n_contrib: the entries every pixel must evaluate up
# to its last composited one; the forward's as B1_CULL_OPS below says.
FWD_OPS_PER_EVAL_GS = {True: 30, False: 35}
BWD_OPS_PER_EVAL_GS = {True: 66, False: 78}
RICH_FWD_OPS["GS"] = 2
RICH_BWD_OPS["GS"] = 4
# B1's stats form adds a sum and a max of each evaluated contribution over
# the tile's pixels; B5 an add and a max per sorted pair.
STATS_OPS_PER_EVAL = 2
# B1's operations are counted where this run's data needs them (b1_work),
# not at every (pair, pixel) up to n_contrib: an entry of alpha 0 at a pixel
# changes none of its outputs. They are the cull of an entry for each
# 8x4 warp box while some pixel of the box is live (B1_CULL_OPS, counted
# from box_may_hit / box_may_hit_gs: "2D" the three barycentrics' maxima
# over the box and the margin, 52; "3D" the same from the box's four
# corners, each a divide and three ratios, 184; "GS" the center's distance
# to the box and the conic's smaller eigenvalue, 44); the first half of the
# alpha terms at each live pixel of a box the cull keeps (B1_ECC_OPS: the
# barycentrics, a3, their min, the ecc and its range tests, 17, "3D" with
# the plane guard and the divide 27; "GS" dx, dy, q and its test, 10); and
# the rest of FWD_OPS_PER_EVAL* (the falloff and the composite), the rich
# and the stats operations only where the plain alpha is != 0.
B1_CULL_OPS = {"2D": 52, "3D": 184, "GS": 44}
B1_ECC_OPS = {"2D": 17, "3D": 27, "GS": 10}
B5_OPS_PER_PAIR = 2
# the mesh recipe with its ADC blocks, cut to the 50-step run (mesh_adc)
ADC_STAT_WINDOW = (5, 40)
ADC_SCALE_INTERVAL = 10
ADC_CONTRIB_INTERVAL = 20
ADC_TARGET = 93_000          # run_experiments.py's "ship" preset
# ~1 ms of GPU clock cycles: longer than the host takes to enqueue one
# kernel wrapper or library call (see cuda_ms)
SPIN_CYCLES = 2_000_000

TOL = dict(b1_abs=1e-5, b2_rel=1e-4, b4_rel=1e-5, stats_sum_rel=1e-5,
           stats_max_rel=1e-6, b5_rel=1e-5, oracle_stats_abs=5e-4, rich_rel=1e-5,
           oracle_rich_rel=1e-3)
GS_FORMS = (("gs", False, False), ("gs_stats", True, False), ("gs_rich", False, True),
            ("gs_rich_stats", True, True))
_BLEND = "triangle_splatting_tpu/ops/pallas/blend.py"
_STREAMS = "triangle_splatting_tpu/ops/pallas/streams.py"
_PROBES = ("vpu_probe", "exp_probe", "scan_probe")
REPLACES = {
    "blend_forward": f"{_BLEND}:514",
    "blend_backward": f"{_BLEND}:956",
    "relayout_pairs": f"{_STREAMS}:100",
    "segment_reduce_pairs": f"{_STREAMS}:221",
    "blend_forward_3d": f"{_BLEND}:514",
    "blend_backward_3d": f"{_BLEND}:956",
    "blend_forward_stats": f"{_BLEND}:514",
    "blend_forward_3d_stats": f"{_BLEND}:514",
    "segment_reduce_stats": f"{_STREAMS}:356",
    "blend_forward_rich": f"{_BLEND}:514",
    "blend_backward_rich": f"{_BLEND}:956",
    "blend_forward_3d_rich": f"{_BLEND}:514",
    "blend_backward_3d_rich": f"{_BLEND}:956",
    **{f"blend_forward_{f}": f"{_BLEND}:514" for f, _, _ in GS_FORMS},
    "blend_backward_gs": f"{_BLEND}:956",
    "blend_backward_gs_rich": f"{_BLEND}:956",
    "blend_forward_rich_stats": f"{_BLEND}:514",
    "blend_forward_3d_rich_stats": f"{_BLEND}:514",
    "vpu_probe": "tools/vpu_probe.py:50",
    "exp_probe": "tools/exp_probe.py:68",
    "scan_probe": "tools/scan_probe.py:112",
}
_CSRC = "triangle_splatting_tpu_torch/ops/cuda/csrc"
SOURCES = {name: f"{_CSRC}/{'probes' if name in _PROBES else 'streams' if _STREAMS in r else 'blend_gs' if '_gs' in name else 'blend'}.cu"
           for name, r in REPLACES.items()}
# the training phase whose run each kernel's launches are read from: the
# path that runs it (the 2D stats form is on none of them: no shipped
# photo recipe has a statistic block, so its count is the photo run's 0)
PATH_OF = dict.fromkeys(REPLACES, "train")
PATH_OF.update(blend_forward_3d="mesh", blend_backward_3d="mesh",
               blend_forward_3d_stats="mesh_adc", segment_reduce_stats="mesh_adc",
               blend_forward_3d_rich="city", blend_backward_3d_rich="city",
               # the VanillaGS trainer renders with statistics and without
               # rich info: the other GS forms run in its evaluation (outside
               # the counted steps) and in the GaussianRenderer facade
               **{f"blend_forward_{f}": "gs" for f, _, _ in GS_FORMS},
               blend_backward_gs="gs", blend_backward_gs_rich="gs",
               # the triangle renderer facade with rich info
               blend_forward_rich_stats="renderer", blend_forward_3d_rich_stats="renderer",
               **dict.fromkeys(_PROBES, "probes"))
RICH_FORMS = ("blend_forward_rich", "blend_backward_rich", "blend_forward_3d_rich",
              "blend_backward_3d_rich", "blend_forward_rich_stats",
              "blend_forward_3d_rich_stats")
# the probes: K of the parity checks, and the variant each JSON row times
PROBE_PARITY_K = 64
PROBE_ROW = dict(vpu_probe="fma float32", exp_probe="exp (expf)", scan_probe="hs")
# the MatrixCity recipe, cut to the 50-step city phase
CITY_W, CITY_H = 1600, 900
CITY_POINTS = 4_000_000
CITY_TRIANGLES = (900_000, 1_100_000)   # what the recipe's 0.007 grid must give
CITY_CUTS = dict(
    iterations="50 of 90,000",
    geometry_start="geometry_loss.start_iter 15,000 -> 5",
    opacity_pruning="(6,000, 60,000] every 200, hold 90,000 -> fires every 10 in (5, 40], "
                    "thresholds 0.005 -> 0.5 scheduled over (5, 60]",
    opacity_clipping="(30,000, 60,000] every 200, hold 90,000 -> (10, 40] every 10",
    scale_pruning="(1,000, 60,000] every 200 -> (5, 40] every 10",
    gamma_anneal="30,000-60,000 -> 10-40",
    opacity_reg="quad_start_iter 6,000 -> 5, linear_start_iter 60,000 -> 40",
    log_interval="50 -> 10 (the pair budget is re-sized at log steps)",
    initial_eval="before and after the counted run, outside it",
    views="8 train / 2 test synthetic aerial views (MatrixCity: 6,000+)")
# gs-800-100k: the JAX package's smoke VanillaGS recipe
# (triangle_splatting_tpu/trainers/smoke.py make_smoke_config, model="gs",
# densify=True, iters=50), written out as data, with the cuts of GS_CUTS
GS_ITERS = TRAIN_ITERS
GS_CONTRIB_WINDOW = (5, 40)
GS_CONTRIB_INTERVAL = 20
GS_TARGET = 93_000
GS_CUTS = dict(
    iterations="50 (the smoke's own count; no published VanillaGS recipe ships)",
    sh="max_sh_degree 1 -> 3 (GSModelConfig's default), one_up_iters [12] -> [10, 20, 30]",
    densification="removed (not ported: ROADMAP Queue A item 5)",
    contribution_pruning="added: config/NerfSynthetic_VanillaTS_mesh.yaml's block, window "
                         "(1,000, 40,000] every 1,000 -> (5, 40] every 20, target 93,000",
    saves="save_iterations / checkpoint_iterations [50] -> none",
    eval="outside the counted run (test PSNR before and after)",
    data="the photo phase's soup: 8 train / 2 test views at 800x800, a 100k-point cloud")


def gs_config(root: Path) -> dict:
    """The gs-800-100k recipe (smoke.py make_smoke_config(model="gs") at 50
    iterations, with the cuts of GS_CUTS)."""
    lr = lambda a, b: dict(v_init=a, v_final=b, max_steps=GS_ITERS)  # noqa: E731
    start, end = GS_CONTRIB_WINDOW
    return dict(
        dataset=dict(type="NerfSynthetic", local_dir=str(root), background="white",
                     use_alpha_mask=False, num_workers=2, pcd_path="point_cloud.ply",
                     hold_test_set=True),
        model=dict(
            max_sh_degree=3, rasterizer_type="2D", pairs_per_triangle=16,
            sampling=dict(sample_method="direct", init_opacity=0.3),
            optimizer=dict(xyz=lr(0.002, 0.0002), scaling=lr(0.005, 0.005),
                           rotation=lr(0.001, 0.001), opacity=lr(0.05, 0.02),
                           f_dc=lr(0.02, 0.005), f_rest=lr(0.001, 0.001)),
            model_update=dict(
                sh_schedule=dict(one_up_iters=[10, 20, 30]),
                statistic=dict(start_iter=0, end_iter=GS_ITERS),
                opacity_pruning=dict(start_iter=GS_ITERS // 4, end_iter=GS_ITERS,
                                     hold_iter=GS_ITERS, interval_iter=max(50, GS_ITERS // 8),
                                     opacity_threshold_init=0.005,
                                     opacity_threshold_final=0.005),
                contribution_pruning=dict(
                    start_iter=start, end_iter=end, interval_iter=GS_CONTRIB_INTERVAL,
                    min_view_count=1, target_point_num=GS_TARGET, downsample_iteration=[],
                    downsample_point_num=[], prune_ratio=0.15, max_prune_ratio=0.2,
                    contrib_max_ratio=0.1, sparsity_retain_ratio=0.25))),
        trainer=dict(type="VanillaGS", output_dir=str(WORK / "out_gs"), iterations=GS_ITERS,
                     initial_eval=False, log_interval_iter=10, eval_interval_iter=0,
                     histogram_interval_iter=0, train_background="white",
                     eval_background="white", w_ssim=0.2, use_tensorboard=False, seed=0))


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2, hide_host: bool = True) -> float:
    """Median per-call time of ``fn`` in ms between CUDA events recorded
    around it. With ``hide_host`` each call is queued behind a ~1 ms spin
    kernel, so the host has enqueued the events and the call's launches
    before the device reaches them: the events then time the device work
    alone, without the wrapper's launch overhead (which exceeds the run
    time of a 10 us kernel). Without it they time the call end to end,
    host included, as a caller sees it."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def b1_ms(fwd, geo, stats: bool = False, rich: bool = False, cmp=None,
          site: str | None = None) -> float:
    """B1's time in the form (stats, rich) on the inputs ``fwd`` (median of
    20). With --blend-parent (``cmp``, a tools/blend_compare.py Comparison)
    and a ``site``, first the earlier builds' B1 in turns with it; the
    parent's five per-pixel outputs must be the current ones bit for bit,
    its stream's maxes too and its sums within rel 1e-5."""
    from triangle_splatting_tpu_torch.ops.cuda import blend as KB
    if cmp is not None and site is not None:
        t = cmp.turns_b1(fwd, geo, stats, rich, cuda_ms)
        say("blend_parent", site=site, **t)
        parent = cmp.builds[0]
        check(all(t["identical"][parent]), f"blend_forward {t['form']} at {site}: the "
              f"parent's outputs are not the current ones bit for bit {t['identical'][parent]}")
        if stats:
            ps = t["stream"][parent]
            check(ps["max_identical"] and ps["sum_rel"] <= TOL["stats_sum_rel"],
                  f"blend_forward {t['form']} at {site}: the parent's stream differs {ps}")
    return cuda_ms(lambda: KB.blend_forward(*fwd, stats=stats, rich=rich, **geo), 20)


def b2_ms(bw, geo, rich: bool = False, cmp=None, site: str | None = None) -> float:
    """B2's time on the inputs ``bw`` (median of 20). With --blend-parent
    (``cmp``) and a ``site``, first the earlier builds' B2 in turns with it."""
    from triangle_splatting_tpu_torch.ops.cuda import blend as KB
    if cmp is not None and site is not None:
        say("blend_parent", site=site, **cmp.turns_b2(bw, geo, rich, cuda_ms))
    return cuda_ms(lambda: KB.blend_backward(*bw, rich=rich, **geo), 20)


def bound_ms(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b1_work(fwd, geo, n_contrib, what: str) -> dict:
    """The work B1's function needs on the packed pairs ``fwd`` = (fields,
    tile_starts, tile_counts, params), given its n_contrib (H, W): per tile,
    the kernel's warp boxes (``tile_pixel``'s lane map) and each pixel's
    entries j < n_contrib ("GS": up to its last composited one, a lower
    bound), counted as ``boxes`` (entry, box) pairs with a live pixel,
    ``eccs`` live (pair, pixel) in a box the plain cull keeps
    (``box_cull_plain`` / ``box_cull_gs_plain``) and ``hits`` live (pair,
    pixel) whose plain alpha is != 0. Fails if the cull drops a hit."""
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import blend as KB

    pairs, tile_starts, tile_counts, params = fwd
    variant, th, tw = geo["variant"], geo["tile_h"], geo["tile_w"]
    W, H = geo["image_width"], geo["image_height"]
    grid_w, npix, dev = -(-W // tw), th * tw, pairs.device
    check(npix % 32 == 0, f"b1_work {what}: {th}x{tw} tiles are not whole warps")
    lane = torch.arange(npix, device=dev)
    if tw % 8 == 0 and th % 4 == 0:
        warp, wl = lane // 32, lane % 32
        lx, ly = (warp % (tw // 8)) * 8 + wl % 8, (warp // (tw // 8)) * 4 + wl // 8
    else:
        lx, ly = lane % tw, lane // tw
    gamma, g = params[0], float(params[0])
    inr = torch.ones((1, 1), dtype=torch.bool, device=dev)
    boxes = eccs = hits = missed = torch.zeros((), dtype=torch.int64, device=dev)
    for t, (s, n) in enumerate(zip(tile_starts.tolist(), tile_counts.tolist())):
        if n == 0:
            continue
        x, y = (t % grid_w) * tw + lx, (t // grid_w) * th + ly
        inside = (x < W) & (y < H)
        nc = torch.where(inside, n_contrib[y.clamp(max=H - 1), x.clamp(max=W - 1)], 0)
        xs, ys = x.view(-1, 32).to(pairs.dtype), y.view(-1, 32).to(pairs.dtype)
        box = torch.stack([xs.amin(1), xs.amax(1), ys.amin(1), ys.amax(1)], dim=1)
        f = pairs[:, s:s + n]
        px, py = x.to(pairs.dtype), y.to(pairs.dtype)
        if variant == "GS":
            ok = KB.alpha_terms_gs_plain(f, px, py, gamma, inr)[-1]
            cull = KB.box_cull_gs_plain(f, box, KB.q_bound_plain(f[6], g))
        else:
            ok = KB.alpha_terms_plain(f, px, py, gamma, inr, variant)[7]
            bound = KB.ecc_bound_plain(f[9 if variant == "3D" else 6], g)
            cull = KB.box_cull_plain(f, box, bound, variant)
        live = (torch.arange(n, device=dev)[:, None] < nc[None, :]).view(n, -1, 32)
        hit = live & ok.view(n, -1, 32)
        boxes = boxes + live.any(2).sum()
        eccs = eccs + (live & cull[:, :, None]).sum()
        hits = hits + hit.sum()
        missed = missed + (hit & ~cull[:, :, None]).sum()
    out = dict(boxes=int(boxes), eccs=int(eccs), hits=int(hits),
               evals=int(n_contrib.to(torch.int64).sum()))
    check(int(missed) == 0, f"b1_work {what}: the plain cull drops {int(missed)} hits")
    say("b1_work", what=what, **out)
    return out


def b1_ops(work: dict, variant: str, gamma1: bool, stats: bool = False,
           rich: bool = False) -> float:
    """B1's operations on ``b1_work``'s counts (see B1_CULL_OPS)."""
    per_eval = {"2D": FWD_OPS_PER_EVAL, "3D": FWD_OPS_PER_EVAL_3D[gamma1],
                "GS": FWD_OPS_PER_EVAL_GS[gamma1]}[variant]
    per_hit = (per_eval - B1_ECC_OPS[variant] + (STATS_OPS_PER_EVAL if stats else 0)
               + (RICH_FWD_OPS[variant] if rich else 0))
    return (B1_CULL_OPS[variant] * work["boxes"] + B1_ECC_OPS[variant] * work["eccs"]
            + per_hit * work["hits"])


def read_launches() -> dict:
    """Launch counts under the kernel names of the JSON record: B1/B2 in
    variant "3D" as ``<kernel>_3d``, B1's stats forms as
    ``blend_forward_stats`` ("2D") and ``blend_forward_3d_stats``."""
    from triangle_splatting_tpu_torch.ops.cuda import launch_counts
    out = {}
    for (k, form), n in launch_counts().items():
        suffix = "" if form is None else form.lower().replace("2d", "").strip("_")
        out[f"{k}_{suffix}" if suffix else k] = n
    return out


def check_no_rich_launches(launches: dict, phase: str) -> None:
    """A path without a geometry term launches no rich form of B1/B2."""
    for name in RICH_FORMS:
        check(launches[name] == 0, f"{phase}: kernel {name} launched {launches[name]} times "
              "on a path without rich info")


def check_no_gs_launches(launches: dict, phase: str) -> None:
    """A triangle path launches no GS form of B1/B2."""
    for name, n in launches.items():
        if "_gs" in name:
            check(n == 0, f"{phase}: kernel {name} launched {n} times on a triangle path")


def check_no_stats_launches(launches: dict, phase: str) -> None:
    """A path without a statistic block launches neither B5 nor a stats
    form of B1."""
    for name in ("segment_reduce_stats", "blend_forward_stats", "blend_forward_3d_stats",
                 "blend_forward_rich_stats", "blend_forward_3d_rich_stats"):
        check(launches[name] == 0, f"{phase}: kernel {name} launched {launches[name]} times "
              "on a path without statistics")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def ptxas_usage(log: str) -> dict:
    """Kernel name (template instantiations as ``name<false>`` /
    ``name<true>``) -> its spill and register/shared-memory lines from the
    ``-Xptxas -v`` output of one nvcc run."""
    from triangle_splatting_tpu_torch.ops.cuda.compare_sass import kernel_name
    usage, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = kernel_name(m.group(1))
        elif name is not None and ("spill" in ln or "Used" in ln):
            usage.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in usage.items()}


def phase_build() -> None:
    from triangle_splatting_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    paths = build.build_all()
    secs = time.perf_counter() - t0
    for name in paths:
        build.library(name)
    for name, rep in build.build_reports.items():
        say("build", source=f"{name}.cu", seconds=round(rep["seconds"], 3),
            ptxas=ptxas_usage(rep["log"]))
    say("build", seconds=round(secs, 3), libraries=sorted(p.name for p in paths.values()))
    # B1's and B2's registers, spills and static shared memory per form
    # (ptxas; none where the libraries were built before), and the dynamic
    # shared memory each launch asks for
    from triangle_splatting_tpu_torch.ops.cuda import blend as KB
    usage = {k: v for rep in build.build_reports.values()
             for k, v in ptxas_usage(rep["log"]).items()}
    say("build", b1_ptxas={f: usage.get(k) for f, k in KB.FORWARD_KERNELS.items()},
        b1_dynamic_smem_bytes=KB.forward_smem_bytes())
    say("build", b2_ptxas={f: usage.get(k) for f, k in KB.BACKWARD_KERNELS.items()},
        b2_dynamic_smem_bytes=KB.backward_smem_bytes())


def make_bench(dev):
    """The bench.py workload on the card: scene, camera, probe-sized budget."""
    import dataclasses

    import torch
    from triangle_splatting_tpu_torch.ops.projection import RasterSettings
    from triangle_splatting_tpu_torch.ops.rasterize import rasterize
    from triangle_splatting_tpu_torch.trainers.adc_utils import adapt_pair_budget
    from triangle_splatting_tpu_torch.utils.testing import make_camera, make_random_scene

    s = make_random_scene(N_TRI, seed=0, size_range=(0.01, 0.05))
    b = dict(vertex=torch.as_tensor(s["vertex"]).to(dev),
             opacity=torch.as_tensor(s["opacity"]).to(dev),
             rgb=torch.as_tensor(s["rgb"]).to(dev),
             camera=make_camera(RES, RES, device=dev))
    gen = torch.Generator(device="cpu").manual_seed(0)
    b["target"] = torch.rand((3, RES, RES), generator=gen).to(dev)
    settings = RasterSettings(image_width=RES, image_height=RES, rich_info=False,
                              pairs_per_triangle=6)
    with torch.no_grad():
        out = rasterize(b["vertex"], b["opacity"], None, b["camera"], settings,
                        gamma=1.0, background=torch.ones(3, device=dev),
                        bg_depth=10.0, colors=b["rgb"])
    check(not bool(out["overflow"]), "probe pair budget overflow")
    ppt = adapt_pair_budget(6.0, int(out["num_pairs"]), N_TRI, False,
                            shrink_if_below=1.0)
    b["settings"] = dataclasses.replace(settings, pairs_per_triangle=ppt)
    b["ppt"] = ppt
    return b


def pack_fields(fmat, pair_tri):
    """The per-triangle field matrix gathered into the aligned pair order,
    field-major (16, MA), zeros in the padding slots (the forward of
    ``ops/rasterize.py:PackPairFields``)."""
    import torch
    return torch.where((pair_tri >= 0)[:, None], fmat[pair_tri.clamp_min(0).long()],
                       torch.zeros((), device=fmat.device)).t().contiguous()


def check_relayout(sp, what: str):
    """B3 against its plain version on one frame's sorted pairs: exact.
    Returns the kernel's pair_tri, the argument tuple and the count of
    slots that differ (0)."""
    args = (sp.sorted_tri, sp.raw_starts, sp.astarts, sp.tile_counts, sp.ma)
    out, err = hold_relayout(args, what)
    return out, args, err


def hold_relayout(args, what: str):
    """B3 against its plain version on one argument tuple: exact. Returns
    the kernel's output and the count of slots that differ (0)."""
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import streams as KS

    out = KS.relayout_pairs(*args)
    ref = KS.relayout_pairs_plain(*args)
    torch.cuda.synchronize()
    err = int((out != ref).sum())
    check(err == 0, f"relayout_pairs {what}: disagrees with its plain version in {err} slots")
    return out, err


def check_segment_reduce(grads, pair_tri, sp, what: str) -> dict:
    """B4 against its plain version on the pack backward's inputs: the live
    per-pair gradient rows ``grads`` sorted by owning triangle (empty slots
    last), one segment per triangle; rel 1e-5 of the max. Returns the
    errors, the argument tuple and the sorted owner keys."""
    import torch

    P = sp.tri_offsets.shape[0] - 1
    key = torch.where(pair_tri >= 0, pair_tri, torch.full_like(pair_tri, P))
    skey, order = torch.sort(key, stable=True)
    cols = grads.index_select(1, order).contiguous()
    starts = torch.minimum(sp.tri_offsets[:-1], sp.num_pairs).contiguous()
    ends = torch.minimum(sp.tri_offsets[1:], sp.num_pairs).contiguous()
    return dict(hold_segment_reduce((cols, starts, ends, sp.num_pairs), what), skey=skey)


def hold_segment_reduce(args, what: str) -> dict:
    """B4 against its plain version on one argument tuple (cols, starts,
    ends, nvalid): rel 1e-5 of the max. Returns the errors, the argument
    tuple and the plain result."""
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import streams as KS

    out = KS.segment_reduce_pairs(*args)
    ref = KS.segment_reduce_pairs_plain(*args)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-30)
    check(rel <= TOL["b4_rel"], f"segment_reduce_pairs {what}: rel err {rel:.3e} > {TOL['b4_rel']}")
    return dict(args=args, ref=ref, err=err, rel=rel)


def check_segment_stats(pair_contrib, pair_tri, sp, what: str) -> dict:
    """B5 against its plain version on B1's per-pair stream after the
    owner sort (the inputs ``ops/rasterize.py:_contrib_stats`` gives it):
    sums within rel 1e-5 of the largest, maxes exact. Returns the errors,
    the argument tuple, the segment lengths and the library yardstick
    (two ``torch.segment_reduce`` calls on the sorted stream)."""
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import streams as KS

    P = sp.tri_offsets.shape[0] - 1
    key = torch.where(pair_tri >= 0, pair_tri, torch.full_like(pair_tri, P))
    cols = pair_contrib.index_select(1, torch.sort(key, stable=True).indices)
    starts = torch.minimum(sp.tri_offsets[:-1], sp.num_pairs).contiguous()
    ends = torch.minimum(sp.tri_offsets[1:], sp.num_pairs).contiguous()
    args = (cols[0], cols[1], starts, ends, sp.num_pairs)
    sums, maxes = KS.segment_reduce_stats(*args)
    ref_s, ref_m = KS.segment_reduce_stats_plain(*args)
    torch.cuda.synchronize()
    err_s = float((sums - ref_s).abs().max())
    rel_s = err_s / max(float(ref_s.abs().max()), 1e-30)
    err_m = float((maxes - ref_m).abs().max())
    check(rel_s <= TOL["b5_rel"], f"segment_reduce_stats {what}: sum rel err {rel_s:.3e}")
    check(err_m == 0.0, f"segment_reduce_stats {what}: max err {err_m:.3e}, expected exact")
    n = int(sp.num_pairs)
    lengths = ends - starts
    data = (cols[0, :n].contiguous(), cols[1, :n].contiguous())

    def library():
        return (torch.segment_reduce(data[0], "sum", lengths=lengths, initial=0),
                torch.segment_reduce(data[1], "max", lengths=lengths, initial=0))
    lib_s, lib_m = library()
    check(float((lib_s - ref_s).abs().max()) <= TOL["b5_rel"] * float(ref_s.abs().max())
          and bool(torch.equal(lib_m, ref_m)), "segment_reduce yardstick disagrees with B5")
    return dict(args=args, library=library, err=max(err_s, err_m), rel=rel_s,
                bytes=4 * (2 * n + 2 * P + 1) + 4 * 2 * P, ops=B5_OPS_PER_PAIR * n)


def check_blend(fields, sp, params, geo, target, what: str) -> dict:
    """B1 and B2 of ``geo["variant"]`` against their plain versions on the
    same packed pairs: n_contrib exact, color / final_T abs 1e-5, the live
    gradient rows rel 1e-4 of each row's max and the other rows zero. B2's
    cotangent is that of the bench loss |render - target|. B1's stats form
    on the same pairs: color, final_T and n_contrib bit-identical to the
    stats-off kernel's, the per-pair stream's sums within rel 1e-5 and its
    maxes within rel 1e-6 of each row's max against the plain stream.
    Returns the errors, the argument tuples for timing, the evaluated
    (pair, pixel) count, the bytes each kernel must move and the stream."""
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import blend as KB

    H, W = geo["image_height"], geo["image_width"]
    live = KB.LIVE_GRAD_ROWS[(geo["variant"], False)]   # = fields B1 reads
    fwd = (fields, sp.astarts, sp.tile_counts, params)
    out1 = KB.blend_forward(*fwd, **geo)
    on1 = KB.blend_forward(*fwd, stats=True, **geo)
    ref1 = KB.blend_forward_plain(*fwd, stats=True, **geo)
    torch.cuda.synchronize()
    e_color = float((out1[0] - ref1[0]).abs().max())
    e_T = float((out1[3] - ref1[3]).abs().max())
    e_nc = int((out1[4] != ref1[4]).sum())
    check(e_color <= TOL["b1_abs"] and e_T <= TOL["b1_abs"],
          f"blend_forward {what}: color/final_T err {e_color:.3e}/{e_T:.3e} > {TOL['b1_abs']}")
    check(e_nc == 0, f"blend_forward {what}: n_contrib differs in {e_nc} pixels")
    same = [bool(torch.equal(a, b)) for a, b in zip(on1[:5], out1)]
    check(all(same), f"blend_forward stats form {what}: blend outputs differ from the "
          f"stats-off kernel's (color, depth, normal, final_T, n_contrib: {same})")
    pc, pref = on1[5], ref1[5]
    e_sum = float((pc[0] - pref[0]).abs().max())
    e_max = float((pc[1] - pref[1]).abs().max())
    rel_sum = e_sum / max(float(pref[0].abs().max()), 1e-30)
    rel_max = e_max / max(float(pref[1].abs().max()), 1e-30)
    check(rel_sum <= TOL["stats_sum_rel"] and rel_max <= TOL["stats_max_rel"],
          f"blend_forward stats form {what}: stream err rel {rel_sum:.3e} (sum) / "
          f"{rel_max:.3e} (max)")

    g_color = (torch.sign(out1[0] - target) / (3 * H * W)).contiguous()
    bw = fwd + (out1[3], out1[4], g_color, torch.zeros((H, W), device=fields.device))
    out2 = KB.blend_backward(*bw, **geo)
    ref2 = KB.blend_backward_plain(*bw, **geo)
    torch.cuda.synchronize()
    diff2 = (out2 - ref2).abs()
    rel2 = float((diff2.amax(dim=1) / ref2.abs().amax(dim=1).clamp_min(1e-30))[:live].max())
    check(bool(torch.isfinite(out2).all()), f"blend_backward {what}: non-finite values")
    check(float(out2[live:].abs().max()) == 0.0, f"blend_backward {what}: rows {live}.. not zero")
    check(rel2 <= TOL["b2_rel"], f"blend_backward {what}: rel err {rel2:.3e} > {TOL['b2_rel']}")

    num_pairs, T = int(sp.num_pairs), sp.tile_counts.shape[0]
    pairs_in = 4 * (live * num_pairs + 2 * T + 1 + 8)
    return dict(fwd=fwd, bw=bw, out1=out1, g_color=g_color, out2=out2,
                b1_err=max(e_color, e_T), n_contrib_mismatch=e_nc,
                b2_err=float(diff2.max()), b2_rel=rel2,
                evals=float(out1[4].to(torch.float64).sum()),
                work=b1_work(fwd, geo, out1[4], what), b1_bytes=pairs_in + 4 * 9 * H * W,
                b2_bytes=pairs_in + 4 * 6 * H * W + 4 * 16 * sp.ma,
                pair_contrib=pc, stats_err=max(e_sum, e_max), stats_rel_sum=rel_sum,
                stats_rel_max=rel_max, stats_bytes=pairs_in + 4 * 9 * H * W + 4 * 2 * sp.ma,
                b1_tol=f"abs {TOL['b1_abs']} (color, final_T); n_contrib exact",
                b2_tol=f"rel {TOL['b2_rel']} of each row's max",
                stats_tol=(f"blend outputs bit-identical to stats off; stream rel "
                           f"{TOL['stats_sum_rel']} (sum) / {TOL['stats_max_rel']} (max) "
                           "of each row's max"))


def check_blend_rich(fwd, geo, off, bw_cot, what: str) -> dict:
    """B1 and B2 of ``geo["variant"]`` with rich info against their plain
    versions on the same packed pairs ``fwd``: color / final_T abs 1e-5,
    n_contrib exact, depth and normal rel 1e-5 of each output's max; the
    rich forward's color, final_T and n_contrib bit-identical to ``off``,
    the outputs of the kernel without rich info; B2 rel 1e-4 of each live
    row's max (16 rows "2D", 14 "3D"), the other rows zero, and its depth
    rows nonzero (the depth cotangent reached the kernel). ``bw_cot`` are
    the cotangents (color, final_T, depth, normal). Returns the errors,
    the argument tuples for timing, the evaluated (pair, pixel) count and
    the bytes each kernel must move."""
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import blend as KB

    H, W, variant = geo["image_height"], geo["image_width"], geo["variant"]
    live = KB.LIVE_GRAD_ROWS[(variant, True)]
    on = KB.blend_forward(*fwd, rich=True, **geo)
    ref = KB.blend_forward_plain(*fwd, rich=True, **geo)
    torch.cuda.synchronize()
    same = [bool(torch.equal(on[k], off[k])) for k in (0, 3, 4)]
    check(all(same), f"blend_forward rich {what}: color, final_T, n_contrib differ from the "
          f"form without rich info: {same}")
    e_ct = max(float((on[k] - ref[k]).abs().max()) for k in (0, 3))
    e_nc = int((on[4] != ref[4]).sum())
    rel_dn = [float((on[k] - ref[k]).abs().max()) / max(float(ref[k].abs().max()), 1e-30)
              for k in (1, 2)]
    check(e_ct <= TOL["b1_abs"] and e_nc == 0, f"blend_forward rich {what}: color/final_T err "
          f"{e_ct:.3e}, n_contrib differs in {e_nc} pixels")
    check(max(rel_dn) <= TOL["rich_rel"], f"blend_forward rich {what}: depth / normal rel err "
          f"{rel_dn} > {TOL['rich_rel']}")
    check(float(on[2].abs().max()) > 0, f"blend_forward rich {what}: zero normal")
    bw = fwd + (on[3], on[4]) + tuple(bw_cot)
    out2 = KB.blend_backward(*bw, rich=True, **geo)
    ref2 = KB.blend_backward_plain(*bw, rich=True, **geo)
    torch.cuda.synchronize()
    diff2 = (out2 - ref2).abs()
    rel2 = float((diff2.amax(dim=1) / ref2.abs().amax(dim=1).clamp_min(1e-30))[:live].max())
    check(bool(torch.isfinite(out2).all()), f"blend_backward rich {what}: non-finite values")
    check(live == 16 or float(out2[live:].abs().max()) == 0.0,
          f"blend_backward rich {what}: rows {live}.. not zero")
    check(rel2 <= TOL["b2_rel"], f"blend_backward rich {what}: rel err {rel2:.3e} > {TOL['b2_rel']}")
    depth_rows = (13,) if variant == "3D" else (10, 14, 15)
    row_max = [float(out2[r].abs().max()) for r in depth_rows]
    check(min(row_max) > 0, f"blend_backward rich {what}: depth rows {depth_rows} zero {row_max}")
    num_pairs = int(fwd[2].to(torch.int64).sum())
    T = fwd[2].shape[0]
    pairs_in = 4 * (live * num_pairs + 2 * T + 1 + 8)
    return dict(fwd=fwd, bw=bw, on=on, out2=out2,
                b1_err=max(e_ct, max(rel_dn) * float(ref[1].abs().max())),
                rel_depth=rel_dn[0], rel_normal=rel_dn[1], b2_err=float(diff2.max()), b2_rel=rel2,
                depth_row_max=row_max, evals=float(on[4].to(torch.float64).sum()),
                b1_bytes=pairs_in + 4 * 9 * H * W,
                b2_bytes=pairs_in + 4 * 10 * H * W + 4 * 16 * fwd[0].shape[1],
                b1_tol=(f"abs {TOL['b1_abs']} (color, final_T), rel {TOL['rich_rel']} of the max "
                        "(depth, normal); n_contrib exact; color, final_T, n_contrib "
                        "bit-identical to rich off"),
                b2_tol=f"rel {TOL['b2_rel']} of each row's max")


def check_blend_rich_stats(fwd, geo, off, rich_on, stream, what: str) -> dict:
    """B1 with rich info and the contribution stream together (the triangle
    renderer facade's form) on the packed pairs ``fwd``: color, final_T and
    n_contrib bit-identical to ``off`` (the plain form's), depth and normal
    to ``rich_on`` (the rich form's), the stream to ``stream`` (the stats
    form's); against the plain version n_contrib exact, color / final_T abs
    1e-5, depth and normal rel 1e-5 of their max, the stream's sums rel 1e-5
    and maxes rel 1e-6 of each row's max. Returns the error, the evaluated
    (pair, pixel) count, the bytes the kernel must move and the tolerance."""
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import blend as KB

    H, W, variant = geo["image_height"], geo["image_width"], geo["variant"]
    both = KB.blend_forward(*fwd, rich=True, stats=True, **geo)
    ref = KB.blend_forward_plain(*fwd, rich=True, stats=True, **geo)
    torch.cuda.synchronize()
    same = ([bool(torch.equal(both[k], off[k])) for k in (0, 3, 4)]
            + [bool(torch.equal(both[k], rich_on[k])) for k in (1, 2)]
            + [bool(torch.equal(both[5], stream))])
    check(all(same), f"blend_forward rich + stats {what}: not bit-identical to the plain "
          f"(color, final_T, n_contrib), rich (depth, normal) and stats (stream) forms: {same}")
    e_ct = max(float((both[k] - ref[k]).abs().max()) for k in (0, 3))
    e_nc = int((both[4] != ref[4]).sum())
    rel_dn = [float((both[k] - ref[k]).abs().max()) / max(float(ref[k].abs().max()), 1e-30)
              for k in (1, 2)]
    rel_pc = [float((both[5][r] - ref[5][r]).abs().max())
              / max(float(ref[5][r].abs().max()), 1e-30) for r in (0, 1)]
    check(e_ct <= TOL["b1_abs"] and e_nc == 0 and max(rel_dn) <= TOL["rich_rel"]
          and rel_pc[0] <= TOL["stats_sum_rel"] and rel_pc[1] <= TOL["stats_max_rel"],
          f"blend_forward rich + stats {what}: color/final_T err {e_ct:.3e}, n_contrib differs "
          f"in {e_nc} pixels, depth / normal rel {rel_dn}, stream rel {rel_pc}")
    live = KB.LIVE_GRAD_ROWS[(variant, True)]
    num_pairs, T, ma = int(fwd[2].to(torch.int64).sum()), fwd[2].shape[0], fwd[0].shape[1]
    return dict(err=max(e_ct, max(rel_dn) * float(ref[1].abs().max()),
                        float((both[5] - ref[5]).abs().max())),
                rel_depth=rel_dn[0], rel_normal=rel_dn[1], rel_stream_sum=rel_pc[0],
                rel_stream_max=rel_pc[1],
                bytes=4 * (live * num_pairs + 2 * T + 1 + 8) + 4 * 9 * H * W + 4 * 2 * ma,
                tol=(f"bit-identical to the plain (color, final_T, n_contrib), rich (depth, "
                     f"normal) and stats (stream) forms; vs plain: abs {TOL['b1_abs']} "
                     f"(color, final_T), rel {TOL['rich_rel']} (depth, normal), stream rel "
                     f"{TOL['stats_sum_rel']} (sum) / {TOL['stats_max_rel']} (max); n_contrib "
                     "exact"))


def rich_cotangents(c, H: int, W: int, dev, seed: int = 0):
    """(color, final_T, depth, normal) cotangents for B2's rich form: the
    bench loss's color cotangent and random ones for depth and normal."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    return (c["g_color"], torch.zeros((H, W), device=dev),
            (torch.randn((H, W), generator=gen) / (H * W)).to(dev),
            (torch.randn((3, H, W), generator=gen) / (3 * H * W)).to(dev))


def phase_kernels(b, cmp=None) -> dict:
    """Each kernel against its plain version at the bench shapes."""
    import torch
    from triangle_splatting_tpu_torch.ops.binning import sort_pairs
    from triangle_splatting_tpu_torch.ops.cuda import blend as KB
    from triangle_splatting_tpu_torch.ops.cuda import streams as KS
    from triangle_splatting_tpu_torch.ops.projection import preprocess_2d
    from triangle_splatting_tpu_torch.ops.rasterize import (_round_up,
                                                            triangle_field_matrix)

    dev = b["vertex"].device
    st, cam = b["settings"], b["camera"]
    H = W = RES
    geo = dict(image_width=W, image_height=H, tile_h=st.tile_h, tile_w=st.tile_w,
               variant="2D")
    rec = {}
    with torch.no_grad():
        prep = preprocess_2d(b["vertex"], torch.zeros((N_TRI, 2), device=dev),
                             b["rgb"], cam.world_view, cam.full_proj,
                             cam.tan_fovx, cam.tan_fovy, st, opacity=b["opacity"],
                             gamma=torch.ones((), device=dev))
        max_pairs = _round_up(int(st.pairs_per_triangle * N_TRI), KB.ALIGN)
        sp = sort_pairs(prep, st, max_pairs)
        num_pairs = int(sp.num_pairs)
        check(not bool(sp.overflow), "bench pair budget overflow")
        T = st.num_tiles

        # ---- B3 relayout_pairs
        pair_tri, args3, _ = check_relayout(sp, "2D")
        ref3 = KS.relayout_pairs_plain(*args3)
        abs3 = float((pair_tri - ref3).abs().max())
        # one indexed scatter computes the same map
        j = torch.arange(max_pairs, device=dev, dtype=torch.int32)
        tile_of = (torch.searchsorted(sp.raw_starts, j, right=True, out_int32=True) - 1).clamp(0, T - 1).long()
        keep = j < num_pairs
        dst = (sp.astarts[tile_of] + j - sp.raw_starts[tile_of])[keep].long()
        src = sp.sorted_tri[keep]
        lib_out = torch.full((sp.ma,), -1, dtype=torch.int32, device=dev)
        lib_out.scatter_(0, dst, src)
        check(bool((lib_out == ref3).all()), "scatter yardstick disagrees with B3")
        nbytes3 = 4 * (num_pairs + 3 * (T + 1) + sp.ma)
        rec["relayout_pairs"] = dict(
            max_abs_err=abs3,
            ms=cuda_ms(lambda: KS.relayout_pairs(*args3), 50),
            plain_ms=cuda_ms(lambda: KS.relayout_pairs_plain(*args3), 20),
            library_ms=cuda_ms(lambda: lib_out.scatter_(0, dst, src), 50),
            bound=bound_ms(nbytes3), tol="exact")

        # ---- B1 blend_forward, B2 blend_backward
        fmat = triangle_field_matrix(prep, b["opacity"])
        fields = pack_fields(fmat, pair_tri)
        params = torch.tensor([1.0, 1.0, 1.0, 1.0, 10.0, 0.0, 0.0, 0.0], device=dev)
        c = check_blend(fields, sp, params, geo, b["target"], "2D")
        rec["blend_forward"] = dict(
            max_abs_err=c["b1_err"],
            ms=b1_ms(c["fwd"], geo, cmp=cmp, site="bench-800-100k"),
            plain_ms=cuda_ms(lambda: KB.blend_forward_plain(*c["fwd"], **geo), 3, 1),
            library_ms=None,
            bound=bound_ms(c["b1_bytes"], b1_ops(c["work"], "2D", True)),
            tol=c["b1_tol"])
        rec["blend_backward"] = dict(
            max_abs_err=c["b2_err"],
            ms=b2_ms(c["bw"], geo, cmp=cmp, site="bench-800-100k"),
            plain_ms=cuda_ms(lambda: KB.blend_backward_plain(*c["bw"], **geo), 3, 1),
            library_ms=None,
            bound=bound_ms(c["b2_bytes"], BWD_OPS_PER_EVAL * c["evals"]),
            tol=c["b2_tol"])
        rec["blend_forward_stats"] = dict(
            max_abs_err=c["stats_err"],
            ms=b1_ms(c["fwd"], geo, stats=True, cmp=cmp, site="bench-800-100k"),
            plain_ms=cuda_ms(lambda: KB.blend_forward_plain(*c["fwd"], stats=True, **geo), 3, 1),
            library_ms=None,
            bound=bound_ms(c["stats_bytes"], b1_ops(c["work"], "2D", True, stats=True)),
            tol=c["stats_tol"])
        # ---- B1 / B2 with rich info, "2D"; B4 on their 16 live rows
        r = check_blend_rich(c["fwd"], geo, c["out1"], rich_cotangents(c, H, W, dev), "2D")
        rec["blend_forward_rich"] = dict(
            max_abs_err=r["b1_err"],
            ms=b1_ms(r["fwd"], geo, rich=True, cmp=cmp, site="bench-800-100k"),
            plain_ms=cuda_ms(lambda: KB.blend_forward_plain(*r["fwd"], rich=True, **geo), 3, 1),
            library_ms=None,
            bound=bound_ms(r["b1_bytes"], b1_ops(c["work"], "2D", True, rich=True)),
            tol=r["b1_tol"])
        rec["blend_backward_rich"] = dict(
            max_abs_err=r["b2_err"],
            ms=b2_ms(r["bw"], geo, rich=True, cmp=cmp, site="bench-800-100k"),
            plain_ms=cuda_ms(lambda: KB.blend_backward_plain(*r["bw"], rich=True, **geo), 3, 1),
            library_ms=None,
            bound=bound_ms(r["b2_bytes"], (BWD_OPS_PER_EVAL + RICH_BWD_OPS["2D"]) * r["evals"]),
            tol=r["b2_tol"])
        # ---- B1 with rich info and the stream together, "2D"
        rs = check_blend_rich_stats(c["fwd"], geo, c["out1"], r["on"], c["pair_contrib"], "2D")
        rec["blend_forward_rich_stats"] = dict(
            max_abs_err=rs["err"],
            ms=b1_ms(c["fwd"], geo, stats=True, rich=True, cmp=cmp, site="bench-800-100k"),
            plain_ms=cuda_ms(lambda: KB.blend_forward_plain(*c["fwd"], rich=True, stats=True,
                                                            **geo), 3, 1),
            library_ms=None,
            bound=bound_ms(rs["bytes"], b1_ops(c["work"], "2D", True, stats=True, rich=True)),
            tol=rs["tol"])
        live_r = KB.LIVE_GRAD_ROWS[("2D", True)]
        c4r = check_segment_reduce(r["out2"][:live_r], pair_tri, sp, "2D rich")
        say("kernels", kernel="blend_rich", variant="2D", b1_rel_err_depth=r["rel_depth"],
            b1_rel_err_normal=r["rel_normal"], b2_rel_err=r["b2_rel"],
            b2_depth_row_max=r["depth_row_max"], b4_rows=live_r, b4_rel_err=c4r["rel"],
            b4_max_abs_err=c4r["err"])

        # B5 on the 2D stream (its record is taken at the mesh shapes)
        c5 = check_segment_stats(c["pair_contrib"], pair_tri, sp, "2D")
        say("kernels", kernel="segment_reduce_stats", shapes="bench-800-100k",
            max_abs_err=c5["err"], sum_rel_err=c5["rel"],
            ms=cuda_ms(lambda: KS.segment_reduce_stats(*c5["args"]), 50),
            library_ms=cuda_ms(c5["library"], 50), bound_ms=bound_ms(c5["bytes"], c5["ops"])[0])
        out2 = c["out2"]

        # ---- B4 segment_reduce_pairs (the pack backward's inputs)
        P = fmat.shape[0]
        live = KB.LIVE_GRAD_ROWS[("2D", False)]
        c4 = check_segment_reduce(out2[:live], pair_tri, sp, "2D")
        args4, ref4 = c4["args"], c4["ref"]
        # one index_add_ over the segment ids computes the same sums
        seg = c4["skey"][:num_pairs].long()
        lib_cols = args4[0][:, :num_pairs]
        lib4 = torch.zeros((live, P), device=dev)
        lib4.index_add_(1, seg, lib_cols)
        check(float((lib4 - ref4[:live]).abs().max()) <= 1e-5 * float(ref4.abs().max()),
              "index_add_ yardstick disagrees with B4")
        nbytes4 = 4 * (live * num_pairs + 2 * P + 1) + 4 * 16 * P
        rec["segment_reduce_pairs"] = dict(
            max_abs_err=c4["err"], rel_err=c4["rel"],
            ms=cuda_ms(lambda: KS.segment_reduce_pairs(*args4), 50),
            plain_ms=cuda_ms(lambda: KS.segment_reduce_pairs_plain(*args4), 20),
            library_ms=cuda_ms(lambda: torch.zeros((live, P), device=dev).index_add_(1, seg, lib_cols), 50),
            bound=bound_ms(nbytes4, live * num_pairs), tol=f"rel {TOL['b4_rel']} of the max")

    for name, r in rec.items():
        say("kernels", kernel=name, max_abs_err=r["max_abs_err"], tol=r["tol"],
            ms=round(r["ms"], 4), plain_ms=round(r["plain_ms"], 3),
            bound_ms=round(r["bound"][0], 5), bound_by=r["bound"][1])
    say("kernels", num_pairs=num_pairs, pairs_per_triangle=b["ppt"], ma=sp.ma)
    return rec


def phase_kernels_3d(dev, cmp=None) -> dict:
    """B1/B2 in variant "3D" against their plain versions on a 100k-triangle
    random scene at the mesh path's rendered size (1600x1600: 2,500 tiles),
    at gamma 1 and at gamma 50; timed at gamma 50, the solidified regime
    the mesh recipe trains in from the end of its anneal on. B3 and B4 are
    held against theirs at the same shapes: B3 on the 2,500-tile frame, B4
    on B2-3D's 13 live gradient rows."""
    import dataclasses

    import torch
    from triangle_splatting_tpu_torch.ops.binning import sort_pairs
    from triangle_splatting_tpu_torch.ops.cuda import blend as KB
    from triangle_splatting_tpu_torch.ops.cuda import streams as KS
    from triangle_splatting_tpu_torch.ops.projection import RasterSettings, preprocess_3d
    from triangle_splatting_tpu_torch.ops.rasterize import (_round_up, rasterize,
                                                            triangle_field_matrix_3d)
    from triangle_splatting_tpu_torch.trainers.adc_utils import adapt_pair_budget
    from triangle_splatting_tpu_torch.utils.testing import make_camera, make_random_scene

    R = MESH_RES
    s = make_random_scene(N_TRI, seed=0, size_range=(0.01, 0.05))
    vertex, opacity, rgb = (torch.as_tensor(s[k]).to(dev) for k in ("vertex", "opacity", "rgb"))
    cam = make_camera(R, R, device=dev)
    st = RasterSettings(image_width=R, image_height=R, rich_info=False,
                        rasterizer_type="3D", pairs_per_triangle=6)
    with torch.no_grad():
        probe = rasterize(vertex, opacity, None, cam, st, gamma=1.0,
                          background=torch.ones(3, device=dev), bg_depth=10.0, colors=rgb)
    check(not bool(probe["overflow"]), "3D probe pair budget overflow")
    ppt = adapt_pair_budget(6.0, int(probe["num_pairs"]), N_TRI, False, shrink_if_below=1.0)
    st = dataclasses.replace(st, pairs_per_triangle=ppt)
    geo = dict(image_width=R, image_height=R, tile_h=st.tile_h, tile_w=st.tile_w,
               variant="3D")
    target = torch.rand((3, R, R), generator=torch.Generator().manual_seed(1)).to(dev)
    sx = R / (2.0 * float(cam.tan_fovx))
    sy = R / (2.0 * float(cam.tan_fovy))
    rec = {}
    for gamma in (1.0, 50.0):
        with torch.no_grad():
            prep = preprocess_3d(vertex, torch.zeros((N_TRI, 2), device=dev), rgb,
                                 cam.world_view, cam.full_proj, cam.tan_fovx,
                                 cam.tan_fovy, st, opacity=opacity,
                                 gamma=torch.tensor(gamma, device=dev))
            sp = sort_pairs(prep, st, _round_up(int(ppt * N_TRI), KB.ALIGN))
            check(not bool(sp.overflow), f"3D pair budget overflow at gamma {gamma}")
            what = f"3D, gamma {gamma}"
            # B3 and B4 at the mesh path's shapes: 2,500 tiles, 13 live rows
            pair_tri, args3, err3 = check_relayout(sp, what)
            fmat = triangle_field_matrix_3d(prep, opacity, cam.tan_fovx, cam.tan_fovy, R, R)
            params = torch.tensor([gamma, 1.0, 1.0, 1.0, 10.0, sx, sy, 0.0], device=dev)
            c = check_blend(pack_fields(fmat, pair_tri), sp, params, geo, target, what)
            live = KB.LIVE_GRAD_ROWS[("3D", False)]
            c4 = check_segment_reduce(c["out2"][:live], pair_tri, sp, what)
            c5 = check_segment_stats(c["pair_contrib"], pair_tri, sp, what)
            r = check_blend_rich(c["fwd"], geo, c["out1"], rich_cotangents(c, R, R, dev),
                                 what)
            live_r = KB.LIVE_GRAD_ROWS[("3D", True)]
            c4r = check_segment_reduce(r["out2"][:live_r], pair_tri, sp, what + " rich")
            rs = check_blend_rich_stats(c["fwd"], geo, c["out1"], r["on"], c["pair_contrib"],
                                        what)
        site = None if gamma == 1.0 else "bench3d-1600-100k gamma 50"
        ms1rs = b1_ms(c["fwd"], geo, stats=True, rich=True, cmp=cmp, site=site)
        g1 = gamma == 1.0
        bound1rs = bound_ms(rs["bytes"], b1_ops(c["work"], "3D", g1, stats=True, rich=True))
        say("kernels_3d", kernel="blend_forward_rich_stats", gamma=gamma,
            rel_err_depth=rs["rel_depth"], rel_err_normal=rs["rel_normal"],
            rel_err_stream_sum=rs["rel_stream_sum"], rel_err_stream_max=rs["rel_stream_max"],
            ms=ms1rs, bound_ms=bound1rs[0])
        ms1r = b1_ms(r["fwd"], geo, rich=True, cmp=cmp, site=site)
        ms2r = b2_ms(r["bw"], geo, rich=True, cmp=cmp, site=site)
        rich_ops = (b1_ops(c["work"], "3D", g1, rich=True),
                    (BWD_OPS_PER_EVAL_3D[g1] + RICH_BWD_OPS["3D"]) * r["evals"])
        say("kernels_3d", kernel="blend_rich", gamma=gamma, b1_rel_err_depth=r["rel_depth"],
            b1_rel_err_normal=r["rel_normal"], b1_max_abs_err=r["b1_err"],
            b2_rel_err=r["b2_rel"], b2_max_abs_err=r["b2_err"],
            b2_depth_row_max=r["depth_row_max"], b4_rows=live_r, b4_rel_err=c4r["rel"],
            b4_max_abs_err=c4r["err"], b1_rich_ms=ms1r,
            b1_rich_bound_ms=bound_ms(r["b1_bytes"], rich_ops[0])[0],
            b2_rich_ms=ms2r,
            b2_rich_bound_ms=bound_ms(r["b2_bytes"], rich_ops[1])[0])
        ms1 = b1_ms(c["fwd"], geo, cmp=cmp, site=site)
        ms1s = b1_ms(c["fwd"], geo, stats=True, cmp=cmp, site=site)
        ms2 = b2_ms(c["bw"], geo, cmp=cmp, site=site)
        ms5 = cuda_ms(lambda: KS.segment_reduce_stats(*c5["args"]), 50)
        bound1 = bound_ms(c["b1_bytes"], b1_ops(c["work"], "3D", g1))
        bound1s = bound_ms(c["stats_bytes"], b1_ops(c["work"], "3D", g1, stats=True))
        bound2 = bound_ms(c["b2_bytes"], BWD_OPS_PER_EVAL_3D[g1] * c["evals"])
        bound5 = bound_ms(c5["bytes"], c5["ops"])
        say("kernels_3d", gamma=gamma, tiles=int(sp.tile_counts.shape[0]),
            num_pairs=int(sp.num_pairs), pairs_per_triangle=ppt,
            pair_pixel_evals=c["evals"], b1_err=c["b1_err"],
            b1_n_contrib_mismatch=c["n_contrib_mismatch"], b2_rel_err=c["b2_rel"],
            b2_max_abs_err=c["b2_err"], b1_ms=ms1, b1_bound_ms=bound1[0], b2_ms=ms2,
            b2_bound_ms=bound2[0], b1_stats_ms=ms1s, b1_stats_bound_ms=bound1s[0],
            b1_stats_rel_err_sum=c["stats_rel_sum"], b1_stats_rel_err_max=c["stats_rel_max"],
            b3_mismatch=err3, b4_rows=live, b4_rel_err=c4["rel"],
            b4_max_abs_err=c4["err"], b5_sum_rel_err=c5["rel"], b5_max_abs_err=c5["err"],
            b5_ms=ms5, b5_bound_ms=bound5[0],
            b3_ms=cuda_ms(lambda: KS.relayout_pairs(*args3), 50),
            b4_ms=cuda_ms(lambda: KS.segment_reduce_pairs(*c4["args"]), 50))
        if not g1:
            rec["blend_forward_3d"] = dict(
                max_abs_err=c["b1_err"], ms=ms1,
                plain_ms=cuda_ms(lambda: KB.blend_forward_plain(*c["fwd"], **geo), 3, 1),
                library_ms=None, bound=bound1, tol=c["b1_tol"])
            rec["blend_backward_3d"] = dict(
                max_abs_err=c["b2_err"], ms=ms2,
                plain_ms=cuda_ms(lambda: KB.blend_backward_plain(*c["bw"], **geo), 3, 1),
                library_ms=None, bound=bound2, tol=c["b2_tol"])
            rec["blend_forward_3d_stats"] = dict(
                max_abs_err=c["stats_err"], ms=ms1s,
                plain_ms=cuda_ms(lambda: KB.blend_forward_plain(*c["fwd"], stats=True, **geo),
                                 3, 1),
                library_ms=None, bound=bound1s, tol=c["stats_tol"])
            rec["blend_forward_3d_rich_stats"] = dict(
                max_abs_err=rs["err"], ms=ms1rs,
                plain_ms=cuda_ms(lambda: KB.blend_forward_plain(*c["fwd"], rich=True, stats=True,
                                                                **geo), 3, 1),
                library_ms=None, bound=bound1rs, tol=rs["tol"])
            rec["segment_reduce_stats"] = dict(
                max_abs_err=c5["err"], ms=ms5,
                plain_ms=cuda_ms(lambda: KS.segment_reduce_stats_plain(*c5["args"]), 20),
                library_ms=cuda_ms(c5["library"], 50), bound=bound5,
                tol=f"sums rel {TOL['b5_rel']} of the max, maxes exact")
    for name, r in rec.items():
        say("kernels_3d", kernel=name, gamma=50.0, max_abs_err=r["max_abs_err"], tol=r["tol"],
            ms=round(r["ms"], 4), plain_ms=round(r["plain_ms"], 3),
            bound_ms=round(r["bound"][0], 5), bound_by=r["bound"][1])
    return rec


def check_blend_gs(fwd, geo, target, what: str, cot_seed: int = 0) -> dict:
    """B1-GS in its four forms and B2-GS in both against their plain
    versions on the packed pairs ``fwd`` = (fields, tile_starts,
    tile_counts, params). Forward: n_contrib and final_T exact (the done
    flag and the transmittance are bit-identical to the plain version's),
    color abs 1e-5, depth rel 1e-5 of its max, the stream's sums rel 1e-5
    of the row's max and its maxes exact; the four forms' color, final_T
    and n_contrib bit-identical to each other. Backward (cotangent of the
    bench loss |render - target| and a random depth cotangent): the live
    rows (10 / 11) rel 1e-4 of each row's max, row 5 and the others zero.
    Returns the errors, the argument tuples for timing, the evaluated
    (pair, pixel) count and the bytes each form must move."""
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import blend as KB

    H, W = geo["image_height"], geo["image_width"]
    dev = fwd[0].device
    ref = KB.blend_forward_plain(*fwd, stats=True, rich=True, **geo)
    outs, errs = {}, {}
    for form, stats, rich in GS_FORMS:
        out = KB.blend_forward(*fwd, stats=stats, rich=rich, **geo)
        torch.cuda.synchronize()
        e_nc = int((out[4] != ref[4]).sum())
        e_T = float((out[3] - ref[3]).abs().max())
        e_c = float((out[0] - ref[0]).abs().max())
        check(e_nc == 0 and e_T == 0.0, f"blend_forward {form} {what}: n_contrib differs in "
              f"{e_nc} pixels, final_T by {e_T:.3e} (expected exact)")
        check(e_c <= TOL["b1_abs"], f"blend_forward {form} {what}: color err {e_c:.3e}")
        if rich:
            e_d = float((out[1] - ref[1]).abs().max()) / max(float(ref[1].abs().max()), 1e-30)
            check(e_d <= TOL["rich_rel"], f"blend_forward {form} {what}: depth rel err {e_d:.3e}")
        else:
            e_d = 0.0
            check(bool(torch.equal(out[1], out[3] * fwd[3][4])),
                  f"blend_forward {form} {what}: depth is not final_T * bg_depth")
        check(not bool(out[2].any()), f"blend_forward {form} {what}: nonzero normal")
        e = dict(color=e_c, final_T=e_T, n_contrib=e_nc, depth_rel=e_d)
        if stats:
            pc = out[5]
            e_s = float((pc[0] - ref[5][0]).abs().max()) / max(float(ref[5][0].abs().max()), 1e-30)
            e_m = float((pc[1] - ref[5][1]).abs().max())
            check(e_s <= TOL["stats_sum_rel"] and e_m == 0.0, f"blend_forward {form} {what}: "
                  f"stream sum rel err {e_s:.3e}, max err {e_m:.3e} (expected exact)")
            e.update(stream_sum_rel=e_s, stream_max=e_m)
        outs[form], errs[form] = out, e
    base = outs["gs"]
    for form, out in outs.items():
        same = [bool(torch.equal(out[k], base[k])) for k in (0, 3, 4)]
        check(all(same), f"blend_forward {form} {what}: color, final_T, n_contrib differ from "
              f"the plain form's {same}")
    gen = torch.Generator().manual_seed(cot_seed)
    g_color = (torch.sign(base[0] - target) / (3 * H * W)).contiguous()
    g_depth = (torch.randn((H, W), generator=gen) / (H * W)).to(dev)
    zero = torch.zeros((H, W), device=dev)
    bws = {}
    for rich in (False, True):
        live = KB.LIVE_GRAD_ROWS[("GS", rich)]
        bw = fwd + (base[3], base[4], g_color, zero, g_depth if rich else None)
        out2 = KB.blend_backward(*bw, rich=rich, **geo)
        ref2 = KB.blend_backward_plain(*bw, rich=rich, **geo)
        torch.cuda.synchronize()
        diff2 = (out2 - ref2).abs()
        rel2 = float((diff2.amax(dim=1) / ref2.abs().amax(dim=1).clamp_min(1e-30))[:live].max())
        form = "gs_rich" if rich else "gs"
        check(bool(torch.isfinite(out2).all()), f"blend_backward {form} {what}: non-finite")
        check(not bool(out2[5].any()) and not bool(out2[live:].any()),
              f"blend_backward {form} {what}: row 5 or rows {live}.. not zero")
        check(rel2 <= TOL["b2_rel"], f"blend_backward {form} {what}: rel err {rel2:.3e}")
        check(min(float(out2[r].abs().max()) for r in range(live) if r != 5) > 0,
              f"blend_backward {form} {what}: a live row is zero")
        bws[form] = dict(bw=bw, out=out2, err=float(diff2.max()), rel=rel2)
    num_pairs, T = int(fwd[2].to(torch.int64).sum()), fwd[2].shape[0]
    pairs_in = lambda rows: 4 * (rows * num_pairs + 2 * T + 1 + 8)  # noqa: E731
    ma = fwd[0].shape[1]
    return dict(errs=errs, outs=outs, bws=bws, evals=float(base[4].to(torch.float64).sum()),
                work=b1_work(fwd, geo, base[4], what),
                b1_bytes={f: pairs_in(11 if r else 10) + 4 * 9 * H * W + (8 * ma if s else 0)
                          for f, s, r in GS_FORMS},
                b2_bytes={f: pairs_in(11 if f == "gs_rich" else 10) + 4 * (6 + (f == "gs_rich"))
                          * H * W + 4 * 16 * ma for f in bws})


def phase_kernels_gs(dev, cmp=None) -> dict:
    """bench-gs-800-100k: B1-GS (four forms) and B2-GS (two forms) against
    their plain versions on 100k random Gaussians at 800x800 (the GS twin of
    bench-800-100k: ``make_gs_scene`` over the same frustum, scales 0.01-0.05
    as the bench triangles' sizes, the budget sized by a probe frame), at
    gamma 1 and at gamma 2; B3 on the frame, B4 on B2's 10 / 11 live rows,
    B5 on the stream after the owner sort. Each form is timed at gamma 1,
    the gamma VanillaGS trains at. Then a stack of 400 Gaussians whose kill
    entry (index 300) lies past the first staged batch of every form (256
    forward, 96 backward), held exactly on n_contrib and
    final_T."""
    import dataclasses

    import torch
    from triangle_splatting_tpu_torch.ops.binning import sort_pairs
    from triangle_splatting_tpu_torch.ops.cuda import blend as KB
    from triangle_splatting_tpu_torch.ops.cuda import streams as KS
    from triangle_splatting_tpu_torch.ops.gaussian import (gaussian_field_matrix,
                                                           preprocess_gaussian)
    from triangle_splatting_tpu_torch.ops.projection import RasterSettings
    from triangle_splatting_tpu_torch.ops.rasterize import _round_up, rasterize_gaussian
    from triangle_splatting_tpu_torch.trainers.adc_utils import adapt_pair_budget
    from triangle_splatting_tpu_torch.utils.testing import (make_camera, make_gs_scene,
                                                            make_gs_stack_scene)

    def scene_tensors(sc):
        return [torch.as_tensor(sc[k]).to(dev) for k in ("xyz", "scale", "rot", "opacity", "rgb")]

    s = make_gs_scene(N_TRI, seed=0, scale_range=(0.01, 0.05))
    xyz, scale, rot, opacity, rgb = scene_tensors(s)
    cam = make_camera(RES, RES, device=dev)
    st = RasterSettings(image_width=RES, image_height=RES, rich_info=False,
                        rasterizer_type="GS", pairs_per_triangle=6)
    with torch.no_grad():
        probe = rasterize_gaussian(xyz, scale, rot, opacity, None, cam, st, gamma=1.0,
                                   background=torch.ones(3, device=dev), bg_depth=10.0,
                                   colors=rgb, need_stats=False)
    check(not bool(probe["overflow"]), "GS probe pair budget overflow")
    ppt = adapt_pair_budget(6.0, int(probe["num_pairs"]), N_TRI, False, shrink_if_below=1.0)
    st = dataclasses.replace(st, pairs_per_triangle=ppt)
    geo = dict(image_width=RES, image_height=RES, tile_h=st.tile_h, tile_w=st.tile_w,
               variant="GS")
    target = torch.rand((3, RES, RES), generator=torch.Generator().manual_seed(2)).to(dev)
    rec = {}
    for gamma in (1.0, 2.0):
        what = f"GS, gamma {gamma}"
        with torch.no_grad():
            prep = preprocess_gaussian(xyz, scale, rot, rgb, cam.world_view, cam.full_proj,
                                       cam.tan_fovx, cam.tan_fovy, st, opacity=opacity,
                                       gamma=torch.tensor(gamma, device=dev))
            sp = sort_pairs(prep, st, _round_up(int(ppt * N_TRI), KB.ALIGN))
            check(not bool(sp.overflow), f"GS pair budget overflow at gamma {gamma}")
            pair_tri, args3, err3 = check_relayout(sp, what)
            fields = pack_fields(gaussian_field_matrix(prep, opacity), pair_tri)
            params = torch.tensor([gamma, 1.0, 1.0, 1.0, 10.0, 0.0, 0.0, 0.0], device=dev)
            fwd = (fields, sp.astarts, sp.tile_counts, params)
            c = check_blend_gs(fwd, geo, target, what)
            c4 = {f: check_segment_reduce(c["bws"][f]["out"][:KB.LIVE_GRAD_ROWS[("GS", r)]],
                                          pair_tri, sp, f"{what} {f}")
                  for f, r in (("gs", False), ("gs_rich", True))}
            c5 = check_segment_stats(c["outs"]["gs_stats"][5], pair_tri, sp, what)
        g1 = gamma == 1.0
        times = {}
        for form, stats, rich in GS_FORMS:
            ops = b1_ops(c["work"], "GS", g1, stats=stats, rich=rich)
            times[f"blend_forward_{form}"] = dict(
                ms=b1_ms(fwd, geo, stats, rich, cmp, "bench-gs-800-100k" if g1 else None),
                bound=bound_ms(c["b1_bytes"][form], ops), err=max(
                    v for k, v in c["errs"][form].items() if k not in ("n_contrib",)),
                plain=lambda stats=stats, rich=rich: KB.blend_forward_plain(
                    *fwd, stats=stats, rich=rich, **geo))
        for form, b in c["bws"].items():
            rich = form == "gs_rich"
            ops = (BWD_OPS_PER_EVAL_GS[g1] + (RICH_BWD_OPS["GS"] if rich else 0)) * c["evals"]
            times[f"blend_backward_{form}"] = dict(
                ms=b2_ms(b["bw"], geo, rich, cmp, "bench-gs-800-100k" if g1 else None),
                bound=bound_ms(c["b2_bytes"][form], ops), err=b["err"],
                plain=lambda b=b, rich=rich: KB.blend_backward_plain(*b["bw"], rich=rich, **geo))
        say("kernels_gs", gamma=gamma, tiles=int(sp.tile_counts.shape[0]),
            num_pairs=int(sp.num_pairs), pairs_per_triangle=ppt, pair_pixel_evals=c["evals"],
            max_n_contrib=int(c["outs"]["gs"][4].max()), b1_errs=c["errs"],
            b2_rel_err={f: b["rel"] for f, b in c["bws"].items()}, b3_mismatch=err3,
            b4_rel_err={f: x["rel"] for f, x in c4.items()}, b5_sum_rel_err=c5["rel"],
            b5_max_abs_err=c5["err"],
            ms={k: round(v["ms"], 4) for k, v in times.items()},
            bound_ms={k: round(v["bound"][0], 5) for k, v in times.items()},
            b3_ms=cuda_ms(lambda: KS.relayout_pairs(*args3), 50),
            b4_ms=cuda_ms(lambda: KS.segment_reduce_pairs(*c4["gs"]["args"]), 50),
            b5_ms=cuda_ms(lambda: KS.segment_reduce_stats(*c5["args"]), 50))
        if g1:
            for name, t in times.items():
                rec[name] = dict(max_abs_err=t["err"], ms=t["ms"],
                                 plain_ms=cuda_ms(t["plain"], 3, 1), library_ms=None,
                                 bound=t["bound"],
                                 tol=("n_contrib, final_T and stream maxes exact; color abs "
                                      f"{TOL['b1_abs']}, depth and stream sums rel "
                                      f"{TOL['rich_rel']}" if "forward" in name else
                                      f"rel {TOL['b2_rel']} of each row's max"))
        del c, c4, c5, times, fwd, fields
    for name, r in rec.items():
        say("kernels_gs", kernel=name, gamma=1.0, max_abs_err=r["max_abs_err"], tol=r["tol"],
            ms=round(r["ms"], 4), plain_ms=round(r["plain_ms"], 3),
            bound_ms=round(r["bound"][0], 5), bound_by=r["bound"][1])

    # the kill entry past the first staged batch of every form
    n, kill_at = 400, 300
    xyz, scale, rot, opacity, rgb = scene_tensors(make_gs_stack_scene(n, kill_at, 0.02))
    st_k = RasterSettings(image_width=RES, image_height=RES, rich_info=False,
                          rasterizer_type="GS", pairs_per_triangle=400)
    with torch.no_grad():
        prep = preprocess_gaussian(xyz, scale, rot, rgb, cam.world_view, cam.full_proj,
                                   cam.tan_fovx, cam.tan_fovy, st_k, opacity=opacity,
                                   gamma=torch.ones((), device=dev))
        sp = sort_pairs(prep, st_k, _round_up(400 * n, KB.ALIGN))
        check(not bool(sp.overflow), "GS stack pair budget overflow")
        pair_tri, _, _ = check_relayout(sp, "GS stack")
        fwd = (pack_fields(gaussian_field_matrix(prep, opacity), pair_tri), sp.astarts,
               sp.tile_counts, torch.tensor([1.0, 1.0, 1.0, 1.0, 10.0, 0, 0, 0], device=dev))
        c = check_blend_gs(fwd, geo, target, "GS stack, kill past the batch")
    nc = c["outs"]["gs"][4]
    center = int(nc[RES // 2, RES // 2])
    check(256 < center < n, f"GS stack: n_contrib {center} at the center, not past the "
          "first 256-entry batch and before the list's end")
    say("kernels_gs", case="kill past the batch", gaussians=n, kill_at=kill_at,
        center_n_contrib=center, max_n_contrib=int(nc.max()),
        pixels_past_256=int((nc > 256).sum()), b1_errs=c["errs"],
        b2_rel_err={f: b["rel"] for f, b in c["bws"].items()},
        tol="n_contrib and final_T exact in every form")
    return rec


def phase_reference(dev) -> None:
    """The 2D and the 3D kernel pipelines vs their dense oracles on a small
    scene (64x64), with the contribution statistics (B1's stream, owner
    sort, B5), and again with rich info (depth and normal); the 3D one at
    gamma 1 and 50. Then the Gaussian pipeline against its oracle at gamma
    1 and 2 with the statistics, and with rich info and statistics together
    through the GaussianRenderer facade (its depth)."""
    import dataclasses

    import torch
    from triangle_splatting_tpu_torch.ops.projection import RasterSettings
    from triangle_splatting_tpu_torch.ops.rasterize import rasterize
    from triangle_splatting_tpu_torch.utils.testing import make_camera, make_random_scene

    s = make_random_scene(150, seed=0)
    cam = make_camera(64, 64, device=dev)
    for variant, gamma in (("2D", 1.0), ("3D", 1.0), ("3D", 50.0)):
        st = RasterSettings(image_width=64, image_height=64, rich_info=False,
                            rasterizer_type=variant)
        outs = {}
        for impl in ("cuda", "oracle"):
            with torch.no_grad():
                outs[impl] = rasterize(torch.as_tensor(s["vertex"]).to(dev),
                                       torch.as_tensor(s["opacity"]).to(dev), None, cam, st,
                                       gamma=gamma, background=torch.ones(3, device=dev),
                                       bg_depth=10.0, colors=torch.as_tensor(s["rgb"]).to(dev),
                                       impl=impl, need_stats=True)
        d = float((outs["cuda"]["render"] - outs["oracle"]["render"]).abs().max())
        nc = int((outs["cuda"]["n_contrib"] != outs["oracle"]["n_contrib"]).sum())
        ds = {k: float((outs["cuda"][k] - outs["oracle"][k]).abs().max())
              for k in ("contrib_sum", "contrib_max")}
        # the JAX package's Pallas-vs-oracle budgets (tests/test_rasterize.py)
        check(d <= 6e-4, f"{variant} kernel pipeline vs oracle render err {d:.3e} > 6e-4")
        check(nc == 0, f"{variant} kernel pipeline vs oracle n_contrib differs in {nc} pixels")
        check(max(ds.values()) <= TOL["oracle_stats_abs"],
              f"{variant} kernel pipeline vs oracle statistics err {ds}")
        check(float(outs["cuda"]["contrib_sum"].max()) > 0, f"{variant}: zero statistics")
        # with rich info (no statistics: the kernels do not run both)
        st_r = dataclasses.replace(st, rich_info=True)
        rich = {}
        for impl in ("cuda", "oracle"):
            with torch.no_grad():
                rich[impl] = rasterize(torch.as_tensor(s["vertex"]).to(dev),
                                       torch.as_tensor(s["opacity"]).to(dev), None, cam, st_r,
                                       gamma=gamma, background=torch.ones(3, device=dev),
                                       bg_depth=10.0, colors=torch.as_tensor(s["rgb"]).to(dev),
                                       impl=impl)
        dr = float((rich["cuda"]["render"] - outs["oracle"]["render"]).abs().max())
        ncr = int((rich["cuda"]["n_contrib"] != rich["oracle"]["n_contrib"]).sum())
        rel_dn = {k: float((rich["cuda"][k] - rich["oracle"][k]).abs().max())
                  / float(rich["oracle"][k].abs().max()) for k in ("depth", "normal")}
        check(dr <= 6e-4 and ncr == 0, f"{variant} rich pipeline vs oracle: render err {dr:.3e}, "
              f"n_contrib differs in {ncr} pixels")
        check(max(rel_dn.values()) <= TOL["oracle_rich_rel"],
              f"{variant} rich pipeline vs oracle: depth / normal rel err {rel_dn}")
        check(bool(torch.equal(rich["cuda"]["render"], outs["cuda"]["render"])),
              f"{variant}: the rich pipeline's render differs from the pipeline without it")
        say("reference", variant=variant, gamma=gamma, render_max_abs_err=d,
            n_contrib_mismatch=nc, contrib_sum_max_abs_err=ds["contrib_sum"],
            contrib_max_max_abs_err=ds["contrib_max"], rich_render_max_abs_err=dr,
            rich_depth_rel_err=rel_dn["depth"], rich_normal_rel_err=rel_dn["normal"],
            tol=(f"render 6e-4 abs, statistics {TOL['oracle_stats_abs']} abs, depth and "
                 f"normal rel {TOL['oracle_rich_rel']} of the max"))
    phase_reference_gs(dev, cam)


def phase_reference_gs(dev, cam) -> None:
    import torch
    from triangle_splatting_tpu_torch.ops.projection import RasterSettings
    from triangle_splatting_tpu_torch.ops.rasterize import rasterize_gaussian
    from triangle_splatting_tpu_torch.renderer import GaussianRenderer
    from triangle_splatting_tpu_torch.utils.testing import make_gs_scene

    g = make_gs_scene(120, seed=0)
    xyz, scale, rot, opacity, rgb = (torch.as_tensor(g[k]).to(dev)
                                     for k in ("xyz", "scale", "rot", "opacity", "rgb"))
    ones = torch.ones(3, device=dev)
    for gamma in (1.0, 2.0):
        st = RasterSettings(image_width=64, image_height=64, rich_info=False,
                            rasterizer_type="GS")
        with torch.no_grad():
            outs = {impl: rasterize_gaussian(xyz, scale, rot, opacity, None, cam, st,
                                             gamma=gamma, background=ones, bg_depth=10.0,
                                             colors=rgb, impl=impl, need_stats=True)
                    for impl in ("cuda", "oracle")}
        o, c = outs["oracle"], outs["cuda"]
        d = {k: float((c[k] - o[k]).abs().max()) for k in ("render", "final_T")}
        nc = int((c["n_contrib"] != o["n_contrib"]).sum())
        ds = {k: float((c[k] - o[k]).abs().max()) for k in ("contrib_sum", "contrib_max")}
        check(max(d.values()) <= 6e-4 and nc == 0, f"GS pipeline vs oracle, gamma {gamma}: "
              f"render / final_T err {d}, n_contrib differs in {nc} pixels")
        check(max(ds.values()) <= TOL["oracle_stats_abs"] and float(c["contrib_sum"].max()) > 0,
              f"GS pipeline vs oracle, gamma {gamma}: statistics err {ds}")
        say("reference", variant="GS", gamma=gamma, render_max_abs_err=d["render"],
            final_T_max_abs_err=d["final_T"], n_contrib_mismatch=nc,
            contrib_sum_max_abs_err=ds["contrib_sum"], contrib_max_max_abs_err=ds["contrib_max"],
            tol=f"render 6e-4 abs, n_contrib exact, statistics {TOL['oracle_stats_abs']} abs")
    # the facade: rich info with the statistics (its default need_stats)
    with torch.no_grad():
        fo = {impl: GaussianRenderer(cam, bg_color=(1.0, 1.0, 1.0), rich_info=True,
                                     impl=impl).render(xyz, None, rgb, opacity, scale, rot)
              for impl in ("cuda", "oracle")}
    o, c = fo["oracle"], fo["cuda"]
    dr = float((c["render"] - o["render"]).abs().max())
    nc = int((c["n_contrib"] != o["n_contrib"]).sum())
    rel_d = float((c["depth"] - o["depth"]).abs().max()) / float(o["depth"].abs().max())
    ds = {k: float((c[k] - o[k]).abs().max()) for k in ("contrib_sum", "contrib_max")}
    check(dr <= 6e-4 and nc == 0 and rel_d <= TOL["oracle_rich_rel"]
          and max(ds.values()) <= TOL["oracle_stats_abs"],
          f"GaussianRenderer(rich_info=True) vs oracle: render {dr:.3e}, n_contrib differs in "
          f"{nc} pixels, depth rel {rel_d:.3e}, statistics {ds}")
    say("reference", variant="GS", facade="GaussianRenderer(rich_info=True)",
        render_max_abs_err=dr, n_contrib_mismatch=nc, depth_rel_err=rel_d,
        contrib_sum_max_abs_err=ds["contrib_sum"], contrib_max_max_abs_err=ds["contrib_max"],
        tol=f"render 6e-4 abs, depth rel {TOL['oracle_rich_rel']} of the max")


def phase_renderer(b) -> dict:
    """The triangle renderer facade with rich info at bench-800-100k:
    TriangleRenderer(rich_info=True) renders the bench scene once in "2D"
    (gamma 1) and once in "3D" (gamma 50), without gradients, counted: B1's
    2D_rich_stats and 3D_rich_stats forms once each and no other blend form,
    B3 and B5 once per render. Its render, final_T and n_contrib are
    bit-identical to rasterize without rich info and statistics (the plain
    form), depth and normal to rasterize with rich info alone, and
    contrib_sum / contrib_max to rasterize with the statistics alone. Then
    the facade against the dense oracle on the reference phase's scene
    (64x64, 150 triangles; at the bench size the oracle's one Python step
    per triangle would take 100k steps): render 6e-4 abs, n_contrib exact,
    statistics 5e-4 abs, depth and normal rel 1e-3 of their max. Returns
    the counted run's launches."""
    import dataclasses

    import torch
    from triangle_splatting_tpu_torch.ops.cuda import reset_launches
    from triangle_splatting_tpu_torch.ops.cuda.blend import ALIGN
    from triangle_splatting_tpu_torch.ops.rasterize import _round_up, rasterize
    from triangle_splatting_tpu_torch.renderer import TriangleRenderer
    from triangle_splatting_tpu_torch.utils.testing import make_camera, make_random_scene

    dev = b["vertex"].device
    # the bench budget with a margin for the 3D variant's coverage
    max_pairs = _round_up(int(1.5 * b["ppt"] * N_TRI), ALIGN)
    cases = (("2D", 1.0), ("3D", 50.0))
    renderers = {v: TriangleRenderer(b["camera"], bg_color=(1.0, 1.0, 1.0), bg_depth=10.0,
                                     gamma=g, rich_info=True, rasterizer_type=v,
                                     max_pairs=max_pairs) for v, g in cases}
    args = (b["vertex"], None, b["rgb"], b["opacity"])
    with torch.no_grad():
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = {v: renderers[v].render(*args) for v, _ in cases}
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        for name, n in launches.items():
            want = {"blend_forward_rich_stats": 1, "blend_forward_3d_rich_stats": 1,
                    "relayout_pairs": 2, "segment_reduce_stats": 2}.get(name, 0)
            check(n == want, f"renderer: kernel {name} launched {n} times, expected {want}")
        st0 = b["settings"]
        for v, g in cases:
            o = outs[v]
            check(not bool(o["overflow"]), f"renderer {v}: pair budget overflow")
            check(tuple(o["render"].shape) == (3, RES, RES) and all(
                bool(torch.isfinite(o[k]).all()) for k in ("render", "depth", "normal",
                                                           "contrib_sum", "contrib_max")),
                  f"renderer {v}: outputs not finite or of the wrong shape")
            check(float(o["contrib_sum"].max()) > 0 and float(o["normal"].abs().max()) > 0,
                  f"renderer {v}: zero statistics or normal")
            forms = {}
            for rich, stats in ((False, False), (True, False), (False, True)):
                st = dataclasses.replace(st0, rasterizer_type=v, rich_info=rich)
                forms[(rich, stats)] = rasterize(
                    b["vertex"], b["opacity"], None, b["camera"], st, gamma=g,
                    background=torch.ones(3, device=dev), bg_depth=10.0, colors=b["rgb"],
                    max_pairs=max_pairs, need_stats=stats)
            pairs = [(k, forms[(False, False)]) for k in ("render", "final_T", "n_contrib")]
            pairs += [(k, forms[(True, False)]) for k in ("depth", "normal")]
            pairs += [(k, forms[(False, True)]) for k in ("contrib_sum", "contrib_max")]
            differ = [k for k, f in pairs if not torch.equal(o[k], f[k])]
            check(not differ, f"renderer {v}: {differ} differ from the forms without both")
            say("renderer", variant=v, gamma=g, num_pairs=int(o["num_pairs"]),
                render_ms=round(cuda_ms(lambda: renderers[v].render(*args), 5,
                                        hide_host=False), 3),
                bit_identical=[k for k, _ in pairs])
        say("renderer", counted_seconds=round(secs, 3), launches=launches)

        # against the dense oracle on the reference phase's scene
        s = make_random_scene(150, seed=0)
        cam = make_camera(64, 64, device=dev)
        small = [torch.as_tensor(s[k]).to(dev) for k in ("vertex", "rgb", "opacity")]
        for v, g in cases:
            fo = {impl: TriangleRenderer(cam, bg_color=(1.0, 1.0, 1.0), bg_depth=10.0, gamma=g,
                                         rich_info=True, rasterizer_type=v, impl=impl).render(
                      small[0], None, small[1], small[2]) for impl in ("cuda", "oracle")}
            c, o = fo["cuda"], fo["oracle"]
            d = float((c["render"] - o["render"]).abs().max())
            nc = int((c["n_contrib"] != o["n_contrib"]).sum())
            rel = {k: float((c[k] - o[k]).abs().max()) / float(o[k].abs().max())
                   for k in ("depth", "normal")}
            ds = {k: float((c[k] - o[k]).abs().max()) for k in ("contrib_sum", "contrib_max")}
            check(d <= 6e-4 and nc == 0 and max(rel.values()) <= TOL["oracle_rich_rel"]
                  and max(ds.values()) <= TOL["oracle_stats_abs"],
                  f"TriangleRenderer({v}, rich_info=True) vs oracle: render {d:.3e}, n_contrib "
                  f"differs in {nc} pixels, depth / normal rel {rel}, statistics {ds}")
            say("renderer", facade=f"TriangleRenderer({v}, rich_info=True) vs oracle, 64x64",
                gamma=g, render_max_abs_err=d, n_contrib_mismatch=nc,
                depth_rel_err=rel["depth"], normal_rel_err=rel["normal"],
                contrib_sum_max_abs_err=ds["contrib_sum"],
                contrib_max_max_abs_err=ds["contrib_max"],
                tol=(f"render 6e-4 abs, n_contrib exact, statistics {TOL['oracle_stats_abs']} "
                     f"abs, depth and normal rel {TOL['oracle_rich_rel']} of the max"))
    return launches


def probe_sass() -> dict:
    """Opcode counts of each probe kernel's SASS (csrc/probes.cu through
    compare_sass.compile_sass: build.py's flags, cuobjdump), by kernel."""
    import collections
    import tempfile

    from triangle_splatting_tpu_torch.ops.cuda.build import CSRC
    from triangle_splatting_tpu_torch.ops.cuda.compare_sass import compile_sass

    with tempfile.TemporaryDirectory() as tmp:
        sass, _ = compile_sass(CSRC / "probes.cu", Path(tmp) / "probes.cubin")
    return {name: collections.Counter(next(t for t in insn.split() if not t.startswith("@"))
                                      for insn in insns)
            for name, insns in sass.items()}


def phase_probes(dev) -> tuple[dict, dict]:
    """P1-P3 through their tools' entry points at the JAX tools' shapes
    (vpu_probe R x C = 512 x 1024, K = 65536, four ops in float32 and
    bfloat16; exp_probe 512 x 1024, K = 16384, four ops, after its fast_exp
    check; scan_probe S x C = 256 x 1024, K = 2048, seven variants, after
    its check against float64 cumprod), counted; then each probe kernel
    against its plain version at K = 64 on the same shapes (the budgets of
    tests/test_torch_cuda.py), the opcodes of each probe kernel's SASS (the
    loop holds the operation measured), and the JSON rows: P1 timed at fma
    float32, P2 at exp (expf), P3 at hs, each against its plain version at
    the full K, P3 also against K torch.cumprod + clamp_ calls replayed
    from one CUDA graph. Returns (the counted run's launches, the rows)."""
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import probes as KP
    from triangle_splatting_tpu_torch.ops.cuda import reset_launches
    from triangle_splatting_tpu_torch.tools import exp_probe, scan_probe, vpu_probe

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vpu = vpu_probe.main([])
    exp = exp_probe.main([])
    scan = scan_probe.main([])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    # each run: one warm-up and three timed launches
    want = dict(vpu_probe=4 * len(KP.VPU_OPS) * 2, exp_probe=4 * len(KP.EXP_OPS),
                scan_probe=len(KP.SCAN_VARIANTS) * 5)
    for name, n in launches.items():
        check(n == want.get(name, 0), f"probes: kernel {name} launched {n} times, "
              f"expected {want.get(name, 0)}")
    errs = scan["check"]
    for name, err in errs.items():
        check(err <= (2e-5 if name == "mxu_log" else 2e-6),
              f"scan_probe check: {name} rel err {err:.3e} against float64 cumprod")
    say("probes", counted_seconds=round(secs, 3), launches=launches, card=card_line(),
        vpu={f"{r['op']} {r['dtype']}": dict(ms=round(r["ms"], 4),
                                             tera_elem_ops_per_s=round(r["elem_ops_per_s"] / 1e12, 3))
             for r in vpu},
        exp={r["op"]: dict(ms=round(r["ms"], 4), ps_per_elem=round(r["ps_per_elem"], 4))
             for r in exp},
        scan={r["variant"]: dict(ms=round(r["ms"], 4), ns_per_scan=round(r["ns_per_scan"], 2),
                                 ps_per_elem=round(r["ps_per_elem"], 4)) for r in scan["runs"]},
        scan_check_rel_err=errs)

    # parity at K = 64 on the tools' shapes (not counted)
    gen = torch.Generator().manual_seed(0)
    x1 = (torch.rand((vpu_probe.R, vpu_probe.C), generator=gen) * 3 - 1.5).to(dev)
    x2 = (torch.rand((exp_probe.R, exp_probe.C), generator=gen) + 0.5).to(dev)
    x3 = (torch.rand((scan_probe.S, scan_probe.C), generator=gen) * 0.1 + 0.9).to(dev)
    k = PROBE_PARITY_K
    par = {}
    for op in KP.VPU_OPS:
        for dt in (torch.float32, torch.bfloat16):
            got, ref = KP.vpu_probe(x1, op, dt, k), KP.vpu_probe_plain(x1, op, dt, k)
            rel = float((got - ref).abs().max()) / float(ref.abs().max())
            exact = op in ("mul", "min3") or (dt == torch.bfloat16 and op == "fma")
            tol = 0.0 if exact else 1e-5 if op == "fma" else 2 ** -8 if dt == torch.bfloat16 else 1e-6
            check(rel <= tol, f"vpu_probe {op} {dt}: rel err {rel:.3e} > {tol}")
            par[f"vpu {op} {str(dt)[6:]}"] = rel
    for op in KP.EXP_OPS:
        got, ref = KP.exp_probe(x2, op, k), KP.exp_probe_plain(x2, op, k)
        rel = float(((got - ref).abs() / ref).max())
        check(rel <= (0.0 if op == "mul8" else 1e-6), f"exp_probe {op}: rel err {rel:.3e}")
        par[f"exp {op}"] = rel
    for v in KP.SCAN_VARIANTS:
        got, ref = KP.scan_probe(x3, v, k), KP.scan_probe_plain(x3, v, k)
        rel = float(((got - ref).abs() / ref).max())
        check(rel <= (4e-5 if v == "mxu_log" else 5e-6), f"scan_probe {v}: rel err {rel:.3e}")
        par[f"scan {v}"] = rel
    torch.cuda.synchronize()
    say("probes", parity_k=k, rel_err=par,
        tol="mul, min3 (and bf16 fma) exact; f32 fma rel 1e-5; exp rel 1e-6 (bf16 2^-8); "
            "mul8 exact; expf, fast_exp, __expf rel 1e-6; scans rel 5e-6 (mxu_log 4e-5)")

    # the SASS of every probe kernel holds the operation it measures (an
    # opcode holding one of the tokens; bf16 min3 compiles to one
    # three-input VHMNMX.BF16_V2)
    expect = {"vpu_probe_f32_kernel<0>": ("FMUL",), "vpu_probe_f32_kernel<1>": ("FFMA",),
              "vpu_probe_f32_kernel<2>": ("MNMX",), "vpu_probe_f32_kernel<3>": ("MUFU.EX2",),
              "vpu_probe_bf16_kernel<0>": ("HMUL2.BF16", "HFMA2.BF16"),
              "vpu_probe_bf16_kernel<1>": ("HFMA2.BF16",),
              "vpu_probe_bf16_kernel<2>": ("MNMX",),
              "vpu_probe_bf16_kernel<3>": ("MUFU.EX2",),
              "exp_probe_kernel<0>": ("FMUL",), "exp_probe_kernel<1>": ("MUFU.EX2",),
              "exp_probe_kernel<2>": ("FFMA",), "exp_probe_kernel<3>": ("MUFU.EX2",)}
    sass = probe_sass()
    for key, tokens in expect.items():
        check(key in sass, f"probe SASS: kernel {key} not found ({sorted(sass)})")
        counts = sass[key]
        n_op = sum(v for o, v in counts.items() if any(t in o for t in tokens))
        check(n_op > 0, f"probe SASS: {key} holds none of {tokens}: {dict(counts)}")
    say("probes", sass={n: dict(c.most_common(12)) for n, c in sass.items()})

    # the JSON rows, each at one variant
    rows = {}
    R, C, K = vpu_probe.R, vpu_probe.C, vpu_probe.K
    ones = torch.ones((R, C), device=dev)
    rows["vpu_probe"] = dict(
        max_abs_err=float((KP.vpu_probe(x1, "fma", torch.float32, k)
                           - KP.vpu_probe_plain(x1, "fma", torch.float32, k)).abs().max()),
        ms=cuda_ms(lambda: KP.vpu_probe(ones, "fma", torch.float32, K), 5),
        plain_ms=cuda_ms(lambda: KP.vpu_probe_plain(ones, "fma", torch.float32, K), 1, 0,
                         hide_host=False),
        library_ms=None,
        # a mul and an add per element-pass, as the float32 peak counts an FMA
        bound=bound_ms(8 * R * C, 2 * R * C * K))
    R, C, K = exp_probe.R, exp_probe.C, exp_probe.K
    ones = torch.ones((R, C), device=dev)
    rows["exp_probe"] = dict(
        max_abs_err=float((KP.exp_probe(x2, "exp", k) - KP.exp_probe_plain(x2, "exp", k))
                          .abs().max()),
        ms=cuda_ms(lambda: KP.exp_probe(ones, "exp", K), 5),
        plain_ms=cuda_ms(lambda: KP.exp_probe_plain(ones, "exp", K), 1, 0, hide_host=False),
        library_ms=None,
        # |v|, the product and the exp, each one operation
        bound=bound_ms(8 * R * C, 3 * R * C * K))
    S, C, K = scan_probe.S, scan_probe.C, scan_probe.K
    full = torch.full((S, C), 0.9999, device=dev)

    def cumprod_reps(v, reps):
        for _ in range(reps):
            v = torch.cumprod(v, dim=0).clamp_(0.9, 1.0)
        return v
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cumprod_reps(full, 3)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        lib_out = cumprod_reps(full, K)
    graph.replay()
    kern_out = KP.scan_probe(full, "hs", K)
    torch.cuda.synchronize()
    lib_rel = float(((lib_out - kern_out).abs() / lib_out).max())
    check(lib_rel <= 5e-6, f"scan_probe: torch.cumprod yardstick differs by rel {lib_rel:.3e}")
    rows["scan_probe"] = dict(
        max_abs_err=float((KP.scan_probe(x3, "hs", k) - KP.scan_probe_plain(x3, "hs", k))
                          .abs().max()),
        ms=cuda_ms(lambda: KP.scan_probe(full, "hs", K), 5),
        plain_ms=cuda_ms(lambda: KP.scan_probe_plain(full, "hs", K), 1, 0, hide_host=False),
        library_ms=cuda_ms(graph.replay, 5),
        # a prefix product needs S - 1 products per column; the clip two
        # operations per element
        bound=bound_ms(8 * S * C, ((S - 1) * C + 2 * S * C) * K))
    del graph
    for name, r in rows.items():
        say("probes", kernel=name, variant=PROBE_ROW[name], max_abs_err=r["max_abs_err"],
            ms=round(r["ms"], 4), plain_ms=round(r["plain_ms"], 3),
            library_ms=None if r["library_ms"] is None else round(r["library_ms"], 4),
            bound_ms=round(r["bound"][0], 5), bound_by=r["bound"][1])
    return launches, rows


def phase_rasterize(b) -> float:
    import torch
    from triangle_splatting_tpu_torch.ops.rasterize import rasterize

    dev = b["vertex"].device
    leaves = [b[k].clone().requires_grad_(True) for k in ("vertex", "opacity", "rgb")]
    bg = torch.ones(3, device=dev)

    def step():
        out = rasterize(leaves[0], leaves[1], None, b["camera"], b["settings"],
                        gamma=1.0, background=bg, bg_depth=10.0, colors=leaves[2])
        loss = (out["render"] - b["target"]).abs().mean()
        return torch.autograd.grad(loss, leaves), out

    grads, out = step()
    torch.cuda.synchronize()
    check(not bool(out["overflow"]), "rasterize: pair budget overflow")
    check(all(bool(torch.isfinite(g).all()) for g in grads), "rasterize: non-finite gradients")
    check(tuple(out["render"].shape) == (3, RES, RES), "rasterize: render shape")
    ms = cuda_ms(lambda: step(), 20, hide_host=False)
    say("rasterize", fwd_bwd_ms=round(ms, 3), resolution=RES, triangles=N_TRI,
        pairs_per_triangle=b["ppt"], num_pairs=int(out["num_pairs"]))
    return ms


WORK = REPO / "build" / "chip_smoke"


def build_dataset(dev, scene_kind: str) -> Path:
    """A synthetic NeRF-Synthetic scene of ~100k GT triangles, 8 train / 2
    test views at 800x800: the "soup" of semi-transparent triangles for
    the photo phase, the opaque "surface" for the mesh phase."""
    from triangle_splatting_tpu_torch.utils.testing import build_synthetic_nerf_dataset

    t0 = time.perf_counter()
    root = build_synthetic_nerf_dataset(
        WORK / f"data_{scene_kind}", res=RES, n_tri=N_TRI, n_train=8, n_test=2,
        size_range=(0.01, 0.05), pcd_points=N_TRI, scene_kind=scene_kind, device=dev)
    say("dataset", scene_kind=scene_kind, seconds=round(time.perf_counter() - t0, 3))
    return root


def phase_train(dev, root: Path) -> dict:
    import numpy as np
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import reset_launches
    from triangle_splatting_tpu_torch.trainers import build_trainer
    from triangle_splatting_tpu_torch.utils.config import loadConfig

    cfg = loadConfig(REPO / "config" / "NerfSynthetic_VanillaTS.yaml")
    cfg.dataset.local_dir = str(root)
    t = cfg.trainer
    t.output_dir = str(WORK / "out")
    t.iterations = TRAIN_ITERS
    t.log_interval_iter = 10
    t.eval_interval_iter = 0
    t.initial_eval = False
    t.save_iterations, t.checkpoint_iterations, t.save_glb_iterations = [], [], []
    t.use_tensorboard = False
    t.seed = 0
    cfg.model.model_update.sh_schedule.one_up_iters = [10, 20, 30]

    trainer = build_trainer(cfg, log_file=False)
    trainer._init_model()
    train_views = [trainer.dataset.getTrainDataset()[i]
                   for i in range(trainer.dataset.getTrainDatasetSize())]
    white = torch.ones(3, device=dev)
    psnr0 = float(np.mean(trainer.psnr_views(train_views, white)))

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    losses = torch.stack(trainer.loss_history).cpu().numpy()
    psnr1 = float(np.mean(trainer.psnr_views(train_views, white)))
    check(len(losses) == TRAIN_ITERS, f"expected {TRAIN_ITERS} losses, got {len(losses)}")
    check(bool(np.isfinite(losses).all()), "train: non-finite loss")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    check(last < first, f"train: loss did not fall (first10 {first:.5f}, last10 {last:.5f})")
    for name in ("blend_forward", "blend_backward", "relayout_pairs", "segment_reduce_pairs"):
        check(launches[name] > 0, f"train: kernel {name} was never launched")
    check(launches["blend_forward_3d"] == launches["blend_backward_3d"] == 0,
          "train: the photo path launched a 3D blend kernel")
    check_no_stats_launches(launches, "train")
    check_no_rich_launches(launches, "train")
    check_no_gs_launches(launches, "train")
    check(int(trainer.state.active_sh_degree) == 3, "train: SH degree did not reach 3")
    say("train", ms_per_step=round(secs / TRAIN_ITERS * 1e3, 3), steps=TRAIN_ITERS,
        peak_mem_gib=round(peak / 2**30, 3),
        triangles=int(trainer.state.alive.sum()), loss_first10=first,
        loss_last10=last, psnr_train_before=psnr0, psnr_train_after=psnr1,
        launches=launches, pairs_per_triangle=trainer._ppt)
    profile_steps(trainer)
    return launches


def profile_steps(trainer, phase: str = "profile", steps: int = 10, bg=None) -> None:
    """Where a train step's time goes at the end of a training phase:
    torch.profiler over ``steps`` more iterations, each the body of the
    trainer's loop (next camera, train step, schedules) without its
    logging; device time by kernel and the device's busy share of the
    wall time (kernels run on one stream). The cameras are fetched before
    the window (the loader re-reads its images after ``train()`` closes
    it), and the same steps run once unprofiled for the wall time, since
    the profiler's host-side tracing slows the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if bg is None:
        bg = torch.ones(3, device=trainer.device)    # train_background "white"
    cams = [trainer.dataset.nextTrainData() for _ in range(steps)]
    trainer.dataset.close()

    def run():
        t0 = time.perf_counter()
        for i, camera in enumerate(cams):
            it = TRAIN_ITERS + 1 + i
            trainer.params, trainer.opt, trainer.state, _, _ = trainer._train_step(
                trainer._settings_for(camera), trainer.params, trainer.opt,
                trainer.state, camera, trainer._loss_weights(it), trainer._lrs(it), bg, it)
            trainer._model_update(it)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    wall_ms = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_wall_ms = run()
    # device-side events only: a host op's self device time repeats the
    # kernels it launched
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    check(busy_ms > 0, "profile: the profiler recorded no device time")
    say(phase, steps=steps, wall_ms_per_step=round(wall_ms / steps, 3),
        traced_wall_ms_per_step=round(traced_wall_ms / steps, 3),
        device_busy_ms_per_step=round(busy_ms / steps, 3),
        device_busy_share=round(busy_ms / wall_ms, 4),
        top=[dict(kernel=k[:80], ms_per_step=round(ms / steps, 4), calls_per_step=c / steps)
             for ms, k, c in rows[:16]])


def phase_mesh_train(dev, root: Path) -> dict:
    """The mesh recipe without its ADC blocks: 3D rasterizer, SH 0, STE
    opacity at 0.3, gamma rescale, render_up_scale 2 (800x800 views
    rasterized at 1600x1600), L1 + 0.2 SSIM, cut to 50 steps with the
    gamma anneal moved to steps 10-40, so gamma 1, the anneal and gamma 50
    all run. The scene is the opaque surface the recipe is meant for: on
    the photo phase's soup of semi-transparent triangles solidifying costs
    more than 50 steps of training win back, and the loss rises. The
    recipe's saves move with its schedule: the PLY at the anneal's start
    (10) and at the end (50), the GLB at the end, timed apart from the
    steps; its checkpoint (not ported) is cut. Then ``check_export``."""
    import numpy as np
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import reset_launches
    from triangle_splatting_tpu_torch.trainers import build_trainer
    from triangle_splatting_tpu_torch.utils.config import loadConfig

    cfg = loadConfig(REPO / "config" / "NerfSynthetic_VanillaTS_mesh.yaml")
    mu = cfg.model.model_update
    for name in ("statistic", "scale_pruning", "contribution_pruning"):
        setattr(mu, name, None)
    mu.gamma_schedule.start_iter, mu.gamma_schedule.end_iter = 10, 40
    cfg.dataset.local_dir = str(root)
    t = cfg.trainer
    t.output_dir = str(WORK / "out_mesh")
    t.iterations = TRAIN_ITERS
    t.log_interval_iter = 10
    t.initial_eval = False
    t.use_tensorboard = False
    t.seed = 0
    # [SOLIDIFY_START_ITER, TOTAL_ITER] -> [10, 50]; [TOTAL_ITER] -> [50]
    t.save_iterations = [mu.gamma_schedule.start_iter, TRAIN_ITERS]
    t.save_glb_iterations = [TRAIN_ITERS]
    t.checkpoint_iterations = []

    trainer = build_trainer(cfg, log_file=False)
    trainer._init_model()
    train_views = [trainer.dataset.getTrainDataset()[i]
                   for i in range(trainer.dataset.getTrainDatasetSize())]
    white = torch.ones(3, device=dev)
    psnr0 = float(np.mean(trainer.psnr_views(train_views, white)))
    save_secs = {}

    def timed(kind, save):
        def wrapped(path, *a, **kw):
            t1 = time.perf_counter()
            save(path, *a, **kw)
            save_secs[f"{kind} {Path(path).name}"] = time.perf_counter() - t1
        return wrapped
    trainer.savePLY = timed("ply", trainer.savePLY)
    trainer.saveGLB = timed("glb", trainer.saveGLB)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0 - sum(save_secs.values())
    del trainer.savePLY, trainer.saveGLB
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(sorted(save_secs) == ["glb 50.glb", "ply 10.ply", "ply 50.ply"],
          f"mesh: the saves ran {sorted(save_secs)}")

    losses = torch.stack(trainer.loss_history).cpu().numpy()
    psnr1 = float(np.mean(trainer.psnr_views(train_views, white)))
    check(len(losses) == TRAIN_ITERS, f"mesh: expected {TRAIN_ITERS} losses, got {len(losses)}")
    check(bool(np.isfinite(losses).all()), "mesh: non-finite loss")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    check(last < first, f"mesh: loss did not fall (first10 {first:.5f}, last10 {last:.5f})")
    gamma = float(trainer.state.gamma)
    check(abs(gamma - 50.0) <= 1e-3, f"mesh: gamma ended at {gamma}, not 50")
    for name in ("blend_forward_3d", "blend_backward_3d", "relayout_pairs",
                 "segment_reduce_pairs"):
        check(launches[name] == TRAIN_ITERS,
              f"mesh: kernel {name} launched {launches[name]} times in {TRAIN_ITERS} steps")
    check(launches["blend_forward"] == launches["blend_backward"] == 0,
          "mesh: the 3D path launched a 2D blend kernel")
    check_no_stats_launches(launches, "mesh")
    check_no_rich_launches(launches, "mesh")
    check_no_gs_launches(launches, "mesh")
    say("mesh", ms_per_step=round(secs / TRAIN_ITERS * 1e3, 3), steps=TRAIN_ITERS,
        render_size=MESH_RES, peak_mem_gib=round(peak / 2**30, 3),
        triangles=int(trainer.state.alive.sum()), ste_triangles=trainer.triangle_count(),
        gamma_final=gamma, loss_first10=first, loss_last10=last,
        psnr_train_before=psnr0, psnr_train_after=psnr1, launches=launches,
        pairs_per_triangle=trainer._ppt,
        save_seconds={k: round(v, 3) for k, v in sorted(save_secs.items())})
    check_export(trainer, dev)
    profile_steps(trainer, "mesh_profile")
    return launches


def check_export(trainer, dev) -> None:
    """The mesh run's last PLY and GLB against the trained model, read back
    through RawTriangle: the PLY's arrays equal ``toRawTriangle()``'s, the
    GLB's vertices too (its colors are the SH DC band clipped to [0, 1]).
    The GLB rendered through MeshRenderer on the card at the first test
    view (800x800): one B1-3D rich launch and no other blend form, and
    mask > 0.5 over >= 90% of the trained model's footprint (the pixels
    the model covers with alpha > 0.5, rendered at the view's size); then
    at 200x200 of the same view on the card and on the CPU: render, mask
    and depth within 1e-3 of their scale outside a 1e-3 share of pixels
    (edge flips at gamma 50), at most 1e-2."""
    import dataclasses

    import numpy as np
    import torch
    from triangle_splatting_tpu_torch.models import triangle as M
    from triangle_splatting_tpu_torch.models.raw_triangle import RawTriangle
    from triangle_splatting_tpu_torch.ops.cuda import reset_launches
    from triangle_splatting_tpu_torch.ops.cuda.blend import ALIGN
    from triangle_splatting_tpu_torch.ops.rasterize import _round_up
    from triangle_splatting_tpu_torch.renderer import MeshRenderer

    out = Path(trainer.output_dir)
    ply, glb = out / "point_cloud" / f"{TRAIN_ITERS}.ply", out / "glb" / f"{TRAIN_ITERS}.glb"
    raw = trainer.toRawTriangle()
    back = RawTriangle(ply_path=ply)
    same = [bool(np.array_equal(getattr(back, k), getattr(raw, k)))
            for k in ("vertex", "opacity", "shs")]
    check(all(same), f"export: the PLY read back differs from toRawTriangle() {same}")
    mesh = RawTriangle(glb_path=glb)
    check(len(mesh) == len(raw) > 0 and np.array_equal(mesh.vertex, raw.vertex),
          f"export: the GLB read back has {len(mesh)} faces, the model {len(raw)}")
    cam = next(iter(trainer.dataset.getTestDataset()))
    bg = (1.0, 1.0, 1.0)
    # budget: the faces (front and back) at twice the trainer's pairs per triangle
    max_pairs = _round_up(int(2 * trainer._ppt * 2 * len(mesh)), ALIGN)
    with torch.no_grad():
        reset_launches()
        r = MeshRenderer(cam, bg_color=bg, max_pairs=max_pairs)
        card = r.render(mesh_path=str(glb))
        torch.cuda.synchronize()
        launches = read_launches()
        blends = {k: n for k, n in launches.items() if k.startswith("blend_") and n}
        check(blends == {"blend_forward_3d_rich": 1},
              f"export: MeshRenderer launched {blends}, expected one blend_forward_3d_rich")
        render_ms = cuda_ms(lambda: r.render(mesh_path=str(glb)), 3, hide_host=False)
        cfg = dataclasses.replace(trainer.model_cfg, render_up_scale=None)
        pkg = M.forward(trainer.params, trainer.state, cam, torch.ones(3, device=dev), cfg,
                        trainer._settings_for(cam), is_training=False)
        foot = (1.0 - pkg["final_T"]) > 0.5
        covered = card["mask"][0] > 0.5
        share = float((covered & foot).sum()) / max(int(foot.sum()), 1)
        iou = float((covered & foot).sum()) / max(int((covered | foot).sum()), 1)
        check(int(foot.sum()) > 0.05 * foot.numel() and share >= 0.9,
              f"export: the GLB's mask covers {share:.3f} of the model's footprint "
              f"({int(foot.sum())} pixels)")

        def small(c, d):
            return dataclasses.replace(
                c, world_view=c.world_view.to(d), full_proj=c.full_proj.to(d),
                camera_center=c.camera_center.to(d), tan_fovx=c.tan_fovx.to(d),
                tan_fovy=c.tan_fovy.to(d), gt_image=None, alpha_mask=None,
                image_width=200, image_height=200)
        lo = {name: MeshRenderer(small(cam, d), bg_color=bg, max_pairs=max_pairs).render(
            mesh_path=str(glb)) for name, d in (("cpu", torch.device("cpu")), ("card", dev))}
        err = {}
        for k in ("render", "mask", "depth"):
            a, b = lo["card"][k].cpu(), lo["cpu"][k]
            d = (a - b).abs() / max(1.0, float(b.abs().max()))
            err[k] = (float(d.max()), float((d > 1e-3).float().mean()))
            check(err[k][1] <= 1e-3 and err[k][0] <= 1e-2,
                  f"export: MeshRenderer card vs CPU {k}: max {err[k][0]:.3e}, "
                  f"share > 1e-3 {err[k][1]:.2e}")
    say("export", ply=str(ply.relative_to(WORK)), glb=str(glb.relative_to(WORK)),
        faces=len(mesh), glb_bytes=glb.stat().st_size, ply_bytes=ply.stat().st_size,
        mesh_render_ms=round(render_ms, 3), footprint_pixels=int(foot.sum()),
        footprint_covered_share=share, mask_iou=iou,
        card_vs_cpu_200={k: dict(max=v[0], share_above_1e_3=v[1]) for k, v in err.items()})


def phase_mesh_adc(dev, root: Path) -> dict:
    """The mesh recipe as shipped, its statistic / scale_pruning /
    contribution_pruning blocks included, cut to 50 steps: the statistic
    window over steps (5, 40], scale pruning every 10 and contribution
    pruning every 20 steps in (5, 40] (so at 20 and 40), the gamma anneal
    at steps 10-40, and target_point_num 93,000 (run_experiments.py's
    "ship" preset; the recipe ships null, on which the JAX trainer
    raises). Every other knob is the recipe's. Each step renders with the
    contribution statistics (B1-3D's stats form, owner sort, B5)."""
    import numpy as np
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import reset_launches
    from triangle_splatting_tpu_torch.trainers import build_trainer
    from triangle_splatting_tpu_torch.utils.config import loadConfig

    cfg = loadConfig(REPO / "config" / "NerfSynthetic_VanillaTS_mesh.yaml")
    mu = cfg.model.model_update
    start, end = ADC_STAT_WINDOW
    mu.statistic.start_iter, mu.statistic.end_iter = start, end
    mu.scale_pruning.start_iter, mu.scale_pruning.end_iter = start, end
    mu.scale_pruning.interval_iter = ADC_SCALE_INTERVAL
    cp = mu.contribution_pruning
    cp.start_iter, cp.end_iter, cp.interval_iter = start, end, ADC_CONTRIB_INTERVAL
    cp.target_point_num = ADC_TARGET
    mu.gamma_schedule.start_iter, mu.gamma_schedule.end_iter = 10, 40
    cfg.dataset.local_dir = str(root)
    t = cfg.trainer
    t.output_dir = str(WORK / "out_mesh_adc")
    t.iterations = TRAIN_ITERS
    t.log_interval_iter = 10
    t.initial_eval = False
    t.use_tensorboard = False
    t.seed = 0

    trainer = build_trainer(cfg, log_file=False)
    trainer._init_model()
    alive0 = int(trainer.state.alive.sum())
    # host time at the end of each step (the loop's last call), to split
    # the steps at which a pruning fired from the others
    stamps = []

    def timed_model_update(it, update=trainer._model_update):
        update(it)
        stamps.append(time.perf_counter())
    trainer._model_update = timed_model_update

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    del trainer._model_update
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    losses = torch.stack(trainer.loss_history).cpu().numpy()
    n = TRAIN_ITERS
    check(len(losses) == n, f"mesh_adc: expected {n} losses, got {len(losses)}")
    check(bool(np.isfinite(losses).all()), "mesh_adc: non-finite loss")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    check(last < first, f"mesh_adc: loss did not fall (first10 {first:.5f}, last10 {last:.5f})")
    gamma = float(trainer.state.gamma)
    check(abs(gamma - 50.0) <= 1e-3, f"mesh_adc: gamma ended at {gamma}, not 50")
    for name in ("blend_forward_3d_stats", "segment_reduce_stats", "blend_backward_3d",
                 "relayout_pairs", "segment_reduce_pairs"):
        check(launches[name] == n, f"mesh_adc: kernel {name} launched {launches[name]} "
              f"times in {n} steps")
    for name in ("blend_forward", "blend_forward_3d", "blend_forward_stats", "blend_backward"):
        check(launches[name] == 0, f"mesh_adc: kernel {name} launched {launches[name]} times")
    check_no_rich_launches(launches, "mesh_adc")
    check_no_gs_launches(launches, "mesh_adc")
    hist = trainer.prune_history
    contrib = [(it, k) for it, kind, k in hist if kind == "contribution"]
    scale = [(it, k) for it, kind, k in hist if kind == "scale"]
    due = [it for it in range(start + 1, end + 1) if it % ADC_CONTRIB_INTERVAL == 0]
    check([it for it, _ in contrib] == due, f"mesh_adc: contribution pruning fired at "
          f"{contrib}, due at {due}")
    check(all(k > 0 for _, k in contrib), f"mesh_adc: a contribution pruning removed nothing {contrib}")
    alive1 = int(trainer.state.alive.sum())
    check(alive0 - alive1 == sum(k for _, _, k in hist),
          f"mesh_adc: alive {alive0} -> {alive1}, logged prunes {hist}")
    st = trainer.state
    alive = st.alive
    seen = float((st.gradient_denom[alive] >= 1).float().mean())
    check(seen >= 0.5, f"mesh_adc: only {seen:.3f} of the alive rows have gradient_denom >= 1")
    check(bool(torch.isfinite(st.gradient_accum).all()), "mesh_adc: non-finite gradient_accum")
    fired = {it for it, _, _ in hist}
    steps = np.diff(np.array([t0] + stamps)) * 1e3
    quiet = [ms for it, ms in zip(range(1, n + 1), steps) if it not in fired]
    say("mesh_adc", ms_per_step=round(secs / n * 1e3, 3), steps=n,
        ms_per_step_without_firings=round(float(np.mean(quiet)), 3),
        ms_firing_steps={it: round(float(steps[it - 1]), 3) for it in sorted(fired)},
        render_size=MESH_RES, peak_mem_gib=round(peak / 2**30, 3), alive_before=alive0,
        alive_after=alive1, contribution_pruned=contrib, scale_pruned=scale,
        gradient_denom_seen_share=seen, ste_triangles=trainer.triangle_count(),
        gamma_final=gamma, loss_first10=first, loss_last10=last, launches=launches,
        pairs_per_triangle=trainer._ppt)
    profile_steps(trainer, "mesh_adc_profile")
    return launches


def build_city(dev) -> Path:
    """The synthetic city (``make_city_scene``: a 6 x 6 ground and 16
    buildings, ~40k opaque triangles) written in MatrixCity's block_all
    layout: 8 train / 2 test aerial views at 1600x900 and a 4M-point
    fused.ply; prints the host seconds of each step. Returns the root."""
    from triangle_splatting_tpu_torch.utils.testing import make_city_scene, write_matrix_city

    t0 = time.perf_counter()
    scene = make_city_scene(0)
    root = WORK / "matrix_city"
    secs = write_matrix_city(root, scene, width=CITY_W, height=CITY_H, n_train=8, n_test=2,
                             n_points=CITY_POINTS, device=dev)
    secs["total"] = time.perf_counter() - t0
    say("city_data", gt_triangles=int(scene["vertex"].shape[0]), points=CITY_POINTS,
        host_seconds={k: round(v, 3) for k, v in secs.items()})
    return root


def phase_city(dev, root: Path, cmp=None) -> tuple[dict, dict]:
    """config/MatrixCity_VanillaTS_mesh.yaml as shipped, on the synthetic
    city, with the cuts of CITY_CUTS (the recipe's cadences compressed
    into 50 steps). Gates: losses finite and falling; the geometry term
    > 0 and finite from step 6; gamma 50 at the end; each opacity pruning
    lowers the alive count by its logged count and each clipping changes
    exactly its logged count of opacities; B1/B2-3D's rich forms, B3 and
    B4 once per step and no other blend form, no B5; B2's K row (13) zero
    at step 5 and nonzero at steps 6 and 50 (the geometry term's weight
    turns on at 6). Then B1/B2 rich, B3 and B4 against their plain
    versions on the last step's own inputs (the main path's shapes) and
    opacity clipping and pruning on the card against the CPU
    (``check_opacity_adc``). Returns the launches and the kernel records."""
    import numpy as np
    import torch
    from triangle_splatting_tpu_torch.ops import binning as BN
    from triangle_splatting_tpu_torch.ops import rasterize as RZ
    from triangle_splatting_tpu_torch.ops.cuda import blend as KB
    from triangle_splatting_tpu_torch.ops.cuda import reset_launches
    from triangle_splatting_tpu_torch.ops.cuda import streams as KS
    from triangle_splatting_tpu_torch.trainers import build_trainer
    from triangle_splatting_tpu_torch.utils.config import loadConfig

    cfg = loadConfig(REPO / "config" / "MatrixCity_VanillaTS_mesh.yaml")
    cfg.dataset.local_dir = str(root)
    mu = cfg.model.model_update
    op, oc, sp = mu.opacity_pruning, mu.opacity_clipping, mu.scale_pruning
    op.start_iter, op.end_iter, op.hold_iter, op.interval_iter = 5, 60, 40, 10
    oc.start_iter, oc.end_iter, oc.hold_iter, oc.interval_iter = 10, 40, 40, 10
    sp.start_iter, sp.end_iter, sp.interval_iter = 5, 40, 10
    mu.gamma_schedule.start_iter, mu.gamma_schedule.end_iter = 10, 40
    t = cfg.trainer
    n = TRAIN_ITERS
    t.iterations = n
    t.output_dir = str(WORK / "out_city")
    t.geometry_loss.start_iter = 5
    t.w_opacity_reg.quad_start_iter, t.w_opacity_reg.linear_start_iter = 5, 40
    t.log_interval_iter = 10
    t.initial_eval = False
    saves = (t.save_iterations or []) + (t.checkpoint_iterations or []) + (t.save_glb_iterations or [])
    check(all(it > n for it in saves), "city: a save iteration lies inside the run")
    say("city", cell="matrixcity-mesh-1600x900-1m", cuts=CITY_CUTS)

    t0 = time.perf_counter()
    trainer = build_trainer(cfg, log_file=False)
    host = dict(load_cameras=time.perf_counter() - t0)
    timed = {}

    def timer(name, fn):
        def wrapped(*a, **kw):
            t1 = time.perf_counter()
            out = fn(*a, **kw)
            timed[name] = time.perf_counter() - t1
            return out
        return wrapped
    trainer.dataset.getPointCloud = timer("load_point_cloud", trainer.dataset.getPointCloud)
    trainer._sample_points = timer("grid_sampling", trainer._sample_points)
    t0 = time.perf_counter()
    trainer._init_model()
    host["init_model"] = time.perf_counter() - t0
    host.update(timed)
    alive0 = int(trainer.state.alive.sum())
    check(CITY_TRIANGLES[0] <= alive0 <= CITY_TRIANGLES[1],
          f"city: grid sampling gave {alive0} triangles, not {CITY_TRIANGLES}")
    psnr0 = trainer._evaluate(0)

    # The spies act at three steps only and pass every other call straight
    # through: at step 5 (the last with the geometry weight 0, so the depth
    # cotangent is exactly 0), step 6 (the first with it on) and the last
    # step they read B2's K row, and at the last step they keep the inputs
    # of B1-B4, held against the plain versions after the run. The ADC spy
    # snapshots the alive mask and the opacities only at the blocks'
    # cadence steps.
    k_steps = (5, 6, n)
    step = {"next": 1}           # the step the next launches belong to
    last, k_rows, firings = {}, {}, []
    real = dict(fwd=RZ.blend_forward, bwd=RZ.blend_backward, b3=BN.relayout_pairs,
                b4=RZ.segment_reduce_pairs)

    def spy(name):
        def wrapped(*a, **kw):
            out = real[name](*a, **kw)
            if step["next"] == n:
                last[name] = (a, kw)
            if name == "bwd" and step["next"] in k_steps:
                k_rows[step["next"]] = out[13].abs().max()
            return out
        return wrapped

    update0 = trainer._model_update

    def update_spy(it):
        step["next"] = it + 1
        if all(it % b.interval_iter for b in (op, oc, sp)):
            return update0(it)
        alive, opac = trainer.state.alive.clone(), trainer.params.opacity.clone()
        n_hist = len(trainer.prune_history)
        update0(it)
        fired = trainer.prune_history[n_hist:]
        if fired:
            firings.append(dict(
                it=it, logged=fired,
                alive_drop=int(alive.sum()) - int(trainer.state.alive.sum()),
                opacity_changed=int((trainer.params.opacity != opac).any(dim=1).sum())))
    RZ.blend_forward, RZ.blend_backward = spy("fwd"), spy("bwd")
    BN.relayout_pairs, RZ.segment_reduce_pairs = spy("b3"), spy("b4")
    trainer._model_update = update_spy
    try:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        RZ.blend_forward, RZ.blend_backward = real["fwd"], real["bwd"]
        BN.relayout_pairs, RZ.segment_reduce_pairs = real["b3"], real["b4"]
        del trainer._model_update
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    losses = torch.stack(trainer.loss_history).cpu().numpy()
    geos = torch.stack(trainer.geo_history).cpu().numpy()
    k_max = {it: float(k_rows[it]) for it in sorted(k_rows)}
    check(len(losses) == n, f"city: expected {n} losses, got {len(losses)}")
    check(bool(np.isfinite(losses).all()), "city: non-finite loss")
    first, last10 = float(losses[:10].mean()), float(losses[-10:].mean())
    check(last10 < first, f"city: loss did not fall (first10 {first:.5f}, last10 {last10:.5f})")
    check(bool(np.isfinite(geos).all() and (geos[5:] > 0).all()),
          f"city: geometry term not > 0 and finite from step 6: {geos.tolist()}")
    gamma = float(trainer.state.gamma)
    check(abs(gamma - 50.0) <= 1e-3, f"city: gamma ended at {gamma}, not 50")
    # before the geometry term starts (weight 0 through step 5) the depth
    # cotangent is exactly 0, from step 6 on it reaches B2's K row
    check(list(k_max) == list(k_steps) and k_max[5] == 0.0 and k_max[6] > 0 and k_max[n] > 0,
          f"city: B2's K row (the depth cotangent) at steps {k_steps}: {k_max}")
    for name in ("blend_forward_3d_rich", "blend_backward_3d_rich", "relayout_pairs",
                 "segment_reduce_pairs"):
        check(launches[name] == n, f"city: kernel {name} launched {launches[name]} times "
              f"in {n} steps")
    for name, cnt in launches.items():
        if name.startswith("blend_") and not name.endswith("_3d_rich") or name == "segment_reduce_stats":
            check(cnt == 0, f"city: kernel {name} launched {cnt} times")
    kinds = {}
    for f in firings:
        for it, kind, cnt in f["logged"]:
            kinds.setdefault(kind, []).append((it, cnt))
        pruned = sum(cnt for _, kind, cnt in f["logged"] if kind != "clipping")
        clipped = sum(cnt for _, kind, cnt in f["logged"] if kind == "clipping")
        check(f["alive_drop"] == pruned, f"city: step {f['it']} pruned {f['alive_drop']} rows, "
              f"logged {f['logged']}")
        check(f["opacity_changed"] == clipped, f"city: step {f['it']} changed "
              f"{f['opacity_changed']} opacities, logged {f['logged']}")
    due = {"opacity": list(range(10, 41, 10)), "clipping": [20, 30, 40],
           "scale": list(range(10, 41, 10))}
    for kind, its in due.items():
        check([it for it, _ in kinds.get(kind, [])] == its,
              f"city: {kind} fired at {kinds.get(kind)}, due at {its}")
    alive1 = int(trainer.state.alive.sum())
    check(alive0 - alive1 == sum(cnt for kind in ("opacity", "scale")
                                 for _, cnt in kinds.get(kind, [])),
          f"city: alive {alive0} -> {alive1}, logged {kinds}")
    psnr1 = trainer._evaluate(n)
    say("city", ms_per_step=round(secs / n * 1e3, 3), steps=n, resolution=[CITY_W, CITY_H],
        peak_mem_gib=round(peak / 2**30, 3), host_seconds={k: round(v, 3) for k, v in host.items()},
        triangles_init=alive0, triangles_end=alive1, firings=kinds, gamma_final=gamma,
        loss_first=float(losses[0]), loss_last=float(losses[-1]), loss_first10=first,
        loss_last10=last10, geometry_step6=float(geos[5]), geometry_last=float(geos[-1]),
        k_row_max=k_max, psnr_test_before=psnr0, psnr_test_after=psnr1,
        launches=launches, pairs_per_triangle=trainer._ppt)

    # B1/B2 rich on the last step's own inputs: the main path's shapes
    (fa, fkw), (ba, bkw) = last["fwd"], last["bwd"]
    geo = {k: fkw[k] for k in ("image_width", "image_height", "tile_h", "tile_w", "variant")}
    fwd = tuple(x.detach() for x in fa[:4])          # no autograd history
    with torch.no_grad():
        off = KB.blend_forward(*fwd, **geo)
        r = check_blend_rich(fwd, geo, off, [x.detach() for x in ba[6:10]], "3D, city")
        num_pairs = int(fwd[2].to(torch.int64).sum())
        g50 = False          # the last step runs at gamma 50
        rec = {
            "blend_forward_3d_rich": dict(
                max_abs_err=r["b1_err"],
                ms=b1_ms(r["fwd"], geo, rich=True, cmp=cmp, site="city last step"),
                plain_ms=cuda_ms(lambda: KB.blend_forward_plain(*r["fwd"], rich=True, **geo), 2, 1),
                library_ms=None,
                bound=bound_ms(r["b1_bytes"], b1_ops(b1_work(fwd, geo, off[4], "city"), "3D",
                                                     g50, rich=True)),
                tol=r["b1_tol"]),
            "blend_backward_3d_rich": dict(
                max_abs_err=r["b2_err"],
                ms=b2_ms(r["bw"], geo, rich=True, cmp=cmp, site="city last step"),
                plain_ms=cuda_ms(lambda: KB.blend_backward_plain(*r["bw"], rich=True, **geo), 2, 1),
                library_ms=None,
                bound=bound_ms(r["b2_bytes"], (BWD_OPS_PER_EVAL_3D[g50] + RICH_BWD_OPS["3D"])
                               * r["evals"]),
                tol=r["b2_tol"]),
        }
        for name, x in rec.items():
            say("city_kernels", kernel=name, max_abs_err=x["max_abs_err"], tol=x["tol"],
                ms=round(x["ms"], 4), plain_ms=round(x["plain_ms"], 3),
                bound_ms=round(x["bound"][0], 5), bound_by=x["bound"][1])
        say("city_kernels", tiles=int(fwd[2].shape[0]), num_pairs=num_pairs, ma=int(fwd[0].shape[1]),
            pair_pixel_evals=r["evals"], b1_rel_err_depth=r["rel_depth"],
            b1_rel_err_normal=r["rel_normal"], b2_rel_err=r["b2_rel"],
            b2_k_row_max=r["depth_row_max"])
        # B3 and B4 on the last step's own inputs: 1,450 tiles with a
        # partial last row, and B2-3D-rich's 14 live rows per pair
        a3 = last["b3"][0] + tuple(last["b3"][1].values())
        a4 = tuple(x.detach() if torch.is_tensor(x) else x
                   for x in last["b4"][0] + tuple(last["b4"][1].values()))
        _, err3 = hold_relayout(a3, "city")
        c4 = hold_segment_reduce(a4, "city")
        T, ma, np3 = int(a3[3].shape[0]), int(a3[4]), int(a3[3].sum())
        rows4, P, np4 = int(a4[0].shape[0]), int(a4[1].shape[0]), int(a4[3])
        b3 = bound_ms(4 * (np3 + 3 * (T + 1) + ma))
        b4 = bound_ms(4 * (rows4 * np4 + 2 * P + 1) + 4 * 16 * P, rows4 * np4)
        say("city_kernels", kernel="relayout_pairs", max_abs_err=err3, tol="exact", tiles=T,
            num_pairs=np3, ma=ma, ms=round(cuda_ms(lambda: KS.relayout_pairs(*a3), 50), 4),
            plain_ms=round(cuda_ms(lambda: KS.relayout_pairs_plain(*a3), 10), 3),
            bound_ms=round(b3[0], 5), bound_by=b3[1])
        say("city_kernels", kernel="segment_reduce_pairs", max_abs_err=c4["err"],
            rel_err=c4["rel"], tol=f"rel {TOL['b4_rel']} of the max", rows=rows4,
            triangles=P, num_pairs=np4,
            ms=round(cuda_ms(lambda: KS.segment_reduce_pairs(*a4), 50), 4),
            plain_ms=round(cuda_ms(lambda: KS.segment_reduce_pairs_plain(*a4), 10), 3),
            bound_ms=round(b4[0], 5), bound_by=b4[1])
        del last, r, fwd, off, a3, a4, c4
        check_opacity_adc(trainer.params, trainer.opt, trainer.state)
    profile_steps(trainer, "city_profile", bg=torch.zeros(3, device=dev))
    return launches, rec


def phase_gs(dev, root: Path) -> dict:
    """The gs-800-100k cell: ``gs_config`` (the JAX smoke's VanillaGS recipe
    with the cuts of GS_CUTS) on the photo phase's soup through
    build_trainer for 50 steps. Gates: losses finite and falling; B1-GS's
    stats form, B2-GS, B3, B4 and B5 once per step and no other blend form;
    contribution pruning at 20 and 40 removing > 0, opacity pruning at 50,
    the alive count falling by exactly the logged counts; SH degree 3. Then
    B1-GS stats, B2-GS, B3, B4 (10 rows) and B5 held against their plain
    versions on the last step's own inputs (captured detached by spies
    that act at that step only), and 10 profiled steps. Returns the
    launches."""
    import numpy as np
    import torch
    from triangle_splatting_tpu_torch.ops import binning as BN
    from triangle_splatting_tpu_torch.ops import rasterize as RZ
    from triangle_splatting_tpu_torch.ops.cuda import blend as KB
    from triangle_splatting_tpu_torch.ops.cuda import reset_launches
    from triangle_splatting_tpu_torch.ops.cuda import streams as KS
    from triangle_splatting_tpu_torch.trainers import build_trainer
    from triangle_splatting_tpu_torch.utils.config import dict_to_config

    n = GS_ITERS
    say("gs", cell="gs-800-100k", cuts=GS_CUTS)
    trainer = build_trainer(dict_to_config(gs_config(root)), log_file=False)
    trainer._init_model()
    alive0 = int(trainer.state.alive.sum())
    psnr0 = trainer._evaluate(0)

    step = {"next": 1}
    last = {}
    real = dict(fwd=RZ.blend_forward, bwd=RZ.blend_backward, b3=BN.relayout_pairs,
                b4=RZ.segment_reduce_pairs, b5=RZ.segment_reduce_stats)

    def detached(x):
        return x.detach() if torch.is_tensor(x) else x

    def spy(name):
        def wrapped(*a, **kw):
            if step["next"] == n:
                last[name] = (tuple(detached(x) for x in a),
                              {k: detached(v) for k, v in kw.items()})
            return real[name](*a, **kw)
        return wrapped

    update0 = trainer._model_update

    def update_spy(it):
        step["next"] = it + 1
        return update0(it)
    RZ.blend_forward, RZ.blend_backward = spy("fwd"), spy("bwd")
    BN.relayout_pairs, RZ.segment_reduce_pairs = spy("b3"), spy("b4")
    RZ.segment_reduce_stats = spy("b5")
    trainer._model_update = update_spy
    try:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        RZ.blend_forward, RZ.blend_backward = real["fwd"], real["bwd"]
        BN.relayout_pairs, RZ.segment_reduce_pairs = real["b3"], real["b4"]
        RZ.segment_reduce_stats = real["b5"]
        del trainer._model_update
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    losses = torch.stack(trainer.loss_history).cpu().numpy()
    check(len(losses) == n, f"gs: expected {n} losses, got {len(losses)}")
    check(bool(np.isfinite(losses).all()), "gs: non-finite loss")
    first, last10 = float(losses[:10].mean()), float(losses[-10:].mean())
    check(last10 < first, f"gs: loss did not fall (first10 {first:.5f}, last10 {last10:.5f})")
    for name in ("blend_forward_gs_stats", "blend_backward_gs", "relayout_pairs",
                 "segment_reduce_pairs", "segment_reduce_stats"):
        check(launches[name] == n, f"gs: kernel {name} launched {launches[name]} times in {n} steps")
    for name, cnt in launches.items():
        if name.startswith("blend_") and name not in ("blend_forward_gs_stats", "blend_backward_gs"):
            check(cnt == 0, f"gs: kernel {name} launched {cnt} times")
    hist = trainer.prune_history
    kinds = {}
    for it, kind, cnt in hist:
        kinds.setdefault(kind, []).append((it, cnt))
    start, end = GS_CONTRIB_WINDOW
    due = [it for it in range(start + 1, end + 1) if it % GS_CONTRIB_INTERVAL == 0]
    check([it for it, _ in kinds.get("contribution", [])] == due and
          all(k > 0 for _, k in kinds.get("contribution", [])),
          f"gs: contribution pruning fired {kinds.get('contribution')}, due at {due} with > 0")
    check([it for it, _ in kinds.get("opacity", [])] == [n],
          f"gs: opacity pruning fired {kinds.get('opacity')}, due at {n}")
    alive1 = int(trainer.state.alive.sum())
    check(alive0 - alive1 == sum(k for _, _, k in hist),
          f"gs: alive {alive0} -> {alive1}, logged prunes {hist}")
    check(int(trainer.state.active_sh_degree) == 3, "gs: SH degree did not reach 3")
    check(bool(torch.isfinite(trainer.state.gradient_accum).all()), "gs: non-finite statistics")
    psnr1 = trainer._evaluate(n)
    say("gs", ms_per_step=round(secs / n * 1e3, 3), steps=n, resolution=RES,
        peak_mem_gib=round(peak / 2**30, 3), gaussians_init=alive0, gaussians_end=alive1,
        firings=kinds, loss_first10=first, loss_last10=last10, psnr_test_before=psnr0,
        psnr_test_after=psnr1, launches=launches, pairs_per_triangle=trainer._ppt)

    # B1-GS stats, B2-GS, B3, B4 and B5 on the last step's own inputs
    (fa, fkw), (ba, bkw) = last["fwd"], last["bwd"]
    geo = {k: fkw[k] for k in ("image_width", "image_height", "tile_h", "tile_w", "variant")}
    check(fkw["stats"] and not fkw["rich"] and geo["variant"] == "GS",
          f"gs: the last step's B1 ran in form {fkw}")
    fwd = fa[:4]
    H, W = geo["image_height"], geo["image_width"]
    rec = {}
    with torch.no_grad():
        out = KB.blend_forward(*fwd, stats=True, **geo)
        ref = KB.blend_forward_plain(*fwd, stats=True, **geo)
        torch.cuda.synchronize()
        e_nc = int((out[4] != ref[4]).sum())
        e_T = float((out[3] - ref[3]).abs().max())
        e_c = float((out[0] - ref[0]).abs().max())
        e_s = float((out[5][0] - ref[5][0]).abs().max()) / max(float(ref[5][0].abs().max()), 1e-30)
        e_m = float((out[5][1] - ref[5][1]).abs().max())
        check(e_nc == 0 and e_T == 0.0 and e_c <= TOL["b1_abs"] and e_s <= TOL["stats_sum_rel"]
              and e_m == 0.0, f"gs last step: B1-GS stats vs plain: n_contrib {e_nc}, final_T "
              f"{e_T:.3e}, color {e_c:.3e}, stream sum rel {e_s:.3e}, max {e_m:.3e}")
        bw = fa[:4] + ba[4:8]
        out2 = KB.blend_backward(*bw, **geo)
        ref2 = KB.blend_backward_plain(*bw, **geo)
        torch.cuda.synchronize()
        live = KB.LIVE_GRAD_ROWS[("GS", False)]
        diff2 = (out2 - ref2).abs()
        rel2 = float((diff2.amax(dim=1) / ref2.abs().amax(dim=1).clamp_min(1e-30))[:live].max())
        check(rel2 <= TOL["b2_rel"] and not bool(out2[live:].any()),
              f"gs last step: B2-GS vs plain rel err {rel2:.3e}")
        a3 = last["b3"][0] + tuple(last["b3"][1].values())
        a4 = last["b4"][0] + tuple(last["b4"][1].values())
        a5 = last["b5"][0] + tuple(last["b5"][1].values())
        _, err3 = hold_relayout(a3, "gs")
        c4 = hold_segment_reduce(a4, "gs")
        s5, m5 = KS.segment_reduce_stats(*a5)
        rs5, rm5 = KS.segment_reduce_stats_plain(*a5)
        torch.cuda.synchronize()
        e5 = float((s5 - rs5).abs().max()) / max(float(rs5.abs().max()), 1e-30)
        em5 = float((m5 - rm5).abs().max())
        check(e5 <= TOL["b5_rel"] and em5 == 0.0, f"gs last step: B5 sum rel {e5:.3e}, max {em5:.3e}")
        evals = float(out[4].to(torch.float64).sum())
        num_pairs, T, ma = int(fwd[2].to(torch.int64).sum()), fwd[2].shape[0], fwd[0].shape[1]
        pairs_in = 4 * (10 * num_pairs + 2 * T + 1 + 8)
        rows4, P, np4 = int(a4[0].shape[0]), int(a4[1].shape[0]), int(a4[3])
        np5 = int(a5[4])
        b1 = bound_ms(pairs_in + 4 * 9 * H * W + 8 * ma,
                      b1_ops(b1_work(fwd, geo, out[4], "gs last step"), "GS", True, stats=True))
        b2 = bound_ms(pairs_in + 4 * 6 * H * W + 4 * 16 * ma, BWD_OPS_PER_EVAL_GS[True] * evals)
        b3 = bound_ms(4 * (int(a3[3].sum()) + 3 * (int(a3[3].shape[0]) + 1) + int(a3[4])))
        b4 = bound_ms(4 * (rows4 * np4 + 2 * P + 1) + 4 * 16 * P, rows4 * np4)
        b5 = bound_ms(4 * (2 * np5 + 2 * P + 1) + 4 * 2 * P, B5_OPS_PER_PAIR * np5)
        rows = {
            "blend_forward_gs_stats": (e_c, lambda: KB.blend_forward(*fwd, stats=True, **geo),
                                       lambda: KB.blend_forward_plain(*fwd, stats=True, **geo), b1),
            "blend_backward_gs": (float(diff2.max()), lambda: KB.blend_backward(*bw, **geo),
                                  lambda: KB.blend_backward_plain(*bw, **geo), b2),
            "relayout_pairs": (err3, lambda: KS.relayout_pairs(*a3),
                               lambda: KS.relayout_pairs_plain(*a3), b3),
            "segment_reduce_pairs": (c4["err"], lambda: KS.segment_reduce_pairs(*a4),
                                     lambda: KS.segment_reduce_pairs_plain(*a4), b4),
            "segment_reduce_stats": (max(float((s5 - rs5).abs().max()), em5),
                                     lambda: KS.segment_reduce_stats(*a5),
                                     lambda: KS.segment_reduce_stats_plain(*a5), b5),
        }
        for name, (err, kfn, pfn, b) in rows.items():
            rec[name] = dict(max_abs_err=err, ms=cuda_ms(kfn, 20 if "blend" in name else 50),
                             plain_ms=cuda_ms(pfn, 2, 1), bound=b)
            say("gs_kernels", kernel=name, max_abs_err=err, ms=round(rec[name]["ms"], 4),
                plain_ms=round(rec[name]["plain_ms"], 3), bound_ms=round(b[0], 5), bound_by=b[1])
        say("gs_kernels", tiles=T, num_pairs=num_pairs, ma=ma, pair_pixel_evals=evals,
            b1_n_contrib_mismatch=e_nc, b1_final_T_err=e_T, b1_stream_sum_rel_err=e_s,
            b1_stream_max_err=e_m, b2_rel_err=rel2, b3_mismatch=err3, b4_rows=rows4,
            b4_rel_err=c4["rel"], b5_sum_rel_err=e5, b5_max_err=em5, gaussians=P)
        del last, out, ref, out2, ref2, bw, fwd, a3, a4, a5
    profile_steps(trainer, "gs_profile")
    return launches


def check_opacity_adc(params, opt, state) -> None:
    """Opacity clipping and opacity pruning of the trained model on the card
    against the same calls on a CPU copy. The run's own firings change no
    row at the recipe's thresholds, so these pick thresholds that select
    a tenth or more of the live rows each: the midpoint of the first gap
    wider than 1e-6 between sorted live opacities from the 90% (clipping)
    and the 10% (pruning) quantile on (a block of tied opacities pushes it
    further), so that an ulp of the sigmoid cannot move a row across.
    Counts, opacities, Adam moments, alive masks and statistics must agree
    exactly. The calls return new tensors, so
    the trainer's model stays as it was."""
    import dataclasses

    import torch
    from triangle_splatting_tpu_torch.models import triangle as M

    def to_cpu(x):
        if isinstance(x, M.AdamState):
            return dataclasses.replace(x, m=to_cpu(x.m), v=to_cpu(x.v))
        return dataclasses.replace(x, **{f.name: getattr(x, f.name).cpu()
                                         for f in dataclasses.fields(x)
                                         if torch.is_tensor(getattr(x, f.name))})

    def leaves(p, o, s):
        yield from (("params." + k, t) for k, t in p.tensors().items())
        yield from (("adam.m." + k, t) for k, t in o.m.tensors().items())
        yield from (("adam.v." + k, t) for k, t in o.v.tensors().items())
        yield from (("state." + f.name, getattr(s, f.name)) for f in dataclasses.fields(s))

    host = (to_cpu(params), to_cpu(opt), to_cpu(state))
    live = torch.sort(M.get_opacity(host[0])[:, 0][host[2].alive]).values.double()
    gaps = live[1:] - live[:-1]
    for kind, fn, q in (("clipping", M.opacity_clipping, 0.9),
                        ("pruning", M.opacity_pruning, 0.1)):
        k = int(q * live.numel())
        wide = torch.nonzero(gaps[k:] > 1e-6)
        check(wide.numel() > 0, f"city opacity {kind}: no gap > 1e-6 above the {q} quantile")
        i = k + int(wide[0])                     # the gap lies between live[i] and live[i + 1]
        thr = float(live[i] + live[i + 1]) / 2
        expect = live.numel() - (i + 1) if kind == "clipping" else i + 1
        *dev_out, n_dev = fn(params, opt, state, thr)
        *cpu_out, n_cpu = fn(*host, thr)
        check(int(n_dev) == int(n_cpu) == expect > 0,
              f"city opacity {kind}: card {int(n_dev)}, CPU {int(n_cpu)} rows, expected {expect}")
        differ = [name for (name, a), (_, b) in zip(leaves(*dev_out), leaves(*cpu_out))
                  if not torch.equal(a.cpu(), b)]
        check(not differ, f"city opacity {kind}: card and CPU differ in {differ}")
        say("city_adc", kind=kind, threshold=thr, rows=int(n_dev), live=int(live.numel()),
            card_vs_cpu="exact")


def main(argv=None) -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blend-parent", type=Path, action="append", default=[], metavar="DIR",
                    help="a directory with an earlier blend.cu and blend_gs.cu: time their "
                         "B1 and B2 in turns with the current ones (tools/blend_compare.py); "
                         "repeatable, the first is the parent")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        import triangle_splatting_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    try:
        print(card_line(), flush=True)
        say("device", kind=torch.cuda.get_device_name(0),
            count=torch.cuda.device_count(), torch=torch.__version__,
            cuda=torch.version.cuda)
        phase_build()
        cmp = None
        if args.blend_parent:
            from triangle_splatting_tpu_torch.tools.blend_compare import Comparison
            cmp = Comparison(args.blend_parent)
            say("blend_parent", builds=cmp.builds, takes_order=cmp.takes_order, sass=cmp.sass)
        bench = make_bench(dev)
        rec = phase_kernels(bench, cmp)
        rec.update(phase_kernels_3d(dev, cmp))
        rec.update(phase_kernels_gs(dev, cmp))
        phase_reference(dev)
        phase_rasterize(bench)
        runs = dict(renderer=phase_renderer(bench))
        runs["probes"], probe_rec = phase_probes(dev)
        rec.update(probe_rec)
        shutil.rmtree(WORK, ignore_errors=True)
        soup = build_dataset(dev, "soup")
        runs["train"] = phase_train(dev, soup)
        runs["gs"] = phase_gs(dev, soup)
        shutil.rmtree(soup, ignore_errors=True)
        surface = build_dataset(dev, "surface")
        runs["mesh"] = phase_mesh_train(dev, surface)
        runs["mesh_adc"] = phase_mesh_adc(dev, surface)
        shutil.rmtree(surface, ignore_errors=True)
        runs["city"], city_rec = phase_city(dev, build_city(dev), cmp)
        rec.update(city_rec)
    except SmokeFailure as e:
        print(f"FAIL {e}", flush=True)
        return 1
    kernels = []
    for name, r in rec.items():
        # each kernel's launches in the training run of its own path
        n = runs[PATH_OF[name]][name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
