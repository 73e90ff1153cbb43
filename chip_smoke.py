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
             per-pair stream against the plain one), B2, B3 (pair_tri and
             the owner-order map), B4 through the map (and against the old
             route: owner sort, index_select, B4 on sorted columns, bit for
             bit), and B5 reading the stream through the map (equal, bit
             for bit, to B5 after the gather and after the owner sort);
             then B1 (both forms) and B2 in
             variant "3D", B3/B4 on their pairs (2,500 tiles, 13 live
             gradient rows) and B5, on a 100k random scene at the mesh
             path's rendered size (1600x1600) at gamma 1 and 50, timed at
             gamma 50; at each site (and the city's last step) a
             [pair_stage] line times the statistics stage (B5 through the
             map, one launch) and binning's owners (the binary search,
             held equal to the cummax route on every slot);
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
             shapes (P3 "hs" bit for bit), the opcodes of each probe
             kernel's SASS, P2's bound from its loop's SASS and the SM
             clock under load, and the rates;
13. smoke  — the port's trainers.smoke at its defaults but for its
             densification thresholds and the mesh run's initial opacity
             (SMOKE_CUTS): photo, --mesh and
             --model gs at 400x400 for 400 iterations, each on the soup it
             builds on the card (cells smoke-400-ts / -mesh / -gs): the PSNR
             climbs by 2 dB, densification grows rows, the alive count moves
             by the logged counts, the PLY and checkpoint (and GLB) at 400,
             the run's variant of B1 stats / B2 / B3 / B4 / B5 once per step;
14. resume — the photo smoke with a checkpoint at 200: a new trainer
             resumes from it bit for bit and lands within 2 dB;
15. adc    — tools/full_run.py --adc (the port's twin) cut to 1,000 steps
             (cell adc-800-20k, cuts in ADC_CUTS): the capacity grows, the
             first densify on the card equals the CPU's bit for bit, a
             forced overflow places no orphan half; 10 profiled steps;
16. mesh_tools — tools/full_run.py --mesh --scene surface at 600 steps
             (cell fullrun-mesh-surface-800): chamfer / F-score of the GLB
             against the GT soup, the ray-traced test PSNR (within 1 dB of
             the rasterized one), and kNN and the ray tracer on the card
             against the CPU;
17. scaffold — (run after city) the photo phase's soup written as a COLMAP
             capture (16 views at 1297x840, a 100k-point points3D.bin) and
             config/Colmap_ScaffoldGS.yaml at its widths trained on it for 50
             steps (cell scaffold-colmap-1297x840, cuts in SCAFFOLD_CUTS):
             the loss falls, anchors grow and the alive count moves by the
             logged counts, B1-GS plain / B2-GS / B3 / B4 once per step and no
             B5, the first anchor-growth level repeated on a CPU copy bit for
             bit, the kernels against their plain versions on the last
             step's inputs, the checkpoint restored exactly, the PLY read
             back, 100 steps of the MLP pretrain; 10 profiled steps;
18. smoke --model scaffold — the smoke phase's fourth run (cell
             smoke-400-scaffold): +2 dB, anchors added, the alive bookkeeping,
             PLY / checkpoint at 400, B1-GS plain / B2-GS / B3 / B4 at 400;
19. loss_terms — (after resume) the smoke photo recipe without
             densification plus DoG, smoothness, the vertex regularizer and
             the color affine for 100 steps (cell loss-terms-photo-400): the
             loss falls, the kNN refresh on its cadence, the affine off
             identity, one step card against CPU, LPIPS on random weights
             card against CPU, eval_lpips without weights.
20. entry  — (after gs, on the soup) ``python -m
             triangle_splatting_tpu_torch.run_experiments --type NerfSynthetic``
             as a subprocess, from a directory whose config is the shipped one
             cut to 50 steps with a profile window at 20-30 (ENTRY_CUTS): exit
             0, the loss falls, the timer's breakdown in the log, the trace
             under profile/, TensorBoard events where it imports; the
             pipeline's GPU count read without creating a CUDA context;
21. render_utils — (after city) make_render_fn on the city model's test
             views at 1600x900 and at the tour's 2160x1440, render_BEV_image
             and tour frames at 2160x1440 (degenerate on the synthetic city:
             an API check), a tour video where cv2 imports;
22. facades — (after scaffold) the photo / gs models through their PLYs,
             the mesh GLB at gamma 50 and the scaffold state through
             VanillaTSModel / VanillaGSModel / ScaffoldGSModel: one counted
             render each (B1 "2D" / "3D" / "GS" rich + stats, "GS" rich), bit
             for bit with the plain form; the new forms and B3 against their
             plain versions;
23. viewer — run_viewer on the mesh run's directory ("3D") and the photo
             PLY's ("2D"): 3 modes x 512 / 1024 x gamma 1 / 50 over HTTP,
             JPEG sizes and X-Info gated, B1 rich and B3 only.
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
per form. With --probes-parent DIR (an earlier probes.cu with the current
ts_probe_scan parameters) the probes phase holds each P3 variant of it
against the current one bit for bit and times the two in turns. With
--blend-parent DIR (an earlier blend.cu and blend_gs.cu;
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
import math
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
# path that runs it
PATH_OF = dict.fromkeys(REPLACES, "train")
PATH_OF.update(blend_forward_3d="mesh", blend_backward_3d="mesh",
               # the 2D stats form: the densification rehearsal (a photo
               # recipe with a statistic block)
               blend_forward_stats="adc",
               blend_forward_3d_stats="mesh_adc", segment_reduce_stats="mesh_adc",
               blend_forward_3d_rich="city", blend_backward_3d_rich="city",
               # the VanillaGS trainer renders with statistics and without
               # rich info (ScaffoldGS trains on B1-GS without statistics:
               # below; the rich GS forms: the facades, further below)
               blend_forward_gs_stats="gs",
               blend_forward_gs="scaffold",
               blend_backward_gs="gs", blend_backward_gs_rich="gs",
               # the triangle renderer facade with rich info
               blend_forward_rich_stats="renderer", blend_forward_3d_rich_stats="renderer",
               # the forms whose first user path is the inference surface:
               # the viewer ("2D" rich), the Gaussian and Scaffold facades
               blend_forward_rich="viewer", blend_forward_gs_rich_stats="facades",
               blend_forward_gs_rich="facades",
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
    densification="left out so that the cell stays comparable with its earlier runs "
                  "(densification runs in the smoke phase's cell smoke-400-gs)",
    contribution_pruning="added: config/NerfSynthetic_VanillaTS_mesh.yaml's block, window "
                         "(1,000, 40,000] every 1,000 -> (5, 40] every 20, target 93,000",
    saves="save_iterations / checkpoint_iterations [50] -> none, so that the cell stays "
          "comparable (the saves run in the smoke phase)",
    eval="outside the counted run (test PSNR before and after)",
    data="the photo phase's soup: 8 train / 2 test views at 800x800, a 100k-point cloud")


# the smoke phase: trainers.smoke at its defaults (cells smoke-400-ts,
# smoke-400-mesh, smoke-400-gs), and the JAX package's TPU v5e trajectories
# at that size (the JAX package's recorded smoke results), a check of
# convergence and not of speed
SMOKE_RUNS = (("ts", []), ("mesh", ["--mesh"]), ("gs", ["--model", "gs"]),
              ("scaffold", ["--model", "scaffold"]))
SMOKE_ITERS = 400
SMOKE_V5E = {"ts": (17.4, 26.7), "mesh": (17.1, 21.6), "gs": None, "scaffold": (19.5, 29.6)}
# the smoke's densify thresholds (6e-4 -> 3e-4) lie 7-15x above the largest
# mean screen-space gradient at 400x400 (the photo run at its defaults:
# p50 2.4e-6, p99 2.0e-5-2.8e-5, max 2.7e-5-4.2e-5 at its five firings; it
# grew nothing), so they are lowered as tools/full_run.py lowers them
SMOKE_GRAD_THRESHOLD = (1e-5, 1e-5 * 2 / 3)
# the mesh recipe starts every triangle at opacity 0.3, its STE threshold:
# sigmoid(logit(0.3)) is 0.3f and 0.3f > 0.3 is false, so every triangle
# renders transparent, none is seen in a view, and densification finds no
# eligible row (ROADMAP Queue C); just above it they render from step 0
SMOKE_MESH_INIT_OPACITY = 0.31
# the scaffold smoke's grad threshold 2e-4 lies 4-9x above the largest mean
# center-gradient norm of its examined offsets at 400x400 (an H100 run at
# the default: p99 8.6e-6-1.4e-5, max 2.2e-5-4.8e-5 at its seven updates;
# nothing grew)
SMOKE_SCAFFOLD_GRAD_THRESHOLD = 1e-5
SMOKE_CUTS = dict(
    densification="grad_threshold_init / _final 6e-4 / 3e-4 -> 1e-5 / 6.7e-6 (at the defaults "
                  "nothing grows at 400x400: the largest grad statistic was 4.2e-5)",
    mesh_init_opacity="0.3 -> 0.31 (--mesh only: at 0.3, the STE threshold, every triangle "
                      "renders transparent and no row is ever eligible to densify)",
    scaffold_grad_threshold="anchor_update.grad_threshold_init / _final 2e-4 -> 1e-5 "
                            "(--model scaffold only: at 2e-4 nothing grows at 400x400, the "
                            "largest grad statistic was 4.8e-5)",
    rest="trainers.smoke's defaults (400x400, 400 iterations, 800 GT triangles, 24 train / 4 "
         "test views, GT rendered on the card)")
RESUME_AT = 200
# scaffold-colmap-1297x840: config/Colmap_ScaffoldGS.yaml at its own widths
# on a synthetic COLMAP capture of the photo phase's soup (the size of a
# Mip-NeRF 360 images_4 view, a sparse cloud of ~10^5 points)
SCAFFOLD_W, SCAFFOLD_H = 1297, 840
SCAFFOLD_VIEWS = 16
SCAFFOLD_POINTS = 100_000
SCAFFOLD_ITERS = 50
SCAFFOLD_WINDOW = (5, 45)
SCAFFOLD_INTERVAL = 10
SCAFFOLD_PRETRAIN_ITERS = 100
# the examined offsets' mean center-gradient norm at 1297x840 (an H100 run
# at the recipe's 2e-4): p50 2.5e-8-3.5e-8, p99 7.8e-8-1.2e-7, max
# 2.4e-7-2.5e-6 over the four updates; nothing grew
SCAFFOLD_GRAD_THRESHOLD = 1e-7
SCAFFOLD_GT_GAUSSIANS = 100_000
SCAFFOLD_CUTS = dict(
    iterations="30,000 -> 50",
    anchor_update="start 500, end 15,000, every 100 -> start 5, end 45, every 10",
    view_counts="grad_min_view_count / opacity_min_view_count 100 -> 1 (no offset is seen "
                "100 times in 50 steps)",
    grad_threshold="grad_threshold_init / _final 2e-4 -> 1e-7 (at 2e-4 nothing grows at "
                   "1297x840: the mean center-gradient norm's p99 was 7.8e-8-1.2e-7)",
    log="every 100 -> every 10 (the pair budget is re-sized at log steps)",
    eval="every 5,000 -> before and after the counted run",
    pretrain="1,000 -> 100 steps, on a GT PLY of 100k random Gaussians",
    data="16 synthetic views (2 held out by hold_interval 8) of the photo phase's soup "
         "(100k GT triangles) at 1297x840, a 100k-point points3D.bin drawn on its faces")
# loss-terms-photo-400: the smoke photo recipe without densification (no
# statistic block) with the four refused terms on
LOSS_TERMS_ITERS = 100
LOSS_TERMS = dict(w_dog=0.05, w_smoothness=0.05,
                  vertex_reg=dict(w_vertex_reg=0.01, start_iter=0, interval_iter=10))
LOSS_TERMS_AFFINE_LR = 0.001            # config/MipNerf360_VanillaTS.yaml's color_affine v_init
# adc-800-20k: tools/full_run.py --adc (the densification rehearsal) cut to
# fit the script's time
ADC_ITERS = 1000
ADC_INTERVAL = 100
# the grad statistic at 800x800 (an H100 run): p50 1e-9-2.5e-8, p99 4.9e-7-1.3e-6
# over the firings; at 1e-7 the six firings placed 16,557 rows into 20,192 dead slots
ADC_GRAD_THRESHOLD = 3e-8
ADC_CUTS = dict(
    iterations="30,000 (full_run's default) -> 1,000",
    densification="every 500 from 500 to 3/4 of the run -> every 100 from 100 to 750; "
                  "--grad_threshold 1.5e-4 -> 3e-8 (its final 2/3 of it), from the grad "
                  "statistics' quantiles (at 1.5e-4 nothing grows at 800x800)",
    opacity_pruning="every 500 from 1,000 -> every 100 from 200",
    eval="every 2,000 -> before and after the counted run",
    log="every 250 -> every 100 (the pair budget is re-sized at log steps)",
    checkpoints="every 5,000 -> none")
# fullrun-mesh-surface-800: tools/full_run.py --mesh --scene surface, the
# mesh recipe's windows scaled to 600 iterations by full_run itself
MESH_TOOLS_ITERS = 600
# at gamma 50 the rasterized test views are close to the opaque endpoint the
# ray tracer draws from the GLB (19.88 and 19.67 dB in an H100 run)
MESH_TOOLS_TRACE_GAP_DB = 1.0
MESH_TOOLS_CUTS = dict(
    iterations="60,000 (the recipe) -> 600, every window scaled by 1/100 as full_run scales "
               "it",
    checkpoints="every 5,000 -> none")


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
    """B3 against its plain version on one frame's sorted pairs (both
    outputs exact) and its map checked (``hold_relayout``). Returns the
    kernel's pair_tri and pack_perm, the argument tuple and the count of
    entries that differ (0)."""
    args = sp.relayout_args()
    pair_tri, pack_perm, err = hold_relayout(args, what)
    return pair_tri, pack_perm, args, err


def hold_relayout(args, what: str):
    """B3 against its plain version on one argument tuple (tri, sorted_raw,
    sorted_key, raw_starts, astarts, ma, dbits): pair_tri and pack_perm
    exact. The map: ``pair_tri[pack_perm[r]]`` is the owner ``tri[r]`` of
    every binned raw pair r, ``pack_perm`` hits each filled slot exactly
    once, and the entries of the unbinned pairs name empty slots. Returns
    the kernel's outputs and the count of entries that differ (0)."""
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import streams as KS

    pair_tri, pack_perm = KS.relayout_pairs(*args)
    ref_tri, ref_perm = KS.relayout_pairs_plain(*args)
    torch.cuda.synchronize()
    err = int((pair_tri != ref_tri).sum()) + int((pack_perm != ref_perm).sum())
    check(err == 0, f"relayout_pairs {what}: disagrees with its plain version in {err} entries")
    n = int(args[3][-1])                                  # binned pairs: raw_starts[-1]
    filled = torch.nonzero(pair_tri >= 0).flatten()
    head = pack_perm[:n].long()
    check(bool(torch.equal(pair_tri[head], args[0][:n])),
          f"relayout_pairs {what}: pair_tri[pack_perm[r]] is not the owner of raw pair r")
    check(filled.numel() == n and bool(torch.equal(torch.sort(head).values, filled)),
          f"relayout_pairs {what}: pack_perm does not hit each of the {filled.numel()} "
          f"filled slots once")
    check(not bool((pair_tri[pack_perm[n:].long()] >= 0).any()),
          f"relayout_pairs {what}: an unbinned pair maps to a filled slot")
    return pair_tri, pack_perm, err


def owner_order(pair_tri, P: int):
    """The old route's owner order: the indices of a stable sort of the
    owner key over every aligned slot (empty slots get P, the tail)."""
    import torch
    key = torch.where(pair_tri >= 0, pair_tri, torch.full_like(pair_tri, P))
    return torch.sort(key, stable=True).indices


def segment_bounds(tri_offsets, num_pairs):
    """Each triangle's positions [starts, ends) clipped to num_pairs."""
    import torch
    return (torch.minimum(tri_offsets[:-1], num_pairs).contiguous(),
            torch.minimum(tri_offsets[1:], num_pairs).contiguous())


def check_segment_reduce(grads, pair_tri, pack_perm, starts, ends, num_pairs,
                         what: str) -> dict:
    """B4 on the pack backward's inputs, the live per-pair gradient rows
    ``grads`` (B2's output): its map form (``grads`` read through
    ``pack_perm``) against its plain version at rel 1e-5 of the max, and
    against the old route (the owner sort, ``index_select`` and B4's
    sorted form, itself held against its plain version) bit for bit.
    Returns the map form's errors, argument tuple and plain result."""
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import streams as KS

    order = owner_order(pair_tri, starts.shape[0])
    old = hold_segment_reduce((grads.index_select(1, order).contiguous(), starts, ends,
                               num_pairs), what + " (owner-sorted)")
    out = hold_segment_reduce((grads, starts, ends, num_pairs, pack_perm), what)
    got_old = KS.segment_reduce_pairs(*old["args"])
    got_new = KS.segment_reduce_pairs(*out["args"])
    torch.cuda.synchronize()
    check(bool(torch.equal(got_new, got_old)),
          f"segment_reduce_pairs {what}: the map form differs from the old route by "
          f"{float((got_new - got_old).abs().max()):.3e} (expected bit for bit)")
    return out


def hold_segment_reduce(args, what: str) -> dict:
    """B4 against its plain version on one argument tuple (cols, starts,
    ends, nvalid[, perm]): rel 1e-5 of the max. Returns the errors, the
    argument tuple and the plain result."""
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import streams as KS

    out = KS.segment_reduce_pairs(*args)
    ref = KS.segment_reduce_pairs_plain(*args)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-30)
    check(rel <= TOL["b4_rel"], f"segment_reduce_pairs {what}: rel err {rel:.3e} > {TOL['b4_rel']}")
    return dict(args=args, ref=ref, err=err, rel=rel)


def b3_bytes(args) -> float:
    """The bytes B3 must move: per raw pair its raw index read and its map
    entry written, per binned pair its owner read, every slot written
    once, the two tile-start arrays read. The sorted keys are not counted:
    the tile of a sorted pair can come from the raw starts, as in the
    plain version."""
    n, num_pairs = args[0].shape[0], int(args[3][-1])
    return 4 * (2 * n + num_pairs + args[5] + 2 * args[3].shape[0])


def b4_bytes(rows: int, num_pairs: int, P: int) -> float:
    """The bytes B4 must move: the map entries, ``rows`` values of every
    binned pair, the segment bounds and nvalid read, the (16, P) output
    written."""
    return 4 * (num_pairs + rows * num_pairs + 2 * P + 1) + 4 * 16 * P


def b5_bytes(num_pairs: int, P: int) -> float:
    """The bytes B5 must move: the map entry and the two stream values of
    every binned pair, the segment bounds and nvalid read, the two (P,)
    outputs written."""
    return 4 * (num_pairs + 2 * num_pairs + 2 * P + 1) + 4 * 2 * P


def kernel_grids(fn) -> list:
    """The device kernels one call of ``fn`` launches, with their launch
    grid, block and duration (us), from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    WORK.mkdir(parents=True, exist_ok=True)
    path = WORK / "grid_trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [dict(name=e["name"][:90], grid=e.get("args", {}).get("grid"),
                 block=e.get("args", {}).get("block"), us=e.get("dur"))
            for e in events if e.get("cat") == "kernel"]


def owner_markers(counts, offsets, max_pairs: int):
    """The JAX package's owner markers: t + 1 scattered with ``amax`` at
    each triangle's first raw slot; ``torch.cummax`` of them, minus one,
    gives the owners of every raw slot."""
    import torch
    P = counts.shape[0]
    put = (counts > 0) & (offsets < max_pairs)
    markers = torch.zeros((max_pairs,), dtype=torch.int32, device=counts.device)
    markers.scatter_reduce_(0, offsets[put].long(),
                            torch.arange(1, P + 1, dtype=torch.int32, device=counts.device)[put],
                            reduce="amax")
    return markers


def pair_stage(prep, st, max_pairs: int, pair_contrib, site: str,
               grids: bool = False) -> dict:
    """Device ms (median of 50, behind a spin kernel) of two pieces of the
    pair stage on one frame: with a stream ``pair_contrib``, the
    statistics (B5 reading the stream through the map, one launch), and
    binning's owners of every raw slot (``binning.pair_owners``, a binary
    search), held equal on every slot to the JAX package's route
    (``torch.cummax`` over ``owner_markers``; not timed). With ``grids``
    the launch grid of the owners' kernels (later traces in the same
    process recorded no kernel on the H100). Prints one [pair_stage]
    line."""
    import torch
    from triangle_splatting_tpu_torch.ops import binning as BN
    from triangle_splatting_tpu_torch.ops.cuda import streams as KS

    i32 = torch.int32
    with torch.no_grad():
        sp = BN.sort_pairs(prep, st, max_pairs)
        ms = {}
        if pair_contrib is not None:
            _, pack_perm = KS.relayout_pairs(*sp.relayout_args())
            starts, ends = segment_bounds(sp.tri_offsets, sp.num_pairs)
            ms["stats"] = cuda_ms(lambda: KS.segment_reduce_stats(
                pair_contrib[0], pair_contrib[1], starts, ends, sp.num_pairs, pack_perm), 50)
        counts = prep.tiles_touched.to(i32)
        csum = torch.cumsum(counts, 0)
        starts64 = csum - counts

        def owners():
            return BN.pair_owners(counts, starts64, max_pairs)
        cummax = torch.cummax(owner_markers(counts, starts64.to(i32), max_pairs), 0).values - 1
        check(bool(torch.equal(owners(), cummax)),
              f"pair_stage {site}: the searchsorted owners differ from the cummax's")
        ms["owners"] = cuda_ms(owners, 50)
        owner_kernels = kernel_grids(owners) if grids else None
    out = dict(site=site, num_pairs=int(sp.num_pairs), max_pairs=max_pairs, ma=sp.ma,
               triangles=int(counts.shape[0]), tiles=int(sp.tile_counts.shape[0]),
               ms={k: round(v, 5) for k, v in ms.items()}, owner_kernels=owner_kernels)
    say("pair_stage", **out)
    return out


def check_segment_stats(pair_contrib, pair_tri, pack_perm, starts, ends, num_pairs,
                        what: str) -> dict:
    """B5 on B1's per-pair stream read through the map (the inputs
    ``ops/rasterize.py:_contrib_stats`` gives it) against its plain version
    (the gather, then the owner-sorted plain version): sums within rel 1e-5
    of the largest, maxes exact; and its outputs equal, bit for bit, to
    the old route's (the stream gathered through the map by
    ``index_select``, then B5 on the owner-sorted columns) and, given the
    slots' owners ``pair_tri``, to B5 after the owner sort of every slot.
    Returns the errors, the argument tuple,
    the library yardstick (the gather and two ``torch.segment_reduce``
    calls: no one PyTorch call reads through a map) and the bytes and
    operations of its bound."""
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import streams as KS

    P = starts.shape[0]
    args = (pair_contrib[0], pair_contrib[1], starts, ends, num_pairs, pack_perm)
    sums, maxes = KS.segment_reduce_stats(*args)
    ref_s, ref_m = KS.segment_reduce_stats_plain(*args)
    cols = pair_contrib.index_select(1, pack_perm)
    old_s, old_m = KS.segment_reduce_stats(cols[0], cols[1], starts, ends, num_pairs)
    if pair_tri is not None:
        srt = pair_contrib.index_select(1, owner_order(pair_tri, P))
        srt_s, srt_m = KS.segment_reduce_stats(srt[0], srt[1], starts, ends, num_pairs)
        check(bool(torch.equal(sums, srt_s) and torch.equal(maxes, srt_m)),
              f"segment_reduce_stats {what}: through the map differs from after the owner sort")
    torch.cuda.synchronize()
    err_s = float((sums - ref_s).abs().max())
    rel_s = err_s / max(float(ref_s.abs().max()), 1e-30)
    err_m = float((maxes - ref_m).abs().max())
    check(rel_s <= TOL["b5_rel"], f"segment_reduce_stats {what}: sum rel err {rel_s:.3e}")
    check(err_m == 0.0, f"segment_reduce_stats {what}: max err {err_m:.3e}, expected exact")
    check(bool(torch.equal(sums, old_s) and torch.equal(maxes, old_m)),
          f"segment_reduce_stats {what}: through the map differs from the gather and B5")
    n = int(num_pairs)
    lengths = ends - starts
    head = pack_perm[:n]

    def library():
        data = pair_contrib.index_select(1, head)
        return (torch.segment_reduce(data[0], "sum", lengths=lengths, initial=0),
                torch.segment_reduce(data[1], "max", lengths=lengths, initial=0))
    lib_s, lib_m = library()
    check(float((lib_s - ref_s).abs().max()) <= TOL["b5_rel"] * float(ref_s.abs().max())
          and bool(torch.equal(lib_m, ref_m)), "segment_reduce yardstick disagrees with B5")
    return dict(args=args, library=library, err=max(err_s, err_m), rel=rel_s,
                bytes=b5_bytes(n, P), ops=B5_OPS_PER_PAIR * n)


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

        # ---- B3 relayout_pairs (pair_tri and the map)
        pair_tri, pack_perm, args3, err3 = check_relayout(sp, "2D")
        # a scatter_ pair computes both outputs: the binned pairs' owners
        # into their slots, every slot index into the map
        j = torch.arange(max_pairs, device=dev, dtype=torch.int32)
        tile_of = (torch.searchsorted(sp.raw_starts, j, right=True, out_int32=True) - 1).clamp(0, T).long()
        dst = (sp.astarts[tile_of] + j - sp.raw_starts[tile_of]).long()
        raw = sp.sorted_raw.long()
        keep = j < num_pairs
        dst_keep, src = dst[keep], sp.tri[raw][keep]
        dst32 = dst.to(torch.int32)
        lib_tri = torch.full((sp.ma,), -1, dtype=torch.int32, device=dev)
        lib_perm = torch.empty((max_pairs,), dtype=torch.int32, device=dev)

        def scatter_pair():
            lib_tri.scatter_(0, dst_keep, src)
            lib_perm.scatter_(0, raw, dst32)
        scatter_pair()
        check(bool(torch.equal(lib_tri, pair_tri) and torch.equal(lib_perm, pack_perm)),
              "scatter_ yardstick disagrees with B3")
        rec["relayout_pairs"] = dict(
            max_abs_err=float(err3),
            ms=cuda_ms(lambda: KS.relayout_pairs(*args3), 50),
            plain_ms=cuda_ms(lambda: KS.relayout_pairs_plain(*args3), 20),
            library_ms=cuda_ms(scatter_pair, 50),
            bound=bound_ms(b3_bytes(args3)), tol="exact")
        starts, ends = segment_bounds(sp.tri_offsets, sp.num_pairs)

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
        c4r = check_segment_reduce(r["out2"][:live_r], pair_tri, pack_perm, starts, ends,
                                   sp.num_pairs, "2D rich")
        say("kernels", kernel="blend_rich", variant="2D", b1_rel_err_depth=r["rel_depth"],
            b1_rel_err_normal=r["rel_normal"], b2_rel_err=r["b2_rel"],
            b2_depth_row_max=r["depth_row_max"], b4_rows=live_r, b4_rel_err=c4r["rel"],
            b4_max_abs_err=c4r["err"])

        # B5 on the 2D stream (its record is taken at the mesh shapes)
        c5 = check_segment_stats(c["pair_contrib"], pair_tri, pack_perm, starts, ends,
                                 sp.num_pairs, "2D")
        say("kernels", kernel="segment_reduce_stats", shapes="bench-800-100k",
            max_abs_err=c5["err"], sum_rel_err=c5["rel"],
            ms=cuda_ms(lambda: KS.segment_reduce_stats(*c5["args"]), 50),
            library_ms=cuda_ms(c5["library"], 50), bound_ms=bound_ms(c5["bytes"], c5["ops"])[0])
        out2 = c["out2"]

        # ---- B4 segment_reduce_pairs (the pack backward's inputs)
        P = fmat.shape[0]
        live = KB.LIVE_GRAD_ROWS[("2D", False)]
        c4 = check_segment_reduce(out2[:live], pair_tri, pack_perm, starts, ends,
                                  sp.num_pairs, "2D")
        args4, ref4 = c4["args"], c4["ref"]
        # one index_add_ straight from B2's output computes the whole pack
        # backward: every aligned slot adds into its owner's column (the
        # empty slots into a spare column P)
        seg = torch.where(pair_tri >= 0, pair_tri, torch.full_like(pair_tri, P)).long()
        lib_cols = out2[:live]

        def index_add():
            return torch.zeros((live, P + 1), device=dev).index_add_(1, seg, lib_cols)
        check(float((index_add()[:, :P] - ref4[:live]).abs().max())
              <= 1e-5 * float(ref4.abs().max()), "index_add_ yardstick disagrees with B4")
        pair_stage(prep, st, max_pairs, c["pair_contrib"], "bench-800-100k", grids=True)
        rec["segment_reduce_pairs"] = dict(
            max_abs_err=c4["err"], rel_err=c4["rel"],
            ms=cuda_ms(lambda: KS.segment_reduce_pairs(*args4), 50),
            plain_ms=cuda_ms(lambda: KS.segment_reduce_pairs_plain(*args4), 20),
            library_ms=cuda_ms(index_add, 50),
            bound=bound_ms(b4_bytes(live, num_pairs, P), live * num_pairs),
            tol=f"rel {TOL['b4_rel']} of the max; the old route's sums bit for bit")

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
            pair_tri, pack_perm, args3, err3 = check_relayout(sp, what)
            bounds = segment_bounds(sp.tri_offsets, sp.num_pairs)
            fmat = triangle_field_matrix_3d(prep, opacity, cam.tan_fovx, cam.tan_fovy, R, R)
            params = torch.tensor([gamma, 1.0, 1.0, 1.0, 10.0, sx, sy, 0.0], device=dev)
            c = check_blend(pack_fields(fmat, pair_tri), sp, params, geo, target, what)
            live = KB.LIVE_GRAD_ROWS[("3D", False)]
            c4 = check_segment_reduce(c["out2"][:live], pair_tri, pack_perm, *bounds,
                                      sp.num_pairs, what)
            c5 = check_segment_stats(c["pair_contrib"], pair_tri, pack_perm, *bounds,
                                     sp.num_pairs, what)
            r = check_blend_rich(c["fwd"], geo, c["out1"], rich_cotangents(c, R, R, dev),
                                 what)
            live_r = KB.LIVE_GRAD_ROWS[("3D", True)]
            c4r = check_segment_reduce(r["out2"][:live_r], pair_tri, pack_perm, *bounds,
                                       sp.num_pairs, what + " rich")
            rs = check_blend_rich_stats(c["fwd"], geo, c["out1"], r["on"], c["pair_contrib"],
                                        what)
        site = None if gamma == 1.0 else "bench3d-1600-100k gamma 50"
        if site is not None:
            pair_stage(prep, st, _round_up(int(ppt * N_TRI), KB.ALIGN), c["pair_contrib"], site)
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
    B5 on the stream gathered through the map. Each form is timed at gamma 1,
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
            pair_tri, pack_perm, args3, err3 = check_relayout(sp, what)
            bounds = segment_bounds(sp.tri_offsets, sp.num_pairs)
            fields = pack_fields(gaussian_field_matrix(prep, opacity), pair_tri)
            params = torch.tensor([gamma, 1.0, 1.0, 1.0, 10.0, 0.0, 0.0, 0.0], device=dev)
            fwd = (fields, sp.astarts, sp.tile_counts, params)
            c = check_blend_gs(fwd, geo, target, what)
            c4 = {f: check_segment_reduce(c["bws"][f]["out"][:KB.LIVE_GRAD_ROWS[("GS", r)]],
                                          pair_tri, pack_perm, *bounds, sp.num_pairs,
                                          f"{what} {f}")
                  for f, r in (("gs", False), ("gs_rich", True))}
            c5 = check_segment_stats(c["outs"]["gs_stats"][5], pair_tri, pack_perm, *bounds,
                                     sp.num_pairs, what)
        g1 = gamma == 1.0
        if g1:
            pair_stage(prep, st, _round_up(int(ppt * N_TRI), KB.ALIGN),
                       c["outs"]["gs_stats"][5], "bench-gs-800-100k")
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
        pair_tri = check_relayout(sp, "GS stack")[0]
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
    statistics 5e-4 abs, depth and normal rel 1e-3 of their max. B5 is held
    on each counted render's own inputs (``check_segment_stats``). Returns
    the counted run's launches."""
    import dataclasses

    import torch
    from triangle_splatting_tpu_torch.ops.cuda import reset_launches
    from triangle_splatting_tpu_torch.ops.cuda.blend import ALIGN
    from triangle_splatting_tpu_torch.ops.rasterize import _round_up, rasterize
    from triangle_splatting_tpu_torch.renderer import TriangleRenderer
    from triangle_splatting_tpu_torch.utils.testing import make_camera, make_random_scene

    from triangle_splatting_tpu_torch.ops import rasterize as RZ

    dev = b["vertex"].device
    # the bench budget with a margin for the 3D variant's coverage
    max_pairs = _round_up(int(1.5 * b["ppt"] * N_TRI), ALIGN)
    cases = (("2D", 1.0), ("3D", 50.0))
    renderers = {v: TriangleRenderer(b["camera"], bg_color=(1.0, 1.0, 1.0), bg_depth=10.0,
                                     gamma=g, rich_info=True, rasterizer_type=v,
                                     max_pairs=max_pairs) for v, g in cases}
    args = (b["vertex"], None, b["rgb"], b["opacity"])
    b5_calls, real5 = [], RZ.segment_reduce_stats

    def spy5(*a, **kw):
        b5_calls.append((a, kw))
        return real5(*a, **kw)
    with torch.no_grad():
        RZ.segment_reduce_stats = spy5
        try:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = {v: renderers[v].render(*args) for v, _ in cases}
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            RZ.segment_reduce_stats = real5
        launches = read_launches()
        # B5 as each render ran it: through the map, against its plain
        # version and the gather + owner-sorted form
        check(len(b5_calls) == len(cases), f"renderer: {len(b5_calls)} B5 calls captured")
        for (v, _), (a, kw) in zip(cases, b5_calls):
            c5 = check_segment_stats(torch.stack(a[:2]), None, kw["perm"], a[2], a[3],
                                     kw["nvalid"], f"renderer {v}")
            say("renderer", variant=v, b5_sum_rel_err=c5["rel"], b5_max_abs_err=c5["err"])
        del b5_calls
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
    """Each probe kernel's SASS instructions (csrc/probes.cu through
    compare_sass.compile_sass: build.py's flags, cuobjdump), by kernel."""
    import tempfile

    from triangle_splatting_tpu_torch.ops.cuda.build import CSRC
    from triangle_splatting_tpu_torch.ops.cuda.compare_sass import compile_sass

    with tempfile.TemporaryDirectory() as tmp:
        sass, _ = compile_sass(CSRC / "probes.cu", Path(tmp) / "probes.cubin")
    return sass


def opcode(insn: str) -> str:
    """The opcode of one SASS instruction (its predicate skipped)."""
    return next(t for t in insn.split() if not t.startswith("@"))


def sass_loop_mix(insns: list) -> dict:
    """Opcode counts of the innermost loop of one kernel's SASS with the
    most MUFU instructions: the instructions from the target of a backward
    branch to the branch (an sm_90 instruction is 16 bytes). ``fp32``
    counts those issued by the float32 pipe at 128 a clock per SM (FADD,
    FMUL, FFMA in any form), ``mufu`` the special-function unit's."""
    import collections

    loops = []
    for i, insn in enumerate(insns):
        words = [w for w in insn.split() if not w.startswith("@")]
        if words and words[0].startswith("BRA") and words[-1].startswith("0x"):
            target = int(words[-1], 16) // 16
            if target < i:
                loops.append(collections.Counter(opcode(x) for x in insns[target:i + 1]))
    check(bool(loops), "sass_loop_mix: no loop in the kernel")
    mix = max(loops, key=lambda c: sum(v for o, v in c.items() if o.startswith("MUFU")))
    return dict(insns=sum(mix.values()),
                fp32=sum(v for o, v in mix.items() if o.split(".")[0] in ("FADD", "FMUL", "FFMA")),
                mufu=sum(v for o, v in mix.items() if o.startswith("MUFU")),
                ops=dict(mix.most_common()))


def loaded_clocks_mhz(fn, launches: int) -> dict:
    """The SM clock and its maximum as nvidia-smi reads them while
    ``launches`` calls of ``fn`` run back to back on the card: three
    readings each, in MHz (a diagnostic: no bound uses them)."""
    import torch
    for _ in range(launches):
        fn()
    got = dict(sm=[], max_sm=[])
    for _ in range(3):
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
        sm, top = out.splitlines()[0].split(",")
        got["sm"].append(float(sm))
        got["max_sm"].append(float(top))
    torch.cuda.synchronize()
    return got


def parent_scan(src_dir: Path):
    """An earlier ``csrc/probes.cu`` (``DIR/probes.cu``), built with
    ``nvcc`` beside the current libraries and loaded with ``ctypes``, as a
    callable (x, variant, k) running its P3 over a (256, C) block, clipped.
    Its ``ts_probe_scan`` must take the current one's parameters; any
    other source is refused before the build."""
    import ctypes

    import torch
    from triangle_splatting_tpu_torch.ops.cuda import build
    from triangle_splatting_tpu_torch.ops.cuda import probes as KP
    from triangle_splatting_tpu_torch.ops.cuda.streams import _stream
    from triangle_splatting_tpu_torch.tools.blend_compare import c_params

    src = Path(src_dir) / "probes.cu"
    params = c_params(src.read_text(), "ts_probe_scan")
    want = c_params((build.CSRC / "probes.cu").read_text(), "ts_probe_scan")
    check(params == want, f"parent {src}: ts_probe_scan takes {params}, not {want}")
    so = build.BUILD_DIR / "parent_probes.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
                         capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"parent probes.cu: nvcc failed\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.ts_probe_scan.argtypes = [ctypes.c_void_p if "*" in t or t == "cudaStream_t"
                                  else ctypes.c_int for t, _ in params]
    say("parent", source=str(src))

    def scan(x, variant, k):
        out = torch.empty_like(x)
        build.check_launch(lib.ts_probe_scan(x.data_ptr(), out.data_ptr(), x.shape[0],
                                             x.shape[1], k, *KP.scan_code(variant), 1,
                                             _stream()), f"parent scan_probe {variant}")
        return out
    return scan


def phase_probes(dev, scan_parent=None) -> tuple[dict, dict]:
    """P1-P3 through their tools' entry points at the JAX tools' shapes
    (vpu_probe R x C = 512 x 1024, K = 65536, four ops in float32 and
    bfloat16; exp_probe 512 x 1024, K = 16384, four ops, after its fast_exp
    check; scan_probe S x C = 256 x 1024, K = 2048, seven variants, after
    its check against float64 cumprod), counted; then each probe kernel
    against its plain version at K = 64 on the same shapes (the budgets of
    tests/test_torch_cuda.py; P3 "hs" bit for bit, also unclipped at
    K = 1), the opcodes of each probe kernel's SASS (the loop holds the
    operation measured), and the JSON rows: P1 timed at fma float32, P2 at
    exp (expf), P3 at hs, each against its plain version at the full K, P3
    also against K torch.cumprod + clamp_ calls replayed from one CUDA
    graph and bit for bit against its plain version (the product order of
    the Hillis-Steele passes) at the full K. P2's bound counts its loop's
    SASS (``sass_loop_mix``) at the peak clock behind ``F32_OPS_PER_S``:
    the larger of the float32-pipe instructions at 128 a clock per SM and
    the MUFU ones at 16. With ``scan_parent`` (``parent_scan``), every
    variant of the parent's P3 must give the current one's output bit for
    bit at the tool's K (on the tool's block and on a random one), and
    each variant is timed in turns (parent, new, new, parent).
    Returns (the counted run's launches, the rows)."""
    import collections

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
    # "hs" keeps the plain passes' products: bit for bit clipped at K = 64
    # and unclipped at K = 1 (no value held by the clip)
    x1 = (torch.rand((scan_probe.S, scan_probe.C), generator=gen) * 0.1 + 0.9).to(dev)
    for xk, kk, clip in ((x3, k, True), (x1, 1, False)):
        check(torch.equal(KP.scan_probe(xk, "hs", kk, clip),
                          KP.scan_probe_plain(xk, "hs", kk, clip)),
              f"scan_probe hs (K {kk}, clip {clip}): differs from the plain passes")
    torch.cuda.synchronize()
    say("probes", parity_k=k, rel_err=par,
        tol="mul, min3 (and bf16 fma) exact; f32 fma rel 1e-5; exp rel 1e-6 (bf16 2^-8); "
            "mul8 exact; expf, fast_exp, __expf rel 1e-6; scans rel 5e-6 (mxu_log 4e-5); hs "
            "bit for bit, also unclipped at K = 1")

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
    sass_insns = probe_sass()
    sass = {n: collections.Counter(opcode(x) for x in v) for n, v in sass_insns.items()}
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
    # expf issues on the special-function unit (MUFU.EX2, 16 a clock per
    # SM) and the float32 pipe (its range reduction, 128 a clock per SM):
    # the bound is the larger of the two at the peak clock behind
    # F32_OPS_PER_S (128 FFMA, 256 operations, a clock per SM). The clocks
    # read under its load are printed beside it, not used.
    mix = sass_loop_mix(sass_insns["exp_probe_kernel<1>"])
    clocks = loaded_clocks_mhz(lambda: KP.exp_probe(ones, "exp", K), 400)
    fp32_per_s = F32_OPS_PER_S / 2
    passes = R * C * K
    t_fp32 = mix["fp32"] / mix["mufu"] * passes / fp32_per_s * 1e3
    t_mufu = passes / (fp32_per_s * 16 / 128) * 1e3
    # not the bound: every instruction of the loop through the four
    # schedulers' one issue a clock each
    t_issue = mix["insns"] / mix["mufu"] * passes / fp32_per_s * 1e3
    say("probes", exp_bound=dict(loop=mix, loaded_clocks_mhz=clocks,
                                 fp32_per_elem_pass=mix["fp32"] / mix["mufu"],
                                 fp32_ms=t_fp32, mufu_ms=t_mufu, issue_ms=t_issue))
    rows["exp_probe"] = dict(
        max_abs_err=float((KP.exp_probe(x2, "exp", k) - KP.exp_probe_plain(x2, "exp", k))
                          .abs().max()),
        ms=cuda_ms(lambda: KP.exp_probe(ones, "exp", K), 5),
        plain_ms=cuda_ms(lambda: KP.exp_probe_plain(ones, "exp", K), 1, 0, hide_host=False),
        library_ms=None,
        bound=(max(t_fp32, t_mufu), "operations"))
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
    plain_out = KP.scan_probe_plain(full, "hs", K)
    torch.cuda.synchronize()
    lib_rel = float(((lib_out - kern_out).abs() / lib_out).max())
    check(lib_rel <= 5e-6, f"scan_probe: torch.cumprod yardstick differs by rel {lib_rel:.3e}")
    check(bool(torch.equal(kern_out, plain_out)),
          f"scan_probe hs: differs from the plain passes at K = {K}")
    if scan_parent is not None:
        turns = {}
        for v in KP.SCAN_VARIANTS:
            for xk in (full, x3):
                check(bool(torch.equal(scan_parent(xk, v, K), KP.scan_probe(xk, v, K))),
                      f"scan_probe {v}: differs from the parent's at K = {K}")
            fns = dict(parent=lambda v=v: scan_parent(full, v, K),
                       new=lambda v=v: KP.scan_probe(full, v, K))
            turns[v] = {n: [] for n in fns}
            for n in ("parent", "new", "new", "parent"):
                turns[v][n].append(cuda_ms(fns[n], 5))
        say("probes", parent_turns=turns, identical_at_k=K)
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
    keep_model("photo", trainer, WORK / "facades" / "photo" / "point_cloud" / "50.ply")
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
    keep_model("mesh", trainer, dir=WORK / "out_mesh")
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
    contribution statistics (B1-3D's stats form, the map gather, B5)."""
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
                b4=RZ.segment_reduce_pairs, sort=BN.sort_pairs)

    def spy(name):
        def wrapped(*a, **kw):
            out = real[name](*a, **kw)
            if step["next"] == n:
                last[name] = (a, kw)
                if name == "bwd":
                    last["grads"] = out.detach()
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
    BN.sort_pairs = spy("sort")
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
        BN.sort_pairs = real["sort"]
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
        pair_tri, pack_perm, err3 = hold_relayout(a3, "city")
        c4 = check_segment_reduce(a4[0], pair_tri, pack_perm, *a4[1:4], "city")
        T, ma, np3 = int(a3[3].shape[0]) - 1, int(a3[5]), int(a3[3][-1])
        rows4, P, np4 = int(a4[0].shape[0]), int(a4[1].shape[0]), int(a4[3])
        b3 = bound_ms(b3_bytes(a3))
        b4 = bound_ms(b4_bytes(rows4, np4, P), rows4 * np4)
        say("city_kernels", kernel="relayout_pairs", max_abs_err=err3, tol="exact", tiles=T,
            num_pairs=np3, ma=ma, ms=round(cuda_ms(lambda: KS.relayout_pairs(*a3), 50), 4),
            plain_ms=round(cuda_ms(lambda: KS.relayout_pairs_plain(*a3), 10), 3),
            bound_ms=round(b3[0], 5), bound_by=b3[1])
        say("city_kernels", kernel="segment_reduce_pairs", max_abs_err=c4["err"],
            rel_err=c4["rel"], tol=f"rel {TOL['b4_rel']} of the max; the old route's sums "
            "bit for bit", rows=rows4,
            triangles=P, num_pairs=np4,
            ms=round(cuda_ms(lambda: KS.segment_reduce_pairs(*a4), 50), 4),
            plain_ms=round(cuda_ms(lambda: KS.segment_reduce_pairs_plain(*a4), 10), 3),
            bound_ms=round(b4[0], 5), bound_by=b4[1])
        sprep, sst, smax = last["sort"][0][:3]
        pair_stage(sprep.detach(), sst, smax, None, "city last step")
        del last, r, fwd, off, a3, a4, c4
        check_opacity_adc(trainer.params, trainer.opt, trainer.state)
    profile_steps(trainer, "city_profile", bg=torch.zeros(3, device=dev))
    KEEP["city"] = dict(trainer=trainer, cameras=list(trainer.dataset.getTestDataset()))
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
        pair_tri, pack_perm, err3 = hold_relayout(a3, "gs")
        c4 = check_segment_reduce(a4[0], pair_tri, pack_perm, *a4[1:4], "gs")
        # B5 through the map against the gather + owner-sorted form and
        # B5 after the old owner sort, on the last step's stream
        check_segment_stats(out[5], pair_tri, pack_perm, *a5[2:5], "gs")
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
        b3 = bound_ms(b3_bytes(a3))
        b4 = bound_ms(b4_bytes(rows4, np4, P), rows4 * np4)
        b5 = bound_ms(b5_bytes(np5, P), B5_OPS_PER_PAIR * np5)
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
    keep_model("gs", trainer, WORK / "facades" / "gs.ply")
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


# ---------------------------------------------------------------------------
# the smoke twin, resume, densification rehearsal and mesh tools
# ---------------------------------------------------------------------------

class counted_train:
    """Within the block, every trainer's ``train()`` sets the launch counts
    to 0 just before its loop and records them (``train_launches``) and its
    seconds (``train_seconds``) just after: the counts of a run's own
    steps, without its dataset build and evaluations."""

    def __enter__(self):
        import torch
        from triangle_splatting_tpu_torch.ops.cuda import reset_launches
        from triangle_splatting_tpu_torch.trainers.scaffold_gs import ScaffoldGSTrainer
        from triangle_splatting_tpu_torch.trainers.vanilla_gs import VanillaGSTrainer
        from triangle_splatting_tpu_torch.trainers.vanilla_ts import VanillaTSTrainer
        self.real = {cls: cls.train for cls in (VanillaTSTrainer, VanillaGSTrainer,
                                                ScaffoldGSTrainer)}

        def wrap(train):
            def counted(trainer):
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                train(trainer)
                torch.cuda.synchronize()
                trainer.train_seconds = time.perf_counter() - t0
                trainer.train_launches = read_launches()
            return counted
        for cls, train in self.real.items():
            cls.train = wrap(train)
        return self

    def __exit__(self, *exc):
        for cls, train in self.real.items():
            cls.train = train


class smoke_cuts:
    """Within the block, ``trainers.smoke.make_smoke_config`` gives the
    densification thresholds of SMOKE_GRAD_THRESHOLD, in the mesh recipe
    the initial opacity SMOKE_MESH_INIT_OPACITY and in the scaffold recipe
    the growth threshold SMOKE_SCAFFOLD_GRAD_THRESHOLD (the smoke phase's
    cuts)."""

    def __enter__(self):
        from triangle_splatting_tpu_torch.trainers import smoke
        self.real = real = smoke.make_smoke_config

        def lowered(*a, **kw):
            cfg = real(*a, **kw)
            mu = cfg.model.model_update
            d = mu.densification if mu is not None else None
            if d is not None:
                d.grad_threshold_init, d.grad_threshold_final = SMOKE_GRAD_THRESHOLD
            if cfg.model.ste_threshold is not None:
                cfg.model.sampling.init_opacity = SMOKE_MESH_INIT_OPACITY
            au = cfg.model.anchor_update
            if au is not None:
                au.grad_threshold_init = au.grad_threshold_final = SMOKE_SCAFFOLD_GRAD_THRESHOLD
            return cfg
        smoke.make_smoke_config = lowered
        return self

    def __exit__(self, *exc):
        from triangle_splatting_tpu_torch.trainers import smoke
        smoke.make_smoke_config = self.real


def check_alive_bookkeeping(trainer, alive0: int, what: str) -> dict:
    """The alive count moved by exactly the logged counts: rows placed by
    densification, minus split originals, minus every pruning (clippings
    remove nothing). Returns the totals."""
    dens = trainer.densify_history
    tot = dict(grown=sum(d["grown"] for d in dens), placed=sum(d["placed"] for d in dens),
               split_pruned=sum(d["split_pruned"] for d in dens),
               pruned=sum(n for _, kind, n in trainer.prune_history if "clipping" not in kind))
    alive1 = int(trainer.state.alive.sum())
    check(alive1 == alive0 + tot["placed"] - tot["split_pruned"] - tot["pruned"],
          f"{what}: alive {alive0} -> {alive1}, logged {tot}")
    return dict(tot, alive_before=alive0, alive_after=alive1)


def check_path_launches(launches: dict, n: int, variant: str, what: str) -> None:
    """One step of a statistic-window training run launches B1's stats
    form and B2 of ``variant``, B3, B4 and B5 once, and no other blend
    form."""
    sfx = {"2D": "", "3D": "_3d", "GS": "_gs"}[variant]
    own = (f"blend_forward{sfx}_stats", f"blend_backward{sfx}", "relayout_pairs",
           "segment_reduce_pairs", "segment_reduce_stats")
    for name in own:
        check(launches[name] == n, f"{what}: kernel {name} launched {launches[name]} times "
              f"in {n} steps")
    for name, k in launches.items():
        if name.startswith("blend_") and name not in own:
            check(k == 0, f"{what}: kernel {name} launched {k} times on a {variant} path")


def check_anchor_bookkeeping(trainer, what: str) -> dict:
    """A ScaffoldGS run's alive anchors moved by exactly the logged counts:
    the initial voxel anchors plus the placed minus the pruned, and every
    update placed all it emitted (no overflow). Returns the totals."""
    from triangle_splatting_tpu_torch.models import scaffold as S

    mc = trainer.config.model
    alive0 = int(S.create_from_points(
        trainer.dataset.getPointCloud().points, trainer.model_cfg,
        voxel_size=mc.voxel_size if mc.voxel_size is not None else 0.001,
        scene_bbox=trainer.scene_bbox, device="cpu")[1].alive.sum())
    hist = trainer.anchor_history
    tot = dict(added=sum(h["added"] for h in hist), placed=sum(h["placed"] for h in hist),
               removed=sum(h["removed"] for h in hist))
    alive1 = int(trainer.state.alive.sum())
    check(alive1 == alive0 + tot["placed"] - tot["removed"] and tot["added"] == tot["placed"],
          f"{what}: anchors {alive0} -> {alive1}, logged {tot}")
    return dict(tot, alive_before=alive0, alive_after=alive1)


def check_plain_gs_launches(launches: dict, n: int, what: str) -> None:
    """A ScaffoldGS step launches B1-GS without statistics, B2-GS, B3 and B4
    once, and neither B5 nor any other blend form."""
    own = ("blend_forward_gs", "blend_backward_gs", "relayout_pairs", "segment_reduce_pairs")
    for name in own:
        check(launches[name] == n, f"{what}: kernel {name} launched {launches[name]} times "
              f"in {n} steps")
    check(launches["segment_reduce_stats"] == 0,
          f"{what}: B5 launched {launches['segment_reduce_stats']} times")
    for name, k in launches.items():
        if name.startswith("blend_") and name not in own:
            check(k == 0, f"{what}: kernel {name} launched {k} times on the ScaffoldGS path")


def phase_smoke(dev) -> dict:
    """Cells smoke-400-ts, smoke-400-mesh, smoke-400-gs, smoke-400-scaffold:
    the port's ``trainers.smoke`` at its defaults (``smoke.run``, the body of
    its ``main``), photo, ``--mesh``, ``--model gs`` and ``--model
    scaffold``, each on the soup it builds on the card. Gates per run: the
    PSNR climbs by the smoke's 2 dB (its exit criterion); densification
    grew rows (scaffold: an anchor update added anchors); the alive count
    moved by the logged counts; the PLY and the checkpoint at 400 (and the
    mesh run's GLB, gamma 50); B1's stats form, B2, B3, B4 and B5 of the
    run's variant once per step and no other blend form (scaffold: B1-GS
    plain, B2-GS, B3, B4 once per step, no B5). Returns each run's
    launches."""
    from triangle_splatting_tpu_torch.trainers import smoke

    t_phase = time.perf_counter()
    out = {}
    for name, flags in SMOKE_RUNS:
        t0 = time.perf_counter()
        root = WORK / f"smoke_{name}"
        args = smoke.parse_args(["--root", str(root)] + flags)
        with counted_train(), smoke_cuts():
            trainer, rec = smoke.run(args)
        what = f"smoke-400-{name}"
        check(rec["psnr_final"] >= rec["psnr_init"] + args.min_gain,
              f"{what}: PSNR {rec['psnr_init']} -> {rec['psnr_final']}, below +{args.min_gain}")
        if name == "scaffold":
            book = check_anchor_bookkeeping(trainer, what)
            dens = trainer.anchor_history
            check(len(dens) == 7 and book["added"] > 0,
                  f"{what}: the anchor updates {dens} added no anchor (due 7 times)")
        else:
            alive0 = len(trainer.dataset.getPointCloud().points)
            book = check_alive_bookkeeping(trainer, alive0, what)
            dens = trainer.densify_history
            check(len(dens) == 5,
                  f"{what}: densification fired at {[d['iteration'] for d in dens]}")
            check(book["grown"] > 0 and book["placed"] > 0,
                  f"{what}: densification grew nothing {dens}")
        out_dir = root / "out"
        for f in (f"point_cloud/{SMOKE_ITERS}.ply", f"ckpt/{SMOKE_ITERS}.ckpt"):
            check((out_dir / f).exists(), f"{what}: {f} was not written")
        if name == "mesh":
            check(rec["gamma_final"] == 50.0 and rec["glb_exported"],
                  f"{what}: gamma {rec['gamma_final']}, GLB {rec['glb_exported']}")
        if name == "scaffold":
            check_plain_gs_launches(trainer.train_launches, SMOKE_ITERS, what)
        else:
            variant = {"ts": "2D", "mesh": "3D", "gs": "GS"}[name]
            check_path_launches(trainer.train_launches, SMOKE_ITERS, variant, what)
        v5e = SMOKE_V5E[name]
        say("smoke", cell=what, cuts=SMOKE_CUTS, card=card_line(), **rec,
            ms_per_step=round(trainer.train_seconds / SMOKE_ITERS * 1e3, 3),
            densify=dens, prune=trainer.prune_history, **book,
            capacity=trainer.params.capacity, pairs_per_triangle=trainer._ppt,
            max_eligible=max(d["grad_stat"].get("eligible", d["grad_stat"].get("examined", 0))
                             for d in dens),
            v5e_psnr=v5e, below_v5e_final_db=None if v5e is None
            else round(v5e[1] - rec["psnr_final"], 2),
            launches=trainer.train_launches, seconds=round(time.perf_counter() - t0, 3))
        out[name] = trainer.train_launches
    say("smoke", seconds=round(time.perf_counter() - t_phase, 3))
    return out


def tensors_of(tree) -> dict:
    """Every tensor of a model dataclass tree keyed by its path."""
    import dataclasses

    import torch
    out = {}
    for f in dataclasses.fields(tree):
        x = getattr(tree, f.name)
        if dataclasses.is_dataclass(x):
            out.update({f"{f.name}.{k}": v for k, v in tensors_of(x).items()})
        elif torch.is_tensor(x):
            out[f.name] = x.detach().clone()
        else:
            out[f.name] = x
    return out


def phase_resume() -> None:
    """The smoke photo recipe on the smoke phase's photo dataset with a
    checkpoint at 200 (and 400): a new trainer resumes from it through
    ``start_checkpoint`` and every array of params, moments and state
    equals the saving trainer's at step 200 bit for bit; it trains 201-400
    and lands within 2 dB of the uninterrupted run's final test PSNR (the
    JAX criterion, tests/test_trainer_e2e.py:270-292)."""
    import torch
    from triangle_splatting_tpu_torch.trainers import build_trainer, smoke

    t0 = time.perf_counter()
    data = WORK / "smoke_ts" / "data"
    with smoke_cuts():
        cfg = smoke.make_smoke_config(data, WORK / "resume" / "out", SMOKE_ITERS)
    cfg.trainer.checkpoint_iterations = [RESUME_AT, SMOKE_ITERS]
    trainer = build_trainer(cfg, log_file=False)
    snap = {}
    save = trainer.save_ckpt

    def snapshot_save(path):
        save(path)
        if Path(path).stem == str(RESUME_AT):
            snap.update({f"{k}.{n}": x for k, t in (("params", trainer.params),
                                                   ("opt", trainer.opt),
                                                   ("state", trainer.state))
                         for n, x in tensors_of(t).items()})
    trainer.save_ckpt = snapshot_save
    trainer._init_model()
    trainer.train()
    psnr_full = float(trainer._evaluate(SMOKE_ITERS))
    check(bool(snap), f"resume: no checkpoint was written at {RESUME_AT}")

    cfg.trainer.start_checkpoint = RESUME_AT
    t2 = build_trainer(cfg, log_file=False)
    first = t2._init_model()
    check(first == RESUME_AT, f"resume: the run continues after {first}, not {RESUME_AT}")
    loaded = {f"{k}.{n}": x for k, t in (("params", t2.params), ("opt", t2.opt),
                                          ("state", t2.state))
              for n, x in tensors_of(t).items()}
    check(loaded.keys() == snap.keys(), f"resume: fields {loaded.keys() ^ snap.keys()}")
    for k, want in snap.items():
        got = loaded[k]
        same = (torch.equal(got, want) and got.dtype == want.dtype) if torch.is_tensor(want) \
            else got == want
        check(same, f"resume: {k} differs from the saving trainer's step {RESUME_AT}")
    t2.train()
    psnr_resumed = float(t2._evaluate(SMOKE_ITERS))
    check(psnr_resumed > psnr_full - 2.0,
          f"resume: resumed PSNR {psnr_resumed:.3f}, uninterrupted {psnr_full:.3f}")
    say("resume", cell="smoke-400-ts", card=card_line(), checkpoint_at=RESUME_AT,
        arrays_equal=len(snap), psnr_uninterrupted=psnr_full, psnr_resumed=psnr_resumed,
        resumed_steps=len(t2.loss_history), seconds=round(time.perf_counter() - t0, 3))
    shutil.rmtree(WORK / "resume", ignore_errors=True)


def build_colmap(dev) -> Path:
    """The scaffold cell's capture: the photo phase's soup (100k GT
    triangles, ``build_dataset``'s scene) written as a COLMAP capture of
    SCAFFOLD_VIEWS views at SCAFFOLD_W x SCAFFOLD_H with a
    SCAFFOLD_POINTS-point ``points3D.bin`` (``utils/testing.py:write_colmap_scene``)."""
    from triangle_splatting_tpu_torch.utils.testing import make_random_scene, write_colmap_scene

    t0 = time.perf_counter()
    scene = make_random_scene(N_TRI, seed=7, z_range=(-0.8, 0.8), xy_extent=0.8,
                              size_range=(0.01, 0.05), opacity_range=(0.7, 0.95))
    root = WORK / "colmap_scaffold"
    secs = write_colmap_scene(root, scene, width=SCAFFOLD_W, height=SCAFFOLD_H,
                              n_views=SCAFFOLD_VIEWS, n_points=SCAFFOLD_POINTS, device=dev)
    say("colmap", views=SCAFFOLD_VIEWS, width=SCAFFOLD_W, height=SCAFFOLD_H,
        points=SCAFFOLD_POINTS, **{k: round(v, 3) for k, v in secs.items()},
        seconds=round(time.perf_counter() - t0, 3))
    return root


def scaffold_config(root: Path):
    """config/Colmap_ScaffoldGS.yaml as shipped (its widths) with the cuts of
    SCAFFOLD_CUTS."""
    from triangle_splatting_tpu_torch.utils.config import loadConfig

    cfg = loadConfig(REPO / "config" / "Colmap_ScaffoldGS.yaml")
    cfg.dataset.local_dir = str(root)
    t = cfg.trainer
    t.output_dir = str(WORK / "out_scaffold")
    t.iterations = SCAFFOLD_ITERS
    t.log_interval_iter = 10
    t.eval_interval_iter = 0
    t.save_iterations, t.checkpoint_iterations = [SCAFFOLD_ITERS], [SCAFFOLD_ITERS]
    t.use_tensorboard = False
    au = cfg.model.anchor_update
    au.start_iter, au.end_iter = SCAFFOLD_WINDOW
    au.interval_iter = SCAFFOLD_INTERVAL
    au.grad_min_view_count = au.opacity_min_view_count = 1
    au.grad_threshold_init = au.grad_threshold_final = SCAFFOLD_GRAD_THRESHOLD
    return cfg


def scaffold_numpy(trainer) -> dict:
    from triangle_splatting_tpu_torch.convert import scaffold_to_numpy
    p, s, o = scaffold_to_numpy(trainer.params, trainer.state, trainer.opt)
    return dict(params=p, state=s, opt=o)


def flat_arrays(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_arrays(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def check_grow_level_on_cpu(call: dict) -> dict:
    """The captured ``_grow_level`` call of the card (its inputs: the model,
    the card's decoded positions, gradients and coins) repeated on CPU
    copies: every output array and both counts equal bit for bit."""
    import numpy as np
    from triangle_splatting_tpu_torch.convert import scaffold_from_numpy, scaffold_to_numpy
    from triangle_splatting_tpu_torch.models import scaffold as S

    params, opt, state, coins, grad, mask, g_xyz, level, cfg, thr = call["args"]
    p, s, o = scaffold_to_numpy(params, state, opt)
    cp, cs, co = scaffold_from_numpy(p, s, o, device="cpu")
    cpu = S._grow_level(cp, co, cs, coins.cpu(), grad.cpu(), mask.cpu(), g_xyz.cpu(), level, cfg,
                        thr)
    card = call["out"]
    want = flat_arrays(dict(zip(("params", "state", "opt"),
                                scaffold_to_numpy(card[0], card[2], card[1]))))
    got = flat_arrays(dict(zip(("params", "state", "opt"), scaffold_to_numpy(cpu[0], cpu[2],
                                                                           cpu[1]))))
    differ = [k for k in want if not np.array_equal(want[k], got[k])]
    check(not differ and int(cpu[3]) == int(card[3]) and bool(cpu[4]) == bool(card[4]),
          f"scaffold _grow_level: card and CPU differ in {differ}, emitted "
          f"{int(card[3])} / {int(cpu[3])}")
    placed = int((card[2].alive & ~state.alive).sum())
    lthr = float(thr) * (cfg.update_hierachy_factor // 2) ** level
    return dict(level=level, emitted=int(card[3]), placed=placed, arrays=len(want),
                candidates=int(((grad >= lthr) & mask & state.alive[:, None]).sum()),
                card_vs_cpu="exact")


def hold_plain_gs(last: dict, what: str) -> None:
    """B1-GS plain, B2-GS, B3 and B4 against their plain versions on a
    step's captured inputs (n_contrib and final_T exact, color abs 1e-5,
    B2 rel 1e-4, B3 exact, B4 rel 1e-5), timed, with their bounds."""
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import blend as KB
    from triangle_splatting_tpu_torch.ops.cuda import streams as KS

    (fa, fkw), (ba, bkw) = last["fwd"], last["bwd"]
    geo = {k: fkw[k] for k in ("image_width", "image_height", "tile_h", "tile_w", "variant")}
    check(not fkw["stats"] and not fkw["rich"] and geo["variant"] == "GS",
          f"{what}: the last step's B1 ran in form {fkw}")
    fwd = fa[:4]
    H, W = geo["image_height"], geo["image_width"]
    with torch.no_grad():
        out = KB.blend_forward(*fwd, stats=False, **geo)
        ref = KB.blend_forward_plain(*fwd, stats=False, **geo)
        torch.cuda.synchronize()
        e_nc = int((out[4] != ref[4]).sum())
        e_T = float((out[3] - ref[3]).abs().max())
        e_c = float((out[0] - ref[0]).abs().max())
        check(e_nc == 0 and e_T == 0.0 and e_c <= TOL["b1_abs"],
              f"{what}: B1-GS vs plain: n_contrib {e_nc}, final_T {e_T:.3e}, color {e_c:.3e}")
        bw = fa[:4] + ba[4:8]
        out2 = KB.blend_backward(*bw, **geo)
        ref2 = KB.blend_backward_plain(*bw, **geo)
        torch.cuda.synchronize()
        live = KB.LIVE_GRAD_ROWS[("GS", False)]
        diff2 = (out2 - ref2).abs()
        rel2 = float((diff2.amax(dim=1) / ref2.abs().amax(dim=1).clamp_min(1e-30))[:live].max())
        check(rel2 <= TOL["b2_rel"] and not bool(out2[live:].any()),
              f"{what}: B2-GS vs plain rel err {rel2:.3e}")
        a3 = last["b3"][0] + tuple(last["b3"][1].values())
        a4 = last["b4"][0] + tuple(last["b4"][1].values())
        pair_tri, pack_perm, err3 = hold_relayout(a3, what)
        c4 = check_segment_reduce(a4[0], pair_tri, pack_perm, *a4[1:4], what)
        evals = float(out[4].to(torch.float64).sum())
        num_pairs, T, ma = int(fwd[2].to(torch.int64).sum()), fwd[2].shape[0], fwd[0].shape[1]
        pairs_in = 4 * (10 * num_pairs + 2 * T + 1 + 8)
        rows4, P, np4 = int(a4[0].shape[0]), int(a4[1].shape[0]), int(a4[3])
        b1 = bound_ms(pairs_in + 4 * 9 * H * W,
                      b1_ops(b1_work(fwd, geo, out[4], what), "GS", True))
        b2 = bound_ms(pairs_in + 4 * 6 * H * W + 4 * 16 * ma, BWD_OPS_PER_EVAL_GS[True] * evals)
        rows = {
            "blend_forward_gs": (e_c, lambda: KB.blend_forward(*fwd, stats=False, **geo),
                                 lambda: KB.blend_forward_plain(*fwd, stats=False, **geo), b1),
            "blend_backward_gs": (float(diff2.max()), lambda: KB.blend_backward(*bw, **geo),
                                  lambda: KB.blend_backward_plain(*bw, **geo), b2),
            "relayout_pairs": (err3, lambda: KS.relayout_pairs(*a3),
                               lambda: KS.relayout_pairs_plain(*a3), bound_ms(b3_bytes(a3))),
            "segment_reduce_pairs": (c4["err"], lambda: KS.segment_reduce_pairs(*a4),
                                     lambda: KS.segment_reduce_pairs_plain(*a4),
                                     bound_ms(b4_bytes(rows4, np4, P), rows4 * np4)),
        }
        for name, (err, kfn, pfn, b) in rows.items():
            ms, plain = cuda_ms(kfn, 20 if "blend" in name else 50), cuda_ms(pfn, 2, 1)
            say(f"{what}_kernels", kernel=name, max_abs_err=err, ms=round(ms, 4),
                plain_ms=round(plain, 3), bound_ms=round(b[0], 5), bound_by=b[1])
        say(f"{what}_kernels", tiles=T, num_pairs=num_pairs, ma=ma, pair_pixel_evals=evals,
            b1_n_contrib_mismatch=e_nc, b1_final_T_err=e_T, b2_rel_err=rel2, b3_mismatch=err3,
            b4_rows=rows4, b4_rel_err=c4["rel"], gaussians=P)


def phase_scaffold(dev, root: Path) -> dict:
    """The scaffold-colmap-1297x840 cell: ``scaffold_config`` (the shipped
    Colmap_ScaffoldGS recipe at its widths, cuts in SCAFFOLD_CUTS) on the
    synthetic COLMAP capture through build_trainer for 50 steps. Gates: the
    losses finite and falling; anchors added at least once and the alive
    count moving by exactly the logged placed - removed; B1-GS plain,
    B2-GS, B3 and B4 once per step, B5 and every other blend form never;
    the first ``_grow_level`` call that placed anchors repeated on a CPU
    copy of its inputs, bit for bit; B1-GS plain, B2-GS, B3 and B4 against
    their plain versions on the last step's inputs; the checkpoint at 50
    restored into a new trainer with every array equal and the test PSNR
    within 1e-3 dB; the PLY read back; ``mlp_pretrain`` for 100 steps on a
    GT PLY with its loss falling. Then 10 profiled steps. Returns the
    launches."""
    import numpy as np
    import torch
    from triangle_splatting_tpu_torch.models import scaffold as S
    from triangle_splatting_tpu_torch.models.raw_gaussian import RawGaussian
    from triangle_splatting_tpu_torch.ops import binning as BN
    from triangle_splatting_tpu_torch.ops import rasterize as RZ
    from triangle_splatting_tpu_torch.ops.cuda import reset_launches
    from triangle_splatting_tpu_torch.ops.sh import SH_C0
    from triangle_splatting_tpu_torch.trainers import build_trainer
    from triangle_splatting_tpu_torch.utils.config import dict_to_config
    from triangle_splatting_tpu_torch.utils.testing import make_gs_scene

    n = SCAFFOLD_ITERS
    say("scaffold", cell="scaffold-colmap-1297x840", cuts=SCAFFOLD_CUTS)
    cfg = scaffold_config(root)
    torch.cuda.reset_peak_memory_stats()
    trainer = build_trainer(cfg, log_file=False)
    trainer._init_model()
    k = trainer.model_cfg.n_offsets
    alive0, cap0, ppt0 = int(trainer.state.alive.sum()), trainer.params.capacity, trainer._ppt
    psnr0 = trainer._evaluate(0)

    step = {"next": 1}
    last, grow = {}, {}
    real = dict(fwd=RZ.blend_forward, bwd=RZ.blend_backward, b3=BN.relayout_pairs,
                b4=RZ.segment_reduce_pairs)
    real_grow = S._grow_level

    def detached(x):
        return x.detach() if torch.is_tensor(x) else x

    def spy(name):
        def wrapped(*a, **kw):
            if step["next"] == n:
                last[name] = (tuple(detached(x) for x in a),
                              {key: detached(v) for key, v in kw.items()})
            return real[name](*a, **kw)
        return wrapped

    def grow_spy(*a):
        out = real_grow(*a)
        if not grow and int(out[3]) > 0:
            grow.update(args=a, out=out)
        return out

    constraints0 = trainer._maintain_constraints

    def constraints_spy(it):
        step["next"] = it + 1
        return constraints0(it)
    RZ.blend_forward, RZ.blend_backward = spy("fwd"), spy("bwd")
    BN.relayout_pairs, RZ.segment_reduce_pairs = spy("b3"), spy("b4")
    S._grow_level = grow_spy
    trainer._maintain_constraints = constraints_spy
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        RZ.blend_forward, RZ.blend_backward = real["fwd"], real["bwd"]
        BN.relayout_pairs, RZ.segment_reduce_pairs = real["b3"], real["b4"]
        S._grow_level = real_grow
        del trainer._maintain_constraints
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    losses = torch.stack(trainer.loss_history).cpu().numpy()
    check(len(losses) == n and bool(np.isfinite(losses).all()),
          f"scaffold: {len(losses)} losses, finite {bool(np.isfinite(losses).all())}")
    first, last10 = float(losses[:10].mean()), float(losses[-10:].mean())
    check(last10 < first, f"scaffold: loss did not fall (first10 {first:.5f}, last10 {last10:.5f})")
    check_plain_gs_launches(launches, n, "scaffold")
    hist = trainer.anchor_history
    start, end = SCAFFOLD_WINDOW
    due = [it for it in range(start + 1, end + 1) if it % SCAFFOLD_INTERVAL == 0]
    check([h["iteration"] for h in hist] == due, f"scaffold: anchor updates at "
          f"{[h['iteration'] for h in hist]}, due at {due}")
    book = check_anchor_bookkeeping(trainer, "scaffold")
    check(book["alive_before"] == alive0 and book["added"] > 0,
          f"scaffold: no anchor was added ({hist})")
    check(bool(grow), "scaffold: no _grow_level call placed anchors")
    grow_rec = check_grow_level_on_cpu(grow)
    with torch.no_grad():
        cam = trainer.dataset.getTestDataset().__next__()
        pkg = S.forward(trainer.params, trainer.state, cam, torch.ones(3, device=dev),
                        trainer.model_cfg, trainer._settings_for(cam), is_training=False)
        selected = int(pkg["selection_mask"].sum())
        visible = int(pkg["anchor_visible_mask"].sum())
    psnr1 = trainer._evaluate(n)
    say("scaffold", card=card_line(), ms_per_step=round(secs / n * 1e3, 3), steps=n,
        width=SCAFFOLD_W, height=SCAFFOLD_H, peak_mem_gib=round(peak / 2**30, 3),
        anchors_init=alive0, anchors_end=book["alive_after"], capacity=cap0,
        capacity_end=trainer.params.capacity, gaussian_slots=cap0 * k,
        selected_gaussians_test_view=selected, visible_anchors_test_view=visible,
        pairs_per_triangle_before=ppt0, pairs_per_triangle_after=trainer._ppt,
        updates=hist, grow_level=grow_rec, loss_first10=first, loss_last10=last10,
        psnr_test_before=psnr0, psnr_test_after=psnr1, launches=launches)

    hold_plain_gs(last, "scaffold")
    del last

    # the checkpoint at 50 into a new trainer, and the PLY
    t2 = build_trainer(cfg, log_file=False)
    t2.load_ckpt(WORK / "out_scaffold" / "ckpt" / f"{n}.ckpt")
    want, got = flat_arrays(scaffold_numpy(trainer)), flat_arrays(scaffold_numpy(t2))
    differ = [key for key in want if not (want[key].dtype == got[key].dtype
                                          and np.array_equal(want[key], got[key]))]
    check(want.keys() == got.keys() and not differ, f"scaffold resume: arrays differ {differ}")
    psnr2 = t2._evaluate(n)
    check(abs(psnr2 - psnr1) <= 1e-3, f"scaffold resume: PSNR {psnr2} vs {psnr1}")
    ply = RawGaussian(ply_path=str(WORK / "out_scaffold" / "point_cloud" / f"{n}.ply"))
    check(len(ply) > 0 and len(ply) == len(trainer.toRawGaussian()),
          f"scaffold: the PLY holds {len(ply)} Gaussians")
    del t2

    # the MLP pretrain on a GT Gaussian PLY made from a seed
    gs = make_gs_scene(SCAFFOLD_GT_GAUSSIANS, seed=11)
    gt_path = WORK / "scaffold_gt.ply"
    RawGaussian(xyz=gs["xyz"], opacity=np.log(gs["opacity"] / (1 - gs["opacity"]))[:, None],
                shs=(gs["rgb"] - 0.5) / SH_C0, scale=np.log(gs["scale"]),
                rotation=gs["rot"]).savePLY(gt_path)
    cfg.dataset.gt_gaussian_path = str(gt_path)
    cfg.trainer.pretrain = dict_to_config(dict(iterations=SCAFFOLD_PRETRAIN_ITERS,
                                               log_interval_iter=50))
    t3 = build_trainer(cfg, log_file=False)
    t0 = time.perf_counter()
    t3.mlp_pretrain()
    torch.cuda.synchronize()
    pre = torch.stack(t3.pretrain_losses).cpu().numpy()
    check(len(pre) == SCAFFOLD_PRETRAIN_ITERS and bool(np.isfinite(pre).all())
          and pre[-10:].mean() < pre[:10].mean(),
          f"scaffold pretrain: loss {pre[:3]} ... {pre[-3:]}")
    say("scaffold_pretrain", gt_gaussians=SCAFFOLD_GT_GAUSSIANS,
        anchors=int(t3.state.alive.sum()), capacity=t3.params.capacity,
        loss_first10=float(pre[:10].mean()), loss_last10=float(pre[-10:].mean()),
        ms_per_step=round((time.perf_counter() - t0) / len(pre) * 1e3, 3),
        resume_arrays_equal=len(want), resume_psnr=psnr2, ply_gaussians=len(ply))
    del t3
    profile_steps(trainer, "scaffold_profile")
    KEEP["scaffold"] = dict(trainer=trainer, config=cfg.model,
                            cameras=list(trainer.dataset.getTestDataset()))
    return launches


def phase_loss_terms(dev) -> dict:
    """The loss-terms-photo-400 cell: the smoke photo recipe without
    densification (``make_smoke_config(..., densify=False)``: no statistic
    block) with LOSS_TERMS (DoG, smoothness, the vertex regularizer every
    10 steps from step 0) and the color affine, on the smoke phase's photo
    dataset, 100 steps through build_trainer. Gates: the losses finite and
    falling; B1/B2 "2D" plain, B3 and B4 once per step and no other form;
    the kNN refresh at steps 1, 11, ..., 91; the affine parameters off
    identity; one step's loss (rel 1e-4) and gradients (vertex L2 rel 2e-2:
    barycentric ties; the rest L2 rel 1e-3) on the card against the CPU;
    LPIPS on ``random_weights(0)`` on the card against the CPU (rel 1e-4);
    ``eval_lpips`` without weights logging "LPIPS unavailable" once and
    reporting NaN. Returns the launches."""
    import numpy as np
    import torch
    from triangle_splatting_tpu_torch.convert import triangle_from_numpy, triangle_to_numpy
    from triangle_splatting_tpu_torch.models import triangle as M
    from triangle_splatting_tpu_torch.trainers import build_trainer, smoke
    from triangle_splatting_tpu_torch.trainers import lpips as LP
    from triangle_splatting_tpu_torch.utils.config import dict_to_config

    n = LOSS_TERMS_ITERS
    t_phase = time.perf_counter()
    data = WORK / "smoke_ts" / "data"
    cfg = smoke.make_smoke_config(data, WORK / "loss_terms" / "out", n, densify=False)
    for key, value in LOSS_TERMS.items():
        setattr(cfg.trainer, key, dict_to_config(value) if isinstance(value, dict) else value)
    cfg.trainer.eval_lpips = True
    cfg.model.use_color_affine = True
    cfg.model.optimizer.color_affine = dict_to_config(dict(
        v_init=LOSS_TERMS_AFFINE_LR, v_final=LOSS_TERMS_AFFINE_LR, max_steps=n))
    with counted_train():
        trainer = build_trainer(cfg, log_file=False)
        trainer._init_model()
        trainer.train()
    launches = trainer.train_launches
    losses = torch.stack(trainer.loss_history).cpu().numpy()
    check(len(losses) == n and bool(np.isfinite(losses).all()), "loss_terms: non-finite loss")
    first, last10 = float(losses[:10].mean()), float(losses[-10:].mean())
    check(last10 < first, f"loss_terms: loss did not fall ({first:.5f} -> {last10:.5f})")
    for name in ("blend_forward", "blend_backward", "relayout_pairs", "segment_reduce_pairs"):
        check(launches[name] == n, f"loss_terms: kernel {name} launched {launches[name]} times")
    for name, cnt in launches.items():
        if name.startswith("blend_") and name not in ("blend_forward", "blend_backward"):
            check(cnt == 0, f"loss_terms: kernel {name} launched {cnt} times")
    check(launches["segment_reduce_stats"] == 0, "loss_terms: B5 launched")
    due = list(range(1, n + 1, LOSS_TERMS["vertex_reg"]["interval_iter"]))
    check(trainer.nearest_history == due,
          f"loss_terms: kNN refreshed at {trainer.nearest_history}, due at {due}")
    V = trainer.dataset.getTrainDatasetSize()
    aff = float((trainer.params.affine_weight - torch.eye(3, device=dev)).abs().max())
    affb = float(trainer.params.affine_bias.abs().max())
    check(trainer.params.affine_weight.shape == (V, 3, 3) and aff > 1e-4 and affb > 1e-4,
          f"loss_terms: the affine stayed at identity ({aff:.3e}, {affb:.3e})")

    # evaluation with eval_lpips and no weights file: one warning, NaN
    warned = []
    warn0 = trainer.logger.warning
    trainer.logger.warning = lambda msg: (warned.append(msg), warn0(msg))
    psnr = trainer._evaluate(n)
    trainer._evaluate(n)
    trainer.logger.warning = warn0
    check(len([w for w in warned if "LPIPS unavailable" in w]) == 1
          and np.isnan(trainer.last_eval["lpips"]) and np.isfinite(psnr),
          f"loss_terms: eval_lpips without weights logged {warned}, {trainer.last_eval}")

    # one step on the card against the same step on the CPU
    cam = trainer.dataset.getTrainDataset()[1]
    settings = trainer._settings_for(cam)
    weights = trainer._loss_weights(n)
    near = trainer._nearest_idx
    p, s, _ = triangle_to_numpy(trainer.params, trainer.state)
    cp, cs, _ = triangle_from_numpy(p, s, device="cpu")
    res = {}
    for where, (pp, ss, cc, nn, bg) in {
            "card": (trainer.params, trainer.state, cam, near, torch.ones(3, device=dev)),
            "cpu": (cp, cs, camera_on(cam, "cpu"), near.cpu(), torch.ones(3))}.items():
        res[where] = trainer._loss_and_grads(settings, pp, ss, cc, bg, weights, nn)
    (lg, gg, ag), (lc, gc, ac) = res["card"], res["cpu"]
    rel_loss = abs(float(lg) - float(lc)) / float(lc)
    check(rel_loss <= 1e-4, f"loss_terms: card loss {float(lg)} vs CPU {float(lc)}")
    errs = {}
    for name, want in gc.tensors().items():
        got = getattr(gg, name).cpu()
        errs[name] = float((got - want).norm() / want.norm().clamp_min(1e-30))
        check(errs[name] <= (2e-2 if name == "vertex" else 1e-3),
              f"loss_terms: {name} gradient card vs CPU L2 rel {errs[name]:.3e}")

    # LPIPS on random_weights(0): the card against the CPU
    w = LP.random_weights(0)
    test = next(trainer.dataset.getTestDataset())
    with torch.no_grad():
        img = M.forward(trainer.params, trainer.state, test, torch.ones(3, device=dev),
                        trainer.model_cfg, trainer._settings_for(test),
                        apply_color_affine=False)["render"].clamp(0, 1)
    d_card = float(LP.lpips(img, test.gt_image, weights=w))
    d_cpu = float(LP.lpips(img.cpu(), test.gt_image.cpu(), weights=w))
    check(abs(d_card - d_cpu) <= 1e-4 * d_cpu and d_cpu > 0,
          f"loss_terms: LPIPS card {d_card} vs CPU {d_cpu}")
    lp_ms = cuda_ms(lambda: LP.lpips(img, test.gt_image, weights=w), 5, 1)
    say("loss_terms", cell="loss-terms-photo-400", card=card_line(), terms=LOSS_TERMS,
        affine_lr=LOSS_TERMS_AFFINE_LR, steps=n,
        ms_per_step=round(trainer.train_seconds / n * 1e3, 3), loss_first10=first,
        loss_last10=last10, psnr_test=psnr, knn_refreshes=len(trainer.nearest_history),
        affine_max_dev=aff, affine_bias_max=affb, step_loss_rel=rel_loss,
        step_grad_l2_rel=errs, vertex_loss=float(ag["vertex_loss"]),
        lpips_card=d_card, lpips_cpu=d_cpu, lpips_ms=round(lp_ms, 3), launches=launches,
        seconds=round(time.perf_counter() - t_phase, 3))
    shutil.rmtree(WORK / "loss_terms", ignore_errors=True)
    return launches


def to_cpu(params, opt, state):
    """CPU copies of a triangle model's params, Adam state and state."""
    from triangle_splatting_tpu_torch.convert import triangle_from_numpy, triangle_to_numpy
    p, s, o = triangle_to_numpy(params, state, opt)
    params, state, opt = triangle_from_numpy(p, s, o, device="cpu")
    return params, opt, state


def assert_models_identical(a, b, what: str) -> None:
    """(params, opt, state[, grown, overflow]) of two densify calls, the
    second on the CPU: every tensor bit for bit."""
    import torch
    for tree_a, tree_b, name in zip(a[:3], b[:3], ("params", "opt", "state")):
        ta, tb = tensors_of(tree_a), tensors_of(tree_b)
        for k, x in ta.items():
            y = tb[k]
            same = torch.equal(x.cpu(), y) if torch.is_tensor(x) else x == y
            check(same, f"{what}: {name}.{k} differs between the card and the CPU")
    for x, y in zip(a[3:], b[3:]):
        check(int(x) == int(y), f"{what}: counts {a[3:]} on the card, {b[3:]} on the CPU")


def check_forced_overflow(trainer) -> dict:
    """On a copy of the trained model on the card: the first alive rows
    (as many as there are dead slots, or all) all split, more halves than
    dead slots and an odd dead count, so the capacity boundary falls on a
    half 1. The first
    call places whole splits only (the orphan half held back), reports
    overflow and keeps the unsplit originals; after ``grow_capacity`` the
    originals' statistics are set again and a second call places all of
    the rest."""
    import torch
    from triangle_splatting_tpu_torch.models import triangle as TM
    from triangle_splatting_tpu_torch.trainers.adc_utils import grow_capacity

    from triangle_splatting_tpu_torch.convert import triangle_from_numpy, triangle_to_numpy

    p, s, o = triangle_to_numpy(trainer.params, trainer.state, trainer.opt)
    params, state, opt = triangle_from_numpy(p, s, o, device=trainer.device)
    alive = state.alive.clone()
    n_dead = int((~alive).sum())
    if n_dead % 2 == 0:                       # an odd count: the last slot meets a half 1
        alive[torch.nonzero(alive)[-1]] = False
        n_dead += 1
    idx = torch.nonzero(alive)[:, 0][:n_dead]
    k = len(idx)
    check(2 * k > n_dead, f"forced overflow: {k} alive rows, {n_dead} dead slots")
    cand = torch.zeros_like(alive)
    cand[idx] = True

    def with_stats(st, rows):
        one = rows.to(torch.float32)
        st.gradient_accum, st.gradient_denom = one.clone(), one.clone()
        return st
    state.alive = alive
    state = with_stats(state, cand)
    a0 = state.alive.clone()
    params, opt, state, grown, over = TM.densify(params, opt, state, 0.5, 1, 0.0)
    placed = int((state.alive & ~a0).sum())
    split = int((a0 & ~state.alive).sum())
    check(bool(over) and int(grown) == k, f"forced overflow: grown {int(grown)} of {k}, "
          f"overflow {bool(over)}")
    check(placed == 2 * split == n_dead - 1, f"forced overflow: {placed} placed, {split} "
          f"originals removed, {n_dead} dead slots (an orphan half was placed)")
    cap0 = params.capacity
    params, opt, state = grow_capacity(params, opt, state)
    rest = cand.clone()
    rest = torch.cat([rest, rest.new_zeros(params.capacity - cap0)]) & state.alive
    state = with_stats(state, rest)
    a1 = state.alive.clone()
    params, opt, state, grown2, over2 = TM.densify(params, opt, state, 0.5, 1, 0.0)
    placed2 = int((state.alive & ~a1).sum())
    check(not bool(over2) and placed2 == 2 * int(rest.sum()) and
          not bool((rest & state.alive).any()),
          f"forced overflow: after growth {placed2} placed for {int(rest.sum())} splits")
    return dict(dead_slots=n_dead, splits=k, first_placed=placed, first_split=split,
                capacity=[cap0, params.capacity], second_placed=placed2)


def phase_adc(dev) -> dict:
    """Cell adc-800-20k: ``tools/full_run.py --adc`` (the port's twin)
    with the cuts of ADC_CUTS: 800x800, 100k GT soup triangles, a
    20k-point cloud, SH 3, densification every 100 from 100 to 750 and
    opacity pruning every 100 from 200. Gates: the capacity grew at least
    once with training after it; the alive count moved by the logged
    counts; the loss fell; the 2D stats form of B1, B2, B3, B4 and B5 once
    per step; at the first firing the card's ``densify`` equals the plain
    run on a CPU copy of its inputs bit for bit; a forced overflow places
    no orphan half and places the rest after growing. Then 10 profiled
    steps. Returns the launches."""
    import numpy as np
    import torch
    from triangle_splatting_tpu_torch.models import triangle as TM
    from triangle_splatting_tpu_torch.tools import full_run
    from triangle_splatting_tpu_torch.trainers import build_trainer

    t0 = time.perf_counter()
    args = full_run.parse_args(["--adc", "--root", str(WORK / "adc"), "--iters", str(ADC_ITERS),
                                "--grad_threshold", str(ADC_GRAD_THRESHOLD), "--ckpt_every", "0"])
    data = full_run.build_data(args, "cuda")
    t_data = time.perf_counter() - t0
    cfg = full_run.build_config(args, data)
    mu = cfg.model.model_update
    mu.densification.start_iter = mu.densification.interval_iter = ADC_INTERVAL
    mu.opacity_pruning.start_iter = 2 * ADC_INTERVAL
    mu.opacity_pruning.interval_iter = ADC_INTERVAL
    cfg.trainer.eval_interval_iter = 0
    cfg.trainer.log_interval_iter = ADC_INTERVAL
    trainer = build_trainer(cfg, log_file=False)
    trainer._init_model()
    alive0, cap0 = int(trainer.state.alive.sum()), trainer.params.capacity
    psnr0 = float(trainer._evaluate(0))

    first = {}
    real_densify = TM.densify

    def spy(params, opt, state, *a):
        if not first:
            first["cpu"] = to_cpu(params, opt, state) + a
        out = real_densify(params, opt, state, *a)
        if "card" not in first:
            first["card"] = out
        return out
    stamps = []

    def timed_model_update(it, update=trainer._model_update):
        update(it)
        stamps.append(time.perf_counter())
    trainer._model_update = timed_model_update
    TM.densify = spy
    t_train = time.perf_counter()
    try:
        with counted_train():
            trainer.train()
    finally:
        TM.densify = real_densify
        del trainer._model_update
    secs = trainer.train_seconds
    launches = trainer.train_launches
    psnr1 = float(trainer._evaluate(ADC_ITERS))

    losses = torch.stack(trainer.loss_history).cpu().numpy()
    check(len(losses) == ADC_ITERS and bool(np.isfinite(losses).all()), "adc: bad losses")
    lf, ll = float(losses[:100].mean()), float(losses[-100:].mean())
    check(ll < lf, f"adc: loss did not fall (first100 {lf:.5f}, last100 {ll:.5f})")
    dens = trainer.densify_history
    grew = [d["iteration"] for d in dens if d["overflow"]]
    check(bool(grew) and grew[0] < ADC_ITERS and trainer.params.capacity > cap0,
          f"adc: the capacity never grew ({cap0} -> {trainer.params.capacity}, {dens})")
    book = check_alive_bookkeeping(trainer, alive0, "adc")
    check_path_launches(launches, ADC_ITERS, "2D", "adc")
    cpu = first["cpu"]
    assert_models_identical(first["card"], real_densify(*cpu), "adc first densify")

    fired = {d["iteration"] for d in dens} | {it for it, _, _ in trainer.prune_history}
    steps = np.diff(np.array([t_train] + stamps)) * 1e3
    quiet = [ms for it, ms in zip(range(1, ADC_ITERS + 1), steps) if it not in fired]
    firing = {it: round(float(steps[it - 1]), 3) for it in sorted(fired)}
    extra = sum(firing.values()) - len(firing) * float(np.mean(quiet))
    forced = check_forced_overflow(trainer)
    say("adc", cell="adc-800-20k", cuts=ADC_CUTS, card=card_line(), iterations=ADC_ITERS,
        grad_threshold=ADC_GRAD_THRESHOLD, psnr_init=psnr0, psnr_final=psnr1,
        loss_first100=lf, loss_last100=ll, ms_per_step=round(secs / ADC_ITERS * 1e3, 3),
        ms_per_quiet_step=round(float(np.mean(quiet)), 3), ms_firing_steps=firing,
        firing_share_of_wall=round(extra / (secs * 1e3), 4), densify=dens,
        prune=trainer.prune_history, capacity=[cap0, trainer.params.capacity],
        capacity_grown_at=grew, **book, pairs_per_triangle=trainer._ppt,
        first_densify_card_vs_cpu="identical", forced_overflow=forced, launches=launches,
        data_seconds=round(t_data, 3))
    profile_steps(trainer, "adc_profile")
    say("adc", seconds=round(time.perf_counter() - t0, 3))
    shutil.rmtree(WORK / "adc", ignore_errors=True)
    return launches


def camera_on(camera, device):
    import dataclasses

    import torch
    return dataclasses.replace(camera, **{
        f.name: getattr(camera, f.name).to(device) for f in dataclasses.fields(camera)
        if torch.is_tensor(getattr(camera, f.name))})


def phase_mesh_tools(dev) -> None:
    """Cell fullrun-mesh-surface-800: ``tools/full_run.py --mesh --scene
    surface`` (the port's twin) at 600 iterations: 800x800, a 100k-triangle
    GT surface, the mesh recipe with its windows scaled by full_run, the
    GLB export, chamfer / F-score with 100k samples a side (tau 0.05) and
    the ray-traced test PSNR of the GLB. Gates: chamfer finite and below
    1.5, recall above 0.3 (the JAX e2e test's sanity bounds), the traced
    PSNR within MESH_TOOLS_TRACE_GAP_DB of the rasterized test PSNR; kNN on 2k points and the ray tracer on 400 of the GLB's
    triangles at 128x128 equal on the card and the CPU."""
    import numpy as np
    import torch
    from triangle_splatting_tpu_torch.models.raw_triangle import RawTriangle
    from triangle_splatting_tpu_torch.ops.knn import knn
    from triangle_splatting_tpu_torch.ops.projection import RasterSettings
    from triangle_splatting_tpu_torch.ops.raytrace import raytrace_soup
    from triangle_splatting_tpu_torch.ops.sh import SH2RGB
    from triangle_splatting_tpu_torch.tools import full_run

    t0 = time.perf_counter()
    args = full_run.parse_args(["--mesh", "--scene", "surface", "--root", str(WORK / "mesh_tools"),
                                "--iters", str(MESH_TOOLS_ITERS), "--ckpt_every", "0"])
    with counted_train():
        trainer, rec = full_run.run(args)
    geo = rec["geometry"]
    check(np.isfinite(geo["chamfer"]) and geo["chamfer"] < 1.5 and geo["recall"] > 0.3,
          f"mesh_tools: geometry {geo}")
    check(abs(rec["raytrace_psnr"] - rec["psnr_final"]) < MESH_TOOLS_TRACE_GAP_DB,
          f"mesh_tools: traced PSNR {rec['raytrace_psnr']}, rasterized {rec['psnr_final']}")
    check(float(trainer.state.gamma) == 50.0, f"mesh_tools: gamma {float(trainer.state.gamma)}")

    glb = WORK / "mesh_tools" / "out" / "glb" / f"{MESH_TOOLS_ITERS}.glb"
    raw = RawTriangle(glb_path=str(glb))
    gt = np.load(WORK / "mesh_tools" / "data_surface" / "gt_scene.npz")
    pts = gt["vertex"].reshape(-1, 3)[:2000]
    card, host = knn(pts, k=3, group_size=3, device=dev), knn(pts, k=3, group_size=3,
                                                             device="cpu")
    check(torch.equal(card[1].cpu(), host[1]) and torch.equal(card[0].cpu(), host[0]),
          "mesh_tools: kNN differs between the card and the CPU")
    cam = next(iter(trainer.dataset.getTestDataset()))
    small = RasterSettings(image_width=128, image_height=128)
    sl = slice(0, 400)
    cols = np.clip(SH2RGB(raw.shs[sl, :3]), 0, 1)
    outs = [raytrace_soup(torch.as_tensor(raw.vertex[sl]).to(d), torch.as_tensor(cols).to(d),
                          camera_on(cam, d), small, background=torch.ones(3))
            for d in (dev, torch.device("cpu"))]
    check(torch.equal(outs[0]["render"].cpu(), outs[1]["render"]) and
          torch.equal(outs[0]["hit"].cpu(), outs[1]["hit"]) and
          int(outs[1]["hit"].sum()) > 0,
          "mesh_tools: the ray tracer differs between the card and the CPU")
    say("mesh_tools", cell="fullrun-mesh-surface-800", cuts=MESH_TOOLS_CUTS, card=card_line(),
        **rec, ms_per_step=round(trainer.train_seconds / MESH_TOOLS_ITERS * 1e3, 3),
        prune=trainer.prune_history, launches=trainer.train_launches,
        card_vs_cpu=dict(knn_points=len(pts), raytrace_triangles=400, raytrace_size=128,
                         hit_pixels=int(outs[1]["hit"].sum()), equal=True),
        seconds=round(time.perf_counter() - t0, 3))
    shutil.rmtree(WORK / "mesh_tools", ignore_errors=True)


# ---------------------------------------------------------------------------
# The inference surface: the facades, the viewer, the render tours and the
# run_experiments dispatch
# ---------------------------------------------------------------------------

# what the training phases leave to the inference phases: the photo and gs
# models' PLYs, the mesh run's output directory, and each one's test
# cameras; the city and scaffold trainers while their data exist
KEEP: dict = {}
WHITE = (1.0, 1.0, 1.0)
# the B1 form each facade renders (the JAX cores' need_stats defaults, rich
# info on): one counted render each
FACADE_FORMS = {"photo": "blend_forward_rich_stats", "mesh": "blend_forward_3d_rich_stats",
                "gs": "blend_forward_gs_rich_stats", "scaffold": "blend_forward_gs_rich"}
VIEWER_MODES = ("color", "depth", "normal")
VIEWER_RES = (512, 1024)                 # the slider's default and its maximum
VIEWER_GAMMAS = (1.0, 50.0)
TOUR_SIZE = (2160, 1440)                 # render_utils' default frame
TOUR_FRAMES = (0, 100, 200)              # of the reference tour's 300 poses
# the entry phase's cut of config/NerfSynthetic_VanillaTS.yaml: 50 steps, a
# loss line every 10, the PLY at the end, no checkpoint, a profile window
ENTRY_CUTS = dict(iterations=50, log_interval_iter=10, save_iterations=[50],
                  checkpoint_iterations=[], profile_start_iter=20, profile_end_iter=30)


class KernelCapture:
    """While entered, records the arguments of the first B1 call of each
    form (keyed (variant, stats, rich)) and of the first B3 call, detached,
    through spies on ``ops.rasterize.blend_forward`` and
    ``ops.binning.relayout_pairs``."""

    def __enter__(self):
        import torch
        from triangle_splatting_tpu_torch.ops import binning as BN
        from triangle_splatting_tpu_torch.ops import rasterize as RZ
        self.mods, self.real = (RZ, BN), (RZ.blend_forward, BN.relayout_pairs)
        self.b1, self.b3 = {}, []

        def detached(x):
            return x.detach() if torch.is_tensor(x) else x

        def b1(*a, **kw):
            self.b1.setdefault((kw["variant"], kw["stats"], kw["rich"]), (
                tuple(detached(x) for x in a), {k: detached(v) for k, v in kw.items()}))
            return self.real[0](*a, **kw)

        def b3(*a):
            if not self.b3:
                self.b3.append(tuple(detached(x) for x in a))
            return self.real[1](*a)
        RZ.blend_forward, BN.relayout_pairs = b1, b3
        return self

    def __exit__(self, *exc):
        (RZ, BN), (f, r) = self.mods, self.real
        RZ.blend_forward, BN.relayout_pairs = f, r
        return False


def hold_b1(call, what: str) -> dict:
    """B1 in the form of a captured call against its plain version on the
    call's inputs: color and final_T within TOL["b1_abs"], n_contrib exact,
    with rich info depth and normal within TOL["rich_rel"] of their max, with
    statistics the stream's sums within TOL["stats_sum_rel"] and its maxes
    exact."""
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import blend as KB
    a, kw = call
    geo = {k: kw[k] for k in ("image_width", "image_height", "tile_h", "tile_w", "variant")}
    stats, rich = kw["stats"], kw["rich"]
    with torch.no_grad():
        out = KB.blend_forward(*a[:4], stats=stats, rich=rich, **geo)
        ref = KB.blend_forward_plain(*a[:4], stats=stats, rich=rich, **geo)
        torch.cuda.synchronize()
    err = dict(color=float((out[0] - ref[0]).abs().max()),
               final_T=float((out[3] - ref[3]).abs().max()),
               n_contrib=int((out[4] != ref[4]).sum()))
    ok = err["color"] <= TOL["b1_abs"] and err["final_T"] <= TOL["b1_abs"] \
        and err["n_contrib"] == 0
    if rich:
        for i, k in ((1, "depth"), (2, "normal")):
            err[k] = float((out[i] - ref[i]).abs().max()) / max(float(ref[i].abs().max()), 1e-30)
            ok = ok and err[k] <= TOL["rich_rel"]
    if stats:
        err["stream_sum"] = float((out[5][0] - ref[5][0]).abs().max()) / max(
            float(ref[5][0].abs().max()), 1e-30)
        err["stream_max"] = float((out[5][1] - ref[5][1]).abs().max())
        ok = ok and err["stream_sum"] <= TOL["stats_sum_rel"] and err["stream_max"] == 0.0
    check(ok, f"{what}: B1 {geo['variant']} stats={stats} rich={rich} vs plain: {err}")
    return err


def keep_model(name: str, trainer, ply: Path | None = None, **extra) -> None:
    """Leave a training phase's model for the inference phases: its PLY at
    ``ply`` (written here when given) and its test cameras."""
    if ply is not None:
        trainer.savePLY(str(ply))
    KEEP[name] = dict(cameras=list(trainer.dataset.getTestDataset()), ply=ply, **extra)


def pose_of(camera) -> dict:
    """The viewer's look-at pose of a camera: eye at its center, target one
    unit along its view axis, up against its image y axis."""
    W = camera.world_view.detach().double().cpu().numpy()
    eye = camera.camera_center.detach().double().cpu().numpy()
    return dict(eye=eye.tolist(), target=(eye + W[2, :3]).tolist(), up=(-W[1, :3]).tolist())


def phase_facades(dev) -> dict:
    """The model facades at full width: the photo and gs phases' models
    through ``savePLY`` / ``VanillaTSModel.loadPLY`` / ``VanillaGSModel.loadPLY``
    (SH 3), the mesh phase's ``glb/50.glb`` through ``loadGLB`` at gamma 50
    (its recipe's "3D", STE and render_up_scale 2), each on a test view at
    800x800, and the scaffold phase's trainer state through
    ``ScaffoldGSModel`` at 1297x840. One counted render each: B1's "2D" and
    "3D" rich + stats forms, "GS" rich + stats and "GS" rich once, B3 four
    times, B5 three times, nothing else. Color, final_T and n_contrib equal
    the plain form's (no rich info, no statistics) on the same arrays bit
    for bit; the new forms ("GS" rich + stats, "GS" rich) and B3 are held
    against their plain versions on the counted renders' inputs. Prints
    ms per render (end to end, host included). Returns the launches."""
    import dataclasses

    import torch
    from triangle_splatting_tpu_torch import ScaffoldGSModel, VanillaGSModel, VanillaTSModel
    from triangle_splatting_tpu_torch.models.facade import _mk_settings
    from triangle_splatting_tpu_torch.ops.cuda import reset_launches
    from triangle_splatting_tpu_torch.utils.config import dict_to_config, loadConfig

    scaffold = KEEP.pop("scaffold")
    models = dict(
        photo=VanillaTSModel(loadConfig(REPO / "config" / "NerfSynthetic_VanillaTS.yaml").model)
        .loadPLY(KEEP["photo"]["ply"]),
        mesh=VanillaTSModel(loadConfig(REPO / "config" / "NerfSynthetic_VanillaTS_mesh.yaml")
                            .model).loadGLB(KEEP["mesh"]["dir"] / "glb" / "50.glb").set_gamma(50.0),
        gs=VanillaGSModel(dict_to_config({"max_sh_degree": 3})).loadPLY(KEEP["gs"]["ply"]),
        scaffold=ScaffoldGSModel(scaffold["config"]))
    models["scaffold"].params = scaffold["trainer"].params
    models["scaffold"].state = scaffold["trainer"].state
    cams = dict(photo=KEEP["photo"]["cameras"][0], mesh=KEEP["mesh"]["cameras"][0],
                gs=KEEP["gs"]["cameras"][0], scaffold=scaffold["cameras"][0])
    with torch.no_grad(), KernelCapture() as cap:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = {n: m.forward(cams[n], WHITE) for n, m in models.items()}
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = read_launches()
    want = dict.fromkeys(FACADE_FORMS.values(), 1)
    want.update(relayout_pairs=4, segment_reduce_stats=3)
    for name, n in launches.items():
        check(n == want.get(name, 0), f"facades: kernel {name} launched {n} times, "
              f"expected {want.get(name, 0)}")
    for name, m in models.items():
        o, cam = outs[name], cams[name]
        check(not bool(o["overflow"]), f"facades {name}: pair budget overflow")
        check(tuple(o["render"].shape) == (3, cam.image_height, cam.image_width)
              and all(bool(torch.isfinite(o[k]).all()) for k in ("render", "depth", "normal")),
              f"facades {name}: outputs not finite or of the wrong shape")
        core = getattr(m, "_M", None) or getattr(m, "_G", None) or m._S
        extra = dict(apply_color_affine=False) if name in ("photo", "mesh") else {}
        settings = (_mk_settings(cam, m.cfg.max_sh_degree, m.cfg.rasterizer_type,
                                 m.cfg.back_culling) if name in ("photo", "mesh")
                    else _mk_settings(cam, getattr(m.cfg, "max_sh_degree", 0)))
        with torch.no_grad():
            plain = core.forward(m.params, m.state, cam, m._background(WHITE), m.cfg,
                                 dataclasses.replace(settings, rich_info=False),
                                 is_training=False, need_stats=False, **extra)
        differ = [k for k in ("render", "final_T", "n_contrib") if not torch.equal(o[k], plain[k])]
        check(not differ, f"facades {name}: {differ} differ from the plain form's")
        count = m.point_count if hasattr(m, "point_count") else m.anchor_count
        say("facades", model=name, form=FACADE_FORMS[name], size=list(o["render"].shape[1:]),
            primitives=count, num_pairs=int(o["num_pairs"]), overflow=bool(o["overflow"]),
            gamma=float(m.state.gamma) if hasattr(m.state, "gamma") else None,
            ms_per_render=round(cuda_ms(lambda: m.forward(cam, WHITE), 5, hide_host=False), 3),
            bit_identical_to_plain=["render", "final_T", "n_contrib"])
    holds = {f"{v} stats={s} rich={r}": hold_b1(cap.b1[(v, s, r)], f"facades {v}")
             for v, s, r in (("GS", True, True), ("GS", False, True))}
    _, _, err3 = hold_relayout(cap.b3[0], "facades")
    say("facades", counted_seconds=round(secs, 3), launches=launches, b1_vs_plain=holds,
        b3_mismatch=err3, tol=f"B1 color / final_T {TOL['b1_abs']} abs, n_contrib exact, "
        f"depth / normal rel {TOL['rich_rel']}, stream sums rel {TOL['stats_sum_rel']}, "
        "maxes exact; B3 exact")
    del models, outs, cap, scaffold
    return launches


def phase_viewer(dev) -> dict:
    """The viewer on the card: ``run_viewer(port=0, block=False)`` on the
    mesh phase's output directory ("3D", SH 0, its ``point_cloud/50.ply``)
    and on a directory holding the photo model's PLY ("2D", SH 3). For
    each: the three modes x resolutions 512 / 1024 x gamma 1 / 50, posed
    at a test camera, over HTTP. Gates: each JPEG decodes at the requested
    size, ``X-Info`` counts the PLY's triangles, the counted launches are
    B1's "2D" rich and "3D" rich forms and B3 once a request and nothing
    else (no B2, B4, B5 or statistics form); B1 "2D" rich and B3 held
    against their plain versions on the first request's inputs. Prints p50
    and max ms a request (end to end: HTTP, render, JPEG) per resolution,
    and the pairs and overflow of every request. Returns the launches."""
    import io
    import json
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image
    from triangle_splatting_tpu_torch.models.raw_triangle import RawTriangle
    from triangle_splatting_tpu_torch.ops.cuda import reset_launches
    from triangle_splatting_tpu_torch.viewer import run_viewer

    dirs = (("photo", KEEP["photo"]["ply"].parent.parent, "point_cloud/50.ply", 3, "2D"),
            ("mesh", KEEP["mesh"]["dir"], "point_cloud/50.ply", 0, "3D"))
    n_req = len(VIEWER_MODES) * len(VIEWER_RES) * len(VIEWER_GAMMAS)
    with KernelCapture() as cap:
        reset_launches()
        for name, root, model, sh, rtype in dirs:
            server = run_viewer(str(root), host="127.0.0.1", port=0, max_sh_degree=sh,
                                rasterizer_type=rtype, block=False)
            url = f"http://127.0.0.1:{server.server_address[1]}/render"
            try:
                n_tri = len(RawTriangle(ply_path=root / model))
                pose = pose_of(KEEP[name]["cameras"][0])
                ms, pairs, overflow = {r: [] for r in VIEWER_RES}, {r: [] for r in VIEWER_RES}, []
                for mode in VIEWER_MODES:
                    for res in VIEWER_RES:
                        for gamma in VIEWER_GAMMAS:
                            body = json.dumps(dict(pose=pose, mode=mode, bg="white", res=res,
                                                   gamma=gamma, sh=sh, model=model)).encode()
                            t0 = time.perf_counter()
                            with urllib.request.urlopen(urllib.request.Request(
                                    url, data=body, method="POST"), timeout=120) as r:
                                data, hdr = r.read(), r.headers
                            ms[res].append((time.perf_counter() - t0) * 1e3)
                            img = np.asarray(Image.open(io.BytesIO(data)))
                            check(img.shape == (res, res, 3) and img.std() > 1,
                                  f"viewer {name} {mode} {res} gamma {gamma}: frame {img.shape}")
                            check(hdr["X-Info"] == f"{n_tri} tris @ {res}px",
                                  f"viewer {name}: X-Info {hdr['X-Info']!r}, {n_tri} in the PLY")
                            pairs[res].append(int(hdr["X-Num-Pairs"]))
                            if hdr["X-Overflow"] == "1":
                                overflow.append(f"{mode} {res} gamma {gamma}")
                say("viewer", dir=name, variant=rtype, model=model, triangles=n_tri,
                    requests=n_req, ms_p50={r: round(statistics.median(v), 3) for r, v in ms.items()},
                    ms_max={r: round(max(v), 3) for r, v in ms.items()},
                    num_pairs=pairs, overflow=overflow or None)
            finally:
                server.shutdown()
                server.server_close()
    launches = read_launches()
    want = dict(blend_forward_rich=n_req, blend_forward_3d_rich=n_req, relayout_pairs=2 * n_req)
    for name, n in launches.items():
        check(n == want.get(name, 0), f"viewer: kernel {name} launched {n} times, "
              f"expected {want.get(name, 0)}")
    err1 = hold_b1(cap.b1[("2D", False, True)], "viewer")
    _, _, err3 = hold_relayout(cap.b3[0], "viewer")
    say("viewer", launches=launches, b1_2d_rich_vs_plain=err1, b3_mismatch=err3)
    del cap
    return launches


def at_size(cam, size):
    """``cam`` rendered at ``size`` (width, height): the same pose and
    vertical field of view, the horizontal one following the new aspect
    (row 0 of ``full_proj`` is the projection's x scale times the view's
    row 0)."""
    import dataclasses
    w, h = size
    tan_x = cam.tan_fovy * (w / h)
    proj = cam.full_proj.clone()
    proj[0] *= cam.tan_fovx / tan_x
    return dataclasses.replace(cam, full_proj=proj, tan_fovx=tan_x, image_width=w,
                               image_height=h, gt_image=None, alpha_mask=None)


def phase_render_utils(dev) -> dict:
    """``utils/render_utils.py`` on the city trainer's model (~992k
    triangles, "3D"): ``make_render_fn`` on the city's test views at
    1600x900 (B1-3D rich + stats; its PSNR the trainer's own on those
    views within 1e-3 dB) and on the same views at the tour's 2160x1440
    (``at_size``: the vertical field of view kept), whose time is the
    tour-size frame time; one ``render_BEV_image`` and the tour's frames
    0 / 100 / 200 at 2160x1440 as a check of the API only: the BEV and
    tour poses are MatrixCity's metric ones (1200 above the center, an
    800 x 400 orbit), so on the synthetic city (a few units wide) those
    frames are degenerate, the city a few pixels wide: the phase prints
    each frame's pairs and covered share. ``render_tour`` writes a 4-frame
    video where cv2 imports (printed). Returns the launches of the counted
    renders."""
    import numpy as np
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import reset_launches
    from triangle_splatting_tpu_torch.trainers import losses as L
    from triangle_splatting_tpu_torch.utils import render_utils as RU

    city = KEEP.pop("city")
    trainer, cams = city["trainer"], city["cameras"]
    black = torch.zeros(3, device=dev)
    rf = RU.make_render_fn(trainer.params, trainer.state, trainer.model_cfg, device=dev)
    reset_launches()
    views = []
    for cam in cams:
        o = rf(cam)
        check(not bool(o["overflow"]) and bool(torch.isfinite(o["render"]).all()),
              "render_utils: a test view overflowed or is not finite")
        psnr = float(L.psnr(o["render"], cam.gt_image))
        views.append(dict(size=list(o["render"].shape[1:]), psnr=psnr,
                          num_pairs=int(o["num_pairs"])))
    big = [at_size(cam, TOUR_SIZE) for cam in cams]
    frames = {f"test view {i}": cam for i, cam in enumerate(big)}
    frames["bev"] = RU.bev_camera(rf, TOUR_SIZE)
    tour = RU.tour_cameras(rf, TOUR_SIZE, 300)
    frames.update({f"tour {i}": tour[i] for i in TOUR_FRAMES})
    shots = {}
    for name, cam in frames.items():
        o = rf(cam)
        check(tuple(o["render"].shape) == (3, TOUR_SIZE[1], TOUR_SIZE[0])
              and bool(torch.isfinite(o["render"]).all()), f"render_utils {name}: bad frame")
        shots[name] = dict(num_pairs=int(o["num_pairs"]), overflow=bool(o["overflow"]),
                           covered=float((1.0 - o["final_T"]).gt(1e-3).float().mean()))
    bev = RU.render_BEV_image(rf, img_size=TOUR_SIZE)
    check(isinstance(bev, np.ndarray) and bev.shape == (3, TOUR_SIZE[1], TOUR_SIZE[0]),
          "render_utils: render_BEV_image")
    launches = read_launches()
    n = len(cams) + len(frames) + 1
    form = {"2D": "blend_forward_rich_stats", "3D": "blend_forward_3d_rich_stats"}[
        trainer.model_cfg.rasterizer_type]
    for name, k in launches.items():
        want = n if name in (form, "relayout_pairs", "segment_reduce_stats") else 0
        check(k == want, f"render_utils: kernel {name} launched {k} times, expected {want}")
    want = trainer.psnr_views(cams, black, use_mask=False)
    check(all(abs(v["psnr"] - w) <= 1e-3 for v, w in zip(views, want)),
          f"render_utils: PSNR {[v['psnr'] for v in views]} against the trainer's {want}")
    timing = dict(view_ms=round(cuda_ms(lambda: rf(cams[0]), 3, hide_host=False), 3),
                  tour_size_view_ms=round(cuda_ms(lambda: rf(big[0]), 3, hide_host=False), 3),
                  degenerate_tour_frame_ms=round(cuda_ms(lambda: rf(tour[TOUR_FRAMES[1]]), 3,
                                                         hide_host=False), 3))
    try:
        import cv2  # noqa: F401
        path = WORK / "tour" / "tour.mp4"
        RU.render_tour(rf, str(path), img_size=TOUR_SIZE, fps=2, duration=2)
        written = [p.name for p in path.parent.iterdir() if p.stat().st_size > 0]
        check(bool(written), "render_utils: render_tour wrote no video")
        video = f"written: {written}"
    except ImportError:
        video = "cv2 does not import here: no video written"
    say("render_utils", triangles=int(trainer.state.alive.sum()), views=views, frames=shots,
        video=video, launches=launches, **timing)
    del trainer, city, rf
    return launches


def phase_entry(soup: Path) -> dict:
    """``python -m triangle_splatting_tpu_torch.run_experiments --type
    NerfSynthetic --dataset_path <soup's parent> --scenes <soup>`` as a
    subprocess, from a working directory whose
    ``config/NerfSynthetic_VanillaTS.yaml`` is the shipped one with the cuts
    of ENTRY_CUTS (50 steps, a profile window at 20-30). Gates: exit 0; the
    logged loss falls; the timer's breakdown closes the log; the profile
    trace lies under ``profile/``; TensorBoard events are written where
    ``torch.utils.tensorboard`` imports (printed). A fresh process answers
    that, so TensorFlow never loads into this one, after
    ``pipeline_utils.visible_gpu_count`` (the fan-out's probe before it
    spawns workers) has seen the card there and left CUDA uninitialised."""
    import os

    import yaml

    work = WORK / "entry"
    shutil.rmtree(work, ignore_errors=True)
    (work / "config").mkdir(parents=True)
    cfg = yaml.safe_load((REPO / "config" / "NerfSynthetic_VanillaTS.yaml").read_text())
    cfg["trainer"].update(ENTRY_CUTS)
    (work / "config" / "NerfSynthetic_VanillaTS.yaml").write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "triangle_splatting_tpu_torch.run_experiments", "--type",
         "NerfSynthetic", "--dataset_path", str(soup.parent), "--scenes", soup.name],
        cwd=work, env=env, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"entry: exit {proc.returncode}: {proc.stderr[-3000:]}")
    out = work / cfg["trainer"]["output_dir"] / soup.name
    events = [json.loads(ln) for ln in (out / "log" / "events.jsonl").read_text().splitlines()]
    losses = [e["value"] for e in events if e["tag"] == "Loss"]
    check(len(losses) == 5 and all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"entry: losses {losses}")
    log = next((out / "log").glob("*_outputs.log")).read_text()
    check("[Training] total" in log, "entry: no timer breakdown in the log")
    timer = log[log.index("[Training] total"):].splitlines()
    timer = [timer[0]] + [ln for ln in timer[1:] if ln.startswith("  ")]
    trace = out / "profile" / "trace_20_30.json"
    check(trace.exists() and trace.stat().st_size > 0, "entry: no profile trace")
    # the GPU count, then whether torch.utils.tensorboard imports, asked in
    # a process of its own: TensorBoard may pull in TensorFlow, which stays
    # out of this measuring process
    probe = subprocess.run(
        [sys.executable, "-c", "import torch; from triangle_splatting_tpu_torch.utils."
         "pipeline_utils import visible_gpu_count as n; print(n(), torch.cuda.is_initialized())\n"
         "try:\n import torch.utils.tensorboard\n print(True)\n"
         "except Exception:\n print(False)"],
        cwd=work, env=env, capture_output=True, text=True, timeout=300)
    check(probe.returncode == 0 and probe.stdout.split()[:2] == ["1", "False"],
          f"entry: the GPU count probe printed {probe.stdout!r} {probe.stderr[-500:]}")
    has_tb = probe.stdout.split()[2] == "True"
    tb = sorted(p.name for p in (out / "tb").glob("events.out.tfevents.*")) \
        if (out / "tb").exists() else []
    check(bool(tb) == has_tb, f"entry: tensorboard imports: {has_tb}, events {tb}")
    say("entry", seconds=round(secs, 3), exit=proc.returncode, cuts=ENTRY_CUTS, losses=losses,
        gpu_probe=" ".join(probe.stdout.split()[:2]),
        timer=[ln.strip() for ln in timer], trace_bytes=trace.stat().st_size,
        tensorboard=f"events written ({len(tb)})" if tb else "torch.utils.tensorboard does "
        "not import here: no events", ply=(out / "point_cloud" / "50.ply").exists())
    shutil.rmtree(work, ignore_errors=True)
    return dict(seconds=secs)


def main(argv=None) -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blend-parent", type=Path, action="append", default=[], metavar="DIR",
                    help="a directory with an earlier blend.cu and blend_gs.cu: time their "
                         "B1 and B2 in turns with the current ones (tools/blend_compare.py); "
                         "repeatable, the first is the parent")
    ap.add_argument("--probes-parent", type=Path, default=None, metavar="DIR",
                    help="a directory with an earlier probes.cu whose ts_probe_scan takes "
                         "the current parameters: the probes phase holds each P3 variant "
                         "of it against the current one bit for bit at the tool's K and "
                         "times the two in turns")
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
        scan_parent = parent_scan(args.probes_parent) if args.probes_parent else None
        bench = make_bench(dev)
        rec = phase_kernels(bench, cmp)
        rec.update(phase_kernels_3d(dev, cmp))
        rec.update(phase_kernels_gs(dev, cmp))
        phase_reference(dev)
        phase_rasterize(bench)
        runs = dict(renderer=phase_renderer(bench))
        runs["probes"], probe_rec = phase_probes(dev, scan_parent)
        rec.update(probe_rec)
        shutil.rmtree(WORK, ignore_errors=True)
        soup = build_dataset(dev, "soup")
        runs["train"] = phase_train(dev, soup)
        runs["gs"] = phase_gs(dev, soup)
        runs["entry"] = phase_entry(soup)
        shutil.rmtree(soup, ignore_errors=True)
        surface = build_dataset(dev, "surface")
        runs["mesh"] = phase_mesh_train(dev, surface)
        runs["mesh_adc"] = phase_mesh_adc(dev, surface)
        shutil.rmtree(surface, ignore_errors=True)
        runs["city"], city_rec = phase_city(dev, build_city(dev), cmp)
        rec.update(city_rec)
        runs["render_utils"] = phase_render_utils(dev)
        shutil.rmtree(WORK / "matrix_city", ignore_errors=True)
        colmap = build_colmap(dev)
        runs["scaffold"] = phase_scaffold(dev, colmap)
        shutil.rmtree(colmap, ignore_errors=True)
        runs["facades"] = phase_facades(dev)
        runs["viewer"] = phase_viewer(dev)
        KEEP.clear()
        runs["smoke"] = phase_smoke(dev)
        phase_resume()                      # on the smoke photo run's dataset
        runs["loss_terms"] = phase_loss_terms(dev)      # on that dataset too
        for name, _ in SMOKE_RUNS:
            shutil.rmtree(WORK / f"smoke_{name}", ignore_errors=True)
        runs["adc"] = phase_adc(dev)
        phase_mesh_tools(dev)
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
