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
             by the logged counts; then profile 10 more steps.
The photo and mesh phases also check that neither launched B5 or a stats
form of B1.

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
# B1's stats form adds a sum and a max of each evaluated contribution over
# the tile's pixels; B5 an add and a max per sorted pair.
STATS_OPS_PER_EVAL = 2
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
           stats_max_rel=1e-6, b5_rel=1e-5, oracle_stats_abs=5e-4)
_BLEND = "triangle_splatting_tpu/ops/pallas/blend.py"
_STREAMS = "triangle_splatting_tpu/ops/pallas/streams.py"
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
}
_CSRC = "triangle_splatting_tpu_torch/ops/cuda/csrc"
SOURCES = {name: f"{_CSRC}/{'streams' if _STREAMS in r else 'blend'}.cu"
           for name, r in REPLACES.items()}
# the training phase whose run each kernel's launches are read from: the
# path that runs it (the 2D stats form is on none of them: no shipped
# photo recipe has a statistic block, so its count is the photo run's 0)
PATH_OF = dict.fromkeys(REPLACES, "train")
PATH_OF.update(blend_forward_3d="mesh", blend_backward_3d="mesh",
               blend_forward_3d_stats="mesh_adc", segment_reduce_stats="mesh_adc")


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


def bound_ms(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def check_no_stats_launches(launches: dict, phase: str) -> None:
    """A path without a statistic block launches neither B5 nor a stats
    form of B1."""
    for name in ("segment_reduce_stats", "blend_forward_stats", "blend_forward_3d_stats"):
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
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import streams as KS

    args = (sp.sorted_tri, sp.raw_starts, sp.astarts, sp.tile_counts, sp.ma)
    out = KS.relayout_pairs(*args)
    ref = KS.relayout_pairs_plain(*args)
    torch.cuda.synchronize()
    err = int((out != ref).sum())
    check(err == 0, f"relayout_pairs {what}: disagrees with its plain version in {err} slots")
    return out, args, err


def check_segment_reduce(grads, pair_tri, sp, what: str) -> dict:
    """B4 against its plain version on the pack backward's inputs: the live
    per-pair gradient rows ``grads`` sorted by owning triangle (empty slots
    last), one segment per triangle; rel 1e-5 of the max. Returns the
    errors, the argument tuple and the sorted owner keys."""
    import torch
    from triangle_splatting_tpu_torch.ops.cuda import streams as KS

    P = sp.tri_offsets.shape[0] - 1
    key = torch.where(pair_tri >= 0, pair_tri, torch.full_like(pair_tri, P))
    skey, order = torch.sort(key, stable=True)
    cols = grads.index_select(1, order).contiguous()
    starts = torch.minimum(sp.tri_offsets[:-1], sp.num_pairs).contiguous()
    ends = torch.minimum(sp.tri_offsets[1:], sp.num_pairs).contiguous()
    args = (cols, starts, ends, sp.num_pairs)
    out = KS.segment_reduce_pairs(*args)
    ref = KS.segment_reduce_pairs_plain(*args)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-30)
    check(rel <= TOL["b4_rel"], f"segment_reduce_pairs {what}: rel err {rel:.3e} > {TOL['b4_rel']}")
    return dict(args=args, skey=skey, ref=ref, err=err, rel=rel)


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
    return dict(fwd=fwd, bw=bw, out2=out2, b1_err=max(e_color, e_T), n_contrib_mismatch=e_nc,
                b2_err=float(diff2.max()), b2_rel=rel2,
                evals=float(out1[4].to(torch.float64).sum()),
                b1_bytes=pairs_in + 4 * 9 * H * W,
                b2_bytes=pairs_in + 4 * 6 * H * W + 4 * 16 * sp.ma,
                pair_contrib=pc, stats_err=max(e_sum, e_max), stats_rel_sum=rel_sum,
                stats_rel_max=rel_max, stats_bytes=pairs_in + 4 * 9 * H * W + 4 * 2 * sp.ma,
                b1_tol=f"abs {TOL['b1_abs']} (color, final_T); n_contrib exact",
                b2_tol=f"rel {TOL['b2_rel']} of each row's max",
                stats_tol=(f"blend outputs bit-identical to stats off; stream rel "
                           f"{TOL['stats_sum_rel']} (sum) / {TOL['stats_max_rel']} (max) "
                           "of each row's max"))


def phase_kernels(b) -> dict:
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
            ms=cuda_ms(lambda: KB.blend_forward(*c["fwd"], **geo), 20),
            plain_ms=cuda_ms(lambda: KB.blend_forward_plain(*c["fwd"], **geo), 3, 1),
            library_ms=None,
            bound=bound_ms(c["b1_bytes"], FWD_OPS_PER_EVAL * c["evals"]),
            tol=c["b1_tol"])
        rec["blend_backward"] = dict(
            max_abs_err=c["b2_err"],
            ms=cuda_ms(lambda: KB.blend_backward(*c["bw"], **geo), 20),
            plain_ms=cuda_ms(lambda: KB.blend_backward_plain(*c["bw"], **geo), 3, 1),
            library_ms=None,
            bound=bound_ms(c["b2_bytes"], BWD_OPS_PER_EVAL * c["evals"]),
            tol=c["b2_tol"])
        rec["blend_forward_stats"] = dict(
            max_abs_err=c["stats_err"],
            ms=cuda_ms(lambda: KB.blend_forward(*c["fwd"], stats=True, **geo), 20),
            plain_ms=cuda_ms(lambda: KB.blend_forward_plain(*c["fwd"], stats=True, **geo), 3, 1),
            library_ms=None,
            bound=bound_ms(c["stats_bytes"],
                           (FWD_OPS_PER_EVAL + STATS_OPS_PER_EVAL) * c["evals"]),
            tol=c["stats_tol"])
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


def phase_kernels_3d(dev) -> dict:
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
        ms1 = cuda_ms(lambda: KB.blend_forward(*c["fwd"], **geo), 20)
        ms1s = cuda_ms(lambda: KB.blend_forward(*c["fwd"], stats=True, **geo), 20)
        ms2 = cuda_ms(lambda: KB.blend_backward(*c["bw"], **geo), 20)
        ms5 = cuda_ms(lambda: KS.segment_reduce_stats(*c5["args"]), 50)
        g1 = gamma == 1.0
        bound1 = bound_ms(c["b1_bytes"], FWD_OPS_PER_EVAL_3D[g1] * c["evals"])
        bound1s = bound_ms(c["stats_bytes"],
                           (FWD_OPS_PER_EVAL_3D[g1] + STATS_OPS_PER_EVAL) * c["evals"])
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


def phase_reference(dev) -> None:
    """The 2D and the 3D kernel pipelines vs their dense oracles on a small
    scene (64x64), with the contribution statistics (B1's stream, owner
    sort, B5); the 3D one at gamma 1 and 50."""
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
        say("reference", variant=variant, gamma=gamma, render_max_abs_err=d,
            n_contrib_mismatch=nc, contrib_sum_max_abs_err=ds["contrib_sum"],
            contrib_max_max_abs_err=ds["contrib_max"],
            tol=f"render 6e-4 abs, statistics {TOL['oracle_stats_abs']} abs")


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
    check(int(trainer.state.active_sh_degree) == 3, "train: SH degree did not reach 3")
    say("train", ms_per_step=round(secs / TRAIN_ITERS * 1e3, 3), steps=TRAIN_ITERS,
        peak_mem_gib=round(peak / 2**30, 3),
        triangles=int(trainer.state.alive.sum()), loss_first10=first,
        loss_last10=last, psnr_train_before=psnr0, psnr_train_after=psnr1,
        launches=launches, pairs_per_triangle=trainer._ppt)
    profile_steps(trainer)
    return launches


def profile_steps(trainer, phase: str = "profile", steps: int = 10) -> None:
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

    bg = torch.ones(3, device=trainer.device)        # train_background "white"
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
    more than 50 steps of training win back, and the loss rises."""
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
    saves = (t.save_iterations or []) + (t.checkpoint_iterations or []) + (t.save_glb_iterations or [])
    check(all(it > TRAIN_ITERS for it in saves), "mesh: a save iteration lies inside the run")

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
    say("mesh", ms_per_step=round(secs / TRAIN_ITERS * 1e3, 3), steps=TRAIN_ITERS,
        render_size=MESH_RES, peak_mem_gib=round(peak / 2**30, 3),
        triangles=int(trainer.state.alive.sum()), ste_triangles=trainer.triangle_count(),
        gamma_final=gamma, loss_first10=first, loss_last10=last,
        psnr_train_before=psnr0, psnr_train_after=psnr1, launches=launches,
        pairs_per_triangle=trainer._ppt)
    profile_steps(trainer, "mesh_profile")
    return launches


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


def main() -> int:
    import torch
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
        bench = make_bench(dev)
        rec = phase_kernels(bench)
        rec.update(phase_kernels_3d(dev))
        phase_reference(dev)
        phase_rasterize(bench)
        shutil.rmtree(WORK, ignore_errors=True)
        runs = dict(train=phase_train(dev, build_dataset(dev, "soup")))
        surface = build_dataset(dev, "surface")
        runs["mesh"] = phase_mesh_train(dev, surface)
        runs["mesh_adc"] = phase_mesh_adc(dev, surface)
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
