"""B2 (``blend_backward``) against an earlier build of its kernels, on the card.

    python3 chip_smoke.py --b2-parent DIR [--b2-ablate]

DIR holds an earlier ``blend.cu`` and ``blend_gs.cu``, with the headers
they include (``git archive <rev> triangle_splatting_tpu_torch/ops/cuda/csrc``
unpacked, then DIR its ``csrc``). Their B2 entry points must take the
current ones' parameters, with or without the tile order: ``Comparison``
reads each one's parameter list from the source and refuses any other.
chip_smoke.py then times, at every shape where it times B2, the parent's
kernel and the current wrapper in turns (parent, current, current, parent)
on the same inputs, and holds the parent's output against the current
one's. The turns also time the current kernel with the tiles in block
order (``block_order``), not heaviest first as the wrapper sorts them.

``--b2-ablate`` adds two ablations of the parent. They are edits of the
B2 of commit 347405a (before the redesign) and refuse any other source:

- ``notrees``: each per-row warp-shuffle sum replaced by the lane's own
  value. Its sums are wrong: it times the kernel without its trees;
- ``skip``: the gradient chain and the trees run only where some processed
  lane of the warp has alpha != 0. Exact: the other entries change nothing.

``Comparison`` also reads, for every B2 kernel of each build and of the
current sources, ptxas's registers, spills and shared memory and the
static counts of its SASS opcodes (SHFL, FFMA, FMUL, FADD, MUFU, ...).
Needs ``nvcc`` and ``cuobjdump``; nothing here runs at import time.
"""

from __future__ import annotations

import collections
import ctypes
import re
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..ops.cuda.blend import BACKWARD_KERNELS
from ..ops.cuda.build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc

ENTRY = {"blend": "ts_blend_backward", "blend_gs": "ts_blend_backward_gs"}
# ablation -> (regex, replacement), each to match exactly once in each source
ABLATIONS = {
    "notrees": (r"warp_sum\(g\[k\]\)", "(g[k])"),
    "skip": (r"if \(b0 \+ j < nc_eff\) \{\n(\s*)(const \w+ a = [^\n]*;)",
             "const bool proc_ = b0 + j < nc_eff;\n\\1\\2\n"
             "\\1if (__any_sync(0xffffffffu, proc_ && a.alpha != 0.0f) && proc_) {"),
}
OPCODES = ("SHFL", "FFMA", "FMUL", "FADD", "MUFU", "FSEL", "FMNMX", "FSETP", "LDS", "STS",
           "BAR", "LDG", "STG", "BRA")


def c_params(text: str, fn: str) -> list[tuple[str, str]]:
    """(type, name) of each parameter of ``extern "C" int fn(...)`` in a
    CUDA source."""
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    if m is None:
        raise RuntimeError(f"no entry point {fn} in the source")
    out = []
    for p in m.group(1).split(","):
        words = p.replace("*", " * ").split()
        out.append((" ".join(words[:-1]), words[-1]))
    return out


def takes_order(text: str, source: str) -> bool:
    """Whether the B2 entry point in ``text``, an earlier version of
    ``csrc/<source>.cu``, takes the tile order: its parameters must be the
    current ones, or those without ``tile_order``, else this raises."""
    fn = ENTRY[source]
    cur = [n for _, n in c_params((CSRC / f"{source}.cu").read_text(), fn)]
    names = [n for _, n in c_params(text, fn)]
    if names == cur:
        return True
    if names == [n for n in cur if n != "tile_order"]:
        return False
    raise RuntimeError(f"the parent's {fn} takes ({', '.join(names)}): neither the current "
                       "parameters nor those without tile_order")


def ablated(text: str, name: str) -> str:
    """The ablation ``name`` of a parent source; raises unless its pattern
    matches exactly once, as in the B2 of commit 347405a."""
    pat, rep = ABLATIONS[name]
    new, n = re.subn(pat, rep, text)
    if n != 1:
        raise RuntimeError(f"ablation {name}: {n} matches, expected 1 (the ablations are "
                           "edits of the B2 of commit 347405a)")
    return new


def _compile(src: Path, so: Path, include: Path) -> str:
    out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(include), "-o", str(so), str(src)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc {src.name} failed:\n{out.stdout}{out.stderr}")
    return out.stdout + out.stderr


def _sass_report(src: Path, cubin: Path) -> dict:
    """form -> ptxas line and opcode counts of the form's B2 kernel."""
    from ..ops.cuda.compare_sass import compile_sass
    sass, usage = compile_sass(src, cubin)
    rep = {}
    for form, kernel in BACKWARD_KERNELS.items():
        if kernel not in sass:
            continue
        ops = collections.Counter(
            next(t for t in insn.split() if not t.startswith("@")).split(".")[0]
            for insn in sass[kernel])
        rep[form] = dict(ptxas=usage.get(kernel), instructions=len(sass[kernel]),
                         **{k: ops.get(k, 0) for k in OPCODES})
    return rep


class Comparison:
    """The parent's B2 (and with ``ablate`` its ablations), built from the
    sources in ``parent_dir``, to time against the current one."""

    def __init__(self, parent_dir, ablate: bool = False):
        parent_dir = Path(parent_dir).resolve()
        work = BUILD_DIR / "b2_compare"
        work.mkdir(parents=True, exist_ok=True)
        texts = {s: (parent_dir / f"{s}.cu").read_text() for s in ENTRY}
        self.takes_order = {s: takes_order(texts[s], s) for s in ENTRY}
        argtypes = {s: [ctypes.c_void_p if "*" in t or t == "cudaStream_t" else ctypes.c_int
                        for t, _ in c_params(texts[s], fn)] for s, fn in ENTRY.items()}
        # each build's sources; the ablations' are written to the work
        # directory and find the parent's headers through -I
        srcs = {"parent": {s: parent_dir / f"{s}.cu" for s in ENTRY}}
        for name in (ABLATIONS if ablate else ()):
            srcs[name] = {}
            for s, text in texts.items():
                srcs[name][s] = work / f"{name}_{s}.cu"
                srcs[name][s].write_text(ablated(text, name))
        jobs = {(b, s): p for b, by_src in srcs.items() for s, p in by_src.items()}
        so = {k: work / f"{k[0]}_{k[1]}.so" for k in jobs}
        with ThreadPoolExecutor(max_workers=2 * len(jobs) + 2) as ex:
            built = {k: ex.submit(_compile, p, so[k], parent_dir) for k, p in jobs.items()}
            sass = {k: ex.submit(_sass_report, p, so[k].with_suffix(".cubin"))
                    for k, p in jobs.items() if k[0] == "parent"}
            sass.update({("current", s): ex.submit(_sass_report, CSRC / f"{s}.cu",
                                                   work / f"current_{s}.cubin")
                         for s in ENTRY})
            self.sass = collections.defaultdict(dict)
            for (b, _), fut in sass.items():
                self.sass[b].update(fut.result())
            # build -> source name -> its B2 entry point, typed
            self.entry = collections.defaultdict(dict)
            for (b, s), fut in built.items():
                fut.result()
                fn = getattr(ctypes.CDLL(str(so[(b, s)])), ENTRY[s])
                fn.argtypes, fn.restype = argtypes[s], ctypes.c_int
                self.entry[b][s] = fn
        self.builds = list(srcs)

    @staticmethod
    def _launcher(entry: dict, takes_order: dict, bw, geo, rich: bool, out, order):
        """A launch of one build's B2 (``entry``: source name -> entry
        point) on the wrapper's inputs ``bw``, writing ``out``, as a
        function of no arguments; ``order`` is the tile order for an entry
        point that takes one."""
        import torch

        from ..ops.cuda.blend import _grid
        from ..ops.cuda.build import check_launch
        from ..ops.cuda.streams import _stream
        pairs, starts, counts, prm, fT, nc, g_color, g_T = bw[:8]
        H, W = geo["image_height"], geo["image_width"]
        grid_w, grid_h = _grid(W, H, geo["tile_h"], geo["tile_w"])
        extra = [bw[k] if len(bw) > k and bw[k] is not None else None for k in (8, 9)]
        if rich:
            extra = [e if e is not None else torch.zeros(s, device=pairs.device)
                     for e, s in zip(extra, ((H, W), (3, H, W)))]
        g_depth, g_normal = (e.data_ptr() if rich else None for e in extra)
        s = "blend_gs" if geo["variant"] == "GS" else "blend"
        head = (pairs.data_ptr(), pairs.shape[1], starts.data_ptr(), counts.data_ptr(),
                *((order.data_ptr(),) if takes_order[s] else ()),
                prm.data_ptr(), W, H, geo["tile_w"], geo["tile_h"], grid_w, grid_w * grid_h)
        mid = (fT.data_ptr(), nc.data_ptr(), g_color.data_ptr(), g_T.data_ptr())
        if s == "blend_gs":
            args = (*head, int(rich), *mid, g_depth, out.data_ptr())
        else:
            args = (*head, int(geo["variant"] == "3D"), int(rich), *mid, g_depth, g_normal,
                    out.data_ptr())
        fn = entry[s]

        def launch():
            check_launch(fn(*args, _stream()), "blend_backward (compared build)")
            return out, extra, order   # keeps the cotangents and the order alive
        return launch

    def turns(self, bw, geo, rich: bool, time_ms, reps: int = 10) -> dict:
        """Time the parent (and its ablations) and the current kernel in
        block order against the current wrapper on the same inputs, in
        turns: parent, the others, current, current, the others reversed,
        parent. ``time_ms(fn, reps)`` is the caller's timer (median ms).
        Returns per build the mean of its two medians and both, and each
        exact build's largest difference from the current output, relative
        to each live row's max."""
        import torch

        from ..ops.cuda import blend as KB
        from ..ops.cuda.build import library
        live = KB.LIVE_GRAD_ROWS[(geo["variant"], rich)]
        counts = bw[2]
        cur = KB.blend_backward(*bw, rich=rich, **geo)
        order = KB.tile_order(counts)
        outs = {n: torch.empty_like(bw[0]) for n in [*self.builds, "block_order"]}
        fns = {n: self._launcher(self.entry[n], self.takes_order, bw, geo, rich, outs[n],
                                 order) for n in self.builds}
        own = {s: getattr(library(s), fn) for s, fn in ENTRY.items()}
        fns["block_order"] = self._launcher(
            own, dict.fromkeys(ENTRY, True), bw, geo, rich, outs["block_order"],
            torch.arange(counts.shape[0], device=counts.device))
        fns["current"] = lambda: KB.blend_backward(*bw, rich=rich, **geo)
        rest = [n for n in fns if n not in ("parent", "current")]
        times = collections.defaultdict(list)
        for n in ["parent", *rest, "current", "current", *reversed(rest), "parent"]:
            times[n].append(time_ms(fns[n], reps))
        torch.cuda.synchronize()
        scale = cur[:live].abs().amax(dim=1).clamp_min(1e-30)
        rel = {n: float(((outs[n][:live] - cur[:live]).abs().amax(dim=1) / scale).max())
               for n in outs if n != "notrees"}
        return dict(form=geo["variant"] + ("_rich" if rich else ""),
                    tiles=int(counts.shape[0]),
                    ms={n: statistics.mean(t) for n, t in times.items()},
                    turns=dict(times), rel_vs_current=rel)
