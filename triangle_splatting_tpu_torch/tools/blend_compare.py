"""B1 (``blend_forward``) and B2 (``blend_backward``) against earlier builds
of their kernels, on the card.

    python3 chip_smoke.py --blend-parent DIR [--blend-parent DIR ...]

Each DIR holds an earlier ``blend.cu`` and ``blend_gs.cu``, with the headers
they include (``git archive <rev> triangle_splatting_tpu_torch/ops/cuda/csrc``
unpacked, then DIR its ``csrc``). A build is named after its DIR's last
component; the first one given is the parent. Their B1 and B2 entry points
must take the current ones' parameters, with or without the tile order
after ``tile_counts``: ``Comparison`` reads each one's parameter list from
the source and refuses any other. chip_smoke.py then times, at every site
where it times B1 or B2, each build and the current wrapper in turns (the
parent, the other builds, current, current, the other builds reversed, the
parent), each a median of 10 on the same inputs, and holds each build's
outputs against the current ones'. Every build that takes a tile order,
and the current wrapper, gets the same one, heaviest first, computed once
as ``rasterize`` computes it once a step: no column times its argsort.
The turns also time the current kernel with the tiles in block order
(``block_order``).

``Comparison`` also reads, for every B1 and B2 kernel of each build and of
the current sources, ptxas's registers, spills and shared memory and the
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

from ..ops.cuda.blend import BACKWARD_KERNELS, FORWARD_KERNELS
from ..ops.cuda.build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc

SOURCES = ("blend", "blend_gs")
# kernel -> source name -> its C entry point
ENTRY = {"b1": {"blend": "ts_blend_forward", "blend_gs": "ts_blend_forward_gs"},
         "b2": {"blend": "ts_blend_backward", "blend_gs": "ts_blend_backward_gs"}}
OPCODES = ("SHFL", "VOTE", "FFMA", "FMUL", "FADD", "MUFU", "FSEL", "FMNMX", "FSETP", "LDS",
           "STS", "LDGSTS", "BAR", "LDG", "STG", "BRA")


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


def takes_order(text: str, source: str, kernel: str) -> bool:
    """Whether the ``kernel`` ("b1" or "b2") entry point in ``text``, an
    earlier version of ``csrc/<source>.cu``, takes the tile order: its
    parameters must be the current ones without ``tile_order``, or those
    with ``tile_order`` right after ``tile_counts``, else this raises."""
    fn = ENTRY[kernel][source]
    base = [n for _, n in c_params((CSRC / f"{source}.cu").read_text(), fn)
            if n != "tile_order"]
    names = [n for _, n in c_params(text, fn)]
    if names == base:
        return False
    i = base.index("tile_counts") + 1
    if names == base[:i] + ["tile_order"] + base[i:]:
        return True
    raise RuntimeError(f"the parent's {fn} takes ({', '.join(names)}): neither the current "
                       "parameters with tile_order after tile_counts nor those without it")


def _compile(src: Path, so: Path, include: Path) -> str:
    out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(include), "-o", str(so), str(src)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc {src.name} failed:\n{out.stdout}{out.stderr}")
    return out.stdout + out.stderr


def _sass_report(src: Path, cubin: Path) -> dict:
    """form -> ptxas line and opcode counts of the form's B1 and B2 kernels
    (keys ``b1 <form>`` and ``b2 <form>``)."""
    from ..ops.cuda.compare_sass import compile_sass
    sass, usage = compile_sass(src, cubin)
    rep = {}
    for tag, kernels in (("b1", FORWARD_KERNELS), ("b2", BACKWARD_KERNELS)):
        for form, kernel in kernels.items():
            if kernel not in sass:
                continue
            ops = collections.Counter(
                next(t for t in insn.split() if not t.startswith("@")).split(".")[0]
                for insn in sass[kernel])
            rep[f"{tag} {form}"] = dict(ptxas=usage.get(kernel), instructions=len(sass[kernel]),
                                        **{k: ops.get(k, 0) for k in OPCODES})
    return rep


def _turns(fns: dict, time_ms, reps: int) -> dict:
    """Time each function of ``fns`` twice in turns: the first build, the
    others, "current" twice, the others reversed, the first build. Returns
    name -> both medians."""
    first, *rest = [n for n in fns if n != "current"]
    times = collections.defaultdict(list)
    for n in [first, *rest, "current", "current", *reversed(rest), first]:
        times[n].append(time_ms(fns[n], reps))
    return dict(times)


class Comparison:
    """Earlier builds of B1 and B2, from the sources in ``dirs`` (the first
    is the parent), to time against the current ones."""

    def __init__(self, dirs):
        dirs = [Path(d).resolve() for d in dirs]
        self.builds = [d.name for d in dirs]
        if len(set(self.builds)) != len(dirs) or "current" in self.builds:
            raise RuntimeError(f"build names must be distinct and not 'current': {self.builds}")
        work = BUILD_DIR / "blend_compare"
        work.mkdir(parents=True, exist_ok=True)
        texts = {(b, s): (d / f"{s}.cu").read_text() for b, d in zip(self.builds, dirs)
                 for s in SOURCES}
        # build -> kernel -> source name -> whether its entry point takes the order
        self.takes_order = {b: {k: {s: takes_order(texts[(b, s)], s, k) for s in SOURCES}
                                for k in ENTRY} for b in self.builds}
        so = {k: work / f"{k[0]}_{k[1]}.so" for k in texts}
        src = {(b, s): d / f"{s}.cu" for b, d in zip(self.builds, dirs) for s in SOURCES}
        with ThreadPoolExecutor(max_workers=2 * len(texts) + 2) as ex:
            # the headers of each build come from its own directory (-I)
            built = {k: ex.submit(_compile, src[k], so[k], src[k].parent) for k in texts}
            sass = {k: ex.submit(_sass_report, src[k], so[k].with_suffix(".cubin"))
                    for k in texts}
            sass.update({("current", s): ex.submit(_sass_report, CSRC / f"{s}.cu",
                                                   work / f"current_{s}.cubin")
                         for s in SOURCES})
            self.sass = collections.defaultdict(dict)
            for (b, _), fut in sass.items():
                self.sass[b].update(fut.result())
            # build -> kernel -> source name -> its entry point, typed
            self.entry = {b: collections.defaultdict(dict) for b in self.builds}
            for (b, s), fut in built.items():
                fut.result()
                lib = ctypes.CDLL(str(so[(b, s)]))
                for k, by_src in ENTRY.items():
                    fn = getattr(lib, by_src[s])
                    fn.argtypes = [ctypes.c_void_p if "*" in t or t == "cudaStream_t"
                                   else ctypes.c_int for t, _ in c_params(texts[(b, s)],
                                                                           by_src[s])]
                    fn.restype = ctypes.c_int
                    self.entry[b][k][s] = fn

    @staticmethod
    def _head(pairs, starts, counts, prm, geo, order):
        """The entry points' leading arguments, the tile order's pointer
        where ``order`` is given."""
        from ..ops.cuda.blend import _grid
        H, W = geo["image_height"], geo["image_width"]
        grid_w, grid_h = _grid(W, H, geo["tile_h"], geo["tile_w"])
        return (pairs.data_ptr(), pairs.shape[1], starts.data_ptr(), counts.data_ptr(),
                *(() if order is None else (order.data_ptr(),)),
                prm.data_ptr(), W, H, geo["tile_w"], geo["tile_h"], grid_w, grid_w * grid_h)

    @classmethod
    def _b1_launcher(cls, fns: dict, takes: dict, fwd, geo, stats: bool, rich: bool, order):
        """A launch of one build's B1 (``fns``: source name -> entry point)
        on the wrapper's inputs ``fwd``, as a function of no arguments that
        returns its outputs (color, depth, normal, final_T, n_contrib and
        the stream or None)."""
        import torch

        from ..ops.cuda.build import check_launch
        from ..ops.cuda.streams import _stream
        pairs = fwd[0]
        H, W = geo["image_height"], geo["image_width"]
        dev = pairs.device
        outs = (torch.empty((3, H, W), device=dev), torch.empty((H, W), device=dev),
                torch.empty((3, H, W), device=dev), torch.empty((H, W), device=dev),
                torch.empty((H, W), dtype=torch.int32, device=dev),
                torch.empty((2, pairs.shape[1]), device=dev) if stats else None)
        s = "blend_gs" if geo["variant"] == "GS" else "blend"
        head = cls._head(*fwd, geo, order if takes[s] else None)
        flags = (int(stats), int(rich)) if s == "blend_gs" else (
            int(geo["variant"] == "3D"), int(stats), int(rich))
        args = (*head, *flags, *(o.data_ptr() if o is not None else None for o in outs))
        fn = fns[s]

        def launch():
            check_launch(fn(*args, _stream()), "blend_forward (compared build)")
            return outs
        launch.order = order          # keeps the order alive with the launch
        return launch

    @classmethod
    def _b2_launcher(cls, fns: dict, takes: dict, bw, geo, rich: bool, order):
        """A launch of one build's B2 on the wrapper's inputs ``bw``, as a
        function of no arguments that returns the (16, MP) rows."""
        import torch

        from ..ops.cuda.build import check_launch
        from ..ops.cuda.streams import _stream
        pairs, starts, counts, prm, fT, nc, g_color, g_T = bw[:8]
        H, W = geo["image_height"], geo["image_width"]
        extra = [bw[k] if len(bw) > k and bw[k] is not None else None for k in (8, 9)]
        if rich:
            extra = [e if e is not None else torch.zeros(s, device=pairs.device)
                     for e, s in zip(extra, ((H, W), (3, H, W)))]
        g_depth, g_normal = (e.data_ptr() if rich else None for e in extra)
        out = torch.empty_like(pairs)
        s = "blend_gs" if geo["variant"] == "GS" else "blend"
        head = cls._head(pairs, starts, counts, prm, geo, order if takes[s] else None)
        mid = (fT.data_ptr(), nc.data_ptr(), g_color.data_ptr(), g_T.data_ptr())
        if s == "blend_gs":
            args = (*head, int(rich), *mid, g_depth, out.data_ptr())
        else:
            args = (*head, int(geo["variant"] == "3D"), int(rich), *mid, g_depth, g_normal,
                    out.data_ptr())
        fn = fns[s]

        def launch():
            check_launch(fn(*args, _stream()), "blend_backward (compared build)")
            return out
        launch.keep = (extra, order)  # keeps the cotangents and the order alive
        return launch

    def _fns(self, kernel: str, make, current, order):
        """Per build its launch in ``order``, "block_order" the current
        kernel with the tiles in block order and "current" the wrapper."""
        import torch

        from ..ops.cuda.build import library
        fns = {b: make(self.entry[b][kernel], self.takes_order[b][kernel], order)
               for b in self.builds}
        own = {s: getattr(library(s), fn) for s, fn in ENTRY[kernel].items()}
        fns["block_order"] = make(own, dict.fromkeys(SOURCES, True),
                                  torch.arange(order.shape[0], device=order.device))
        fns["current"] = current
        return fns

    def turns_b1(self, fwd, geo, stats: bool, rich: bool, time_ms, reps: int = 10) -> dict:
        """Time each build's B1 and the current kernel in block order
        against the current wrapper on the same inputs, in turns. Returns
        per build the mean of its two medians and both; whether each build's
        five per-pixel outputs are bit-identical to the current ones
        (``identical``); and for the stream whether its max row is
        identical and its sum row's largest difference relative to the
        row's max (``stream``)."""
        import torch

        from ..ops.cuda import blend as KB

        order = KB.tile_order(fwd[2])

        def current():
            return KB.blend_forward(*fwd, stats=stats, rich=rich, order=order, **geo)
        cur = current()
        fns = self._fns("b1", lambda e, t, o: self._b1_launcher(e, t, fwd, geo, stats, rich, o),
                        current, order)
        outs = {n: f() for n, f in fns.items() if n != "current"}
        times = _turns(fns, time_ms, reps)
        torch.cuda.synchronize()
        identical = {n: [bool(torch.equal(a, b)) for a, b in zip(o[:5], cur[:5])]
                     for n, o in outs.items()}
        stream = {}
        if stats:
            scale = max(float(cur[5][0].abs().max()), 1e-30)
            stream = {n: dict(max_identical=bool(torch.equal(o[5][1], cur[5][1])),
                              sum_rel=float((o[5][0] - cur[5][0]).abs().max()) / scale)
                      for n, o in outs.items()}
        return dict(kernel="b1", form=KB._form(geo["variant"], stats, rich),
                    tiles=int(fwd[2].shape[0]),
                    ms={n: statistics.mean(t) for n, t in times.items()}, turns=times,
                    identical=identical, stream=stream)

    def turns_b2(self, bw, geo, rich: bool, time_ms, reps: int = 10) -> dict:
        """Time each build's B2 and the current kernel in block order
        against the current wrapper on the same inputs, in turns. Returns
        per build the mean of its two medians and both, and each build's
        largest difference from the current output, relative to each live
        row's max."""
        import torch

        from ..ops.cuda import blend as KB
        live = KB.LIVE_GRAD_ROWS[(geo["variant"], rich)]

        order = KB.tile_order(bw[2])

        def current():
            return KB.blend_backward(*bw, rich=rich, order=order, **geo)
        cur = current()
        fns = self._fns("b2", lambda e, t, o: self._b2_launcher(e, t, bw, geo, rich, o),
                        current, order)
        outs = {n: f() for n, f in fns.items() if n != "current"}
        times = _turns(fns, time_ms, reps)
        torch.cuda.synchronize()
        scale = cur[:live].abs().amax(dim=1).clamp_min(1e-30)
        rel = {n: float(((o[:live] - cur[:live]).abs().amax(dim=1) / scale).max())
               for n, o in outs.items()}
        return dict(kernel="b2", form=KB._form(geo["variant"], rich=rich),
                    tiles=int(bw[2].shape[0]),
                    ms={n: statistics.mean(t) for n, t in times.items()}, turns=times,
                    rel_vs_current=rel)
