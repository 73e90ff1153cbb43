"""Build and load the hand-written CUDA kernels (ctypes, plain C interface).

Each source under ``csrc/`` is compiled by its own ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``. Builds start at first use, all sources
in parallel, into ``build/`` beside this file (listed in ``.gitignore``).
A library is named by a hash of its source, the headers of ``csrc/`` it
includes and the flags, so an edited source or header is rebuilt and a
stale library is never loaded.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("streams", "blend", "blend_gs", "probes")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argument types (pointers and the stream as
# c_void_p so a 64-bit address is never cut to 32 bits, floats as c_float).
SIGNATURES = {
    "streams": {
        "ts_relayout_pairs": (_P, _P, _P, _P, _I, _P, _I, _P),
        "ts_segment_reduce_pairs": (_P, _I, _I, _P, _P, _P, _I, _P, _P),
        "ts_segment_reduce_stats": (_P, _P, _I, _P, _P, _P, _I, _P, _P, _P),
    },
    "blend": {
        "ts_blend_forward": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
        "ts_blend_backward": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _P, _P, _P, _P, _P, _P, _P, _P),
        "ts_blend_backward_smem": (_I, _I),
        "ts_blend_forward_smem": (_I, _I, _I),
    },
    "blend_gs": {
        "ts_blend_forward_gs": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _P, _P, _P, _P, _P, _P, _P),
        "ts_blend_backward_gs": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _P, _P, _P, _P, _P, _P, _P),
        "ts_blend_backward_gs_smem": (_I,),
        "ts_blend_forward_gs_smem": (_I, _I),
    },
    "probes": {
        "ts_probe_vpu": (_P, _P, _I, _I, _I, _I, _F, _F, _P),
        "ts_probe_exp": (_P, _P, _I, _I, _I, _F, _F, _P),
        "ts_probe_scan": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> dict(seconds, log) of builds this process ran (empty when the
# libraries were already built)
build_reports: dict[str, dict] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in re.findall(rb'#include "([^"]+)"', src):
        src += (CSRC / header.decode()).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all at once.

    Returns name -> library path. Raises with the compiler's output when a
    build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, paths[n])
        build_reports[n] = dict(seconds=time.perf_counter() - t0, log=out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all((name,))[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check_launch(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")
