"""Launch N ranks of a worker script over Gloo on the CPU, for the port's
multi-process tests (imported by name). Each rank is a fresh interpreter
that imports only the port; a rank that exits non-zero or outlives the
timeout fails the test, and every rank is killed when one fails."""

import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PRELUDE = r"""
import os, sys
sys.path.insert(0, os.environ["TS_REPO"])
import torch
torch.set_num_threads(1)
RANK = int(os.environ["TS_PROCESS_ID"])
OUT = os.environ["TS_OUT"]
"""

EPILOGUE = r"""
assert not any(m in ("jax", "triangle_splatting_tpu")
               or m.startswith(("jax.", "triangle_splatting_tpu."))
               for m in sys.modules), "a rank imported JAX or the JAX package"
print(f"RANK_OK {RANK}", flush=True)
"""


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(worker: str, n: int, out_dir, timeout: float = 300.0, env=None) -> list:
    """Run ``worker`` (Python source; PRELUDE gives it RANK and OUT) as ranks
    0..n-1 of one job through the TS_* variables. Returns their outputs."""
    port = free_port()
    procs = []
    for rank in range(n):
        e = dict(os.environ)
        e.update(TS_REPO=str(REPO), TS_COORDINATOR=f"127.0.0.1:{port}",
                 TS_NUM_PROCESSES=str(n), TS_PROCESS_ID=str(rank), TS_OUT=str(out_dir),
                 OMP_NUM_THREADS="1", **(env or {}))
        e.pop("TS_BACKEND", None)
        procs.append(subprocess.Popen([sys.executable, "-c", PRELUDE + worker + EPILOGUE],
                                      env=e, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for rank, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out[-4000:]}"
            assert f"RANK_OK {rank}" in out, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs
