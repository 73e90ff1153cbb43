"""The program's own spans and counters of a traced run, for the per-layer
metrics that read them: the snapshot of the program's tracing registry
(``triangle_splatting_tpu_torch/utils/tracing.py``), taken in the process
that ran the cell after its traced window, where the profiler turned the
program's spans on. Each reader gives None for an untraced record, for a
run without CUDA events (the CPU), and for a program that has no registry
or not the span or counter asked for."""

from __future__ import annotations

PER = {"train": "traced_steps", "render": "traced_frames"}


def _snapshot(rec: dict, kind: str):
    """(snapshot, steps or frames traced), or None."""
    n = rec.get(PER[kind]) if rec.get("kind") == kind else None
    if not n:
        return None
    try:
        from triangle_splatting_tpu_torch.utils import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    if not any(s["device_ms"] is not None for s in snap["spans"].values()):
        return None
    return snap, n


def device_ms(rec: dict, kind: str, names=(), prefix: str | None = None):
    """Device ms a traced step (``kind`` "train") or frame ("render") in
    the spans ``names`` and those whose name starts with ``prefix``: the
    summed CUDA-event wall of each call, idle inside the span included."""
    got = _snapshot(rec, kind)
    if got is None:
        return None
    snap, n = got
    vals = [s["device_ms"] for name, s in snap["spans"].items()
            if (name in names or (prefix and name.startswith(prefix)))
            and s["device_ms"] is not None]
    return sum(vals) / n if vals else None


def share(rec: dict, kind: str, part: str, whole: str):
    """100 * counter ``part`` / counter ``whole`` over the traced window."""
    got = _snapshot(rec, kind)
    if got is None:
        return None
    c = got[0]["counters"]
    if not c.get(whole) or part not in c:
        return None
    return 100.0 * c[part] / c[whole]
