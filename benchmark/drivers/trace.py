"""Reading the device trace of a traced window: ``torch.profiler`` over
the window's first steps, exported as a Chrome trace and reduced to the
device's busy time (the union of kernel, copy and memset intervals, so
overlapping streams count once), device time by operation, and the idle
gaps between device operations attributed to the harness span the host
was in when the gap closed (the span that issued the next device work)."""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."


def start():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def finish(prof, path: Path) -> dict:
    prof.stop()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        return reduce(json.loads(path.read_text()))
    finally:
        path.unlink(missing_ok=True)


def reduce(doc: dict) -> dict:
    """busy_s, by_op {name: seconds}, op_calls {name: n}, idle_by_span
    {span: seconds} over the extent of the ``bench.window`` annotation."""
    ev = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    win = [e for e in ev if e.get("cat") == "user_annotation" and e.get("name") == "bench.window"]
    if not win:
        return dict(busy_s=0.0, by_op={}, op_calls={}, idle_by_span={}, trace_window_s=0.0)
    w0 = min(e["ts"] for e in win)
    w1 = max(e["ts"] + e["dur"] for e in win)
    dev = sorted(((max(e["ts"], w0), min(e["ts"] + e["dur"], w1), e["name"]) for e in ev
                  if e.get("cat") in DEVICE_CATS), key=lambda x: x[0])
    dev = [d for d in dev if d[1] > d[0]]
    by_op, calls = defaultdict(float), defaultdict(int)
    for a, b, name in dev:
        by_op[name] += (b - a) * 1e-6
        calls[name] += 1
    merged = []
    for a, b, _ in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][len(SPAN_PREFIX):]) for e in ev
                    if e.get("cat") == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX)
                    and e["name"] != "bench.window"), key=lambda x: x[0])
    idle = defaultdict(float)
    edges = [(w0, merged[0][0])] if merged else [(w0, w1)]
    edges += [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    if merged:
        edges.append((merged[-1][1], w1))
    for g0, g1 in edges:
        if g1 <= g0:
            continue
        label = "other"
        for s0, s1, name in spans:
            if s0 <= g1 - 1 <= s1:
                label = name
        idle[label] += (g1 - g0) * 1e-6
    return dict(busy_s=busy, by_op=dict(by_op), op_calls=dict(calls), idle_by_span=dict(idle),
                trace_window_s=(w1 - w0) * 1e-6)


def breakdown(red: dict) -> dict:
    ops = sorted(red["by_op"].items(), key=lambda x: -x[1])[:10]
    gaps = sorted(red["idle_by_span"].items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
