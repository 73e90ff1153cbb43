"""Device time and idle gaps of a ``torch.profiler`` Chrome trace by the
program span they fall in.

    python -m triangle_splatting_tpu_torch.tools.trace_report \\
        <output_dir>/profile/trace_<a>_<b>.json [--spans <output_dir>/profile/spans_<a>_<b>.json]

The program's spans (``utils/tracing.py``) are the trace's
``user_annotation`` events. Each device operation (kernel, copy, memset)
is put down to the innermost span open at its launch: the host call that
shares its ``correlation``, or the operation's own start where the trace
has none. Each idle gap between device operations is put down to the
innermost span the host was in when the gap closed, at the launch of the
operation that ends it. Prints device ms and idle ms by span, the busy
time and the share of it launched inside some span; with ``--spans``, the
calls, host ms and device ms (CUDA events) of each span and the counters
of the ``spans_*.json`` the trainers' profile window writes beside the
trace.
"""

from __future__ import annotations

import argparse
import bisect
import json
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
NOT_PROGRAM = ("bench.", "ProfilerStep#")
OUTSIDE = "(no span)"


def _innermost(spans: list) -> tuple[list, list]:
    """Cut the time line at every span boundary: (segment starts, the
    innermost span open over each segment). Spans nest per thread; across
    threads the latest started wins."""
    # at one time, spans that end leave before spans that start enter
    marks = sorted([(s[1], 0, i) for i, s in enumerate(spans)]
                   + [(s[0], 1, i) for i, s in enumerate(spans)])
    open_: dict = {}
    starts, labels = [], []
    for j, (t, enters, i) in enumerate(marks):
        if enters:
            open_[i] = (spans[i][0], -spans[i][1])
        else:
            open_.pop(i, None)
        if j + 1 == len(marks) or marks[j + 1][0] != t:
            starts.append(t)
            labels.append(spans[max(open_, key=open_.get)][2] if open_ else OUTSIDE)
    return starts, labels


def report(doc: dict, exclude=NOT_PROGRAM) -> dict:
    """``device_ms`` and ``idle_ms`` by innermost span, ``busy_ms``, the
    ``in_span_share`` of busy time launched inside a span, and the number
    of program ``spans`` in the trace."""
    ev = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
             if e.get("cat") == "user_annotation" and not e["name"].startswith(exclude)]
    starts, labels = _innermost(spans)

    def label(t):
        i = bisect.bisect_right(starts, t) - 1
        return labels[i] if i >= 0 else OUTSIDE

    launch = {e["args"]["correlation"]: e["ts"] for e in ev
              if e.get("cat") in HOST_CATS and "correlation" in e.get("args", {})}
    ops = sorted((e["ts"], e["ts"] + e["dur"], launch.get(e.get("args", {}).get("correlation"),
                                                          e["ts"]))
                 for e in ev if e.get("cat") in DEVICE_CATS and e["dur"] > 0)
    device, idle = defaultdict(float), defaultdict(float)
    busy = inside = 0.0
    end = None
    for a, b, at in ops:
        who = label(at)
        device[who] += (b - a) * 1e-3
        if end is not None and a > end:
            idle[who] += (a - end) * 1e-3
        lo = a if end is None else max(a, end)
        if b > lo:
            busy += (b - lo) * 1e-3
            if who != OUTSIDE:
                inside += (b - lo) * 1e-3
        end = b if end is None else max(end, b)
    return dict(device_ms=dict(device), idle_ms=dict(idle), busy_ms=busy,
                in_span_share=inside / busy if busy else None, spans=len(spans))


def format_report(rep: dict, spans_doc: dict | None = None) -> str:
    lines = [f"busy {rep['busy_ms']:.3f} ms, launched inside a program span: "
             + ("n/a" if rep["in_span_share"] is None else f"{100 * rep['in_span_share']:.1f}%"),
             "device ms by innermost span:"]
    lines += [f"  {n:<28s} {v:10.3f}" for n, v in sorted(rep["device_ms"].items(),
                                                          key=lambda x: -x[1])]
    lines.append("idle ms by the span that closed the gap:")
    lines += [f"  {n:<28s} {v:10.3f}" for n, v in sorted(rep["idle_ms"].items(),
                                                          key=lambda x: -x[1])]
    if spans_doc is not None:
        snap = spans_doc["snapshot"]
        lines.append("spans (calls, host ms, device ms by CUDA events):")
        for n, s in sorted(snap["spans"].items()):
            dev = "-" if s["device_ms"] is None else f"{s['device_ms']:.3f}"
            lines.append(f"  {n:<28s} {s['calls']:6d} {s['host_ms']:10.3f} {dev:>10s}")
        lines.append("counters:")
        lines += [f"  {n:<28s} {v}" for n, v in sorted(snap["counters"].items())]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", type=Path)
    ap.add_argument("--spans", type=Path, default=None)
    a = ap.parse_args(argv)
    rep = report(json.loads(a.trace.read_text()))
    doc = json.loads(a.spans.read_text()) if a.spans else None
    print(format_report(rep, doc))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
