"""Spans and counters inside the port, on the profiler's clock.

    with tracing.span("raster.binning"):
        binning = bin_triangles(...)
    tracing.count("raster.pairs", binning.num_pairs)

Off, the default, ``span`` returns one shared no-op context manager after
one flag check and ``count`` returns at once: nothing is recorded, no
``record_function`` is entered, no CUDA event is made and no device tensor
is touched. On means ``enable()`` is in force or a ``torch.profiler``
session is recording, so an operator's profiler window (the trainers'
``profile_start_iter``) and any traced run get the spans with no setting of
their own.

While on, a span enters ``torch.profiler.record_function(name)`` (so it
lies in the profiler's Chrome trace around the kernels it launches) and
keeps a record: its name, its parent span, the step id (``set_step``), its
host start and end (``perf_counter_ns``) and, once CUDA is initialised, a
pair of CUDA events recorded on the current stream at entry and exit. The
events are resolved in ``snapshot()`` and ``write()`` only. ``count`` adds
a host number on the host and a device tensor into a device accumulator,
with no synchronise.

Each off-to-on edge (``enable()``, or a new profiler session seen by the
first span, counter or ``set_step`` call inside it) starts a new record
and drops the previous one; a session ends at the first ``set_step`` seen
off, or at ``disable()``. At most ``MAX_RECORDS`` spans are kept a
session, and those past it are counted as dropped (their
``record_function`` is still entered).
"""

from __future__ import annotations

import functools
import json
import threading
import time
from contextlib import nullcontext
from pathlib import Path

import torch
from torch.autograd import profiler as _profiler

MAX_RECORDS = 1 << 16
_NULL = nullcontext()
_forced = False


class _Record:
    __slots__ = ("name", "parent", "step", "t0", "t1", "ev0", "ev1", "device_ms")

    def __init__(self, name: str, parent: int, step):
        self.name, self.parent, self.step = name, parent, step
        self.t1 = self.ev0 = self.ev1 = self.device_ms = None
        if torch.cuda.is_initialized():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter_ns()

    def close(self) -> None:
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record()
        self.t1 = time.perf_counter_ns()


class Registry:
    """One session's span records and counters."""

    def __init__(self, cap: int = MAX_RECORDS):
        self.cap = cap
        self.live = False
        self.session = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._clear()

    def _clear(self) -> None:
        self.records: list[_Record] = []
        self.dropped = 0
        self.step = None
        self.host: dict = {}
        self.device: dict = {}

    def begin(self) -> None:
        """Start a new session, dropping the previous one's records."""
        with self._lock:
            self._clear()
            self.live = True
            self.session += 1

    def stack(self) -> list:
        """This thread's open spans: (session, record index or -1)."""
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def open(self, name: str):
        """A new record under this thread's innermost open span (None past
        the cap)."""
        stack = self.stack()
        with self._lock:
            # a parent opened in an earlier session is not in this one's records
            parent = stack[-1][1] if stack and stack[-1][0] == self.session else -1
            if len(self.records) >= self.cap:
                self.dropped += 1
                rec, idx = None, -1
            else:
                rec = _Record(name, parent, self.step)
                self.records.append(rec)
                idx = len(self.records) - 1
            stack.append((self.session, idx))
        return rec

    def add(self, name: str, value) -> None:
        if not torch.is_tensor(value):
            with self._lock:
                self.host[name] = self.host.get(name, 0) + value
            return
        v = value.detach()
        v = (v.sum() if v.numel() != 1 else v.reshape(()))
        v = v.to(torch.float64 if v.is_floating_point() else torch.int64)
        with self._lock:
            acc = self.device.get(name)
            if acc is None:
                self.device[name] = v.clone()
            else:
                acc.add_(v)

    def resolve(self) -> None:
        """Turn every closed span's event pair into its device ms (one
        synchronise) and release the events."""
        pending = [r for r in self.records if r.ev1 is not None]
        if not pending:
            return
        torch.cuda.synchronize()
        for r in pending:
            r.device_ms = r.ev0.elapsed_time(r.ev1)
            r.ev0 = r.ev1 = None

    def counters(self) -> dict:
        out = dict(self.host)
        for name, acc in self.device.items():
            out[name] = out.get(name, 0) + acc.item()
        return out


_REG = Registry()


class _Span:
    __slots__ = ("name", "_rf", "_rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if not _REG.live:
            _REG.begin()
        self._rf = _profiler.record_function(self.name)
        self._rf.__enter__()
        self._rec = _REG.open(self.name)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec.close()
        _REG.stack().pop()
        self._rf.__exit__(*exc)
        return False


def active() -> bool:
    """Whether spans and counters record now."""
    return _forced or _profiler._is_profiler_enabled


def span(name: str):
    """A context manager around one stage of the program (a no-op while
    off)."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name)


def spanned(name: str):
    """A decorator that runs the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, value) -> None:
    """Add ``value`` (a host number, or a device tensor summed on its
    device) to counter ``name`` while on."""
    if not (_forced or _profiler._is_profiler_enabled):
        return
    if not _REG.live:
        _REG.begin()
    _REG.add(name, value)


def set_step(step) -> None:
    """The step or frame id of the spans that follow; also where a session
    that ended with its profiler is closed."""
    if _forced or _profiler._is_profiler_enabled:
        if not _REG.live:
            _REG.begin()
        _REG.step = step
    elif _REG.live:
        _REG.live = False


def enable() -> None:
    """Record from now on, in a new session."""
    global _forced
    _forced = True
    _REG.begin()


def disable() -> None:
    """Stop recording (a running profiler session still turns spans on);
    the session's records stay readable."""
    global _forced
    _forced = False
    _REG.live = False


def _launches() -> dict:
    from ..ops.cuda import launch_counts
    return {kernel if form is None else f"{kernel}.{form}": n
            for (kernel, form), n in launch_counts().items()}


def snapshot() -> dict:
    """The current (or last) session: per span name ``calls``, ``host_ms``
    and ``device_ms`` (the summed event-to-event wall on the stream, idle
    inside the span included; None where no CUDA event was kept), the
    ``counters``, the kernels' ``launches`` (``ops.cuda.launch_counts()``,
    counted since the process started or its last reset), and the number
    of ``records`` kept and ``dropped``."""
    _REG.resolve()
    spans: dict = {}
    for r in _REG.records:
        if r.t1 is None:
            continue
        s = spans.setdefault(r.name, dict(calls=0, host_ms=0.0, device_ms=None))
        s["calls"] += 1
        s["host_ms"] += (r.t1 - r.t0) * 1e-6
        if r.device_ms is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + r.device_ms
    return dict(spans=spans, counters=_REG.counters(), launches=_launches(),
                records=len(_REG.records), dropped=_REG.dropped)


def write(path) -> dict:
    """Write the session as JSON to ``path``: ``snapshot`` and ``records``,
    one per span kept (name, parent name and index, step, host start and
    end in ns, device ms). Returns the snapshot."""
    snap = snapshot()
    recs = _REG.records
    rows = [dict(name=r.name, parent=recs[r.parent].name if r.parent >= 0 else None,
                 parent_index=r.parent, step=r.step, host_start_ns=r.t0, host_end_ns=r.t1,
                 device_ms=r.device_ms) for r in recs]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(snapshot=snap, records=rows), default=str))
    return snap
