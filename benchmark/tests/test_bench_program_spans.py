"""The per-layer metrics that read the program's own spans and counters
(``benchmark/program_spans.py``): each reader's value on a synthetic
snapshot of the program's registry, None on an untraced record, on a run
without CUDA events (the CPU) and on a program without the registry, and a
traced CPU run of each scaffold cell whose registry holds the traced
window's spans while the readers report nothing."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import pytest

from benchmark import run as R
from benchmark.tests import conftest as T

ROOT = Path(__file__).resolve().parents[2]

SNAP = dict(
    spans={"step": dict(calls=4, host_ms=200.0, device_ms=190.0),
           "scaffold.prefilter": dict(calls=4, host_ms=4.0, device_ms=2.0),
           "scaffold.decode": dict(calls=4, host_ms=8.0, device_ms=30.0),
           "raster.preprocess": dict(calls=4, host_ms=3.0, device_ms=10.0),
           "raster.binning": dict(calls=4, host_ms=3.0, device_ms=6.0),
           "raster.blend": dict(calls=4, host_ms=3.0, device_ms=20.0),
           "loss": dict(calls=4, host_ms=1.0, device_ms=12.0),
           "backward": dict(calls=4, host_ms=5.0, device_ms=80.0),
           "adam": dict(calls=4, host_ms=1.0, device_ms=8.0),
           "stats": dict(calls=8, host_ms=1.0, device_ms=4.0),
           "render": dict(calls=4, host_ms=9.0, device_ms=70.0)},
    counters={"scaffold.selected": 300, "scaffold.slots": 1200},
    launches={}, records=50, dropped=0)

# metric: (value for 4 traced steps or frames of SNAP)
EXPECTED = {"decode_ms.train": 8.0, "raster_ms.train": 9.0, "loss_ms.train": 3.0,
            "backward_ms.train": 20.0, "optimizer_ms.train": 3.0,
            "live_slot_share.train": 25.0, "decode_ms.render": 8.0,
            "raster_ms.render": 9.0, "live_slot_share.render": 25.0}


def metric(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def record(name, **kw):
    kind = name.rsplit(".", 1)[1]
    per = "traced_steps" if kind == "train" else "traced_frames"
    return dict(dict(kind=kind, **{per: 4}), **kw)


@pytest.fixture
def snapshot(monkeypatch):
    from triangle_splatting_tpu_torch.utils import tracing
    snap = {"value": SNAP}
    monkeypatch.setattr(tracing, "snapshot", lambda: snap["value"])
    return snap


def test_the_new_entries_are_appended_and_read_by_files():
    b = R.load_spec()
    names = [m["name"] for m in b["per_layer"]]
    assert names[-len(EXPECTED):] == list(EXPECTED)
    for m in b["per_layer"][-len(EXPECTED):]:
        cell = "scaffold-" + m["name"].rsplit(".", 1)[1]
        assert m["workloads"] == [cell]
        assert m["source"] == ("program_counter" if "share" in m["name"] else "program_span")


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_value_on_a_synthetic_snapshot(name, snapshot):
    assert metric(name)(record(name)) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_none_untraced_on_cpu_and_without_registry(name, snapshot, monkeypatch):
    read = metric(name)
    other = "render" if name.endswith(".train") else "train"
    assert read(record(name, traced_steps=0, traced_frames=0)) is None
    assert read(dict(record(name), kind=other)) is None
    snapshot["value"] = dict(SNAP, spans={n: dict(s, device_ms=None)
                                          for n, s in SNAP["spans"].items()})
    assert read(record(name)) is None
    snapshot["value"] = SNAP
    import triangle_splatting_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "triangle_splatting_tpu_torch.utils.tracing", None)
    assert read(record(name)) is None


def test_readers_give_none_where_the_span_or_counter_is_missing(snapshot):
    snapshot["value"] = dict(SNAP, spans={"render": SNAP["spans"]["render"]}, counters={})
    for name in EXPECTED:
        assert metric(name)(record(name)) is None, name


@pytest.mark.parametrize("cell,span,per", [("scaffold-train", "step", "traced_steps"),
                                           ("scaffold-render", "render", "traced_frames")])
def test_a_traced_cpu_run_records_the_window_and_reports_none(cell, span, per):
    import torch
    from triangle_splatting_tpu_torch.utils import tracing
    torch.set_num_threads(2)
    seen = {}

    def keep(files):
        files = T.tiny(files)
        seen.update(files["traffic"])
        return files
    r = R.run_cell(cell, 3141592653589, 0.3, True, "cpu", overrides=keep, spec=T.spec())
    snap = tracing.snapshot()
    n = seen["trace_steps" if per == "traced_steps" else "trace_frames"]
    assert snap["spans"][span]["calls"] == n and snap["spans"]["raster.blend"]["calls"] == n
    assert snap["counters"]["scaffold.slots"] > 0 and not tracing.active()
    assert not set(EXPECTED) & set(r["metrics"]), r["metrics"]
