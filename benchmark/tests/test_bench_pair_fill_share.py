"""The per-layer metrics ``pair_fill_share.render`` and ``.train``: 100 *
the counter ``raster.pairs`` over ``raster.budget``. Each reader's value on
a synthetic snapshot of the program's registry, and None on an untraced
record, on a run without CUDA events (the CPU), on a program without the
registry and on a program without the ``raster.budget`` counter."""

from __future__ import annotations

import sys

import pytest

from benchmark import run as R
from benchmark.tests.test_bench_program_spans import SNAP, metric, record

COUNTERS = dict(SNAP["counters"], **{"raster.pairs": 1340, "raster.budget": 4000})
FILL = dict(SNAP, counters=COUNTERS)

EXPECTED = {"pair_fill_share.render": 33.5, "pair_fill_share.train": 33.5}


@pytest.fixture
def snapshot(monkeypatch):
    from triangle_splatting_tpu_torch.utils import tracing
    snap = {"value": FILL}
    monkeypatch.setattr(tracing, "snapshot", lambda: snap["value"])
    return snap


def test_the_entries_are_appended_after_the_program_span_metrics():
    b = R.load_spec()
    names = [m["name"] for m in b["per_layer"]]
    assert names[-len(EXPECTED):] == list(EXPECTED)
    assert names.index("live_slot_share.render") < names.index("pair_fill_share.render")
    for m in b["per_layer"][-len(EXPECTED):]:
        kind = m["name"].rsplit(".", 1)[1]
        assert m["workloads"] == ["scaffold-" + kind]
        assert m["moves"] == {"render": "render_ms_p95", "train": "train_views_per_s"}[kind]
        assert (m["unit"], m["better"], m["source"], m["layer"]) == (
            "%", "higher", "program_counter", "rasterizer forward")


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_value_on_a_synthetic_snapshot(name, snapshot):
    assert metric(name)(record(name)) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_none_untraced_on_cpu_and_without_registry(name, snapshot, monkeypatch):
    read = metric(name)
    other = "render" if name.endswith(".train") else "train"
    assert read(record(name, traced_steps=0, traced_frames=0)) is None
    assert read(dict(record(name), kind=other)) is None
    snapshot["value"] = dict(FILL, spans={n: dict(s, device_ms=None)
                                          for n, s in FILL["spans"].items()})
    assert read(record(name)) is None
    snapshot["value"] = FILL
    import triangle_splatting_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "triangle_splatting_tpu_torch.utils.tracing", None)
    assert read(record(name)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_none_without_the_budget_counter(name, snapshot):
    """A program older than the budget counter counts ``raster.pairs`` alone."""
    snapshot["value"] = dict(FILL, counters=dict(SNAP["counters"], **{"raster.pairs": 1340}))
    assert metric(name)(record(name)) is None
    snapshot["value"] = dict(FILL, counters={})
    assert metric(name)(record(name)) is None
