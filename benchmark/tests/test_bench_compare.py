"""The training check's alive-rows gap and the per-layer readers that
divide by the unprofiled window."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import run as R
from benchmark.drivers.compare import alive_gap


def _case():
    """100 rows: 60 alive at the start; the reference prunes rows 3 and 7
    and grows anchors at voxels (1,1,1) and (2,2,2) into rows 60 and 61."""
    start = np.arange(100) < 60
    ref = start.copy()
    ref[[3, 7]] = False
    ref[[60, 61]] = True
    keys = np.zeros((100, 3), np.int64)
    keys[:60] = np.arange(60)[:, None] + 100
    keys_ref = keys.copy()
    keys_ref[60], keys_ref[61] = (1, 1, 1), (2, 2, 2)
    return start, ref, keys_ref


def test_the_same_prunings_and_growth_read_nought():
    start, ref, keys = _case()
    assert alive_gap(ref, ref, start, keys, keys) == 0.0
    assert alive_gap(ref, ref, start) == 0.0


def test_growth_placed_in_other_free_rows_reads_nought():
    start, ref, keys = _case()
    prog, kp = ref.copy(), keys.copy()
    prog[[60, 61]], prog[[70, 71]] = False, True
    kp[70], kp[71] = keys[61], keys[60]
    assert alive_gap(prog, ref, start, kp, keys) == 0.0


@pytest.mark.parametrize("fault", ["other_rows_pruned", "anchor_grown_elsewhere", "one_more_grown",
                                   "none_grown"])
def test_the_wrong_rows_in_the_right_number_count(fault):
    start, ref, keys = _case()
    prog, kp = ref.copy(), keys.copy()
    if fault == "other_rows_pruned":
        prog[[3, 7]], prog[[4, 8]] = True, False
        want = 4
    elif fault == "anchor_grown_elsewhere":
        kp[61] = (2, 2, 3)
        want = 2
    elif fault == "one_more_grown":
        prog[62], kp[62] = True, (5, 5, 5)
        want = 1
    else:
        prog[[60, 61]] = False
        want = 2
    assert alive_gap(prog, ref, start, kp, keys) == pytest.approx(want / 4)


def test_a_program_with_more_rows_counts_its_extra_live_rows():
    start, ref, keys = _case()
    prog = np.concatenate([ref, [True, False]])
    kp = np.concatenate([keys, [[9, 9, 9], [0, 0, 0]]])
    assert alive_gap(prog, ref, start, kp, keys) == pytest.approx(1 / 4)


def _record(kind):
    counts = dict(step_ops=6.7e11)
    trace = dict(busy_s=2.0, by_op={})
    if kind == "train":
        return dict(kind=kind, counts=counts, trace=trace, traced_steps=40, window_s=4.0,
                    steps=500, wall_s=50.0)
    return dict(kind=kind, counts=counts, trace=trace, traced_frames=40, window_s=4.0,
                frames=500, wall_s=50.0)


@pytest.mark.parametrize("kind", ["train", "render"])
def test_idle_share_and_mfu_divide_by_the_unprofiled_step(kind):
    rec = _record(kind)
    # busy 50 ms a profiled step; an unprofiled step lasts 100 ms (the
    # profiled window's 100 ms a step is not the divisor)
    rec["window_s"] = 8.0
    assert R.read_metric(f"device_idle_share.{kind}", rec) == pytest.approx(50.0)
    assert R.read_metric(f"mfu.{kind}", rec) == pytest.approx(100.0 * 6.7e11 / (0.1 * 67e12))
    assert R.read_metric(f"device_idle_share.{'render' if kind == 'train' else 'train'}",
                         rec) is None
