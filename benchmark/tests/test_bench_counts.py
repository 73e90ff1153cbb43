"""The benchmark's operation and byte counts against hand-computed cases."""

from __future__ import annotations

import pytest

from benchmark.counts import blend as B
from benchmark.counts import steps as S


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert B.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert B.bound_s(0.0, 67e12) == pytest.approx(1.0)
    assert B.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


@pytest.mark.parametrize("variant,rich,gamma1,ops,nbytes", [
    # (104 + 22) * 10; 4 * (14 * 2 + 2 + 9) + 4 * 10 * 4 + 4 * 16 * 2
    ("3D", True, False, 1260, 444),
    # (92 + 22) * 10
    ("3D", True, True, 1140, 444),
    # 66 * 10; 4 * (10 * 2 + 2 + 9) + 4 * 6 * 4 + 4 * 16 * 2
    ("GS", False, True, 660, 348),
])
def test_b2_counts(variant, rich, gamma1, ops, nbytes):
    assert B.b2(variant, rich, gamma1, evals=10, num_pairs=2, tiles=1, pixels=4) == (ops, nbytes)


def test_b1_dense_operations():
    assert B.b1_ops_dense("3D", True, False, 10) == (48 + 9) * 10
    assert B.b1_ops_dense("GS", False, True, 10) == 30 * 10


def test_mesh_step_operations_by_hand():
    c = dict(gamma1=True, evals=100, prims=2, pixels=5, params=26, geometry=True)
    want = ((43 + 9) * 100 + (92 + 22) * 100 + 3 * (54 + 12 + 84 + 16 + 6 + 12 + 80) * 2
            + (3 * (5 * 2 * 121 + 20) + 6) * 3 * 5 + 3 * ((2 * 18 + 20) / 4 + 4 * 16 + 12) * 5
            + 12 * 26)
    assert S.mesh_train_step(c) == pytest.approx(want)
    c["geometry"] = False
    assert S.mesh_train_step(c) == pytest.approx(want - 3 * ((2 * 18 + 20) / 4 + 4 * 16 + 12) * 5)


def test_scaffold_step_operations_by_hand():
    c = dict(alive=2, slots=40, anchors=4, feat_dim=3, hidden=2, head_out=7, gamma1=True,
             evals=50, pixels=5, params=9)
    k = 10
    heads = 2 * (5 * 3 * 2 + 2 * 7)
    want = (3 * heads * 2 + 3 * (47 + 180) * 2 * k + 180 * 2 + (30 + 66) * 50
            + (3 * (5 * 2 * 121 + 20) + 6) * 3 * 5 + 12 * 9)
    assert S.scaffold_train_step(c) == pytest.approx(want)


def test_counts_scale_linearly_with_the_work():
    c = dict(gamma1=False, evals=1e6, prims=1e3, pixels=1e4, params=1e4, geometry=True)
    one = S.mesh_train_step(c)
    c2 = {k: (2 * v if not isinstance(v, bool) else v) for k, v in c.items()}
    assert S.mesh_train_step(c2) == pytest.approx(2 * one)
