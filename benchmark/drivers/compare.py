"""The comparison of a training cell's readings with the reference's."""

from __future__ import annotations

import statistics

import numpy as np
import torch

# a leaf whose reference norm is under this share of the median leaf's
# moves by round-off alone and is left out of the worst-leaf gap
NEGLIGIBLE = 1e-3


def norm_gaps(prog: dict, ref: dict) -> tuple[float, dict]:
    """The worst leaf's gap between the program's norm and the
    reference's, |‖p‖ - ‖r‖| / max(‖r‖, median leaf's ‖r‖), over the
    leaves the reference holds (empty leaves and those under NEGLIGIBLE of
    the median left out). Returns (worst gap, per-leaf detail)."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items() if v.numel()}
    med = statistics.median(norms.values()) if norms else 0.0
    detail, worst = {}, 0.0
    for k, rn in norms.items():
        pn = float(torch.linalg.vector_norm(prog[k].double()))
        if rn < NEGLIGIBLE * med:
            detail[k] = dict(program=pn, reference=rn, left_out=True)
            continue
        gap = abs(pn - rn) / max(rn, med, 1e-30)
        detail[k] = dict(program=pn, reference=rn, gap=gap)
        worst = max(worst, gap)
    return worst, detail


def median_gap(detail: dict) -> float:
    """The median leaf's gap of a ``norm_gaps`` detail (the leaves left out
    by NEGLIGIBLE not counted)."""
    gaps = [v["gap"] for v in detail.values() if "gap" in v]
    return statistics.median(gaps) if gaps else 0.0


def _mask(x, n: int) -> np.ndarray:
    m = np.zeros(n, bool)
    x = np.asarray(torch.as_tensor(x).cpu(), bool)
    m[:len(x)] = x
    return m


def _multiset_gap(a: np.ndarray, b: np.ndarray) -> int:
    """How many keys (rows of two (n, d) integer arrays) the two multisets
    do not share."""
    both = np.concatenate([a, b]).reshape(len(a) + len(b), -1)
    if not len(both):
        return 0
    _, inv = np.unique(both, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    ca = np.bincount(inv[:len(a)], minlength=inv.max() + 1)
    cb = np.bincount(inv[len(a):], minlength=inv.max() + 1)
    return int(np.abs(ca - cb).sum())


def alive_gap(alive_program, alive_reference, alive_start, keys_program=None,
              keys_reference=None) -> float:
    """The rows whose life the program and the reference disagree on, over
    the rows the reference's prunings and growth changed (at least 1).

    Rows alive at the start are compared row by row: a pruning leaves the
    other rows in place, so the wrong rows pruned in the right number
    count. Rows that came alive (growth) are compared by their keys (an
    anchor's voxel, from the reference's ``row_keys``) as multisets, where
    keys are given, since the two sides may place the same new anchors in
    other free rows; an anchor grown at the wrong place counts twice (one
    missing, one extra). Without keys they too are compared row by row."""
    n = max(len(alive_program), len(alive_reference), len(alive_start))
    p, r, s = _mask(alive_program, n), _mask(alive_reference, n), _mask(alive_start, n)
    gap = int((p[s] != r[s]).sum())
    born_p, born_r = p & ~s, r & ~s
    if keys_program is None or keys_reference is None:
        gap += int((born_p != born_r).sum())
    else:
        kp = np.asarray(keys_program)[born_p[:len(keys_program)]]
        kr = np.asarray(keys_reference)[born_r[:len(keys_reference)]]
        gap += _multiset_gap(kp, kr)
    return gap / max(int((r != s).sum()), 1)
