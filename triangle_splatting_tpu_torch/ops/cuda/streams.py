"""Kernels B3 (``relayout_pairs``), B4 (``segment_reduce_pairs``) and B5
(``segment_reduce_stats``).

Ports of ``triangle_splatting_tpu/ops/pallas/streams.py``: the CUDA
kernels are in ``csrc/streams.cu``. Each wrapper takes the kernel for CUDA
tensors and the plain PyTorch version beside it for CPU tensors; there is
no fallback from one to the other. ``<wrapper>.launches`` counts the
kernel launches.
"""

from __future__ import annotations

import torch

from .build import check_launch, library


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# B3 relayout_pairs
# ---------------------------------------------------------------------------

def relayout_pairs_plain(sorted_tri: torch.Tensor, raw_starts: torch.Tensor,
                         astarts: torch.Tensor, tile_counts: torch.Tensor,
                         ma: int) -> torch.Tensor:
    """Plain PyTorch B3: one indexed gather over the output slots."""
    num_tiles = tile_counts.shape[0]
    slot = torch.arange(ma, dtype=torch.int32, device=sorted_tri.device)
    # last tile t with astarts[t] <= slot (empty tiles share starts)
    t = torch.searchsorted(astarts, slot, right=True, out_int32=True) - 1
    t_safe = t.clamp(0, num_tiles - 1).long()
    j = slot - astarts[t_safe]
    ok = (t < num_tiles) & (j < tile_counts[t_safe])
    src = (raw_starts[t_safe] + j).clamp(0, max(sorted_tri.shape[0] - 1, 0))
    vals = sorted_tri[src.long()] if sorted_tri.numel() else torch.zeros_like(slot)
    return torch.where(ok, vals, torch.full_like(vals, -1))


def relayout_pairs(sorted_tri: torch.Tensor, raw_starts: torch.Tensor,
                   astarts: torch.Tensor, tile_counts: torch.Tensor,
                   ma: int) -> torch.Tensor:
    """Tile-aligned re-layout of the sorted pair stream.

    ``out[astarts[t] + j] = sorted_tri[raw_starts[t] + j]`` for
    ``j < tile_counts[t]``, -1 elsewhere. All int32: sorted_tri (MP,),
    raw_starts / astarts (T + 1,), tile_counts (T,); returns (ma,).
    """
    dev = sorted_tri.device
    num_tiles = tile_counts.shape[0]
    for t, n in ((sorted_tri, "sorted_tri"), (raw_starts, "raw_starts"),
                 (astarts, "astarts"), (tile_counts, "tile_counts")):
        _check(t, n, torch.int32, 1, dev)
    if raw_starts.shape[0] != num_tiles + 1 or astarts.shape[0] != num_tiles + 1:
        raise ValueError("raw_starts / astarts must have num_tiles + 1 entries")
    if dev.type == "cpu":
        return relayout_pairs_plain(sorted_tri, raw_starts, astarts,
                                    tile_counts, ma)
    if dev.type != "cuda":
        raise ValueError(f"relayout_pairs: unsupported device {dev}")
    out = torch.empty((ma,), dtype=torch.int32, device=dev)
    lib = library("streams")
    relayout_pairs.launches += 1
    check_launch(lib.ts_relayout_pairs(
        sorted_tri.data_ptr(), raw_starts.data_ptr(), astarts.data_ptr(),
        tile_counts.data_ptr(), num_tiles, out.data_ptr(), ma, _stream()),
        "relayout_pairs")
    return out


relayout_pairs.launches = 0


# ---------------------------------------------------------------------------
# B4 segment_reduce_pairs
# ---------------------------------------------------------------------------

def segment_reduce_pairs_plain(cols: torch.Tensor, starts: torch.Tensor,
                               ends: torch.Tensor,
                               nvalid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch B4: an exclusive prefix sum in float64 and two
    gathers at the segment bounds (columns at or past nvalid zeroed with a
    select first)."""
    r, m = cols.shape
    pos = torch.arange(m, device=cols.device)
    clean = torch.where(pos[None, :] < nvalid, cols, torch.zeros_like(cols))
    csum = torch.cat([torch.zeros((r, 1), dtype=torch.float64, device=cols.device),
                      torch.cumsum(clean.double(), dim=1)], dim=1)
    s = starts.long().clamp(0, m)
    e = ends.long().clamp(0, m)
    e = torch.maximum(e, s)
    out = (csum[:, e] - csum[:, s]).to(cols.dtype)
    full = torch.zeros((16, starts.shape[0]), dtype=cols.dtype, device=cols.device)
    full[:r] = out
    return full


def segment_reduce_pairs(cols: torch.Tensor, starts: torch.Tensor,
                         ends: torch.Tensor,
                         nvalid: torch.Tensor | int | None = None) -> torch.Tensor:
    """Sum contiguous column segments of an (R, M) stream into (16, P).

    The backward of the pair pack: after the per-pair gradient columns are
    sorted by owning triangle, triangle t owns columns [starts[t], ends[t])
    and its gradient is their sum. ``starts``/``ends`` are (P,) int32,
    nondecreasing, starts <= ends; empty segments give zeros. Columns at or
    past ``nvalid`` (a 0-dim int32 tensor on the same device, or None for
    M) count as zero even when they hold NaN. ``R <= 16`` leading rows are
    summed; output rows R..15 are zero.
    """
    dev = cols.device
    # float64 only on the CPU (plain version); the kernel takes float32
    _check(cols, "cols", torch.float32 if dev.type == "cuda" else cols.dtype, 2, dev)
    if cols.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cols: expected float32, got {cols.dtype}")
    _check(starts, "starts", torch.int32, 1, dev)
    _check(ends, "ends", torch.int32, 1, dev)
    nrows, m = cols.shape
    p = starts.shape[0]
    if nrows > 16 or ends.shape[0] != p:
        raise ValueError("cols must have <= 16 rows; starts/ends the same length")
    if nvalid is None:
        nvalid = m
    nvalid = torch.as_tensor(nvalid, dtype=torch.int32, device=dev).reshape(())
    if dev.type == "cpu":
        return segment_reduce_pairs_plain(cols, starts, ends, nvalid)
    if dev.type != "cuda":
        raise ValueError(f"segment_reduce_pairs: unsupported device {dev}")
    out = torch.empty((16, p), dtype=torch.float32, device=dev)
    lib = library("streams")
    segment_reduce_pairs.launches += 1
    check_launch(lib.ts_segment_reduce_pairs(
        cols.data_ptr(), nrows, m, starts.data_ptr(), ends.data_ptr(),
        nvalid.data_ptr(), p, out.data_ptr(), _stream()),
        "segment_reduce_pairs")
    return out


segment_reduce_pairs.launches = 0


# ---------------------------------------------------------------------------
# B5 segment_reduce_stats
# ---------------------------------------------------------------------------

def segment_reduce_stats_plain(sum_col: torch.Tensor, max_col: torch.Tensor,
                               starts: torch.Tensor, ends: torch.Tensor,
                               nvalid: torch.Tensor):
    """Plain PyTorch B5: the sums as B4's plain version takes them (an
    exclusive prefix sum in float64, differences at the segment bounds),
    the maxes as a masked segment max: each column below ``nvalid`` finds
    its segment by a binary search over the starts and is scattered with
    ``amax`` onto zeros (columns in no segment scatter a 0)."""
    m, p = sum_col.shape[0], starts.shape[0]
    dev, dt = sum_col.device, sum_col.dtype
    pos = torch.arange(m, device=dev)
    ok = pos < nvalid
    clean = torch.where(ok, sum_col, torch.zeros_like(sum_col))
    csum = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev),
                      torch.cumsum(clean.double(), dim=0)])
    s = starts.long().clamp(0, m)
    e = torch.maximum(ends.long().clamp(0, m), s)
    sums = (csum[e] - csum[s]).to(dt)
    maxes = torch.zeros((p,), dtype=dt, device=dev)
    if p == 0 or m == 0:
        return sums, maxes
    # last segment whose start is <= pos (empty segments share their start
    # with the next one and come first, so the last is the one that owns pos)
    t = (torch.searchsorted(starts, pos.to(torch.int32), right=True) - 1).clamp(0, p - 1)
    owned = ok & (pos >= starts[t]) & (pos < ends[t])
    vals = torch.where(owned, max_col, torch.zeros_like(max_col))
    maxes.scatter_reduce_(0, t, vals, reduce="amax", include_self=True)
    return sums, maxes


def segment_reduce_stats(sum_col: torch.Tensor, max_col: torch.Tensor,
                         starts: torch.Tensor, ends: torch.Tensor,
                         nvalid: torch.Tensor | int | None = None):
    """Segment sum of ``sum_col`` and segment max of ``max_col``.

    The per-triangle contribution statistics: after the per-pair
    contribution stream is sorted by owning triangle, triangle t owns
    columns [starts[t], ends[t]) of both (M,) float32 columns (values
    >= 0). ``starts``/``ends`` are (P,) int32, nondecreasing and disjoint.
    Empty segments give 0 for both (the max identity is 0). Columns at or
    past ``nvalid`` (a 0-dim int32 tensor on the same device, or None for
    M) count as 0 even when they hold NaN. Returns (sums, maxes), two (P,)
    float32.
    """
    dev = sum_col.device
    dt = torch.float32 if dev.type == "cuda" else sum_col.dtype
    _check(sum_col, "sum_col", dt, 1, dev)
    _check(max_col, "max_col", dt, 1, dev)
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"sum_col: expected float32, got {dt}")
    _check(starts, "starts", torch.int32, 1, dev)
    _check(ends, "ends", torch.int32, 1, dev)
    m, p = sum_col.shape[0], starts.shape[0]
    if max_col.shape[0] != m or ends.shape[0] != p:
        raise ValueError("sum_col/max_col and starts/ends must have equal lengths")
    if nvalid is None:
        nvalid = m
    nvalid = torch.as_tensor(nvalid, dtype=torch.int32, device=dev).reshape(())
    if dev.type == "cpu":
        return segment_reduce_stats_plain(sum_col, max_col, starts, ends, nvalid)
    if dev.type != "cuda":
        raise ValueError(f"segment_reduce_stats: unsupported device {dev}")
    sums = torch.empty((p,), dtype=torch.float32, device=dev)
    maxes = torch.empty((p,), dtype=torch.float32, device=dev)
    lib = library("streams")
    segment_reduce_stats.launches += 1
    check_launch(lib.ts_segment_reduce_stats(
        sum_col.data_ptr(), max_col.data_ptr(), m, starts.data_ptr(),
        ends.data_ptr(), nvalid.data_ptr(), p, sums.data_ptr(),
        maxes.data_ptr(), _stream()), "segment_reduce_stats")
    return sums, maxes


segment_reduce_stats.launches = 0
