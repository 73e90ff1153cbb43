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

def _slot_gather_plain(sorted_tri: torch.Tensor, raw_starts: torch.Tensor,
                       astarts: torch.Tensor, ma: int) -> torch.Tensor:
    """``pair_tri`` slot by slot: each slot finds its tile by a binary
    search over the aligned starts and gathers one sorted entry."""
    num_tiles = raw_starts.shape[0] - 1
    tile_counts = raw_starts[1:] - raw_starts[:-1]
    slot = torch.arange(ma, dtype=torch.int32, device=sorted_tri.device)
    # last tile t with astarts[t] <= slot (empty tiles share starts)
    t = torch.searchsorted(astarts, slot, right=True, out_int32=True) - 1
    t_safe = t.clamp(0, num_tiles - 1).long()
    j = slot - astarts[t_safe]
    ok = (t < num_tiles) & (j < tile_counts[t_safe])
    src = (raw_starts[t_safe] + j).clamp(0, max(sorted_tri.shape[0] - 1, 0))
    vals = sorted_tri[src.long()] if sorted_tri.numel() else torch.zeros_like(slot)
    return torch.where(ok, vals, torch.full_like(vals, -1))


def relayout_pairs_plain(tri: torch.Tensor, sorted_raw: torch.Tensor,
                         sorted_key: torch.Tensor, raw_starts: torch.Tensor,
                         astarts: torch.Tensor, ma: int, dbits: int, align: int):
    """Plain PyTorch B3: the owner gather, one indexed gather over the output
    slots, and one scatter that writes the map. The tile of a sorted pair
    comes from a binary search over ``raw_starts`` (the kernel reads it
    from ``sorted_key``, which this version does not read; nor ``align``,
    which ``astarts`` already carries)."""
    n = sorted_raw.shape[0]
    raw = sorted_raw.long()
    pair_tri = _slot_gather_plain(tri[raw], raw_starts, astarts, ma)
    s = torch.arange(n, dtype=torch.int32, device=tri.device)
    tile = (torch.searchsorted(raw_starts, s, right=True, out_int32=True) - 1).clamp_min(0).long()
    pack_perm = torch.empty((n,), dtype=torch.int32, device=tri.device)
    pack_perm[raw] = astarts[tile] + s - raw_starts[tile]
    return pair_tri, pack_perm


def relayout_pairs(tri: torch.Tensor, sorted_raw: torch.Tensor,
                   sorted_key: torch.Tensor, raw_starts: torch.Tensor,
                   astarts: torch.Tensor, ma: int, dbits: int, align: int):
    """Tile-aligned re-layout of the sorted pair stream, and its map.

    The key sort took raw pair ``sorted_raw[s]`` to sorted position ``s``;
    ``sorted_key[s] >> dbits`` is its tile (``num_tiles`` for the unbinned
    tail at and past ``raw_starts[-1]``). With ``slot(s) = astarts[tile] +
    s - raw_starts[tile]`` this returns ``pair_tri`` (ma,), holding
    ``tri[sorted_raw[s]]`` at ``slot(s)`` for every binned pair and -1 in
    every other slot, and ``pack_perm`` (n,), the owner-order map:
    ``pack_perm[sorted_raw[s]] = slot(s)``, so raw pair r (triangle-major)
    lies in slot ``pack_perm[r]``, and raw pairs past the binned ones map to
    distinct empty slots after the last tile. ``astarts`` pads each tile
    to a multiple of ``align``, so ``ma`` must be at least ``n + (align -
    1) * num_tiles`` (``binning.aligned_capacity`` is); a smaller one
    raises. All int32: tri, sorted_raw, sorted_key (n,); raw_starts /
    astarts (num_tiles + 1,).
    """
    dev = tri.device
    n = tri.shape[0]
    for t, name in ((tri, "tri"), (sorted_raw, "sorted_raw"), (sorted_key, "sorted_key"),
                    (raw_starts, "raw_starts"), (astarts, "astarts")):
        _check(t, name, torch.int32, 1, dev)
    if sorted_raw.shape[0] != n or sorted_key.shape[0] != n:
        raise ValueError("tri, sorted_raw and sorted_key must have the same length")
    num_tiles = raw_starts.shape[0] - 1
    if num_tiles < 1 or astarts.shape[0] != num_tiles + 1:
        raise ValueError("raw_starts / astarts must have num_tiles + 1 entries")
    if ma < n + (align - 1) * num_tiles:
        raise ValueError(f"ma {ma} leaves no room for every pair: it must be at least "
                         f"n + (align - 1) * num_tiles = {n + (align - 1) * num_tiles}")
    if dev.type == "cpu":
        return relayout_pairs_plain(tri, sorted_raw, sorted_key, raw_starts, astarts,
                                    ma, dbits, align)
    if dev.type != "cuda":
        raise ValueError(f"relayout_pairs: unsupported device {dev}")
    pair_tri = torch.empty((ma,), dtype=torch.int32, device=dev)
    pack_perm = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = library("streams")
    relayout_pairs.launches += 1
    check_launch(lib.ts_relayout_pairs(
        tri.data_ptr(), sorted_raw.data_ptr(), sorted_key.data_ptr(),
        raw_starts.data_ptr(), astarts.data_ptr(), num_tiles, dbits, n,
        pair_tri.data_ptr(), pack_perm.data_ptr(), ma, _stream()), "relayout_pairs")
    return pair_tri, pack_perm


relayout_pairs.launches = 0


# ---------------------------------------------------------------------------
# B4 segment_reduce_pairs
# ---------------------------------------------------------------------------

def segment_reduce_pairs_plain(cols: torch.Tensor, starts: torch.Tensor,
                               ends: torch.Tensor, nvalid: torch.Tensor,
                               perm: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch B4: with a map, the columns gathered through it first;
    then an exclusive prefix sum in float64 and two gathers at the segment
    bounds (columns at or past nvalid zeroed with a select first)."""
    if perm is not None:
        cols = cols.index_select(1, perm.long())
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
                         nvalid: torch.Tensor | int | None = None,
                         perm: torch.Tensor | None = None) -> torch.Tensor:
    """Sum column segments of an (R, M) stream into (16, P).

    The backward of the pair pack: triangle t owns positions [starts[t],
    ends[t]) and its gradient is the sum of their columns. With ``perm``
    (int32 (L,), B3's ``pack_perm``) position j is column ``perm[j]`` of
    ``cols`` (B2's per-pair gradients in the aligned slot order, read in
    place); without it position j is column j (columns already sorted by
    owning triangle, the JAX contract). ``starts``/``ends`` are (P,) int32,
    nondecreasing, starts <= ends; empty segments give zeros. Positions at
    or past ``nvalid`` (a 0-dim int32 tensor on the same device, or None
    for L, M without a map) count as zero even when their columns hold NaN.
    ``R <= 16`` leading rows are summed; output rows R..15 are zero.
    """
    dev = cols.device
    # float64 only on the CPU (plain version); the kernel takes float32
    _check(cols, "cols", torch.float32 if dev.type == "cuda" else cols.dtype, 2, dev)
    if cols.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cols: expected float32, got {cols.dtype}")
    _check(starts, "starts", torch.int32, 1, dev)
    _check(ends, "ends", torch.int32, 1, dev)
    if perm is not None:
        _check(perm, "perm", torch.int32, 1, dev)
    nrows, m = cols.shape
    p = starts.shape[0]
    if nrows > 16 or ends.shape[0] != p:
        raise ValueError("cols must have <= 16 rows; starts/ends the same length")
    if nvalid is None:
        nvalid = m if perm is None else perm.shape[0]
    nvalid = torch.as_tensor(nvalid, dtype=torch.int32, device=dev).reshape(())
    if dev.type == "cpu":
        return segment_reduce_pairs_plain(cols, starts, ends, nvalid, perm)
    if dev.type != "cuda":
        raise ValueError(f"segment_reduce_pairs: unsupported device {dev}")
    out = torch.empty((16, p), dtype=torch.float32, device=dev)
    lib = library("streams")
    segment_reduce_pairs.launches += 1
    check_launch(lib.ts_segment_reduce_pairs(
        cols.data_ptr(), nrows, m, None if perm is None else perm.data_ptr(),
        0 if perm is None else perm.shape[0], starts.data_ptr(), ends.data_ptr(),
        nvalid.data_ptr(), p, out.data_ptr(), _stream()),
        "segment_reduce_pairs")
    return out


segment_reduce_pairs.launches = 0


# ---------------------------------------------------------------------------
# B5 segment_reduce_stats
# ---------------------------------------------------------------------------

def segment_reduce_stats_plain(sum_col: torch.Tensor, max_col: torch.Tensor,
                               starts: torch.Tensor, ends: torch.Tensor,
                               nvalid: torch.Tensor, perm: torch.Tensor | None = None):
    """Plain PyTorch B5: with a map, both columns gathered through it
    first; then the sums as B4's plain version takes them (an exclusive
    prefix sum in float64, differences at the segment bounds), the maxes as
    a masked segment max: each column below ``nvalid`` finds its segment by
    a binary search over the starts and is scattered with ``amax`` onto
    zeros (columns in no segment scatter a 0)."""
    if perm is not None:
        sum_col, max_col = sum_col[perm.long()], max_col[perm.long()]
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
                         nvalid: torch.Tensor | int | None = None,
                         perm: torch.Tensor | None = None):
    """Segment sum of ``sum_col`` and segment max of ``max_col``.

    The per-triangle contribution statistics: triangle t owns positions
    [starts[t], ends[t]) (P,) int32, nondecreasing and disjoint. With
    ``perm`` (int32 (L,), B3's ``pack_perm``) position j is column
    ``perm[j]`` of both (M,) float32 columns (the two rows of B1's (2, MA)
    stream in the aligned slot order, read in place); without it position
    j is column j (columns already sorted by owning triangle, the JAX
    contract). Values are >= 0; empty segments give 0 for both (the max
    identity is 0). Positions at or past ``nvalid`` (a 0-dim int32 tensor
    on the same device, or None for L, M without a map) count as 0 even
    when their columns hold NaN. Returns (sums, maxes), two (P,) float32.
    """
    dev = sum_col.device
    dt = torch.float32 if dev.type == "cuda" else sum_col.dtype
    _check(sum_col, "sum_col", dt, 1, dev)
    _check(max_col, "max_col", dt, 1, dev)
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"sum_col: expected float32, got {dt}")
    _check(starts, "starts", torch.int32, 1, dev)
    _check(ends, "ends", torch.int32, 1, dev)
    if perm is not None:
        _check(perm, "perm", torch.int32, 1, dev)
    m, p = sum_col.shape[0], starts.shape[0]
    if max_col.shape[0] != m or ends.shape[0] != p:
        raise ValueError("sum_col/max_col and starts/ends must have equal lengths")
    if nvalid is None:
        nvalid = m if perm is None else perm.shape[0]
    nvalid = torch.as_tensor(nvalid, dtype=torch.int32, device=dev).reshape(())
    if dev.type == "cpu":
        return segment_reduce_stats_plain(sum_col, max_col, starts, ends, nvalid, perm)
    if dev.type != "cuda":
        raise ValueError(f"segment_reduce_stats: unsupported device {dev}")
    sums = torch.empty((p,), dtype=torch.float32, device=dev)
    maxes = torch.empty((p,), dtype=torch.float32, device=dev)
    lib = library("streams")
    segment_reduce_stats.launches += 1
    check_launch(lib.ts_segment_reduce_stats(
        sum_col.data_ptr(), max_col.data_ptr(), m,
        None if perm is None else perm.data_ptr(), 0 if perm is None else perm.shape[0],
        starts.data_ptr(), ends.data_ptr(), nvalid.data_ptr(), p, sums.data_ptr(),
        maxes.data_ptr(), _stream()), "segment_reduce_stats")
    return sums, maxes


segment_reduce_stats.launches = 0
