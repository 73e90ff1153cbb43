"""Tile binning: triangle -> (tile, depth)-sorted pair lists.

Port of ``triangle_splatting_tpu/ops/binning.py``. Every ``Binning`` field
matches the JAX function integer for integer on the same ``Preprocessed``
inputs, ``pack_perm`` too (the JAX function's ``compute_pack_perm=True``
map) on its first ``num_pairs`` entries:

- exclusive sum of tiles_touched; ``total`` is kept in int64, so
  ``overflow = total > max_pairs`` also covers the int32 wrap the JAX
  function checks for;
- the owning triangle of every raw slot by a binary search of the slot
  over the exclusive sums (``pair_owners``: the JAX function's marker
  scatter and ``cummax``, equal on every slot; on the card ``cummax`` over
  one long axis runs as a single block);
- one fused int32 key ``tile << depth_bits | quantize(depth)``, computed
  from the per-triangle constants K0 and A as
  ``K0 + (within << dbits) + q * A`` with exact integer division for q;
- a STABLE sort of the key (ties in a depth bucket keep triangle order);
- ``searchsorted`` tile ranges, then kernel B3: the aligned relayout and the
  owner-order map ``pack_perm`` in one launch (the JAX package recovers the
  map with a second relayout and an inversion sort; a Hopper thread writes
  it by scatter).

Binning runs without gradients; its fields are int32 (bool for the flags).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from .cuda.blend import ALIGN, SLAB
from .cuda.streams import relayout_pairs
from .projection import Preprocessed, RasterSettings


@dataclass(frozen=True)
class Binning:
    """Sorted pair lists + per-tile ranges (see the JAX twin).

    Tile t owns slots [tile_starts[t], tile_starts[t] + tile_counts[t]);
    tile starts are ``align``-aligned and padding slots hold -1.
    """
    pair_tri: torch.Tensor       # (ma,) int32 — triangle per slot, -1 if empty
    pair_valid: torch.Tensor     # (ma,) bool
    tri_offsets: torch.Tensor    # (P + 1,) int32 — exclusive sum of tiles_touched
    tile_starts: torch.Tensor    # (num_tiles + 1,) int32, align-multiples
    tile_counts: torch.Tensor    # (num_tiles,) int32 — real pairs per tile
    num_pairs: torch.Tensor      # () int32 — pairs binned (<= max_pairs)
    overflow: torch.Tensor       # () bool — pair budget exceeded
    pack_perm: torch.Tensor      # (max_pairs,) int32 — owner-order map: raw
    #                              pair r (triangle-major, so triangle t's
    #                              pairs are [tri_offsets[t], tri_offsets[t+1]))
    #                              lies in slot pack_perm[r]; entries at and
    #                              past num_pairs name empty slots


def aligned_capacity(max_pairs: int, num_tiles: int, align: int) -> int:
    """Size of the aligned pair buffer for a raw-pair budget: per-tile
    alignment wastes up to ``align - 1`` slots per tile, plus the tail pad
    the TPU kernels' slabs needed (kept so both buffers have one layout)."""
    overrun = SLAB - align if align == ALIGN else SLAB
    return max_pairs + align * num_tiles + max(overrun, align)


def depth_bits_for(num_tiles: int) -> int:
    """Depth-quantization bits so (tile+1, depth) packs into int32."""
    tile_bits = max(int(num_tiles + 1).bit_length(), 1)
    return min(24, 30 - tile_bits)


def quantize_depth(depth: torch.Tensor, valid: torch.Tensor, bits: int) -> torch.Tensor:
    """Rank-preserving quantization of view depths to ``bits`` bits."""
    inf = torch.full_like(depth, float("inf"))
    lo = torch.where(valid, depth, inf).amin()
    hi = torch.where(valid, depth, -inf).amax()
    lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    hi = torch.where(hi > lo, hi, lo + 1.0)
    maxq = (1 << bits) - 1
    q = (depth - lo) / (hi - lo) * maxq
    q = torch.clamp(q, 0, maxq)
    return torch.nan_to_num(q, nan=0.0).to(torch.int32)


class SortedPairs(NamedTuple):
    """The tile-sorted pair stream, before the aligned relayout (the inputs
    of kernel B3) plus the per-triangle offsets."""
    tri: torch.Tensor            # (max_pairs,) int32 owning triangle per RAW pair
    sorted_raw: torch.Tensor     # (max_pairs,) int32 raw pair at each sorted position
    sorted_key: torch.Tensor     # (max_pairs,) int32 sorted keys
    dbits: int                   # key bits below the tile
    raw_starts: torch.Tensor     # (num_tiles + 1,) int32 tile starts (raw)
    astarts: torch.Tensor        # (num_tiles + 1,) int32 tile starts (aligned)
    tile_counts: torch.Tensor    # (num_tiles,) int32
    ma: int                      # aligned buffer capacity
    align: int                   # alignment of the tile starts
    tri_offsets: torch.Tensor    # (P + 1,) int32
    num_pairs: torch.Tensor      # () int32
    overflow: torch.Tensor       # () bool

    def relayout_args(self) -> tuple:
        """The arguments of kernel B3 (``relayout_pairs``)."""
        return (self.tri, self.sorted_raw, self.sorted_key, self.raw_starts,
                self.astarts, self.ma, self.dbits, self.align)


def pair_owners(counts: torch.Tensor, starts: torch.Tensor, max_pairs: int) -> torch.Tensor:
    """The owning triangle of every raw pair slot, (max_pairs,) int32: the
    last triangle with pairs whose first slot ``starts[t]`` (the exclusive
    sum of ``counts``, int64, nondecreasing) is at or before the slot; -1
    where no triangle has pairs. This is the JAX function's marker
    scatter-max of t + 1 at each first slot expanded by ``cummax``, minus
    one, on every slot, the unbinned tail included: a binary search finds
    the last triangle starting at or before the slot, which has pairs
    unless it is the last triangle (an empty one shares its start with the
    next), so the trailing empties are cut to the last triangle with
    pairs."""
    dev = counts.device
    P = counts.shape[0]
    if P == 0:
        return torch.full((max_pairs,), -1, dtype=torch.int32, device=dev)
    slot = torch.arange(max_pairs, dtype=starts.dtype, device=dev)
    t = torch.searchsorted(starts, slot, right=True, out_int32=True) - 1
    ids = torch.arange(P, dtype=torch.int32, device=dev)
    last = torch.where(counts > 0, ids, torch.full_like(ids, -1)).amax()
    return torch.minimum(t, last)


@torch.no_grad()
def sort_pairs(prep: Preprocessed, settings: RasterSettings,
               max_pairs: int, align: int = ALIGN,
               depth_key: Optional[torch.Tensor] = None) -> SortedPairs:
    """Expand triangles into pairs and sort them by (tile, depth).
    ``depth_key`` (P,) int32 replaces the depths quantized over this call's
    triangles: a depth slab sorts by the whole scene's keys
    (``parallel/depth_sharded.py``)."""
    dev = prep.depth.device
    i32 = torch.int32
    P = prep.depth.shape[0]
    grid_w = settings.grid_w
    num_tiles = settings.num_tiles
    dbits = depth_bits_for(num_tiles)

    counts = prep.tiles_touched.to(i32)                       # (P,)
    csum = torch.cumsum(counts, 0)                            # int64
    total = csum[-1] if P > 0 else torch.zeros((), dtype=torch.int64, device=dev)
    offsets = (csum - counts).to(i32)                         # exclusive
    num_pairs = torch.clamp_max(total, max_pairs).to(i32)
    overflow = total > max_pairs

    depth_q = quantize_depth(prep.depth, prep.valid, dbits) if depth_key is None \
        else depth_key.to(i32)
    rw_t = torch.clamp_min(prep.rect_max[:, 0] - prep.rect_min[:, 0], 1).to(i32)
    base = (prep.rect_min[:, 1] * grid_w + prep.rect_min[:, 0]).to(i32)
    K0_t = torch.bitwise_or(torch.bitwise_left_shift(base, dbits), depth_q)
    A_t = torch.bitwise_left_shift((grid_w - rw_t).to(i32), dbits)

    tri = pair_owners(counts, csum - counts, max_pairs)       # (max_pairs,)
    pair_idx = torch.arange(max_pairs, dtype=i32, device=dev)
    valid = (pair_idx < num_pairs) & (tri >= 0)
    tri_c = torch.clamp(tri, 0, max(P - 1, 0))
    tri_safe = tri_c.long()

    within = pair_idx - offsets[tri_safe]
    rw = rw_t[tri_safe]
    q = torch.div(within, rw, rounding_mode="floor").to(i32)
    key = (K0_t[tri_safe] + torch.bitwise_left_shift(within, dbits)
           + q * A_t[tri_safe])
    key = torch.where(valid, key, torch.full_like(key, num_tiles << dbits))
    sorted_key, order = torch.sort(key, stable=True)

    boundaries = torch.bitwise_left_shift(
        torch.arange(num_tiles + 1, dtype=i32, device=dev), dbits)
    raw_starts = torch.searchsorted(sorted_key, boundaries, out_int32=True)
    tile_counts = raw_starts[1:] - raw_starts[:-1]            # (num_tiles,)

    ma = aligned_capacity(max_pairs, num_tiles, align)
    padded = (tile_counts + align - 1) // align * align
    astarts = torch.cat([torch.zeros((1,), dtype=i32, device=dev),
                         torch.cumsum(padded, 0).to(i32)])
    tri_offsets = torch.cat([offsets, total.reshape(1).to(i32)])
    return SortedPairs(tri=tri_c, sorted_raw=order.to(i32), sorted_key=sorted_key,
                       dbits=dbits, raw_starts=raw_starts.contiguous(),
                       astarts=astarts, tile_counts=tile_counts.contiguous(), ma=ma,
                       align=align, tri_offsets=tri_offsets, num_pairs=num_pairs,
                       overflow=overflow)


@torch.no_grad()
def bin_triangles(prep: Preprocessed, settings: RasterSettings,
                  max_pairs: int, align: int = ALIGN,
                  depth_key: Optional[torch.Tensor] = None) -> Binning:
    """Expand triangles into depth-sorted per-tile pair lists, re-laid so
    every tile's range starts on an ``align`` boundary, and the owner-order
    map of the pairs (kernel B3, one launch)."""
    sp = sort_pairs(prep, settings, max_pairs, align, depth_key)
    pair_tri, pack_perm = relayout_pairs(*sp.relayout_args())
    return Binning(pair_tri=pair_tri, pair_valid=pair_tri >= 0,
                   tri_offsets=sp.tri_offsets, tile_starts=sp.astarts,
                   tile_counts=sp.tile_counts, num_pairs=sp.num_pairs,
                   overflow=sp.overflow, pack_perm=pack_perm)
