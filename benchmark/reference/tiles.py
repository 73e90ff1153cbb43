"""Plain tiled front-to-back compositing with autograd: the benchmark's
reference blend.

The semantics are those of the dense oracle
(``triangle_splatting_tpu_torch/ops/oracle.py``, frozen here as rules, not
as code): every primitive is composited over the pixels of the 32x32 tiles
its rect covers, front to back in the order of its quantized view depth
(ties by primitive index); an entry counts where its alpha test passes
(``cand``); a pixel stops after the entry that brings its transmittance to
1e-4 or below, and counts as contributors every entry it processed up to
that one. The oracle walks the primitives one at a time; here every tile's
list is evaluated densely as (tiles, list, pixels) tensors and the
transmittance is an exclusive ``cumprod`` along the list, in chunks of
tiles so that autograd's saved tensors fit. Gradients flow through alpha
wherever an entry counts (the stop set held fixed, as the oracle's
``where`` does).

Nothing here imports the program: the rules are restated, and the
quantities that decide membership (rects, depth order) are recomputed by
the caller's own preprocess.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

T_EPS = 1e-4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
TILE = 32


def depth_bits_for(num_tiles: int) -> int:
    """Bits of the quantized depth below the tile index in a 30-bit key."""
    tile_bits = max(int(num_tiles + 1).bit_length(), 1)
    return min(24, 30 - tile_bits)


def quantize_depth(depth: torch.Tensor, valid: torch.Tensor, bits: int) -> torch.Tensor:
    """Rank-preserving quantization of the valid primitives' view depths
    over their own range to ``bits`` bits (int32)."""
    inf = torch.full_like(depth, float("inf"))
    lo = torch.where(valid, depth, inf).amin()
    hi = torch.where(valid, depth, -inf).amax()
    lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    hi = torch.where(hi > lo, hi, lo + 1.0)
    maxq = (1 << bits) - 1
    q = torch.clamp((depth - lo) / (hi - lo) * maxq, 0, maxq)
    return torch.nan_to_num(q, nan=0.0).to(torch.int32)


@dataclass
class TilePlan:
    """The depth-sorted per-tile lists of one frame."""
    width: int
    height: int
    grid_w: int
    grid_h: int
    prim: torch.Tensor      # (pairs,) int64 primitive of each sorted entry
    starts: torch.Tensor    # (tiles,) int64
    counts: torch.Tensor    # (tiles,) int64

    @property
    def num_pairs(self) -> int:
        return int(self.prim.shape[0])


@torch.no_grad()
def plan_tiles(rect_min: torch.Tensor, rect_max: torch.Tensor, valid: torch.Tensor,
               depth: torch.Tensor, width: int, height: int) -> TilePlan:
    """Expand every valid primitive into (tile, primitive) entries over its
    rect, row-major, and sort them by (tile, quantized depth) with ties in
    primitive order."""
    dev = depth.device
    grid_w, grid_h = -(-width // TILE), -(-height // TILE)
    num_tiles = grid_w * grid_h
    dbits = depth_bits_for(num_tiles)
    dq = quantize_depth(depth, valid, dbits).to(torch.int64)
    rmin, rmax = rect_min.to(torch.int64), rect_max.to(torch.int64)
    rw = (rmax[:, 0] - rmin[:, 0]).clamp_min(0)
    rh = (rmax[:, 1] - rmin[:, 1]).clamp_min(0)
    cnt = torch.where(valid, rw * rh, torch.zeros_like(rw))
    prim = torch.repeat_interleave(torch.arange(depth.shape[0], device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    within = torch.arange(prim.shape[0], device=dev) - first[prim]
    w = rw[prim]
    tx = rmin[prim, 0] + within % w
    ty = rmin[prim, 1] + torch.div(within, w, rounding_mode="floor")
    tile = ty * grid_w + tx
    key = (tile << dbits) | dq[prim]
    order = torch.sort(key, stable=True).indices
    prim, tile = prim[order], tile[order]
    counts = torch.bincount(tile, minlength=num_tiles)
    starts = torch.cumsum(counts, 0) - counts
    return TilePlan(width, height, grid_w, grid_h, prim, starts, counts)


def chunk_tiles(plan: TilePlan, budget: int):
    """Groups of non-empty tiles, the longest lists first, each at most
    ``budget`` (tile, entry, pixel) elements once padded to its longest
    list (a list longer than the budget goes alone)."""
    counts = plan.counts
    nz = torch.nonzero(counts > 0).flatten()
    order = nz[torch.argsort(counts[nz], descending=True, stable=True)]
    lens = counts[order].tolist()
    npix = TILE * TILE
    groups, i = [], 0
    while i < len(lens):
        L = lens[i]
        n = max(1, budget // (L * npix))
        groups.append((order[i:i + n], L))
        i += n
    return groups


def tile_pixels(plan: TilePlan, tiles: torch.Tensor, dtype):
    """Pixel coordinates (nt, 1, 1024) of each tile's pixels and their
    inside-the-image mask."""
    dev = tiles.device
    lane = torch.arange(TILE * TILE, device=dev)
    x = (tiles % plan.grid_w)[:, None] * TILE + lane % TILE
    y = torch.div(tiles, plan.grid_w, rounding_mode="floor")[:, None] * TILE + lane // TILE
    inside = (x < plan.width) & (y < plan.height)
    return x, y, inside


def composite(alpha, cand, entry_ok, rgb, depth_val, nrm, background, bg_depth,
              kill_rule: bool = False):
    """Front-to-back blend of one chunk: alpha / cand (nt, L, npix), entry_ok
    (nt, L, 1) the real entries, rgb / nrm (nt, L, 3) per entry (nrm may be
    None), depth_val (nt, L, npix) or (nt, L, 1). Returns color (nt, 3,
    npix), depth (nt, npix), normal (nt, 3, npix) or None, final_T and
    n_contrib (nt, npix).

    The triangle rule composites the entry that brings T to 1e-4 or below
    and stops after it, counting every entry processed up to it; the
    Gaussian rule (``kill_rule``) skips the entry that would bring T below
    1e-4 and stops there, and counts up to the last composited entry's
    1-based list index."""
    one = torch.ones_like(alpha[:, :1])
    with torch.no_grad():
        a0 = torch.where(cand, alpha, torch.zeros_like(alpha))
        inc = torch.cumprod(1.0 - a0, 1)
        if kill_rule:
            eff = cand & (inc >= T_EPS)
            idx = torch.arange(1, alpha.shape[1] + 1, device=alpha.device)[None, :, None]
            n_contrib = torch.where(eff, idx, torch.zeros_like(idx)).amax(1)
        else:
            live = torch.cat([one, inc[:, :-1]], 1) > T_EPS
            eff = cand & live
            n_contrib = (entry_ok & live).sum(1)
    a = torch.where(eff, alpha, torch.zeros_like(alpha))
    w = 1.0 - a
    tex = torch.cat([one, torch.cumprod(w, 1)[:, :-1]], 1)
    contrib = a * tex
    final_t = tex[:, -1] * w[:, -1]
    color = torch.einsum("nlp,nlc->ncp", contrib, rgb) + final_t[:, None] * background[None, :, None]
    depth = (contrib * depth_val).sum(1) + final_t * bg_depth
    normal = None if nrm is None else torch.einsum("nlp,nlc->ncp", contrib, nrm)
    return color, depth, normal, final_t, n_contrib


def _scatter(img, vals, x, y, inside):
    """Write (nt, [C,] npix) values into an image (C, H, W) or (H, W)."""
    if img.dim() == 3:
        img[:, y[inside], x[inside]] = vals.permute(1, 0, 2)[:, inside]
    else:
        img[y[inside], x[inside]] = vals[inside]


def _gather(img, x, y, inside):
    """Read (nt, [C,] npix) values of an image at the tile pixels (0
    outside the image)."""
    xc, yc = x.clamp(max=img.shape[-1] - 1), y.clamp(max=img.shape[-2] - 1)
    if img.dim() == 3:
        v = img[:, yc, xc].permute(1, 0, 2)
        return torch.where(inside[:, None], v, torch.zeros_like(v))
    v = img[yc, xc]
    return torch.where(inside, v, torch.zeros_like(v))


def render(plan: TilePlan, chunk_fn, background, bg_depth, budget: int, with_normal: bool,
           kill_rule: bool = False):
    """Every tile's composite without gradient: color (3, H, W), depth (H,
    W), normal (3, H, W), final_T (H, W), n_contrib (H, W) int64.
    ``chunk_fn(prim_idx (nt, L), entry_ok (nt, L, 1), x, y (nt, 1, npix),
    inside)`` returns (alpha, cand, entry_ok, rgb, depth_val, nrm)."""
    H, W = plan.height, plan.width
    dev, dt = background.device, background.dtype
    color = background[:, None, None].expand(3, H, W).clone()
    depth = torch.full((H, W), float(bg_depth), dtype=dt, device=dev)
    normal = torch.zeros((3, H, W), dtype=dt, device=dev)
    final_t = torch.ones((H, W), dtype=dt, device=dev)
    n_contrib = torch.zeros((H, W), dtype=torch.int64, device=dev)
    with torch.no_grad():
        for tiles, L, args in _chunk_args(plan, budget):
            c, d, n, t, nc = composite(*chunk_fn(*args), background, bg_depth, kill_rule)
            x, y, inside = args[2][:, 0], args[3][:, 0], args[4]
            _scatter(color, c, x, y, inside)
            _scatter(depth, d, x, y, inside)
            if with_normal:
                _scatter(normal, n, x, y, inside)
            _scatter(final_t, t, x, y, inside)
            _scatter(n_contrib, nc, x, y, inside)
    return color, depth, normal, final_t, n_contrib


def backward(plan: TilePlan, chunk_fn, background, bg_depth, budget: int,
             g_color, g_depth, g_normal, kill_rule: bool = False):
    """Recompute every chunk with autograd and push the image cotangents
    (g_normal may be None) into the leaves ``chunk_fn`` reads."""
    for tiles, L, args in _chunk_args(plan, budget):
        c, d, n, _, _ = composite(*chunk_fn(*args), background, bg_depth, kill_rule)
        x, y, inside = args[2][:, 0], args[3][:, 0], args[4]
        outs = [c, d]
        cots = [_gather(g_color, x, y, inside), _gather(g_depth, x, y, inside)]
        if g_normal is not None and n is not None:
            outs.append(n)
            cots.append(_gather(g_normal, x, y, inside))
        torch.autograd.backward(outs, cots)


def _chunk_args(plan: TilePlan, budget: int):
    dev = plan.prim.device
    for tiles, L in chunk_tiles(plan, budget):
        ar = torch.arange(L, device=dev)
        cnt = plan.counts[tiles]
        entry_ok = ar[None, :] < cnt[:, None]
        pos = torch.where(entry_ok, plan.starts[tiles][:, None] + ar[None, :],
                          torch.zeros_like(ar)[None, :])
        prim = torch.where(entry_ok, plan.prim[pos], torch.zeros_like(pos))
        x, y, inside = tile_pixels(plan, tiles, torch.float32)
        yield tiles, L, (prim, entry_ok[..., None], x[:, None, :], y[:, None, :], inside)
