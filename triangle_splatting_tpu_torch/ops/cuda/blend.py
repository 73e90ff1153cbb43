"""Kernels B1 (``blend_forward``) and B2 (``blend_backward``): the tile
alpha blend of the triangle rasterizers and of the Gaussian renderer.

Ports of ``triangle_splatting_tpu/ops/pallas/blend.py`` for the variants
``"2D"`` and ``"3D"`` (triangles) and ``"GS"`` (Gaussians), each with rich
info (the depth and normal outputs and their cotangents) off or on, the
forward also with the per-pair contribution stream (``stats``) of the ADC
statistic window: four forward forms per variant (rich info with the
stream is what the renderer facades run with ``rich_info=True``). The CUDA
kernels are in ``csrc/blend.cu`` ("2D", "3D") and ``csrc/blend_gs.cu``
("GS"). Each wrapper takes the kernel for CUDA tensors and the plain
PyTorch version beside it for CPU tensors; there is no fallback from one
to the other. ``<wrapper>.launches`` counts the kernel launches per form:
the variant, then ``"_rich"`` with rich info and ``"_stats"`` with the
stream (``"3D_stats"``, ``"2D_rich"``, ``"GS_rich_stats"``).

Layout contract (shared with ``ops/binning.py``): ``pairs`` is the
field-major (16, MP) float32 buffer, tile t owns slots
[tile_starts[t], tile_starts[t] + tile_counts[t]) of it, and tile starts
are multiples of ``ALIGN``. ``params`` is (8,) float32
[gamma, bg_r, bg_g, bg_b, bg_depth, sx, sy, 0].

Fields per pair: "2D" a1 = f0 + f1*px + f2*py, a2 from f3..f5, opacity 6,
rgb 7..9, and for rich info d0 10, normal 11..13, d1 14, d2 15 (depth
d0 + d1*a1 + d2*a2); "3D" D = f0 + f1*px + f2*py, a1 = (f3 + f4*px +
f5*py) / D, a2 = (f6 + f7*px + f8*py) / D, opacity 9, rgb 10..12, and for
rich info K 13 (ray depth K / D; the raw normal is
(sx*N1, sy*N2, N0 - cW*N1 - cH*N2) of N = sum contrib * (f0, f1, f2),
cW = (1 - W) / 2, cH = (1 - H) / 2); "GS" the center X 0, Y 1, the conic
a 2, b 3, c 4, opacity 6, rgb 7..9 and the view depth 10, with
q = a*dx^2 + 2b*dx*dy + c*dy^2 at dx = X - px, dy = Y - py.

"GS" follows the Gaussian rasterizer's semantics: the entry that would
push T below T_EPS is not composited and ends the pixel, and n_contrib is
the 1-based index of the last composited entry, not a count.
"""

from __future__ import annotations

import torch

from .build import check_launch, library
from .streams import _check, _stream

NUM_FIELDS = 16
ALIGN = 128           # alignment of per-tile pair ranges (binning)
SLAB = 128            # slab of the TPU kernels; sizes the buffer tail pad
T_EPS = 1e-4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
ECC_MAX = 10.0

# Count of leading per-pair gradient rows that can be nonzero, per
# (variant, rich) — the pack backward sorts only these rows.
LIVE_GRAD_ROWS = {
    ("2D", True): 16, ("2D", False): 10,
    ("3D", True): 14, ("3D", False): 13,
    ("GS", True): 11, ("GS", False): 10,
}


VARIANTS = ("2D", "3D", "GS")
# per variant: (index of the opacity field, of the first rgb field)
_OPAC_RGB = {"2D": (6, 7), "3D": (9, 10), "GS": (6, 7)}


def _require_ported_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise NotImplementedError(
            f"blend kernels: only variants {VARIANTS} are ported (got variant={variant!r})")


def _form(variant: str, stats: bool = False, rich: bool = False) -> str:
    """Launch-count key of a form: "3D", "3D_stats", "3D_rich" or
    "GS_rich_stats"."""
    return variant + ("_rich" if rich else "") + ("_stats" if stats else "")


def _normal_3d(N: torch.Tensor, params: torch.Tensor, width: int, height: int):
    """(3, ...) raw normal sum N of the D rows -> the "3D" rich normal
    (sx*N1, sy*N2, N0 - cW*N1 - cH*N2)."""
    cW, cH = (1.0 - width) / 2.0, (1.0 - height) / 2.0
    return torch.stack([params[5] * N[1], params[6] * N[2],
                        N[0] - cW * N[1] - cH * N[2]])


def _grid(image_width: int, image_height: int, tile_h: int, tile_w: int):
    npix = tile_h * tile_w
    if npix % 32 != 0 or npix > 1024:
        raise ValueError(f"tile_h * tile_w must be a multiple of 32 and at most "
                         f"1024, got {npix}")
    grid_w = (image_width + tile_w - 1) // tile_w
    grid_h = (image_height + tile_h - 1) // tile_h
    return grid_w, grid_h


def _check_inputs(pairs, tile_starts, tile_counts, params, num_tiles):
    dev = pairs.device
    _check(pairs, "pairs", pairs.dtype, 2, dev)
    if pairs.dtype not in (torch.float32, torch.float64) or pairs.shape[0] != NUM_FIELDS:
        raise ValueError(f"pairs must be (16, MP) float, got {tuple(pairs.shape)} "
                         f"{pairs.dtype}")
    _check(tile_starts, "tile_starts", torch.int32, 1, dev)
    _check(tile_counts, "tile_counts", torch.int32, 1, dev)
    _check(params, "params", params.dtype, 1, dev)
    if tile_counts.shape[0] != num_tiles or tile_starts.shape[0] != num_tiles + 1:
        raise ValueError(f"expected {num_tiles} tiles, got counts "
                         f"{tuple(tile_counts.shape)} starts {tuple(tile_starts.shape)}")
    if params.shape[0] != 8:
        raise ValueError("params must be (8,)")
    return dev


def alpha_terms_plain(f: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                      gamma: torch.Tensor, in_range: torch.Tensor,
                      variant: str = "2D"):
    """blend.py ``_alpha_terms`` on (n,) field rows against (npix,) pixel
    coordinates -> (n, npix) terms, in the kernels' evaluation order.
    ``invD`` is the reciprocal plane denominator for "3D", None for "2D"."""
    col = lambda k: f[k][:, None]  # noqa: E731
    if variant == "2D":
        a1 = col(0) + col(1) * px + col(2) * py
        a2 = col(3) + col(4) * px + col(5) * py
        invD = None
    else:
        D = col(0) + col(1) * px + col(2) * py
        okD = torch.abs(D) >= 1e-8                 # |ray . n| guard
        invD = 1.0 / torch.where(okD, D, torch.ones_like(D))
        a1 = (col(3) + col(4) * px + col(5) * py) * invD
        a2 = (col(6) + col(7) * px + col(8) * py) * invD
        in_range = in_range & okD
    a3 = 1.0 - a1 - a2
    mn = torch.minimum(torch.minimum(a1, a2), a3)
    ecc = 1.0 - 3.0 * mn
    ok = (ecc >= 0.0) & (ecc <= ECC_MAX) & in_range
    eccs = torch.clamp_min(ecc, 0.0)
    powed = torch.where(
        gamma == 1.0, eccs * eccs,
        torch.exp(torch.clamp((2.0 * gamma) * torch.log(eccs), -87.0, 44.0)))
    expp = torch.exp(-0.5 * powed)
    alpha_un = col(_OPAC_RGB[variant][0]) * expp
    alpha = torch.clamp_max(alpha_un, ALPHA_MAX)
    ok = ok & (alpha >= ALPHA_MIN)
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
    return a1, a2, a3, eccs, expp, alpha_un, alpha, ok, invD


def _falloff_bound(opac: torch.Tensor, gamma: float, power: float) -> torch.Tensor:
    """(2 ln(opac / ALPHA_MIN) + 2e-3) ** power * (1 + 1e-5) in float64,
    rounded to float32: -1 where the opacity is below ALPHA_MIN, +inf for
    gamma <= 0 and NaN opacities."""
    o = opac.to(torch.float64)
    amin = float(torch.tensor(ALPHA_MIN, dtype=torch.float32))
    inf = torch.full_like(o, float("inf"))
    if not float(gamma) > 0.0:
        return inf.to(torch.float32)
    c = 2.0 * torch.log(o / amin) + 2e-3
    bound = c.clamp_min(0.0) ** power * (1.0 + 1e-5)
    bound = torch.where(o >= amin, bound, torch.full_like(o, -1.0))
    return torch.where(torch.isnan(o), inf, bound).to(torch.float32)


def ecc_bound_plain(opac: torch.Tensor, gamma: float) -> torch.Tensor:
    """``ecc_bound`` of ``csrc/blend.cu`` on (n,) opacities: the largest
    ecc at which an entry can still reach alpha >= ALPHA_MIN at ``gamma``
    (past it ecc^(2 gamma) >= 2 ln(opac / ALPHA_MIN) + 2e-3, a margin over
    every rounding of the falloff; then a relative 1e-5 for the bound's
    own), in float64 rounded to float32: -1 where the opacity is below
    ALPHA_MIN, +inf for gamma <= 0 and NaN opacities."""
    return _falloff_bound(opac, gamma, 0.5 / float(gamma) if float(gamma) > 0 else 1.0)


def q_bound_plain(opac: torch.Tensor, gamma: float) -> torch.Tensor:
    """``q_bound`` of ``csrc/blend_gs.cu``, "GS"'s twin of
    ``ecc_bound_plain``: the largest q at which an entry can still reach
    alpha >= ALPHA_MIN (past it q^gamma >= 2 ln(opac / ALPHA_MIN) + 2e-3)."""
    return _falloff_bound(opac, gamma, 1.0 / float(gamma) if float(gamma) > 0 else 1.0)


def falloff_pretest_plain(eccs: torch.Tensor, opac: torch.Tensor, gamma: float) -> torch.Tensor:
    """B1's and B2's falloff pre-test on the (n, npix) ``eccs`` of entries
    of (n,) opacities ("2D" and "3D"): True where the falloff is evaluated,
    the ecc within the entry's ``ecc_bound_plain``. A warp skips an entry
    where this is False at each of its live pixels: alpha is 0 at all of
    them, since an ecc out of range gives alpha 0 too."""
    return eccs <= ecc_bound_plain(opac, gamma)[:, None]


CULL_MARGIN = 2e-5    # csrc/blend.cu kCullMargin


def box_cull_plain(f: torch.Tensor, boxes: torch.Tensor, bound: torch.Tensor,
                   variant: str = "2D") -> torch.Tensor:
    """B1's per-warp cull ("2D", "3D"; ``box_may_hit`` of ``csrc/blend.cu``,
    in its float32 operations): for (16, n) field columns, (k, 4) boxes
    [x0, x1, y0, y1] of pixel coordinates (>= 0) and the (n,) entries'
    ``ecc_bound_plain``, (n, k) False only where no pixel of the box can
    have an ecc within the bound. Every pixel's ecc is at least
    1 - 3 min_i max a_i over the box's corners (the barycentrics are affine
    in "2D"; in "3D" ratios of affine forms, taken only where D keeps its
    sign over the box and stays clear of 0 against its terms), less
    CULL_MARGIN times the magnitude of the terms (in "3D" over min |D|) for
    the roundings. A NaN anywhere culls nothing."""
    col = lambda k: f[k][:, None]  # noqa: E731
    x0, x1, y0, y1 = (boxes[:, i][None, :] for i in range(4))

    def affine(c0, cx, cy, px, py):
        return (c0 + cx * px) + cy * py

    def magnitude(c0, cx, cy):
        return (c0.abs() + cx.abs() * x1) + cy.abs() * y1

    if variant == "3D":
        g = [(col(i) - col(i + 3)) - col(i + 6) for i in range(3)]     # A3 = D - A1 - A2
        corners = [(x1 if c & 1 else x0, y1 if c & 2 else y0) for c in range(4)]
        D = torch.stack([affine(col(0), col(1), col(2), px, py) for px, py in corners])
        inv = 1.0 / D
        a = torch.stack([torch.stack([affine(col(3), col(4), col(5), px, py),
                                      affine(col(6), col(7), col(8), px, py),
                                      affine(*g, px, py)]) for px, py in corners])
        a = a * inv[:, None]                                           # (4, 3, n, k)
        hi = a.amax(dim=0)
        amax = a.abs().amax(dim=(0, 1))
        dabs = D.abs().amin(dim=0)
        sd = magnitude(col(0), col(1), col(2))
        sa = magnitude(col(3), col(4), col(5)) + magnitude(col(6), col(7), col(8))
        sign_kept = ((D.amin(dim=0) > 0) | (D.amax(dim=0) < 0)) & (dabs > 1e-3 * sd)
        r = (((sd + sa) * (1.0 + amax)) / dabs + amax) + 1.0
        m = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
    else:
        def box_max(c0, cx, cy):
            return (c0 + torch.maximum(cx * x0, cx * x1)) + torch.maximum(cy * y0, cy * y1)
        g0 = (1.0 - col(0)) - col(3)                                  # a3 = 1 - a1 - a2
        g1, g2 = -(col(1) + col(4)), -(col(2) + col(5))
        m = torch.minimum(torch.minimum(box_max(col(0), col(1), col(2)),
                                        box_max(col(3), col(4), col(5))), box_max(g0, g1, g2))
        r = (1.0 + magnitude(col(0), col(1), col(2))) + magnitude(col(3), col(4), col(5))
        sign_kept = torch.ones_like(m, dtype=torch.bool)
    lower = (1.0 - 3.0 * m) - CULL_MARGIN * r
    return ~(sign_kept & (lower > bound[:, None]))


def box_cull_gs_plain(f: torch.Tensor, boxes: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """B1-GS's per-warp cull (``box_may_hit_gs`` of ``csrc/blend_gs.cu``, in
    its float32 operations): for (16, n) field columns, (k, 4) boxes
    [x0, x1, y0, y1] and the (n,) entries' ``q_bound_plain``, (n, k) False
    only where no pixel of the box can have q within the bound: q >= lambda
    |d|^2 with lambda the conic's smaller eigenvalue and |d| at least the
    center's distance to the box, less CULL_MARGIN times |a| + |b| + |c| on
    lambda and against the farthest corner's |d|^2. A NaN anywhere culls
    nothing."""
    col = lambda k: f[k][:, None]  # noqa: E731
    x0, x1, y0, y1 = (boxes[:, i][None, :] for i in range(4))
    X, Y, a, b, c = (col(k) for k in range(5))
    zero = torch.zeros((), dtype=f.dtype)
    ex = torch.maximum(torch.maximum(x0 - X, X - x1), zero)
    ey = torch.maximum(torch.maximum(y0 - Y, Y - y1), zero)
    fx = torch.maximum((X - x0).abs(), (X - x1).abs())
    fy = torch.maximum((Y - y0).abs(), (Y - y1).abs())
    near2, far2 = ex * ex + ey * ey, fx * fx + fy * fy
    h = 0.5 * (a - c)
    lam = 0.5 * (a + c) - torch.sqrt(h * h + b * b)
    mag = CULL_MARGIN * ((a.abs() + b.abs()) + c.abs())
    lower = (lam - mag) * near2 - mag * far2
    return ~(lower > bound[:, None])


def alpha_terms_gs_plain(f: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                         gamma: torch.Tensor, in_range: torch.Tensor):
    """blend.py ``_alpha_terms_gs`` on (n,) field rows against (npix,) pixel
    coordinates -> (n, npix) terms (qs, dx, dy, expp, alpha_un, alpha, ok)
    in the kernels' evaluation order."""
    col = lambda k: f[k][:, None]  # noqa: E731
    dx = col(0) - px
    dy = col(1) - py
    q = col(2) * dx * dx + 2.0 * col(3) * dx * dy + col(4) * dy * dy
    ok = (q >= 0.0) & in_range
    qs = torch.clamp_min(q, 1e-30)
    power = torch.where(
        gamma == 1.0, -0.5 * qs,
        -0.5 * torch.exp(torch.clamp(gamma * torch.log(qs), -87.0, 44.0)))
    expp = torch.exp(torch.clamp_max(power, 0.0))
    alpha_un = col(6) * expp
    alpha = torch.clamp_max(alpha_un, ALPHA_MAX)
    ok = ok & (alpha >= ALPHA_MIN)
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
    return qs, dx, dy, expp, alpha_un, alpha, ok


def _tile_pixels(t: int, grid_w: int, tile_h: int, tile_w: int, dtype, dev):
    ty, tx = divmod(t, grid_w)
    lane = torch.arange(tile_h * tile_w, device=dev)
    px = (tx * tile_w + lane % tile_w).to(dtype)
    py = (ty * tile_h + lane // tile_w).to(dtype)
    return px, py


def _untile(x: torch.Tensor, grid_h: int, grid_w: int, tile_h: int,
            tile_w: int, H: int, W: int) -> torch.Tensor:
    """(..., T, npix) tile-major -> (..., H, W)."""
    lead = x.shape[:-2]
    x = x.reshape(lead + (grid_h, grid_w, tile_h, tile_w)).transpose(-3, -2)
    return x.reshape(lead + (grid_h * tile_h, grid_w * tile_w))[..., :H, :W].contiguous()


def _tile(x: torch.Tensor, grid_h: int, grid_w: int, tile_h: int,
          tile_w: int) -> torch.Tensor:
    """(..., H, W) -> (..., T, npix) tile-major, zero padded."""
    H, W = x.shape[-2:]
    pad = (0, grid_w * tile_w - W, 0, grid_h * tile_h - H)
    x = torch.nn.functional.pad(x, pad)
    lead = x.shape[:-2]
    x = x.reshape(lead + (grid_h, tile_h, grid_w, tile_w)).transpose(-3, -2)
    return x.reshape(lead + (grid_h * grid_w, tile_h * tile_w))


# ---------------------------------------------------------------------------
# B1 blend_forward
# ---------------------------------------------------------------------------

def blend_forward_plain(pairs, tile_starts, tile_counts, params, *,
                        image_width: int, image_height: int, tile_h: int,
                        tile_w: int, variant: str = "2D", stats: bool = False,
                        rich: bool = False):
    """Plain PyTorch B1: per tile, the dense (n_pairs, npix) alpha matrix
    and an exclusive ``cumprod`` of (1 - alpha) along the pairs (a scan
    over a non-innermost dimension, evaluated sequentially, so its
    roundings are the kernel's). With ``stats`` the per-pair stream is
    the sum and the max over the tile's pixels of the ``contrib`` matrix,
    zeros in every slot that holds no pair. With ``rich`` the depth and
    normal rows are products of their fields with the ``contrib`` matrix,
    as the color ("GS": the depth of field 10, the normal zero). "GS"
    stops each pixel before its kill entry and gives the index of its last
    composited entry as n_contrib. Works in the dtype of ``pairs``."""
    grid_w, grid_h = _grid(image_width, image_height, tile_h, tile_w)
    dev, dt = pairs.device, pairs.dtype
    n_tiles, npix = grid_w * grid_h, tile_h * tile_w
    gamma, bg, bg_depth = params[0], params[1:4], params[4]
    rgb0 = _OPAC_RGB[variant][1]
    starts = tile_starts.tolist()
    counts = tile_counts.tolist()
    color, depth_acc, normal = [], [], []
    final_t = []
    ncon = []
    pair_contrib = torch.zeros((2, pairs.shape[1]), dtype=dt, device=dev) if stats else None
    for t in range(n_tiles):
        px, py = _tile_pixels(t, grid_w, tile_h, tile_w, dt, dev)
        T0 = ((px < image_width) & (py < image_height)).to(dt)
        n = counts[t]
        if n == 0:
            color.append(torch.zeros((3, npix), dtype=dt, device=dev))
            depth_acc.append(torch.zeros((npix,), dtype=dt, device=dev))
            normal.append(torch.zeros((3, npix), dtype=dt, device=dev))
            final_t.append(T0)
            ncon.append(torch.zeros((npix,), dtype=torch.int32, device=dev))
            continue
        f = pairs[:, starts[t]:starts[t] + n]
        in_range = torch.ones((n, 1), dtype=torch.bool, device=dev)
        if variant == "GS":
            *_, alpha, ok = alpha_terms_gs_plain(f, px, py, gamma, in_range)
        else:
            a1, a2, _, _, _, _, alpha, _, invD = alpha_terms_plain(f, px, py, gamma,
                                                                   in_range, variant)
        scan = torch.cumprod(torch.cat([T0[None], 1.0 - alpha], dim=0), dim=0)
        T_excl, T_incl = scan[:-1], scan[1:]
        if variant == "GS":
            # the kill entry (T_incl < T_EPS) is not composited, and the
            # product past it stays below T_EPS: alive is the composited
            # prefix (and the skipped entries inside it)
            alive = T_incl >= T_EPS
        else:
            alive = T_excl > T_EPS
        contrib = torch.where(alive, alpha * T_excl, torch.zeros_like(alpha))
        if stats:
            pair_contrib[0, starts[t]:starts[t] + n] = contrib.sum(dim=1)
            pair_contrib[1, starts[t]:starts[t] + n] = contrib.amax(dim=1)
        color.append(f[rgb0:rgb0 + 3] @ contrib)
        if rich and variant == "GS":
            depth_acc.append(f[10] @ contrib)
            normal.append(torch.zeros((3, npix), dtype=dt, device=dev))
        elif rich and variant == "3D":
            depth_acc.append(f[13] @ (contrib * invD))
            normal.append(_normal_3d(f[0:3] @ contrib, params, image_width, image_height))
        elif rich:
            depth_acc.append(f[10] @ contrib + f[14] @ (contrib * a1)
                             + f[15] @ (contrib * a2))
            normal.append(f[11:14] @ contrib)
        T_min = torch.where(alive, T_incl, torch.full_like(T_incl, 2.0)).amin(dim=0)
        final_t.append(torch.minimum(T0, T_min))
        if variant == "GS":
            # 1-based index of the last composited entry
            idx1 = torch.arange(1, n + 1, dtype=torch.int32, device=dev)[:, None]
            ncon.append(torch.where(alive & ok, idx1, torch.zeros_like(idx1)).amax(dim=0))
        else:
            ncon.append(alive.sum(dim=0).to(torch.int32))
    color = torch.stack(color, dim=1)                      # (3, T, npix)
    final_t = torch.stack(final_t)                         # (T, npix)
    ncon = torch.stack(ncon)
    color = color + final_t[None] * bg[:, None, None]
    depth = final_t * bg_depth
    geo = (grid_h, grid_w, tile_h, tile_w, image_height, image_width)
    if rich:
        depth = torch.stack(depth_acc) + depth
        normal = _untile(torch.stack(normal, dim=1), *geo)
    else:
        normal = torch.zeros((3, image_height, image_width), dtype=dt, device=dev)
    out = (_untile(color, *geo), _untile(depth, *geo), normal,
           _untile(final_t, *geo), _untile(ncon, *geo))
    return out + (pair_contrib,) if stats else out


def blend_forward(pairs: torch.Tensor, tile_starts: torch.Tensor,
                  tile_counts: torch.Tensor, params: torch.Tensor, *,
                  image_width: int, image_height: int, tile_h: int,
                  tile_w: int, rich: bool = False, variant: str = "2D",
                  stats: bool = False, order: torch.Tensor | None = None):
    """Forward tile blend.

    Returns color (3, H, W), depth (H, W) (accumulated depth + final_T *
    bg_depth; final_T * bg_depth with rich off), normal (3, H, W) (the
    raw accumulated normal; zeros with rich off), final_T (H, W) and
    n_contrib (H, W) int32: the count of entries each pixel iterated while
    its exclusive transmittance stayed above T_EPS ("GS": the 1-based index
    of its last composited entry). With ``stats`` a sixth output,
    pair_contrib (2, MP): per pair slot the sum (row 0) and the max (row 1)
    over the tile's pixels of alpha * T_excl of the composited entries,
    zeros in slots that hold no pair or that the tile never reached. The
    first five outputs do not depend on ``stats``, and color, final_T and
    n_contrib not on ``rich``. ``order`` is the order in which the kernel's
    blocks take the tiles, a permutation of them (``tile_order``'s, computed
    here when None); no output depends on it. The card does not check that
    it is a permutation (that would wait for the card): a tile it leaves out
    keeps uninitialised outputs. The plain version reads no order, and the
    CPU path only checks a given one.
    """
    _require_ported_variant(variant)
    grid_w, grid_h = _grid(image_width, image_height, tile_h, tile_w)
    dev = _check_inputs(pairs, tile_starts, tile_counts, params, grid_w * grid_h)
    if order is not None:
        _check_order(order, tile_counts)
    kw = dict(image_width=image_width, image_height=image_height,
              tile_h=tile_h, tile_w=tile_w, variant=variant, stats=stats, rich=rich)
    if dev.type == "cpu":
        return blend_forward_plain(pairs, tile_starts, tile_counts, params, **kw)
    if dev.type != "cuda":
        raise ValueError(f"blend_forward: unsupported device {dev}")
    if pairs.dtype != torch.float32 or params.dtype != torch.float32:
        raise TypeError("blend_forward: the CUDA kernel takes float32 pairs/params")
    if order is None:
        order = tile_order(tile_counts)
    H, W = image_height, image_width
    color = torch.empty((3, H, W), dtype=torch.float32, device=dev)
    depth = torch.empty((H, W), dtype=torch.float32, device=dev)
    normal = torch.empty((3, H, W), dtype=torch.float32, device=dev)
    final_t = torch.empty((H, W), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((H, W), dtype=torch.int32, device=dev)
    # every slot is written by the kernel (zeros where no pair contributes)
    pair_contrib = (torch.empty((2, pairs.shape[1]), dtype=torch.float32, device=dev)
                    if stats else None)
    head = (pairs.data_ptr(), pairs.shape[1], tile_starts.data_ptr(),
            tile_counts.data_ptr(), order.data_ptr(), params.data_ptr(), W, H, tile_w,
            tile_h, grid_w, grid_w * grid_h)
    tail = (color.data_ptr(), depth.data_ptr(), normal.data_ptr(),
            final_t.data_ptr(), n_contrib.data_ptr(),
            pair_contrib.data_ptr() if stats else None, _stream())
    blend_forward.launches[_form(variant, stats, rich)] += 1
    if variant == "GS":
        code = library("blend_gs").ts_blend_forward_gs(*head, int(stats), int(rich), *tail)
    else:
        code = library("blend").ts_blend_forward(*head, int(variant == "3D"), int(stats),
                                                 int(rich), *tail)
    check_launch(code, "blend_forward")
    out = (color, depth, normal, final_t, n_contrib)
    return out + (pair_contrib,) if stats else out


blend_forward.launches = dict.fromkeys(
    (_form(v, s, r) for s, r in ((False, False), (True, False), (False, True), (True, True))
     for v in VARIANTS), 0)


# ---------------------------------------------------------------------------
# B2 blend_backward
# ---------------------------------------------------------------------------

def blend_backward_plain(pairs, tile_starts, tile_counts, params, final_T,
                         n_contrib, g_color, g_final_T, g_depth=None, g_normal=None,
                         *, image_width: int, image_height: int, tile_h: int,
                         tile_w: int, variant: str = "2D", rich: bool = False):
    """Plain PyTorch B2: the explicit back-to-front recurrence, per tile,
    written with tensors over the (n_pairs, npix) matrix.

    T is rebuilt from final_T by multiplying the reciprocals 1/(1 - alpha)
    back to front, and the suffix sum A of later entries' contributions is
    a ``cumsum`` over the reversed entries seeded with the background term;
    both scans run over a non-innermost dimension, so they are sequential
    with the kernel's roundings. Only the sum over a tile's pixels is
    ordered differently from the kernel. "3D" chains the barycentric
    gradients through the quotients a = A / D into the D, A1 and A2
    coefficient rows. With ``rich`` the depth and normal cotangents
    ``g_depth`` (H, W) and ``g_normal`` (3, H, W) enter gdot, the
    background term and their own rows ("3D": the normal's through the D
    rows). "GS" takes the depth cotangent only; its rows are X, Y, a, b,
    c, 0, opacity, rgb and with rich info the depth, through q = a*dx^2 +
    2b*dx*dy + c*dy^2 over each pixel's entries before its n_contrib."""
    grid_w, grid_h = _grid(image_width, image_height, tile_h, tile_w)
    dev, dt = pairs.device, pairs.dtype
    n_tiles = grid_w * grid_h
    gamma, bg = params[0], params[1:4]
    rgb0 = _OPAC_RGB[variant][1]
    live_rows = LIVE_GRAD_ROWS[(variant, rich)]
    tl = lambda x: _tile(x, grid_h, grid_w, tile_h, tile_w)  # noqa: E731
    fT, nc, gcol, gft = tl(final_T), tl(n_contrib), tl(g_color), tl(g_final_T)
    if rich:
        gdep = tl(g_depth)
        gnrm = None if variant == "GS" else tl(g_normal)
        if variant == "3D":
            # the normal cotangent against the raw D-row sums N0, N1, N2
            cW, cH = (1.0 - image_width) / 2.0, (1.0 - image_height) / 2.0
            gnrm = torch.stack([gnrm[2], params[5] * gnrm[0] - cW * gnrm[2],
                                params[6] * gnrm[1] - cH * gnrm[2]])
    starts = tile_starts.tolist()
    counts = tile_counts.tolist()
    nc_eff = torch.minimum(nc, tile_counts[:, None])
    jmax = nc_eff.amax(dim=1).tolist()
    out = torch.zeros_like(pairs)
    for t in range(n_tiles):
        n = min(jmax[t], counts[t])
        if n == 0:
            continue
        px, py = _tile_pixels(t, grid_w, tile_h, tile_w, dt, dev)
        f = pairs[:, starts[t]:starts[t] + n]
        gr, gg, gb = gcol[0, t], gcol[1, t], gcol[2, t]
        processed = torch.arange(n, device=dev)[:, None] < nc_eff[t][None, :]
        if variant == "GS":
            qs, dx, dy, expp, alpha_un, alpha, ok = alpha_terms_gs_plain(
                f, px, py, gamma, processed)
        else:
            a1, a2, a3, eccs, expp, alpha_un, alpha, ok, invD = alpha_terms_plain(
                f, px, py, gamma, processed, variant)
        inv1m = 1.0 / (1.0 - alpha)
        scan_t = torch.cumprod(torch.cat([fT[t][None], inv1m.flip(0)]), dim=0)
        T = scan_t[1:].flip(0)                               # exclusive T
        contrib = alpha * T
        gdot = (f[rgb0][:, None] * gr + f[rgb0 + 1][:, None] * gg
                + f[rgb0 + 2][:, None] * gb)
        bg_dot = bg[0] * gr + bg[1] * gg + bg[2] * gb + gft[t]
        if rich:
            gd = gdep[t]
            gn = None if gnrm is None else gnrm[:, t]
            if variant == "GS":
                gdot = gdot + f[10][:, None] * gd
            elif variant == "3D":
                tr = f[13][:, None] * invD                   # ray depth K / D
                gdot = (gdot + tr * gd + f[0][:, None] * gn[0]
                        + f[1][:, None] * gn[1] + f[2][:, None] * gn[2])
            else:
                d = f[10][:, None] + f[14][:, None] * a1 + f[15][:, None] * a2
                gdot = (gdot + d * gd + f[11][:, None] * gn[0]
                        + f[12][:, None] * gn[1] + f[13][:, None] * gn[2])
            bg_dot = bg_dot + params[4] * gd
        scan_a = torch.cumsum(torch.cat([(fT[t] * bg_dot)[None],
                                         (contrib * gdot).flip(0)]), dim=0)
        A = scan_a[:-1].flip(0)                              # later entries
        dL_da = T * gdot - A * inv1m
        live = torch.where(ok & (alpha_un < ALPHA_MAX), dL_da,
                           torch.zeros_like(dL_da))
        d_opac = live * expp
        if variant == "GS":
            rows = _gs_rows(f, qs, dx, dy, alpha_un, live, d_opac, contrib, gamma,
                            gr, gg, gb, gd if rich else None)
            out[:live_rows, starts[t]:starts[t] + n] = torch.stack([r.sum(dim=1) for r in rows])
            continue
        ecc_pow = torch.where(
            gamma == 1.0, eccs,
            torch.exp(torch.clamp((2.0 * gamma - 1.0) * torch.log(eccs),
                                  -87.0, 44.0)))
        dL_decc = live * alpha_un * (-gamma) * ecc_pow
        is1 = (a1 <= a2) & (a1 <= a3)
        is2 = ~is1 & (a2 <= a3)
        is3 = ~(is1 | is2)
        d_ecc3 = 3.0 * dL_decc
        s3 = torch.where(is3, d_ecc3, torch.zeros_like(d_ecc3))
        da1 = torch.where(is1, -d_ecc3, s3)
        da2 = torch.where(is2, -d_ecc3, s3)
        if rich and variant == "2D":
            cgd = contrib * gd
            da1 = da1 + cgd * f[14][:, None]
            da2 = da2 + cgd * f[15][:, None]
        if variant == "2D":
            affine = [da1, da2]
        else:
            dD = -(da1 * a1 + da2 * a2) * invD
            if rich:
                dD = dD - gd * contrib * tr * invD
            affine = [dD, da1 * invD, da2 * invD]
        rows = [r for g in affine for r in (g, g * px, g * py)]
        if rich and variant == "3D":
            rows[0:3] = [r + contrib * g for r, g in zip(rows[0:3], gn)]
        rows += [d_opac, contrib * gr, contrib * gg, contrib * gb]
        if rich and variant == "3D":
            rows += [contrib * invD * gd]
        elif rich:
            rows += [contrib * gd, contrib * gn[0], contrib * gn[1], contrib * gn[2],
                     contrib * a1 * gd, contrib * a2 * gd]
        out[:live_rows, starts[t]:starts[t] + n] = torch.stack(
            [r.sum(dim=1) for r in rows])
    return out


def _gs_rows(f, qs, dx, dy, alpha_un, live, d_opac, contrib, gamma, gr, gg, gb, gd):
    """Per-(pair, pixel) gradient rows of "GS" (Pallas blend.py :801-833):
    GX, GY, GA, GB, GC2 through dL/dq, a zero row, opacity, rgb, and with
    the depth cotangent ``gd`` the depth row."""
    col = lambda k: f[k][:, None]  # noqa: E731
    dpow_dq = torch.where(
        gamma == 1.0, torch.full_like(qs, -0.5),
        -0.5 * gamma * torch.exp(torch.clamp((gamma - 1.0) * torch.log(qs), -87.0, 44.0)))
    dL_dq = live * alpha_un * dpow_dq
    gdx = dL_dq * dx
    gdy = dL_dq * dy
    rows = [2.0 * col(2) * gdx + 2.0 * col(3) * gdy,       # X
            2.0 * col(3) * gdx + 2.0 * col(4) * gdy,       # Y
            gdx * dx, 2.0 * gdx * dy, gdy * dy,            # a, b, c
            torch.zeros_like(gdx), d_opac,
            contrib * gr, contrib * gg, contrib * gb]
    if gd is not None:
        rows.append(contrib * gd)
    return rows


def blend_backward(pairs: torch.Tensor, tile_starts: torch.Tensor,
                   tile_counts: torch.Tensor, params: torch.Tensor,
                   final_T: torch.Tensor, n_contrib: torch.Tensor,
                   g_color: torch.Tensor, g_final_T: torch.Tensor | None = None,
                   g_depth: torch.Tensor | None = None,
                   g_normal: torch.Tensor | None = None,
                   *, image_width: int, image_height: int, tile_h: int,
                   tile_w: int, rich: bool = False, variant: str = "2D",
                   order: torch.Tensor | None = None) -> torch.Tensor:
    """Backward tile blend: per-pair gradients (16, MP) of the packed
    fields, given the forward's final_T / n_contrib and the cotangents of
    color (3, H, W) and final_T (H, W), and with ``rich`` of depth (H, W)
    and normal (3, H, W) (None: zeros; "GS" reads no normal cotangent).
    With rich info off the depth and normal outputs carry no gradient.
    Rows from ``LIVE_GRAD_ROWS`` on (10 for "2D" and "GS", 13 for "3D";
    16, 11 and 14 with rich), "GS"'s row 5, padding slots and slots past
    the deepest contributor are zero. ``order`` as for ``blend_forward``."""
    _require_ported_variant(variant)
    grid_w, grid_h = _grid(image_width, image_height, tile_h, tile_w)
    dev = _check_inputs(pairs, tile_starts, tile_counts, params, grid_w * grid_h)
    if order is not None:
        _check_order(order, tile_counts)
    H, W = image_height, image_width
    if g_final_T is None:
        g_final_T = torch.zeros((H, W), dtype=pairs.dtype, device=dev)
    checks = [(final_T, "final_T", pairs.dtype, (H, W)),
              (n_contrib, "n_contrib", torch.int32, (H, W)),
              (g_color, "g_color", pairs.dtype, (3, H, W)),
              (g_final_T, "g_final_T", pairs.dtype, (H, W))]
    if rich:
        if g_depth is None:
            g_depth = torch.zeros((H, W), dtype=pairs.dtype, device=dev)
        if g_normal is None:
            g_normal = torch.zeros((3, H, W), dtype=pairs.dtype, device=dev)
        checks += [(g_depth, "g_depth", pairs.dtype, (H, W)),
                   (g_normal, "g_normal", pairs.dtype, (3, H, W))]
    for t, name, dtype, shape in checks:
        _check(t, name, dtype, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    kw = dict(image_width=W, image_height=H, tile_h=tile_h, tile_w=tile_w,
              variant=variant, rich=rich)
    if dev.type == "cpu":
        return blend_backward_plain(pairs, tile_starts, tile_counts, params,
                                    final_T, n_contrib, g_color, g_final_T,
                                    g_depth, g_normal, **kw)
    if dev.type != "cuda":
        raise ValueError(f"blend_backward: unsupported device {dev}")
    if pairs.dtype != torch.float32 or params.dtype != torch.float32:
        raise TypeError("blend_backward: the CUDA kernel takes float32 inputs")
    if order is None:
        order = tile_order(tile_counts)
    out = torch.empty_like(pairs)
    head = (pairs.data_ptr(), pairs.shape[1], tile_starts.data_ptr(),
            tile_counts.data_ptr(), order.data_ptr(), params.data_ptr(), W, H, tile_w,
            tile_h, grid_w, grid_w * grid_h)
    blend_backward.launches[_form(variant, rich=rich)] += 1
    if variant == "GS":
        code = library("blend_gs").ts_blend_backward_gs(
            *head, int(rich), final_T.data_ptr(), n_contrib.data_ptr(),
            g_color.data_ptr(), g_final_T.data_ptr(),
            g_depth.data_ptr() if rich else None, out.data_ptr(), _stream())
    else:
        code = library("blend").ts_blend_backward(
            *head, int(variant == "3D"), int(rich), final_T.data_ptr(),
            n_contrib.data_ptr(), g_color.data_ptr(), g_final_T.data_ptr(),
            g_depth.data_ptr() if rich else None,
            g_normal.data_ptr() if rich else None, out.data_ptr(), _stream())
    check_launch(code, "blend_backward")
    return out


blend_backward.launches = dict.fromkeys((_form(v, rich=r) for r in (False, True)
                                         for v in VARIANTS), 0)


def tile_order(tile_counts: torch.Tensor) -> torch.Tensor:
    """The order in which B1's and B2's blocks take the tiles (one block
    per SM at a time): by descending pair count, ties in tile order (int64,
    as ``argsort`` gives it: the kernels read it so). The heaviest tiles
    start first, so the last wave of blocks is not one long tile. It pays
    where a few tiles carry most of the work (the mesh cells' surface at
    2,500 tiles, the photo and gs cells at 625, the city at 1,450) and
    costs the argsort, ~30 us, on a uniform scene; the wrappers cannot tell
    the two apart without a sync, so they always sort, and ``rasterize``
    sorts once a step for both (PERF.md, Findings)."""
    return torch.argsort(tile_counts, descending=True, stable=True)


def _check_order(order, tile_counts):
    """Checks a tile order given to a wrapper: int64, one entry per tile, on
    the tiles' device, and on the CPU, where that costs no wait for the
    card, a permutation of the tiles."""
    _check(order, "order", torch.int64, 1, tile_counts.device)
    if order.shape != tile_counts.shape:
        raise ValueError(f"order: expected {tuple(tile_counts.shape)}, got {tuple(order.shape)}")
    if not order.is_cuda and not torch.equal(torch.sort(order).values,
                                             torch.arange(order.shape[0])):
        raise ValueError("order: not a permutation of the tiles")


# B1's kernel in each form, as compare_sass and ptxas name it
FORWARD_KERNELS = {
    **{_form(v, s, r): f"blend_forward_kernel<{str(v == '3D').lower()}, {str(s).lower()}, "
                       f"{str(r).lower()}>"
       for v in ("2D", "3D") for s in (False, True) for r in (False, True)},
    **{_form("GS", s, r): f"blend_forward_gs_kernel<{str(s).lower()}, {str(r).lower()}>"
       for s in (False, True) for r in (False, True)}}

# B2's kernel in each form, as compare_sass and ptxas name it
BACKWARD_KERNELS = {"2D": "blend_backward_kernel<false, false>",
                    "3D": "blend_backward_kernel<true, false>",
                    "2D_rich": "blend_backward_kernel<false, true>",
                    "3D_rich": "blend_backward_kernel<true, true>",
                    "GS": "blend_backward_gs_kernel<false>",
                    "GS_rich": "blend_backward_gs_kernel<true>"}


def backward_smem_bytes() -> dict[str, int]:
    """Dynamic shared memory of each B2 form's launch, in bytes (builds the
    kernels: CUDA only)."""
    lib, lib_gs = library("blend"), library("blend_gs")
    out = {_form(v, rich=r): lib.ts_blend_backward_smem(int(v == "3D"), int(r))
           for v in ("2D", "3D") for r in (False, True)}
    out.update({_form("GS", rich=r): lib_gs.ts_blend_backward_gs_smem(int(r))
                for r in (False, True)})
    return out


def forward_smem_bytes() -> dict[str, int]:
    """Dynamic shared memory of each B1 form's launch, in bytes (builds the
    kernels: CUDA only)."""
    lib, lib_gs = library("blend"), library("blend_gs")
    out = {_form(v, s, r): lib.ts_blend_forward_smem(int(v == "3D"), int(s), int(r))
           for v in ("2D", "3D") for s in (False, True) for r in (False, True)}
    out.update({_form("GS", s, r): lib_gs.ts_blend_forward_gs_smem(int(s), int(r))
                for s in (False, True) for r in (False, True)})
    return out
