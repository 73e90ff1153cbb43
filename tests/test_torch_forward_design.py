"""The invariants B1's CUDA design rests on, through the plain versions on the CPU.

B1 (``csrc/blend.cu``, ``csrc/blend_gs.cu``) lets a warp cull an entry
for the box of its pixels before any evaluation (``box_cull_plain``,
``box_cull_gs_plain`` against ``ecc_bound_plain`` / ``q_bound_plain``),
skip the falloff of an entry ("2D", "3D") where none of its live pixels has
an ecc within the entry's bound (``falloff_pretest_plain``), counts such an
entry in the pixels' ``n_contrib`` without evaluating it, and sums the
per-pair stream only over entries that some pixel of the warp composites.
That is exact only if (1) no predicate ever drops an entry whose plain
alpha terms give alpha >= 1/255 (tested on random scenes and on entries at
the bounds' edge; each test fails with a bound 1% too tight), and (2) an
entry of alpha 0 at every pixel changes nothing but ``n_contrib``, by one
at each pixel that meets it. ``rasterize`` computes the tiles' order once a
step and hands it to B1 and to B2.
"""

import numpy as np
import pytest
import torch
from test_torch_backward_design import W, H, cotangents, packed, with_null_pairs

from triangle_splatting_tpu_torch.ops import rasterize as RZ
from triangle_splatting_tpu_torch.ops.cuda import blend as KB
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

GAMMAS = [1.0, 2.0, 7.3, 50.0]


def edge_entries(variant: str, gamma: float, seed: int):
    """(16, n) field columns whose ecc at pixel (0, 0) lies around their
    own ``ecc_bound`` (relative offsets of 1e-7 to 1e-2 on both sides),
    over opacities from ALPHA_MIN to 1: a1 = mn and a2 = a3 = (1 - mn) / 2
    ("3D": D = 1, A1 = mn, A2 = (1 - mn) / 2)."""
    rng = np.random.default_rng(seed)
    opac = np.concatenate([[np.float32(KB.ALPHA_MIN), 0.004, 0.01, 0.5, 0.99, 1.0],
                           rng.uniform(0.0039, 1.0, 40)]).astype(np.float32)
    rel = np.concatenate([-np.logspace(-2, -7, 12), [0.0], np.logspace(-7, -2, 12)])
    bound = KB.ecc_bound_plain(torch.as_tensor(opac), gamma).numpy().astype(np.float64)
    ecc = (bound[:, None] * (1.0 + rel[None, :])).ravel()
    mn = ((1.0 - ecc) / 3.0).astype(np.float32)
    f = torch.zeros((KB.NUM_FIELDS, mn.size))
    o0 = 9 if variant == "3D" else 6
    if variant == "3D":
        f[0] = 1.0
        f[3], f[6] = torch.as_tensor(mn), torch.as_tensor((1.0 - mn) / 2.0)
    else:
        f[0], f[3] = torch.as_tensor(mn), torch.as_tensor((1.0 - mn) / 2.0)
    f[o0] = torch.as_tensor(np.repeat(opac, rel.size))
    return f


@pytest.mark.parametrize("gamma", GAMMAS)
@pytest.mark.parametrize("variant", ["2D", "3D"])
def test_falloff_pretest_never_skips_alpha(variant, gamma):
    """``falloff_pretest_plain`` (the twin of the kernels' test against
    ``ecc_bound``) is False only where the plain alpha terms give alpha 0:
    on every pair and pixel of a random scene's tiles and on entries placed
    at their bound's edge. A bound 1% too tight would skip entries of alpha
    >= 1/255 among the edge entries (the check that this test catches it)."""
    g = torch.tensor(gamma)
    o0 = 9 if variant == "3D" else 6
    fields, starts, counts, params, geo = packed(variant)
    params[0] = gamma
    grid_w = (W + 31) // 32
    ok = lambda n: torch.ones((n, 1), dtype=torch.bool)  # noqa: E731
    s, c = starts.tolist(), counts.tolist()
    tight_hits = 0
    for t in range(len(c)):
        if c[t] == 0:
            continue
        f = fields[:, s[t]:s[t] + c[t]]
        px, py = KB._tile_pixels(t, grid_w, 32, 32, torch.float32, "cpu")
        *_, eccs, _, _, alpha, _, _ = KB.alpha_terms_plain(f, px, py, g, ok(c[t]), variant)
        pre = KB.falloff_pretest_plain(eccs, f[o0], gamma)
        assert not bool(alpha[~pre].any()), t
    f = edge_entries(variant, gamma, int(gamma * 10))
    zero = torch.zeros(1)
    *_, eccs, _, _, alpha, _, _ = KB.alpha_terms_plain(f, zero, zero, g, ok(f.shape[1]), variant)
    bound = KB.ecc_bound_plain(f[o0], gamma)
    pre = KB.falloff_pretest_plain(eccs, f[o0], gamma)
    assert not bool(alpha[~pre].any())
    assert bool(pre.any()) and bool((~pre).any())
    tight = eccs[:, 0] <= 0.99 * bound
    tight_hits = int((~tight & (alpha[:, 0] >= KB.ALPHA_MIN)).sum())
    assert tight_hits > 0


@pytest.mark.parametrize("gamma", [1.0, 50.0])
def test_falloff_pretest_bound_edges(gamma):
    """The bound's own edges: -1 below ALPHA_MIN (every ecc skipped, alpha
    is 0 there), +inf for a NaN opacity and gamma <= 0 (nothing skipped)."""
    o = torch.tensor([0.5 / 255.0, float("nan"), 0.5])
    b = KB.ecc_bound_plain(o, gamma)
    assert float(b[0]) == -1.0 and float(b[1]) == float("inf") and 0.0 < float(b[2]) < 10.0
    assert bool(torch.isinf(KB.ecc_bound_plain(o, 0.0)).all())
    eccs = torch.zeros((3, 2))
    assert KB.falloff_pretest_plain(eccs, o, gamma).tolist() == [[False, False], [True, True],
                                                                 [True, True]]


def tile_boxes(t: int, grid_w: int) -> torch.Tensor:
    """(32, 4) boxes [x0, x1, y0, y1] of the 8x4 pixel blocks of 32x32 tile
    t that its warps cover (warp w: block column w % 4, block row w // 4)."""
    ty, tx = divmod(t, grid_w)
    w = torch.arange(32)
    x0, y0 = tx * 32 + (w % 4) * 8, ty * 32 + (w // 4) * 4
    return torch.stack([x0, x0 + 7, y0, y0 + 3], dim=1).to(torch.float32)


def block_hit(alpha: torch.Tensor) -> torch.Tensor:
    """(n, 1024) alpha over a 32x32 tile's pixels, row-major -> (n, 32):
    whether alpha != 0 at a pixel of each warp's 8x4 block."""
    a = alpha.reshape(-1, 8, 4, 4, 8) != 0       # row block, row, column block, column
    return a.any(dim=4).any(dim=2).reshape(-1, 32)


def edge_box_entries(variant: str, gamma: float, seed: int):
    """``edge_entries`` twice over: as they are (barycentrics constant over
    a block) and with a1 rising over the block [0, 7] x [0, 3] to its value
    at the far corner ("3D": D, A1 and A2 rising together, a1 and a2
    constant), so that the least ecc over the block is at the bound's
    edge."""
    f = edge_entries(variant, gamma, seed)
    g = f.clone()
    if variant == "3D":
        d = torch.tensor([1.0, 0.01, 0.02])
        g[0:3] = d[:, None]
        g[3:6] = f[3][None, :] * d[:, None]
        g[6:9] = f[6][None, :] * d[:, None]
    else:
        g[1], g[2] = 0.01, 0.005
        g[0] = f[0] - 0.01 * 7.0 - 0.005 * 3.0
    return torch.cat([f, g], dim=1)


@pytest.mark.parametrize("gamma", GAMMAS)
@pytest.mark.parametrize("variant", ["2D", "3D"])
def test_box_cull_never_skips_alpha(variant, gamma):
    """``box_cull_plain`` (the twin of the kernels' per-warp cull) culls an
    entry for an 8x4 block only where the plain alpha terms give alpha 0 at
    all of the block's pixels: on every entry and warp block of a random
    scene's tiles (where it does cull) and on entries whose least ecc over
    a block lies at their bound's edge. A bound 1% too tight would cull
    entries of alpha >= 1/255 among the edge entries."""
    g = torch.tensor(gamma)
    o0 = 9 if variant == "3D" else 6
    fields, starts, counts, params, geo = packed(variant, seed=2, n=120)
    grid_w = (W + 31) // 32
    ok = lambda n: torch.ones((n, 1), dtype=torch.bool)  # noqa: E731
    s, c = starts.tolist(), counts.tolist()
    culled = 0
    for t in range(len(c)):
        if c[t] == 0:
            continue
        f = fields[:, s[t]:s[t] + c[t]]
        px, py = KB._tile_pixels(t, grid_w, 32, 32, torch.float32, "cpu")
        alpha = KB.alpha_terms_plain(f, px, py, g, ok(c[t]), variant)[6]
        may = KB.box_cull_plain(f, tile_boxes(t, grid_w), KB.ecc_bound_plain(f[o0], gamma),
                                variant)
        assert not bool((block_hit(alpha) & ~may).any()), t
        culled += int((~may).sum())
    assert culled > 0
    f = edge_box_entries(variant, gamma, int(gamma * 10) + 1)
    px, py = torch.arange(8.0).repeat(4), torch.arange(4.0).repeat_interleave(8)
    hit = (KB.alpha_terms_plain(f, px, py, g, ok(f.shape[1]), variant)[6] != 0).any(dim=1)
    box = torch.tensor([[0.0, 7.0, 0.0, 3.0]])
    bound = KB.ecc_bound_plain(f[o0], gamma)
    may = KB.box_cull_plain(f, box, bound, variant)[:, 0]
    assert not bool((hit & ~may).any())
    assert bool(hit.any()) and bool((~may).any())
    assert bool((hit & ~KB.box_cull_plain(f, box, 0.99 * bound, variant)[:, 0]).any())


def gs_edge_entries(gamma: float, seed: int):
    """(16, n) "GS" field columns whose q at pixel (0, 0) lies around their
    own ``q_bound`` (relative offsets of 1e-7 to 1e-2 on both sides), over
    opacities from ALPHA_MIN to 1 and three conics (round, elongated,
    tilted): the center at (-d, 0), so that (0, 0) is also the pixel of
    least q in the block [0, 7] x [0, 3]."""
    rng = np.random.default_rng(seed)
    opac = np.concatenate([[np.float32(KB.ALPHA_MIN), 0.004, 0.01, 0.5, 0.99, 1.0],
                           rng.uniform(0.0039, 1.0, 20)]).astype(np.float32)
    rel = np.concatenate([-np.logspace(-2, -7, 12), [0.0], np.logspace(-7, -2, 12)])
    bound = KB.q_bound_plain(torch.as_tensor(opac), gamma).numpy().astype(np.float64)
    q = (bound[:, None] * (1.0 + rel[None, :])).ravel()
    cols = []
    for a, b, c in ((1.0, 0.0, 1.0), (0.25, 0.0, 4.0), (2.0, 0.9, 1.0)):
        f = torch.zeros((KB.NUM_FIELDS, q.size))
        f[0] = torch.as_tensor(-np.sqrt(np.maximum(q, 0.0) / a).astype(np.float32))
        f[2], f[3], f[4] = a, b, c
        f[6] = torch.as_tensor(np.repeat(opac, rel.size))
        cols.append(f)
    return torch.cat(cols, dim=1)


@pytest.mark.parametrize("gamma", GAMMAS)
def test_gs_cull_never_skips_alpha(gamma):
    """"GS": ``q_bound_plain`` and ``box_cull_gs_plain`` (the twins of
    B1-GS's bound and per-warp cull) drop an entry only where the plain
    alpha terms give alpha 0: q past the bound at a pixel, and the cull for
    an 8x4 block at all of its pixels; on a random scene's tiles (where the
    cull does cull) and on entries at their bound's edge. A bound 1% too
    tight would drop entries of alpha >= 1/255 among the edge entries."""
    g = torch.tensor(gamma)
    fields, starts, counts, params, geo = packed("GS", seed=2, n=120)
    grid_w = (W + 31) // 32
    ok = lambda n: torch.ones((n, 1), dtype=torch.bool)  # noqa: E731
    s, c = starts.tolist(), counts.tolist()
    culled = 0
    for t in range(len(c)):
        if c[t] == 0:
            continue
        f = fields[:, s[t]:s[t] + c[t]]
        px, py = KB._tile_pixels(t, grid_w, 32, 32, torch.float32, "cpu")
        qs, *_, alpha, _ = KB.alpha_terms_gs_plain(f, px, py, g, ok(c[t]))
        bound = KB.q_bound_plain(f[6], gamma)
        assert not bool(alpha[qs > bound[:, None]].any()), t
        may = KB.box_cull_gs_plain(f, tile_boxes(t, grid_w), bound)
        assert not bool((block_hit(alpha) & ~may).any()), t
        culled += int((~may).sum())
    assert culled > 0
    f = gs_edge_entries(gamma, int(gamma * 10) + 2)
    bound = KB.q_bound_plain(f[6], gamma)
    zero = torch.zeros(1)
    qs, *_, alpha, _ = KB.alpha_terms_gs_plain(f, zero, zero, g, ok(f.shape[1]))
    past = qs[:, 0] > bound
    assert not bool(alpha[past].any()) and bool(past.any())
    assert bool((alpha[:, 0] > 0)[qs[:, 0] > 0.99 * bound].any())
    px, py = torch.arange(8.0).repeat(4), torch.arange(4.0).repeat_interleave(8)
    hit = (KB.alpha_terms_gs_plain(f, px, py, g, ok(f.shape[1]))[5] != 0).any(dim=1)
    box = torch.tensor([[0.0, 7.0, 0.0, 3.0]])
    may = KB.box_cull_gs_plain(f, box, bound)[:, 0]
    assert not bool((hit & ~may).any())
    assert bool(hit.any()) and bool((~may).any())
    assert bool((hit & ~KB.box_cull_gs_plain(f, box, 0.99 * bound)[:, 0]).any())


def expected_n_contrib(nc, final_T, starts, counts, inserted, variant):
    """The n_contrib of the pixels of a list with null pairs inserted: each
    tile's null pairs sit before the entries at positions 0, n // 2 and n
    of its own list. Triangles: a pixel meets the ones before the entry
    that ends it (all of them where T stays above T_EPS); "GS": its index
    of the last composited entry moves by those before that entry."""
    grid_w, grid_h = KB._grid(W, H, 32, 32)
    nc_t = KB._tile(nc, grid_h, grid_w, 32, 32)
    alive = KB._tile(final_T, grid_h, grid_w, 32, 32) > KB.T_EPS
    out = nc_t.clone()
    for t, n in enumerate(counts.tolist()):
        pos = torch.tensor([0, n // 2, n])
        before = (pos[None, :] < nc_t[t][:, None]).sum(dim=1)
        if variant == "GS":
            out[t] = torch.where(nc_t[t] > 0, nc_t[t] + before, nc_t[t])
        else:
            out[t] = nc_t[t] + before + torch.where(alive[t], (pos == n).sum(), 0)
    return KB._untile(out, grid_h, grid_w, 32, 32, H, W)


@pytest.mark.parametrize("kind", ["faint", "far"])
@pytest.mark.parametrize("rich", [False, True], ids=["plain", "rich"])
@pytest.mark.parametrize("variant", ["2D", "3D", "GS"])
def test_null_pairs_raise_only_n_contrib(variant, rich, kind):
    """Pairs whose alpha is 0 at every pixel of their tile, inserted at the
    front, the middle and the end of every tile's list (three into an empty
    tile): the plain B1's color and final_T stay bit-identical, and each
    pixel's n_contrib rises by exactly the inserted pairs it meets (before
    its end: the entry that takes T to T_EPS or below, "GS" its last
    composited entry; all of them where T stays above T_EPS)."""
    # an opaque scene: many pixels end inside their tile's list
    fields, starts, counts, params, geo = packed(variant, seed=1, n=200, xy_extent=0.4,
                                                 opacity_range=(0.8, 0.95))
    new_fields, new_starts, new_counts, _, inserted = with_null_pairs(
        fields, starts, counts, variant, kind)
    fwd = KB.blend_forward_plain(fields, starts, counts, params, rich=rich, **geo)
    fwd_n = KB.blend_forward_plain(new_fields, new_starts, new_counts, params, rich=rich,
                                   **geo)
    for k in (0, 3):
        assert torch.equal(fwd[k], fwd_n[k]), k
    want = expected_n_contrib(fwd[4], fwd[3], starts, counts, inserted, variant)
    assert torch.equal(fwd_n[4], want)
    assert bool((fwd_n[4] > fwd[4]).any())
    if variant != "GS":
        # pixels that end inside their list meet fewer than all three
        assert bool(((fwd_n[4] - fwd[4] < 3) & (fwd[4] > 0)).any())


@pytest.mark.parametrize("variant", ["2D", "3D", "GS"])
def test_blend_tiles_hands_one_order_to_b1_and_b2(variant, monkeypatch):
    """``BlendTiles`` (the blend step of ``rasterize``) computes the tiles'
    order once a step, heaviest first, and hands the same tensor to the B1
    and the B2 wrapper (spies on the CPU path's arguments, with
    ``step_order`` giving the card's order; on the CPU it gives None, and
    the wrappers check the permutation that they get)."""
    fields, starts, counts, params, geo = packed(variant)
    assert RZ.step_order(counts) is None
    orders, seen = [], {}
    real = dict(fwd=RZ.blend_forward, bwd=RZ.blend_backward)

    def order_spy(c):
        orders.append(RZ.tile_order(c))
        return orders[-1]

    def spy(name):
        def wrapped(*a, **kw):
            seen[name] = kw["order"]
            return real[name](*a, **kw)
        return wrapped
    monkeypatch.setattr(RZ, "step_order", order_spy)
    monkeypatch.setattr(RZ, "blend_forward", spy("fwd"))
    monkeypatch.setattr(RZ, "blend_backward", spy("bwd"))
    f = fields.clone().requires_grad_(True)
    cfg = (W, H, 32, 32, variant, True, False)
    color, _, _, final_T, _, _ = RZ.BlendTiles.apply(f, starts, counts, params, cfg)
    g_color, g_T, _, _ = cotangents(3)
    ((color * g_color).sum() + (final_T * g_T).sum()).backward()
    assert len(orders) == 1
    assert seen["fwd"].data_ptr() == seen["bwd"].data_ptr() == orders[0].data_ptr()
    assert torch.equal(orders[0], torch.argsort(counts, descending=True, stable=True))
    assert f.grad is not None and bool(f.grad.abs().sum() > 0)


@pytest.mark.parametrize("which", ["forward", "backward"])
@pytest.mark.parametrize("bad", ["duplicate", "out of range"])
def test_wrappers_refuse_an_order_that_is_no_permutation(which, bad):
    """On the CPU the B1 and B2 wrappers refuse a tile order that repeats a
    tile or names one past the grid, and take any permutation (outputs as
    without an order)."""
    fields, starts, counts, params, geo = packed("2D")
    n = counts.shape[0]
    order = torch.arange(n - 1, -1, -1, dtype=torch.int64)
    if which == "forward":
        call = lambda o: KB.blend_forward(fields, starts, counts, params, order=o, **geo)  # noqa: E731
    else:
        fwd = KB.blend_forward(fields, starts, counts, params, **geo)
        g_color = cotangents(3)[0]
        call = lambda o: KB.blend_backward(fields, starts, counts, params, fwd[3], fwd[4],  # noqa: E731
                                           g_color, order=o, **geo)
    base = call(None)
    got = call(order)
    for a, b in zip(base if isinstance(base, tuple) else (base,),
                    got if isinstance(got, tuple) else (got,)):
        assert torch.equal(a, b)
    order[1] = order[0] if bad == "duplicate" else n
    with pytest.raises(ValueError, match="permutation"):
        call(order)
