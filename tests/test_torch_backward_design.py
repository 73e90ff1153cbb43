"""The invariants B2's CUDA design rests on, through the plain versions on the CPU.

B2 (``csrc/blend.cu``, ``csrc/blend_gs.cu``) skips an entry for a whole
warp when no pixel of the warp has alpha != 0 there: it leaves the
transmittance, the suffix sum and the gradient rows as they are. That is
exact only if such an entry changes nothing. These tests insert pairs whose
alpha is 0 at every pixel of their tile (opacity under 1/255, or placed far
outside the tile) at several positions of the tiles' lists, and hold the
plain B1's color and final_T and the plain B2's rows of every other pair
bit-identical, and the inserted pairs' rows zero, in every variant with
rich info off and on. They also hold ``tile_order``, the order in which
B2's blocks take the tiles: heaviest first, ties in tile order.
"""

import collections

import numpy as np
import pytest
import torch

from triangle_splatting_tpu_torch.ops.binning import sort_pairs
from triangle_splatting_tpu_torch.ops.cuda import blend as KB
from triangle_splatting_tpu_torch.ops.cuda import streams as KS
from triangle_splatting_tpu_torch.ops.gaussian import gaussian_field_matrix, preprocess_gaussian
from triangle_splatting_tpu_torch.ops.projection import (RasterSettings, preprocess_2d,
                                                         preprocess_3d)
from triangle_splatting_tpu_torch.ops.rasterize import (triangle_field_matrix,
                                                        triangle_field_matrix_3d)
from triangle_splatting_tpu_torch.utils.testing import (make_camera, make_gs_scene,
                                                        make_random_scene)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

W, H = 72, 40            # 3 x 2 tiles of 32 x 32, the last column and row partial
GAMMA = {"2D": 1.0, "3D": 50.0, "GS": 1.0}


def packed(variant: str, seed: int = 0, n: int | None = None, **scene_kw):
    """Field-major (16, MA) pairs of a random scene (``n`` primitives: 60
    triangles or 80 Gaussians by default; ``scene_kw`` to the scene's
    maker), with its tile starts and counts, params and the blend geometry,
    on the CPU."""
    st = RasterSettings(image_width=W, image_height=H, rich_info=False,
                        rasterizer_type=variant)
    cam = make_camera(W, H, device="cpu")
    gamma = torch.tensor(GAMMA[variant])
    if variant == "GS":
        s = make_gs_scene(n or 80, seed=seed, **scene_kw)
        xyz, scale, rot, op, rgb = (torch.as_tensor(s[k])
                                    for k in ("xyz", "scale", "rot", "opacity", "rgb"))
        prep = preprocess_gaussian(xyz, scale, rot, rgb, cam.world_view, cam.full_proj,
                                   cam.tan_fovx, cam.tan_fovy, st, opacity=op, gamma=gamma)
    else:
        n = n or 60
        s = make_random_scene(n, seed=seed, **scene_kw)
        vertex, op, rgb = (torch.as_tensor(s[k]) for k in ("vertex", "opacity", "rgb"))
        pre = preprocess_2d if variant == "2D" else preprocess_3d
        prep = pre(vertex, torch.zeros((n, 2)), rgb, cam.world_view, cam.full_proj,
                   cam.tan_fovx, cam.tan_fovy, st, opacity=op, gamma=gamma)
    sp = sort_pairs(prep, st, 128 * 24)
    assert not bool(sp.overflow)
    pair_tri, _ = KS.relayout_pairs_plain(*sp.relayout_args())
    if variant == "GS":
        fmat = gaussian_field_matrix(prep, op)
    elif variant == "2D":
        fmat = triangle_field_matrix(prep, op)
    else:
        fmat = triangle_field_matrix_3d(prep, op, cam.tan_fovx, cam.tan_fovy, W, H)
    fields = torch.where((pair_tri >= 0)[:, None], fmat[pair_tri.clamp_min(0).long()],
                         torch.zeros(())).t().contiguous()
    sx, sy = W / (2.0 * float(cam.tan_fovx)), H / (2.0 * float(cam.tan_fovy))
    params = torch.tensor([GAMMA[variant], 1.0, 0.9, 0.8, 10.0, sx, sy, 0.0])
    geo = dict(image_width=W, image_height=H, tile_h=32, tile_w=32, variant=variant)
    return fields, sp.astarts, sp.tile_counts, params, geo


def null_pair(f: torch.Tensor, variant: str, kind: str) -> torch.Tensor:
    """A copy of the (16,) field column ``f`` whose alpha is 0 at every
    pixel: its opacity under 1/255 ("faint"), or its barycentrics (its
    center) far from the image ("far")."""
    f = f.clone()
    if kind == "faint":
        f[9 if variant == "3D" else 6] = 0.5 / 255.0
    elif variant == "2D":
        f[0:3] = torch.tensor([-50.0, 0.0, 0.0])        # a1 = -50: ecc = 151
    elif variant == "3D":
        f[0:6] = torch.tensor([1.0, 0.0, 0.0, -50.0, 0.0, 0.0])   # D = 1, a1 = -50
    else:
        f[0] = 1e4                                      # X: dx ~ 1e4 pixels
    return f


def with_null_pairs(fields, starts, counts, variant: str, kind: str):
    """The pairs with null pairs inserted at the front, the middle and the
    end of every tile's list (three into an empty tile), re-laid out at
    ALIGN. Returns the new (fields, starts, counts), the new slot of each
    old real slot (old -> new) and the new slots of the inserted pairs."""
    starts, counts = starts.tolist(), counts.tolist()
    cols, new_starts, new_counts, moved, inserted = [], [0], [], {}, []
    for t, n in enumerate(counts):
        own = list(range(starts[t], starts[t] + n))
        src = own[n // 2] if n else None
        at = collections.Counter([0, n // 2, n])      # insert before own[i]
        slot = new_starts[-1]
        for i in range(n + 1):
            for _ in range(at[i]):
                base = fields[:, src] if src is not None else fields[:, 0] * 0
                cols.append(null_pair(base, variant, kind))
                inserted.append(slot)
                slot += 1
            if i < n:
                cols.append(fields[:, own[i]])
                moved[own[i]] = slot
                slot += 1
        new_counts.append(slot - new_starts[-1])
        pad = -slot % KB.ALIGN
        cols += [torch.zeros(KB.NUM_FIELDS)] * pad
        new_starts.append(slot + pad)
    cols += [torch.zeros(KB.NUM_FIELDS)] * KB.ALIGN           # a tail of no tile
    out = torch.stack(cols, dim=1).contiguous()
    return (out, torch.tensor(new_starts, dtype=torch.int32),
            torch.tensor(new_counts, dtype=torch.int32), moved, inserted)


def cotangents(seed: int):
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32) / (H * W))  # noqa: E731
    return g(3, H, W), g(H, W), g(H, W), g(3, H, W)


@pytest.mark.parametrize("kind", ["faint", "far"])
@pytest.mark.parametrize("rich", [False, True], ids=["plain", "rich"])
@pytest.mark.parametrize("variant", ["2D", "3D", "GS"])
def test_null_pairs_change_nothing(variant, rich, kind):
    fields, starts, counts, params, geo = packed(variant)
    new_fields, new_starts, new_counts, moved, inserted = with_null_pairs(
        fields, starts, counts, variant, kind)
    # every inserted pair has alpha 0 at every pixel of its tile
    grid_w = (W + 31) // 32
    s_new = new_starts.tolist()
    for t in range(len(counts)):
        px, py = KB._tile_pixels(t, grid_w, 32, 32, torch.float32, "cpu")
        cols = [i for i in inserted if s_new[t] <= i < s_new[t + 1]]
        f = new_fields[:, cols]
        ok = torch.ones((len(cols), 1), dtype=torch.bool)
        alpha = (KB.alpha_terms_gs_plain(f, px, py, params[0], ok)[5] if variant == "GS"
                 else KB.alpha_terms_plain(f, px, py, params[0], ok, variant)[6])
        assert not bool(alpha.any()), (t, kind)

    fwd = KB.blend_forward_plain(fields, starts, counts, params, rich=rich, **geo)
    fwd_n = KB.blend_forward_plain(new_fields, new_starts, new_counts, params, rich=rich, **geo)
    for k, name in ((0, "color"), (3, "final_T")):
        assert torch.equal(fwd[k], fwd_n[k]), name
    # depth and normal: the plain version's vector-matrix products regroup
    # their sums when the list grows, so ulps, not bits
    for k in (1, 2):
        assert float((fwd[k] - fwd_n[k]).abs().max()) <= 1e-6 * float(fwd[k].abs().max())
    # the inserted pairs lie in front of some pixel's last contributor: B2
    # walks them
    nc_n = fwd_n[4]
    assert int(nc_n.max()) > 1 and int((fwd[4] < nc_n).sum()) > 0

    g_color, g_T, g_depth, g_normal = cotangents(7)
    extra = (g_depth, g_normal) if rich else ()
    bw = KB.blend_backward_plain(fields, starts, counts, params, fwd[3], fwd[4], g_color,
                                 g_T, *extra, rich=rich, **geo)
    bw_n = KB.blend_backward_plain(new_fields, new_starts, new_counts, params, fwd_n[3],
                                   fwd_n[4], g_color, g_T, *extra, rich=rich, **geo)
    old, new = list(moved), [moved[i] for i in moved]
    assert torch.equal(bw[:, old], bw_n[:, new])
    live = [r for r in range(KB.LIVE_GRAD_ROWS[(variant, rich)])
            if not (variant == "GS" and r == 5)]
    assert bool(bw[live][:, old].abs().amax(dim=1).gt(0).all())
    assert not bool(bw_n[:, inserted].any())


def test_tile_order_heaviest_first():
    rng = np.random.default_rng(0)
    counts = torch.as_tensor(rng.integers(0, 6, size=2500).astype(np.int32))
    order = KB.tile_order(counts)
    assert order.dtype == torch.int64
    assert torch.equal(torch.sort(order).values, torch.arange(2500))
    c = counts[order.long()]
    assert bool((c[:-1] >= c[1:]).all())
    # ties keep the tiles' own order
    same = c[:-1] == c[1:]
    assert bool((order[:-1][same] < order[1:][same]).all())


@pytest.mark.parametrize("counts,want", [
    ([0, 0, 0], [0, 1, 2]),
    ([1, 3, 3, 0, 7], [4, 1, 2, 0, 3]),
    ([5], [0]),
])
def test_tile_order_small(counts, want):
    assert KB.tile_order(torch.tensor(counts, dtype=torch.int32)).tolist() == want


@pytest.mark.parametrize("gamma", [1.0, 2.0, 7.3, 50.0])
def test_ecc_bound_skips_only_zero_alpha(gamma):
    """B1 and B2 ("2D"/"3D") evaluate the falloff only where some pixel's
    ecc is within the entry's bound (``ecc_bound_plain``, the kernels'
    ``ecc_bound``). Past it the plain alpha terms (the kernels' float32
    arithmetic) give alpha exactly 0; just inside it they give alpha > 0
    (the bound is tight)."""
    rng = np.random.default_rng(int(gamma * 10))
    opac = np.concatenate([[np.float32(KB.ALPHA_MIN), 0.004, 0.99, 1.0],
                           rng.uniform(0.0039, 1.0, 60)]).astype(np.float32)
    rel = np.concatenate([-np.logspace(-2, -7, 12), [0.0], np.logspace(-7, -2, 12)])
    bounds = KB.ecc_bound_plain(torch.as_tensor(opac), gamma).tolist()
    for o, e in zip(opac, bounds):
        assert e > 0
        ecc = np.float32(e) * (1.0 + rel)                     # around the bound
        mn = ((1.0 - ecc) / 3.0).astype(np.float32)           # a1 = mn, a2 = a3 = (1 - mn) / 2
        f = torch.zeros((KB.NUM_FIELDS, len(mn)))
        f[0] = torch.as_tensor(mn)
        f[3] = torch.as_tensor((1.0 - mn) / 2.0)
        f[6] = float(o)
        zero = torch.zeros(1)
        _, _, _, eccs, _, _, alpha, _, _ = KB.alpha_terms_plain(
            f, zero, zero, torch.tensor(gamma), torch.ones((len(mn), 1), dtype=torch.bool))
        past = eccs[:, 0] > e
        assert not bool(alpha[past].any()), (o, gamma)
        if o >= 0.01:
            assert bool((alpha[eccs[:, 0] < e * (1 - 1e-2)] > 0).all()), (o, gamma)
    assert KB.ecc_bound_plain(torch.tensor([0.5 / 255]), gamma).tolist() == [-1.0]


@pytest.mark.parametrize("kernel", ["b1", "b2"])
def test_blend_compare_reads_the_parents_interface(kernel):
    """The B1/B2 comparison tool takes a parent's entry point with the
    current parameters, with or without the tile order after tile_counts,
    and refuses any other."""
    from triangle_splatting_tpu_torch.ops.cuda.build import CSRC
    from triangle_splatting_tpu_torch.tools import blend_compare as BC
    for s in BC.SOURCES:
        text = (CSRC / f"{s}.cu").read_text()
        assert BC.takes_order(text, s, kernel)
        old = text.replace("const long long* tile_order, ", "")
        assert old != text and not BC.takes_order(old, s, kernel)
        with pytest.raises(RuntimeError, match="tile_order"):
            BC.takes_order(old.replace("int mp,", "int mp, int extra,"), s, kernel)
        moved = old.replace("const float* params,", "const float* params, "
                            "const long long* tile_order,")
        with pytest.raises(RuntimeError, match="tile_order"):
            BC.takes_order(moved, s, kernel)
