"""The plain reference on tiny scenes on the CPU: the tiled composite
against a per-entry loop written from the oracle's rules, chunking that
does not change values or gradients, and one training step of each
reference."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark.reference import gaussians as GSR
from benchmark.reference import tiles as TL
from benchmark.reference import triangles as TR
from benchmark.scenes import common as C


def loop_composite(alpha, cand, rgb, depth, bg, bg_depth, kill_rule):
    """One entry after another, as the dense oracles walk them."""
    nt, L, npix = alpha.shape
    T = torch.ones(nt, npix, dtype=alpha.dtype)
    done = torch.zeros(nt, npix, dtype=torch.bool)
    col = torch.zeros(nt, 3, npix, dtype=alpha.dtype)
    dep = torch.zeros(nt, npix, dtype=alpha.dtype)
    nc = torch.zeros(nt, npix, dtype=torch.int64)
    for i in range(L):
        a, c = alpha[:, i], cand[:, i] & ~done
        if kill_rule:
            test = T * (1 - a)
            eff = c & (test >= TL.T_EPS)
            done = done | (c & (test < TL.T_EPS))
        else:
            eff = c
        contrib = torch.where(eff, a * T, torch.zeros_like(a))
        col = col + rgb[:, i, :, None] * contrib[:, None]
        dep = dep + depth[:, i] * contrib
        if kill_rule:
            nc = torch.where(eff, torch.full_like(nc, i + 1), nc)
        else:
            nc = nc + (~done).to(torch.int64)
        T = torch.where(eff, T * (1 - a), T)
        if not kill_rule:
            done = done | (eff & (T <= TL.T_EPS))
    return col + T[:, None] * bg[None, :, None], dep + T * bg_depth, T, nc


@pytest.mark.parametrize("kill_rule", [False, True])
def test_composite_matches_the_entry_loop(kill_rule):
    g = torch.Generator().manual_seed(3)
    nt, L, npix = 3, 40, 16
    alpha = torch.rand(nt, L, npix, generator=g, dtype=torch.float64) * 0.6
    cand = torch.rand(nt, L, npix, generator=g) > 0.2
    rgb = torch.rand(nt, L, 3, generator=g, dtype=torch.float64)
    depth = torch.rand(nt, L, 1, generator=g, dtype=torch.float64)
    bg = torch.tensor([0.2, 0.5, 0.9], dtype=torch.float64)
    ok = torch.ones(nt, L, 1, dtype=torch.bool)
    c, d, _, t, nc = TL.composite(alpha, cand, ok, rgb, depth, None, bg, 3.0, kill_rule)
    rc, rd, rt, rnc = loop_composite(alpha, cand, rgb, depth.expand(nt, L, npix), bg, 3.0,
                                     kill_rule)
    torch.testing.assert_close(c, rc)
    torch.testing.assert_close(d, rd)
    torch.testing.assert_close(t, rt)
    assert torch.equal(nc, rnc)
    # the stop is reached on some pixels, so the rule is exercised
    assert bool((rt < 0.01).any())


@pytest.mark.parametrize("kill_rule", [False, True])
def test_composite_gradient_matches_the_entry_loop(kill_rule):
    g = torch.Generator().manual_seed(4)
    nt, L, npix = 2, 25, 8
    base = torch.rand(nt, L, npix, generator=g, dtype=torch.float64) * 0.7
    cand = torch.rand(nt, L, npix, generator=g) > 0.1
    rgb = torch.rand(nt, L, 3, generator=g, dtype=torch.float64)
    w = torch.rand(nt, 3, npix, generator=g, dtype=torch.float64)
    bg = torch.zeros(3, dtype=torch.float64)
    ok = torch.ones(nt, L, 1, dtype=torch.bool)
    zero_depth = torch.zeros(nt, L, 1, dtype=torch.float64)
    a1 = base.clone().requires_grad_(True)
    (TL.composite(a1, cand, ok, rgb, zero_depth, None, bg, 0.0, kill_rule)[0] * w).sum().backward()
    a2 = base.clone().requires_grad_(True)
    (loop_composite(a2, cand, rgb, zero_depth.expand(nt, L, npix), bg, 0.0,
                    kill_rule)[0] * w).sum().backward()
    torch.testing.assert_close(a1.grad, a2.grad)


def _camera(W=64, H=48):
    R, t = C.aerial_pose(0.3, radius=1.0, height=2.0, target=(0.0, 0.0, 0.0))
    fx = W / (2 * math.tan(math.radians(60) / 2))
    return C.camera_tensors(C.camera_record(C.rotmat2qvec(R), t, fx, W, H, "v"), "cpu")


def _triangles(n=30, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.5, 0.5, (n, 3)) * [1, 1, 0.2]
    e = rng.normal(0, 0.15, (n, 2, 3))
    v = np.stack([c, c + e[:, 0], c + e[:, 1]], 1).astype(np.float32)
    return (torch.as_tensor(v), torch.as_tensor(rng.uniform(0.2, 0.95, n).astype(np.float32)),
            torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32)))


def dense_3d(prep, gamma, cam, bg):
    """Every triangle over every pixel of its rect, front to back in
    quantized-depth order: the dense oracle's rules, pixel by pixel."""
    W, H = cam["width"], cam["height"]
    dq = TL.quantize_depth(prep.depth, prep.valid, TL.depth_bits_for(
        (-(-W // TL.TILE)) * (-(-H // TL.TILE))))
    order = [int(i) for i in torch.argsort(
        torch.where(prep.valid, dq, torch.full_like(dq, 2 ** 31 - 1)), stable=True) if prep.valid[i]]
    img = torch.zeros(3, H, W)
    leaves = dict(v1=prep.v_view[:, 0], v2=prep.v_view[:, 1], v3=prep.v_view[:, 2],
                  n=prep.normal, rgb=prep.rgb, op=prep.opacity, valid=prep.valid)
    fn = TR.chunk_fn_3d(leaves, gamma, cam)
    for py in range(H):
        for px in range(W):
            tile_x, tile_y = px // TL.TILE, py // TL.TILE
            T, done = 1.0, False
            col = torch.zeros(3)
            for i in order:
                r0, r1 = prep.rect_min[i], prep.rect_max[i]
                if done or not (r0[0] <= tile_x < r1[0] and r0[1] <= tile_y < r1[1]):
                    continue
                a, c, _, rgb, _, _ = fn(torch.tensor([[i]]), torch.ones(1, 1, 1, dtype=torch.bool),
                                        torch.tensor([[[px]]]), torch.tensor([[[py]]]), None)
                if bool(c[0, 0, 0]):
                    col += float(a[0, 0, 0]) * T * rgb[0, 0]
                    T *= 1 - float(a[0, 0, 0])
                    done = T <= TL.T_EPS
            img[:, py, px] = col + T * bg
    return img


def test_tiled_3d_render_matches_the_dense_rules():
    cam = _camera()
    v, o, rgb = _triangles()
    gamma = torch.tensor(1.7)
    prep = TR.preprocess_3d(v, rgb, o, cam, torch.ones(len(v), dtype=torch.bool), gamma)
    q, _ = TR.leaves_of(prep)
    plan = TL.plan_tiles(prep.rect_min, prep.rect_max, prep.valid, prep.depth, 64, 48)
    bg = torch.tensor([0.1, 0.2, 0.3])
    with torch.no_grad():
        img = TL.render(plan, TR.chunk_fn_3d(q, gamma, cam), bg, 5.0, 1 << 16, True)[0]
    torch.testing.assert_close(img, dense_3d(prep, gamma, cam, bg), atol=2e-6, rtol=1e-5)
    assert plan.num_pairs > len(v)          # some triangles cover several tiles


@pytest.mark.parametrize("budget", [1 << 12, 1 << 24])
def test_chunking_changes_neither_image_nor_gradient(budget):
    cam = _camera()
    v, o, rgb = _triangles(60, seed=2)
    gamma = torch.tensor(1.0)
    bg = torch.tensor([0.3, 0.3, 0.3])

    def run(b):
        vv = v.clone().requires_grad_(True)
        prep = TR.preprocess_3d(vv, rgb, o, cam, torch.ones(len(v), dtype=torch.bool), gamma)
        q, src = TR.leaves_of(prep)
        plan = TL.plan_tiles(prep.rect_min, prep.rect_max, prep.valid, prep.depth, 64, 48)
        fn = TR.chunk_fn_3d(q, gamma, cam)
        img = TL.render(plan, fn, bg, 5.0, b, True)[0]
        TL.backward(plan, fn, bg, 5.0, b, torch.ones_like(img), torch.zeros(48, 64), None)
        keys = [k for k in ("v1", "v2", "v3", "n") if q[k].grad is not None]
        torch.autograd.backward([src[k] for k in keys], [q[k].grad for k in keys])
        return img, vv.grad

    img_a, g_a = run(budget)
    img_b, g_b = run(1 << 30)
    torch.testing.assert_close(img_a, img_b)
    # the chunks add their gradients in another order: float32 rounding
    scale = float(g_b.abs().max())
    torch.testing.assert_close(g_a, g_b, rtol=1e-4, atol=1e-5 * scale)
    assert scale > 0


def test_gaussian_chunk_alpha_at_the_center():
    cam = _camera()
    xyz = torch.tensor([[0.0, 0.0, 0.0]])
    prep = GSR.preprocess(xyz, torch.full((1, 3), 0.05), torch.tensor([[1.0, 0, 0, 0]]),
                          torch.tensor([[0.2, 0.4, 0.6]]), torch.tensor([0.5]), cam,
                          torch.ones(1, dtype=torch.bool))
    q, _ = GSR.leaves_of(prep)
    mx, my = prep.mean2d[0]
    a, c, _, _, _, _ = GSR.chunk_fn(q)(torch.tensor([[0]]), torch.ones(1, 1, 1, dtype=torch.bool),
                                       torch.tensor([[[int(round(float(mx))), 0]]]),
                                       torch.tensor([[[int(round(float(my))), 0]]]), None)
    assert bool(c[0, 0, 0]) and not bool(c[0, 0, 1])
    assert 0.4 < float(a[0, 0, 0]) <= 0.5


@pytest.mark.parametrize("cell", ["city-mesh-train", "scaffold-train"])
def test_reference_step_is_finite_and_deterministic(cell):
    from benchmark import control as K
    from benchmark.tests.conftest import spec, tiny
    r1 = K.readings(cell, 11, faults=("half_batch",), device="cpu", overrides=tiny, spec=spec())
    r2 = K.readings(cell, 11, faults=("half_batch",), device="cpu", overrides=tiny, spec=spec())
    assert r1["half_batch"]["grad_gap"] == r2["half_batch"]["grad_gap"]
    assert r1["half_batch"]["grad_gap"] > 1e-3
