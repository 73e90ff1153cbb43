"""The port's Scaffold-GS model and trainer against the JAX package's on
the CPU, at the JAX tests' small widths (feat 8, hidden 16, k 4):

- the model functions on one numpy state: the init (heads, anchors,
  features, capacity), the decode, Adam, the statistics, the growth level
  by level with JAX's coin flips (bit for bit on given decoded positions),
  the whole growth, the pruning and the pretrain helpers; the weights'
  conversion both ways;
- ``forward``'s render and gradients (the port's plain kernel versions and
  oracle against the JAX oracle);
- the trainers in lockstep for 30 steps with one anchor update (the JAX
  trainer on its dense oracle, the port's on its plain kernel versions),
  a pretrain lockstep, the checkpoint both ways, the PLY against JAX's
  ``savePLY``, and the smoke ``--model scaffold`` quick check at 48x48.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.models import scaffold as JS
from triangle_splatting_tpu.ops.projection import RasterSettings as JRasterSettings
from triangle_splatting_tpu.utils.testing import make_camera as j_make_camera
from triangle_splatting_tpu_torch.convert import scaffold_from_numpy, scaffold_to_numpy
from triangle_splatting_tpu_torch.models import scaffold as TS
from triangle_splatting_tpu_torch.ops.projection import RasterSettings
from triangle_splatting_tpu_torch.utils.testing import make_camera
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(feat_dim=8, hidden_dim=16, n_offsets=4, max_offset_scale=2.0, max_scaling_scale=1.5,
          update_depth=2, update_init_factor=4, update_hierachy_factor=4)
JCFG, TCFG = JS.ScaffoldConfig(**KW), TS.ScaffoldConfig(**KW)


def tree_np(x):
    """A JAX Scaffold container (or dict of them) as nested dicts of numpy."""
    if dataclasses.is_dataclass(x):
        return {f.name: tree_np(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: tree_np(v) for k, v in x.items()}
    return np.asarray(x)


def jax_model(params, state, opt=None):
    """JAX containers from the nested numpy dicts of ``scaffold_to_numpy``."""
    def p(d):
        return JS.ScaffoldParams(anchor=jnp.asarray(d["anchor"]),
                                 anchor_feat=jnp.asarray(d["anchor_feat"]),
                                 mlps=jax.tree_util.tree_map(jnp.asarray, d["mlps"]))
    st = JS.ScaffoldState(**{k: jnp.asarray(v) for k, v in state.items()})
    o = None if opt is None else JS.ScaffoldAdamState(m=p(opt["m"]), v=p(opt["v"]),
                                                      step=jnp.int32(opt["step"]))
    return p(params), st, o


def assert_trees(want, got, rtol=0.0, atol=0.0, path=""):
    if isinstance(want, dict):
        assert set(want) == set(got), (path, set(want) ^ set(got))
        for k in want:
            assert_trees(want[k], got[k], rtol, atol, f"{path}.{k}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=path)


def both_models(n=20, cap=64, voxel=0.5, seed=0, **kw):
    """The same point cloud through both ``create_from_points``."""
    pts = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    jp, js = JS.create_from_points(pts, JCFG, voxel_size=voxel, capacity=cap, seed=seed, **kw)
    tp, ts = TS.create_from_points(pts, TCFG, voxel_size=voxel, capacity=cap, seed=seed,
                                   device="cpu", **kw)
    return (jp, js), (tp, ts)


def trained_model(seed=3, cap=64, n=40):
    """Numpy params / state / moments of a model away from its init: random
    features and heads, dead rows, statistics and view counts."""
    (jp, js), _ = both_models(n=n, cap=cap, voxel=0.4, seed=seed)
    rng = np.random.default_rng(seed + 10)
    p = tree_np(jp)
    p["anchor_feat"] = rng.normal(0, 0.5, p["anchor_feat"].shape).astype(np.float32)
    p["mlps"] = jax.tree_util.tree_map(
        lambda x: (x + rng.normal(0, 0.2, x.shape)).astype(np.float32), p["mlps"])
    s = tree_np(js)
    C, k = cap, JCFG.n_offsets
    s["alive"] = s["alive"] & (rng.random(C) < 0.8)
    s["opacity_accum"] = rng.uniform(0, 2, C).astype(np.float32)
    s["anchor_denom"] = rng.integers(0, 4, C).astype(np.float32)
    s["offset_grad_accum"] = rng.uniform(0, 1e-3, (C, k)).astype(np.float32)
    s["offset_denom"] = rng.integers(0, 4, (C, k)).astype(np.float32)
    s["opacity_threshold"] = np.float32(0.3)
    f = lambda x: rng.normal(size=x.shape).astype(np.float32)  # noqa: E731
    o = dict(m=jax.tree_util.tree_map(f, p), v=jax.tree_util.tree_map(lambda x: abs(f(x)), p),
             step=np.int32(5))
    return p, s, o


# ---------------------------------------------------------------------------
# model functions on one numpy state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("voxel,bbox", [(0.5, None), (0.0, None),
                                         (0.3, [-0.5, -0.5, -0.5, 0.5, 0.5, 0.5])],
                         ids=["voxel", "median_voxel", "outside_box"])
def test_create_from_points_matches_jax(voxel, bbox):
    """Anchors (the box's outside on the coarser grid), features, the heads'
    draws and the state: equal, bit for bit; capacity rounded to 256."""
    pts = np.random.default_rng(4).normal(size=(300, 3)).astype(np.float32)
    jp, js = JS.create_from_points(pts, JCFG, voxel_size=voxel, scene_bbox=bbox, seed=2)
    tp, ts = TS.create_from_points(pts, TCFG, voxel_size=voxel, scene_bbox=bbox, seed=2,
                                   device="cpu")
    p, s, _ = scaffold_to_numpy(tp, ts)
    assert tp.capacity == jp.capacity and tp.capacity % 256 == 0
    assert_trees(tree_np(jp), p)
    assert_trees(tree_np(js), s)


def test_convert_round_trip():
    p, s, o = trained_model()
    tp, ts, to = scaffold_from_numpy(p, s, o, device="cpu")
    assert to.step == 5 and ts.alive.dtype == torch.bool
    p2, s2, o2 = scaffold_to_numpy(tp, ts, to)
    assert_trees(p, p2)
    assert_trees(s, s2)
    assert_trees(o, o2)
    assert sorted(tp.leaves())[:3] == ["anchor", "anchor_feat", "mlps.color.b1"]


def test_decode_matches_jax():
    """The heads' scales, the decoded Gaussians and the raw pretrain outputs:
    the products' summation order differs (XLA against ATen), so rel 1e-5
    on values of order 1."""
    p, s, o = trained_model()
    jp, js, _ = jax_model(p, s)
    tp, ts, _ = scaffold_from_numpy(p, s, device="cpu")
    for j, t in zip(JS.anchor_scaling_heads(jp, js, JCFG), TS.anchor_scaling_heads(tp, ts, TCFG)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-9)
    jd, td = JS.generate_gaussians(jp, js, JCFG), TS.generate_gaussians(tp, ts, TCFG)
    for k in jd:
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    jr, tr = JS.get_raw_output(jp, JCFG), TS.get_raw_output(tp, TCFG)
    for k in jr:
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_adam_and_moment_masks_match_jax():
    """One Adam step (lr per group, the heads by mlp_<head>, a missing group
    at 0) and the anchor-moment reset: equal to 1 ulp."""
    p, s, o = trained_model()
    rng = np.random.default_rng(9)
    g = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32), p)
    lrs = {"anchor": 0.01, "anchor_feat": 0.05, "mlp_offset": 0.02, "mlp_cov": 0.003,
           "mlp_color": 0.004, "mlp_scaling": 0.001}
    jp, _, jo = jax_model(p, s, o)
    jg, _, _ = jax_model(g, s)
    tp, _, to = scaffold_from_numpy(p, s, o, device="cpu")
    tg, _, _ = scaffold_from_numpy(g, s, device="cpu")
    jp2, jo2 = JS.adam_update(jp, jo, jg, {k: np.float32(v) for k, v in lrs.items()})
    tp2, to2 = TS.adam_update(tp, to, tg, lrs)
    mask = np.asarray(s["alive"]) & (np.arange(len(s["alive"])) % 3 == 0)
    jo2 = JS.zero_anchor_moments(jo2, jnp.asarray(mask))
    to2 = TS.zero_anchor_moments(to2, torch.as_tensor(mask))
    p2, _, o2 = scaffold_to_numpy(tp2, scaffold_from_numpy(p, s, device="cpu")[1], to2)
    assert_trees(tree_np(jp2), p2, rtol=2e-7)
    assert_trees(tree_np(jo2), o2, rtol=2e-7)
    assert not o2["m"]["anchor"][mask].any() and o2["m"]["mlps"]["opacity"]["w1"].any()


def test_update_statistics_and_prune_match_jax():
    """The statistics update inside and outside the window, and the opacity
    pruning with its resets: bit for bit."""
    p, s, o = trained_model()
    C, k = s["alive"].shape[0], JCFG.n_offsets
    rng = np.random.default_rng(5)
    pkg = dict(anchor_visible_mask=s["alive"] & (rng.random(C) < 0.7),
               gaussian_visible_mask=rng.random((C, k)) < 0.6,
               gaussian_opacity=rng.uniform(0, 1, (C, k)).astype(np.float32))
    m2d = rng.normal(0, 1e-3, (C * k, 2)).astype(np.float32)
    jp, js, jo = jax_model(p, s, o)
    tp, ts, to = scaffold_from_numpy(p, s, o, device="cpu")
    for gate in (True, False):
        js2 = JS.update_statistics(js, jnp.asarray(m2d),
                                   {n: jnp.asarray(v) for n, v in pkg.items()}, k, gate=gate)
        ts2 = TS.update_statistics(ts, torch.as_tensor(m2d),
                                   {n: torch.as_tensor(v) for n, v in pkg.items()}, k, gate=gate)
        assert_trees(tree_np(js2), scaffold_to_numpy(tp, ts2)[1])
    jout = JS.prune_anchors(jp, jo, js2, np.float32(0.4), np.float32(1.0))
    tout = TS.prune_anchors(tp, to, ts2, 0.4, 1.0)
    assert int(tout[3]) == int(jout[3]) > 0
    _, s3, o3 = scaffold_to_numpy(tout[0], tout[2], tout[1])
    assert_trees(tree_np(jout[2]), s3)
    assert_trees(tree_np(jout[1]), o3)


def jax_coins(key, C, k, depth):
    """The coin flips JAX ``grow_anchors`` draws from ``key``, level by level."""
    out = []
    for _ in range(depth):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.uniform(sub, (C, k))))
    return out


@pytest.mark.parametrize("cap_dead,level", [(None, 0), (None, 1), (3, 0)],
                         ids=["level0", "level1", "overflow"])
def test_grow_level_matches_jax_bit_for_bit(cap_dead, level):
    """``_grow_level`` on given decoded positions, gradients and coins:
    anchors, features, moments and state equal bit for bit, the emitted
    count and the overflow flag equal. ``cap_dead`` leaves that many dead
    slots, so that the candidates overflow them."""
    p, s, o = trained_model(n=60, cap=256)
    C, k = s["alive"].shape[0], JCFG.n_offsets
    if cap_dead is not None:
        s["alive"] = np.arange(C) < C - cap_dead
    rng = np.random.default_rng(11)
    grad = rng.uniform(0, 2e-4, (C, k)).astype(np.float32)
    offset_mask = rng.random((C, k)) < 0.8
    g_xyz = (p["anchor"][:, None] + rng.normal(0, 0.6, (C, k, 3))).reshape(-1, 3)
    g_xyz = g_xyz.astype(np.float32)
    jp, js, jo = jax_model(p, s, o)
    tp, ts, to = scaffold_from_numpy(p, s, o, device="cpu")
    # the JAX function draws its coins from a key: hand its draws to the port
    key = jax.random.PRNGKey(7)
    jcoins = np.array(jax.random.uniform(key, (C, k)))
    jout = JS._grow_level(jp, jo, js, key, jnp.asarray(grad), jnp.asarray(offset_mask),
                          jnp.asarray(g_xyz), level, JCFG, np.float32(5e-5))
    tout = TS._grow_level(tp, to, ts, torch.as_tensor(jcoins), torch.as_tensor(grad),
                          torch.as_tensor(offset_mask), torch.as_tensor(g_xyz), level, TCFG,
                          np.float32(5e-5))
    p2, s2, o2 = scaffold_to_numpy(tout[0], tout[2], tout[1])
    assert_trees(tree_np(jout[0]), p2)
    assert_trees(tree_np(jout[2]), s2)
    assert_trees(tree_np(jout[1]), o2)
    assert int(tout[3]) == int(jout[3]) > 0
    assert bool(tout[4]) == bool(jout[4]) == (cap_dead is not None)


def test_grow_anchors_matches_jax():
    """Both levels with JAX's key splits as coins, from the decoded
    positions of each package: every decoded coordinate lies further from
    a rounding boundary (.5 of a voxel) than the decode's measured
    difference, so the voxels, and then every array, agree exactly."""
    p, s, o = trained_model(n=60)
    C, k = s["alive"].shape[0], JCFG.n_offsets
    rng = np.random.default_rng(12)
    s["offset_grad_accum"] = rng.uniform(0, 4e-4, (C, k)).astype(np.float32)
    s["offset_denom"] = rng.integers(1, 4, (C, k)).astype(np.float32)
    jp, js, jo = jax_model(p, s, o)
    tp, ts, to = scaffold_from_numpy(p, s, o, device="cpu")
    jx = np.asarray(JS.generate_gaussians(jp, js, JCFG)["xyz"]).reshape(-1, 3)
    tx = TS.generate_gaussians(tp, ts, TCFG)["xyz"].reshape(-1, 3).numpy()
    diff = np.abs(jx - tx).max()
    for level in range(JCFG.update_depth):
        size = np.float32(s["voxel_size"]) * max(
            JCFG.update_init_factor // JCFG.update_hierachy_factor ** level, 1)
        frac = np.abs(np.abs((jx / size) % 1.0) - 0.5)
        assert frac.min() * size > 4 * diff, (level, frac.min() * size, diff)
    key = jax.random.PRNGKey(3)
    jout = JS.grow_anchors(jp, jo, js, key, JCFG, np.float32(1e-4), np.float32(1.0))
    tout = TS.grow_anchors(tp, to, ts, TCFG, np.float32(1e-4), 1.0,
                           coins=jax_coins(key, C, k, JCFG.update_depth))
    p2, s2, o2 = scaffold_to_numpy(tout[0], tout[2], tout[1])
    assert_trees(tree_np(jout[0]), p2)
    assert_trees(tree_np(jout[2]), s2)
    assert_trees(tree_np(jout[1]), o2)
    assert int(tout[3]) == int(jout[3]) > 0 and bool(tout[4]) == bool(jout[4])


def test_gt_gaussian_to_gt_pkg_matches_jax():
    """Voxels holding more Gaussians than k keep the k most important; the
    package equals JAX's bit for bit."""
    rng = np.random.default_rng(0)
    n = 300
    args = (rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 1)),
            rng.normal(size=(n, 3)) - 2.0, rng.normal(size=(n, 4)), rng.normal(size=(n, 3)))
    want = JS.gt_gaussian_to_gt_pkg(*args, voxel_size=0.8, n_offsets=4)
    got = TS.gt_gaussian_to_gt_pkg(*args, voxel_size=0.8, n_offsets=4)
    assert_trees(want, got)
    assert np.bincount(np.unique(np.round(args[0] / 0.8), axis=0, return_inverse=True)[1]
                       .reshape(-1)).max() > 4


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def scene_model():
    """A model in front of the identity camera: 30 anchors at z 3-5."""
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(-1, 1, 30), rng.uniform(-1, 1, 30),
                    rng.uniform(3, 5, 30)], -1).astype(np.float32)
    cfg_kw = dict(KW, max_offset_scale=0.3, max_scaling_scale=0.3)
    jcfg, tcfg = JS.ScaffoldConfig(**cfg_kw), TS.ScaffoldConfig(**cfg_kw)
    jp, js = JS.create_from_points(pts, jcfg, voxel_size=0.05, capacity=64, seed=1)
    p, s = tree_np(jp), tree_np(js)
    p["anchor_feat"] = (p["anchor_feat"] * 5).astype(np.float32)
    s["alive"] = s["alive"] & (np.arange(64) != 3)
    s["opacity_threshold"] = np.float32(0.45)
    return p, s, jcfg, tcfg


@pytest.mark.parametrize("impl", ["cuda", "oracle"])
def test_forward_render_and_grads_match_jax(impl):
    """``forward`` at 48x40 (tiles 16x16): the render, the masks and the
    gradients of a squared loss with respect to every leaf and the center
    offset, the port's plain kernel versions (``impl="cuda"`` on the CPU)
    and its oracle against the JAX oracle. Render abs 1e-5, gradients rel
    1e-4 of each leaf's largest."""
    p, s, jcfg, tcfg = scene_model()
    W, H = 48, 40
    jcam, tcam = j_make_camera(W, H), make_camera(W, H, device="cpu")
    jset = JRasterSettings(image_width=W, image_height=H, max_sh_degree=0)
    tset = RasterSettings(image_width=W, image_height=H, max_sh_degree=0,
                          rasterizer_type="GS")
    target = np.random.default_rng(2).uniform(0, 1, (3, H, W)).astype(np.float32)
    N = 64 * jcfg.n_offsets
    jp, js, _ = jax_model(p, s)

    def jloss(params, m2d):
        pkg = JS.forward(params, js, jcam, jnp.ones(3), jcfg, jset, mean2d_offset=m2d,
                         impl="oracle")
        return ((pkg["render"] - target) ** 2).sum(), pkg
    (jl, jpkg), (jg, jm) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.zeros((N, 2)))
    tp, ts, _ = scaffold_from_numpy(p, s, device="cpu")
    leaves = {n: t.requires_grad_(True) for n, t in tp.leaves().items()}
    m2d = torch.zeros((N, 2), requires_grad=True)
    tpkg = TS.forward(TS.ScaffoldParams.from_leaves(leaves), ts, tcam, torch.ones(3), tcfg,
                      tset, mean2d_offset=m2d, impl=impl)
    if impl == "cuda":
        assert not bool(tpkg["contrib_sum"].any())          # no statistics
    tl = ((tpkg["render"] - torch.as_tensor(target)) ** 2).sum()
    tg = torch.autograd.grad(tl, list(leaves.values()) + [m2d])
    np.testing.assert_allclose(tpkg["render"].detach().numpy(), np.asarray(jpkg["render"]),
                               atol=1e-5)
    for name in ("selection_mask", "anchor_visible_mask", "gaussian_visible_mask"):
        np.testing.assert_array_equal(tpkg[name].numpy(), np.asarray(jpkg[name]), err_msg=name)
    sel = tpkg["selection_mask"].numpy()
    assert 0 < sel.sum() < sel.size and tpkg["anchor_visible_mask"].sum() > 10
    jflat = dict(anchor=jg.anchor, anchor_feat=jg.anchor_feat,
                 **{f"mlps.{h}.{x}": jg.mlps[h][x] for h in JS.MLP_HEADS for x in TS.MLP_LEAVES})
    jflat["m2d"] = jm
    for (name, want), got in zip(jflat.items(), tg):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-4, (name, err)
