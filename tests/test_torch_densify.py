"""Densification, scale clipping, opacity reset and capacity growth of the
port against the JAX package, for triangles and Gaussians, each on one
numpy state fed to both.

Every leaf of params, Adam moments and state is compared: the alive mask,
the grown count, the overflow flag and the slot placement bit for bit, the
floats to 1e-6 relative (atol 1e-7 for values near 0). The Gaussian split
draws its two normal samples inside the JAX function; the test draws the
same JAX samples and hands them to the port's ``densify(noise=...)``, so
both place the same rows."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.models import gaussian_model as JG
from triangle_splatting_tpu.models import triangle as JM
from triangle_splatting_tpu.trainers import adc_utils as JU
from triangle_splatting_tpu.utils.testing import make_random_scene
from triangle_splatting_tpu_torch.convert import (gaussian_from_numpy, gaussian_to_numpy,
                                                  triangle_from_numpy, triangle_to_numpy)
from triangle_splatting_tpu_torch.models import gaussian_model as TG
from triangle_splatting_tpu_torch.models import triangle as TM
from triangle_splatting_tpu_torch.trainers import adc_utils as TU
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

RTOL, ATOL = 1e-6, 1e-7
CFG = JM.ModelConfig(max_sh_degree=1)


def leaves(tree):
    """numpy leaves of a JAX dataclass keyed by field name (None kept)."""
    return {f.name: None if getattr(tree, f.name) is None else np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def assert_same(jax_out, torch_out, to_numpy):
    """(params, opt, state[, count[, overflow]]) of the JAX and the port
    function: bools and integers exact, floats to RTOL."""
    jp, jo, js, *jrest = jax_out
    tp, to, ts, *trest = torch_out
    bp, bs, bo = to_numpy(tp, ts, to)

    def cmp(want, got, name):
        if want is None:
            assert got is None, name
            return
        assert got.shape == want.shape and got.dtype == want.dtype, (name, got.shape, want.shape)
        if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
    for name, want in leaves(jp).items():
        cmp(want, bp[name], name)
    for which in ("m", "v"):
        for name, want in leaves(getattr(jo, which)).items():
            cmp(want, bo[which][name], f"{which}.{name}")
    assert int(bo["step"]) == int(jo.step)
    for name, want in leaves(js).items():
        cmp(want, bs[name], f"state.{name}")
    for want, got in zip(jrest, trest):
        assert int(np.asarray(want)) == int(got)


# ---------------------------------------------------------------------------
# triangles
# ---------------------------------------------------------------------------

def triangle_model(n, seed=0, capacity=None, alive=None, accum=None, denom=None,
                   moments_seed=None):
    """A JAX triangle model as test_model.py builds it (create_from_points
    on a random scene's centroids, opacity 0.3), with the statistics and
    alive mask overridden, and random Adam moments so that the zeroing of
    placed rows shows. Returns numpy (params, state, opt) dicts."""
    s = make_random_scene(n, seed=seed)
    params, state = JM.create_from_points(s["vertex"].mean(1), s["rgb"], None, CFG,
                                          init_opacity=0.3, capacity=capacity)
    p, st = leaves(params), leaves(state)
    C = p["vertex"].shape[0]
    if alive is not None:
        st["alive"] = np.asarray(alive(C), bool)
    if accum is not None:
        st["gradient_accum"] = np.asarray(accum(C, st["alive"]), np.float32)
    if denom is not None:
        st["gradient_denom"] = np.asarray(denom(C, st["alive"]), np.float32)
    rng = np.random.default_rng(moments_seed if moments_seed is not None else seed + 100)
    for name in ("max_radii2d", "contrib_sum", "contrib_max", "contrib_denom"):
        st[name] = np.where(st["alive"], rng.uniform(0, 5, C), 0).astype(np.float32)
    m = {k: None if x is None else rng.normal(size=x.shape).astype(np.float32)
         for k, x in p.items()}
    v = {k: None if x is None else np.abs(rng.normal(size=x.shape)).astype(np.float32)
         for k, x in p.items()}
    return p, st, dict(m=m, v=v, step=7)


def to_jax_triangle(p, st, o):
    tp = lambda d: JM.TriangleParams(**{k: None if x is None else jnp.asarray(x)  # noqa: E731
                                        for k, x in d.items()})
    return (tp(p), JM.TriangleState(**{k: jnp.asarray(x) for k, x in st.items()}),
            JM.AdamState(m=tp(o["m"]), v=tp(o["v"]), step=jnp.int32(o["step"])))


def both_triangle(p, st, o):
    jp, js, jo = to_jax_triangle(p, st, o)
    tp, ts, to = triangle_from_numpy(p, st, o, device="cpu")
    return (jp, jo, js), (tp, to, ts)


def sorted_scaling(p, n):
    return np.sort(np.asarray(JM.get_scaling(JM.TriangleParams(
        **{k: None if x is None else jnp.asarray(x) for k, x in p.items()})))[:n])


def high(first):
    """gradient_accum: 100 on the first ``first`` rows, 0 elsewhere."""
    return lambda C, alive: np.where(np.arange(C) < first, 100.0, 0.0)


def seen(C, alive):
    return np.where(alive, 10.0, 0.0)


def every(C):
    return np.ones(C, bool)


# the cases of tests/test_model.py: (model kwargs, grad threshold, min views,
# split threshold (None: the median of the first 16 scalings))
TRIANGLE_CASES = {
    "clone_and_split": (dict(n=16, accum=high(8), denom=seen), 0.1, 1, None),
    "split_geometry": (dict(n=4, accum=high(1), denom=seen), 0.1, 1, 0.0),
    "overflow_reported": (dict(n=16, capacity=256, alive=every,
                               accum=lambda C, a: np.full(C, 100.0),
                               denom=lambda C, a: np.full(C, 10.0)), 0.1, 1, 1e9),
    "overflow_never_loses_geometry": (dict(n=16, capacity=256, alive=every,
                                           accum=lambda C, a: np.full(C, 100.0),
                                           denom=lambda C, a: np.full(C, 10.0)), 0.1, 1, 0.0),
}


@pytest.mark.parametrize("case", sorted(TRIANGLE_CASES))
def test_triangle_densify_cases_match_jax(case):
    kw, thr, mvc, split = TRIANGLE_CASES[case]
    p, st, o = triangle_model(**kw)
    if split is None:
        split = float(sorted_scaling(p, 16)[8])
    (jp, jo, js), (tp, to, ts) = both_triangle(p, st, o)
    jout = JM.densify(jp, jo, js, np.float32(thr), mvc, np.float32(split))
    tout = TM.densify(tp, to, ts, float(np.float32(thr)), mvc, float(np.float32(split)))
    assert_same(jout, tout, triangle_to_numpy)
    alive0 = st["alive"]
    alive1 = tout[2].alive.numpy()
    if case == "overflow_never_loses_geometry":
        assert bool(tout[4]) and alive1.sum() == alive0.sum()
    if case == "split_geometry":
        assert not alive1[0] and alive1.sum() == alive0.sum() + 1


def random_triangle_state(n_alive, C, seed):
    """n_alive random rows alive among C (spread over the capacity), about
    a third of them above the gradient threshold, view counts 0-4."""
    rng = np.random.default_rng(seed)

    def alive(C):
        a = np.zeros(C, bool)
        a[rng.choice(C, n_alive, replace=False)] = True
        return a
    return dict(n=n_alive, capacity=C, seed=seed, alive=alive,
                accum=lambda C, a: rng.uniform(0, 3, C) * a,
                denom=lambda C, a: rng.integers(0, 5, C).astype(np.float64) * a)


@pytest.mark.parametrize("n_alive,C,seed", [
    (300, 512, 1),      # room for every candidate: clones and splits
    (490, 512, 2),      # 22 dead slots: capacity boundary mid-list
    (505, 512, 3),
    (509, 512, 4),
])
def test_triangle_densify_random_state_matches_jax(n_alive, C, seed):
    """Clones and splits both fire; with few dead slots the boundary falls
    inside the candidate list (overflow, and for some seeds the orphan-half
    rule), and slot placement must still be the JAX one bit for bit."""
    p, st, o = triangle_model(**random_triangle_state(n_alive, C, seed))
    split = float(np.median(sorted_scaling(p, C)[-n_alive:]))
    (jp, jo, js), (tp, to, ts) = both_triangle(p, st, o)
    args = (np.float32(0.5), 2, np.float32(split))
    jout = JM.densify(jp, jo, js, *args)
    tout = TM.densify(tp, to, ts, *(float(a) if i != 1 else a for i, a in enumerate(args)))
    assert_same(jout, tout, triangle_to_numpy)
    grow = (st["gradient_denom"] >= 2) & (st["gradient_accum"] > 0.5 * st["gradient_denom"]) \
        & st["alive"]
    assert grow.sum() > 20
    alive1 = tout[2].alive.numpy()
    placed = int((alive1 & ~st["alive"]).sum())
    pruned = int((st["alive"] & ~alive1).sum())
    if n_alive == 300:
        assert placed > 0 and pruned > 0 and not bool(tout[4])
    else:
        assert bool(tout[4]) and placed <= C - n_alive


def test_triangle_densify_orphan_half_held_back():
    """Three dead slots, two splits first in line: the second split's half
    1 would land in the last slot without its half 2, so it is held back;
    the first split is placed whole and its original pruned, the second
    original stays."""
    def alive(C):
        a = np.ones(C, bool)
        a[[5, 9, 200]] = False
        return a
    p, st, o = triangle_model(n=256, capacity=256, alive=alive,
                              accum=lambda C, a: np.where(np.isin(np.arange(C), [0, 1]),
                                                          100.0, 0.0),
                              denom=lambda C, a: np.full(C, 10.0))
    (jp, jo, js), (tp, to, ts) = both_triangle(p, st, o)
    jout = JM.densify(jp, jo, js, np.float32(0.1), 1, np.float32(0.0))
    tout = TM.densify(tp, to, ts, 0.1, 1, 0.0)
    assert_same(jout, tout, triangle_to_numpy)
    alive1 = tout[2].alive.numpy()
    assert alive1[5] and alive1[9] and not alive1[200]      # two halves placed
    assert not alive1[0] and alive1[1] and bool(tout[4])


@pytest.mark.parametrize("hold", [False, True])
def test_triangle_scale_clipping_and_opacity_reset_match_jax(hold):
    p, st, o = triangle_model(**random_triangle_state(200, 256, 5))
    target = float(np.median(sorted_scaling(p, 256)[-200:]))
    (jp, jo, js), (tp, to, ts) = both_triangle(p, st, o)
    jout = JM.scale_clipping(jp, jo, js, np.float32(target))
    tout = TM.scale_clipping(tp, to, ts, target)
    assert_same(jout, tout, triangle_to_numpy)
    assert int(tout[3]) > 0
    s1 = TM.get_scaling(tout[0])[tout[2].alive]
    assert bool((s1 <= target * 1.001).all())
    reset = 0.1 if hold else 0.01
    jout = JM.opacity_reset(*jout[:3], np.float32(reset))
    tout = TM.opacity_reset(*tout[:3], reset)
    assert_same(jout, tout, triangle_to_numpy)
    assert not tout[1].m.opacity.any() and not tout[1].v.opacity.any()


# ---------------------------------------------------------------------------
# Gaussians
# ---------------------------------------------------------------------------

def gaussian_model(n, seed=0, capacity_factor=4.0, alive=None, accum=None, denom=None,
                   log_scale=None):
    """A JAX Gaussian model on a random point set (create_from_points,
    SH degree 0 or 1), statistics overridden, random Adam moments. Returns
    numpy (params, state, opt) dicts."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    params, state = JG.create_from_points(pts, cols, JG.GSModelConfig(max_sh_degree=1),
                                          init_opacity=0.5, capacity_factor=capacity_factor)
    p, st = leaves(params), leaves(state)
    C = p["xyz"].shape[0]
    p["rotation"] = np.where(st["alive"][:, None], rng.normal(size=(C, 4)),
                             p["rotation"]).astype(np.float32)
    if log_scale is not None:
        p["scaling"] = np.where(st["alive"][:, None], rng.uniform(*log_scale, (C, 3)),
                                p["scaling"]).astype(np.float32)
    if alive is not None:
        st["alive"] = np.asarray(alive(C), bool)
    if accum is not None:
        st["gradient_accum"] = np.asarray(accum(C, st["alive"]), np.float32)
    if denom is not None:
        st["gradient_denom"] = np.asarray(denom(C, st["alive"]), np.float32)
    m = {k: rng.normal(size=x.shape).astype(np.float32) for k, x in p.items()}
    v = {k: np.abs(rng.normal(size=x.shape)).astype(np.float32) for k, x in p.items()}
    return p, st, dict(m=m, v=v, step=4)


def both_gaussian(p, st, o):
    tp = lambda d: JG.GaussianParams(**{k: jnp.asarray(x) for k, x in d.items()})  # noqa: E731
    j = (tp(p), JG.GSAdamState(m=tp(o["m"]), v=tp(o["v"]), step=jnp.int32(o["step"])),
         JG.GaussianState(**{k: jnp.asarray(x) for k, x in st.items()}))
    tpp, tst, top = gaussian_from_numpy(p, st, o, device="cpu")
    return j, (tpp, top, tst)


def jax_noise(key, C):
    """The two (C, 3) normal draws JAX densify makes from ``key``."""
    return (np.asarray(jax.random.normal(key, (C, 3))),
            np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (C, 3))))


GAUSSIAN_CASES = {
    # tests/test_gaussian.py: 16 splits at capacity factor 4
    "densify_and_prune": (dict(n=32, accum=lambda C, a: np.where(np.arange(C) < 16, 10.0, 0.0),
                               denom=lambda C, a: np.where(a, 5.0, 0.0)), 0.1, 1, 0.0),
    # clones (small) and splits (large) in one call
    "clone_and_split": (dict(n=120, seed=3, log_scale=(-4.0, 0.0),
                             accum=lambda C, a: np.where(np.arange(C) % 3 == 0, 10.0, 0.0) * a,
                             denom=lambda C, a: np.where(a, 5.0, 0.0)), 0.1, 1, 0.2),
    # no room: every alive row grows into 0 dead slots
    "overflow": (dict(n=256, capacity_factor=1.0, accum=lambda C, a: np.full(C, 10.0),
                      denom=lambda C, a: np.full(C, 5.0)), 0.1, 1, 0.0),
}


@pytest.mark.parametrize("case", sorted(GAUSSIAN_CASES))
def test_gaussian_densify_matches_jax_with_its_noise(case):
    kw, thr, mvc, split = GAUSSIAN_CASES[case]
    p, st, o = gaussian_model(**kw)
    (jp, jo, js), (tp, to, ts) = both_gaussian(p, st, o)
    key = jax.random.PRNGKey(0)
    C = p["xyz"].shape[0]
    jout = JG.densify(jp, jo, js, key, np.float32(thr), mvc, np.float32(split))
    eps = tuple(torch.tensor(e) for e in jax_noise(key, C))
    tout = TG.densify(tp, to, ts, thr, mvc, split, noise=eps)
    assert_same(jout, tout, gaussian_to_numpy)
    alive0, alive1 = st["alive"], tout[2].alive.numpy()
    if case == "densify_and_prune":
        assert int(tout[3]) == 16 and alive1.sum() == 32 + 16
    if case == "clone_and_split":
        grown = (alive1 & ~alive0).sum()
        assert grown > int(tout[3]) > 0 and (alive0 & ~alive1).sum() > 0
    if case == "overflow":
        assert bool(tout[4]) and alive1.sum() == alive0.sum()


def test_gaussian_densify_draws_from_the_generator():
    """Without noise the split draws from the given generator: the same
    seed gives the same placement, and it equals passing those draws."""
    p, st, o = gaussian_model(**GAUSSIAN_CASES["clone_and_split"][0])
    C = p["xyz"].shape[0]
    outs = []
    for _ in range(2):
        tp, ts, to = gaussian_from_numpy(p, st, o, device="cpu")
        gen = torch.Generator().manual_seed(3)
        outs.append(TG.densify(tp, to, ts, 0.1, 1, 0.2, generator=gen))
    tp, ts, to = gaussian_from_numpy(p, st, o, device="cpu")
    noise = TG.densify_noise(C, torch.Generator().manual_seed(3), "cpu")
    outs.append(TG.densify(tp, to, ts, 0.1, 1, 0.2, noise=noise))
    for other in outs[1:]:
        torch.testing.assert_close(other[0].xyz, outs[0][0].xyz, rtol=0, atol=0)
        assert torch.equal(other[2].alive, outs[0][2].alive)


def test_gaussian_scale_clipping_and_opacity_reset_match_jax():
    p, st, o = gaussian_model(n=100, seed=6, log_scale=(-3.0, 1.0))
    (jp, jo, js), (tp, to, ts) = both_gaussian(p, st, o)
    jout = JG.scale_clipping(jp, jo, js, np.float32(1.0))
    tout = TG.scale_clipping(tp, to, ts, 1.0)
    assert_same(jout, tout, gaussian_to_numpy)
    assert int(tout[3]) > 10
    jout = JG.opacity_reset(*jout[:3], np.float32(0.05))
    tout = TG.opacity_reset(*tout[:3], 0.05)
    assert_same(jout, tout, gaussian_to_numpy)


# ---------------------------------------------------------------------------
# capacity growth
# ---------------------------------------------------------------------------

def test_triangle_grow_capacity_matches_jax():
    """Every capacity-sized leaf zero-padded by 1.5x rounded to 256, the
    per-camera affine tables (here exactly as many as the capacity) left
    alone, the Adam step and the scalars untouched."""
    p, st, o = triangle_model(**random_triangle_state(200, 256, 7))
    C = 256
    rng = np.random.default_rng(0)
    p["affine_weight"] = rng.normal(size=(C, 3, 3)).astype(np.float32)
    p["affine_bias"] = rng.normal(size=(C, 3)).astype(np.float32)
    for d in (o["m"], o["v"]):
        d["affine_weight"] = rng.normal(size=(C, 3, 3)).astype(np.float32)
        d["affine_bias"] = rng.normal(size=(C, 3)).astype(np.float32)
    (jp, jo, js), (tp, to, ts) = both_triangle(p, st, o)
    jout = JU.grow_capacity(jp, jo, js)
    tout = TU.grow_capacity(tp, to, ts)
    assert tout[0].capacity == 512 and tout[0].affine_weight.shape == (C, 3, 3)
    assert_same((jout[0], jout[1], jout[2]), tout, triangle_to_numpy)
    assert not tout[0].vertex[C:].any() and not tout[2].alive[C:].any()
    assert not tout[1].m.f_rest[C:].any() and float(tout[2].gamma) == float(st["gamma"])


def test_gaussian_grow_capacity_restores_identity_quaternions():
    """The VanillaGS trainer's growth (both packages' ``_grow_capacity`` on
    a bare trainer object): zero pads, then w = 1 in the new dead slots'
    rotations; the old rows untouched."""
    from triangle_splatting_tpu.trainers.vanilla_gs import VanillaGSTrainer as JT
    from triangle_splatting_tpu_torch.trainers.vanilla_gs import VanillaGSTrainer as TT
    p, st, o = gaussian_model(n=200, seed=8, capacity_factor=1.0)
    (jp, jo, js), (tp, to, ts) = both_gaussian(p, st, o)
    jt, tt = object.__new__(JT), object.__new__(TT)
    jt.params, jt.opt, jt.state, jt.logger = jp, jo, js, None
    tt.params, tt.opt, tt.state, tt.logger = tp, to, ts, None
    jt._grow_capacity()
    tt._grow_capacity()
    assert tt.params.capacity == 512            # 1.5 x 256, rounded up to 256
    assert_same((jt.params, jt.opt, jt.state), (tt.params, tt.opt, tt.state), gaussian_to_numpy)
    rot = tt.params.rotation.numpy()
    np.testing.assert_array_equal(rot[256:], np.tile([1, 0, 0, 0], (256, 1)))
    np.testing.assert_array_equal(rot[:256], p["rotation"])


# ---------------------------------------------------------------------------
# the trainers' model update with the lifted blocks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from triangle_splatting_tpu_torch.utils.testing import build_synthetic_nerf_dataset
    return build_synthetic_nerf_dataset(tmp_path_factory.mktemp("densify_scene"), res=32,
                                        n_tri=80, pcd_points=300, device="cpu")


def adc_trainer_config(root, out_dir, kind):
    """A 100-step recipe whose densification, scale clipping and opacity
    reset all fire at step 20 (the Gaussians' split threshold so large
    that every grown row is a clone: no noise, so both packages place the
    same rows)."""
    lr = dict(v_init=1e-3, v_final=1e-3, max_steps=100)
    groups = ("vertex", "opacity", "f_dc", "f_rest") if kind == "VanillaTS" \
        else JG.GS_PARAM_GROUPS
    win = dict(start_iter=0, end_iter=100, interval_iter=20)
    return {
        "dataset": {"type": "NerfSynthetic", "local_dir": str(root), "background": "white",
                    "use_alpha_mask": False, "num_workers": 2, "pcd_path": "point_cloud.ply",
                    "hold_test_set": True},
        "model": {
            "max_sh_degree": 1, "pairs_per_triangle": 8,
            "sampling": {"sample_method": "direct", "init_opacity": 0.3},
            "optimizer": {g: lr for g in groups},
            "model_update": {
                "densification": dict(win, grad_threshold_init=0.5, grad_threshold_final=0.3,
                                      min_view_count=2,
                                      split_scale_threshold=0.05 if kind == "VanillaTS"
                                      else 1e9),
                "scale_clipping": dict(win, scale_max_init=0.08, scale_max_final=0.05),
                "opacity_reset": dict(win, reset_value=0.2),
            },
        },
        "trainer": {"type": kind, "output_dir": str(out_dir), "iterations": 100,
                    "initial_eval": False, "log_interval_iter": 10, "eval_interval_iter": 0,
                    "train_background": "white", "eval_background": "white", "w_ssim": 0.2,
                    "use_tensorboard": False, "seed": 0},
    }


@pytest.mark.parametrize("kind", ["VanillaTS", "VanillaGS"])
def test_trainer_model_update_blocks_match_jax(dataset, tmp_path, kind):
    """Both trainers build with the three blocks (capacity 2x / 4x the
    count), and at a firing their model updates leave equal models: the
    schedulers' thresholds, the order densify -> scale clipping -> opacity
    reset, the grown rows' slots."""
    from triangle_splatting_tpu.trainers import build_trainer as j_build
    from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
    from triangle_splatting_tpu_torch.trainers import build_trainer
    from triangle_splatting_tpu_torch.utils.config import dict_to_config
    jt = j_build(j_dict_to_config(adc_trainer_config(dataset, tmp_path / "j", kind)),
                 impl="oracle", log_file=False)
    jt._init_model()
    tt = build_trainer(dict_to_config(adc_trainer_config(dataset, tmp_path / "t", kind)),
                       device="cpu", log_file=False)
    tt._init_model()
    assert tt.params.capacity == jt.params.capacity == (1280 if kind == "VanillaGS" else 768)
    C = tt.params.capacity
    rng = np.random.default_rng(9)
    alive = np.asarray(jt.state.alive)
    accum = (rng.uniform(0, 3, C) * alive).astype(np.float32)
    denom = (rng.integers(0, 5, C) * alive).astype(np.float32)
    jt.state = dataclasses.replace(jt.state, gradient_accum=jnp.asarray(accum),
                                   gradient_denom=jnp.asarray(denom))
    if kind == "VanillaTS":
        conv, to_np = triangle_from_numpy, triangle_to_numpy
    else:
        conv, to_np = gaussian_from_numpy, gaussian_to_numpy
    tt.params, tt.state, tt.opt = conv(
        leaves(jt.params), leaves(jt.state),
        dict(m=leaves(jt.opt.m), v=leaves(jt.opt.v), step=jt.opt.step), device="cpu")
    if kind == "VanillaTS":
        # the densify log's [p50, p99, max, eligible] (the JAX trainer's helper)
        np.testing.assert_array_equal(TM.densify_stats(tt.state, 2).numpy(),
                                      np.asarray(jt._j_densify_stats(jt.state, 2)))
    for it in (19, 20):
        jt._model_update(it)
        tt._model_update(it)
    assert_same((jt.params, jt.opt, jt.state), (tt.params, tt.opt, tt.state), to_np)
    rec = tt.densify_history[0]
    assert rec["iteration"] == 20 and rec["grown"] > 0 and rec["placed"] > 0
    assert [(it, kind_) for it, kind_, _ in tt.prune_history] == [(20, "scale clipping")]
    assert tt.prune_history[0][2] > 0
    assert float(TM.get_opacity(tt.params).max() if kind == "VanillaTS"
                 else TG.get_opacity(tt.params).max()) <= 0.2 + 1e-6
