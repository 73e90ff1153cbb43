"""The Gaussian path of the port vs the JAX package: the covariances, the EWA
preprocess and the packed fields (with their VJP), the dense oracle, the
plain versions of B1-GS (all four forms) and B2-GS (both forms) against
the Pallas kernels in interpret mode and against float64 autograd,
``rasterize_gaussian`` against the JAX function, the Gaussian kill and
early-exit semantics (also with the kill entry past the CUDA kernels'
staged batches), dead-slot gradients and the ``GaussianRenderer`` facade.
Inputs are numpy arrays from a seed fed to both packages."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.models import gaussian_model as JG
from triangle_splatting_tpu.ops import gaussian as JGO
from triangle_splatting_tpu.ops.binning import bin_triangles
from triangle_splatting_tpu.ops.pallas import blend as JB
from triangle_splatting_tpu.ops.projection import RasterSettings as JRS
from triangle_splatting_tpu.ops.rasterize import pack_pair_fields
from triangle_splatting_tpu.ops.rasterize import rasterize_gaussian as j_rasterize_gs
from triangle_splatting_tpu.utils.testing import make_camera as j_camera
from triangle_splatting_tpu_torch.models import gaussian_model as TG
from triangle_splatting_tpu_torch.ops import gaussian as TGO
from triangle_splatting_tpu_torch.ops.cuda import blend as TB
from triangle_splatting_tpu_torch.ops.projection import RasterSettings as TRS
from triangle_splatting_tpu_torch.ops.rasterize import rasterize_gaussian as t_rasterize_gs
from triangle_splatting_tpu_torch.renderer import GaussianRenderer
from triangle_splatting_tpu_torch.utils.testing import make_camera as t_camera
from triangle_splatting_tpu_torch.utils.testing import make_gs_scene, make_gs_stack_scene
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

GEO = dict(tile_h=32, tile_w=32)
KEYS = ("xyz", "scale", "rot", "opacity", "rgb")


def rel(got, want):
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def scene_of(kind, P, seed):
    if kind == "kill":
        return make_gs_stack_scene(P, seed, opacity=0.025)
    return make_gs_scene(P, seed=seed)


# ---------------------------------------------------------------------------
# covariances, preprocess, fields
# ---------------------------------------------------------------------------

class TestCov:
    def test_quat_identity(self):
        r = TGO.quat_to_rotmat(torch.tensor([[1.0, 0, 0, 0]]))
        np.testing.assert_allclose(r[0].numpy(), np.eye(3), atol=1e-6)

    def test_cov3d_isotropic(self):
        cov = TGO.build_cov3d(torch.full((1, 3), 2.0), torch.tensor([[1.0, 0, 0, 0]]))
        np.testing.assert_allclose(cov[0].numpy(), 4.0 * np.eye(3), atol=1e-5)

    def test_cov3d_rotation_invariant_trace(self):
        rng = np.random.default_rng(0)
        q = rng.normal(size=(5, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        s = rng.uniform(0.5, 2.0, (5, 3)).astype(np.float32)
        cov = TGO.build_cov3d(torch.as_tensor(s), torch.as_tensor(q)).numpy()
        np.testing.assert_allclose(np.trace(cov, axis1=1, axis2=2), (s ** 2).sum(1), rtol=1e-5)

    def test_matches_jax(self):
        """Float32 elementwise against the JAX einsum at HIGHEST: ulps."""
        rng = np.random.default_rng(1)
        q = rng.normal(size=(200, 4)).astype(np.float32)
        s = rng.uniform(0.01, 2.0, (200, 3)).astype(np.float32)
        np.testing.assert_allclose(TGO.quat_to_rotmat(torch.as_tensor(q)).numpy(),
                                   np.asarray(JGO.quat_to_rotmat(jnp.asarray(q))), atol=1e-6)
        got = TGO.build_cov3d(torch.as_tensor(s), torch.as_tensor(q), 0.7).numpy()
        want = np.asarray(JGO.build_cov3d(jnp.asarray(s), jnp.asarray(q), 0.7))
        assert rel(got, want) <= 1e-6


def prep_inputs(seed=3, P=200, dead=True):
    s = make_gs_scene(P, seed=seed)
    rng = np.random.default_rng(seed + 100)
    alive = rng.random(P) < (0.85 if dead else 1.1)
    rot = s["rot"].copy()
    rot[~alive] = 0.0                      # dead slots may hold zero quaternions
    off = rng.normal(size=(P, 2)).astype(np.float32) * 0.3
    return s, rot, alive, off


@pytest.mark.parametrize("tight", [True, False])
def test_preprocess_matches_jax(tight):
    """Screen centers, conics and depths to float32 ulps; valid, the tile
    rects, tiles touched and the radii exactly; with ``opacity`` and
    ``gamma`` the tight radius (gamma 2.5), else the 3-sigma one."""
    s, rot, alive, off = prep_inputs()
    W, H = 96, 64
    kw = dict(opacity=s["opacity"], gamma=np.float32(2.5)) if tight else {}
    jp = JGO.preprocess_gaussian(
        jnp.asarray(s["xyz"]), jnp.asarray(s["scale"]), jnp.asarray(rot), jnp.asarray(s["rgb"]),
        *(lambda c: (c.world_view, c.full_proj, c.tan_fovx, c.tan_fovy))(j_camera(W, H)),
        JRS(image_width=W, image_height=H), alive_mask=jnp.asarray(alive),
        mean2d_offset=jnp.asarray(off), scale_modifier=1.1,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    cam = t_camera(W, H, device="cpu")
    tp = TGO.preprocess_gaussian(
        torch.as_tensor(s["xyz"]), torch.as_tensor(s["scale"]), torch.as_tensor(rot),
        torch.as_tensor(s["rgb"]), cam.world_view, cam.full_proj, cam.tan_fovx, cam.tan_fovy,
        TRS(image_width=W, image_height=H, rasterizer_type="GS"),
        alive_mask=torch.as_tensor(alive), mean2d_offset=torch.as_tensor(off),
        scale_modifier=1.1, **{k: torch.as_tensor(v) for k, v in kw.items()})
    for name in ("valid", "rect_min", "rect_max", "tiles_touched", "radii"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    valid = tp.valid.numpy()
    assert 0.5 < valid.mean() < 1 and tp.radii.numpy().max() > 3
    np.testing.assert_allclose(tp.mean2d.numpy(), np.asarray(jp.mean2d), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tp.depth.numpy(), np.asarray(jp.depth), rtol=1e-6)
    assert rel(tp.conic.numpy()[valid], np.asarray(jp.conic)[valid]) <= 1e-5


def field_args(s, off):
    return [s["xyz"], s["scale"], s["rot"], s["opacity"], s["rgb"], off]


def test_field_matrix_and_vjp_match_jax():
    """``gaussian_field_matrix`` over the preprocess, forward and VJP
    against ``jax.vjp`` with the same random cotangent: fields to ulps of
    their magnitude, the gradients of xyz, scale, rotation, opacity, rgb
    and the center offset within rel 1e-4 of each one's max."""
    s, _, _, off = prep_inputs(seed=4, P=150, dead=False)
    W = H = 64
    st_j, st_t = JRS(image_width=W, image_height=H), TRS(image_width=W, image_height=H,
                                                         rasterizer_type="GS")
    jc, tc = j_camera(W, H), t_camera(W, H, device="cpu")
    gamma = np.float32(1.0)

    def jfun(xyz, scale, rot, op, rgb, m2d):
        p = JGO.preprocess_gaussian(xyz, scale, rot, rgb, jc.world_view, jc.full_proj,
                                    jc.tan_fovx, jc.tan_fovy, st_j, opacity=op, gamma=gamma,
                                    mean2d_offset=m2d)
        return JGO.gaussian_field_matrix(p, op)

    args = field_args(s, off)
    want, vjp = jax.vjp(jfun, *(jnp.asarray(a) for a in args))
    cot = np.random.default_rng(6).normal(size=want.shape).astype(np.float32)
    gwant = vjp(jnp.asarray(cot))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    p = TGO.preprocess_gaussian(leaves[0], leaves[1], leaves[2], leaves[4], tc.world_view,
                                tc.full_proj, tc.tan_fovx, tc.tan_fovy, st_t,
                                opacity=leaves[3], gamma=torch.tensor(gamma),
                                mean2d_offset=leaves[5])
    got = TGO.gaussian_field_matrix(p, leaves[3])
    assert rel(got.detach().numpy(), np.asarray(want)) <= 1e-6
    assert (np.abs(got.detach().numpy() - np.asarray(want)).max(axis=0)
            <= 1e-5 * np.abs(np.asarray(want)).max(axis=0) + 1e-7).all()
    ggot = torch.autograd.grad((got * torch.as_tensor(cot)).sum(), leaves)
    for name, g, w in zip(("xyz", "scale", "rot", "opacity", "rgb", "m2d"), ggot, gwant):
        assert rel(g.numpy(), np.asarray(w)) <= 1e-4, name
        assert np.abs(np.asarray(w)).max() > 0, name


# ---------------------------------------------------------------------------
# the dense oracle
# ---------------------------------------------------------------------------

def j_render(s, impl, gamma=1.0, W=64, H=64, rich=True, need_stats=True):
    jst = JRS(image_width=W, image_height=H, max_sh_degree=0, rich_info=rich)
    return {k: np.asarray(v) for k, v in j_rasterize_gs(
        *(jnp.asarray(s[k]) for k in KEYS[:4]), None, j_camera(W, H), jst, gamma=gamma,
        background=jnp.ones(3), bg_depth=10.0, colors=jnp.asarray(s["rgb"]), impl=impl,
        interpret=True, need_stats=need_stats).items()}


def t_render(s, impl, gamma=1.0, W=64, H=64, rich=True, need_stats=True, leaves=None):
    tst = TRS(image_width=W, image_height=H, max_sh_degree=0, rich_info=rich,
              rasterizer_type="GS")
    args = leaves or [torch.as_tensor(s[k]) for k in KEYS]
    return t_rasterize_gs(*args[:4], None, t_camera(W, H, device="cpu"), tst, gamma=gamma,
                          background=torch.ones(3), bg_depth=10.0, colors=args[4], impl=impl,
                          need_stats=need_stats)


@pytest.mark.parametrize("gamma", [1.0, 2.5])
def test_blend_oracle_gs_matches_jax(gamma):
    """The port's dense oracle against the JAX one: render, depth, final_T
    and the statistics to float32 ulps, n_contrib (the last composited
    index) exactly."""
    s = make_gs_scene(120, seed=0)
    want = j_render(s, "oracle", gamma)
    got = {k: v.detach().numpy() for k, v in t_render(s, "oracle", gamma).items()}
    np.testing.assert_array_equal(got["n_contrib"], want["n_contrib"])
    assert want["n_contrib"].max() > 5
    for k in ("render", "depth", "final_T", "contrib_sum", "contrib_max"):
        assert np.abs(got[k] - want[k]).max() <= 1e-5 * max(1.0, np.abs(want[k]).max()), k
    assert not got["normal"].any()


# ---------------------------------------------------------------------------
# plain B1-GS / B2-GS against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

CASES = [
    # (scene, P, W, H, seed, gamma); for "kill" the seed is the kill index
    ("scene", 150, 64, 64, 0, 1.0),
    ("scene", 200, 80, 48, 2, 2.5),      # partial tiles, gamma != 1
    ("kill", 400, 64, 64, 280, 1.0),     # kill entry past every staged batch
]
FORMS = [(False, False), (True, False), (False, True), (True, True)]   # (stats, rich)


@functools.lru_cache(maxsize=None)
def packed_inputs(kind, P, W, H, seed, gamma):
    """Numpy (pairs, tile_starts, tile_counts, params) of the GS pipeline
    from the JAX package (cached: read-only arrays)."""
    s = scene_of(kind, P, seed)
    st = JRS(image_width=W, image_height=H, rich_info=True, max_sh_degree=0)
    cam = j_camera(W, H)
    op = jnp.asarray(s["opacity"])
    prep = JGO.preprocess_gaussian(jnp.asarray(s["xyz"]), jnp.asarray(s["scale"]),
                                   jnp.asarray(s["rot"]), jnp.asarray(s["rgb"]),
                                   cam.world_view, cam.full_proj, cam.tan_fovx, cam.tan_fovy,
                                   st, opacity=op, gamma=jnp.float32(gamma))
    b = bin_triangles(prep, st, 128 * 40, interpret=True)
    assert not bool(b.overflow)
    fields = pack_pair_fields(JGO.gaussian_field_matrix(prep, op), b, True, 11)
    params = np.array([gamma, 1.0, 0.9, 0.8, 10.0, 0, 0, 0], np.float32)
    return (np.array(fields), np.array(b.tile_starts), np.array(b.tile_counts), params)


def torch_args(inp, dtype=torch.float32):
    pairs, ts, tc, params = inp
    return (torch.as_tensor(pairs).to(dtype), torch.as_tensor(ts), torch.as_tensor(tc),
            torch.as_tensor(params).to(dtype))


def real_slots(ts, tc):
    return np.concatenate([np.arange(ts[t], ts[t] + tc[t]) for t in range(tc.shape[0])])


@functools.lru_cache(maxsize=None)
def jax_forward(case, stats, rich):
    W, H = case[2], case[3]
    out = JB.blend_forward(*(jnp.asarray(a) for a in packed_inputs(*case)), image_width=W,
                           image_height=H, rich=rich, variant="GS", stats=stats,
                           interpret=True, **GEO)
    return [np.array(x) for x in out]     # writable copies


@pytest.mark.parametrize("case", CASES)
def test_forward_gs_plain_matches_pallas(case):
    """Each of the four forms against the Pallas kernel in the same form:
    n_contrib exactly; color, final_T (and depth with rich info) within
    2e-5 (Pallas' transmittance is a Hillis-Steele product, the plain
    version's a sequential one); the stream within 5e-4 (an ulp of T may
    flip an isolated (pair, pixel) across the 1/255 cut, JAX's own budget
    of its statistics). The blend outputs of the four forms are the same
    bit for bit (every form on the first case; the plain form and rich
    info with statistics, which share no switch, on the others)."""
    kind, P, W, H, seed, gamma = case
    inp = packed_inputs(*case)
    cols = real_slots(inp[1], inp[2])
    before = dict(TB.blend_forward.launches)
    base = None
    # every form on the first scene, the plain one and rich with stats
    # (the two that share no switch) on the others
    for stats, rich in FORMS if case == CASES[0] else FORMS[::3]:
        want = jax_forward(case, stats, rich)
        got = [x.numpy() for x in TB.blend_forward(
            *torch_args(inp), image_width=W, image_height=H, variant="GS", stats=stats,
            rich=rich, **GEO)]
        np.testing.assert_array_equal(got[4], want[4])
        for k in (0, 1, 3):
            d = np.abs(got[k] - want[k])
            assert d.max() <= 2e-5 * max(1.0, float(np.abs(want[k]).max())), (stats, rich, k)
        assert not got[2].any()
        if stats:
            d = np.abs(got[5] - want[5][:, :got[5].shape[1]])[:, cols]
            assert d.max() <= 5e-4, (rich, d.max())
            assert got[5][0, cols].max() > 0
        if base is None:
            base = got
        for k in (0, 3, 4):
            assert np.array_equal(got[k], base[k]), (stats, rich, k)
    assert TB.blend_forward.launches == before      # CPU: the plain versions ran
    nc = base[4]
    assert nc.max() > (256 if kind == "kill" else 3)


def cotangents(W, H, seed=5):
    rng = np.random.default_rng(seed)
    n = H * W
    return (rng.normal(size=(3, H, W)).astype(np.float32) / (3 * n),
            rng.normal(size=(H, W)).astype(np.float32) / n,
            rng.normal(size=(H, W)).astype(np.float32) / n)


def row_rel_err(got, want, cols, rows):
    got, want = got[:rows, cols], want[:rows, cols]
    scale = np.maximum(np.abs(want).max(axis=1), 1e-30)
    return float((np.abs(got - want).max(axis=1) / scale).max())


@pytest.mark.parametrize("rich", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_backward_gs_plain_matches_pallas(case, rich):
    """B2-GS against the Pallas kernel on the same forward state: the live
    rows (10, 11 with rich info) within rel 5e-3 of each row's max, row 5
    and the rows past the live ones zero, and so are padding slots. The
    Pallas backward sums its suffix terms and the rgb / depth rows with
    bf16 matmuls (unit roundoff 2^-9 per operand) and the random
    cotangents make the sums cancel: the budget of the triangle forms'
    tests (tests/test_torch_rich.py); measured up to 2.9e-3. The float64
    test below holds the recurrence to 1e-9."""
    kind, P, W, H, seed, gamma = case
    inp = packed_inputs(*case)
    _, _, _, final_T, n_contrib, _ = jax_forward(case, True, True)
    g_color, g_T, g_depth = cotangents(W, H)
    want = np.asarray(JB.blend_backward(
        *(jnp.asarray(a) for a in inp), jnp.asarray(final_T), jnp.asarray(n_contrib),
        jnp.asarray(g_color), jnp.asarray(g_depth), jnp.zeros((3, H, W)), jnp.asarray(g_T),
        image_width=W, image_height=H, rich=rich, variant="GS", interpret=True, **GEO))
    got = TB.blend_backward(
        *torch_args(inp), torch.as_tensor(final_T), torch.as_tensor(n_contrib),
        torch.as_tensor(g_color), torch.as_tensor(g_T),
        torch.as_tensor(g_depth) if rich else None, None, image_width=W, image_height=H,
        variant="GS", rich=rich, **GEO).numpy()
    ts, tc = inp[1], inp[2]
    cols = real_slots(ts, tc)
    live = TB.LIVE_GRAD_ROWS[("GS", rich)]
    assert row_rel_err(got, want, cols, live) <= 5e-3
    assert not got[5].any() and not got[live:].any()
    for t in range(tc.shape[0]):
        assert not got[:, ts[t] + tc[t]:ts[t + 1]].any()
    for r in range(live):
        if r != 5:
            assert np.abs(got[r, cols]).max() > 0, r


@pytest.mark.parametrize("rich", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_backward_gs_plain_matches_float64_autograd(case, rich):
    """The explicit back-to-front recurrence equals autograd through the
    dense plain forward; in float64 the only difference is rounding."""
    kind, P, W, H, seed, gamma = case
    pairs, ts, tc, params = torch_args(packed_inputs(*case), torch.float64)
    pairs.requires_grad_(True)
    geo = dict(image_width=W, image_height=H, variant="GS", **GEO)
    color, depth, _, final_T, n_contrib = TB.blend_forward_plain(pairs, ts, tc, params,
                                                                 rich=rich, **geo)
    g_color, g_T, g_depth = (torch.as_tensor(g).double() for g in cotangents(W, H))
    value = (color * g_color).sum() + (final_T * g_T).sum()
    if rich:
        value = value + (depth * g_depth).sum()
    want = torch.autograd.grad(value, pairs)[0]
    got = TB.blend_backward(pairs.detach(), ts, tc, params, final_T.detach(), n_contrib,
                            g_color, g_T, g_depth if rich else None, None, rich=rich, **geo)
    live = TB.LIVE_GRAD_ROWS[("GS", rich)]
    assert row_rel_err(got.numpy(), want.numpy(), real_slots(ts.numpy(), tc.numpy()),
                       live) <= 1e-9
    assert not got[live:].any()


# ---------------------------------------------------------------------------
# rasterize_gaussian against the JAX function
# ---------------------------------------------------------------------------

class TestGSParity:
    @pytest.mark.parametrize("gamma", [1.0, 2.5])
    def test_forward(self, gamma):
        """The port's pipeline (plain kernels) with statistics and rich
        info against the JAX Pallas pipeline and the JAX oracle."""
        s = make_gs_scene()
        p = j_render(s, "pallas", gamma)
        o = j_render(s, "oracle", gamma)
        t = {k: v.detach().numpy() for k, v in t_render(s, "cuda", gamma).items()}
        for want in (p, o):
            np.testing.assert_array_equal(t["n_contrib"], want["n_contrib"])
            for k in ("render", "final_T"):
                assert np.abs(t[k] - want[k]).max() <= 1e-5, k
            assert np.abs(t["depth"] - want["depth"]).max() <= 1e-4
            for k in ("contrib_sum", "contrib_max"):
                assert np.abs(t[k] - want[k]).max() <= 5e-4, k
            np.testing.assert_array_equal(t["radii"], want["radii"])
        assert t["contrib_sum"].max() > 0 and int(t["num_pairs"]) == int(p["num_pairs"])

    def test_backward(self):
        """Gradients of an L1 + depth loss through the port's pipeline
        against its dense oracle's autograd, within rel 5e-3 of the largest
        (the JAX package's budget of its pipeline against its oracle; the
        oracle's forward is held against the JAX one above, the preprocess
        VJP and B2-GS against the JAX package's above)."""
        s = make_gs_scene(seed=3)
        target = np.random.default_rng(5).uniform(size=(3, 64, 64)).astype(np.float32)
        grads = {}
        for impl in ("cuda", "oracle"):
            leaves = [torch.tensor(s[k], requires_grad=True) for k in KEYS]
            out = t_render(s, impl, leaves=leaves)
            loss = (out["render"] - torch.as_tensor(target)).abs().mean() \
                + 0.01 * out["depth"].mean()
            grads[impl] = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
        for name, a, c in zip(KEYS, grads["cuda"], grads["oracle"]):
            assert np.isfinite(a).all() and np.abs(a).max() > 0, name
            assert rel(a, c) <= 5e-3, name


    @pytest.mark.parametrize("gamma", [1.0, 2.5])
    def test_backward_matches_jax_oracle(self, gamma):
        """Gradients of the same L1 + depth loss through the port's pipeline
        (plain kernels, float32) against ``jax.grad`` of the JAX package's
        dense oracle, which has no bf16 step: every leaf and the
        screen-space center offset (the densification statistic's input)
        within rel 1e-5 of the leaf's max; measured up to 7.4e-7."""
        s = make_gs_scene(seed=3)
        target = np.random.default_rng(5).uniform(size=(3, 64, 64)).astype(np.float32)
        off = np.zeros((s["xyz"].shape[0], 2), np.float32)
        jst = JRS(image_width=64, image_height=64, max_sh_degree=0, rich_info=True)
        cam = j_camera(64, 64)

        def j_loss(xyz, scale, rot, opacity, rgb, m2d):
            out = j_rasterize_gs(xyz, scale, rot, opacity, None, cam, jst, gamma=gamma,
                                 background=jnp.ones(3), bg_depth=10.0, colors=rgb,
                                 mean2d_offset=m2d, impl="oracle", need_stats=False)
            return jnp.abs(out["render"] - target).mean() + 0.01 * out["depth"].mean()

        want = jax.grad(j_loss, argnums=tuple(range(6)))(
            *(jnp.asarray(s[k]) for k in KEYS), jnp.asarray(off))
        leaves = [torch.tensor(a, requires_grad=True) for a in [s[k] for k in KEYS] + [off]]
        tst = TRS(image_width=64, image_height=64, max_sh_degree=0, rich_info=True,
                  rasterizer_type="GS")
        out = t_rasterize_gs(*leaves[:4], None, t_camera(64, 64, device="cpu"), tst,
                             gamma=gamma, background=torch.ones(3), bg_depth=10.0,
                             colors=leaves[4], mean2d_offset=leaves[5], need_stats=False)
        loss = (out["render"] - torch.as_tensor(target)).abs().mean() \
            + 0.01 * out["depth"].mean()
        got = torch.autograd.grad(loss, leaves)
        for name, g, w in zip(KEYS + ("m2d",), got, want):
            assert np.abs(np.asarray(w)).max() > 0, name
            assert rel(g.numpy(), np.asarray(w)) <= 1e-5, name


# ---------------------------------------------------------------------------
# the Gaussian kill and early-exit semantics
# ---------------------------------------------------------------------------

class TestGSEarlyTermination:
    """The entry that would push T below 1e-4 is not composited and ends the
    pixel; later small-alpha entries must not resurrect it. Kill index 250
    lies past Pallas' 128-pair slab, 280 also past the CUDA kernels'
    staged batches (256 in the forward, 96 backward)."""

    @pytest.mark.parametrize("n,kill_at,opacity", [(360, 250, 0.03), (400, 280, 0.025)])
    def test_kill_parity(self, n, kill_at, opacity):
        s = make_gs_stack_scene(n, kill_at, opacity)
        o = j_render(s, "oracle")
        t = {k: v.detach().numpy() for k, v in t_render(s, "cuda").items()}
        nc = o["n_contrib"]
        # the kill fires at the center, past the first 128 entries
        # (peripheral pixels see weak falloffs and may never be killed)
        assert 128 < nc[32, 32] < n
        np.testing.assert_array_equal(t["n_contrib"], nc)
        assert np.abs(t["final_T"] - o["final_T"]).max() <= 1e-5
        assert np.abs(t["render"] - o["render"]).max() <= 1e-3
        assert (t["final_T"][nc >= kill_at] >= 1e-4).all()

    @pytest.mark.parametrize("n,kill_at,opacity", [(360, 250, 0.03), (400, 280, 0.025)])
    def test_kill_backward_parity(self, n, kill_at, opacity):
        s = make_gs_stack_scene(n, kill_at, opacity)
        target = torch.as_tensor(np.random.default_rng(5).uniform(size=(3, 64, 64)),
                                 dtype=torch.float32)
        grads = {}
        for impl in ("cuda", "oracle"):
            leaves = [torch.tensor(s[k], requires_grad=True) for k in KEYS]
            out = t_render(s, impl, leaves=leaves, rich=False, need_stats=False)
            loss = (out["render"] - target).abs().mean()
            grads[impl] = torch.autograd.grad(loss, [leaves[i] for i in (0, 3, 4)])
        for name, a, b in zip(("xyz", "opacity", "rgb"), grads["cuda"], grads["oracle"]):
            assert np.isfinite(a.numpy()).all(), name
            assert rel(a.numpy(), b.numpy()) <= 5e-3, name


class TestGSEarlyExitDrain:
    def test_all_pixels_done_in_first_batch(self):
        """Every pixel is killed within its first few entries: the pipeline
        stops early, and the Gaussians past every pixel's kill report
        exactly zero contribution."""
        n = 300
        rng = np.random.default_rng(11)
        xyz = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                        np.linspace(3.0, 6.0, n)], -1).astype(np.float32)
        s = dict(xyz=xyz, scale=np.full((n, 3), 2.0, np.float32),
                 rot=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
                 opacity=np.full(n, 0.97, np.float32),
                 rgb=rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32))
        o = j_render(s, "oracle")
        t = {k: v.detach().numpy() for k, v in t_render(s, "cuda").items()}
        assert int(o["n_contrib"].max()) < 16
        np.testing.assert_array_equal(t["n_contrib"], o["n_contrib"])
        assert np.abs(t["render"] - o["render"]).max() <= 1e-5
        assert not t["contrib_sum"][-100:].any() and not t["contrib_max"][-100:].any()
        assert rel(t["contrib_sum"], o["contrib_sum"]) <= 1e-5


class TestDeadSlotGradients:
    @pytest.mark.parametrize("impl", ["oracle", "cuda"])
    def test_no_nan_grads_from_dead_slots(self, impl):
        """Dead capacity slots sit at the origin, the camera center: the SH
        view-direction normalize and the covariance build keep their
        gradients finite there."""
        from triangle_splatting_tpu_torch.convert import gaussian_from_numpy
        rng = np.random.default_rng(5)
        n, cap = 30, 64
        cfg = JG.GSModelConfig(max_sh_degree=1)
        jp, js = JG.create_from_points(rng.normal(size=(n, 3)).astype(np.float32),
                                       rng.uniform(size=(n, 3)).astype(np.float32), cfg,
                                       capacity=cap)
        leaves = lambda t: {k: np.asarray(getattr(t, k)) for k in t.__dataclass_fields__}  # noqa
        params, state, _ = gaussian_from_numpy(leaves(jp), leaves(js), device="cpu")
        p = {k: v.clone().requires_grad_(True) for k, v in params.tensors().items()}
        out = TG.forward(TG.GaussianParams(**p), state, t_camera(64, 64, device="cpu"),
                         torch.zeros(3), TG.GSModelConfig(max_sh_degree=1),
                         TRS(image_width=64, image_height=64, max_sh_degree=1,
                             rasterizer_type="GS"), impl=impl)
        grads = torch.autograd.grad(out["render"].mean(), list(p.values()))
        for name, g in zip(p, grads):
            assert torch.isfinite(g).all(), name


# ---------------------------------------------------------------------------
# the GaussianRenderer facade (tests/test_renderer_facade.py)
# ---------------------------------------------------------------------------

def facade_scene(n=30, seed=7):
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(3.0, 6.0, n)], -1).astype(np.float32)
    scale = rng.uniform(0.05, 0.2, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.9, n).astype(np.float32)
    sh = rng.uniform(0, 1, (n, 1, 3)).astype(np.float32)
    return xyz, scale, q, opac, sh


class TestGaussianRendererFacade:
    def test_render_and_radii_match_jax(self):
        """Rich info (B1-GS with rich info and statistics together, as the
        facade renders) against the JAX facade on its dense oracle: render,
        depth, final_T, statistics, n_contrib and radii; ``get_radii`` (3
        sigma) against the JAX one."""
        import triangle_splatting_tpu as tst
        xyz, scale, q, opac, sh = facade_scene()
        jr = tst.GaussianRenderer(j_camera(64, 64), rich_info=True, sh_degree=0, impl="oracle")
        want = jr.render(xyz, sh, None, opac, scale, q)
        r = GaussianRenderer(t_camera(64, 64, device="cpu"), rich_info=True, sh_degree=0)
        got = r.render(*(torch.as_tensor(a) for a in (xyz, sh)), None,
                       *(torch.as_tensor(a) for a in (opac, scale, q)))
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["n_contrib"].numpy(), np.asarray(want["n_contrib"]))
        np.testing.assert_array_equal(got["radii"].numpy(), np.asarray(want["radii"]))
        for k in ("render", "final_T", "depth"):
            scale_k = max(1.0, float(np.abs(np.asarray(want[k])).max()))
            assert np.abs(got[k].detach().numpy() - np.asarray(want[k])).max() <= 1e-5 * scale_k, k
        for k in ("contrib_sum", "contrib_max"):    # JAX's budget of its statistics
            assert np.abs(got[k].numpy() - np.asarray(want[k])).max() <= 5e-4, k
        assert got["means2D"].shape == (30, 2) and float(got["contrib_sum"].max()) > 0
        np.testing.assert_array_equal(r.get_radii(xyz, scale, q).numpy(),
                                      np.asarray(jr.get_radii(xyz, scale, q)))
        assert (r.get_radii(xyz, scale, q) >= got["radii"]).all()

    def test_non_rich_drops_keys(self, monkeypatch):
        """Without rich info the facade renders without the contribution
        statistics (the plain forms), and returns no depth or statistics."""
        from triangle_splatting_tpu_torch.renderer import gaussian_renderer as GR
        need_stats = []

        def spy(*args, **kw):
            need_stats.append(kw["need_stats"])
            return t_rasterize_gs(*args, **kw)
        monkeypatch.setattr(GR, "rasterize_gaussian", spy)
        xyz, scale, q, opac, sh = facade_scene(10, 4)
        r = GaussianRenderer(t_camera(64, 64, device="cpu"), sh_degree=0)
        out = r.render(xyz, sh, None, opac, scale, q)
        assert need_stats == [False]
        assert not {"depth", "normal", "contrib_sum", "contrib_max"} & set(out)
        assert out["render"].shape == (3, 64, 64) and torch.isfinite(out["render"]).all()

    def test_in_frustum(self):
        r = GaussianRenderer(t_camera(64, 64, device="cpu"))
        pts = np.array([[0.0, 0.0, 5.0], [0.0, 0.0, -5.0], [0.0, 0.0, 0.1]], np.float32)
        assert r.in_frustum(pts).tolist() == [True, False, False]
