"""The port's depth-sharded rendering and hybrid step
(``triangle_splatting_tpu_torch/parallel/{depth_sharded,hybrid}.py``) on the
CPU: ``partition_by_depth`` over the whole-scene keys and ``composite_over``
against JAX's, the whole-scene keys against ``rasterize``'s own order, then
real ranks over Gloo (fresh interpreters importing only the port): two
ranks of the depth-sharded render against one ``rasterize`` and JAX's
depth-sharded render on a 2-device mesh, gradients included, and four
ranks of the 2 x 2 hybrid step against JAX's hybrid step on a 2 x 2 mesh
and the single-device camera-mean reference. Scenes are 32x32 with 64-96
random triangles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.ops.projection import RasterSettings as JSettings
from triangle_splatting_tpu.parallel import depth_sharded as JD
from triangle_splatting_tpu.utils.testing import make_camera as j_make_camera
from triangle_splatting_tpu.utils.testing import make_random_scene
from triangle_splatting_tpu_torch.ops.projection import RasterSettings
from triangle_splatting_tpu_torch.ops.rasterize import rasterize
from triangle_splatting_tpu_torch.parallel import depth_sharded as TD
from triangle_splatting_tpu_torch.utils.testing import make_camera
from torch_ranks import run_ranks
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

N, RES = 96, 32
SETTINGS = RasterSettings(image_width=RES, image_height=RES)
J_SETTINGS = JSettings(image_width=RES, image_height=RES)


@pytest.fixture(scope="module")
def scene():
    # moderate opacity keeps T above the early-termination threshold (the
    # JAX test's scene choice)
    return make_random_scene(N, seed=3, opacity_range=(0.2, 0.5))


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("variant", ["2D", "3D"])
def test_partition_by_depth_matches_jax(scene, k, variant):
    """Slabs of the whole-scene keys (``binning_depth_key``) in JAX's
    quantized order exactly, with some dead triangles: every triangle of
    this scene survives the preprocess, so the keys quantize the same
    centroid depths over the same range. Dead triangles sort last."""
    alive = np.random.default_rng(1).random(N) > 0.2
    jorder = JD.partition_by_depth(jnp.asarray(scene["vertex"]), j_make_camera(RES, RES), k,
                                   alive=jnp.asarray(alive), settings=J_SETTINGS)
    s = RasterSettings(image_width=RES, image_height=RES, rasterizer_type=variant)
    key = TD.binning_depth_key(torch.as_tensor(scene["vertex"]),
                               torch.as_tensor(scene["opacity"]).reshape(-1),
                               make_camera(RES, RES, device="cpu"), s, 1.0,
                               torch.as_tensor(alive))
    torder = TD.partition_by_depth(key, k, alive=torch.as_tensor(alive))
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    assert not alive[torder.numpy()[-int((~alive).sum()):]].any()    # dead sort last
    with pytest.raises(ValueError, match="divisible"):
        TD.partition_by_depth(key[:N - 1], k)


def test_composite_over_matches_jax():
    """Three slabs, background and background depth: within float32
    rounding of JAX's (rtol 1e-6, the JAX algebra test's)."""
    rng = np.random.default_rng(0)
    c, d, n = (rng.uniform(size=s).astype(np.float32) for s in ((3, 3, 4, 4), (3, 4, 4),
                                                                (3, 3, 4, 4)))
    t = rng.uniform(0.2, 0.9, (3, 4, 4)).astype(np.float32)
    bg = np.asarray([1.0, 0.5, 0.0], np.float32)
    want = JD.composite_over(jnp.asarray(c), jnp.asarray(d), jnp.asarray(n), jnp.asarray(t),
                             background=jnp.asarray(bg), bg_depth=7.0)
    got = TD.composite_over(*(torch.as_tensor(x) for x in (c, d, n, t)),
                            background=torch.as_tensor(bg), bg_depth=torch.tensor(7.0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("variant", ["2D", "3D"])
def test_whole_scene_keys_are_rasterize_order(scene, variant):
    """``rasterize`` keyed by ``binning_depth_key`` of its own triangles
    equals ``rasterize`` bit for bit: the keys are the ones it sorts by."""
    s = RasterSettings(image_width=RES, image_height=RES, rasterizer_type=variant)
    cam = make_camera(RES, RES, device="cpu")
    v, o, c = (torch.as_tensor(scene[k]) for k in ("vertex", "opacity", "rgb"))
    o = o.reshape(-1)
    alive = torch.ones(N, dtype=torch.bool)
    key = TD.binning_depth_key(v, o, cam, s, 1.0, alive)
    a = rasterize(v, o, None, cam, s, colors=c, alive_mask=alive)
    b = rasterize(v, o, None, cam, s, colors=c, alive_mask=alive, depth_key=key)
    for name in ("render", "final_T", "n_contrib", "depth"):
        assert torch.equal(a[name], b[name]), name


SHARD_WORKER = r"""
import numpy as np
from triangle_splatting_tpu_torch.ops.projection import RasterSettings
from triangle_splatting_tpu_torch.parallel import depth_sharded as D
from triangle_splatting_tpu_torch.parallel.multihost import make_global_mesh, maybe_initialize
from triangle_splatting_tpu_torch.utils.testing import make_camera, make_random_scene

assert maybe_initialize(device="cpu")
g = make_global_mesh()
K = g.size
N, RES = 96, 32
settings = RasterSettings(image_width=RES, image_height=RES)
s = make_random_scene(N, seed=3, opacity_range=(0.2, 0.5))
cam = make_camera(RES, RES, device="cpu")
v, o, c = (torch.as_tensor(s[k]) for k in ("vertex", "opacity", "rgb"))
o = o.reshape(-1)
alive = torch.ones(N, dtype=torch.bool)
key = D.binning_depth_key(v, o, cam, settings, 1.0, alive)
order = D.partition_by_depth(key, K, alive=alive)
slab = order[RANK * (N // K):(RANK + 1) * (N // K)]
sv, so, sc = (x[slab].clone().requires_grad_(True) for x in (v, o, c))
render = D.make_depth_sharded_render(g, settings)
pkg = render(sv, so, sc, alive[slab], cam, torch.ones(3), 10.0, 1.0, depth_key=key[slab])
# every rank back-propagates the replicated loss: each slab gets one pass's gradient
pkg["render"].mean().backward()
np.savez(f"{OUT}/shard{RANK}.npz", slab=slab.numpy(), order=order.numpy(),
         gv=sv.grad.numpy(), go=so.grad.numpy(), gc=sc.grad.numpy(),
         **{k: pkg[k].detach().numpy() for k in ("render", "final_T", "depth", "n_contrib")})
"""


def test_two_ranks_depth_sharded_render(scene, tmp_path):
    """Two Gloo ranks: the fused render and transmittance within 1e-4 of
    one ``rasterize`` (the early-termination bound; slabs keyed by the
    whole scene's depths keep the single pass's order), n_contrib at least
    its count, and each slab's vertex / opacity / color gradients within
    1e-6 of the single pass's (measured: render 1.2e-7, gradients 1.5e-7
    against a largest vertex gradient of 1.1e-2: float32 rounding of the
    composite). Against JAX's depth-sharded render on a 2-device mesh:
    JAX's own test's bounds against one pass (4e-3 render and final_T,
    5e-2 depth, 2e-4 gradients: JAX re-quantizes each shard's depths, so
    tied triangles can swap)."""
    run_ranks(SHARD_WORKER, 2, tmp_path)
    shards = [np.load(tmp_path / f"shard{r}.npz") for r in range(2)]
    for k in ("render", "final_T", "depth", "n_contrib"):
        np.testing.assert_array_equal(shards[1][k], shards[0][k], err_msg=k)
    pkg = shards[0]

    cam = make_camera(RES, RES, device="cpu")
    v, o, c = (torch.as_tensor(scene[k]).clone().requires_grad_(True)
               for k in ("vertex", "opacity", "rgb"))
    ref = rasterize(v, o.reshape(-1), None, cam, SETTINGS, gamma=1.0, background=torch.ones(3),
                    bg_depth=10.0, colors=c)
    ref["render"].mean().backward()
    np.testing.assert_allclose(pkg["render"], ref["render"].detach().numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pkg["final_T"], ref["final_T"].detach().numpy(), rtol=0,
                               atol=1e-4)
    assert (pkg["n_contrib"] >= ref["n_contrib"].numpy()).all()
    for sh in shards:
        slab = sh["slab"]
        np.testing.assert_allclose(sh["gv"], v.grad.numpy()[slab], rtol=0, atol=1e-6)
        np.testing.assert_allclose(sh["go"], o.grad.numpy().reshape(-1)[slab], rtol=0, atol=1e-6)
        np.testing.assert_allclose(sh["gc"], c.grad.numpy()[slab], rtol=0, atol=1e-6)

    # JAX's depth-sharded render and its gradients on a 2-device mesh
    from triangle_splatting_tpu.parallel.mesh import make_mesh
    k = 2
    jcam = j_make_camera(RES, RES)
    jorder = JD.partition_by_depth(jnp.asarray(scene["vertex"]), jcam, k, settings=J_SETTINGS)
    jv = jnp.asarray(scene["vertex"])[jorder].reshape(k, N // k, 3, 3)
    jo = jnp.asarray(scene["opacity"]).reshape(-1)[jorder].reshape(k, N // k)
    jc = jnp.asarray(scene["rgb"])[jorder].reshape(k, N // k, 3)
    alive = jnp.ones((k, N // k), bool)
    jrender = JD.make_depth_sharded_render(make_mesh(k, axis="model"), J_SETTINGS, axis="model",
                                           impl="oracle")

    def jloss(v_, o_, c_):
        out = jrender(v_, o_, c_, alive, jcam.strip_static(), jnp.ones(3), 10.0, 1.0)
        return out["render"].mean(), out

    (_, jpkg), grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jv, jo, jc)
    np.testing.assert_allclose(pkg["render"], np.asarray(jpkg["render"]), atol=4e-3)
    np.testing.assert_allclose(pkg["final_T"], np.asarray(jpkg["final_T"]), atol=4e-3)
    np.testing.assert_allclose(pkg["depth"], np.asarray(jpkg["depth"]), atol=5e-2)
    jorder = np.asarray(jorder)
    full = {name: np.zeros((N,) + np.asarray(g).shape[2:], np.float32)
            for name, g in zip(("gv", "go", "gc"), grads)}
    for name, g in zip(("gv", "go", "gc"), grads):
        full[name][jorder] = np.asarray(g).reshape((N,) + np.asarray(g).shape[2:])
    for sh in shards:
        for name in ("gv", "go", "gc"):
            np.testing.assert_allclose(sh[name], full[name][sh["slab"]], atol=2e-4,
                                       err_msg=name)


HYBRID_WORKER = r"""
import dataclasses
import numpy as np
from triangle_splatting_tpu_torch.convert import triangle_from_numpy
from triangle_splatting_tpu_torch.models import triangle as M
from triangle_splatting_tpu_torch.ops.projection import RasterSettings
from triangle_splatting_tpu_torch.parallel.hybrid import make_hybrid_mesh, make_hybrid_train_step
from triangle_splatting_tpu_torch.parallel.multihost import maybe_initialize, tree_checksum
from triangle_splatting_tpu_torch.trainers import losses as L
from triangle_splatting_tpu_torch.utils.testing import make_camera

assert maybe_initialize(device="cpu")
mesh = make_hybrid_mesh(2, 2)
assert mesh.shape == (2, 2)
inp = np.load(f"{OUT}/inputs.npz")
params, state, _ = triangle_from_numpy(
    {k[2:]: inp[k] for k in inp.files if k.startswith("p.")},
    {k[2:]: inp[k] for k in inp.files if k.startswith("s.")}, device="cpu")
opt = M.AdamState.create(params)
cam = dataclasses.replace(make_camera(32, 32, float(inp["fovs"][mesh.data.rank]), with_image=True,
                                      device="cpu"),
                          gt_image=torch.as_tensor(inp["gts"][mesh.data.rank]))
settings = RasterSettings(image_width=32, image_height=32, max_sh_degree=1)
step = make_hybrid_train_step(
    mesh, settings, lambda pkg, cam, p, st, w: w["l1"] * L.l1(pkg["render"], cam.gt_image))
lrs = {k: 1e-3 for k in ("vertex", "opacity", "f_dc", "f_rest", "affine")}
p2, o2, s2, loss, slim = step(params, opt, state, cam, torch.ones(3), lrs, {"l1": 1.0})
arrays = dict(loss=loss, **{f"p.{k}": v for k, v in p2.tensors().items()},
              **{f"m.{k}": v for k, v in o2.m.tensors().items()},
              **{f"s.{k}": getattr(s2, k) for k in ("gradient_accum", "gradient_denom",
                                                    "contrib_sum", "contrib_max",
                                                    "max_radii2d")})
sums = mesh.both.all_gather(tree_checksum(list(arrays.values())))
np.savez(f"{OUT}/hybrid{RANK}.npz", same=bool((sums == sums[0]).all()),
         overflow=bool(slim["overflow"]), **{k: v.numpy() for k, v in arrays.items()})
"""

HYBRID_FOVS = (55.0, 65.0)
HYBRID_LR = 1e-3
# The port's 2 x 2 step against JAX's on the 4-device virtual mesh (JAX on
# its dense oracle, the port on its plain kernel versions): the loss within
# rel 1e-5, each leaf's Adam first moment (0.1 g after step 1: the gradient
# with its scale), the accumulated centroid-gradient norms and the
# contribution maxima and sums within 1e-4 of their largest (measured: loss
# 1.7e-7, moments 8.9e-6, norms 1.2e-5, contributions 6.2e-6), the view
# counts and radii exact. Against the port's own camera-mean reference (the
# same plain versions): the loss within 1e-6 and the moments within 1e-6 of
# each leaf's largest (measured 1.5e-8 and 0).
JAX_HYBRID_TOL = dict(loss_rel=1e-5, m=1e-4, acc=1e-4, cmax=1e-4, csum=1e-4)
SELF_HYBRID_TOL = dict(loss=1e-6, m=1e-6)


def hybrid_inputs():
    """The JAX model (SH degree 1, 64 triangles) and the two views."""
    from triangle_splatting_tpu.models import triangle as JM
    s = make_random_scene(64, seed=3)
    jp, js = JM.create_from_points(s["vertex"].mean(1), s["rgb"], None,
                                   JM.ModelConfig(max_sh_degree=1), init_opacity=0.5)
    gts = np.random.default_rng(11).random((2, 3, 32, 32)).astype(np.float32)
    return jp, js, gts


def test_four_ranks_hybrid_step(tmp_path):
    """Four Gloo ranks, 2 x 2: every rank ends with the same model, bit for
    bit. The step against JAX's ``make_hybrid_train_step`` on a 2 x 2 mesh
    of the conftest's virtual devices, on the same model, views and
    learning rates (JAX_HYBRID_TOL), and against the single-device
    camera-mean reference of JAX's own test
    (tests/test_multichip.py::test_hybrid_step_matches_single_device):
    the loss within 1e-4, the Adam update within rtol 1e-4 / atol 2e-5
    where the reference gradient exceeds 1e-6 (step 1 is sign(g)-like),
    the view-summed centroid-gradient norms within rtol 1e-3 where a view
    counted the triangle, the radii's max and the view counts exactly,
    and Adam's first moment, which carries the gradient's scale, within
    SELF_HYBRID_TOL."""
    import dataclasses
    from triangle_splatting_tpu.models import triangle as JM
    from triangle_splatting_tpu.parallel.hybrid import make_hybrid_mesh, make_hybrid_train_step
    from triangle_splatting_tpu.parallel.mesh import stack_cameras
    from triangle_splatting_tpu.trainers import losses as JL
    from triangle_splatting_tpu_torch.convert import triangle_from_numpy
    from triangle_splatting_tpu_torch.models import triangle as M
    from triangle_splatting_tpu_torch.trainers import losses as L

    jp, js, gts = hybrid_inputs()
    p_np = {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp)
            if getattr(jp, f.name) is not None}
    s_np = {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)}
    np.savez(tmp_path / "inputs.npz", fovs=np.asarray(HYBRID_FOVS), gts=gts,
             **{f"p.{k}": v for k, v in p_np.items()}, **{f"s.{k}": v for k, v in s_np.items()})
    run_ranks(HYBRID_WORKER, 4, tmp_path)
    outs = [np.load(tmp_path / f"hybrid{r}.npz") for r in range(4)]
    for o in outs:
        assert bool(o["same"]) and not bool(o["overflow"])
    for k in outs[0].files:
        np.testing.assert_array_equal(outs[3][k], outs[0][k], err_msg=k)
    h = outs[0]
    names = [k[2:] for k in h.files if k.startswith("p.")]

    # JAX's hybrid step on a 2 x 2 mesh of virtual CPU devices
    jcams = [dataclasses.replace(j_make_camera(32, 32, fov, with_image=True),
                                 gt_image=jnp.asarray(g)) for fov, g in zip(HYBRID_FOVS, gts)]
    jsettings = JSettings(image_width=32, image_height=32, max_sh_degree=1)
    jstep = make_hybrid_train_step(
        make_hybrid_mesh(2, 2), jsettings,
        lambda pkg, cam, p, st, w: w["l1"] * JL.l1(pkg["render"], cam.gt_image),
        impl="oracle", donate=False)
    jlrs = {k: np.float32(HYBRID_LR) for k in ("vertex", "opacity", "f_dc", "f_rest", "affine")}
    _, jo, js2, jloss, _ = jstep(jp, JM.AdamState.create(jp), js, stack_cameras(jcams),
                                 jnp.ones(3), jlrs, {"l1": np.float32(1.0)})
    t = JAX_HYBRID_TOL
    assert abs(float(h["loss"]) - float(jloss)) <= t["loss_rel"] * float(jloss)
    for k in names:
        jm = np.asarray(getattr(jo.m, k))
        np.testing.assert_allclose(h[f"m.{k}"], jm, rtol=0, atol=t["m"] * np.abs(jm).max(),
                                   err_msg=f"m.{k} vs JAX")
    jst = {k: np.asarray(getattr(js2, k)) for k in ("gradient_accum", "gradient_denom",
                                                     "contrib_sum", "contrib_max",
                                                     "max_radii2d")}
    np.testing.assert_array_equal(h["s.gradient_denom"], jst["gradient_denom"])
    np.testing.assert_array_equal(h["s.max_radii2d"], jst["max_radii2d"])
    for k, tol in (("gradient_accum", t["acc"]), ("contrib_max", t["cmax"]),
                   ("contrib_sum", t["csum"])):
        np.testing.assert_allclose(h[f"s.{k}"], jst[k], rtol=0,
                                   atol=tol * np.abs(jst[k]).max(), err_msg=f"{k} vs JAX")

    # the port's single-device camera-mean reference on the same model
    settings = RasterSettings(image_width=32, image_height=32, max_sh_degree=1)
    params, state, _ = triangle_from_numpy(p_np, s_np, device="cpu")
    opt = M.AdamState.create(params)
    cams = [dataclasses.replace(make_camera(32, 32, fov, with_image=True, device="cpu"),
                                gt_image=torch.as_tensor(g)) for fov, g in zip(HYBRID_FOVS, gts)]
    losses, gps, gns, visible, radii = [], [], [], [], []
    C = params.capacity
    for cam in cams:
        leaves = {k: t_.detach().requires_grad_(True) for k, t_ in params.tensors().items()}
        c2d = torch.zeros((C, 2), requires_grad=True)
        p = M.TriangleParams(**leaves)
        dist = M.safe_norm(cam.camera_center[None, None, :] - p.vertex)
        bgd = torch.where(state.alive[:, None], dist, torch.zeros_like(dist)).amax()
        out = rasterize(p.vertex, M.get_opacity(p)[:, 0], M.get_features(p), cam, settings,
                        gamma=state.gamma, background=torch.ones(3), bg_depth=bgd,
                        active_sh_degree=state.active_sh_degree, center2d_offset=c2d,
                        alive_mask=state.alive)
        loss = L.l1(out["render"], cam.gt_image)
        gs = torch.autograd.grad(loss, [leaves[k] for k in leaves] + [c2d], allow_unused=True)
        losses.append(float(loss.detach()))
        gps.append({k: torch.zeros_like(leaves[k]) if g is None else g
                    for k, g in zip(leaves, gs[:-1])})
        gns.append(torch.linalg.vector_norm(gs[-1], dim=-1).numpy())
        visible.append(out["visible_mask"].numpy())
        radii.append(out["radii"].numpy())
    mean = M.TriangleParams(**{k: (gps[0][k] + gps[1][k]) / 2.0 for k in gps[0]})
    ref_p, ref_o = M.adam_update(params, opt, mean, {k: HYBRID_LR for k in (
        "vertex", "opacity", "f_dc", "f_rest", "affine")})
    assert abs(float(h["loss"]) - np.mean(losses)) < 1e-4
    assert abs(float(h["loss"]) - np.mean(losses)) <= SELF_HYBRID_TOL["loss"]
    for k in names:
        g = getattr(mean, k).numpy()
        m = np.abs(g) > 1e-6
        np.testing.assert_allclose(h[f"p.{k}"][m], getattr(ref_p, k).numpy()[m], rtol=1e-4,
                                   atol=2e-5, err_msg=k)
        rm = getattr(ref_o.m, k).numpy()
        np.testing.assert_allclose(h[f"m.{k}"], rm, rtol=0,
                                   atol=SELF_HYBRID_TOL["m"] * np.abs(rm).max(),
                                   err_msg=f"m.{k} vs the camera-mean reference")
    rec = h["s.gradient_denom"] > 0
    np.testing.assert_allclose(h["s.gradient_accum"][rec], (gns[0] + gns[1])[rec], rtol=1e-3,
                               atol=1e-7)
    np.testing.assert_array_equal(h["s.gradient_denom"],
                                  visible[0].astype(np.float32) + visible[1])
    np.testing.assert_array_equal(h["s.max_radii2d"], np.maximum(radii[0], radii[1]))
