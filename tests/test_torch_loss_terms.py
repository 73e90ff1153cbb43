"""The loss terms the VanillaTS recipes may switch on, and LPIPS, against the
JAX package on the CPU:

- ``dog_loss`` and ``smoothness_loss`` values and gradients (with the
  exact 0.5 downscale and 2x upscale of ``resize_linear`` they use);
- the color affine: ``forward``'s transformed and original renders and
  their gradients, ``setup_color_affine`` and the ``affine`` Adam group;
- the vertex regularizer: its loss term on ``nearest_neighbor``'s
  indices, and the trainer's refresh cadence (and after capacity growth);
- one VanillaTS step with all four terms on (the JAX trainer on its
  oracle, the port's on its plain kernel versions): loss and gradients;
- LPIPS on ``random_weights(0)``: identical images give 0, single and
  batched distances, and the missing-weights behaviour of the trainer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.models import triangle as JM
from triangle_splatting_tpu.trainers import losses as JL
from triangle_splatting_tpu.trainers import lpips as JP
from triangle_splatting_tpu_torch.convert import triangle_from_numpy
from triangle_splatting_tpu_torch.models import triangle as TM
from triangle_splatting_tpu_torch.models.model_utils import resize_linear
from triangle_splatting_tpu_torch.trainers import build_trainer
from triangle_splatting_tpu_torch.trainers import losses as TL
from triangle_splatting_tpu_torch.trainers import lpips as TP
from triangle_splatting_tpu_torch.utils.config import dict_to_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

RES, N_TRI = 32, 120


def leaves(tree):
    return {f.name: None if getattr(tree, f.name) is None else np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def images(seed=0, shape=(3, 40, 48)):
    """A smooth GT-like image (a few blobs) and a noisy render of it."""
    rng = np.random.default_rng(seed)
    H, W = shape[1:]
    y, x = np.mgrid[0:H, 0:W] / max(H, W)
    gt = np.zeros(shape, np.float32)
    for _ in range(5):
        cy, cx, s = rng.uniform(0, 1), rng.uniform(0, 1), rng.uniform(0.05, 0.3)
        gt += rng.uniform(0, 1, (3, 1, 1)) * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / s ** 2)
    gt = np.clip(gt / gt.max(), 0, 1).astype(np.float32)
    img = np.clip(gt + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    return img, gt


def both_grads(jfn, tfn, img, gt):
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(img), jnp.asarray(gt))
    t = torch.as_tensor(img).requires_grad_(True)
    tv = tfn(t, torch.as_tensor(gt))
    (tg,) = torch.autograd.grad(tv, t)
    return float(jv), np.asarray(jg), float(tv.detach()), tg.numpy()


@pytest.mark.parametrize("shape,out", [((1, 40, 48), (20, 24)), ((1, 20, 24), (40, 48)),
                                       ((3, 40, 48), (20, 24)), ((3, 20, 24), (40, 48))],
                         ids=["down_gray", "up_gray", "down_rgb", "up_rgb"])
def test_resize_at_the_terms_scales_matches_jax(shape, out):
    """The 0.5 downscale and the 2x upscale of the DoG and smoothness terms:
    ``resize_linear`` against ``jax.image.resize(..., "linear")``, abs
    1e-6."""
    x = np.random.default_rng(3).uniform(size=shape).astype(np.float32)
    want = np.asarray(JL._resize(jnp.asarray(x), out))
    np.testing.assert_allclose(resize_linear(torch.as_tensor(x), *out).numpy(), want,
                               rtol=0, atol=1e-6)


def dog_normed(L, resize, gt, freq):
    """The min-max normalized DoG of ``dog_loss`` through one package's
    functions (numpy out)."""
    gray = gt.mean(0, keepdim=True) if isinstance(gt, torch.Tensor) else gt.mean(0, keepdims=True)
    sigma = 0.1 + (100 - freq) * 0.1 if freq >= 50 else 0.1 + freq * 0.1
    k1 = L._gaussian_kernel(int(2 * round(3 * sigma) + 1), sigma)
    k2 = L._gaussian_kernel(int(2 * round(6 * sigma) + 1), 2 * sigma)
    down = resize(gray, (20, 24))
    up = np.asarray(resize(L.depthwise_conv2d(down, k1) - L.depthwise_conv2d(down, k2), (40, 48)))
    return (up - up.min()) / (up.max() - up.min() + 1e-12)


@pytest.mark.parametrize("freq,seed", [(90, 1), (30, 3)])
def test_dog_loss_matches_jax(freq, seed):
    """Value rel 1e-5, gradient abs 1e-7. The masks are equal: at every
    pixel the normalized DoG lies further from its 0.5 cut than four times
    the two packages' difference (asserted; the normalization by a small
    range amplifies the resize's ulps at the wide sigma of freq 30)."""
    img, gt = images(seed)
    jn = dog_normed(JL, JL._resize, jnp.asarray(gt), freq)
    tn = dog_normed(TL, lambda x, o: resize_linear(x, *o), torch.as_tensor(gt), freq)
    assert (np.abs(jn - 0.5) > 4 * np.abs(jn - tn)).all()
    jv, jg, tv, tg = both_grads(lambda a, b: JL.dog_loss(a, b, freq=freq),
                                lambda a, b: TL.dog_loss(a, b, freq=freq), img, gt)
    assert abs(tv - jv) <= 1e-5 * abs(jv) and jv > 0
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-7)


def test_smoothness_loss_matches_jax():
    """Value rel 1e-5 and gradient rel 1e-4 of its largest; the quantile
    mask is equal (no GT gradient norm within 1e-6 of the threshold,
    asserted). The render has no pixel whose Scharr gradient is exactly
    zero: there the JAX gradient is NaN (``jnp.linalg.norm`` at 0) and the
    port's 0."""
    img, gt = images(2)
    up = np.asarray(JL._resize(JL.scharr(JL._resize(jnp.asarray(gt), (20, 24)), ret_norm=True),
                               (40, 48)))
    thr = np.quantile(up, 0.3)
    assert np.abs(up - thr).min() > 1e-6 * thr
    jv, jg, tv, tg = both_grads(JL.smoothness_loss, TL.smoothness_loss, img, gt)
    assert np.isfinite(jg).all()
    assert abs(tv - jv) <= 1e-5 * abs(jv) and jv > 0
    assert np.abs(tg - jg).max() <= 1e-4 * np.abs(jg).max()


def test_smoothness_gradient_at_a_flat_render_is_finite():
    """A render that is flat around a pixel (zero Scharr gradient): the
    port's gradient is finite there, the JAX one is NaN (logged in
    ROADMAP Queue C)."""
    img, gt = images(2)
    img[:, 10:20, 10:20] = 0.5
    _, jg, tv, tg = both_grads(JL.smoothness_loss, TL.smoothness_loss, img, gt)
    assert np.isfinite(tg).all() and np.isfinite(tv)
    assert np.isnan(jg).any()


def trained_triangles(n=16, K=4, views=3, seed=0):
    """Numpy triangle params in front of the identity camera with random
    color transforms per view."""
    from triangle_splatting_tpu_torch.utils.testing import make_random_scene
    s = make_random_scene(n, seed=seed)
    rng = np.random.default_rng(seed)
    p = dict(vertex=s["vertex"], opacity=np.log(s["opacity"] / (1 - s["opacity"]))[:, None],
             f_dc=s["sh_dc"], f_rest=(0.1 * rng.normal(size=(n, K - 1, 3))).astype(np.float32),
             affine_weight=(np.eye(3) + 0.1 * rng.normal(size=(views, 3, 3))).astype(np.float32),
             affine_bias=(0.05 * rng.normal(size=(views, 3))).astype(np.float32))
    st = leaves(JM.TriangleState.create(n))
    st["alive"] = np.ones(n, bool)
    return {k: np.asarray(v, np.float32) for k, v in p.items()}, st


def test_color_affine_forward_and_adam_group_match_jax():
    """``forward`` with the affine on (camera uid 2), both packages on their
    dense oracles: the transformed, clipped render and ``render_original``
    abs 1e-5, the gradients of a
    squared loss with respect to every leaf rel 1e-4; off in evaluation
    (``apply_color_affine=False``); ``setup_color_affine`` gives identities;
    one Adam step through the ``affine`` lr group equals JAX's."""
    from triangle_splatting_tpu.utils.testing import make_camera as j_make_camera
    from triangle_splatting_tpu_torch.ops.projection import RasterSettings
    from triangle_splatting_tpu_torch.utils.testing import make_camera
    from triangle_splatting_tpu.ops.projection import RasterSettings as JRS
    p, st = trained_triangles()
    jcfg = JM.ModelConfig(max_sh_degree=1, use_color_affine=True)
    tcfg = TM.ModelConfig(max_sh_degree=1, use_color_affine=True)
    jcam = dataclasses.replace(j_make_camera(32, 32), uid=2)
    tcam = dataclasses.replace(make_camera(32, 32, device="cpu"), uid=2)
    jset = JRS(image_width=32, image_height=32, max_sh_degree=1)
    tset = RasterSettings(image_width=32, image_height=32, max_sh_degree=1)
    target = np.random.default_rng(4).uniform(size=(3, 32, 32)).astype(np.float32)
    jp = JM.TriangleParams(**{k: jnp.asarray(v) for k, v in p.items()})
    js = JM.TriangleState(**{k: jnp.asarray(v) for k, v in st.items()})

    def jloss(params):
        pkg = JM.forward(params, js, jcam, jnp.ones(3), jcfg, jset, impl="oracle")
        return ((pkg["render"] - target) ** 2).sum(), pkg
    (jl, jpkg), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp, ts, _ = triangle_from_numpy(p, st, device="cpu")
    lv = {k: t.requires_grad_(True) for k, t in tp.tensors().items()}
    tpkg = TM.forward(TM.TriangleParams(**lv), ts, tcam, torch.ones(3), tcfg, tset,
                      impl="oracle")
    tl = ((tpkg["render"] - torch.as_tensor(target)) ** 2).sum()
    tg = dict(zip(lv, torch.autograd.grad(tl, list(lv.values()))))
    for name in ("render", "render_original"):
        np.testing.assert_allclose(tpkg[name].detach().numpy(), np.asarray(jpkg[name]), atol=1e-5)
    assert float(tpkg["render"].detach().min()) == 0.0 or float(tpkg["render"].detach().max()) == 1.0
    for name, want in leaves(jg).items():
        if want is not None:
            err = np.abs(tg[name].numpy() - want).max() / max(np.abs(want).max(), 1e-30)
            assert err <= 1e-4, (name, err)
    off = TM.forward(tp, ts, tcam, torch.ones(3), tcfg, tset, impl="oracle",
                     apply_color_affine=False)
    assert "render_original" not in off
    np.testing.assert_array_equal(off["render"].detach().numpy(),
                                  tpkg["render_original"].detach().numpy())

    ident = TM.setup_color_affine(tp, 5)
    want = JM.setup_color_affine(jp, 5)
    np.testing.assert_array_equal(ident.affine_weight.numpy(), np.asarray(want.affine_weight))
    np.testing.assert_array_equal(ident.affine_bias.numpy(), np.asarray(want.affine_bias))
    lrs = dict(vertex=0.001, opacity=0.05, f_dc=0.02, f_rest=0.001, affine=0.003)
    jp2, _ = JM.adam_update(jp, JM.AdamState.create(jp), jg,
                            {k: np.float32(v) for k, v in lrs.items()})
    tgp = TM.TriangleParams(**{k: v.detach() for k, v in tg.items()})
    tp2, _ = TM.adam_update(tp, TM.AdamState.create(tp), tgp, lrs)
    for name in ("affine_weight", "affine_bias"):
        np.testing.assert_allclose(getattr(tp2, name).numpy(), np.asarray(getattr(jp2, name)),
                                   rtol=1e-6, atol=1e-7)


def terms_config(root, out_dir, iters=12, **trainer):
    """A photo recipe at 32x32 with the four terms on: w_dog 0.05,
    w_smoothness 0.05, vertex_reg (0.01, every 5 steps from step 0), the
    color affine (lr 0.001, w_affine_reg 0.01)."""
    lr = lambda a, b: dict(v_init=a, v_final=b, max_steps=iters)  # noqa: E731
    return dict(
        dataset=dict(type="NerfSynthetic", local_dir=str(root), background="white",
                     use_alpha_mask=False, num_workers=2, pcd_path="point_cloud.ply",
                     hold_test_set=True),
        model=dict(max_sh_degree=1, rasterizer_type="2D", pairs_per_triangle=16,
                   use_color_affine=True,
                   sampling=dict(sample_method="direct", init_opacity=0.3),
                   optimizer=dict(vertex=lr(0.002, 0.0002), opacity=lr(0.05, 0.02),
                                  f_dc=lr(0.02, 0.005), f_rest=lr(0.001, 0.001),
                                  color_affine=lr(0.001, 0.001)),
                   model_update=dict(sh_schedule=dict(one_up_iters=[3]))),
        trainer=dict(type="VanillaTS", output_dir=str(out_dir), iterations=iters,
                     initial_eval=False, log_interval_iter=5, eval_interval_iter=0,
                     histogram_interval_iter=0, save_iterations=[], checkpoint_iterations=[],
                     train_background="white", eval_background="white", w_ssim=0.2,
                     w_dog=0.05, w_smoothness=0.05, w_affine_reg=0.01,
                     vertex_reg=dict(w_vertex_reg=0.01, start_iter=0, interval_iter=5),
                     use_tensorboard=False, seed=0, **trainer))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from triangle_splatting_tpu_torch.utils.testing import build_synthetic_nerf_dataset
    return build_synthetic_nerf_dataset(tmp_path_factory.mktemp("terms_torch"), res=RES,
                                        n_tri=N_TRI, n_train=6, device="cpu")


def test_vanilla_ts_step_with_all_four_terms_matches_jax(dataset, tmp_path):
    """One step with DoG, smoothness, the vertex regularizer (JAX's
    ``nearest_neighbor`` indices against the port's: equal) and the color
    affine (perturbed off identity) on one model in both trainers: the
    loss weights equal (L1's is 1 - w_ssim - w_dog - w_smooth), the loss rel
    1e-4 (SSIM's budget, as the plain step of tests/test_torch_trainer.py),
    the vertex term rel 1e-5, every gradient rel 2e-3 of its largest (the
    oracle budget of that test). The view is filled by 400 triangles, so
    that no rendered pixel has a zero Scharr gradient (asserted): there the
    JAX smoothness gradient is NaN (ROADMAP Queue C), as it is on the
    white background of the dataset's views."""
    from triangle_splatting_tpu.ops.knn import nearest_neighbor as j_nn
    from triangle_splatting_tpu.trainers.vanilla_ts import VanillaTSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as j_dict_to_config
    from triangle_splatting_tpu.utils.testing import make_camera as j_make_camera
    from triangle_splatting_tpu_torch.ops.knn import nearest_neighbor
    from triangle_splatting_tpu_torch.utils.testing import make_camera, make_random_scene
    jt = JT(j_dict_to_config(terms_config(dataset, tmp_path / "j")), impl="oracle",
            log_file=False)
    tt = build_trainer(dict_to_config(terms_config(dataset, tmp_path / "t")), device="cpu",
                       log_file=False)
    tt._init_model()
    V = tt.dataset.getTrainDatasetSize()
    assert tt.params.affine_weight.shape == (V, 3, 3)
    n = 400
    sc = make_random_scene(n, seed=3, z_range=(3.0, 4.0), xy_extent=2.2, size_range=(0.3, 0.6),
                           opacity_range=(0.3, 0.7))
    rng = np.random.default_rng(6)
    p = dict(vertex=sc["vertex"], opacity=np.log(sc["opacity"] / (1 - sc["opacity"]))[:, None],
             f_dc=sc["sh_dc"], f_rest=0.1 * rng.normal(size=(n, 3, 3)),
             affine_weight=np.eye(3) + 0.05 * rng.normal(size=(V, 3, 3)),
             affine_bias=0.02 * rng.normal(size=(V, 3)))
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    st = leaves(JM.TriangleState.create(n))
    st["alive"] = np.arange(n) != 7
    st["active_sh_degree"] = np.int32(1)
    jp = JM.TriangleParams(**{k: jnp.asarray(v) for k, v in p.items()})
    js = JM.TriangleState(**{k: jnp.asarray(v) for k, v in st.items()})
    tp, ts, _ = triangle_from_numpy(p, st, device="cpu")
    gt = images(7, (3, 32, 32))[1]
    jcam = dataclasses.replace(j_make_camera(32, 32), gt_image=jnp.asarray(gt), uid=1)
    tcam = dataclasses.replace(make_camera(32, 32, device="cpu"), gt_image=torch.as_tensor(gt),
                               uid=1)
    jw, tw = jt._loss_weights(1), tt._loss_weights(1)
    assert {k: float(v) for k, v in jw.items()} == tw
    assert tw["l1"] == np.float32(1 - 0.2 - 0.05 - 0.05)
    jnear = np.asarray(j_nn(jp.vertex.reshape(-1, 3), 3, jnp.repeat(js.alive, 3)))
    tnear = nearest_neighbor(tp.vertex.reshape(-1, 3), 3, ts.alive.repeat_interleave(3))
    np.testing.assert_array_equal(tnear.numpy(), jnear)
    settings = tt._settings_for(tcam)
    with torch.no_grad():
        img = TM.forward(tp, ts, tcam, torch.ones(3), tt.model_cfg, settings)["render"]
        assert bool((TL.scharr(img, ret_norm=True) > 0).all())

    c2d = jnp.zeros((n, 2))
    (jl, jaux), jg = jax.value_and_grad(
        lambda pp: jt._camera_loss(jt._settings_for(jcam), pp, c2d, js, jcam, jnp.ones(3), jw,
                                   jnp.asarray(jnear)), has_aux=True)(jp)
    tl, tg, taux = tt._loss_and_grads(settings, tp, ts, tcam, torch.ones(3), tw, tnear)
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
    assert abs(float(taux["vertex_loss"]) - float(jaux["vertex_loss"])) <= \
        1e-5 * float(jaux["vertex_loss"])
    for name, want in leaves(jg).items():
        if want is not None:
            assert np.isfinite(want).all(), name
            err = float(np.abs(getattr(tg, name).numpy() - want).max() / np.abs(want).max())
            assert err <= 2e-3, (name, err)


def test_terms_train_and_refresh_on_their_cadence(dataset, tmp_path):
    """The port trainer with the four terms for 12 steps: the losses are
    finite and fall; the kNN refresh runs at steps 1, 6 and 11 (every 5 from
    step 0) and again at the step after a capacity growth; the affine
    parameters moved off identity; evaluation leaves the affine out."""
    tr = build_trainer(dict_to_config(terms_config(dataset, tmp_path)), device="cpu",
                       log_file=False)
    tr.train()
    losses = torch.stack(tr.loss_history).numpy()
    assert np.isfinite(losses).all() and losses[-3:].mean() < losses[:3].mean()
    assert tr.nearest_history == [1, 6, 11]
    assert float((tr.params.affine_weight - torch.eye(3)).abs().max()) > 1e-4
    assert float(tr.params.affine_bias.abs().max()) > 1e-4
    tr._grow_capacity()
    tr._refresh_nearest(13)
    assert tr.nearest_history[-1] == 13 and tr._nearest_idx.shape == (3 * tr.params.capacity,)


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

def test_lpips_matches_jax_on_random_weights():
    """``random_weights(0)`` equal to JAX's draws; identical images give 0;
    one pair and a batch of two, rel 1e-4 of JAX's distance."""
    jw, tw = JP.random_weights(0), TP.random_weights(0)
    for k, v in jw.items():
        np.testing.assert_array_equal(tw[k].numpy(), np.asarray(v), err_msg=k)
    a, b = images(5, (3, 32, 40))
    c, d = images(6, (3, 32, 40))
    assert float(TP.lpips(torch.as_tensor(a), torch.as_tensor(a), weights=tw)) == 0.0
    want = float(JP.lpips(a, b, weights=jw))
    got = float(TP.lpips(torch.as_tensor(a), torch.as_tensor(b), weights=tw))
    assert want > 0 and abs(got - want) <= 1e-4 * want
    wantb = np.asarray(JP.lpips(np.stack([a, c]), np.stack([b, d]), weights=jw))
    gotb = TP.lpips(torch.as_tensor(np.stack([a, c])), torch.as_tensor(np.stack([b, d])),
                    weights=tw).numpy()
    assert gotb.shape == (2,)
    np.testing.assert_allclose(gotb, wantb, rtol=1e-4)


def test_lpips_without_weights(dataset, tmp_path, monkeypatch):
    """No weights file: ``lpips`` raises FileNotFoundError, and a trainer with
    ``eval_lpips`` logs "LPIPS unavailable" once and reports NaN while PSNR
    and SSIM stay finite. The npz schema loads back (``load_weights``)."""
    monkeypatch.setattr(TP, "_CACHED", None)
    monkeypatch.setattr(TP, "_TRIED", False)
    monkeypatch.setenv("TS_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    monkeypatch.setattr(TP, "_find_weights", lambda: None)
    with pytest.raises(FileNotFoundError):
        TP.lpips(torch.zeros(3, 8, 8), torch.zeros(3, 8, 8))
    cfg = terms_config(dataset, tmp_path / "out", iters=1, eval_lpips=True)
    tr = build_trainer(dict_to_config(cfg), device="cpu", log_file=False)
    warned = []
    tr.logger.warning = warned.append
    tr._init_model()
    psnr = tr._evaluate(0)
    tr._evaluate(1)
    assert np.isfinite(psnr) and np.isnan(tr.last_eval["lpips"])
    assert len(warned) == 1 and "LPIPS unavailable" in warned[0]
    np.savez(tmp_path / "w.npz", **{k: v.numpy() for k, v in TP.random_weights(1).items()})
    w = TP.load_weights(str(tmp_path / "w.npz"))
    assert w["conv12_w"].shape == (512, 512, 3, 3)
