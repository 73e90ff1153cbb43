"""The port's multi-process wiring (``triangle_splatting_tpu_torch/parallel/multihost.py``)
on the CPU: the settings and backend rules in this process, then real
ranks over Gloo (fresh interpreters importing only the port, after
tests/test_multihost.py): two ranks set up through ``TS_COORDINATOR`` /
``TS_NUM_PROCESSES`` / ``TS_PROCESS_ID`` take one VanillaTS data-parallel
step of ``data_parallel: 4`` (two views a rank), held against the one-rank
four-view step and JAX's ``_train_step_dp`` on a 4-device mesh; the scene is
32x32 with 80 GT triangles."""

import numpy as np
import pytest
import torch

from triangle_splatting_tpu_torch.parallel import multihost as MH
from triangle_splatting_tpu_torch.utils.config import dict_to_config
from torch_ranks import run_ranks
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ENV_KEYS = ("TS_COORDINATOR", "TS_NUM_PROCESSES", "TS_PROCESS_ID", "TS_BACKEND")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("source", ["none", "env", "block", "both"])
def test_distributed_settings(clean_env, source):
    """The trainer.distributed block wins over the TS_* environment; None
    without either (the JAX function's resolution)."""
    if source in ("env", "both"):
        clean_env.setenv("TS_COORDINATOR", "10.0.0.1:1234")
        clean_env.setenv("TS_NUM_PROCESSES", "4")
        clean_env.setenv("TS_PROCESS_ID", "3")
    cfg = dict_to_config({"trainer": {"distributed": {
        "coordinator": "127.0.0.1:99", "num_processes": 2, "process_id": 1}}}
        if source in ("block", "both") else {"trainer": {}})
    got = MH.distributed_settings(cfg)
    want = {"none": None, "env": ("10.0.0.1:1234", 4, 3), "block": ("127.0.0.1:99", 2, 1),
            "both": ("127.0.0.1:99", 2, 1)}[source]
    assert got == want
    assert MH.distributed_settings() == (want if source == "env" else
                                         ("10.0.0.1:1234", 4, 3) if source == "both" else None)


def test_backend_rule_and_no_job(clean_env):
    """NCCL for a CUDA device, Gloo for the CPU; the block's ``backend``
    overrides it, and TS_BACKEND (which mirrors the block) where the block
    names none; an unknown backend raises. Without settings no group is
    made and the world is one rank."""
    assert MH.resolve_backend(None, "cuda") == "nccl"
    assert MH.resolve_backend(None, "cpu") == "gloo"
    clean_env.setenv("TS_BACKEND", "gloo")
    assert MH.resolve_backend(None, "cuda") == "gloo"
    blk = dict_to_config({"trainer": {"distributed": {"backend": "nccl"}}})
    assert MH.resolve_backend(blk, "cpu") == "nccl"
    clean_env.setenv("TS_BACKEND", "mpi")
    with pytest.raises(ValueError, match="backend"):
        MH.resolve_backend(None, "cpu")
    clean_env.delenv("TS_BACKEND")
    assert MH.maybe_initialize(None, device="cpu") is False
    assert MH.world() == (0, 1) and MH.is_main_process()
    g = MH.make_global_mesh()
    assert (g.size, g.rank, g.world, g.group) == (1, 0, 1, None)


def test_checksum_and_global_dp_inputs():
    """Equal bits give equal checksums, one flipped bit another; a rank's
    share of the global batch is its contiguous slice."""
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.normal(size=(7, 3)).astype(np.float32))
    b = a.clone()
    assert torch.equal(MH.tree_checksum([a, b > 0])[0], MH.tree_checksum([b, a > 0])[0])
    c = a.clone()
    c.view(torch.int32)[3, 1] ^= 1
    assert not torch.equal(MH.tree_checksum([a]), MH.tree_checksum([c]))
    batch = list(range(8))
    for rank, want in ((0, [0, 1, 2, 3]), (1, [4, 5, 6, 7])):
        g = MH.DataGroup(size=2, rank=rank, world=2)
        assert g.takes_cameras and MH.global_dp_inputs(g, batch)[0] == want
    idle = MH.DataGroup(size=2, rank=2, world=3)
    assert not idle.takes_cameras and MH.global_dp_inputs(idle, batch)[0] == []
    with pytest.raises(ValueError, match="split"):
        MH.global_dp_inputs(MH.DataGroup(size=3, rank=0, world=3), batch)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from triangle_splatting_tpu_torch.utils.testing import build_synthetic_nerf_dataset
    return build_synthetic_nerf_dataset(tmp_path_factory.mktemp("mh_torch"), res=32, n_tri=80,
                                        n_train=4, n_test=2, pcd_points=200, seed=5,
                                        device="cpu")


DP_WORKER = r"""
import numpy as np
from triangle_splatting_tpu_torch.parallel import multihost
from triangle_splatting_tpu_torch.trainers import build_trainer
from triangle_splatting_tpu_torch.trainers.smoke import make_smoke_config

cfg = make_smoke_config(os.environ["TS_DATA"], f"{OUT}/rank{RANK}", 40)
cfg.trainer.data_parallel = 4
tr = build_trainer(cfg, device="cpu", impl="oracle", log_file=False)   # joins via TS_*
assert multihost.world() == (RANK, 2)
tr._init_model()
tr._setup_data_parallel()
g = tr._dp_group
assert (g.size, g.rank, g.backend, tr._dp_b) == (2, RANK, "gloo", 2), g
views = [tr.dataset.getTrainDataset()[i] for i in range(4)]
local, = multihost.global_dp_inputs(g, views)
it = 5
p, o, s, loss, aux = tr._train_step_dp(tr._settings_for(views[0]), tr.params, tr.opt,
                                       tr.state, local, tr._loss_weights(it), tr._lrs(it),
                                       torch.ones(3), it)
arrays = {f"p.{k}": v for k, v in p.tensors().items()}
arrays.update({f"m.{k}": v for k, v in o.m.tensors().items()})
arrays.update({f"v.{k}": v for k, v in o.v.tensors().items()})
arrays.update({f"s.{k}": getattr(s, k) for k in ("gradient_accum", "gradient_denom",
                                                  "contrib_sum", "contrib_max", "max_radii2d")})
sums = g.all_gather(multihost.tree_checksum(list(arrays.values())))
np.savez(f"{OUT}/dp{RANK}.npz", loss=loss.numpy(), same=bool((sums == sums[0]).all()),
         **{k: v.detach().numpy() for k, v in arrays.items()})
"""


def test_two_ranks_dp_step(dataset, tmp_path):
    """Two Gloo ranks, data_parallel 4: both ranks' params, moments and
    statistics equal bit for bit (a checksum all-gathered, and the files);
    equal to the one-rank four-view step within rtol 1e-6 (the sums are
    added in another order: (g1+g2)+(g3+g4)), view counts and radii
    exact; the loss JAX's four-camera loss within rel 1e-4
    (tests/test_torch_trainer.py's budget)."""
    run_ranks(DP_WORKER, 2, tmp_path, env={"TS_DATA": str(dataset)})
    r0, r1 = (np.load(tmp_path / f"dp{r}.npz") for r in range(2))
    assert bool(r0["same"]) and bool(r1["same"])
    for k in r0.files:
        np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)

    from triangle_splatting_tpu_torch.parallel.mesh import make_mesh
    from triangle_splatting_tpu_torch.trainers import build_trainer
    from triangle_splatting_tpu_torch.trainers.smoke import make_smoke_config
    cfg = make_smoke_config(dataset, tmp_path / "one", 40)
    cfg.trainer.data_parallel = 4
    tr = build_trainer(cfg, device="cpu", impl="oracle", log_file=False)
    tr._init_model()
    v0 = tr.params.vertex.numpy().copy()
    tr._dp_group, tr._dp_b = make_mesh(1), 4
    views = [tr.dataset.getTrainDataset()[i] for i in range(4)]
    p, o, s, loss, _ = tr._train_step_dp(tr._settings_for(views[0]), tr.params, tr.opt,
                                         tr.state, views, tr._loss_weights(5), tr._lrs(5),
                                         torch.ones(3), 5)
    one = {f"p.{k}": v for k, v in p.tensors().items()}
    one.update({f"m.{k}": v for k, v in o.m.tensors().items()})
    one.update({f"v.{k}": v for k, v in o.v.tensors().items()})
    for k, v in one.items():
        want = v.numpy()
        np.testing.assert_allclose(r0[k], want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()), err_msg=k)
    for k in ("gradient_denom", "max_radii2d"):
        np.testing.assert_array_equal(r0[f"s.{k}"], getattr(s, k).numpy(), err_msg=k)
    np.testing.assert_allclose(r0["s.gradient_accum"], s.gradient_accum.numpy(), rtol=1e-6,
                               atol=1e-12)
    assert abs(float(r0["loss"]) - float(loss)) <= 1e-6 * float(loss)

    import jax.numpy as jnp  # noqa: F401 (the JAX side: conftest's CPU mesh)
    from triangle_splatting_tpu.parallel.mesh import make_mesh as j_make_mesh
    from triangle_splatting_tpu.parallel.mesh import stack_dp_cameras
    from triangle_splatting_tpu.trainers.vanilla_ts import VanillaTSTrainer as JT
    from triangle_splatting_tpu.utils.config import dict_to_config as jcfg
    d = make_smoke_config(dataset, tmp_path / "j", 40).to_dict()
    d["trainer"]["data_parallel"] = 4
    jt = JT(jcfg(d), impl="oracle", log_file=False)
    jt._init_model()
    # both packages initialize the same triangles from the cloud and seed
    np.testing.assert_array_equal(np.asarray(jt.params.vertex), v0)
    jt._mesh, jt._dp_b = j_make_mesh(4), 1
    jviews = [jt.dataset.getTrainDataset()[i].strip_static() for i in range(4)]
    sched = jt._pack.pack({n: np.float32(w) for n, w in jt._loss_weights(5).items()},
                          jt._lrs(5), np.ones(3, np.float32), 5)
    _, _, _, jl, _ = jt._train_step_dp(jt._settings_for(jviews[0]), jt.params, jt.opt,
                                       jt.state, stack_dp_cameras(jviews), sched, None)
    assert abs(float(r0["loss"]) - float(jl)) <= 1e-4 * float(jl), (float(r0["loss"]), float(jl))


MISMATCH_WORKER = r"""
from triangle_splatting_tpu_torch.parallel import multihost
assert multihost.maybe_initialize(device="cpu")
g = multihost.make_global_mesh()
params = {"vertex": torch.arange(12, dtype=torch.float32).reshape(4, 3)}
multihost.check_replicated(g, params)                   # equal on both ranks: passes
batch = list(range(4))
local, same = multihost.global_dp_inputs(g, batch, params)
assert local == batch[2 * RANK:2 * RANK + 2] and same is params
if RANK == 1:
    params["vertex"][2, 1] += 1e-6
try:
    multihost.check_replicated(g, params, what="the params")
except RuntimeError as e:
    assert "ranks [1]" in str(e), e
    print("MISMATCH_SEEN", flush=True)
"""


def test_two_ranks_replicated_check(tmp_path):
    """Two Gloo ranks: equal trees pass ``check_replicated`` and
    ``global_dp_inputs``; one ulp-sized change on rank 1 raises on both
    ranks, naming rank 1."""
    outs = run_ranks(MISMATCH_WORKER, 2, tmp_path)
    assert all("MISMATCH_SEEN" in o for o in outs), outs


IDLE_WORKER = r"""
import dataclasses
import numpy as np
from triangle_splatting_tpu_torch.models import triangle as M
from triangle_splatting_tpu_torch.ops.projection import RasterSettings
from triangle_splatting_tpu_torch.parallel import mesh, multihost
from triangle_splatting_tpu_torch.trainers import losses as L
from triangle_splatting_tpu_torch.utils.testing import make_camera, make_random_scene

assert multihost.maybe_initialize(device="cpu")
d, b = mesh.dp_layout(2)
assert (d, b) == (2, 1)
g = mesh.make_mesh(d)
assert (g.size, g.world, g.takes_cameras) == (2, 3, RANK < 2)
s = make_random_scene(64, seed=1)
params, state = M.create_from_points(s["vertex"].mean(1), s["rgb"], None,
                                     M.ModelConfig(max_sh_degree=0), init_opacity=0.5,
                                     device="cpu")
rng = np.random.default_rng(2)
cams = [dataclasses.replace(make_camera(32, 32, fov, with_image=True, device="cpu"),
                            gt_image=torch.as_tensor(rng.random((3, 32, 32), np.float32)))
        for fov in (50.0, 60.0)]
step = mesh.make_dp_train_step(g, RasterSettings(image_width=32, image_height=32),
                               M.ModelConfig(max_sh_degree=0),
                               lambda pkg, c, p, st, w: L.l1(pkg["render"], c.gt_image))
local, = multihost.global_dp_inputs(g, cams)
lrs = {k: 1e-3 for k in ("vertex", "opacity", "f_dc", "f_rest", "affine")}
p2, o2, _, loss, c2d = step(params, M.AdamState.create(params), state, local, torch.ones(3),
                            lrs, {}, idle_camera=cams[0])
multihost.check_replicated(g, p2, o2, c2d)
np.savez(f"{OUT}/idle{RANK}.npz", loss=loss.numpy(), vertex=p2.vertex.numpy(),
         m=o2.m.vertex.numpy(), c2d=c2d.numpy())
"""


def test_three_ranks_one_idle(tmp_path):
    """data_parallel 2 over 3 Gloo ranks: dp_layout uses 2, the third takes
    no camera and adds zeros; all three end equal (checked across ranks)
    and equal to the one-rank two-view step: the loss, the moments and the
    centroid gradient within rtol 1e-6 (two views summed in one order on
    either side, zeros added), the parameters likewise."""
    run_ranks(IDLE_WORKER, 3, tmp_path)
    outs = [np.load(tmp_path / f"idle{r}.npz") for r in range(3)]
    for k in outs[0].files:
        np.testing.assert_array_equal(outs[2][k], outs[0][k], err_msg=k)

    import dataclasses
    from triangle_splatting_tpu_torch.models import triangle as M
    from triangle_splatting_tpu_torch.ops.projection import RasterSettings
    from triangle_splatting_tpu_torch.parallel import mesh
    from triangle_splatting_tpu_torch.trainers import losses as L
    from triangle_splatting_tpu_torch.utils.testing import make_camera, make_random_scene
    s = make_random_scene(64, seed=1)
    params, state = M.create_from_points(s["vertex"].mean(1), s["rgb"], None,
                                         M.ModelConfig(max_sh_degree=0), init_opacity=0.5,
                                         device="cpu")
    rng = np.random.default_rng(2)
    cams = [dataclasses.replace(make_camera(32, 32, fov, with_image=True, device="cpu"),
                                gt_image=torch.as_tensor(rng.random((3, 32, 32), np.float32)))
            for fov in (50.0, 60.0)]
    step = mesh.make_dp_train_step(mesh.make_mesh(1), RasterSettings(image_width=32,
                                                                     image_height=32),
                                   M.ModelConfig(max_sh_degree=0),
                                   lambda pkg, c, p, st, w: L.l1(pkg["render"], c.gt_image),
                                   cameras_per_device=2)
    lrs = {k: 1e-3 for k in ("vertex", "opacity", "f_dc", "f_rest", "affine")}
    p2, o2, _, loss, c2d = step(params, M.AdamState.create(params), state, cams, torch.ones(3),
                                lrs, {})
    want = dict(loss=loss.numpy(), vertex=p2.vertex.numpy(), m=o2.m.vertex.numpy(),
                c2d=c2d.numpy())
    for k, w in want.items():
        np.testing.assert_allclose(outs[0][k], w, rtol=1e-6, atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=k)
