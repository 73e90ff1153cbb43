"""The port's viewer (``viewer.py``) against the JAX package's
(``tests/test_viewer.py``): ``ViewerState.render`` on the same model
directory gives the JAX frames before JPEG encoding in each mode, and the
HTTP server answers the same routes with JPEGs of the requested size."""

import io
import json
import urllib.request

import numpy as np
import pytest
import torch

from triangle_splatting_tpu.models.raw_triangle import RawTriangle
from triangle_splatting_tpu.viewer import ViewerState as JViewer
from triangle_splatting_tpu_torch.ops.cuda import launch_counts
from triangle_splatting_tpu_torch.viewer import ViewerState as TViewer
from triangle_splatting_tpu_torch.viewer import run_viewer
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

pytest.importorskip("PIL")
RES = 96


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """tests/test_viewer.py's model: 64 random triangles, SH 3 with live DC
    and rest bands, as a PLY and a GLB."""
    root = tmp_path_factory.mktemp("viewer_model")
    rng = np.random.default_rng(3)
    n = 64
    centers = rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.5
    verts = centers + rng.normal(size=(n, 3, 3)).astype(np.float32) * 0.25
    raw = RawTriangle(
        vertex=verts, opacity=np.full((n, 1), 2.0, np.float32),
        shs=np.concatenate([rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                            0.2 * rng.normal(size=(n, 45)).astype(np.float32)], axis=1))
    raw.savePLY(root / "point_cloud" / "7000.ply")
    raw.saveGLB(root / "glb" / "7000.glb", save_back=True)
    return root


def request(**overrides):
    req = {"pose": {"eye": [0.3, -0.5, -4], "target": [0, 0, 0], "up": [0, -1, 0]},
           "mode": "color", "bg": "white", "res": RES, "gamma": 1.0, "sh": 3}
    req.update(overrides)
    return req


CASES = [dict(mode=m) for m in ("color", "depth", "normal")] + [
    dict(mode="color", gamma=30.0, bg="black"), dict(mode="color", sh=1),
    dict(mode="color", model="glb/7000.glb"), dict(mode="normal", model="glb/7000.glb", gamma=50.0)]


@pytest.fixture(scope="module")
def viewers(model_dir):
    return JViewer(model_dir, 3, "2D"), TViewer(model_dir, 3, "2D", device="cpu")


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_viewer_frames_match_jax(viewers, case):
    """The float frame before JPEG: color 1e-3 abs (the render budget,
    widened by gamma / 5 past gamma 5); normal 2e-3 abs of the unit normal
    mapped to [0, 1]; depth, which goes through the 2-98 percentile window
    and an 8-bit JET table, equal on all but 1% of the pixels (a level that
    flips at a quantization edge) and there within one JET step (5/255).
    The info line is the JAX one; the port's plain kernel versions run (no
    launches on the CPU)."""
    jv, tv = viewers
    before = launch_counts()
    t_img, t_info = tv.render(request(**case))
    j_img, j_info = jv.render(request(**case))
    assert launch_counts() == before
    assert t_info == j_info
    assert t_img.shape == j_img.shape == (RES, RES, 3)
    d = np.abs(t_img - np.asarray(j_img))
    mode = case["mode"]
    if mode == "depth":
        assert (d > 0).mean() <= 0.01 and d.max() <= 5 / 255 + 1e-6, ((d > 0).mean(), d.max())
        assert t_img.std() > 0.05
    else:
        widen = max(1.0, case.get("gamma", 1.0) / 5.0)
        assert d.max() <= (1e-3 if mode == "color" else 2e-3) * widen, d.max()
        assert t_img.std() > 0.01
    assert not tv.last["overflow"] and tv.last["num_pairs"] > 0


def test_viewer_loads_sh_degree_and_glb_as_jax(viewers):
    """The loaded state: every triangle alive, ``active_sh_degree`` the
    viewer's maximum, and the request's ``sh`` capping it per frame."""
    jv, tv = viewers
    for rel in ("point_cloud/7000.ply", "glb/7000.glb"):
        tv.load(rel)
        jv.load(rel)
        assert int(tv.state.alive.sum()) == int(np.asarray(jv.state.alive).sum()) == 64
        assert int(tv.state.active_sh_degree) == int(jv.state.active_sh_degree) == 3
        np.testing.assert_array_equal(tv.params.vertex.numpy(), np.asarray(jv.params.vertex))
        np.testing.assert_array_equal(tv.params.f_rest.numpy(), np.asarray(jv.params.f_rest))
    assert tv.models == jv.models == ["point_cloud/7000.ply", "glb/7000.glb"]


@pytest.fixture(scope="module")
def server(model_dir):
    srv = run_viewer(str(model_dir), host="127.0.0.1", port=0, block=False, device="cpu")
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def post(base, **overrides):
    r = urllib.request.urlopen(urllib.request.Request(
        f"{base}/render", data=json.dumps(request(**overrides)).encode(), method="POST"),
        timeout=120)
    assert r.status == 200 and r.headers["Content-Type"] == "image/jpeg"
    return r.read(), r.headers


def test_viewer_http_roundtrip(server):
    """tests/test_viewer.py's round trip: the model list, the page, JPEGs
    of the requested size in each mode with the JAX info line, the pairs
    and overflow headers, and gamma and the GLB changing the frame."""
    from PIL import Image
    with urllib.request.urlopen(f"{server}/models", timeout=30) as r:
        assert json.loads(r.read()) == ["point_cloud/7000.ply", "glb/7000.glb"]
    with urllib.request.urlopen(server, timeout=30) as r:
        assert b"2DTS viewer" in r.read()
    for mode, res in (("color", 128), ("depth", 64), ("normal", 96)):
        data, headers = post(server, mode=mode, res=res)
        img = np.asarray(Image.open(io.BytesIO(data)))
        assert img.shape == (res, res, 3), mode
        assert headers["X-Info"] == f"64 tris @ {res}px"
        assert int(headers["X-Num-Pairs"]) > 0 and headers["X-Overflow"] == "0"
    soft, _ = post(server, gamma=1.0)
    hard, _ = post(server, gamma=30.0)
    assert soft != hard
    glb, headers = post(server, model="glb/7000.glb", bg="black")
    assert len(glb) > 500 and "64 tris" in headers["X-Info"]
    assert torch.is_grad_enabled()
