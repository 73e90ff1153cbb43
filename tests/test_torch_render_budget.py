"""The render path's pair budget (``ops/rasterize.py:PairBudget``): the
model facades, the viewer and ``render_utils.make_render_fn`` bin each
frame at a budget sized from the pairs their frames needed, and return the
images of the default budget bit for bit; a frame that overflows the
budget is rendered again at one that holds it. The budget's rules are
checked on synthetic frames, in pairs and with no per-primitive floor,
and frames that alternate between two sizes render again only once."""

import numpy as np
import pytest
import torch

import triangle_splatting_tpu_torch as tts
from triangle_splatting_tpu_torch.models import scaffold as S
from triangle_splatting_tpu_torch.models import triangle as M
from triangle_splatting_tpu_torch.models.point_cloud import PointCloud
from triangle_splatting_tpu_torch.ops.cuda.blend import ALIGN
from triangle_splatting_tpu_torch.ops.projection import RasterSettings
from triangle_splatting_tpu_torch.ops.rasterize import (PAIR_MARGIN, PAIR_SHRINK_AFTER,
                                                        PairBudget)
from triangle_splatting_tpu_torch.utils import tracing
from triangle_splatting_tpu_torch.utils.camera import Camera
from triangle_splatting_tpu_torch.utils.config import dict_to_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

W = H = 96
CPU = dict(device="cpu")
# camera translations: the scene starts far (few pairs: the budget shrinks
# from the default), comes close (more pairs than the shrunk budget holds:
# the frame renders again) and dollies on both ways
DOLLY = [(0.0, 0.0, 2.5), (0.1, 0.0, -1.6), (0.0, 0.0, 0.0), (0.2, -0.1, 1.5),
         (-0.1, 0.1, -1.2)]
OUTPUTS = ("render", "depth", "final_T", "n_contrib")


def default_max_pairs(P: int) -> int:
    """The budget of a frame binned with ``max_pairs=None``: 6 a primitive,
    aligned."""
    return -(-int(RasterSettings(image_width=W, image_height=H).pairs_per_triangle * P)
             // ALIGN) * ALIGN


def camera(t) -> Camera:
    return Camera.create(R=np.eye(3, dtype=np.float32), T=np.asarray(t, np.float32),
                         fovx=np.deg2rad(60.0), fovy=np.deg2rad(60.0), image_width=W,
                         image_height=H, **CPU)


def pcd(n=80, seed=0) -> PointCloud:
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3), np.float32) - 0.5) * 2
    pts[:, 2] += 4.0
    return PointCloud(points=pts, colors=rng.random((n, 3), np.float32),
                      normals=np.tile(np.array([0, 0, 1], np.float32), (n, 1)))


def triangle_facade():
    return tts.VanillaTSModel(dict_to_config({"max_sh_degree": 0}), **CPU).create_from_pcd(
        pcd(), init_opacity=0.4)


def scaffold_facade():
    return tts.ScaffoldGSModel(dict_to_config({"feat_dim": 8, "hidden_dim": 16,
                                               "n_offsets": 3}), **CPU).create_from_pcd(
        pcd(60), voxel_size=0.2)


def unsized(m, cam, background):
    """The facade's core forward at the default budget (``max_pairs=None``)."""
    core = M.forward if isinstance(m, tts.VanillaTSModel) else S.forward
    kw = dict(need_stats=True, apply_color_affine=False) if core is M.forward \
        else dict(need_stats=False)
    settings = RasterSettings(image_width=W, image_height=H, max_sh_degree=0)
    with torch.no_grad():
        return core(m.params, m.state, cam, torch.as_tensor(background), m.cfg, settings,
                    is_training=False, impl="cuda", max_pairs=None, **kw)


def assert_same_bits(got, want):
    for k in OUTPUTS:
        assert torch.equal(got[k], want[k]), k
    assert int(got["pairs_needed"]) == int(want["pairs_needed"]) == int(want["num_pairs"])
    assert not bool(got["overflow"])


@pytest.fixture
def traced():
    tracing.enable()
    yield
    tracing.disable()


@pytest.mark.parametrize("make", [triangle_facade, scaffold_facade], ids=["ts", "scaffold"])
def test_sized_budget_renders_the_default_budgets_bits(make, traced):
    """Every pose of a dolly sequence, through the facade's own budget, is
    the default budget's render, depth, final_T and n_contrib bit for bit;
    after the first frame the facade bins at a budget far below the default
    and counts each frame's budget and pairs; the close pose renders again."""
    m = make()
    bg = (1.0, 1.0, 1.0)
    default = default_max_pairs(m.params.vertex.shape[0] if isinstance(m, tts.VanillaTSModel)
                                else m.params.capacity * m.cfg.n_offsets)
    budgets, rerenders = [], 0
    for t in DOLLY:
        cam = camera(t)
        before = m._budget.max_pairs or default
        c0 = tracing.snapshot()["counters"]
        got = m.forward(cam, bg)
        c1 = tracing.snapshot()["counters"]
        assert_same_bits(got, unsized(m, cam, bg))
        again = c1.get("raster.rerender", 0) - c0.get("raster.rerender", 0)
        assert again in (0, 1)
        rerenders += again
        budgets.append(m._budget.max_pairs)
        # the frame binned at the budget it found, and once more at the new one
        assert c1["raster.budget"] - c0.get("raster.budget", 0) == before + again * budgets[-1]
        assert c1["raster.pairs"] - c0.get("raster.pairs", 0) \
            == int(got["pairs_needed"]) + again * min(int(got["pairs_needed"]), before)
    assert all(b is not None and b < default for b in budgets), (budgets, default)
    assert rerenders >= 1 and m._budget.rerenders == rerenders, budgets


def test_a_budget_below_the_need_renders_again(traced):
    """A budget forced below the frame's need re-renders once: the facade
    returns the default budget's bits, counts ``raster.rerender`` 1, and
    keeps PAIR_MARGIN x the need, aligned."""
    m = triangle_facade()
    cam = camera(DOLLY[2])
    want = unsized(m, cam, (0.0, 0.0, 0.0))
    need = int(want["pairs_needed"])
    assert need > ALIGN
    m._budget.max_pairs = ALIGN
    c0 = tracing.snapshot()["counters"]
    got = m.forward(cam, (0.0, 0.0, 0.0))
    c1 = tracing.snapshot()["counters"]
    assert_same_bits(got, want)
    assert c1["raster.rerender"] - c0.get("raster.rerender", 0) == 1 == m._budget.rerenders
    assert c1["raster.budget"] - c0["raster.budget"] == ALIGN + m._budget.max_pairs
    assert m._budget.max_pairs == -(-int(np.ceil(PAIR_MARGIN * need)) // ALIGN) * ALIGN


def fit(need: int) -> int:
    """PAIR_MARGIN x ``need`` pairs, aligned (one alignment at the least)."""
    return -(-max(int(np.ceil(PAIR_MARGIN * need)), 1) // ALIGN) * ALIGN


class Frames:
    """Synthetic frames of 100,000 primitives through one ``PairBudget``:
    ``frame(need)`` returns the budgets the frame was binned at (None: the
    default) and the draw whose dict came back."""
    P = 100_000

    def __init__(self):
        self.budget = PairBudget()

    def frame(self, need: int, again_over: bool = False):
        drawn = []

        def draw(max_pairs):
            drawn.append(max_pairs)
            held = default_max_pairs(self.P) if max_pairs is None else max_pairs
            over = need > held or (again_over and len(drawn) > 1)
            return dict(overflow=torch.tensor(over),
                        pairs_needed=torch.tensor(need, dtype=torch.int64), drawn=len(drawn))
        out = self.budget.render(draw)
        assert out["drawn"] == len(drawn)
        return drawn


def test_budget_rules_in_pairs_with_no_per_primitive_floor():
    """The first frame bins at the default and the budget becomes
    PAIR_MARGIN x its need, whatever the default was; it shrinks only after
    PAIR_SHRINK_AFTER frames in a row fit below half of it, to the largest
    of their sizes (far below the trainers' 2 pairs a primitive), and a
    frame at or above half starts the run again; a need over the budget
    renders the frame again at PAIR_MARGIN x the need and returns that
    render; a frame with no pairs needs one alignment."""
    f = Frames()
    assert f.frame(300_000) == [None] and f.budget.max_pairs == fit(300_000)
    small = [10_000, 12_000, 3_000, 9_000, 0, 11_000, 4_000]
    assert len(small) == PAIR_SHRINK_AFTER - 1
    for need in small:
        assert f.frame(need) == [fit(300_000)] and f.budget.max_pairs == fit(300_000)
    assert f.frame(fit(300_000) // 2) == [fit(300_000)]     # not below half: run restarts
    for need in small:
        f.frame(need)
    assert f.budget.max_pairs == fit(300_000)
    assert f.frame(5_000) == [fit(300_000)]                # the run's eighth frame
    assert f.budget.max_pairs == fit(12_000) < 2 * Frames.P
    assert f.frame(12_000) == [fit(12_000)]                # the run's largest fits
    assert f.frame(20_000) == [fit(12_000), fit(20_000)]   # overflow: rendered again
    assert f.budget.max_pairs == fit(20_000) and f.budget.rerenders == 1
    assert f.frame(fit(20_000)) == [fit(20_000)]           # exactly full: no overflow
    for _ in range(PAIR_SHRINK_AFTER):
        f.frame(0)
    assert f.budget.max_pairs == fit(0) == ALIGN


def test_alternating_sizes_render_again_only_once():
    """A viewer that switches between a small and a 4x larger frame, and a
    tour that switches between two sizes, pay one second render, when the
    larger first comes: the budget keeps the larger one's size."""
    f = Frames()
    drawn = [f.frame(need) for _ in range(12) for need in (25_000, 100_000)]
    assert f.budget.rerenders == 1 and drawn[1] == [fit(25_000), fit(100_000)]
    assert all(d == [fit(100_000)] for d in drawn[2:])
    assert f.budget.max_pairs == fit(100_000)


def test_a_second_overflow_raises():
    """A frame whose second render still overflows raises, so no image
    with dropped pairs is returned."""
    f = Frames()
    f.frame(10_000)
    with pytest.raises(RuntimeError, match="overflowed"):
        f.frame(50_000, again_over=True)


def test_pairs_needed_is_the_unclamped_total():
    """``pairs_needed`` is the frame's pair total at any budget: binned at
    one alignment, the frame overflows, ``num_pairs`` is clamped to it and
    ``pairs_needed`` is the default budget's count."""
    m = triangle_facade()
    cam = camera(DOLLY[2])
    settings = RasterSettings(image_width=W, image_height=H, max_sh_degree=0)
    want = unsized(m, cam, (0.0, 0.0, 0.0))
    with torch.no_grad():
        got = M.forward(m.params, m.state, cam, torch.zeros(3), m.cfg, settings,
                        is_training=False, impl="cuda", max_pairs=ALIGN, need_stats=True,
                        apply_color_affine=False)
    assert want["pairs_needed"].dtype == got["pairs_needed"].dtype == torch.int32
    assert int(got["pairs_needed"]) == int(want["pairs_needed"]) > ALIGN
    assert bool(got["overflow"]) and int(got["num_pairs"]) == ALIGN


def test_viewer_renders_through_its_budget(tmp_path):
    """``ViewerState.render`` bins at its model's budget: the first frame at
    the default, the same request again at the sized budget gives the same
    frame, a budget forced below the need renders again (no overflow in
    ``last``), and loading another model keeps the budget, as a facade's
    is."""
    from triangle_splatting_tpu_torch.viewer import ViewerState
    m = triangle_facade()
    m.savePLY(tmp_path / "point_cloud" / "7000.ply")
    m.savePLY(tmp_path / "point_cloud" / "8000.ply")
    v = ViewerState(tmp_path, 0, "2D", device="cpu")
    req = {"pose": {"eye": [0.0, 0.0, -1.5], "target": [0.0, 0.0, 4.0], "up": [0, -1, 0]},
           "mode": "color", "bg": "white", "res": W, "gamma": 1.0, "sh": 0,
           "model": "point_cloud/7000.ply"}
    first, _ = v.render(req)
    sized = v.budget.max_pairs
    default = default_max_pairs(v.params.vertex.shape[0])
    assert sized is not None and sized < default and v.last["num_pairs"] > ALIGN
    np.testing.assert_array_equal(v.render(req)[0], first)
    v.budget.max_pairs = ALIGN
    np.testing.assert_array_equal(v.render(req)[0], first)
    assert v.budget.max_pairs == sized and not v.last["overflow"]
    assert v.budget.rerenders == 1
    v.budget.max_pairs = ALIGN
    np.testing.assert_array_equal(v.render(dict(req, model="point_cloud/8000.ply"))[0], first)
    assert v.current == "point_cloud/8000.ply"
    assert v.budget.max_pairs == sized and v.budget.rerenders == 2


def test_render_fn_renders_through_its_budget(traced):
    """``make_render_fn``'s closure bins at its own budget (``render_fn.budget``)
    and returns the default budget's bits across the dolly."""
    from triangle_splatting_tpu_torch.utils.render_utils import make_render_fn
    m = triangle_facade()
    render_fn = make_render_fn(m.params, m.state, m.cfg, **CPU)
    seen = []
    for t in DOLLY:
        cam = camera(t)
        c0 = tracing.snapshot()["counters"].get("raster.budget", 0)
        got = render_fn(cam)
        seen.append(tracing.snapshot()["counters"]["raster.budget"] - c0)
        assert_same_bits(got, unsized(m, cam, (0.0, 0.0, 0.0)))
    assert render_fn.budget.max_pairs is not None
    assert max(seen[1:]) < seen[0] == default_max_pairs(m.params.vertex.shape[0])
