"""The scene generators: deterministic by seed, cached by the generator's
source (and, for the city, by seed), and different across seeds only
where the seed is meant to act (the start model, and the city's colors;
never the layout, the views' poses or the work)."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from benchmark.scenes import city, colmap_soup
from benchmark.tests.conftest import TINY_SCENES

GENERATORS = {"city": city, "colmap_soup": colmap_soup}


def _params(kind):
    import json
    from benchmark.run import BENCH
    name = {"city": "matrixcity-mesh-1m", "colmap_soup": "scaffold-colmap-100k"}[kind]
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    return dict(cfg["scene"], **TINY_SCENES[kind], model=cfg["recipe"]["model"])


def _digest(root):
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file():
            h.update(p.relative_to(root).as_posix().encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def _start(scene) -> dict:
    if "start" in scene:
        return scene["start"]
    return dict(np.load(scene["start_npz"]))


@pytest.mark.parametrize("kind", sorted(GENERATORS))
def test_same_seed_same_scene_and_cache_hit(kind, scene_cache):
    gen = GENERATORS[kind]
    a = gen.build(_params(kind), 1234567890123, "cpu")
    first = _digest(a["root"])
    stamp = (a["root"] / "COMPLETE").stat().st_mtime_ns
    b = gen.build(_params(kind), 1234567890123, "cpu")
    assert b["root"] == a["root"]
    assert (b["root"] / "COMPLETE").stat().st_mtime_ns == stamp      # not rebuilt
    assert _digest(b["root"]) == first
    sa, sb = _start(a), _start(b)
    assert sorted(sa) == sorted(sb) and all(np.array_equal(sa[k], sb[k]) for k in sa)
    import shutil
    shutil.rmtree(a["root"])
    c = gen.build(_params(kind), 1234567890123, "cpu")
    assert _digest(c["root"]) == first                               # rebuilt the same


@pytest.mark.parametrize("kind", sorted(GENERATORS))
def test_seeds_change_the_start_model_not_the_work(kind, scene_cache):
    gen = GENERATORS[kind]
    a = gen.build(_params(kind), 1, "cpu")
    b = gen.build(_params(kind), 2, "cpu")
    sa, sb = _start(a), _start(b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].shape == sb[k].shape or kind == "colmap_soup"
    assert any(not np.array_equal(sa[k], sb[k]) for k in sa)
    assert [r["name"] for r in a["train"]] == [r["name"] for r in b["train"]]
    assert [r["q"] for r in a["train"]] == [r["q"] for r in b["train"]]     # same views
    same_views = np.array_equal(a["gt"](a["train"][0]).numpy(), b["gt"](b["train"][0]).numpy())
    assert same_views == (kind == "colmap_soup")      # the city's seed jitters its colors


def test_the_capture_is_built_once_for_every_seed(scene_cache):
    """A new seed finds the scaffold capture (cameras and views) in the
    cache: only the start model, made in memory, depends on the seed, so
    every run after a checkout's first does the same set-up work."""
    a = colmap_soup.build(_params("colmap_soup"), 11, "cpu")
    stamps = {p: p.stat().st_mtime_ns for p in a["root"].rglob("COMPLETE")}
    b = colmap_soup.build(_params("colmap_soup"), 2 ** 31 + 12345, "cpu")
    assert b["root"] == a["root"] and len(stamps) == 2
    assert {p: p.stat().st_mtime_ns for p in b["root"].rglob("COMPLETE")} == stamps
    assert not list(b["root"].rglob("*.npz")) and not list(b["root"].rglob("*.ckpt"))


def test_city_layout_is_fixed_and_the_start_model_fits_the_recipe():
    c1, c2 = city.make_city(cell=0.5), city.make_city(cell=0.5)
    assert np.array_equal(c1["vertex"], c2["vertex"])
    m = city.init_model(c1, 500, 5, 0.007, np.random.default_rng(3))
    side = np.linalg.norm(m["vertex"][:, 1] - m["vertex"][:, 0], axis=1)
    assert (side[:5] > 0.1).all() and (side[5:] < 0.02).all()     # scale pruning fires on 5
    assert m["opacity"].shape == (500, 1) and m["f_dc"].shape == (500, 1, 3)


def test_scaffold_start_is_in_the_checkpoint_layout():
    params = _params("colmap_soup")
    pts = np.random.default_rng(0).uniform(-0.01, 0.01, (50, 3)).astype(np.float32)
    flat = colmap_soup.start_model(pts, params["model"], 1, "cpu")
    blob = colmap_soup.checkpoint_blob(flat)
    cap = flat["p.anchor"].shape[0]
    assert cap % 256 == 0 and cap >= 4 * int(flat["s.alive"].sum())
    assert set(blob["params"]["mlps"]) == set(colmap_soup.HEADS)
    assert blob["opt"]["step"] == 0
    assert set(blob["state"]) == {"alive", "anchor_scaling", "anchor_rotation", "opacity_accum",
                                  "anchor_denom", "offset_grad_accum", "offset_denom", "voxel_size",
                                  "opacity_threshold"}
