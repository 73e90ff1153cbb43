"""Port tile binning vs the JAX ``bin_triangles``: every ``Binning`` field
integer-exact on identical numpy ``Preprocessed`` inputs (f32 noise from
two preprocess implementations could move a depth across a quantization
bucket, so both sides bin the same arrays)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangle_splatting_tpu.ops.binning import bin_triangles as j_bin
from triangle_splatting_tpu.ops.projection import Preprocessed as JPrep
from triangle_splatting_tpu.ops.projection import RasterSettings as JRS
from triangle_splatting_tpu.ops.projection import preprocess_2d as j_pre
from triangle_splatting_tpu.utils.testing import make_camera, make_random_scene
from triangle_splatting_tpu_torch.ops.binning import bin_triangles as t_bin
from triangle_splatting_tpu_torch.ops.projection import Preprocessed as TPrep
from triangle_splatting_tpu_torch.ops.projection import RasterSettings as TRS

FIELDS = ("pair_tri", "pair_valid", "tri_offsets", "tile_starts",
          "tile_counts", "num_pairs", "overflow")


def numpy_prep(P, W, H, seed):
    s = make_random_scene(P, seed=seed)
    cam = make_camera(W, H)
    prep = j_pre(jnp.asarray(s["vertex"]), jnp.zeros((P, 2)), jnp.asarray(s["rgb"]),
                 cam.world_view, cam.full_proj, cam.tan_fovx, cam.tan_fovy,
                 JRS(image_width=W, image_height=H),
                 opacity=jnp.asarray(s["opacity"]), gamma=jnp.float32(1.0))
    return {f.name: np.asarray(getattr(prep, f.name)) for f in dataclasses.fields(prep)}


def bin_both(arrs, W, H, max_pairs):
    jb = j_bin(JPrep(**{k: jnp.asarray(v) for k, v in arrs.items()}),
               JRS(image_width=W, image_height=H), max_pairs, interpret=True)
    tb = t_bin(TPrep(**{k: torch.as_tensor(np.array(v)) for k, v in arrs.items()}),
               TRS(image_width=W, image_height=H), max_pairs)
    return jb, tb


@pytest.mark.parametrize("P,W,H,seed,max_pairs", [
    (300, 64, 64, 0, 128 * 12),      # roomy budget
    (512, 160, 96, 1, 128 * 16),     # non-square grid, partial tiles
])
def test_fields_integer_exact(P, W, H, seed, max_pairs):
    arrs = numpy_prep(P, W, H, seed)
    jb, tb = bin_both(arrs, W, H, max_pairs)
    assert not bool(jb.overflow)
    for name in FIELDS:
        want = np.asarray(getattr(jb, name))
        got = getattr(tb, name).numpy()
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_overflow_case_integer_exact():
    """A budget below the demand drops a suffix of the raw stream: the
    overflow flag, num_pairs and every layout field still match."""
    arrs = numpy_prep(300, 64, 64, 2)
    demand = int(arrs["tiles_touched"].sum())
    max_pairs = 128
    assert demand > max_pairs
    jb, tb = bin_both(arrs, 64, 64, max_pairs)
    assert bool(jb.overflow) and bool(tb.overflow)
    assert int(tb.num_pairs) == max_pairs
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), err_msg=name)
