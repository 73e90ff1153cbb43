"""Device ms a training step spends in the rasterizer's forward: the spans
``raster.preprocess`` (EWA preprocess and field matrix), ``raster.binning``
(sort and B3), ``raster.blend`` (the pack and B1) and ``raster.stats``,
each the CUDA-event wall around its launches, over the traced steps. The
backward of these stages runs inside ``backward``."""

from benchmark.program_spans import device_ms


def read(rec: dict):
    return device_ms(rec, "train", prefix="raster.")
