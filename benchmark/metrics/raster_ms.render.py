"""Device ms a rendered frame spends in the rasterizer: the spans
``raster.preprocess``, ``raster.binning`` and ``raster.blend`` (and
``raster.stats`` where it runs), over the traced frames."""

from benchmark.program_spans import device_ms


def read(rec: dict):
    return device_ms(rec, "render", prefix="raster.")
