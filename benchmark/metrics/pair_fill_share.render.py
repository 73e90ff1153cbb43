"""The share of the pair budget that a rendered frame's pairs fill: 100 *
the counter ``raster.pairs`` over ``raster.budget`` (the ``max_pairs``
each binning ran at, a re-render's included) across the traced frames, in
percent. None for a program without the ``raster.budget`` counter."""

from benchmark.program_spans import share


def read(rec: dict):
    return share(rec, "render", "raster.pairs", "raster.budget")
