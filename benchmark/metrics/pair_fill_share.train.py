"""The share of the pair budget that a training step's pairs fill: 100 *
the counter ``raster.pairs`` over ``raster.budget`` (the ``max_pairs`` the
trainer bins at) across the traced steps, in percent. None for a program
without the ``raster.budget`` counter."""

from benchmark.program_spans import share


def read(rec: dict):
    return share(rec, "train", "raster.pairs", "raster.budget")
