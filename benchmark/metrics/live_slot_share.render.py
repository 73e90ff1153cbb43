"""The share of decoded Gaussian slots that the selection keeps in a
rendered frame: 100 * the counter ``scaffold.selected`` over
``scaffold.slots`` across the traced frames, in percent."""

from benchmark.program_spans import share


def read(rec: dict):
    return share(rec, "render", "scaffold.selected", "scaffold.slots")
