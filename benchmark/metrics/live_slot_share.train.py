"""The share of decoded Gaussian slots that the selection keeps (opacity
over the threshold, visible and alive anchor): 100 * the counter
``scaffold.selected`` over ``scaffold.slots`` (capacity * offsets a step)
across the traced steps, in percent."""

from benchmark.program_spans import share


def read(rec: dict):
    return share(rec, "train", "scaffold.selected", "scaffold.slots")
