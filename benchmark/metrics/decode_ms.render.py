"""Device ms a rendered frame spends in the scaffold decode: the spans
``scaffold.prefilter`` and ``scaffold.decode``, each the CUDA-event wall
around its launches, over the traced frames."""

from benchmark.program_spans import device_ms


def read(rec: dict):
    return device_ms(rec, "render", names=("scaffold.prefilter", "scaffold.decode"))
