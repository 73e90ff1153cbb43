"""Device ms a training step spends in the scaffold decode: the spans
``scaffold.prefilter`` (the anchors' EWA prefilter) and ``scaffold.decode``
(the MLP heads over every slot and the selection mask), each the CUDA-event
wall around its launches, idle inside it included, over the traced steps."""

from benchmark.program_spans import device_ms


def read(rec: dict):
    return device_ms(rec, "train", names=("scaffold.prefilter", "scaffold.decode"))
