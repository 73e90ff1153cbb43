"""Device ms a training step spends in the backward of everything (the
``torch.autograd.grad`` call: losses, B2, B4, the preprocess and the
heads): the span ``backward``, over the traced steps."""

from benchmark.program_spans import device_ms


def read(rec: dict):
    return device_ms(rec, "train", names=("backward",))
