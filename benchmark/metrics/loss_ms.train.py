"""Device ms a training step spends in the camera loss (L1, SSIM and the
regularisers, forward only): the span ``loss``, over the traced steps."""

from benchmark.program_spans import device_ms


def read(rec: dict):
    return device_ms(rec, "train", names=("loss",))
