"""Device ms a training step spends in Adam and the anchor statistics:
the spans ``adam`` and ``stats``, over the traced steps."""

from benchmark.program_spans import device_ms


def read(rec: dict):
    return device_ms(rec, "train", names=("adam", "stats"))
