"""The share of a rendered frame in which no operation runs on the
device: 1 - (the union of the kernel, copy and memset intervals a
profiled frame) / (the wall time of a frame in the unprofiled window), in
percent. The profiler slows the host, so its own window's wall would count
its overhead as idle; the run's ``device`` keeps that profiled window."""


def read(rec: dict):
    if rec.get("kind") != "render" or not rec.get("traced_frames") or not rec.get("frames") \
            or not rec.get("wall_s"):
        return None
    busy = rec["trace"]["busy_s"] / rec["traced_frames"]
    return 100.0 * (1.0 - busy / (rec["wall_s"] / rec["frames"]))
