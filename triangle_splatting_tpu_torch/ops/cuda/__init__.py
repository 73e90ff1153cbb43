"""Hand-written CUDA kernels of the tile pipeline (``csrc/``), their
``ctypes`` wrappers and the plain PyTorch version beside each kernel.

Each wrapper counts the launches of its kernel in ``<wrapper>.launches``:
a dict by form for the blend kernels (the variant ``"2D"``, ``"3D"`` or
``"GS"``, then ``"_rich"`` with rich info and, for the forward,
``"_stats"`` with the contribution stream), an int for the stream
kernels. ``reset_launches`` and ``launch_counts`` read and reset them all
in one form."""


def _counters() -> dict:
    from . import blend, streams
    return {"blend_forward": blend.blend_forward,
            "blend_backward": blend.blend_backward,
            "relayout_pairs": streams.relayout_pairs,
            "segment_reduce_pairs": streams.segment_reduce_pairs,
            "segment_reduce_stats": streams.segment_reduce_stats}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in _counters().values():
        fn.launches = dict.fromkeys(fn.launches, 0) if isinstance(fn.launches, dict) else 0


def launch_counts() -> dict[tuple[str, str | None], int]:
    """Launches by (kernel, form); the form is None for kernels that have
    one form only."""
    out = {}
    for name, fn in _counters().items():
        if isinstance(fn.launches, dict):
            out.update({(name, v): n for v, n in fn.launches.items()})
        else:
            out[(name, None)] = fn.launches
    return out
