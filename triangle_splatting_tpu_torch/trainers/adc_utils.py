"""ADC cadence helpers (port of ``triangle_splatting_tpu/trainers/adc_utils.py``;
this slice needs only the pair-budget adaptation)."""

from __future__ import annotations


def adapt_pair_budget(ppt: float, used: int | None, count: int,
                      overflow: bool, *, max_ppt: float = 32.0,
                      margin: float = 1.3,
                      shrink_if_below: float = 0.5) -> float:
    """Need-based pair-budget adaptation shared by the trainer and benches.

    The pair buffer has a fixed budget per frame, re-quantized with
    hysteresis exactly as the JAX package does: grow 2x on overflow, and
    shrink directly to ``margin`` x the measured per-primitive need when
    that frees at least ``1 - shrink_if_below`` of the buffer (eighth
    steps). Pass ``used=None`` when the measured pair count is unknown:
    adaptation is then grow-only.

    Returns the new pairs-per-primitive budget (may equal ``ppt``).
    """
    if overflow:
        return min(ppt * 2.0, max_ppt)
    if used is None:
        return ppt
    need = margin * float(used) / max(count, 1)
    new = max(2.0, round(need * 8.0) / 8.0)   # eighth steps
    if new < ppt * shrink_if_below:
        return new
    return ppt
