"""Batch bucketing — the one piece of ``repro.core.engine_select`` this
slice needs (the autotuner itself is ported later)."""
from __future__ import annotations


def bucket_batch(batch: int) -> int:
    """Next power of two — one decision (and one padded shape) per batch
    octave."""
    return 1 << max(int(batch) - 1, 0).bit_length()
