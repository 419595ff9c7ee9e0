"""Input shapes of the model's step functions — the part of
``repro.launch.specs`` the trainer uses.  ``input_specs`` (the dry run's
stand-ins) waits for ROADMAP Queue A 12.6."""
from __future__ import annotations

from ..models.config import ArchConfig


def enc_len(cfg: ArchConfig, seq_len: int) -> int:
    """Stub audio frontend: ~4× downsampled frames, capped."""
    return min(max(seq_len // 4, 16), 8192)
