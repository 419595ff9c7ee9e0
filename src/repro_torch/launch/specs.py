"""Input shapes of the model's step functions — ``repro.launch.specs``.
``input_specs`` gives meta tensors (shape and dtype, no storage) for every
(arch × shape) cell; the speech frontend of the encdec family is a stub:
its encoder reads precomputed frame embeddings."""
from __future__ import annotations

import torch

from ..models.config import ArchConfig, ShapeConfig


def enc_len(cfg: ArchConfig, seq_len: int) -> int:
    """Stub audio frontend: ~4× downsampled frames, capped."""
    return min(max(seq_len // 4, 16), 8192)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Inputs of the cell's step function, as meta tensors:

    train   : {tokens (B, S) int32 [, enc_embeds (B, Se, D) f32]}
    prefill : the same as train
    decode  : {tokens (B, 1) int32}  (the KV/SSM cache is threaded state)
    """
    B, S = shape.global_batch, shape.seq_len
    specs: dict = {"tokens": torch.empty(
        (B, 1) if shape.kind == "decode" else (B, S), dtype=torch.int32,
        device="meta")}
    if cfg.family == "encdec" and shape.kind != "decode":
        specs["enc_embeds"] = torch.empty((B, enc_len(cfg, S), cfg.d_model),
                                          dtype=torch.float32, device="meta")
    return specs
