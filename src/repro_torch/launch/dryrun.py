"""The model-FLOPs accounting of ``repro.launch.dryrun``.

The reference's dry run lowers every (arch × shape) cell to XLA HLO for a
256-chip TPU mesh and reads its roofline from the compiled text
(``build_cell``, ``run_cell``, ``launch/hlo_analysis.py``); nothing in
torch lowers to HLO, so the port keeps only ``_model_flops``, which turns
a step's time into a share of the card's peak.
"""
from __future__ import annotations

from ..models.config import ArchConfig, ShapeConfig


def _model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6·N_active·D for train (fwd+bwd), 2·N_active·D for
    inference.  D = processed tokens."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n_active * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n_active * toks
    return 2.0 * n_active * shape.global_batch   # decode: 1 token / seq
