"""The model-FLOPs accounting of ``repro.launch.dryrun``.

The reference's dry run lowers every (arch × shape) cell to XLA HLO for a
256-chip TPU mesh and reads its roofline from the compiled text
(``build_cell``, ``run_cell``, ``launch/hlo_analysis.py``); nothing in
torch lowers to HLO, so the port keeps the arithmetic over a config, a
shape and a mesh's shape: ``_model_flops``, which turns a step's time into
a share of the card's peak, ``_accum_steps`` (micro-batches a step) and
``_analytic_memory`` (the per-device residency model the reference's fit
criterion reads), each held equal to the reference's.  A mesh is anything
with ``shape`` (axis → size) and ``axis_names``: ``launch.mesh.Mesh``,
live or abstract.
"""
from __future__ import annotations

import math

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


def _accum_steps(cfg: ArchConfig, shape: ShapeConfig, mesh) -> int:
    """Micro-batches per step: keep a device's live activations inside
    HBM.  Rough model: stored residual carries + remat working set ≈
    B/device/accum × S × d_model × 2 B × (n_layers + 24).  Target ≤ ~6 GB,
    leaving room for weight shards, gradients and optimizer state."""
    n_data = math.prod(mesh.shape[a] for a in mesh.axis_names
                       if a in ("pod", "data"))
    n_model = mesh.shape.get("model", 1)
    b_chip = max(shape.global_batch // n_data, 1)
    seq_shard = shape.seq_len // n_model if shape.seq_len % n_model == 0 \
        else shape.seq_len
    act_bytes = (b_chip * seq_shard * cfg.d_model * 2
                 * (cfg.n_layers + 24))
    accum = 1
    while act_bytes / accum > 6e9 and accum < b_chip:
        accum *= 2
    return accum


def _analytic_memory(cfg: ArchConfig, shape: ShapeConfig, mesh,
                     accum: int, opt_state_dtype: str) -> dict:
    """Per-device residency model, in bytes:

      params      — f32 masters (train) / bf16 (serve), fully sharded
      optimizer   — Adam m+v (f32: 8 B/param; int8: ~2.06 B/param)
      grads       — f32, sharded like params (train only)
      act_carries — stored residual stream per layer (bf16, seq-sharded)
      working     — 2× double-buffered per-layer gathered weights (bf16)
                    + the flash attention live window
      kv_cache    — decode cells: bf16 cache as the state specs shard it
    """
    n_chips = math.prod(mesh.shape.values())
    n_model = mesh.shape.get("model", 1)
    n_data = n_chips // n_model
    P = cfg.param_count()
    train = shape.kind == "train"
    b_chip = max(shape.global_batch // n_data, 1)
    seq_shard = (shape.seq_len // n_model
                 if shape.seq_len % n_model == 0 else shape.seq_len)

    out = {}
    out["params"] = P * (4 if train else 2) / n_chips
    out["optimizer"] = (P * (2.06 if opt_state_dtype == "int8" else 8)
                        / n_chips) if train else 0.0
    out["grads"] = P * 4 / n_chips if train else 0.0
    if shape.kind == "decode":
        na = sum(1 for layer in range(cfg.n_layers)
                 if cfg.is_attn_layer(layer))
        kv = (2 * na * shape.global_batch * shape.seq_len
              * cfg.n_kv * cfg.head_dim * 2)
        ssm_layers = cfg.n_layers - na
        ssm = (ssm_layers * shape.global_batch
               * cfg.d_inner * max(cfg.ssm_state, 1) * 4) if ssm_layers else 0
        # the cache's sharding as distributed.sharding.decode_state_specs
        # places it: batch over the data axes; kv heads over "model" when
        # they divide it, else head_dim
        b_div = n_data if shape.global_batch % n_data == 0 else 1
        m_div = n_model if (cfg.n_kv % n_model == 0
                            or cfg.head_dim % n_model == 0) else 1
        out["kv_cache"] = kv / (b_div * m_div) + ssm / b_div
        out["act_carries"] = 0.0
    else:
        mb = max(b_chip // accum, 1)
        out["kv_cache"] = 0.0
        out["act_carries"] = mb * seq_shard * cfg.d_model * 2 * cfg.n_layers
        qc = min(1024, shape.seq_len)
        flash = 3 * b_chip / max(accum, 1) * max(cfg.n_heads // n_model, 1) \
            * qc * qc * 4
        out["working"] = 2 * (P / max(cfg.n_layers, 1) / n_model) * 2 + flash
    out.setdefault("working", 2 * (P / max(cfg.n_layers, 1) / n_model) * 2)
    out["total"] = float(sum(out.values()))
    out["fits_16gb"] = bool(out["total"] < 16e9)
    return {k: (round(v, 1) if isinstance(v, float) else v)
            for k, v in out.items()}
