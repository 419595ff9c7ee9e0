"""Multi-pod dry run of the training cells — the port's counterpart of
``repro.launch.dryrun``: per (architecture × shape) cell, whether the
port's own training step fits the production mesh and which roofline term
bounds it, before any card time is spent.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --shape train_4k \
        --mesh both

No card and no JAX: ``run_cell`` starts a ``fake`` process group of the
mesh's 256 (``single``, (16, 16)) or 512 (``multi``, (2, 16, 16)) ranks,
builds ``Trainer(mesh=)`` on ``make_production_mesh`` (``build_cell``)
and traces one step of rank 0 on ``meta`` tensors
(``launch/cost_analysis.py``): FLOPs, HBM bytes, collective bytes and
per-device memory of the very code the trainer runs live.  Records land
in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``, beside the
reference's ``experiments/dryrun/``.

Only the training cells have a sharded step in the port: a prefill or
decode cell gets ``status: "not_ported"`` (ROADMAP Queue A, the sharded
serving step), an inapplicable cell ``skipped`` as the reference's does.

Also the arithmetic the reference's fit criterion and roofline read, each
held equal to the reference's: ``_model_flops``, ``_accum_steps``
(micro-batches a step) and ``_analytic_memory`` (the per-device residency
model).  A mesh is anything with ``shape`` (axis → size) and
``axis_names``: ``launch.mesh.Mesh``, live or abstract.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any

import torch

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..models.config import ArchConfig, ShapeConfig
from ..models.model import Model
from ..obs.log import get_logger
from .cost_analysis import fake_world, peak_bytes, trace_step
from .mesh import make_production_mesh
from .train import Trainer

log = get_logger("dryrun")

# H100 SXM5 80GB (700 W) datasheet constants, the roofline's denominators
# (per card): bf16 dense tensor-core peak; HBM3 bandwidth; and the link a
# collective of the production mesh crosses.  Each 16-wide axis spans two
# 8-card NVLink nodes, so a ring over it takes the inter-node hop: one
# 400 Gb/s InfiniBand NDR port per card, 50e9 bytes/s each way (NVLink 4
# inside a node gives 450e9 each way).
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 50e9
HBM_BYTES = 80 * 2 ** 30

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")

NOT_PORTED = ("the port has no sharded {kind} step: Model.prefill and "
              "decode_step run on one device (ROADMAP Queue A item 12.8, "
              "the sharded prefill and decode step)")


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


def _model_for(cfg: ArchConfig, shape: ShapeConfig) -> Model:
    """The reference's settings: bf16, query chunks of 1024 (the sequence
    below that), SSD chunks of 128, loss chunks of min(1024, S), remat;
    on the torch engine, on the dry run's ``meta`` device."""
    q_chunk = 1024 if shape.seq_len >= 1024 else shape.seq_len
    return Model(cfg, torch.bfloat16, q_chunk=q_chunk, ssd_chunk=128,
                 loss_chunk=min(1024, shape.seq_len), remat=True,
                 backend="torch", device="meta")


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               opt_state_dtype: str = "auto", grad_dtype: str = "f32",
               kv_quant: bool = False):
    """(the cell's ``Trainer`` on ``mesh``, a live mesh of a fake world,
    with no state yet; ``{"opt_state_dtype", "accum_steps"}``).  Its plan
    is ``Trainer(mesh=)``'s: ``tree_shardings`` of params and Adam state,
    the global batch split by ``data_spec``, ``_accum_steps``
    micro-batches; Adam's moments int8 above 40e9 parameters; the model
    settings of ``_model_for`` (the trainer's SSD chunk, min(128, S), is
    its 128 at every training length).  Only ``grad_dtype="f32"`` (the
    trainer's) is taken; ``kv_quant`` concerns
    decode cells, which the port does not build."""
    if shape.kind != "train":
        raise ValueError(NOT_PORTED.format(kind=shape.kind))
    if grad_dtype != "f32":
        raise ValueError(f"grad_dtype {grad_dtype!r}: the trainer sums f32 "
                         f"gradients")
    if opt_state_dtype == "auto":
        opt_state_dtype = "int8" if cfg.param_count() > 40e9 else "f32"
    accum = _accum_steps(cfg, shape, mesh)
    model = _model_for(cfg, shape)
    trainer = Trainer(cfg, batch=shape.global_batch, seq_len=shape.seq_len,
                      mesh=mesh, opt_state=opt_state_dtype,
                      accum_steps=accum, device="meta",
                      compute_dtype=model.compute_dtype, remat=model.remat,
                      q_chunk=model.q_chunk, loss_chunk=model.loss_chunk)
    return trainer, {"opt_state_dtype": opt_state_dtype,
                     "accum_steps": accum}


def balanced_routing(cfg: ArchConfig):
    """``cost_analysis.trace_step``'s ``nonzero_rows``: an expert takes
    1/E of its (token, choice) pairs, the load the aux loss drives to (no
    pair past capacity is dropped at a capacity factor ≥ 1)."""
    return lambda mask: mask.numel() // max(cfg.n_experts, 1)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             save: bool = True, kv_quant: bool = False) -> dict:
    """The reference's record, key for key, but:

      * ``lower_s`` and ``compile_s`` are one ``trace_s``, the seconds to
        build the cell and trace its step;
      * ``xla_cost_analysis`` is absent (no XLA);
      * ``memory`` holds ``argument_size_in_bytes``,
        ``output_size_in_bytes`` and ``temp_size_in_bytes`` of the traced
        step (no generated code), and ``argument_parts`` (params,
        optimizer, residuals, inputs); ``fits_80gib`` is the fit
        criterion, arguments plus temporaries ≤ the card's 80 GiB;
      * ``hlo_flops`` and ``hlo_bytes`` are the traced step's FLOPs and
        unfused HBM bytes; ``collectives`` counts by the port's kinds;
      * ``roofline`` divides by the H100 constants above, not the TPU
        v5e's;
      * a prefill or decode cell is ``not_ported``, with its ``reason``.
    """
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    rec: dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "timestamp": time.time(),
    }
    if kv_quant:
        rec["kv_quant"] = True
        rec["mesh"] = mesh_kind + "__kvq8"   # separate artifact name
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
    elif shape.kind != "train":
        rec["status"] = "not_ported"
        rec["reason"] = NOT_PORTED.format(kind=shape.kind)
    else:
        multi = mesh_kind == "multi"
        n_chips = 512 if multi else 256
        try:
            t0 = time.perf_counter()
            with fake_world(n_chips):
                mesh = make_production_mesh(multi_pod=multi, device="meta")
                trainer, extra = build_cell(cfg, shape, mesh,
                                            kv_quant=kv_quant)
                tr = trace_step(trainer, balanced_routing(cfg))
            coll = tr.cost.collectives
            flops, bytes_hbm = tr.cost.flops, tr.cost.bytes_hbm
            rec.update({
                "status": "ok",
                "n_chips": n_chips,
                "trace_s": round(time.perf_counter() - t0, 2),
                "memory": tr.memory,
                "fits_80gib": peak_bytes(tr.memory) <= HBM_BYTES,
                "analytic_memory": _analytic_memory(
                    cfg, shape, mesh, extra["accum_steps"],
                    extra["opt_state_dtype"]),
                "hlo_flops": flops,
                "hlo_bytes": bytes_hbm,
                "collectives": {
                    "total_bytes": coll.total_bytes,
                    "link_bytes": coll.link_bytes,
                    "per_op": dict(coll.per_op),
                    "counts": dict(coll.counts),
                },
                **extra,
            })
            rec["roofline"] = {
                "compute_s": flops / PEAK_FLOPS,
                "memory_s": bytes_hbm / HBM_BW,
                "collective_s": coll.link_bytes / LINK_BW,
            }
            dom = max(rec["roofline"], key=rec["roofline"].get)
            rec["roofline"]["dominant"] = dom
            model_flops = _model_flops(cfg, shape)
            rec["model_flops_global"] = model_flops
            rec["model_flops_per_chip"] = model_flops / n_chips
            if flops > 0:
                rec["useful_flop_ratio"] = (model_flops / n_chips) / flops
        except Exception as e:  # noqa: BLE001 — recorded, the sweep goes on
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-4000:]
    if save:
        _save(rec)
    return rec


def _save(rec: dict) -> None:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    fn = os.path.join(
        RESULTS_DIR, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(fn, "w") as f:
        json.dump(rec, f, indent=1, default=float)


def main(argv=None) -> list[dict]:
    """The cells the flags name, one record each (returned, and saved);
    one log line per cell."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache for decode cells (not ported: "
                         "the records say so)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    records = []
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                out = os.path.join(
                    RESULTS_DIR, f"{arch}__{shape}__{mk}.json")
                if args.skip_existing and os.path.exists(out):
                    log.info("skip_existing", arch=arch, shape=shape,
                             mesh=mk)
                    continue
                t0 = time.time()
                rec = run_cell(arch, shape, mk, kv_quant=args.kv_quant)
                records.append(rec)
                status = rec["status"]
                fields = dict(arch=arch, shape=shape, mesh=mk,
                              wall_s=time.time() - t0)
                if status == "ok":
                    r = rec["roofline"]
                    fields.update(dominant=r["dominant"],
                                  compute_ms=r["compute_s"] * 1e3,
                                  memory_ms=r["memory_s"] * 1e3,
                                  collective_ms=r["collective_s"] * 1e3,
                                  peak_gib=peak_bytes(rec["memory"])
                                  / 2 ** 30,
                                  fits_80gib=rec["fits_80gib"],
                                  trace_s=rec["trace_s"])
                    log.info("cell_ok", **fields)
                elif status == "error":
                    log.error("cell_error", error=rec["error"][:120],
                              **fields)
                else:
                    log.info(f"cell_{status}", **fields)
    return records


if __name__ == "__main__":
    main()
