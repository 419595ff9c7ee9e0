"""The training launcher — the port's counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
        --reduced --steps 200 --batch 8 --seq-len 256 --ckpt-dir DIR

Runs on the card unless ``--device cpu`` asks for the CPU.  What it keeps
of the reference:

  * checkpoint/restart: atomic checkpoints on the reference's layout
    (``distributed/checkpoint.py``), resume from ``LATEST``;
  * the straggler watchdog: a trailing-median step deadline, a heartbeat
    file, offenders flagged in the records;
  * preemption: SIGTERM checkpoints, then stops;
  * int8 error-feedback gradient compression (``--compress-grads``) and
    int8 Adam moments (``--opt-state int8``);
  * deterministic data: (seed, step)-keyed synthetic batches, so a restart
    replays the exact token stream.

The model trains on ``backend="torch"`` (the chunked flash in torch): the
reference's training path reaches no Pallas kernel, and the card's flash
kernel has no backward pass.

``Trainer(mesh=)`` trains data parallel over the mesh's data axes ("pod"
× "data"), one rank a replica (``launch/mesh.py``, ``launch/cluster.py``):
the rank takes its rows of the global batch as ``data_spec`` splits dim
0, computes its gradient, and one coalesced f32 all-reduce gives every
rank the replicas' mean; then the codec, the grad norm and Adam run on
that global gradient, as on one device (the reference's GSPMD step
computes its compression on the global gradient too).  Params and Adam
state are replicated; ``p_shards``/``o_shards`` hold the placements the
sharding rules give them.  A "model" axis larger than 1 (tensor
parallelism) and FSDP storage are ROADMAP Queue A 12.7.  Rank 0 writes
checkpoints, every rank reads them, so a run restores onto another
number of replicas (``plan_elastic_restart``).  The launcher joins a
process group when REPRO_MULTIHOST=1 (``launch/cluster.py``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import signal
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_config
from ..core.registry import resolve_device
from ..data.tokens import SyntheticTokens, TokenPipelineConfig
from ..distributed import checkpoint as ckpt
from ..distributed.compression import compress_tree, init_residuals
from ..distributed.fault_tolerance import (Heartbeat, PreemptionFlag,
                                           StragglerDetector)
from ..distributed.optimizer import Adam, AdamConfig
from ..distributed.sharding import data_spec, fsdp_axes, tree_shardings
from ..models.attention import waits
from ..models.model import Model, tree_flatten, tree_map, tree_unflatten
from ..obs.log import get_logger
from .cluster import initialize_from_env, multihost_requested
from .mesh import Mesh, make_debug_mesh, make_production_mesh
from .specs import enc_len

log = get_logger("train")

# the all-reduce buffer starts each gradient leaf at a multiple of this
# many f32s (512 bytes, the caching allocator's alignment), so the reduced
# leaves are views that reductions read as they read a fresh tensor
ALIGN = 128


@contextlib.contextmanager
def reproducible(device: torch.device):
    """Deterministic kernels for the body on a CUDA device, the process's
    settings restored on exit: the same state and batch give the same
    bits, and an op with no deterministic kernel raises.  The NaN fill of
    fresh allocations that the deterministic mode also turns on (a check
    for kernels that read memory they never wrote) stays off: it cost
    11-18% of a full-width step, the deterministic kernels ~0 (PERF.md
    §6).  A no-op on the CPU, whose kernels are deterministic."""
    if device.type != "cuda":
        yield
        return
    det = torch.utils.deterministic
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        det.fill_uninitialized_memory = was[2]


# --------------------------------------------------------------------------- #
# Trainer
# --------------------------------------------------------------------------- #
class Trainer:
    """Owns the step, the state tree and the fault-tolerance hooks; a class
    so tests can drive the loop step by step.

    The state is the reference's: f32 master params, Adam's ``{"m", "v",
    "step"}`` and the compression residuals (a 0-d zero per leaf without
    compression), trees of dicts in ``jax.tree.flatten``'s order, so
    ``save`` and ``restore`` cross with the reference's checkpoints.
    ``compute_dtype`` (the port's own) is the model's: bf16, as the
    reference's trainer computes; f32 for parity checks.  ``param_dtype``
    is the dtype the reference plans its sharding for; on one device it
    changes nothing (the masters are f32).

    ``mesh``: ``None`` trains on ``device`` alone.  A live ``Mesh`` whose
    "model" axis is 1 trains data parallel over its ranks on the mesh's
    device: ``batch`` is the global batch, ``accum_steps`` splits each
    rank's rows."""

    def __init__(self, cfg, *, batch: int, seq_len: int, mesh=None,
                 lr: float = 3e-4, opt_state: str = "f32",
                 compress_grads: bool = False, remat: bool = True,
                 seed: int = 0, param_dtype=torch.float32,
                 accum_steps: int = 1, compute_dtype=torch.bfloat16,
                 device=None):
        self.mesh = _data_parallel_mesh(mesh)
        # gradient accumulation: the global batch is invariant in
        # accum_steps (an elastic restart on fewer hosts raises it)
        if accum_steps < 1 or batch % accum_steps:
            raise ValueError(f"batch {batch} is not a multiple of "
                             f"accum_steps {accum_steps}")
        if self.mesh is not None and device is None:
            device = self.mesh.device
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.compress_grads = compress_grads
        self.accum_steps = accum_steps
        self.param_dtype = param_dtype
        self.device = resolve_device(device)
        self.model = Model(cfg, compute_dtype, q_chunk=min(512, seq_len),
                           ssd_chunk=min(128, seq_len),
                           loss_chunk=min(512, seq_len), remat=remat,
                           backend="torch", device=self.device)
        self.opt = Adam(AdamConfig(lr=lr, state_dtype=opt_state))
        self.pipeline = SyntheticTokens(TokenPipelineConfig(
            vocab=cfg.vocab, seq_len=seq_len, global_batch=batch, seed=seed))
        self._needs_enc = cfg.family == "encdec"
        self.params = None
        self.opt_state = None
        self.residuals = None
        self.step = 0
        self.rank, self.replicas = 0, 1
        self.p_shards = self.o_shards = self.tok_spec = None
        self.comm: dict = {}
        if self.mesh is not None:
            self._plan_mesh()

    def _plan_mesh(self) -> None:
        """The reference's sharding plan on the mesh, recorded; this rank's
        rows of the global batch; the group of the replicas."""
        mesh = self.mesh
        if mesh.device.type != self.device.type:
            raise ValueError(f"the mesh runs on {mesh.device}, the trainer "
                             f"on {self.device}")
        logical = self.model.param_logical_specs()
        p_shapes = self.model.param_shapes(self.param_dtype)
        self.p_shards = tree_shardings(p_shapes, logical, mesh)
        self.o_shards = tree_shardings(
            self.opt.init(p_shapes), self.opt.state_logical_specs(logical),
            mesh)
        self.tok_spec = data_spec(mesh, 2, self.batch)
        self._group = mesh.group(fsdp_axes(mesh) or mesh.axis_names)
        self.rank, self.replicas = dist.get_rank(), mesh.size
        split = self.tok_spec[0] or ()
        split = (split,) if isinstance(split, str) else split
        self.rows_per_rank = self.batch // math.prod(mesh.shape[a]
                                                     for a in split)
        self._first_row = (mesh.coordinate(split) if split else 0) \
            * self.rows_per_rank
        if self.rows_per_rank % self.accum_steps:
            raise ValueError(f"{self.rows_per_rank} rows a replica are not "
                             f"a multiple of accum_steps {self.accum_steps}")

    def init_state(self, seed: int = 0) -> None:
        """Fresh f32 masters (torch's seeded draws, not ``jax.random``'s),
        zero moments and residuals, step 0.  On a mesh every rank then
        takes rank 0's masters."""
        self.params = self.model.init_params(seed, torch.float32)
        if self.mesh is not None:
            src = dist.get_global_rank(self._group, 0)
            for p in tree_flatten(self.params)[0]:
                dist.broadcast(p, src=src, group=self._group)
        self.opt_state = self.opt.init(self.params)
        if self.compress_grads:
            self.residuals = init_residuals(self.params)
        else:
            self.residuals = tree_map(
                lambda p: torch.zeros((), dtype=torch.float32,
                                      device=p.device), self.params)
        self.step = 0

    # --------------------------------------------------------- checkpoint
    def state_tree(self) -> dict:
        return {"params": self.params, "opt": self.opt_state,
                "residuals": self.residuals}

    def save(self, path: str) -> str:
        """Write the state as step ``self.step``.  On a mesh rank 0 writes
        (the state is replicated) and every rank waits for it."""
        if self.rank == 0:
            out = ckpt.save(path, self.step, self.state_tree())
        else:
            out = os.path.join(path, f"step_{self.step:08d}")
        if self.mesh is not None:
            dist.barrier(group=self._group)
        return out

    def restore(self, path: str, step: Optional[int] = None) -> int:
        """Load a checkpoint (of either package) onto this trainer's
        device; the target tree is this trainer's own state.  On a mesh
        every rank reads it."""
        if self.params is None:
            self.init_state()
        tree, got = ckpt.restore(path, self.state_tree(), step=step,
                                 device=self.device)
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.residuals = tree["residuals"]
        self.step = got
        return got

    # --------------------------------------------------------------- step
    def _value_and_grad(self, tokens, enc=None):
        """(loss, grads) of ``loss_fn`` at the current params: grads a tree
        of the params' shape, zeros where no path reaches a leaf."""
        leaves, treedef = tree_flatten(self.params)
        req = [p.detach().requires_grad_(True) for p in leaves]
        loss = self.model.loss_fn(tree_unflatten(treedef, req), tokens, enc)
        grads = torch.autograd.grad(loss, req, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), tree_unflatten(treedef, list(grads))

    def _grads(self, tokens, enc=None):
        """The step's (loss, grads): one pass, or the mean over
        ``accum_steps`` micro-batches summed in f32."""
        accum = self.accum_steps
        if accum == 1:
            return self._value_and_grad(tokens, enc)
        b = tokens.shape[0] // accum
        flat, treedef = tree_flatten(self.params)
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in flat]
        for i in range(accum):
            rows = slice(i * b, (i + 1) * b)
            l, g = self._value_and_grad(
                tokens[rows], None if enc is None else enc[rows])
            loss = loss + l
            acc = [a + c.float() for a, c in zip(acc, tree_flatten(g)[0])]
        inv = 1.0 / accum
        return loss * inv, tree_unflatten(treedef, [a * inv for a in acc])

    def batch_inputs(self, step: int):
        """Step ``step``'s tokens (B, S) and, for encdec, its encoder frames
        (B, enc_len, D) from ``default_rng((17, step))``, on the device."""
        tokens = torch.as_tensor(self.pipeline.batch(step),
                                 device=self.device)
        if not self._needs_enc:
            return tokens, None
        rng = np.random.default_rng((17, step))
        Se = enc_len(self.cfg, self.seq_len)
        enc = rng.normal(0, 1, size=(self.batch, Se, self.cfg.d_model)) \
            .astype(np.float32)
        return tokens, torch.as_tensor(enc, device=self.device)

    def _mark(self, marks: list) -> None:
        """A point in the step's time: a CUDA event on the card, the host
        clock on the CPU (where the collectives are synchronous)."""
        if self.device.type == "cuda":
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())

    def _all_reduce(self, loss, grads):
        """The replicas' mean of the f32 gradients and the loss: one
        coalesced all-reduce (SUM, then ÷ replicas) of a buffer holding
        every leaf (at ``ALIGN``ed offsets) and the loss last; the reduced
        leaves are views of it.  ``self.comm`` gets its bytes and the
        marks around the copy in, the all-reduce and the division."""
        flat, treedef = tree_flatten(grads)
        marks: list = []
        self._mark(marks)
        pad = torch.zeros(ALIGN, dtype=torch.float32, device=self.device)
        parts, offsets, at = [], [], 0
        for g in flat:
            parts.append(g.reshape(-1).float())
            gap = -g.numel() % ALIGN
            if gap:
                parts.append(pad[:gap])
            offsets.append(at)
            at += g.numel() + gap
        parts.append(loss.reshape(1).float())
        buf = torch.cat(parts)
        del parts
        self._mark(marks)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self._group)
        self._mark(marks)
        buf.div_(self.replicas)
        self._mark(marks)
        self.comm = {"all_reduce_bytes": buf.numel() * buf.element_size(),
                     "grad_bytes": 4 * sum(g.numel() for g in flat),
                     "marks": marks}
        out = [buf[o:o + g.numel()].view(g.shape)
               for o, g in zip(offsets, flat)]
        return buf[-1], tree_unflatten(treedef, out)

    def _comm_record(self) -> dict:
        """The last all-reduce's bytes and the ms of the copy into its
        buffer, of the collective and of the division (CUDA events on the
        card, read once the step has synchronised)."""
        m = self.comm["marks"]
        if self.device.type == "cuda":
            ms = [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        else:
            ms = [(b - a) * 1e3 for a, b in zip(m, m[1:])]
        return {"pack_ms": ms[0], "all_reduce_ms": ms[1],
                "scale_ms": ms[2],
                "all_reduce_bytes": self.comm["all_reduce_bytes"],
                "grad_bytes": self.comm["grad_bytes"],
                "replicas": self.replicas}

    def any_rank(self, flag: bool) -> bool:
        """``flag`` as any replica holds it (itself without a mesh)."""
        if self.mesh is None:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._group)
        return bool(t.item())

    def train_step(self) -> dict:
        """Loss and grads (on a mesh: of this rank's rows, then the
        replicas' mean), then the int8 codec if asked, the f32 grad norm
        of what Adam sees, and Adam's update: {"step", "loss",
        "grad_norm"}, and on a mesh the all-reduce's ms and bytes."""
        tokens, enc = self.batch_inputs(self.step)
        if self.mesh is not None:
            rows = slice(self._first_row, self._first_row + self.rows_per_rank)
            tokens, enc = tokens[rows], None if enc is None else enc[rows]
        with reproducible(self.device):
            loss, grads = self._grads(tokens, enc)
            if self.mesh is not None:
                loss, grads = self._all_reduce(loss, grads)
            if self.compress_grads:
                grads, self.residuals = compress_tree(grads, self.residuals)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in tree_flatten(grads)[0]))
            self.params, self.opt_state = self.opt.update(
                grads, self.opt_state, self.params)
        self.step += 1
        rec = {"step": self.step, "loss": float(loss),
               "grad_norm": float(gnorm)}
        if self.mesh is not None:
            rec.update(self._comm_record())
        return rec


def _data_parallel_mesh(mesh):
    """``mesh`` if the trainer can run on it: a live mesh of data axes and
    a "model" axis of 1."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a launch.mesh.Mesh, not "
                        f"{type(mesh).__name__}")
    other = set(mesh.axis_names) - {"pod", "data", "model"}
    if other or "model" not in mesh.shape:
        raise ValueError(f"mesh axes {mesh.axis_names}: the trainer takes "
                         f"'pod', 'data' and 'model'")
    if mesh.shape["model"] > 1:
        waits(f"Trainer on a \"model\" axis of {mesh.shape['model']} "
              f"(tensor parallelism)", "12.7")
    if not mesh.live:
        raise ValueError("Trainer(mesh=) needs a live mesh "
                         "(make_debug_mesh, make_production_mesh)")
    return mesh


# --------------------------------------------------------------------------- #
# Loop with fault-tolerance hooks
# --------------------------------------------------------------------------- #
def run_loop(trainer: Trainer, *, steps: int, ckpt_dir: Optional[str],
             ckpt_every: int = 50, log_path: Optional[str] = None,
             resume: bool = True, keep: int = 3,
             hb_dir: Optional[str] = None,
             log_every: int = 10) -> list[dict]:
    """Train to ``steps``: resume from ``LATEST`` if there is one, a JSONL
    record per step, a checkpoint every ``ckpt_every`` steps (the newest
    ``keep`` kept) and at the end, a heartbeat per step, stragglers
    flagged, and SIGTERM answered by a checkpoint and a stop.  The SIGTERM
    handler is restored on return."""
    flag = PreemptionFlag()
    old_handler = signal.signal(signal.SIGTERM, flag.set)
    watchdog = StragglerDetector()
    hb = Heartbeat(hb_dir, trainer.rank) if hb_dir else None

    if ckpt_dir and resume and ckpt.latest_step(ckpt_dir) is not None:
        got = trainer.restore(ckpt_dir)
        log.info("resumed", step=got)
    elif trainer.params is None:
        trainer.init_state()

    logf = open(log_path, "a") if log_path and trainer.rank == 0 else None
    records = []
    t_tokens = trainer.batch * trainer.seq_len
    try:
        while trainer.step < steps:
            t0 = time.time()
            rec = trainer.train_step()
            dt = time.time() - t0
            rec["step_time_s"] = round(dt, 4)
            rec["tokens_per_s"] = round(t_tokens / dt, 1)
            if watchdog.observe(dt):
                rec["straggler"] = True
                log.warning("straggler", step=rec["step"], step_s=dt,
                            median_s=watchdog.median)
            records.append(rec)
            if hb:
                hb.beat(rec["step"])
            if logf:
                logf.write(json.dumps(rec) + "\n")
                logf.flush()
            if rec["step"] % log_every == 0 or rec["step"] == 1:
                log.info("step", step=rec["step"], loss=rec["loss"],
                         gnorm=rec["grad_norm"],
                         tok_per_s=rec["tokens_per_s"])
            if ckpt_dir and rec["step"] % ckpt_every == 0:
                trainer.save(ckpt_dir)
                if trainer.rank == 0:
                    ckpt.cleanup(ckpt_dir, keep=keep)
            # every replica stops after the same step
            if trainer.any_rank(flag):
                log.warning("preempted", step=trainer.step,
                            checkpointing=bool(ckpt_dir))
                if ckpt_dir:
                    trainer.save(ckpt_dir)
                break
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        if logf:
            logf.close()
    if ckpt_dir and trainer.step and (not records
                                      or trainer.step % ckpt_every != 0):
        trainer.save(ckpt_dir)
    return records


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="debug",
                    choices=["debug", "production"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--log", default=None)
    ap.add_argument("--hb-dir", default=None)
    ap.add_argument("--opt-state", default="f32", choices=["f32", "int8"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Train as the flags say; returns the step records."""
    args = parse_args(argv)
    joined = multihost_requested()
    if joined:
        initialize_from_env(device=args.device)
    try:
        if args.mesh == "production":
            mesh = make_production_mesh(device=args.device)
        elif dist.is_available() and dist.is_initialized():
            mesh = make_debug_mesh(dist.get_world_size(), 1,
                                   device=args.device)
        else:
            mesh = None
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        trainer = Trainer(cfg, batch=args.batch, seq_len=args.seq_len,
                          mesh=mesh, lr=args.lr, opt_state=args.opt_state,
                          compress_grads=args.compress_grads,
                          seed=args.seed, accum_steps=args.accum_steps,
                          device=args.device)
        t0 = time.time()
        records = run_loop(trainer, steps=args.steps,
                           ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every, log_path=args.log,
                           resume=not args.no_resume, hb_dir=args.hb_dir)
    finally:
        if joined:
            dist.destroy_process_group()
    if records:
        first, last = records[0], records[-1]
        log.info("done", steps=len(records), wall_s=time.time() - t0,
                 loss_first=first["loss"], loss_last=last["loss"])
    return records


if __name__ == "__main__":
    main()
