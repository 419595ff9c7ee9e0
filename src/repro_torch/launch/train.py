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

``Trainer(mesh=)`` trains on a live mesh (``launch/mesh.py``,
``launch/cluster.py``), one rank a device, and each rank stores only its
shard of every param, Adam moment (int8 values and row scales alike) and
compression residual, as the sharding rules place them (``p_shards``,
``o_shards``; ``distributed/sharding.py``).  The rank takes its rows of
the global batch (``data_spec`` splits dim 0 over the data axes); the
model runs tensor parallel over "model", and sequence parallel where the
sequence divides that axis (else the residual stream is whole on each
rank, as the reference's ``constrain`` leaves it), and gathers each
unit's "embed" shards over the data axes as it runs it (FSDP,
``models/model.py``).  Gradients a gather left partial are summed by its
backward reduce-scatter; a coalesced f32 all-reduce sums the rest over
the data axes (leaves the rules replicate there, and the loss) and over
"model" (leaves replicated over it, whose ranks each hold a share:
their sequence chunk's, or their heads' of the whole sequence), and
everything is divided by the replicas.  The codec, the grad
norm and Adam then run on the shards of that global gradient, as on one
device: a row split over ranks takes its amax over them, and the grad
norm counts each distinct shard once.  ``save`` gathers every leaf and
rank 0 writes the reference's layout; ``restore`` reads the global arrays
and keeps this rank's shards, so a run restores onto another mesh or onto
none (``plan_elastic_restart``).  The launcher joins a process group when
REPRO_MULTIHOST=1 (``launch/cluster.py``).
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
from ..distributed import collectives
from ..distributed.collectives import Parallel, spec_axes
from ..distributed.compression import compress_tree, init_residuals
from ..distributed.fault_tolerance import (Heartbeat, PreemptionFlag,
                                           StragglerDetector)
from ..distributed.optimizer import Adam, AdamConfig
from ..distributed.sharding import (P, data_spec, fsdp_axes, gather_tensor,
                                    shard_tensor, tree_shardings)
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

    ``mesh``: ``None`` trains on ``device`` alone.  A live ``Mesh`` of
    "pod"/"data"/"model" axes trains over its ranks on the mesh's device,
    each holding its shards: ``batch`` is the global batch,
    ``accum_steps`` splits each rank's rows.  A sequence (or an encdec
    model's encoder length) that divides the "model" axis runs sequence
    parallel over it, any other whole on each of its ranks
    (``Parallel.split``).

    ``q_chunk``/``loss_chunk``: the model's query and loss chunks, each
    at most S (the dry run takes the reference's 1024,
    ``launch.dryrun._model_for``); SSD chunks of min(128, S)."""

    def __init__(self, cfg, *, batch: int, seq_len: int, mesh=None,
                 lr: float = 3e-4, opt_state: str = "f32",
                 compress_grads: bool = False, remat: bool = True,
                 seed: int = 0, param_dtype=torch.float32,
                 accum_steps: int = 1, compute_dtype=torch.bfloat16,
                 device=None, q_chunk: int = 512, loss_chunk: int = 512):
        self.mesh = _check_mesh(mesh)
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
        self.model = Model(cfg, compute_dtype, q_chunk=min(q_chunk, seq_len),
                           ssd_chunk=min(128, seq_len),
                           loss_chunk=min(loss_chunk, seq_len), remat=remat,
                           backend="torch", device=self.device)
        self.opt = Adam(AdamConfig(lr=lr, state_dtype=opt_state))
        self.pipeline = SyntheticTokens(TokenPipelineConfig(
            vocab=cfg.vocab, seq_len=seq_len, global_batch=batch, seed=seed))
        self._needs_enc = cfg.family == "encdec"
        self.params = None
        self.opt_state = None
        self.residuals = None
        self.par = None
        self.step = 0
        self.rank, self.replicas = 0, 1
        self.p_shards = self.o_shards = self.tok_spec = None
        self.comm: dict = {}
        if self.mesh is not None:
            self._plan_mesh(compute_dtype)

    def _plan_mesh(self, compute_dtype) -> None:
        """The reference's sharding plan on the mesh; this rank's rows of
        the global batch; the model's ``Parallel`` context; per param leaf
        the axes that split it and the group that holds the rest of its
        rows."""
        mesh = self.mesh
        if mesh.device.type != self.device.type:
            raise ValueError(f"the mesh runs on {mesh.device}, the trainer "
                             f"on {self.device}")
        m = mesh.shape["model"]
        logical = self.model.param_logical_specs()
        p_shapes = self.model.param_shapes(self.param_dtype)
        self.p_shards = tree_shardings(p_shapes, logical, mesh)
        self.o_shards = tree_shardings(
            self.opt.init(p_shapes), self.opt.state_logical_specs(logical),
            mesh)
        self.p_specs = tree_map(lambda s: s.spec, self.p_shards)
        self.o_specs = tree_map(lambda s: s.spec, self.o_shards)
        self.tok_spec = data_spec(mesh, 2, self.batch)
        split = spec_axes(self.tok_spec[0])
        self.par = Parallel(
            mesh, self.p_specs, split, compute_dtype,
            split=self.seq_len % m == 0,
            split_enc=enc_len(self.cfg, self.seq_len) % m == 0
            if self._needs_enc else None)
        # a mesh of one rank runs the one-device model: its per-unit casts
        # would be fresh tensors where one device slices a cast stack, and
        # the bf16 products' bits follow the operands' alignment
        self.model.parallel = self.par if mesh.size > 1 else None
        self.rank = dist.get_rank()
        fa = fsdp_axes(mesh)
        self.replicas = math.prod(mesh.shape[a] for a in fa)
        # the replicas' group, one rank too (a no-op all-reduce)
        self._replica_group = mesh.group(fa) if fa else None
        self._leaf_axes, self.row_groups = [], []
        for spec in tree_flatten(self.p_specs)[0]:
            axes = {a for e in spec for a in spec_axes(e)
                    if mesh.shape[a] > 1}
            self._leaf_axes.append(mesh._axes(tuple(axes)) if axes else ())
            last = [a for a in spec_axes(spec[-1] if spec else None)
                    if mesh.shape[a] > 1]
            self.row_groups.append(mesh.group(tuple(last)) if last
                                    else None)
        self.rows_per_rank = self.batch // math.prod(mesh.shape[a]
                                                     for a in split)
        self._first_row = (mesh.coordinate(split) if split else 0) \
            * self.rows_per_rank
        if self.rows_per_rank % self.accum_steps:
            raise ValueError(f"{self.rows_per_rank} rows a replica are not "
                             f"a multiple of accum_steps {self.accum_steps}")

    def init_state(self, seed: int = 0, params: Optional[dict] = None,
                   sharded: bool = False) -> None:
        """Fresh f32 masters (torch's seeded draws, not ``jax.random``'s,
        or the global tree ``params``), zero moments and residuals, step 0.
        On a mesh every rank takes rank 0's global masters, then keeps its
        shards; ``sharded``: ``params`` are already this rank's shards."""
        self.params = params if params is not None else \
            self.model.init_params(seed, torch.float32)
        if self.mesh is not None and not sharded:
            for p in tree_flatten(self.params)[0]:
                dist.broadcast(p, src=0)
            self.params = self._shard(self.params, self.p_specs)
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

    def state_specs(self) -> dict:
        """The ``PartitionSpec`` tree of ``state_tree`` on the mesh."""
        res = self.p_specs if self.compress_grads else \
            tree_map(lambda s: P(), self.p_specs)
        return {"params": self.p_specs, "opt": self.o_specs,
                "residuals": res}

    def _shard(self, tree, specs):
        """Each leaf's shard for this rank, in its own storage on the
        trainer's device."""
        flat, treedef = tree_flatten(tree)
        out = []
        for t, spec in zip(flat, tree_flatten(specs)[0]):
            local = shard_tensor(t, spec, self.mesh)
            out.append(torch.empty(local.shape, dtype=local.dtype,
                                   device=self.device).copy_(local))
        return tree_unflatten(treedef, out)

    def gathered(self, tree, specs) -> dict:
        """``tree`` (of this rank's shards, ``specs`` theirs) whole on every
        rank; ``tree`` itself without a mesh."""
        if self.mesh is None:
            return tree
        flat, treedef = tree_flatten(tree)
        return tree_unflatten(treedef, [
            gather_tensor(t, s, self.mesh)
            for t, s in zip(flat, tree_flatten(specs)[0])])

    def save(self, path: str) -> str:
        """Write the state as step ``self.step``.  On a mesh every leaf is
        gathered whole, rank 0 writes the global tree, and every rank
        waits for it."""
        if self.mesh is None:
            return ckpt.save(path, self.step, self.state_tree())
        flat, treedef = tree_flatten(self.state_tree())
        host = []
        for t, spec in zip(flat, tree_flatten(self.state_specs())[0]):
            g = gather_tensor(t, spec, self.mesh)
            host.append(g.cpu() if self.rank == 0 else None)
            del g
        out = os.path.join(path, f"step_{self.step:08d}")
        if self.rank == 0:
            out = ckpt.save(path, self.step, tree_unflatten(treedef, host))
        dist.barrier()
        return out

    def restore(self, path: str, step: Optional[int] = None) -> int:
        """Load a checkpoint (of either package) onto this trainer's
        device; the target tree is this trainer's own state.  On a mesh
        every rank reads the global arrays and keeps its shards, so the
        checkpoint may come from another mesh or from none."""
        if self.mesh is None:
            if self.params is None:
                self.init_state()
            tree, got = ckpt.restore(path, self.state_tree(), step=step,
                                     device=self.device)
        else:
            shapes = self.model.param_shapes(torch.float32)
            like = {"params": shapes, "opt": self.opt.init(shapes),
                    "residuals": init_residuals(shapes)
                    if self.compress_grads else tree_map(
                        lambda p: p.new_zeros(()), shapes)}
            tree, got = ckpt.restore(path, like, step=step, device="cpu")
            tree = self._shard(tree, self.state_specs())
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

    def _coalesced(self, parts: list, group, marks=None) -> tuple:
        """``parts`` summed over ``group`` by one f32 all-reduce of a buffer
        holding each (at ``ALIGN``ed offsets): (the summed parts as views
        of the buffer, the buffer).  ``marks`` gets a mark between the copy
        in and the all-reduce."""
        pad = torch.zeros(ALIGN, dtype=torch.float32, device=self.device)
        packed, offsets, at = [], [], 0
        for g in parts:
            packed.append(g.reshape(-1).float())
            gap = -g.numel() % ALIGN
            if gap:
                packed.append(pad[:gap])
            offsets.append(at)
            at += g.numel() + gap
        buf = torch.cat(packed) if packed else pad[:0]
        if marks is not None:
            self._mark(marks)
        collectives.all_reduce_sum(buf, group)
        return [buf[o:o + g.numel()].view(g.shape)
                for o, g in zip(offsets, parts)], buf

    def _reduce_grads(self, loss, grads):
        """The global gradient's shards and the replicas' mean loss.  The
        loss, and with replicas the leaves no gather has summed over the
        data axes, go through one coalesced all-reduce over them (over a
        one-rank group without); the leaves replicated
        over "model" through one over it; then every leaf and the loss are
        divided by the replicas.  ``self.comm`` gets the bytes and the
        marks around the copy in, each all-reduce and the division."""
        flat, treedef = tree_flatten(grads)
        par = self.par
        marks: list = []
        self._mark(marks)
        data_idx = [i for i, axes in enumerate(self._leaf_axes)
                    if self.replicas > 1
                    and not set(axes) & set(par.data_axes)]
        summed, buf = self._coalesced([flat[i] for i in data_idx]
                                      + [loss.reshape(1)],
                                      self._replica_group, marks)
        for i, g in zip(data_idx, summed):
            flat[i] = g
        loss = summed[-1][0]
        self._mark(marks)
        model_idx = [i for i, axes in enumerate(self._leaf_axes)
                     if par.m > 1 and "model" not in axes]
        if model_idx:
            for i, g in zip(model_idx, self._coalesced(
                    [flat[i] for i in model_idx], par.model)[0]):
                flat[i] = g
        self._mark(marks)
        flat = [g.float().div_(self.replicas) for g in flat]
        loss = loss / self.replicas
        self._mark(marks)
        self.comm = {"all_reduce_bytes": buf.numel() * buf.element_size(),
                     "grad_bytes": 4 * sum(flat[i].numel()
                                           for i in data_idx),
                     "marks": marks}
        return loss, tree_unflatten(treedef, flat)

    def _grad_norm(self, grads) -> torch.Tensor:
        """sqrt of the global gradient's sum of squares: each leaf's local
        sum, then one sum over the ranks that hold the distinct shards of
        the leaves split over the same axes (a copy is counted once)."""
        sq = [torch.sum(torch.square(g.float()))
              for g in tree_flatten(grads)[0]]
        if self.mesh is None:
            return torch.sqrt(sum(sq))
        by_axes: dict = {}
        for s_, axes in zip(sq, self._leaf_axes):
            by_axes.setdefault(axes, []).append(s_)
        total = sum(by_axes.pop((), []))
        for axes in sorted(by_axes):
            total = total + collectives.all_reduce_sum(
                sum(by_axes[axes]), self.mesh.group(axes))
        return torch.sqrt(total)

    def _comm_record(self) -> dict:
        """The step's exchanges: the data all-reduce's bytes and the ms of
        the copy into its buffer, of that all-reduce (with the "model"
        one) and of the division (CUDA events on the card, read once the
        step has synchronised), and every collective's bytes by kind."""
        m = self.comm["marks"]
        if self.device.type == "cuda":
            ms = [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        else:
            ms = [(b - a) * 1e3 for a, b in zip(m, m[1:])]
        return {"pack_ms": ms[0], "all_reduce_ms": ms[1],
                "model_reduce_ms": ms[2], "scale_ms": ms[3],
                "all_reduce_bytes": self.comm["all_reduce_bytes"],
                "grad_bytes": self.comm["grad_bytes"],
                "replicas": self.replicas,
                "collective_bytes": collectives.bytes_moved()}

    def any_rank(self, flag: bool) -> bool:
        """``flag`` as any replica holds it (itself without a mesh)."""
        if self.mesh is None:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def loss_and_grads(self, batch: Optional[tuple] = None):
        """This step's loss and gradient before the codec, under
        ``reproducible``: on a mesh the replicas' mean loss and this rank's
        shards of the global gradient (the step's collective bytes are
        counted from here).  ``batch``: this rank's (tokens, encoder
        frames or None) rows in place of the step's (the dry run's)."""
        if batch is None:
            tokens, enc = self.batch_inputs(self.step)
            if self.mesh is not None:
                take = slice(self._first_row,
                             self._first_row + self.rows_per_rank)
                tokens = tokens[take]
                enc = None if enc is None else enc[take]
        else:
            tokens, enc = batch
        with reproducible(self.device):
            if self.mesh is None:
                return self._grads(tokens, enc)
            collectives.reset_bytes()
            return self._reduce_grads(*self._grads(tokens, enc))

    def update(self, grads) -> torch.Tensor:
        """The int8 codec if asked, then Adam's update of the state from
        ``grads``: the f32 grad norm of what Adam sees."""
        rows = self.row_groups if self.mesh is not None else None
        with reproducible(self.device):
            if self.compress_grads:
                grads, self.residuals = compress_tree(grads, self.residuals,
                                                      rows)
            gnorm = self._grad_norm(grads)
            self.params, self.opt_state = self.opt.update(
                grads, self.opt_state, self.params, rows)
        return gnorm

    def apply_grads(self, loss, grads) -> dict:
        """The step from ``loss_and_grads``' result (``update``):
        {"step", "loss", "grad_norm"}, and on a mesh the exchanges' ms and
        bytes."""
        gnorm = self.update(grads)
        self.step += 1
        rec = {"step": self.step, "loss": float(loss),
               "grad_norm": float(gnorm)}
        if self.mesh is not None:
            rec.update(self._comm_record())
        return rec

    def train_step(self) -> dict:
        """One step: ``loss_and_grads``, then ``apply_grads``."""
        return self.apply_grads(*self.loss_and_grads())


def _check_mesh(mesh):
    """``mesh`` if a step (the trainer's, the serving step's) can run on
    it: a live mesh of "pod", "data" and "model" axes."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a launch.mesh.Mesh, not "
                        f"{type(mesh).__name__}")
    other = set(mesh.axis_names) - {"pod", "data", "model"}
    if other or "model" not in mesh.shape:
        raise ValueError(f"mesh axes {mesh.axis_names}: a step on a mesh "
                         f"takes 'pod', 'data' and 'model'")
    if not mesh.live:
        raise ValueError("a step on a mesh needs a live mesh "
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
