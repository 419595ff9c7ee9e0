"""Roofline accounting of one traced training step — the port's counterpart
of ``repro.launch.hlo_analysis``.

The reference lowers its jitted step to XLA and reads the three roofline
numerators off the optimized HLO text.  Nothing in torch lowers to HLO, so
the port runs the step itself, the very code ``Trainer(mesh=)`` runs live
(``Trainer.loss_and_grads`` and ``Trainer.update``), as rank 0 of a
``fake`` process group of the mesh's size (``fake_world``), on tensors of
the ``meta`` device (shapes and dtypes, no memory, no compute: what
``FakeTensorMode``'s fake tensors wrap, at a third of their dispatch
cost, which a dry run of 72 layers pays per op), and counts what it
dispatches:

  * FLOPs      — ``torch.utils.flop_counter.FlopCounterMode``'s count:
                 its per-op rules (``flop_registry``) over every op the
                 step dispatches, so products only (mm, bmm, addmm,
                 convolutions, attention), the reference's convention
                 (``hlo_analysis.py:7-11``).  Every micro-batch and every
                 remat recompute counts, since the traced step executes
                 them.  The rules run inside the byte counter's dispatch
                 (``FlopCounterMode`` itself costs a third more a step);
  * HBM bytes  — over every op dispatched, its operand bytes plus its
                 result bytes; views and ops that move no data (``empty``,
                 ``detach``, aliases) are skipped, as the reference's
                 ``_SKIP_BYTES_OPS``.  Each eager op reads and writes
                 memory, so this is the unfused upper bound: it lies above
                 XLA's count at fusion boundaries;
  * collectives — ``distributed.collectives``' byte and call counters by
                 kind (every exchange of the step goes through it), with
                 the reference's ring-algorithm link weights (all-reduce
                 2.0, the others 1.0; ``hlo_analysis.py:44-45``);
  * memory     — per device: the arguments (the rank's stored parameter
                 shards, optimizer state, compression residuals and its
                 rows of the batch), the outputs (the new state and the
                 loss), and the temporaries: the peak of the live bytes of
                 the storages the step creates, read off each meta
                 storage's lifetime (a weak reference per storage).

A data-dependent shape has no meta value: ``nonzero`` (the MoE dispatch's
tokens per expert) takes the row count the caller's ``nonzero_rows``
gives, the dry run's balanced routing (``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib
import time
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..distributed import collectives
from ..distributed.sharding import local_shape
from ..models.model import tree_flatten, tree_map, tree_unflatten

# ring-algorithm link weights by kind (``hlo_analysis._LINK_WEIGHT``)
LINK_WEIGHT = {"all_gather": 1.0, "reduce_scatter": 1.0, "all_reduce": 2.0,
               "all_reduce_max": 2.0}

# ops that move no data: their bytes are not charged
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "detach", "alias", "lift_fresh",
            "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
            "sym_storage_offset"}


@dataclass
class CollectiveStats:
    per_op: dict = field(default_factory=lambda: defaultdict(float))
    total_bytes: float = 0.0
    link_bytes: float = 0.0
    counts: dict = field(default_factory=lambda: defaultdict(int))


@dataclass
class StepCost:
    flops: float = 0.0
    bytes_hbm: float = 0.0
    collectives: CollectiveStats = field(default_factory=CollectiveStats)


@dataclass
class StepTrace:
    """One traced step: its cost, its per-device memory (the reference's
    ``memory_analysis`` keys, plus ``argument_parts``) and the seconds the
    trace took."""
    cost: StepCost
    memory: dict
    trace_s: float


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _op_tensors(args, out: list) -> list:
    """The tensors among ``args`` and the lists in it (an op's operands or
    results), appended to ``out``."""
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            _op_tensors(a, out)
    return out


_NO_DATA_CACHE: dict = {}


def _moves_no_data(func) -> bool:
    hit = _NO_DATA_CACHE.get(func)
    if hit is None:
        hit = _NO_DATA_CACHE[func] = (
            func.__name__.split(".")[0] in _NO_DATA
            or any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns))
    return hit


class _Counter(TorchDispatchMode):
    """``FlopCounterMode``'s FLOPs and the operand plus result bytes of
    every op that moves data, and the live bytes of the storages created
    under it (``known`` storages excluded) with their peak.
    ``nonzero_rows(mask)`` sizes ``nonzero``'s result."""

    def __init__(self, nonzero_rows: Optional[Callable] = None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._nonzero_rows = nonzero_rows
        self._seen: dict = {}

    def known(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            self._seen.setdefault(id(st), weakref.ref(st))

    def _free(self, key: int, n: int) -> None:
        self._seen.pop(key, None)
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        ref = self._seen.get(key)
        if ref is not None and ref() is st:
            return
        n = st.nbytes()
        self._seen[key] = weakref.ref(st)
        weakref.finalize(st, self._free, key, n)
        self.live += n
        if self.live > self.peak:
            self.peak = self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten.nonzero.default:
            if self._nonzero_rows is None:
                raise RuntimeError("nonzero has a data-dependent shape: "
                                   "give trace_step nonzero_rows=")
            mask = args[0]
            out = torch.empty((self._nonzero_rows(mask), mask.dim()),
                              dtype=torch.long, device=mask.device)
        else:
            out = func(*args, **kwargs)
        rule = flop_registry.get(func._overloadpacket)
        if rule is not None:
            self.flops += rule(*args, **kwargs, out_val=out)
        outs = _op_tensors(out if isinstance(out, (list, tuple)) else (out,),
                           [])
        if not _moves_no_data(func):
            ins = _op_tensors(args, [])
            if kwargs:
                _op_tensors(kwargs.values(), ins)
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks, this
    process its rank 0: every collective returns at once and moves
    nothing.  Destroyed on exit; raises if a process group is up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is up: the dry run starts its "
                           "own fake world")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta_batch(trainer) -> tuple:
    """This rank's rows of a step's tokens (and encoder frames)."""
    rows = trainer.rows_per_rank if trainer.mesh is not None \
        else trainer.batch
    tokens = torch.zeros((rows, trainer.seq_len), dtype=torch.int32,
                         device=trainer.device)
    enc = None
    if trainer._needs_enc:
        from .specs import enc_len
        enc = torch.zeros((rows, enc_len(trainer.cfg, trainer.seq_len),
                           trainer.cfg.d_model), dtype=torch.float32,
                          device=trainer.device)
    return tokens, enc


def _meta_params(trainer) -> dict:
    """The rank's f32 parameter shards, drawn as nothing: tensors of
    ``local_shape`` of the plan (the whole tree without a mesh)."""
    shapes = trainer.model.param_shapes(torch.float32)
    if trainer.mesh is None:
        return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                              device=trainer.device),
                        shapes)
    flat, treedef = tree_flatten(shapes)
    specs = tree_flatten(trainer.p_specs)[0]
    return tree_unflatten(treedef, [
        torch.zeros(local_shape(t.shape, s, trainer.mesh), dtype=t.dtype,
                    device=trainer.device) for t, s in zip(flat, specs)])


def _state_bytes(trainer) -> dict:
    return {"params": sum(map(_nbytes, _tensors(trainer.params))),
            "optimizer": sum(map(_nbytes, _tensors(trainer.opt_state))),
            "residuals": sum(map(_nbytes, _tensors(trainer.residuals)))}


def trace_step(trainer, nonzero_rows: Optional[Callable] = None
               ) -> StepTrace:
    """One training step of ``trainer`` (on ``device="meta"``, on a mesh of
    a ``fake_world`` or on none) traced: its ``StepCost`` and memory.  The
    trainer's state is zeros of its shards, set by ``init_state``, and is
    dropped again on return."""
    if trainer.device.type != "meta":
        raise ValueError(f"the dry run traces a trainer on 'meta', not "
                         f"{trainer.device}")
    t0 = time.perf_counter()
    try:
        trainer.init_state(params=_meta_params(trainer), sharded=True)
        batch = _meta_batch(trainer)
        parts = _state_bytes(trainer)
        parts["inputs"] = sum(map(_nbytes, _tensors(batch)))
        counter = _Counter(nonzero_rows)
        counter.known(_tensors(trainer.state_tree()) + _tensors(batch))
        collectives.reset_bytes()
        with counter:
            loss, grads = trainer.loss_and_grads(batch)
            trainer.update(grads)
            out_bytes = sum(_state_bytes(trainer).values()) + _nbytes(loss)
            del loss, grads
        moved = collectives.bytes_moved()
        calls = collectives.calls_made()
    finally:
        trainer.params = trainer.opt_state = trainer.residuals = None
    coll = CollectiveStats()
    for kind in collectives.KINDS:
        if calls[kind]:
            coll.per_op[kind] = moved[kind]
            coll.counts[kind] = calls[kind]
            coll.total_bytes += moved[kind]
            coll.link_bytes += moved[kind] * LINK_WEIGHT[kind]
    cost = StepCost(flops=float(counter.flops),
                    bytes_hbm=float(counter.bytes), collectives=coll)
    memory = {"argument_size_in_bytes": sum(parts.values()),
              "output_size_in_bytes": out_bytes,
              "temp_size_in_bytes": counter.peak,
              "argument_parts": parts}
    return StepTrace(cost, memory, time.perf_counter() - t0)


def peak_bytes(memory: dict) -> int:
    """A traced step's peak per device: arguments plus temporaries, what
    the fit criterion holds to the card's memory."""
    return memory["argument_size_in_bytes"] + memory["temp_size_in_bytes"]
