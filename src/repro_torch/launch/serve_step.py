"""The sharded serving step — the port's counterpart of the reference's
jitted prefill and decode functions with ``in_shardings``
(``repro.launch.dryrun.build_cell``'s serving branches).

``ServeStep(cfg, kind, batch, seq_len, mesh=)`` plans the mesh as
``Trainer(mesh=)`` does (``launch/train.py``) and holds this rank's shards
of the weights, in the compute dtype (bf16, as the reference's serving
cells store them), and of the decode state:

  * the params' ``tree_shardings``; the tokens' ``data_spec(mesh, 2, B)``
    and an encdec prefill's frames' ``data_spec(mesh, 3, B)``: the rank
    takes its rows of the global batch (``rows``);
  * ``decode_state_specs`` of the state, a ``kind="decode"`` step's
    ``seq_len`` deep: KV heads over "model" (else head_dim), SSM heads
    over "model", ``conv`` over d_inner, the batch over the data axes;
  * the model's ``Parallel`` context, with the residual stream split
    along the sequence over "model" where the prompt's length divides it
    (``S % m == 0``); a decode step's single position never splits.

``load_params`` draws every leaf from a seed (``Model.init_params``'s
draws, leaf by leaf), or takes each leaf of a given global tree, keeps
this rank's shard and frees the leaf, so a rank's peak is its shards and
one whole leaf.  ``init_state`` makes the rank's zero shards of the state
(an encdec model encodes its frames on the mesh first and keeps its cross
K/V heads).  ``prefill(tokens)`` returns the last position's logits
(B_rows, vocab), whole over vocab on every "model" rank, as the
reference's ``out_shardings=data_spec(mesh, 2, B)``; on a decode step it
also fills the rank's shards of the state (one pass, where the reference
fills its cache by decode steps: ROADMAP Queue C).  ``decode(tokens)``
runs one token against the state, updated in place (the reference
donates it).

Every call runs under ``torch.no_grad()``, so on ``backend="cuda"`` the
"heads" attention of the prefill runs the flash kernel on the rank's
heads.  A mesh of one rank (or none) runs the mesh-less model.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.registry import resolve_device
from ..distributed.collectives import Parallel, spec_axes
from ..distributed.sharding import (data_spec, decode_state_specs,
                                    local_shape, resolve_spec, shard_tensor,
                                    tree_shardings)
from ..models.layers import RealMaker
from ..models.model import Model, make_params, tree_flatten, tree_map, \
    tree_unflatten
from .train import _check_mesh

KINDS = ("prefill", "decode")


def decode_enc_len(seq_len: int) -> int:
    """Encoder frames of a decode cell's encdec state: the reference's
    ``min(S // 4, 8192)`` (``repro/launch/dryrun.py:248``)."""
    return min(seq_len // 4, 8192)


class ServeStep:
    """One serving step of ``cfg`` on ``mesh`` (or on ``device`` alone):
    ``kind="prefill"`` the forward over (batch, seq_len) prompts, its last
    logits; ``kind="decode"`` one token against a state ``seq_len``
    positions deep, whose ``prefill`` fills the state first.  ``batch``
    is the global batch.  The model's chunks are the reference's serving
    cells': queries 1024 (the sequence below that), SSD 128."""

    def __init__(self, cfg, kind: str, batch: int, seq_len: int, *,
                 mesh=None, kv_quant: bool = False, backend: str = "cuda",
                 device=None, compute_dtype=torch.bfloat16):
        if kind not in KINDS:
            raise ValueError(f"kind {kind!r} not in {KINDS}")
        self.mesh = _check_mesh(mesh)
        if self.mesh is not None and device is None:
            device = self.mesh.device
        self.device = resolve_device(device)
        if self.mesh is not None and \
                self.mesh.device.type != self.device.type:
            raise ValueError(f"the mesh runs on {self.mesh.device}, the "
                             f"step on {self.device}")
        self.cfg, self.kind = cfg, kind
        self.batch, self.seq_len = batch, seq_len
        self.kv_quant = kv_quant
        self.model = Model(cfg, compute_dtype, q_chunk=min(1024, seq_len),
                           ssd_chunk=128, remat=False, backend=backend,
                           device=self.device)
        self.params = self.state = None
        self.sharded = self.mesh is not None and self.mesh.size > 1
        self.rows_per_rank, self.first_row = batch, 0
        self.p_specs = self.s_specs = None
        if self.sharded:
            self._plan_mesh()

    def _plan_mesh(self) -> None:
        mesh = self.mesh
        model = self.model
        self.p_specs = tree_map(lambda s: s.spec, tree_shardings(
            model.param_shapes(model.compute_dtype),
            model.param_logical_specs(), mesh))
        # the tokens' rows, and an encdec prefill's frames' (the same split)
        self.tok_spec = data_spec(mesh, 2, self.batch)
        self.batch_axes = spec_axes(self.tok_spec[0])
        n = 1
        for a in self.batch_axes:
            n *= mesh.shape[a]
        self.rows_per_rank = self.batch // n
        self.first_row = (mesh.coordinate(self.batch_axes)
                          if self.batch_axes else 0) * self.rows_per_rank

    # ------------------------------------------------------------ context
    def _context(self, seq: int, enc: Optional[int] = None) -> None:
        """The model's ``Parallel`` for a sequence of ``seq`` positions
        (and ``enc`` encoder frames): split over "model" where they divide
        it."""
        if not self.sharded:
            self.model.parallel = None
            return
        m = self.mesh.shape["model"]
        self.model.parallel = Parallel(
            self.mesh, self.p_specs, self.batch_axes,
            self.model.compute_dtype, split=seq % m == 0,
            split_enc=None if enc is None else enc % m == 0)

    def rows(self, x) -> torch.Tensor:
        """This rank's rows of a global batch (dim 0), on the device."""
        x = torch.as_tensor(x, device=self.device)
        return x[self.first_row:self.first_row + self.rows_per_rank]

    # ------------------------------------------------------------- params
    def _keep(self, t: torch.Tensor, logical) -> torch.Tensor:
        """This rank's shard of the global leaf ``t`` in the compute dtype,
        in storage of its own on the device."""
        if self.sharded:
            t = shard_tensor(t, resolve_spec(tuple(t.shape), logical,
                                             self.mesh), self.mesh)
        dt = self.model.compute_dtype
        return torch.empty(t.shape, dtype=dt, device=self.device).copy_(t)

    def load_params(self, params: Optional[dict] = None, *, seed: int = 0,
                    sharded: bool = False) -> dict:
        """Set this rank's weights: drawn from ``seed`` as
        ``Model.init_params(seed)`` draws them (on the step's device), or
        cut from the global tree ``params``; ``sharded``: ``params`` are
        this rank's shards already.  Returns them."""
        model = self.model
        with torch.no_grad():
            if params is None:
                draw = RealMaker(seed, torch.float32, self.device)
                self.params = make_params(
                    self.cfg, lambda shape, logical, init="fan_in":
                    self._keep(draw(shape, logical, init), logical))
            elif sharded:
                self.params = model.cast(params)
            else:
                flat, treedef = tree_flatten(params)
                logical = tree_flatten(model.param_logical_specs())[0]
                self.params = tree_unflatten(treedef, [
                    self._keep(torch.as_tensor(t), lg)
                    for t, lg in zip(flat, logical)])
        return self.params

    def param_shapes(self) -> dict:
        """This rank's shapes of the weights, as meta tensors."""
        shapes = self.model.param_shapes(self.model.compute_dtype)
        if not self.sharded:
            return shapes
        return _local_meta(shapes, self.p_specs, self.mesh)

    # -------------------------------------------------------------- state
    def state_shapes(self, enc_frames: int = 0) -> dict:
        """The rank's shards of the decode state as meta tensors (the
        whole state without a mesh); sets ``s_specs``."""
        shapes = self.model.decode_state_shapes(
            self.batch, self.seq_len, enc_frames, kv_quant=self.kv_quant)
        if not self.sharded:
            return shapes
        self.s_specs = tree_map(lambda s: s.spec, decode_state_specs(
            self.cfg, shapes, self.mesh))
        return _local_meta(shapes, self.s_specs, self.mesh)

    def init_state(self, enc_embeds=None) -> dict:
        """This rank's zero shards of a ``kind="decode"`` step's state,
        ``index`` 0.  An encdec model takes its frames ``enc_embeds`` (the
        rank's rows): they are encoded on the mesh, and the rank keeps the
        cross K/V heads its shard holds."""
        if self.kind != "decode":
            raise ValueError("a prefill step holds no decode state")
        if self.params is None:
            raise ValueError("load_params first")
        encdec = self.cfg.family == "encdec"
        if encdec and enc_embeds is None:
            raise ValueError(f"{self.cfg.name} (encdec): init_state needs "
                             f"enc_embeds=")
        frames = 0 if enc_embeds is None else enc_embeds.shape[1]
        shapes = self.state_shapes(frames)
        state: dict = {"index": 0}
        for key, t in shapes.items():
            if key not in ("cross_k", "cross_v"):
                state[key] = torch.zeros(t.shape, dtype=t.dtype,
                                         device=self.device)
        if encdec:
            with torch.no_grad():
                self._context(1, frames)
                model = self.model
                memory = model.encode(self.params, enc_embeds)
                if model.parallel is not None:
                    memory = model.parallel.encoder().gather_seq(memory)
                whole = shapes["cross_k"].shape[-2] == self.cfg.n_heads
                state["cross_k"], state["cross_v"] = model.cross_kv(
                    self.params, memory, shapes["cross_k"].dtype,
                    heads=None if whole else 1)
        self.state = state
        return state

    # ------------------------------------------------------------ the step
    def prefill(self, tokens, enc_embeds=None) -> torch.Tensor:
        """The rank's rows of the prompts (B_rows, S) → the last position's
        logits (B_rows, vocab).  A decode step fills its state (positions
        0..S-1, ``index`` S); an encdec decode step's state holds the
        cross K/V, so it takes no ``enc_embeds``."""
        tokens = torch.as_tensor(tokens, device=self.device)
        enc = None if enc_embeds is None else enc_embeds.shape[1]
        with torch.no_grad():
            self._context(tokens.shape[1], enc)
            return self.model.prefill(self.params, tokens, self.state,
                                      enc_embeds=enc_embeds)

    def decode(self, tokens) -> torch.Tensor:
        """One token (B_rows, 1) against the state → logits (B_rows,
        vocab); the state's shards are updated in place and ``index``
        advanced."""
        if self.state is None:
            raise ValueError("init_state (and prefill) first")
        with torch.no_grad():
            self._context(1)
            logits, self.state = self.model.decode_step(
                self.params, self.state, tokens)
        return logits


def _local_meta(shapes: dict, specs: dict, mesh) -> dict:
    """Meta tensors of each leaf's ``local_shape`` under its spec."""
    flat, treedef = tree_flatten(shapes)
    return tree_unflatten(treedef, [
        torch.empty(local_shape(t.shape, s, mesh), dtype=t.dtype,
                    device="meta")
        for t, s in zip(flat, tree_flatten(specs)[0])])
