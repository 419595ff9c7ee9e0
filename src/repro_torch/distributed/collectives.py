"""Autograd-aware collectives over a mesh axis group, and the tensor- and
sequence-parallel context the trainer's model runs under.

The reference leaves its exchanges to GSPMD; torch has no sharding
propagation, so the port writes each one out, as Megatron does (tensor
parallelism, with sequence parallelism where the sequence splits):

  * ``all_gather(x, dim, group)``: the group's chunks of ``x`` joined
    along ``dim`` in group-rank order; the backward is a reduce-scatter,
    which hands each rank the group's sum of its chunk's gradient;
  * ``reduce_scatter(x, dim, group)``: the group's sum of ``x``, this
    rank's chunk of it along ``dim``; the backward is an all-gather;
  * ``copy_to_group``: identity forward, all-reduce (sum) backward;
  * ``reduce_from_group``: all-reduce (sum) forward, identity backward;
  * ``all_reduce``: all-reduce (sum) forward and backward;
  * ``all_reduce_max``: in place, no gradient.

Over a group of one rank each is the identity.  Every call over more
ranks adds the bytes of the larger of its input and output to a
per-process counter by kind and one to a count of its calls
(``reset_bytes``, ``bytes_moved``, ``calls_made``), which the trainer's
step record and the dry run (``launch/cost_analysis.py``) report.  The calls are the list forms (``dist.all_gather``,
``dist.reduce_scatter``), which torch 2.11 and later both have without a
deprecation, and which a gloo group takes on card tensors as well as on
host ones (``chip_smoke.py`` phase 16 probes each on the card).

``Parallel`` binds a live mesh: its "model" group, the group of its data
axes and that of the axes the batch is split over, this rank's "model"
coordinate, the tree of the params' ``PartitionSpec``s, and whether the
residual stream is split along the sequence over "model" (``split``; the
encoder's own in ``encoder``).  A sharded dim holds contiguous equal
chunks in mesh-coordinate order, a dim split over several axes the first
axis major (``distributed/sharding.py``).
"""
from __future__ import annotations

import copy

import torch
import torch.distributed as dist

KINDS = ("all_gather", "reduce_scatter", "all_reduce", "all_reduce_max")

_BYTES = dict.fromkeys(KINDS, 0)
_CALLS = dict.fromkeys(KINDS, 0)


def reset_bytes() -> None:
    for k in KINDS:
        _BYTES[k] = _CALLS[k] = 0


def bytes_moved() -> dict:
    """Bytes by kind since ``reset_bytes``."""
    return dict(_BYTES)


def calls_made() -> dict:
    """Calls by kind since ``reset_bytes``."""
    return dict(_CALLS)


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _count(kind: str, *tensors) -> None:
    _BYTES[kind] += max(t.numel() * t.element_size() for t in tensors)
    _CALLS[kind] += 1


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim)
    _count("all_gather", out)
    return out


def _scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    chunks = [c.contiguous() for c in x.chunk(n, dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    _count("reduce_scatter", x)
    return out


def _reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM,
            kind: str = "all_reduce") -> torch.Tensor:
    dist.all_reduce(x, op=op, group=group)
    if size(group) > 1:
        _count(kind, x)
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.clone(), ctx.group), None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if size(group) == 1 else _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if size(group) == 1 else _ReduceScatter.apply(x, dim, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if size(group) == 1 else _ReduceFromGroup.apply(x, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return x if size(group) == 1 else _AllReduce.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The group's elementwise max, in place (no gradient); ``x`` itself
    for no group."""
    if group is not None:
        _reduce(x, group, dist.ReduceOp.MAX, "all_reduce_max")
    return x


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's elementwise sum, in place (no gradient); ``x`` itself
    for no group."""
    if group is not None:
        _reduce(x, group)
    return x


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity forward; the gradient times ``scale``."""
    return x if scale == 1 else _ScaleGrad.apply(x, scale)


# --------------------------------------------------------------------------- #
# The parallel context
# --------------------------------------------------------------------------- #
def spec_axes(entry) -> tuple:
    """A ``PartitionSpec`` entry's axes: () for None."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Parallel:
    """A live mesh as the trainer's model sees it.

    ``m``/``r``: the "model" axis's size and this rank's coordinate on it;
    ``model``: its group; ``data``: the group of the data axes, the FSDP
    axes ("pod", "data"), over which every "embed" shard is gathered;
    ``batch``: the group of the axes the batch rows are split over (the
    data axes, or only the inner one when the batch does not divide them
    all), over which MoE routing gathers the global token set; ``specs``:
    the params' tree of ``PartitionSpec``s.  Axes of size 1 split nothing
    and are ignored.

    ``split``: the residual stream is this rank's sequence chunk (S/m),
    each sub-block gathering it and reduce-scattering its output
    (Megatron's sequence parallelism); else, for a sequence that does not
    split over "model" (the reference's ``constrain`` then leaves it
    replicated), it is whole on every rank, ``chunk`` and ``gather_seq``
    pass it through and each sub-block's closing reduce-scatter becomes an
    all-reduce both ways (plain tensor parallelism), so the gradient a
    rank holds for it is its share of the sum over "model".
    ``split_enc``: the same for the encoder's stack (``split`` by
    default), which runs under ``encoder()``."""

    def __init__(self, mesh, specs, batch_axes=(), dtype=torch.float32,
                 split: bool = True, split_enc: bool = None):
        self.specs = specs
        self.dtype = dtype
        self.split = split
        self.m = mesh.shape.get("model", 1)
        self.model = mesh.group("model") if self.m > 1 else None
        self.r = mesh.coordinate("model") if self.m > 1 else 0
        fa = tuple(a for a in mesh.axis_names
                   if a in ("pod", "data") and mesh.shape[a] > 1)
        self.data_axes = fa
        self.data = mesh.group(fa) if fa else None
        ba = tuple(a for a in batch_axes if mesh.shape[a] > 1)
        self.batch = mesh.group(ba) if ba else None
        self.batch_rank = mesh.coordinate(ba) if ba else 0
        self.split_enc = split if split_enc is None else split_enc

    def encoder(self) -> "Parallel":
        """The context the encoder's stack runs under: this one, or a copy
        whose sequence is split as the encoder's length allows."""
        if self.split_enc == self.split:
            return self
        view = copy.copy(self)
        view.split = self.split_enc
        return view

    # ------------------------------------------------------------ params
    def model_dim(self, spec):
        """The tensor dim ``spec`` splits over "model" (None if none)."""
        if self.m == 1:
            return None
        for d, e in enumerate(spec):
            if "model" in spec_axes(e):
                return d
        return None

    def take(self, t: torch.Tensor, spec) -> torch.Tensor:
        """A stored shard as the unit uses it: gathered over the data axes
        along the dim ``spec`` splits over them (f32, so the backward's
        reduce-scatter sums f32 gradients), then cast to the compute
        dtype.  Its "model" split stays."""
        for d, e in enumerate(spec):
            if self.data is not None and \
                    set(spec_axes(e)) & set(self.data_axes):
                t = all_gather(t, d, self.data)
        return t.to(self.dtype) if t.dtype == torch.float32 else t

    def take_tree(self, tree, specs):
        if isinstance(tree, dict):
            return {k: self.take_tree(tree[k], specs[k]) for k in tree}
        return self.take(tree, specs)

    def want(self, t: torch.Tensor, have, dim=None) -> torch.Tensor:
        """``t``, split over "model" along ``have`` (None: whole), as the
        compute wants it: split along ``dim``, or whole for None.  A
        mismatch gathers over "model" (the backward reduce-scatters the
        ranks' partial gradients) and then takes this rank's chunk."""
        if have == dim or self.m == 1:
            return t
        if have is not None:
            t = all_gather(t, have, self.model)
        if dim is None:
            return t
        n = t.shape[dim] // self.m
        return t.narrow(dim, self.r * n, n)

    # --------------------------------------------------------- sequence
    def chunk(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's chunk of ``x`` along ``dim`` (no exchange); ``x``
        itself when the sequence is not split."""
        if not self.split:
            return x
        n = x.shape[dim] // self.m
        return x.narrow(dim, self.r * n, n)

    def offset(self, n: int) -> int:
        """The global position of this rank's first of ``n`` positions."""
        return self.r * n if self.split else 0

    def gather_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return all_gather(x, dim, self.model) if self.split else x

    def scatter_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """A sub-block's partial outputs summed over "model": this rank's
        chunk of the sum, or the whole sum when the sequence is not
        split."""
        if self.split:
            return reduce_scatter(x, dim, self.model)
        return all_reduce(x, self.model)
