"""Logical-axis → mesh-axis sharding resolution — the port's counterpart of
``repro.distributed.sharding``, its rules held exactly.

Model code names every param dim with a logical axis (``models/layers.py``
``SpecMaker``); this module maps those names onto a mesh's axes:

  mesh axes: ("data", "model")           — 16 × 16
             ("pod", "data", "model")    — 2 × 16 × 16

Per tensor, with divisibility checks, at most one mesh axis per dim and
at most one dim per mesh axis:

  * the tensor-parallel axis "model": vocab / ff / experts / ssm_inner
    first, then heads / kv / ssm_heads, then head_dim (when the head count
    does not divide the axis: smollm's 15 heads, command-r's 8 kv heads);
  * the FSDP axes ("pod", "data"): the "embed" (d_model) dim of every
    weight;
  * "layers" and small dims: replicated.

A spec is a ``PartitionSpec``: one entry per tensor dim, ``None``, an axis
name or a tuple of names, equal entry for entry to JAX's.  A
``NamedSharding`` pairs it with its DTensor placements over the mesh
(``Shard(dim)`` or ``Replicate()`` per mesh dim).

The port's trainer stores each rank's shard of every tensor as its spec
places it (``launch/train.py``): ``local_shape`` is the shard's shape,
``shard_tensor`` cuts it from the global tensor and ``gather_tensor``
joins the ranks' shards again.  A split dim holds contiguous equal chunks
in mesh-coordinate order, a dim split over a tuple of axes the first axis
major, as JAX lays out ``P(("pod", "data"))``.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Sequence

import torch
import torch.distributed as dist

# priority 0 tried first
MODEL_PRIORITY = {
    "vocab": 0, "ff": 0, "experts": 0, "ssm_inner": 0,
    "heads": 1, "kv": 1, "ssm_heads": 1,
    "head_dim": 2,
}
FSDP_CANDIDATES = ("embed",)


class PartitionSpec(tuple):
    """Per tensor dim: ``None`` (replicated), a mesh axis name, or a tuple
    of names (the dim split over those axes, major first).  A tuple, so it
    compares equal to JAX's ``PartitionSpec`` of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec on a mesh, with its DTensor placements."""
    mesh: Any
    spec: PartitionSpec
    placements: tuple


def placements(spec: Sequence, mesh) -> tuple:
    """Per mesh dim, ``Shard(d)`` for the tensor dim ``d`` whose entry names
    that axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def named(mesh, spec: PartitionSpec) -> NamedSharding:
    return NamedSharding(mesh, spec, placements(spec, mesh))


def fsdp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))


def resolve_spec(shape: Sequence[int], logical: Sequence[str],
                 mesh) -> PartitionSpec:
    """One tensor: logical names + concrete shape → PartitionSpec."""
    assert len(shape) == len(logical), (shape, logical)
    out: list = [None] * len(shape)
    model_size = mesh.shape["model"]
    # pass 1: tensor-parallel axis
    cands = [(MODEL_PRIORITY[l], i) for i, l in enumerate(logical)
             if l in MODEL_PRIORITY and shape[i] % model_size == 0
             and shape[i] > 0]
    if cands:
        _, i = min(cands)
        out[i] = "model"
    # pass 2: FSDP axes on the embed dim
    fa = fsdp_axes(mesh)
    if fa:
        fs = _axis_size(mesh, fa)
        for i, l in enumerate(logical):
            if l in FSDP_CANDIDATES and out[i] is None and shape[i] % fs == 0:
                out[i] = fa if len(fa) > 1 else fa[0]
                break
    return P(*out)


def _dim_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: Sequence[int], spec: Sequence, mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` tensor under ``spec``."""
    out = []
    for n, e in zip(shape, spec):
        k = _axis_size(mesh, _dim_axes(e))
        if n % k:
            raise ValueError(f"dim {n} of {tuple(shape)} does not split "
                             f"{k} ways ({tuple(spec)})")
        out.append(n // k)
    return tuple(out) + tuple(shape[len(spec):])


def shard_tensor(t, spec: Sequence, mesh, coords: dict = None):
    """This rank's shard of the global tensor ``t``: along each split dim
    the chunk at the rank's coordinate over that dim's axes (``coords``,
    axis → index, stands in for a live mesh's own).  A view of ``t``."""
    local = local_shape(t.shape, spec, mesh)
    for d, e in enumerate(spec):
        axes = _dim_axes(e)
        if not axes or local[d] == t.shape[d]:
            continue
        if coords is None:
            i = mesh.coordinate(axes)
        else:
            i = 0
            for a in axes:
                i = i * mesh.shape[a] + coords[a]
        t = t.narrow(d, i * local[d], local[d])
    return t


def gather_tensor(t, spec: Sequence, mesh):
    """The global tensor from every rank's shard ``t``: all-gathered over
    each split dim's axes in coordinate order.  On an abstract mesh, a
    meta tensor of the global shape (shapes only)."""
    if not mesh.live:
        shape = [n * _axis_size(mesh, _dim_axes(e))
                 for n, e in zip(t.shape, spec)]
        return t.new_empty(shape + list(t.shape[len(spec):]),
                           device="meta")
    for d, e in enumerate(spec):
        axes = tuple(a for a in _dim_axes(e) if mesh.shape[a] > 1)
        if not axes:
            continue
        group = mesh.group(axes)
        t = t.contiguous()
        parts = [t.new_empty(t.shape) for _ in range(
            dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        t = torch.cat(parts, d)
    return t


def _zip_map(fn, tree, logical):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], logical[k]) for k in tree}
    return fn(tree, logical)


def tree_shardings(param_tree, logical_tree, mesh):
    """A tree of tensors (meta tensors do) and the matching tree of logical
    tuples → a tree of ``NamedSharding``."""
    return _zip_map(
        lambda a, l: named(mesh, resolve_spec(tuple(a.shape), l, mesh)),
        param_tree, logical_tree)


def _batch_axis(mesh, b: int):
    fa = fsdp_axes(mesh)
    if fa and b % _axis_size(mesh, fa) == 0:
        return fa if len(fa) > 1 else fa[0]
    if fa and b % mesh.shape[fa[-1]] == 0:
        return fa[-1]
    return None


def data_spec(mesh, ndim: int, batch_size: int) -> PartitionSpec:
    """Batch-sharded activation/input spec: dim 0 over (pod, data) when
    divisible, else over the inner axis when that divides, rest
    replicated."""
    return P(_batch_axis(mesh, batch_size), *([None] * (ndim - 1)))


def decode_state_specs(cfg, state_tree, mesh):
    """Sharding of the decode state: batch over the data axes; KV heads
    over "model" when divisible, else head_dim; SSM heads over "model".
    ``state_tree`` is ``Model.init_decode_state``'s dict (meta tensors
    do); its ``index`` is a host int."""
    model_size = mesh.shape["model"]

    def one(name, arr):
        if name == "index":
            return named(mesh, P())
        shape = tuple(arr.shape)
        if name in ("k", "v"):
            # (U, na, B, Smax, K, hd)
            b = _batch_axis(mesh, shape[2])
            if shape[4] % model_size == 0:
                return named(mesh, P(None, None, b, None, "model", None))
            if shape[5] % model_size == 0:
                return named(mesh, P(None, None, b, None, None, "model"))
            return named(mesh, P(None, None, b, None, None, None))
        if name in ("k_scale", "v_scale"):
            # (U, na, B, Smax, K): the int8 cache's per-position scales
            b = _batch_axis(mesh, shape[2])
            kk = "model" if shape[4] % model_size == 0 else None
            return named(mesh, P(None, None, b, None, kk))
        if name == "ssm_h":
            # (U, ns, B, H, P, N)
            b = _batch_axis(mesh, shape[2])
            h = "model" if shape[3] % model_size == 0 else None
            return named(mesh, P(None, None, b, h, None, None))
        if name == "conv":
            # (U, ns, B, cw-1, d_inner)
            b = _batch_axis(mesh, shape[2])
            di = "model" if shape[4] % model_size == 0 else None
            return named(mesh, P(None, None, b, None, di))
        if name in ("cross_k", "cross_v"):
            # (U, B, Sm, H, hd)
            b = _batch_axis(mesh, shape[1])
            h = "model" if shape[3] % model_size == 0 else None
            return named(mesh, P(None, b, None, h, None))
        return named(mesh, P(*([None] * len(shape))))

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return one(name, tree)

    return walk(state_tree, None)
