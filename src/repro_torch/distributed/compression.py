"""Int8 error-feedback gradient compression — the port's counterpart of
``repro.distributed.compression``.

Before the data-parallel all-reduce each worker quantizes its gradient to
int8 with one scale per row (the last axis), keeps the quantization error
as a residual added to the next step's gradient (error feedback), and
all-reduces the int8 payload.  ``compress``/``decompress``/``compress_tree``
model the lossy codec on one device, bit for bit the reference's: the scale
is max(amax, 1e-12) / 127 in f32 and the quotient rounds half to even, as
``jnp.round`` does.  ``compressed_psum`` is the codec inside the
all-reduce over a mesh axis: one scale shared by every rank (an all-reduce
MAX), the int8 payload summed as int32 (an all-reduce SUM), both exact,
so it gives the reference's bits; ``compressed_psum_reference`` is the
same arithmetic over every rank's inputs in one process.

The trainer runs the codec on the global gradient; on a mesh each rank
holds its shard of it, and a leaf whose last axis is split takes each
row's amax over the ranks that split it (``compress_tree``'s
``row_groups``), so the bits are one device's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..launch.mesh import current_mesh
from ..models.model import tree_flatten, tree_map, tree_unflatten
from .collectives import all_reduce_max


def compress(g: torch.Tensor, residual: torch.Tensor, group=None):
    """(grad, residual) → (q int8, scale f32, new residual f32).
    ``group``: the ranks that hold the rest of each row."""
    x = g.float() + residual
    if x.dim() == 0:
        scale = torch.clamp(x.abs(), min=1e-12) / 127.0
    else:
        amax = all_reduce_max(x.abs().amax(dim=-1, keepdim=True), group)
        scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale, x - decompress(q, scale)


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, residuals, row_groups=None):
    """(grads as seen after the all-reduce, dequantized; new residuals),
    both trees of ``grads``' structure.  ``row_groups`` as
    ``Adam.update``'s."""
    flat_g, treedef = tree_flatten(grads)
    flat_r = tree_flatten(residuals)[0]
    groups = row_groups or [None] * len(flat_g)
    deqs, res = [], []
    for g, r, group in zip(flat_g, flat_r, groups):
        q, s, nr = compress(g, r, group)
        deqs.append(decompress(q, s))
        res.append(nr)
    return tree_unflatten(treedef, deqs), tree_unflatten(treedef, res)


def init_residuals(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def _psum_scale(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x.abs().amax(), min=1e-12) / 127.0


def _psum_q(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int32)


def compressed_psum(g: torch.Tensor, residual: torch.Tensor, axis_name):
    """Inside ``with mesh:``, over the ranks of ``axis_name`` (a mesh axis
    or a tuple of axes): int8-quantize g + residual with the ranks' largest
    scale, sum the integers, dequantize → (the ranks' mean as the codec
    sees it, the new residual)."""
    mesh = current_mesh()
    if mesh is None:
        raise ValueError(f"compressed_psum: axis {axis_name!r} is unbound; "
                         f"call it inside `with mesh:`")
    group = mesh.group(axis_name)
    x = g.float() + residual
    scale = _psum_scale(x)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = _psum_q(x, scale)
    deq_local = q.float() * scale
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    return q.float() * scale / n, x - deq_local


def compressed_psum_reference(grads, residuals):
    """``compressed_psum`` over ranks that hold ``grads[i]``,
    ``residuals[i]``, in one process: (the output every rank gets, each
    rank's new residual)."""
    xs = [g.float() + r for g, r in zip(grads, residuals)]
    scale = torch.stack([_psum_scale(x) for x in xs]).amax()
    qs = [_psum_q(x, scale) for x in xs]
    total = torch.stack(qs).sum(dim=0, dtype=torch.int32)
    return (total.float() * scale / len(xs),
            [x - q.float() * scale for x, q in zip(xs, qs)])
