"""Int8 error-feedback gradient compression — the port's counterpart of
``repro.distributed.compression``.

Before the data-parallel all-reduce each worker quantizes its gradient to
int8 with one scale per row (the last axis), keeps the quantization error
as a residual added to the next step's gradient (error feedback), and
all-reduces the int8 payload.  ``compress``/``decompress``/``compress_tree``
model the lossy codec on one device, bit for bit the reference's: the scale
is max(amax, 1e-12) / 127 in f32 and the quotient rounds half to even, as
``jnp.round`` does.  ``compressed_psum``, the codec inside the all-reduce,
needs a data-parallel axis and waits for ROADMAP Queue A 12.6.
"""
from __future__ import annotations

import torch

from ..models.attention import waits
from ..models.model import tree_flatten, tree_map, tree_unflatten


def compress(g: torch.Tensor, residual: torch.Tensor):
    """(grad, residual) → (q int8, scale f32, new residual f32)."""
    x = g.float() + residual
    if x.dim() == 0:
        scale = torch.clamp(x.abs(), min=1e-12) / 127.0
    else:
        scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True),
                            min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale, x - decompress(q, scale)


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, residuals):
    """(grads as seen after the all-reduce, dequantized; new residuals),
    both trees of ``grads``' structure."""
    flat_g, treedef = tree_flatten(grads)
    flat_r = tree_flatten(residuals)[0]
    deqs, res = [], []
    for g, r in zip(flat_g, flat_r):
        q, s, nr = compress(g, r)
        deqs.append(decompress(q, s))
        res.append(nr)
    return tree_unflatten(treedef, deqs), tree_unflatten(treedef, res)


def init_residuals(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compressed_psum(g, residual, axis_name: str):
    waits("compressed_psum (the data-parallel all-reduce)", "12.6")
