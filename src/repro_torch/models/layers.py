"""Shared layers — the torch counterpart of ``repro.models.layers``:
the seeded param factory, norms, RoPE, MLPs and embeddings.  Params are
nested dicts of tensors with the reference's names and shapes, so a tree
of the reference's weights (as numpy) carries across leaf for leaf
(``models/convert.py``).

``SpecMaker`` (the logical sharding axes) waits for the sharding slice
(ROADMAP Queue A 12)."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------- #
# Param factory
# --------------------------------------------------------------------------- #
class RealMaker:
    """Creates initialized tensors on ``device`` from a seeded
    ``torch.Generator``.  The reference's init rules: ``fan_in`` is
    normal(0, 1/sqrt(fan_in)) with fan-in the product of all dims but the
    last, ``embed`` normal(0, 1), ``zeros`` and ``ones``.  The draws are
    torch's, not ``jax.random``'s: a test that needs the same weights in
    both packages makes them in one and carries them across
    (``models/convert.py``)."""

    def __init__(self, seed: int, dtype=torch.float32, device="cpu"):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def __call__(self, shape: Sequence[int], logical: Sequence[str],
                 init: str = "fan_in") -> torch.Tensor:
        shape = tuple(shape)
        kw = dict(dtype=self.dtype, device=self.device)
        if init == "zeros":
            return torch.zeros(shape, **kw)
        if init == "ones":
            return torch.ones(shape, **kw)
        if init == "embed":
            scale = 1.0
        elif init == "fan_in":
            fan = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
            scale = fan ** -0.5
        else:
            raise ValueError(init)
        return torch.randn(shape, generator=self.gen, **kw) * scale


class ShapeMaker:
    """Returns the shape instead of a tensor (same call sites): the tree
    ``models/convert.py`` checks a converted tree against."""

    def __call__(self, shape, logical, init="fan_in"):
        assert len(shape) == len(logical), (shape, logical)
        return tuple(shape)


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """In f32, cast back to x's dtype, and only then scaled by ``w``
    (``layers.py:58-62``): in bf16 the order decides the rounding."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * w


# --------------------------------------------------------------------------- #
# Rotary position embedding
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, hd), positions (..., S) int.  Rotate-half on the two
    halves of hd, in f32, cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                     # (hd/2,)
    ang = positions[..., None].float() * freqs                  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                          # (...,S,1,hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #
def make_mlp_params(mk, d_model: int, d_ff: int, kind: str,
                    extra_axes: tuple = ()) -> dict:
    ea = tuple(extra_axes)
    pre = ("layers",) * len(ea)
    if kind == "swiglu":
        return {
            "w_gate": mk(ea + (d_model, d_ff), pre + ("embed", "ff")),
            "w_up": mk(ea + (d_model, d_ff), pre + ("embed", "ff")),
            "w_down": mk(ea + (d_ff, d_model), pre + ("ff", "embed")),
        }
    return {
        "w_up": mk(ea + (d_model, d_ff), pre + ("embed", "ff")),
        "w_down": mk(ea + (d_ff, d_model), pre + ("ff", "embed")),
    }


def mlp_forward(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation; torch's to erf
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


# --------------------------------------------------------------------------- #
# Embedding / head
# --------------------------------------------------------------------------- #
def make_embed_params(mk, vocab: int, d_model: int) -> dict:
    return {
        "embedding": mk((vocab, d_model), ("vocab", "embed"), init="embed"),
        "lm_head": mk((d_model, vocab), ("embed", "vocab")),
        "final_norm": mk((d_model,), ("embed",), init="ones"),
    }
