"""Adam/AdamW with optional int8 moments — the port's counterpart of
``repro.distributed.optimizer``, step for step the reference's arithmetic
in f32.

The int8 state quantizes each moment row-wise (one f32 scale per row of
the last axis): ``q = round(x / s)`` with ``s = max(amax, 1e-12) / 127``.
On a mesh a leaf whose last axis is split takes the row's amax over the
ranks that split it (``update``'s ``row_groups``), so every rank's bits
are one device's.
The second moment is stored in the sqrt domain (``_q8_sqrt``): linear int8
would round small entries of a row to exactly 0, and m / (sqrt(0) + eps)
diverges.  With int8 moments the update ratio is clipped to ±10.  The
state costs ~2.03 bytes a parameter against 8 for f32 moments.

Trees are nested dicts of tensors; every walk over them is in
``jax.tree.flatten``'s order (``models.model.tree_flatten``), so a state
crosses to and from the reference's checkpoints leaf for leaf.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.model import tree_flatten, tree_map, tree_unflatten
from .collectives import all_reduce_max


@dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    state_dtype: str = "f32"        # "f32" | "int8"


# ---------------------------------------------------------------- int8 state
def _q8(x: torch.Tensor, group=None):
    """Row-wise symmetric int8 quantization: (q, scale).  A 0-d x scales
    by |x|, not |x| / 127, as the reference's 0-d branch does (ROADMAP
    Queue C): its q is 0 or ±127.  ``group``: the ranks that hold the
    rest of each row."""
    if x.dim() == 0:
        scale = torch.clamp(x.abs(), min=1e-12)
        return torch.round(x / scale * 127).to(torch.int8), scale
    amax = all_reduce_max(x.abs().amax(dim=-1, keepdim=True), group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return torch.round(x / scale).to(torch.int8), scale


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _q8_sqrt(x: torch.Tensor, group=None):
    """int8 of sqrt(max(x, 0)): half the dynamic range of x, so the small
    entries of a row keep at least one quantization level."""
    return _q8(torch.sqrt(torch.clamp(x, min=0.0)), group)


def _dq8_sqrt(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    r = _dq8(q, scale)
    return r * r


def is_q8(x) -> bool:
    """An int8 moment leaf: ``{"q": int8, "scale": f32}``."""
    return isinstance(x, dict) and set(x) == {"q", "scale"}


class Adam:
    def __init__(self, cfg: AdamConfig):
        if cfg.state_dtype not in ("f32", "int8"):
            raise ValueError(f"state_dtype {cfg.state_dtype!r} not in "
                             f"('f32', 'int8')")
        self.cfg = cfg

    def init(self, params) -> dict:
        """{"m", "v", "step"}: zero moments of ``params``' tree on each
        leaf's device, ``step`` a 0-d int32 tensor."""
        def zeros_like_state(p):
            if self.cfg.state_dtype == "int8":
                return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                         device=p.device),
                        "scale": torch.zeros(
                            p.shape[:-1] + (1,) if p.dim() else (),
                            dtype=torch.float32, device=p.device)}
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        device = tree_flatten(params)[0][0].device
        return {"m": tree_map(zeros_like_state, params),
                "v": tree_map(zeros_like_state, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def _load(self, s, sqrt_domain: bool = False):
        if self.cfg.state_dtype == "int8":
            return (_dq8_sqrt if sqrt_domain else _dq8)(s["q"], s["scale"])
        return s

    def _store(self, x, sqrt_domain: bool = False, group=None):
        if self.cfg.state_dtype == "int8":
            q, scale = (_q8_sqrt if sqrt_domain else _q8)(x, group)
            return {"q": q, "scale": scale}
        return x

    def update(self, grads, state, params, row_groups=None):
        """(new params, new state); nothing is changed in place.
        ``row_groups``: per leaf in ``tree_flatten``'s order, the process
        group over which its last axis is split, or None."""
        cfg = self.cfg
        step = state["step"] + 1
        # the bias corrections in f32, as b ** step.astype(f32) is
        stepf = step.float()
        c1 = 1.0 - torch.full_like(stepf, cfg.b1) ** stepf
        c2 = 1.0 - torch.full_like(stepf, cfg.b2) ** stepf

        def upd(p, g, m_s, v_s, group):
            g = g.float()
            m = cfg.b1 * self._load(m_s) + (1 - cfg.b1) * g
            v = cfg.b2 * self._load(v_s, sqrt_domain=True) \
                + (1 - cfg.b2) * g * g
            mh, vh = m / c1, v / c2
            ratio = mh / (torch.sqrt(vh) + cfg.eps)
            if cfg.state_dtype == "int8":
                # Adam's ratio is ~±1 at convergence: |ratio| >> 1 only
                # comes from a second moment the quantization corrupted
                ratio = torch.clamp(ratio, -10.0, 10.0)
            delta = cfg.lr * ratio
            if cfg.weight_decay:
                delta = delta + cfg.lr * cfg.weight_decay * p
            return ((p - delta).to(p.dtype), self._store(m, group=group),
                    self._store(v, sqrt_domain=True, group=group))

        flat_p, treedef = tree_flatten(params)
        flat_g = tree_flatten(grads)[0]
        flat_m = tree_flatten(state["m"], is_leaf=is_q8)[0]
        flat_v = tree_flatten(state["v"], is_leaf=is_q8)[0]
        groups = row_groups or [None] * len(flat_p)
        out = [upd(*a) for a in zip(flat_p, flat_g, flat_m, flat_v, groups)]
        new_p, new_m, new_v = (tree_unflatten(treedef, [o[i] for o in out])
                               for i in range(3))
        return new_p, {"m": new_m, "v": new_v, "step": step}

    def state_logical_specs(self, logical_tree):
        """Optimizer-state sharding mirrors the param sharding: the tree of
        logical-axis tuples for ``init``'s state."""
        if self.cfg.state_dtype == "int8":
            mom = tree_map(lambda l: {"q": l, "scale": l}, logical_tree)
        else:
            mom = logical_tree
        return {"m": mom, "v": mom, "step": ()}
