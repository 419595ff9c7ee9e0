"""Activation-sharding policy — the port's counterpart of
``repro.models.act_sharding``.

The reference pins the batch dim of activations at loop-carry boundaries
to the data axes of the ambient mesh (``with_sharding_constraint``),
because XLA's propagation through ``while`` loops loses it.  The policy
(which axes, their sizes, the divisibility fallbacks) is kept here bit for
bit, and ``models.attention._attn_shard_mode`` reads it.

``constrain_batch``, ``constrain`` and ``constrain_tree_batch`` return
their input itself.  On the trainer's mesh (``launch/train.py``) each
rank's activations already are its batch shard, the layout the reference
asks XLA to pin, and the "model" splits they name are the explicit
sequence- and tensor-parallel exchanges of ``models/model.py``.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Optional, Sequence

_POLICY: dict = {"batch_axes": None, "axis_sizes": {}}


def set_policy(batch_axes: Optional[Sequence[str]],
               axis_sizes: Optional[dict] = None) -> None:
    """batch_axes: mesh axes the batch dim is sharded over (e.g. ("data",)
    or ("pod", "data")); None disables all constraints.
    axis_sizes: mesh axis→size, used for divisibility checks."""
    _POLICY["batch_axes"] = tuple(batch_axes) if batch_axes else None
    _POLICY["axis_sizes"] = dict(axis_sizes or {})


def policy_from_mesh(mesh) -> None:
    if os.environ.get("REPRO_NO_ACT_SHARDING") == "1":
        # the reference's ablation hook
        set_policy(None)
        return
    axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    set_policy(axes or None, {a: mesh.shape[a] for a in mesh.axis_names})


def clear_policy() -> None:
    set_policy(None)


@contextmanager
def policy(batch_axes, axis_sizes=None):
    old = dict(_POLICY)
    set_policy(batch_axes, axis_sizes)
    try:
        yield
    finally:
        _POLICY.update(old)


def _batch_axes_for(n: int):
    """Largest prefix/suffix of the configured axes that divides n."""
    axes = _POLICY["batch_axes"]
    if not axes:
        return None
    sizes = _POLICY["axis_sizes"]
    total = 1
    for a in axes:
        total *= sizes.get(a, 1)
    if total > 1 and n % total == 0:
        return axes
    # fall back to the innermost axis alone (e.g. global_batch 32 on a
    # 2×16 pod×data factorisation)
    last = axes[-1]
    if sizes.get(last, 1) > 1 and n % sizes[last] == 0:
        return (last,)
    return None


def model_axis_size() -> int:
    if _POLICY["batch_axes"] is None:
        return 1
    return _POLICY["axis_sizes"].get("model", 1)


def constrain_batch(x, dim: int = 0):
    """The reference pins ``x``'s ``dim`` to the data axes; here ``x``."""
    return x


def constrain(x, spec_map: dict):
    """The reference pins dims to the model or data axes; here ``x``."""
    return x


def constrain_tree_batch(tree, dim: int = 0):
    return tree
