"""Carry a reference LM's weights across: the reference's parameter tree
as numpy arrays (``jax.tree.map(np.asarray, params)``) → the port's tree
of tensors on a device, in a dtype; and a reference trainer's whole state
(``train_state_from_reference``: params, Adam moments in f32 or int8,
step, compression residuals), so both packages start a step from one
state.

The port never imports ``repro``, so the tree arrives as nested dicts of
numpy arrays.  Every leaf's path and shape is checked against
``make_params(cfg, ShapeMaker())``, and its dtype against the reference's
f32 masters, before anything is copied, and a
missing, extra or misshapen leaf raises, as ``core/convert.py`` does for
forests.

With a live ``mesh`` each function returns this rank's shards, as the
sharding rules place every leaf (``distributed/sharding.py``): what a
``Trainer(mesh=)`` stores.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..distributed.sharding import resolve_spec, shard_tensor
from .config import ArchConfig
from .layers import ShapeMaker, SpecMaker
from .model import make_params, tree_map

SOURCE_DTYPES = (np.float32,)      # the reference's master params


def _leaves(tree, prefix=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _local(t: torch.Tensor, logical, mesh) -> torch.Tensor:
    """``t``, or with a mesh this rank's shard of it (a copy)."""
    if mesh is None:
        return t
    return shard_tensor(t, resolve_spec(tuple(t.shape), logical, mesh),
                        mesh).clone()


def params_from_reference(tree: Mapping, cfg: ArchConfig, *, device="cpu",
                          dtype=torch.float32, mesh=None) -> dict:
    """The port's param tree for ``cfg`` from a reference tree of numpy
    arrays: every leaf checked, then copied to ``device`` in ``dtype``
    (with a ``mesh``, this rank's shard of it)."""
    want = dict(_leaves(make_params(cfg, ShapeMaker())))
    logical = dict(_leaves(make_params(cfg, SpecMaker())))
    got = dict(_leaves(tree))
    missing = sorted("/".join(p) for p in want.keys() - got.keys())
    extra = sorted("/".join(p) for p in got.keys() - want.keys())
    if missing or extra:
        raise ValueError(f"param tree for {cfg.name}: missing {missing}, "
                         f"unexpected {extra}")
    for path, a in got.items():
        name = "/".join(path)
        if not isinstance(a, np.ndarray):
            raise TypeError(f"{name}: expected a numpy array, got "
                            f"{type(a).__name__}")
        if a.dtype not in [np.dtype(d) for d in SOURCE_DTYPES]:
            raise TypeError(f"{name}: dtype {a.dtype}, expected "
                            f"{[np.dtype(d).name for d in SOURCE_DTYPES]}")
        shape = want[path]
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
    out: dict = {}
    for path, a in got.items():
        t = _local(torch.from_numpy(np.array(a)), logical[path], mesh)
        _set(out, path, t.to(device=device, dtype=dtype))
    return out


def _get(tree: Mapping, path: tuple, what: str):
    for k in path:
        if not isinstance(tree, Mapping) or k not in tree:
            raise ValueError(f"{what}: missing {'/'.join(path)}")
        tree = tree[k]
    return tree


def _array(a, name: str, dtype, shape) -> torch.Tensor:
    if not isinstance(a, (np.ndarray, np.generic)):
        raise TypeError(f"{name}: expected a numpy array, got "
                        f"{type(a).__name__}")
    a = np.asarray(a)
    if a.dtype != np.dtype(dtype) or a.shape != tuple(shape):
        raise ValueError(f"{name}: {a.dtype}{list(a.shape)}, expected "
                         f"{np.dtype(dtype).name}{list(shape)}")
    return torch.from_numpy(np.array(a))


def train_state_from_reference(tree: Mapping, cfg: ArchConfig, *,
                               device="cpu", mesh=None) -> dict:
    """The port's train state from a reference trainer's ``state_tree()``
    as numpy: ``{"params", "opt": {"m", "v", "step"}, "residuals"}``.

    Params go through ``params_from_reference``; with a ``mesh`` every
    leaf is this rank's shard, each moment's values and row scales as
    the rules place them.  Each moment leaf is an
    f32 array of its param's shape, or an int8 moment ``{"q": int8 of the
    param's shape, "scale": f32 of its shape[:-1] + (1,)}``, one kind for
    all; ``step`` an int32 scalar; each residual an f32 array of its
    param's shape (compressed gradients) or an f32 scalar zero, one kind
    for all.  Anything else raises."""
    if set(tree) != {"params", "opt", "residuals"} or \
            set(tree["opt"]) != {"m", "v", "step"}:
        raise ValueError("a train state is {'params', 'opt': {'m', 'v', "
                         "'step'}, 'residuals'}")
    shapes = dict(_leaves(make_params(cfg, ShapeMaker())))
    logical = dict(_leaves(make_params(cfg, SpecMaker())))
    out = {"params": params_from_reference(tree["params"], cfg,
                                           device=device, mesh=mesh),
           "opt": {}, "residuals": {}}
    kinds: dict = {"moments": set(), "residuals": set()}
    for part in ("m", "v", "residuals"):
        src = tree["residuals"] if part == "residuals" else tree["opt"][part]
        dst = out["residuals"] if part == "residuals" else \
            out["opt"].setdefault(part, {})
        used = 0
        for path, shape in shapes.items():
            name = f"{part}/{'/'.join(path)}"
            a = _get(src, path, part)
            if part == "residuals":
                kind = "full" if shape and np.shape(a) == shape else "zero"
                t = _array(a, name, np.float32,
                           shape if kind == "full" else ())
                if kind == "full":
                    t = _local(t, logical[path], mesh)
            elif isinstance(a, Mapping):
                kind = "int8"
                if set(a) != {"q", "scale"}:
                    raise ValueError(f"{name}: an int8 moment is "
                                     f"{{'q', 'scale'}}, got {sorted(a)}")
                t = {"q": _array(a["q"], name + "/q", np.int8, shape),
                     "scale": _array(a["scale"], name + "/scale",
                                     np.float32, shape[:-1] + (1,))}
                t = {k: _local(v, logical[path], mesh) for k, v in t.items()}
            else:
                kind = "f32"
                t = _local(_array(a, name, np.float32, shape),
                           logical[path], mesh)
            kinds["residuals" if part == "residuals" else "moments"] \
                .add(kind)
            used += 2 if kind == "int8" else 1
            _set(dst, path, t)
        n = sum(1 for _ in _leaves(src))
        if n != used:
            raise ValueError(f"{part}: {n} leaves, expected {used}")
    for what, k in kinds.items():
        if len(k) > 1:
            raise ValueError(f"{what} mix kinds {sorted(k)}")
    out["opt"]["step"] = _array(tree["opt"]["step"], "opt/step", np.int32,
                                ())
    return tree_map(lambda t: t.to(device), out)
