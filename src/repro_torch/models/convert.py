"""Carry a reference LM's weights across: the reference's parameter tree
as numpy arrays (``jax.tree.map(np.asarray, params)``) → the port's tree
of tensors on a device, in a dtype.

The port never imports ``repro``, so the tree arrives as nested dicts of
numpy arrays.  Every leaf's path and shape is checked against
``make_params(cfg, ShapeMaker())``, and its dtype against the reference's
f32 masters, before anything is copied, and a
missing, extra or misshapen leaf raises, as ``core/convert.py`` does for
forests.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import ArchConfig
from .layers import ShapeMaker
from .model import make_params

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


def params_from_reference(tree: Mapping, cfg: ArchConfig, *, device="cpu",
                          dtype=torch.float32) -> dict:
    """The port's param tree for ``cfg`` from a reference tree of numpy
    arrays: every leaf checked, then copied to ``device`` in ``dtype``."""
    want = dict(_leaves(make_params(cfg, ShapeMaker())))
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
        _set(out, path, torch.from_numpy(np.array(a)).to(device=device,
                                                          dtype=dtype))
    return out
