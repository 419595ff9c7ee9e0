"""Carry a reference forest across: ``repro.core.Forest`` fields → the
port's ``Forest``.

The port never imports ``repro``, so the reference IR arrives as a plain
mapping of numpy arrays and scalars (``vars(ref_forest)``).  Every field is
checked for dtype and shape before the port's IR is built, so both
packages traverse the identical forest.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from .forest import Forest

_INT_SCALARS = ("n_trees", "n_leaves", "n_classes", "n_features", "max_depth")
# node arrays: (T, L-1) int32
_NODE_FIELDS = ("feature", "left", "right", "leaf_lo", "leaf_mid", "leaf_hi")
_THRESHOLD_DTYPES = (np.float32, np.int32, np.int16, np.int8)
_LEAF_DTYPES = (np.float32, np.int32, np.int16)
_REQUIRED = frozenset(_INT_SCALARS + _NODE_FIELDS + (
    "threshold", "leaf_value", "n_nodes", "n_leaves_per_tree"))
_OPTIONAL = {"quant_scale": None, "quant_bits": None, "leaf_scale": 1.0,
             "feat_lo": None, "feat_hi": None, "feat_map": None,
             "n_features_src": None, "int_accum": False, "flint": False,
             "leaf_err_bound": None}


def _array(fields: Mapping, name: str, shape: tuple, dtypes) -> np.ndarray:
    a = fields[name]
    if not isinstance(a, np.ndarray):
        raise TypeError(f"{name}: expected a numpy array, got "
                        f"{type(a).__name__}")
    if a.dtype not in [np.dtype(d) for d in dtypes]:
        raise TypeError(f"{name}: dtype {a.dtype} not in "
                        f"{[np.dtype(d).name for d in dtypes]}")
    if a.shape != shape:
        raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
    return a.copy()


def forest_from_reference(fields: Mapping[str, object]) -> Forest:
    """Build the port's ``Forest`` from a reference forest's fields."""
    unknown = sorted(set(fields) - _REQUIRED - set(_OPTIONAL))
    if unknown:
        raise ValueError(f"unknown Forest fields {unknown}")
    missing = sorted(_REQUIRED - set(fields))
    if missing:
        raise ValueError(f"missing Forest fields {missing}")

    scalars = {k: int(fields[k]) for k in _INT_SCALARS}
    T, L = scalars["n_trees"], scalars["n_leaves"]
    C, d = scalars["n_classes"], scalars["n_features"]
    nodes = {k: _array(fields, k, (T, L - 1), (np.int32,))
             for k in _NODE_FIELDS}
    threshold = _array(fields, "threshold", (T, L - 1), _THRESHOLD_DTYPES)
    leaf_value = _array(fields, "leaf_value", (T, L, C), _LEAF_DTYPES)
    counts = {k: _array(fields, k, (T,), (np.int32,))
              for k in ("n_nodes", "n_leaves_per_tree")}

    opt = {k: fields.get(k, default) for k, default in _OPTIONAL.items()}
    for k in ("feat_lo", "feat_hi"):
        if opt[k] is not None:
            opt[k] = _array(fields, k, (d,), (np.float64,))
    if opt["feat_map"] is not None:
        opt["feat_map"] = _array(fields, "feat_map", (d,),
                                 (np.int32, np.int64))
    for k in ("quant_scale", "leaf_scale", "leaf_err_bound"):
        if opt[k] is not None:
            opt[k] = float(opt[k])
    for k in ("quant_bits", "n_features_src"):
        if opt[k] is not None:
            opt[k] = int(opt[k])
    opt["int_accum"] = bool(opt["int_accum"])
    opt["flint"] = bool(opt["flint"])
    return Forest(**scalars, **nodes, threshold=threshold,
                  leaf_value=leaf_value, **counts, **opt)
