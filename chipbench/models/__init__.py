"""Model files: the canonical padded arrays of a forest, made from a
configuration's fixed seed by the maker its ``model`` key names
(``models/<model>.py``: ``make(cfg) -> dict``) and kept in
``chipbench/cache/`` so that only a checkout's first run makes them.

A model file holds, for T trees of at most L leaves and N = L - 1
internal nodes: ``feature`` (T, N) int32 (-1 pads), ``threshold`` (T, N)
float32, ``left``/``right`` (T, N) int32 (>= 0 an internal node in
preorder, < 0 the leaf -(x+1), leaves numbered left to right),
``leaf_lo``/``leaf_mid``/``leaf_hi`` (T, N) int32 (node n's subtree
holds leaves [lo, hi), its left subtree [lo, mid)), ``leaf_value``
(T, L, C) float32, ``n_nodes`` and ``n_leaves`` (T,) int32, and scalars
``max_depth``, ``n_features``, ``n_classes``; a maker may add more
(a cascade's gate threshold)."""
from __future__ import annotations

import hashlib
import importlib
import os
from pathlib import Path

import numpy as np


def load(cfg: dict, cfg_path: Path, root: Path) -> dict:
    """The model file of ``cfg``, from the cache or made and cached."""
    h = hashlib.sha256(Path(cfg_path).read_bytes())
    base = Path(__file__).resolve().parents[1]
    for src in sorted(p for d in ("models", "datasets", "reference")
                      for p in (base / d).glob("*.py")) + \
            [base / "trainer.py"]:
        h.update(src.read_bytes())       # changed generator code makes anew
    path = Path(root) / "chipbench" / "cache" / \
        f"{Path(cfg_path).stem}-{h.hexdigest()[:16]}.npz"
    if path.exists():
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    model = importlib.import_module(f"{__name__}.{cfg['model']}").make(cfg)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.partial.npz")
    np.savez(tmp, **model)
    os.replace(tmp, path)            # a run cut short leaves no half file
    return model


def canonical(roots: list, n_features: int, n_classes: int) -> dict:
    """Trees of ``trainer.Node``s → the model file's arrays."""
    T = len(roots)
    per_tree = [_flatten(r) for r in roots]
    L = max(2, max(len(leaves) for _, leaves, _ in per_tree))
    N = L - 1
    out = {k: np.zeros((T, N), dtype=np.int32) for k in
           ("left", "right", "leaf_lo", "leaf_mid", "leaf_hi")}
    out["feature"] = np.full((T, N), -1, dtype=np.int32)
    out["threshold"] = np.zeros((T, N), dtype=np.float32)
    out["leaf_value"] = np.zeros((T, L, n_classes), dtype=np.float32)
    out["n_nodes"] = np.zeros(T, dtype=np.int32)
    out["n_leaves"] = np.zeros(T, dtype=np.int32)
    depth = 1
    for t, (nodes, leaves, d) in enumerate(per_tree):
        depth = max(depth, d)
        out["n_nodes"][t], out["n_leaves"][t] = len(nodes), len(leaves)
        for j, value in enumerate(leaves):
            out["leaf_value"][t, j] = value
        for i, (f, thr, lcode, rcode, lo, mid, hi) in enumerate(nodes):
            out["feature"][t, i], out["threshold"][t, i] = f, thr
            out["left"][t, i], out["right"][t, i] = lcode, rcode
            out["leaf_lo"][t, i], out["leaf_mid"][t, i], \
                out["leaf_hi"][t, i] = lo, mid, hi
    out.update(max_depth=np.int64(depth), n_features=np.int64(n_features),
               n_classes=np.int64(n_classes))
    return out


def _flatten(root):
    """One tree → (nodes in preorder as (feature, threshold, left code,
    right code, lo, mid, hi), leaf values left to right, depth)."""
    nodes, leaves = [], []

    def walk(nd, depth):
        if nd.is_leaf:
            leaves.append(nd.value)
            j = len(leaves) - 1
            return -(j + 1), j, j + 1, depth
        i = len(nodes)
        nodes.append(None)
        lcode, lo, mid, dl = walk(nd.left, depth + 1)
        rcode, _, hi, dr = walk(nd.right, depth + 1)
        nodes[i] = (nd.feature, nd.threshold, lcode, rcode, lo, mid, hi)
        return i, lo, hi, max(dl, dr)

    _, _, _, depth = walk(root, 1)
    return nodes, leaves, depth
