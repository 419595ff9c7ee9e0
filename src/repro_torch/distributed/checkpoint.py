"""Fault-tolerant checkpoints — the port's counterpart of
``repro.distributed.checkpoint``, on the same layout, so a checkpoint
written by either package restores in the other:

    <dir>/step_<N>/
        manifest.msgpack   — step, tree description, shapes, dtypes, CRCs
        arr_<i>.npy        — one file per leaf, in jax.tree.flatten's order
    <dir>/LATEST           — names the newest complete step

* atomic publish: a step is written to ``step_<N>.tmp`` and renamed, and
  ``LATEST`` is replaced through ``LATEST.tmp``: a crash mid-save never
  corrupts the newest checkpoint;
* integrity: a CRC32 of each leaf's file, checked on restore.

The port needs no ``msgpack`` (a GPU host may lack it), so the manifest
goes through a private codec for the subset it uses (maps with str keys,
str, int, lists), byte for byte what ``msgpack.packb`` writes.  ``treedef`` is written in JAX's
notation (``PyTreeDef({'a': *, ...})``), equal to the reference's for the
trees of dicts a trainer saves; neither package's ``restore`` reads it.
"""
from __future__ import annotations

import os
import shutil
import zlib
from typing import Any, Optional

import numpy as np
import torch

from ..models.model import tree_flatten, tree_unflatten


# --------------------------------------------------------------- msgpack
def _packb(obj) -> bytes:
    """``msgpack.packb`` of maps with str keys, lists, str and int."""
    out = bytearray()

    def head(n, fix, fix_max, codes):
        if n <= fix_max:
            out.append(fix | n)
            return
        for width, code in codes:
            if n < 1 << (8 * width):
                out.append(code)
                out.extend(n.to_bytes(width, "big"))
                return
        raise ValueError(f"length {n} too large for msgpack")

    def put(x):
        if isinstance(x, bool) or x is None:
            raise TypeError(f"the manifest codec takes no {x!r}")
        if isinstance(x, int):
            if 0 <= x < 128:
                out.append(x)
            elif x >= 0:
                for width, code in ((1, 0xcc), (2, 0xcd), (4, 0xce),
                                    (8, 0xcf)):
                    if x < 1 << (8 * width):
                        out.append(code)
                        out.extend(x.to_bytes(width, "big"))
                        return
                raise ValueError(f"int {x} too large for msgpack")
            elif x >= -32:
                out.append(x & 0xff)
            else:
                for width, code in ((1, 0xd0), (2, 0xd1), (4, 0xd2),
                                    (8, 0xd3)):
                    if x >= -(1 << (8 * width - 1)):
                        out.append(code)
                        out.extend(x.to_bytes(width, "big", signed=True))
                        return
                raise ValueError(f"int {x} too small for msgpack")
        elif isinstance(x, str):
            b = x.encode("utf-8")
            head(len(b), 0xa0, 31, ((1, 0xd9), (2, 0xda), (4, 0xdb)))
            out.extend(b)
        elif isinstance(x, (list, tuple)):
            head(len(x), 0x90, 15, ((2, 0xdc), (4, 0xdd)))
            for v in x:
                put(v)
        elif isinstance(x, dict):
            head(len(x), 0x80, 15, ((2, 0xde), (4, 0xdf)))
            for k, v in x.items():
                if not isinstance(k, str):
                    raise TypeError(f"map key {k!r} is not a str")
                put(k)
                put(v)
        else:
            raise TypeError(f"the manifest codec takes no "
                            f"{type(x).__name__}")
    put(obj)
    return bytes(out)


def _unpackb(data: bytes):
    """The inverse of ``_packb`` (lists come back as lists, as
    ``msgpack.unpackb`` gives them)."""
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(data):
            raise ValueError("truncated manifest")
        b = data[pos:pos + n]
        pos += n
        return b

    def uint(n):
        return int.from_bytes(take(n), "big")

    def get():
        c = take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return getmap(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [get() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return take(c & 0x1f).decode("utf-8")
        uints = {0xcc: 1, 0xcd: 2, 0xce: 4, 0xcf: 8}
        sints = {0xd0: 1, 0xd1: 2, 0xd2: 4, 0xd3: 8}
        strs = {0xd9: 1, 0xda: 2, 0xdb: 4}
        if c in uints:
            return uint(uints[c])
        if c in sints:
            return int.from_bytes(take(sints[c]), "big", signed=True)
        if c in strs:
            return take(uint(strs[c])).decode("utf-8")
        if c in (0xdc, 0xdd):
            return [get() for _ in range(uint(2 if c == 0xdc else 4))]
        if c in (0xde, 0xdf):
            return getmap(uint(2 if c == 0xde else 4))
        raise ValueError(f"msgpack type byte {c:#04x} is not in the "
                         f"manifest codec")

    def getmap(n):
        return {get(): get() for _ in range(n)}
    obj = get()
    if pos != len(data):
        raise ValueError("trailing bytes after the manifest")
    return obj


def treedef_string(treedef) -> str:
    """A ``tree_flatten`` treedef in JAX's notation:
    ``PyTreeDef({'a': *, 'b': {'c': *}})``."""
    def show(d):
        if isinstance(d, dict):
            return "{" + ", ".join(f"{k!r}: {show(d[k])}"
                                   for k in sorted(d)) + "}"
        return "*"
    return f"PyTreeDef({show(treedef)})"


# ------------------------------------------------------------ checkpoints
def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, step: int, tree: Any) -> str:
    """Write ``tree`` (params, optimizer state, residuals: any tree of
    dicts whose leaves are tensors or arrays) as step ``step``."""
    leaves, treedef = tree_flatten(tree)
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    metas = []
    for i, leaf in enumerate(leaves):
        arr = _host(leaf)
        fn = os.path.join(tmp, f"arr_{i}.npy")
        np.save(fn, arr)
        with open(fn, "rb") as f:
            crc = zlib.crc32(f.read())
        metas.append({"shape": list(arr.shape), "dtype": str(arr.dtype),
                      "crc": crc})
    manifest = {
        "step": step,
        "treedef": treedef_string(treedef),
        "n_leaves": len(leaves),
        "leaves": metas,
    }
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(_packb(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    with open(os.path.join(path, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(path, "LATEST.tmp"), os.path.join(path, "LATEST"))
    return final


def latest_step(path: str) -> Optional[int]:
    latest = os.path.join(path, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(path, name)):
        return None
    return int(name.split("_")[1])


def restore(path: str, target_tree: Any, step: Optional[int] = None,
            device=None) -> tuple[Any, int]:
    """Load into the structure of ``target_tree``: (tree, step).  Each
    leaf goes to ``device``, or else to its target leaf's device (the
    CPU for a target that is no tensor).  A leaf whose CRC or shape
    disagrees raises."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        manifest = _unpackb(f.read())

    t_leaves, treedef = tree_flatten(target_tree)
    if manifest["n_leaves"] != len(t_leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"target {len(t_leaves)}")
    out = []
    for i, (meta, tgt) in enumerate(zip(manifest["leaves"], t_leaves)):
        fn = os.path.join(d, f"arr_{i}.npy")
        with open(fn, "rb") as f:
            crc = zlib.crc32(f.read())
        if crc != meta["crc"]:
            raise IOError(f"CRC mismatch in {fn} (corrupt checkpoint)")
        arr = np.load(fn)
        if list(arr.shape) != list(np.shape(tgt)):
            raise ValueError(f"leaf {i}: ckpt {arr.shape} vs target "
                             f"{tuple(np.shape(tgt))}")
        dev = device if device is not None else (
            tgt.device if isinstance(tgt, torch.Tensor) else "cpu")
        out.append(torch.from_numpy(arr).to(dev))
    return tree_unflatten(treedef, out), step


def cleanup(path: str, keep: int = 3) -> None:
    """Retain the newest ``keep`` checkpoints."""
    if not os.path.isdir(path):
        return
    steps = sorted(n for n in os.listdir(path) if n.startswith("step_")
                   and not n.endswith(".tmp"))
    for n in steps[:-keep]:
        shutil.rmtree(os.path.join(path, n), ignore_errors=True)
