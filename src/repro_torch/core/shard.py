"""Tree-sharded execution over several devices — the port's counterpart of
``repro.core.shard``.

Forest scoring is a sum over trees, so the multi-device layout is **tree
parallelism**: split every per-tree compiled buffer over the devices,
evaluate the engine on each device's tree slice, and sum the partial
scores.  Every torch engine compiles to a ``CompiledModule`` of tree-major
buffers and has an ``evaluate(compiled, X)`` (``core/registry.py``), so one
generic wrapper serves them all.

Mechanics, as in the reference:

  * the forest is padded with single-leaf zero-value trees to a multiple
    of the device count (they reach leaf 0 and add exactly 0);
  * the engine is compiled **once, globally**, so static layout decisions
    (bitmm's field width and ``tree_chunk``, gemm's ``Bvec``) are the same
    on every shard;
  * buffers whose leading axis is the tree axis are split; every other
    buffer (rapidscorer's unique-node table) and the scalar config are
    replicated;
  * partial scores are exact under quantization: integer leaf sums over a
    power-of-two scale, so the reassociated sum is bitwise the
    single-device one.

In PyTorch's idiom the whole thing runs in one process, without
``torch.distributed``: shard ``d`` is a copy of the compiled module built
from its buffer slices on ``devices[d]`` (as ``CompiledModule.restore``
builds a module, never a deep copy of the global one), and the partials
are summed on ``devices[0]`` in device order — the reference's
``shard_map`` + ``psum``.  A device may repeat in ``devices``.  With no
list, a ``cuda`` device means the visible cards and a ``cpu`` device means
``n_devices`` replicas of the CPU, the port's counterpart of the
reference's forced host device count.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import registry
from .forest import Forest
from .quantize import quantize_inputs
from .registry import (BasePredictor, CompiledModule, as_input_tensor,
                       ensure_feature_column, resolve_device)


def pad_forest_trees(forest: Forest, mult: int) -> Forest:
    """Pad the ensemble with single-leaf zero trees to ``T % mult == 0``.

    A padding tree has no internal nodes and one leaf worth 0: every
    engine routes all instances to leaf 0 and adds nothing."""
    T = forest.n_trees
    pad = (-T) % mult
    if pad == 0:
        return forest

    def rows(a, fill=0):
        shape = (pad,) + a.shape[1:]
        return np.concatenate([a, np.full(shape, fill, dtype=a.dtype)])

    return replace(
        forest,
        n_trees=T + pad,
        feature=rows(forest.feature, -1),        # -1 → padding node
        threshold=rows(forest.threshold),
        left=rows(forest.left),
        right=rows(forest.right),
        leaf_lo=rows(forest.leaf_lo),
        leaf_mid=rows(forest.leaf_mid),
        leaf_hi=rows(forest.leaf_hi),
        leaf_value=rows(forest.leaf_value),
        n_nodes=rows(forest.n_nodes),
        n_leaves_per_tree=rows(forest.n_leaves_per_tree, 1),
    )


# --------------------------------------------------------------------------- #
# Generic compiled-module partitioning
# --------------------------------------------------------------------------- #
def _partition(compiled: CompiledModule, n_trees: int, replicated: tuple):
    """Split a compiled module into (sharded, replicated, rebuild).

    Buffers with leading dim == ``n_trees`` whose name is not in
    ``replicated`` are tree-sharded, other buffers replicated; the scalar
    config (``SCALARS``), the host ``forest`` and nested compiled modules
    (``CompiledRS.qs``) are carried over.  Returns flat dicts keyed by
    dotted buffer name (``named_buffers()``'s) and ``rebuild(sharded,
    replicated, device)``, which builds one shard's module from its
    buffers on ``device``."""
    sharded: dict = {}
    repl: dict = {}
    for path, buf in compiled.named_buffers():
        name = path.rsplit(".", 1)[-1]
        if buf.ndim >= 1 and buf.shape[0] == n_trees and \
                name not in replicated:
            sharded[path] = buf
        else:
            repl[path] = buf

    def build(mod: CompiledModule, prefix: str, sh: dict, rp: dict,
              device: torch.device) -> CompiledModule:
        cls = type(mod)
        out = cls.__new__(cls)
        nn.Module.__init__(out)
        out.device = device
        out.forest = mod.forest
        for k in cls.SCALARS:
            setattr(out, k, getattr(mod, k))
        for name, _ in mod.named_buffers(recurse=False):
            t = sh.get(prefix + name)
            if t is None:
                t = rp[prefix + name]
            out.register_buffer(name, t.to(device))
        for name, sub in mod.named_children():
            setattr(out, name, build(sub, f"{prefix}{name}.", sh, rp,
                                     device))
        return out

    def rebuild(sh: dict, rp: dict, device: torch.device) -> CompiledModule:
        return build(compiled, "", sh, rp, device)

    return sharded, repl, rebuild


class ShardedPredictor(BasePredictor):
    """Predictor running one engine tree-sharded over ``devices``: one
    compiled module per shard, partial scores summed on ``devices[0]``."""

    def __init__(self, forest: Forest, spec, shards: list, devices: list):
        # BasePredictor.__init__ is bypassed: there is one compiled
        # module per shard, not one for the predictor
        self.forest = forest
        self.engine = spec.name
        self.spec = spec
        self.shards = shards
        self.devices = devices
        self.n_devices = len(devices)
        self.device = devices[0]
        self._shapes: set = set()

    def transform_inputs(self, X: np.ndarray) -> np.ndarray:
        return quantize_inputs(self.forest, np.asarray(X))

    def predict_transformed(self, Xq: np.ndarray) -> np.ndarray:
        Xq = ensure_feature_column(np.asarray(Xq))
        self._shapes.add((Xq.shape, Xq.dtype.str))
        inputs: dict = {}
        total = None
        for mod, dev in zip(self.shards, self.devices):
            X = inputs.get(dev)
            if X is None:
                X = inputs[dev] = as_input_tensor(Xq, dev)
            part = self.spec.evaluate(mod, X).to(self.device)
            total = part if total is None else total + part
        return total.cpu().numpy()


def _devices(device, n_devices: Optional[int], devices) -> list:
    """The shard devices: ``devices`` as given (repeats allowed), else the
    visible cards for a ``cuda`` device, else ``n_devices`` replicas of
    the CPU."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    else:
        dev = resolve_device(device)
        if dev.type == "cuda":
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        else:
            devs = [dev] * max(int(n_devices or 1), 1)
    D = int(n_devices) if n_devices is not None else len(devs)
    if D > len(devs):
        raise ValueError(f"n_devices={D} but only {len(devs)} devices "
                         "visible (pass devices= to repeat a device)")
    if D < 1:
        raise ValueError(f"n_devices={D}: need at least one device")
    return devs[:D]


def tree_sharded(forest: Forest, engine: str = "bitvector", *,
                 n_devices: Optional[int] = None, devices=None, device=None,
                 **engine_kw) -> ShardedPredictor:
    """Compile ``engine`` with its trees sharded over ``n_devices``.

    Wraps any registered torch engine with ``spec.shardable``; outputs are
    those of the single-device predictor (bitwise on quantized forests).
    ``devices`` lists the shard devices (repeats allowed); without it,
    ``device`` (``None`` → the card) picks the visible cards or, on the
    CPU, ``n_devices`` replicas of it."""
    spec = registry.get(engine, "torch")
    if not spec.shardable:
        raise ValueError(
            f"engine {engine!r} is not shardable (registered engines that "
            f"are: {[s.name for s in registry.specs('torch') if s.shardable]})")
    devs = _devices(device, n_devices, devices)
    D = len(devs)

    padded = pad_forest_trees(forest, D)
    kw = dict(engine_kw)
    if spec.shard_kw is not None:
        for k, v in spec.shard_kw(padded, D).items():
            kw.setdefault(k, v)
    compiled = spec.compile(padded, device="cpu", **kw)
    sharded, repl, rebuild = _partition(compiled, padded.n_trees,
                                        spec.replicated)
    if not sharded:
        # e.g. a caller-forced bitmm tree_chunk that does not divide the
        # padded tree count re-pads inside compile: replicating those
        # buffers would count their trees D times
        raise ValueError(
            f"engine {engine!r}: no compiled array has the {padded.n_trees}"
            "-tree leading axis; refusing to shard")
    local = padded.n_trees // D
    shards = [rebuild({k: v[d * local:(d + 1) * local]
                       for k, v in sharded.items()}, repl, dev)
              for d, dev in enumerate(devs)]
    # the quantization metadata lives on the forest; padding keeps it
    # (dataclasses.replace), so transform_inputs matches the unsharded one
    return ShardedPredictor(padded, spec, shards, devs)
