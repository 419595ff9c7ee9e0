"""Engine registry — every traversal engine registers exactly once.

The port's counterpart of ``repro.core.registry``:

  * ``EngineSpec`` — one record per (engine, backend): how to compile the
    Forest IR into device tensors, how to evaluate them, and how to wrap
    the result into a predictor.
  * ``register_engine`` / ``register_deferred`` — registration; a deferred
    target (``"module:attr"``) is imported on first use, so importing
    ``repro_torch.core`` never loads the kernel stack.
  * ``BasePredictor`` — the shared predictor base (input quantization and
    ``predict`` / ``predict_class`` / ``predict_proba``).  Where the
    reference wraps the evaluator in ``jax.jit``, the port calls it
    eagerly on tensors on the predictor's device and returns numpy.
  * ``CompiledModule`` — the base of the engines' compiled ``nn.Module``s:
    what ``io.packed`` saves of one (its scalar config and buffers, in
    the reference's on-disk dtypes) and how it is rebuilt from them on a
    device without compiling again.

Backends: ``"torch"`` is the reference's ``"jax"`` (the engine in plain
torch), ``"cuda"`` its ``"pallas"`` (the hand-written kernel).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch
from torch import nn

from ..obs import trace


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without CUDA that raises: the port never
    moves to the CPU unless the caller asks for it by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def as_input_tensor(X: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host rows → a tensor on ``device``.  Float rows become float32
    before any compare, as the reference's x64-off ``jnp.asarray`` and
    the kernel predictor do: float64 would flip near-threshold
    predicates against float32 thresholds."""
    X = np.asarray(X)
    if np.issubdtype(X.dtype, np.floating):
        X = X.astype(np.float32, copy=False)
    return torch.as_tensor(np.ascontiguousarray(X), device=device)


# --------------------------------------------------------------------------- #
# Compiled engine state
# --------------------------------------------------------------------------- #
class CompiledModule(nn.Module):
    """Base of the compiled engine modules: buffers on ``device``, the host
    IR (``forest``) and a scalar config.

    ``io.packed`` saves a module as the reference saves its compiled
    dataclass: the scalars named by ``SCALARS`` in the header and the
    buffers an ``EngineSpec.serial_arrays`` names as arrays, in the
    reference's dtypes.  Buffers in ``INDEX`` are int64 here and int32 on
    disk; buffers in ``BITS`` are int32 bit patterns here and uint32 on
    disk.  ``restore`` is the inverse: the buffers a fresh compile gives
    (same dtypes, same values) on ``device``, with no compile step."""

    SCALARS: tuple = ()
    INDEX: tuple = ()
    BITS: tuple = ()

    def scalar_config(self) -> dict:
        return {k: getattr(self, k) for k in self.SCALARS}

    def saved_array(self, name: str) -> np.ndarray:
        a = getattr(self, name).cpu().numpy()
        if name in self.INDEX:
            return a.astype(np.int32)
        if name in self.BITS:
            return a.view(np.uint32)
        return a

    @classmethod
    def restore(cls, arrays: dict, scalars: dict, forest,
                device: torch.device) -> "CompiledModule":
        """Rebuild from ``arrays`` (buffer name → saved numpy array) and
        ``scalars`` (nesting prefix → scalar config; this module's is
        ``scalars[""]``) on ``device``."""
        mod = cls.__new__(cls)
        nn.Module.__init__(mod)
        mod.device = device
        mod.forest = forest
        cfg = scalars.get("", {})
        missing = [k for k in cls.SCALARS if k not in cfg]
        if missing:
            raise ValueError(f"{cls.__name__}: saved config lacks {missing}")
        for k in cls.SCALARS:
            setattr(mod, k, cfg[k])
        for name, a in arrays.items():
            if name in cls.INDEX:
                a = a.astype(np.int64)
            elif name in cls.BITS:
                a = a.view(np.int32)
            mod.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(a)).to(device))
        return mod


# --------------------------------------------------------------------------- #
# Protocols
# --------------------------------------------------------------------------- #
@runtime_checkable
class Predictor(Protocol):
    """What every engine hands back to the user/serving layer."""

    def transform_inputs(self, X: np.ndarray) -> np.ndarray: ...
    def predict(self, X: np.ndarray) -> np.ndarray: ...
    def predict_class(self, X: np.ndarray) -> np.ndarray: ...


# --------------------------------------------------------------------------- #
# Shared predictor base
# --------------------------------------------------------------------------- #
def normalize_scores(scores: np.ndarray,
                     votes: Optional[bool] = None) -> np.ndarray:
    """(B, C) raw class scores → per-row probabilities (paper §4).

    ``votes=True`` — non-negative vote mass (averaged RF leaves): rows
    divide by their sum (all-zero rows fall back to uniform).
    ``votes=False`` — logit leaves (boosting): softmax.
    ``votes=None`` infers from the scores at hand — predictors instead
    pass the mode derived from the forest's leaf table, so one input row
    always gets the same probabilities regardless of its batchmates.
    """
    s = np.asarray(scores, dtype=np.float64)
    if s.ndim != 2 or s.shape[1] < 2:
        raise ValueError(
            f"predict_proba needs a classification forest (C >= 2 class "
            f"scores); got shape {s.shape}")
    if votes is None:
        votes = bool((s >= 0).all())
    if votes:
        s = np.maximum(s, 0.0)         # guard: quantization can dip below 0
        tot = s.sum(axis=1, keepdims=True)
        uniform = np.full_like(s, 1.0 / s.shape[1])
        return np.where(tot > 0, s / np.where(tot > 0, tot, 1.0), uniform)
    z = np.exp(s - s.max(axis=1, keepdims=True))
    return z / z.sum(axis=1, keepdims=True)


def votes_mode(forest) -> bool:
    """Whether a forest's class scores are vote mass (RF averaging, all
    leaves >= 0 → sum-normalize) or logits (boosting → softmax)."""
    return bool((np.asarray(forest.leaf_value) >= 0).all())


def ensure_feature_column(X: np.ndarray) -> np.ndarray:
    """0-feature ensembles (every tree a single leaf) hand engines a
    (B, 0) input, but all engines gather feature column 0 unconditionally
    — give them one dummy column instead of an empty gather axis."""
    if X.ndim == 2 and X.shape[1] == 0:
        return np.zeros((X.shape[0], 1), dtype=X.dtype)
    return X


class BasePredictor:
    """Shared engine wrapper: input quantization + the full prediction
    surface.  ``eval_fn(compiled, X) → (B, C)`` is the engine's evaluator
    on tensors; ``compiled`` carries ``device`` and, for quantized
    forests, ``transform_inputs``."""

    def __init__(self, compiled, eval_fn: Callable):
        self.compiled = compiled
        self._eval = eval_fn
        self.device = compiled.device
        self._shapes: set = set()

    def trace_cache_size(self) -> int:
        """Distinct input shapes (and dtypes) that reached the evaluator —
        the port's counterpart of a jit trace cache: each new one is a
        first use on the device (``repro_torch.obs.retrace``)."""
        return len(self._shapes)

    def transform_inputs(self, X: np.ndarray) -> np.ndarray:
        t = getattr(self.compiled, "transform_inputs", None)
        X = np.asarray(X)
        return t(X) if t is not None else X

    def predict_transformed(self, Xq: np.ndarray) -> np.ndarray:
        """Evaluate inputs that already went through ``transform_inputs``."""
        Xq = ensure_feature_column(np.asarray(Xq))
        self._shapes.add((Xq.shape, Xq.dtype.str))
        out = self._eval(self.compiled, as_input_tensor(Xq, self.device))
        return out.cpu().numpy()

    def predict(self, X: np.ndarray) -> np.ndarray:
        root = trace.begin("repro_torch.predict")
        try:
            t = trace.begin("repro_torch.transform")
            Xq = self.transform_inputs(X)
            trace.end(t)
            return self.predict_transformed(Xq)
        finally:
            trace.end(root, rows=len(X))

    def predict_class(self, X: np.ndarray) -> np.ndarray:
        return self.predict(X).argmax(axis=1)

    def host_forest(self):
        """The host IR, if this predictor can reach one (compiled objects
        carry it for input quantization; CompiledRS nests it under qs)."""
        for owner in (self, getattr(self, "compiled", None),
                      getattr(getattr(self, "compiled", None), "qs", None)):
            f = getattr(owner, "forest", None)
            if f is not None:
                return f
        return None

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        # the normalization mode is a property of the model (its leaf
        # table), so results never depend on batch composition
        forest = self.host_forest()
        votes = None if forest is None else votes_mode(forest)
        return normalize_scores(self.predict(X), votes=votes)


# --------------------------------------------------------------------------- #
# The registry
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class EngineSpec:
    """One engine × backend entry.

    Either ``build`` (forest, device=, **kw → predictor) is set directly
    (or through ``deferred``), or ``compile`` + ``evaluate`` are set and
    ``build`` is derived via ``predictor_cls``.
    """
    name: str                             # canonical name, e.g. "bitvector"
    backend: str                          # "torch" | "cuda"
    tune_name: str                        # short name, e.g. "qs"
    build: Optional[Callable] = None      # (forest, device=, **kw) -> Predictor
    compile: Optional[Callable] = None    # (forest, device=) -> compiled
    evaluate: Optional[Callable] = None   # (compiled, X) -> (B, C) tensor
    predictor_cls: type = BasePredictor
    shardable: bool = False               # supports core.shard tree-sharding
    #                                       (compile + evaluate engines; the
    #                                       cuda kernels never shard)
    shard_kw: Optional[Callable] = None   # (padded forest, n_shards) -> kw
    replicated: tuple = ()                # compiled buffers never tree-sharded
    layout: Optional[Callable] = None     # (forest, plan) -> detail string;
    #                                       pipeline layout-pass hook
    serial_arrays: tuple = ()             # compiled buffers io.packed may
    #                                       serialize (dotted for nested
    #                                       modules); empty → artifact not
    #                                       serializable, rebuild from the
    #                                       forest instead
    restore: Optional[Callable] = None    # (arrays, scalars, forest, device)
    #                                       -> compiled, with no compile
    deferred: Optional[str] = None        # "module:attr" lazy build target
    doc: str = ""

    def build_fn(self) -> Callable:
        """Resolve the (forest, device=, **kw) → predictor callable."""
        if self.build is not None:
            return self.build
        if self.deferred is not None:
            mod, attr = self.deferred.split(":")
            fn = getattr(importlib.import_module(mod), attr)
            object.__setattr__(self, "build", fn)   # cache the resolution
            return fn
        if self.compile is None or self.evaluate is None:
            raise ValueError(f"engine {self.name}/{self.backend} registered "
                             "without build, deferred, or compile+evaluate")

        def build(forest, device=None, **kw):
            compiled = self.compile(forest, device=device, **kw)
            return self.predictor_cls(compiled, self.evaluate)

        object.__setattr__(self, "build", build)
        return build


_REGISTRY: dict[tuple[str, str], EngineSpec] = {}


def register_engine(name: str, *, backend: str = "torch",
                    tune_name: Optional[str] = None,
                    **spec_kw) -> EngineSpec:
    """Register an engine under (name, backend) from ``EngineSpec``
    fields (``build=``, ``deferred=`` or ``compile=`` + ``evaluate=``)."""
    spec = EngineSpec(name=name, backend=backend,
                      tune_name=tune_name or name, **spec_kw)
    _REGISTRY[(name, backend)] = spec
    return spec


def register_deferred(name: str, *, backend: str, target: str,
                      tune_name: str, **spec_kw) -> EngineSpec:
    """Register an engine whose build function lives in a module that
    must not be imported eagerly (the kernel stack)."""
    return register_engine(name, backend=backend, tune_name=tune_name,
                           deferred=target, **spec_kw)


def get(name: str, backend: str = "torch") -> EngineSpec:
    try:
        return _REGISTRY[(name, backend)]
    except KeyError:
        names = engines(backend)
        raise ValueError(
            f"unknown engine {name!r} for backend {backend!r}; "
            f"registered: {names or tuple(sorted(set(n for n, _ in _REGISTRY)))}"
        ) from None


def specs(backend: Optional[str] = None) -> tuple[EngineSpec, ...]:
    """All registered specs, in registration order."""
    return tuple(s for s in _REGISTRY.values()
                 if backend is None or s.backend == backend)


def engines(backend: Optional[str] = None) -> tuple[str, ...]:
    """Canonical engine names (deduped across backends, in order)."""
    return tuple(dict.fromkeys(s.name for s in specs(backend)))


def tune_table() -> dict[str, tuple[str, str]]:
    """Autotuner name → (engine, backend) — derived, never re-declared."""
    return {s.tune_name: (s.name, s.backend) for s in _REGISTRY.values()}


def by_tune_name(tune_name: str) -> EngineSpec:
    for s in _REGISTRY.values():
        if s.tune_name == tune_name:
            return s
    raise ValueError(f"unknown autotuner engine {tune_name!r}; "
                     f"registered: {sorted(tune_table())}")


def build(forest, name: str, backend: str = "torch", device=None,
          **kw) -> Predictor:
    """Compile ``forest`` with the registered (name, backend) engine."""
    return get(name, backend).build_fn()(forest, device=device, **kw)
