"""Pass-based forest compiler: canonicalize → quantize → layout → lower.

The port's counterpart of ``repro.core.pipeline``: the same ``PIPELINE``
of named passes, each appending a ``PassRecord`` to the ``CompilePlan`` so
a compiled predictor can explain how it was built
(``pred.plan.describe()``).

Passes whose machinery belongs to a later slice of the port raise
``NotImplementedError`` naming it instead of skipping silently: loading a
model file (``deserialize``), the optimizer levels (``optimize``),
cascades and tree-sharded execution (``lower``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from . import registry
from .forest import Forest, from_trees
from .quantize import QuantSpec, flint_forest, quantize_forest


@dataclass(frozen=True)
class PassRecord:
    name: str
    detail: str


@dataclass
class CompilePlan:
    """Declarative compile request + the record of what each pass did.

    ``engine_kw`` is forwarded to the engine's registered build function;
    ``device`` is where its tensors live (``None`` → the card).
    """
    engine: str = "bitvector"
    backend: str = "cuda"
    device: object = None
    quant: Optional[QuantSpec] = None     # None → keep the forest's dtypes
    flint: bool = False                   # FLInt int32-key traversal pass
    opt: object = None                    # optimizer level; only O0 here
    n_devices: int = 1
    cascade: Optional[object] = None
    engine_kw: dict = field(default_factory=dict)
    records: list = field(default_factory=list)

    def record(self, name: str, detail: str) -> None:
        self.records.append(PassRecord(name, detail))

    def describe(self) -> str:
        return " → ".join(f"{r.name}[{r.detail}]" for r in self.records)


# --------------------------------------------------------------------------- #
# Pass registry
# --------------------------------------------------------------------------- #
PASSES: dict[str, Callable] = {}
PIPELINE = ("deserialize", "canonicalize", "quantize", "optimize",
            "flint", "layout", "lower")


def forest_pass(name: str):
    def deco(fn):
        PASSES[name] = fn
        return fn
    return deco


@forest_pass("deserialize")
def deserialize(obj, plan: CompilePlan, ctx: dict):
    """Entry pass: in-memory objects pass through; model files need the
    importers and packed format, which the port does not have yet."""
    if isinstance(obj, (str, os.PathLike)):
        raise NotImplementedError(
            "compiling from a model file needs repro_torch.io, ported in "
            "the ingestion slice (ROADMAP Queue A item 6)")
    plan.record("deserialize", "skipped (in-memory object)")
    return obj


@forest_pass("canonicalize")
def canonicalize(obj, plan: CompilePlan, ctx: dict) -> Forest:
    """Anything tree-shaped → canonical padded SoA ``Forest`` IR."""
    if isinstance(obj, Forest):
        forest = obj
        how = "already canonical"
    elif hasattr(obj, "cfg") and hasattr(obj.cfg, "objective"):
        from .forest import from_gradient_boosting
        forest = from_gradient_boosting(obj)
        how = "from GradientBoosting"
    elif hasattr(obj, "trees") and hasattr(obj, "n_classes"):
        from .forest import from_random_forest
        forest = from_random_forest(obj)
        how = "from RandomForest"
    elif isinstance(obj, (list, tuple)):
        forest = from_trees(list(obj), n_features=ctx["n_features"],
                            n_classes=ctx.get("n_classes", 1))
        how = f"from {len(obj)} trees"
    else:
        raise TypeError(f"cannot canonicalize {type(obj).__name__} into a "
                        "Forest (expected Forest, trainer, or tree list)")
    plan.record("canonicalize",
                f"{how}: T={forest.n_trees} L={forest.n_leaves} "
                f"C={forest.n_classes} d={forest.n_features} "
                f"depth={forest.max_depth}")
    return forest


@forest_pass("quantize")
def quantize(forest: Forest, plan: CompilePlan, ctx: dict) -> Forest:
    """Fixed-point lowering (paper §5) as a compilation stage."""
    if plan.quant is None:
        plan.record("quantize", "skipped (already quantized)"
                    if forest.quant_scale is not None
                    else "skipped (float forest)")
        return forest
    if forest.quant_scale is not None:
        plan.record("quantize", "skipped (already quantized)")
        return forest
    if plan.flint:
        raise ValueError("quant= and flint=True are mutually exclusive: "
                         "FLInt keys float thresholds, quantization "
                         "replaces them")
    qf = quantize_forest(forest, ctx.get("X_calib"), plan.quant)
    calib = "data" if ctx.get("X_calib") is not None else "thresholds"
    detail = (f"{plan.quant.bits}b scale={qf.quant_scale:g} "
              f"leaf_scale={qf.leaf_scale:g} calib={calib}")
    if qf.int_accum:
        detail += f" int_accum err_bound={qf.leaf_err_bound:g}"
    plan.record("quantize", detail)
    return qf


def _is_o0(opt) -> bool:
    if opt is None or (isinstance(opt, (int, np.integer))
                       and not isinstance(opt, bool) and int(opt) == 0):
        return True
    return isinstance(opt, str) and opt.lstrip("-") in ("O0", "o0", "0")


@forest_pass("optimize")
def optimize(forest: Forest, plan: CompilePlan, ctx: dict) -> Forest:
    """The optimizer middle-end: only ``-O0`` until it is ported."""
    if not _is_o0(plan.opt):
        raise NotImplementedError(
            f"opt={plan.opt!r} needs the optimizer middle-end, ported in "
            "the optimizer slice (ROADMAP Queue A item 5)")
    plan.record("optimize", "skipped (O0)")
    return forest


@forest_pass("flint")
def flint(forest: Forest, plan: CompilePlan, ctx: dict) -> Forest:
    """FLInt lowering (docs/QUANT.md): f32 thresholds → monotone int32
    keys, so the compares run on integers with zero quantization error."""
    if not plan.flint:
        plan.record("flint", "skipped (not requested)")
        return forest
    if forest.flint:
        plan.record("flint", "skipped (already FLInt-keyed)")
        return forest
    if forest.quant_scale is not None:
        raise ValueError("flint=True on a quantized forest: thresholds "
                         "are already integers (FLInt applies to float "
                         "forests)")
    if plan.backend == "cuda":
        raise ValueError(
            "FLInt is unsupported on the cuda backend: the kernel "
            "wrapper stages inputs through f32, which cannot represent "
            "int32 keys exactly (docs/QUANT.md)")
    out = flint_forest(forest)
    plan.record("flint", "f32 thresholds → monotone int32 keys "
                         "(zero quantization error)")
    return out


@forest_pass("layout")
def layout(forest: Forest, plan: CompilePlan, ctx: dict) -> Forest:
    """Memory-layout decisions, recorded on the plan.  The port's engines
    take the IR's tree-major SoA as-is (no engine has a layout hook yet)."""
    if plan.backend == "cuda":
        plan.record("layout", "tree-major SoA, shared-memory tree chunks")
    else:
        plan.record("layout", "tree-major SoA")
    return forest


@forest_pass("lower")
def lower(forest: Forest, plan: CompilePlan, ctx: dict):
    """Resolve the engine through the registry and build the predictor."""
    spec = registry.get(plan.engine, plan.backend)
    if plan.cascade is not None:
        raise NotImplementedError(
            "cascade= needs repro_torch.cascade, ported in the cascade "
            "slice (ROADMAP Queue A item 7)")
    if plan.n_devices > 1:
        raise NotImplementedError(
            f"n_devices={plan.n_devices} needs tree-sharded execution, "
            "ported in the sharding slice (ROADMAP Queue A item 10)")
    pred = spec.build_fn()(forest, device=plan.device, **plan.engine_kw)
    plan.record("lower", f"{spec.tune_name} ({plan.engine}/{plan.backend})")
    pred.plan = plan
    return pred


def compile_plan(obj, plan: Optional[CompilePlan] = None, *,
                 X_calib: Optional[np.ndarray] = None,
                 n_features: Optional[int] = None, n_classes: int = 1,
                 **plan_kw):
    """Run the full pipeline on ``obj`` (Forest / trainer / trees).

    Either pass a ``CompilePlan`` or keyword fields for one::

        pred = compile_plan(forest, backend="cuda", quant=QuantSpec(16))

    ``X_calib`` feeds the quantize pass's feature ranges; ``n_features`` /
    ``n_classes`` are only needed when ``obj`` is a bare tree list.
    """
    if plan is None:
        plan = CompilePlan(**plan_kw)
    elif plan_kw:
        raise TypeError("pass either a CompilePlan or plan kwargs, not both")
    ctx = {"X_calib": X_calib, "n_features": n_features,
           "n_classes": n_classes}
    for name in PIPELINE:
        obj = PASSES[name](obj, plan, ctx)
    return obj
