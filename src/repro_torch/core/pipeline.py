"""Pass-based forest compiler: deserialize → canonicalize → quantize →
optimize → flint → layout → lower.

The port's counterpart of ``repro.core.pipeline``: the same ``PIPELINE``
of named passes, each appending a ``PassRecord`` to the ``CompilePlan`` so
a compiled predictor can explain how it was built
(``pred.plan.describe()``).  A model file compiles like an in-memory
forest (``compile_plan("model.json", ...)``, through ``repro_torch.io``),
and ``opt=`` runs the optimizer middle-end (``repro_torch.optim``), each
of its passes recorded as ``opt.<name>``.

Tree-sharded execution (``n_devices > 1`` in ``lower``) belongs to a
later slice of the port and raises ``NotImplementedError`` naming it.
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
    opt: object = None                    # optim level (0/1/2, "O2") or
    #                                       pass-name tuple; None → O0
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
    """Entry pass: a path (str/PathLike to a model file) becomes an
    in-memory forest via ``repro_torch.io`` — XGBoost/LightGBM JSON dumps,
    sklearn-shim JSON, or a packed ``.repro.npz`` forest all compile with
    ``compile_plan("model.json", engine=...)``.  In-memory objects pass
    through untouched."""
    if not isinstance(obj, (str, os.PathLike)):
        plan.record("deserialize", "skipped (in-memory object)")
        return obj
    from .. import io
    path = os.fspath(obj)
    forest = io.load_model(path, **ctx.get("load_kw") or {})
    plan.record("deserialize", f"loaded {path}")
    return forest


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


def _optimize_cached(forest: Forest, opt, opt_cache: Optional[dict],
                     X_calib=None):
    """Run (or reuse) the optimizer middle-end for one (forest, opt-tag)
    point.  ``opt_cache`` — a dict the caller owns, keyed by
    ``(id(forest), tag)`` — is the shared-IR mechanism: repeated compiles
    of the same IR at the same level see the same optimized forest, and
    the optimizer (with its oracle-equivalence check) runs once.  Returns
    ``None`` when the level resolves to no passes."""
    from .. import optim
    names, tag = optim.resolve_opt(opt)
    if not names:
        return None
    key = (id(forest), tag)
    if opt_cache is not None and key in opt_cache:
        return opt_cache[key]
    res = optim.optimize(forest, opt, ctx={"X_calib": X_calib})
    if opt_cache is not None:
        opt_cache[key] = res
    return res


def optimized_forest(forest: Forest, opt,
                     opt_cache: Optional[dict] = None,
                     X_calib=None) -> Forest:
    """The IR the optimize pass would hand downstream for ``opt``, through
    the same shared cache."""
    res = _optimize_cached(forest, opt, opt_cache, X_calib)
    return forest if res is None else res.forest


@forest_pass("optimize")
def optimize(forest: Forest, plan: CompilePlan, ctx: dict) -> Forest:
    """The optimizer middle-end (``repro_torch.optim``): run the level /
    pass list named by ``plan.opt`` on the (possibly quantized) IR.  Each
    optimizer pass appends its own ``opt.<name>`` record with before/after
    node / unique-threshold stats, followed by one ``optimize`` summary
    record; the run is always oracle-equivalence checked
    (``optim.OptimizationError`` on divergence).  With an ``opt_cache`` in
    the ctx the result is computed once per (forest, tag) point and
    replayed, records included."""
    from .. import optim
    names, tag = optim.resolve_opt(plan.opt)
    if not names:
        plan.record("optimize", f"skipped ({tag})")
        return forest
    res = _optimize_cached(forest, plan.opt, ctx.get("opt_cache"),
                           X_calib=ctx.get("X_calib"))
    for st in res.stats:
        plan.record(f"opt.{st.name}", st.detail())
    plan.record("optimize", res.describe())
    return res.forest


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
    """Engine-aware memory-layout decisions, recorded on the plan.  An
    engine may carry a ``layout`` hook that chooses packing / tiling
    defaults (written into ``plan.engine_kw``; caller-provided values
    win) and returns the recorded detail.  Engines without a hook take
    the IR's tree-major SoA as-is."""
    spec = registry.get(plan.engine, plan.backend)
    if spec.layout is not None:
        plan.record("layout", spec.layout(forest, plan))
    elif plan.backend == "cuda":
        plan.record("layout", "tree-major SoA, shared-memory tree chunks")
    else:
        plan.record("layout", "tree-major SoA")
    return forest


@forest_pass("lower")
def lower(forest: Forest, plan: CompilePlan, ctx: dict):
    """Resolve the engine through the registry and build the predictor.

    With ``plan.cascade`` set, the forest is partitioned into tree-prefix
    stages and each stage lowers through the same engine build function;
    the cascade is recorded as its own plan stage.
    ``CascadeSpec(fused=True)`` picks the fused predictor."""
    spec = registry.get(plan.engine, plan.backend)
    if plan.cascade is not None:
        if plan.n_devices > 1:
            raise ValueError(
                "cascade + tree-sharded execution is not supported "
                f"(n_devices={plan.n_devices}); pick one")
        from ..cascade import CascadePredictor, FusedCascadePredictor
        fused = bool(getattr(plan.cascade, "fused", False))
        cls = FusedCascadePredictor if fused else CascadePredictor
        pred = cls(forest, plan.cascade, engine=plan.engine,
                   backend=plan.backend, engine_kw=plan.engine_kw,
                   device=plan.device)
        plan.record("cascade", pred.describe())
        stage_note = f"{spec.tune_name} × {len(pred.stages)} cascade stages"
        plan.record("lower", stage_note + (" (fused)" if fused else ""))
        pred.plan = plan
        return pred
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
                 load_kw: Optional[dict] = None,
                 opt_cache: Optional[dict] = None,
                 **plan_kw):
    """Run the full pipeline on ``obj`` (path / Forest / trainer / trees).

    Either pass a ``CompilePlan`` or keyword fields for one::

        pred = compile_plan(forest, backend="cuda", quant=QuantSpec(16))
        pred = compile_plan("model.json", engine="bitvector", opt="O2")

    ``X_calib`` feeds the quantize pass's feature ranges and the
    ``reorder_trees`` pass; ``n_features`` / ``n_classes`` are only needed
    when ``obj`` is a bare tree list; ``load_kw`` forwards to
    ``io.load_model`` when ``obj`` is a path; ``opt_cache`` (a dict the
    caller owns) lets repeated compiles of the same IR at the same opt
    level share one optimizer run — see ``_optimize_cached``.
    """
    if plan is None:
        plan = CompilePlan(**plan_kw)
    elif plan_kw:
        raise TypeError("pass either a CompilePlan or plan kwargs, not both")
    ctx = {"X_calib": X_calib, "n_features": n_features,
           "n_classes": n_classes, "load_kw": load_kw,
           "opt_cache": opt_cache}
    for name in PIPELINE:
        obj = PASSES[name](obj, plan, ctx)
    return obj
