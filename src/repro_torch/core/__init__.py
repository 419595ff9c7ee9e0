"""repro_torch.core — QuickScorer tree-ensemble inference in PyTorch, with
fixed-point quantization; the port's counterpart of ``repro.core``.

Typical use::

    from repro_torch import core
    forest = core.from_random_forest(rf)              # trainer → IR
    forest = core.quantize_forest(forest, X_train)    # optional, paper §5
    pred = core.compile_forest(forest, engine="bitvector", backend="cuda")
    scores = pred.predict(X)                          # (B, C) numpy

Engines live in a single registry (``core.registry``); compilation runs
through an explicit pass pipeline (``core.pipeline``).  ``backend="torch"``
is the reference's ``"jax"`` engine in plain torch; ``backend="cuda"`` its
``"pallas"`` kernel, written by hand for Hopper.
"""
from .forest import (Forest, from_gradient_boosting, from_random_forest,
                     from_trees, random_forest_ir)
from .quantize import (QuantSpec, accum_bits, feature_ranges, flint_forest,
                       flint_key, leaf_scale, normalize_features,
                       quantize_forest, quantize_inputs)
from . import registry
from .registry import (BasePredictor, EngineSpec, Predictor,
                       normalize_scores, register_engine, resolve_device)
# importing the engine module registers the torch engine
from .quickscorer import (CompiledQS, QSPredictor, compile_qs, eval_batch,
                          eval_scalar_numpy, exit_leaf)
from .convert import forest_from_reference

# the kernel engine registers lazily: resolving it imports the kernel
# stack (repro_torch.kernels.ops) on first use, never at import time
registry.register_deferred(
    "bitvector", backend="cuda", tune_name="cuda-qs",
    target="repro_torch.kernels.ops:cuda_qs_predictor",
    doc="QuickScorer, hand-written CUDA kernel for sm_90a")

from .pipeline import CompilePlan, PassRecord, compile_plan


def compile_forest(forest: Forest, engine: str = "bitvector",
                   backend: str = "cuda", cascade=None, opt=None,
                   tune=None, device=None, **kw):
    """Build a predictor for ``forest`` via the pass pipeline.

    ``engine`` / ``backend`` resolve through ``core.registry``; ``**kw``
    is forwarded to the engine's build function.  ``device=None`` means
    the card: without CUDA that raises, and only an explicit
    ``device="cpu"`` selects the CPU (where the cuda backend runs its
    kernel's plain version).  ``tune=`` raises until the autotuner is ported; ``opt``
    other than O0 and ``cascade`` raise in the pipeline likewise.
    """
    if tune is not None:
        raise NotImplementedError(
            "tune= needs the autotuner, ported in the autotuner slice "
            "(ROADMAP Queue A item 8)")
    device = resolve_device(device)
    return compile_plan(forest, CompilePlan(engine=engine, backend=backend,
                                            device=device, cascade=cascade,
                                            opt=opt, engine_kw=kw))


__all__ = [
    "Forest", "from_trees", "from_random_forest", "from_gradient_boosting",
    "random_forest_ir", "QuantSpec", "quantize_forest", "quantize_inputs",
    "feature_ranges", "normalize_features", "leaf_scale",
    "accum_bits", "flint_forest", "flint_key",
    "CompiledQS", "compile_qs", "QSPredictor", "eval_batch",
    "eval_scalar_numpy", "exit_leaf", "compile_forest", "registry",
    "register_engine", "EngineSpec", "Predictor", "BasePredictor",
    "normalize_scores", "resolve_device", "forest_from_reference",
    "CompilePlan", "PassRecord", "compile_plan",
]
