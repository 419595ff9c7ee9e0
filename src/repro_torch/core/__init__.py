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
# importing the engine modules registers the torch engines
from .quickscorer import (BitMMPredictor, CompiledBitMM, CompiledQS,
                          QSPredictor, bitmm_cuda_layout, compile_qs,
                          compile_qs_bitmm, eval_batch, eval_batch_bitmm,
                          eval_scalar_numpy, exit_leaf)
from .rapidscorer import (CompiledRS, RSPredictor, compile_rs, merge_nodes,
                          merge_stats)
from .baselines import (BaselinePredictor, compile_gemm, compile_native,
                        eval_gemm, eval_native, gemm_predictor,
                        native_predictor)
from .convert import forest_from_reference

# the kernel engines register lazily: resolving one imports the kernel
# stack (repro_torch.kernels.ops) on first use, never at import time
registry.register_deferred(
    "bitvector", backend="cuda", tune_name="cuda-qs",
    target="repro_torch.kernels.ops:cuda_qs_predictor",
    doc="QuickScorer, hand-written CUDA kernel for sm_90a")
registry.register_deferred(
    "bitmm", backend="cuda", tune_name="cuda-bitmm",
    target="repro_torch.kernels.ops:cuda_bitmm_predictor",
    layout=bitmm_cuda_layout,
    doc="bit-matmul QuickScorer, hand-written CUDA kernel for sm_90a")
registry.register_deferred(
    "gemm", backend="cuda", tune_name="cuda-gemm",
    target="repro_torch.kernels.ops:cuda_gemm_predictor",
    doc="Hummingbird tensor traversal, hand-written CUDA kernel for sm_90a")

from .pipeline import CompilePlan, PassRecord, compile_plan


def compile_forest(forest: Forest, engine: str = "bitvector",
                   backend: str = "cuda", cascade=None, opt=None,
                   tune=None, device=None, **kw):
    """Build a predictor for ``forest`` via the pass pipeline.

    ``engine`` / ``backend`` resolve through ``core.registry``; ``**kw``
    is forwarded to the engine's build function.  ``device=None`` means
    the card: without CUDA that raises, and only an explicit
    ``device="cpu"`` selects the CPU (where the cuda backend runs its
    kernel's plain version).  ``cascade=CascadeSpec(...)`` builds a staged
    or fused cascade predictor (``repro_torch.cascade``).  ``opt=`` runs
    the optimizer middle-end (``repro_torch.optim``) on the IR first: a
    level (``0``/``1``/``2`` or ``"O2"``) or an explicit pass-name tuple;
    the result is always oracle-equivalence checked.  For
    quantization-as-a-pass or a model file use ``core.compile_plan``
    directly.  ``tune=`` raises until the autotuner is ported.
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
    "CompiledBitMM", "compile_qs_bitmm", "BitMMPredictor",
    "eval_batch_bitmm",
    "eval_scalar_numpy", "exit_leaf", "CompiledRS", "compile_rs",
    "RSPredictor", "merge_nodes", "merge_stats", "BaselinePredictor",
    "compile_native", "compile_gemm", "eval_native", "eval_gemm",
    "native_predictor", "gemm_predictor", "compile_forest", "registry",
    "register_engine", "EngineSpec", "Predictor", "BasePredictor",
    "normalize_scores", "resolve_device", "forest_from_reference",
    "CompilePlan", "PassRecord", "compile_plan",
]
