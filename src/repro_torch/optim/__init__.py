"""repro_torch.optim — the forest optimizer middle-end, the port's
counterpart of ``repro.optim`` (docs/OPTIM.md).

IR→IR passes running between ``quantize`` and ``layout`` in the compile
pipeline.  Typical use is through the pipeline::

    pred = core.compile_forest(forest, engine="bitvector", opt=2)
    print(pred.plan.describe())       # per-pass before/after stats

or standalone::

    from repro_torch import optim
    res = optim.optimize(forest, 2)   # OptResult: forest + stats,
    res.forest                        # oracle-equivalence verified

Passes register through ``register_pass``; ``OPT_LEVELS`` groups them
into -O0/-O1/-O2.
"""
# .analysis first: it stays import-light (numpy only) because
# core/rapidscorer.py resolves unique_splits from it
from .analysis import n_unique_splits, unique_fraction, unique_splits
from .rewrite import Node, extract_tree, rebuild_forest
from .passes import (OPT_LEVELS, OPT_PASSES, ForestStats, OptimizationError,
                     OptPass, OptResult, PassStats, opt_passes, optimize,
                     per_tree_scores, register_pass, resolve_opt,
                     verify_equivalence)

__all__ = [
    "unique_splits", "n_unique_splits", "unique_fraction",
    "Node", "extract_tree", "rebuild_forest",
    "OPT_LEVELS", "OPT_PASSES", "OptPass", "OptResult", "PassStats",
    "ForestStats", "OptimizationError", "opt_passes", "optimize",
    "per_tree_scores", "register_pass", "resolve_opt",
    "verify_equivalence",
]
