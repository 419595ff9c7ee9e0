"""repro_torch.tune — learned cost model over the autotuner cache
(``-Os``); the port's copy of ``repro.tune`` (numpy only).

The measured autotuner (``core.engine_select.choose``) is ground truth
but O(product) compiles per new shape; this package turns its
accumulated cache history into a zero-shot predictor
(docs/AUTOTUNE.md)::

    from repro_torch import tune
    from repro_torch.core import engine_select

    # after some measured sweeps have populated the cache:
    model = tune.train_from_cache(
        save_to=engine_select.default_model_path())

    # new shapes now compile once, not O(product) times:
    choice = engine_select.choose(forest, 256, mode="predict")

``extract_rows`` flattens schema-v2 cache entries into feature rows,
``fit_cost_model`` is the numpy-only ridge ranker with a calibrated
confidence score, and ``CostModel.save``/``load`` round-trip the
versioned JSON artifact (``repro_torch.io.packed``), which the reference
reads and writes too.
"""
from .extract import AXES, extract_rows, parse_candidate, rows_from_entries
from .model import (GROUPS, NUMERIC, SIGMA_FLOOR, CostModel, featurize,
                    fit_cost_model, train_from_cache)

__all__ = [
    "AXES", "GROUPS", "NUMERIC", "SIGMA_FLOOR",
    "CostModel", "featurize", "fit_cost_model", "train_from_cache",
    "extract_rows", "parse_candidate", "rows_from_entries",
]
