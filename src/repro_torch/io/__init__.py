"""repro_torch.io — model ingestion + packed serialization, the port's
counterpart of ``repro.io`` (docs/FORMATS.md).

Front door for forests trained elsewhere and for durable compiled
artifacts::

    from repro_torch import io

    forest = io.load_model("model.json")          # sniffs XGB/LGBM/shim
    forest = io.import_sklearn(fitted_rf)         # duck-typed, no sklearn
    io.save_forest(forest, "forest.repro.npz")    # packed IR

    pred = core.compile_forest(forest, engine="bitmm", backend="torch")
    io.save_predictor(pred, "model.pred.npz")     # compiled artifact
    pred = io.load_predictor("model.pred.npz")    # cold start, no compile

The packed container is the reference's: forest artifacts cross both
ways, and the reference's predictor and cascade artifacts load here.
"""
from .importers import (import_lightgbm_json, import_sklearn,
                        import_xgboost_json, load_model,
                        sklearn_shim_from_json)
from .packed import (FORMAT, VERSION, load_cost_model, load_forest,
                     load_manifest, load_predictor, peek, save_cost_model,
                     save_forest, save_manifest, save_predictor)

__all__ = [
    "import_sklearn", "import_xgboost_json", "import_lightgbm_json",
    "load_model", "sklearn_shim_from_json",
    "save_forest", "load_forest", "save_predictor", "load_predictor",
    "save_manifest", "load_manifest",
    "save_cost_model", "load_cost_model",
    "peek", "FORMAT", "VERSION",
]
