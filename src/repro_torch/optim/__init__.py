"""repro_torch.optim — the forest optimizer middle-end, the port's
counterpart of ``repro.optim``.  Only the shared IR analysis is ported so
far (``analysis``); the passes and ``-O`` levels come with the optimizer
slice, and until then ``compile_forest(opt=...)`` above O0 raises."""
from .analysis import n_unique_splits, unique_fraction, unique_splits

__all__ = ["unique_splits", "n_unique_splits", "unique_fraction"]
