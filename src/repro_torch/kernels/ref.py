"""Plain oracles for the kernels (the ``ref.py`` layer): the torch engine
is the mathematical reference, the numpy traversal the most trusted one."""
from __future__ import annotations

import numpy as np

from ..core.forest import Forest
from ..core.quantize import leaf_scale, quantize_inputs
from ..core.quickscorer import compile_qs, eval_batch
from ..core.registry import as_input_tensor


def ref_qs(forest: Forest, X: np.ndarray) -> np.ndarray:
    """Bitvector-engine reference on the CPU: (B, d) raw inputs → (B, C)."""
    qs = compile_qs(forest, device="cpu")
    Xq = quantize_inputs(forest, np.asarray(X))
    return eval_batch(qs, as_input_tensor(Xq, qs.device)).numpy()


def ref_oracle(forest: Forest, X: np.ndarray) -> np.ndarray:
    """Slowest, most-trusted path: vectorized numpy root-to-leaf traversal."""
    Xq = quantize_inputs(forest, np.asarray(X))
    return forest.predict_oracle(Xq) / leaf_scale(forest)
