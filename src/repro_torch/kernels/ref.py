"""Plain oracles for the kernels (the ``ref.py`` layer): the torch engines
are the mathematical references, the numpy traversal the most trusted
one."""
from __future__ import annotations

import numpy as np

from ..core.baselines import compile_gemm, eval_gemm
from ..core.forest import Forest
from ..core.quantize import leaf_scale, quantize_inputs
from ..core.quickscorer import (compile_qs, compile_qs_bitmm, eval_batch,
                                eval_batch_bitmm)
from ..core.registry import as_input_tensor


def _run(compiled, evaluate, forest: Forest, X: np.ndarray) -> np.ndarray:
    Xq = quantize_inputs(forest, np.asarray(X))
    return evaluate(compiled, as_input_tensor(Xq, compiled.device)).numpy()


def ref_qs(forest: Forest, X: np.ndarray) -> np.ndarray:
    """Bitvector-engine reference on the CPU: (B, d) raw inputs → (B, C)."""
    return _run(compile_qs(forest, device="cpu"), eval_batch, forest, X)


def ref_bitmm(forest: Forest, X: np.ndarray) -> np.ndarray:
    """Bit-matmul-engine reference on the CPU: (B, d) raw inputs → (B, C)."""
    return _run(compile_qs_bitmm(forest, device="cpu"), eval_batch_bitmm,
                forest, X)


def ref_gemm(forest: Forest, X: np.ndarray) -> np.ndarray:
    """GEMM-engine reference on the CPU: (B, d) raw inputs → (B, C)."""
    return _run(compile_gemm(forest, device="cpu"), eval_gemm, forest, X)


def ref_oracle(forest: Forest, X: np.ndarray) -> np.ndarray:
    """Slowest, most-trusted path: vectorized numpy root-to-leaf traversal."""
    Xq = quantize_inputs(forest, np.asarray(X))
    return forest.predict_oracle(Xq) / leaf_scale(forest)
