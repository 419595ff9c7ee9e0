"""Hopper kernels for the port's hot spots, each beside its plain torch
version.

quickscorer_kernel — QuickScorer bitvector (csrc/qs_forward.cu) and
                     bit-matmul (csrc/qs_bitmm_forward.cu) traversal,
                     replacing the Pallas ``qs_forward`` and
                     ``qs_bitmm_forward``
gemm_forest_kernel — GEMM (Hummingbird) traversal (csrc/gemm_forward.cu),
                     replacing the Pallas ``gemm_forward``
cascade_kernel     — the fused confidence-gated cascade over bitvector
                     stages (csrc/cascade_qs_forward.cu), replacing the
                     Pallas ``cascade_qs_forward``
flash_attention_kernel — GQA flash attention (csrc/flash_forward.cu),
                     replacing the Pallas ``flash_forward``; the LM
                     prefill's attention on ``backend="cuda"``
ops                — host glue: padding, dtype prep, kernel predictors
ref                — plain oracles
launch             — what every wrapper shares: block limits, operand
                     checks, card-or-CPU choice, the ctypes launch
build              — nvcc into build/, loaded with ctypes at first use
"""
from . import ops, ref
from .cascade_kernel import cascade_qs_forward, cascade_qs_forward_reference
from .flash_attention_kernel import (flash_attention_bshd, flash_forward,
                                     flash_forward_reference)
from .gemm_forest_kernel import gemm_forward, gemm_forward_reference
from .quickscorer_kernel import (qs_bitmm_forward, qs_bitmm_forward_reference,
                                 qs_forward, qs_forward_reference)

__all__ = ["ops", "ref", "qs_forward", "qs_forward_reference",
           "qs_bitmm_forward", "qs_bitmm_forward_reference", "gemm_forward",
           "gemm_forward_reference", "cascade_qs_forward",
           "cascade_qs_forward_reference", "flash_forward",
           "flash_forward_reference", "flash_attention_bshd"]
