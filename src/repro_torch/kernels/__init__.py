"""Hopper kernels for the port's hot spots, each beside its plain torch
version.

quickscorer_kernel — QuickScorer bitvector traversal (csrc/qs_forward.cu),
                     replacing the Pallas ``qs_forward``
ops                — host glue: padding, dtype prep, kernel predictors
ref                — plain oracles
build              — nvcc into build/, loaded with ctypes at first use
"""
from . import ops, ref
from .quickscorer_kernel import qs_forward, qs_forward_reference

__all__ = ["ops", "ref", "qs_forward", "qs_forward_reference"]
