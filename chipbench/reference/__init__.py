"""The plain reference: NumPy quantization and a plain torch traversal of
the model file, with its own copy of the margin gate's exit rule.  It
imports nothing of the program and takes nothing the program made."""
from .forest import (Quantized, cascade, fit_ranges, margin_exits,
                     quantize_model, quantize_rows, traverse)

__all__ = ["Quantized", "cascade", "fit_ranges", "margin_exits",
           "quantize_model", "quantize_rows", "traverse"]
