"""The LM stack's dense path: config, layers, attention (chunked flash in
torch, or the CUDA flash kernel), the model, and weight conversion from
the reference's tree."""
from .config import SHAPES, ArchConfig, ShapeConfig, shape_applicable
from .model import Model, make_params, n_units, unit_layout

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "shape_applicable",
           "Model", "make_params", "n_units", "unit_layout"]
