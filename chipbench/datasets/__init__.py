"""Row sources, one module per dataset, found by name (``load``).

Each module has ``train_rows()`` (the rows a model is trained on and its
quantization fitted to) and ``draw(n, rng)`` (fresh rows of the same
distribution as float32, and their labels or ``None``)."""
from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")
