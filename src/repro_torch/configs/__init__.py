"""Architecture registry: one module per assigned architecture, plus the
paper's own forest configurations (forest_*)."""
from __future__ import annotations

import importlib

from ..models.config import SHAPES, ArchConfig, ShapeConfig, shape_applicable

ARCH_IDS = [
    "chameleon_34b",
    "smollm_360m",
    "phi3_mini_3_8b",
    "command_r_plus_104b",
    "starcoder2_3b",
    "phi3_5_moe_42b",
    "grok_1_314b",
    "seamless_m4t_large_v2",
    "jamba_1_5_large_398b",
    "mamba2_370m",
]

_ALIASES = {
    "chameleon-34b": "chameleon_34b",
    "smollm-360m": "smollm_360m",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "command-r-plus-104b": "command_r_plus_104b",
    "starcoder2-3b": "starcoder2_3b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "grok-1-314b": "grok_1_314b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "mamba2-370m": "mamba2_370m",
}


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "get_config", "all_configs", "SHAPES", "ArchConfig",
           "ShapeConfig", "shape_applicable"]
