"""Architecture config registry: one module per assigned architecture (a copy
of ``repro.configs``; every size is committed, nothing is downloaded)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, MoESpec, SSMSpec, ShapeCell, SHAPES, SHAPE_BY_NAME, reduced

_MODULES = {
    "llama3-8b": "llama3_8b",
    "qwen3-8b": "qwen3_8b",
    "qwen3-0.6b": "qwen3_0_6b",
    "stablelm-3b": "stablelm_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "mixtral-8x7b": "mixtral_8x7b",
    "mamba2-780m": "mamba2_780m",
    "llava-next-34b": "llava_next_34b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    import importlib

    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


__all__ = [
    "ArchConfig", "MoESpec", "SSMSpec", "ShapeCell", "SHAPES", "SHAPE_BY_NAME",
    "ARCH_NAMES", "get_config", "reduced",
]
