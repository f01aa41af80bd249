"""Config registry: ``arch id -> ModelConfig`` for the ported archs."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

# arch id -> module name (grows as slices port more archs)
ARCH_MODULES: Dict[str, str] = {
    "gemma3-1b": "gemma3_1b",
    "mamba2-130m": "mamba2_130m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCH_IDS = tuple(ARCH_MODULES)


def _module(arch: str):
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
