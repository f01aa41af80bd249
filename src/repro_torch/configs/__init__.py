"""Config registry: ``--arch <id>`` resolution for launchers and tests (own
copy of ``repro/configs/__init__.py``: the same ten archs in the same
order, the same shape skips)."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig

# arch id -> module name
ARCH_MODULES: Dict[str, str] = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mamba2-130m": "mamba2_130m",
    "qwen1.5-32b": "qwen15_32b",
    "hubert-xlarge": "hubert_xlarge",
    "mixtral-8x22b": "mixtral_8x22b",
    "stablelm-3b": "stablelm_3b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "phi-3-vision-4.2b": "phi3_vision_42b",
    "gemma3-1b": "gemma3_1b",
    "olmoe-1b-7b": "olmoe_1b_7b",
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


# (arch, shape) pairs skipped by design
SKIPS = {
    ("hubert-xlarge", "decode_32k"): "encoder-only: no decode step",
    ("hubert-xlarge", "long_500k"): "encoder-only: no decode step",
    ("qwen1.5-32b", "long_500k"): "pure full attention: no sub-quadratic path",
    ("stablelm-3b", "long_500k"): "pure full attention: no sub-quadratic path",
    ("moonshot-v1-16b-a3b", "long_500k"): "pure full attention: no sub-quadratic path",
    ("phi-3-vision-4.2b", "long_500k"): "pure full attention: no sub-quadratic path",
    ("olmoe-1b-7b", "long_500k"): "pure full attention: no sub-quadratic path",
}


def live_pairs():
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            if (arch, shape) not in SKIPS:
                yield arch, shape
