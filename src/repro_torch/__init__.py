"""PyTorch/CUDA port of the D2FT system, one slice at a time.

Mirrors ``src/repro/`` module for module: the reference for
``repro_torch/x/y.py`` is always ``repro/x/y.py``. Imports torch, numpy and
the standard library only — never jax, triton, or anything of ``repro``.

Entry points take an explicit ``device=``. They run on ``cuda`` unless the
caller asks for the CPU, and raise when no card is present and none was
requested (``resolve_device``): nothing silently carries on on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    first CUDA card. Raises when no card is present and none was named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return torch.device("cuda")
