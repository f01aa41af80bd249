"""Modality frontends for the [audio] and [vlm] archs (port of
``repro/models/frontends.py``).

As in the JAX package these are STUBS: HuBERT's conv feature extractor and
Phi-3-vision's CLIP tower are not implemented. The helpers give the frame
or patch embeddings the frontend would emit, with their shape; a learned
linear projector inside the backbone (``Transformer.frontend_proj``,
[frontend_dim, d_model]) maps them to d_model.

``synth_features`` draws from an explicit ``torch.Generator``: its numbers
differ from ``jax.random``'s, so tests cross features as numpy arrays.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import torch_dtype


def feature_spec(cfg: ModelConfig, batch: int, seq_len: int
                 ) -> Optional[Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of the frontend's output embeddings, or None for a
    text-only arch."""
    dt = torch_dtype(cfg.compute_dtype)
    if cfg.frontend == "audio_stub":
        # the encoder takes one embedding per frame: the whole sequence
        return (batch, seq_len, cfg.frontend_dim), dt
    if cfg.frontend == "vision_stub":
        return (batch, cfg.frontend_tokens, cfg.frontend_dim), dt
    return None


def synth_features(gen: torch.Generator, cfg: ModelConfig, batch: int,
                   seq_len: int) -> Optional[torch.Tensor]:
    """Unit-normal stub embeddings on ``gen.device``, or None."""
    spec = feature_spec(cfg, batch, seq_len)
    if spec is None:
        return None
    shape, dt = spec
    return torch.randn(shape, generator=gen, device=gen.device).to(dt)


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text tokens so that frontend tokens + text == seq_len."""
    if cfg.frontend == "vision_stub":
        return seq_len - cfg.frontend_tokens
    if cfg.frontend == "audio_stub":
        return 0
    return seq_len
