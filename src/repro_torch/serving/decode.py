"""Serving: batched prefill + decode against contiguous KV caches (port of
``repro/serving/decode.py``).

``serve_step`` is one new token per sequence against a cache of ``t``
tokens. ``generate`` drives a full prefill + N-token greedy decode for the
examples.

Prefill is one batched teacher-forced pass whose per-layer K/V (and SSD /
RG-LRU state) is dumped straight into the decode caches
(``models.transformer.prefill_forward``). The sequential decode-path loop
is kept as ``prefill_sequential``: the cache-exact oracle that the tests
hold the dump against.

Serving is schedule-free: D2FT changes only training, so the fine-tuned
model decodes through the ordinary dense path and nothing here takes a
``Schedule``. Paged, continuously batched serving lives in
``serving/engine.py``. Every function runs on the device that holds the
model and the tokens, under ``torch.inference_mode``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import (Transformer, decode_step,
                                            init_cache, prefill_forward)


@torch.inference_mode()
def serve_step(model: Transformer, cache, cfg: ModelConfig, token, t: int,
               policy=None):
    """One decode step: token [B, 1] int, t = tokens already cached (a host
    int). Returns (next_token [B, 1] int64, logits [B, 1, V], cache), the
    cache updated in place. Greedy: argmax takes the first index on ties,
    as ``jnp.argmax`` does."""
    logits, cache = decode_step(model, cache, cfg, token, t, policy=policy)
    return torch.argmax(logits[:, -1], dim=-1)[:, None], logits, cache


@torch.inference_mode()
def prefill(model: Transformer, cfg: ModelConfig, tokens, max_len: int):
    """Batched prefill: one forward pass + cache dump. Returns (logits
    [B, 1, V] — the last position's, the greedy seed for decode — and the
    filled cache, positioned at t = S)."""
    logits, cache = prefill_forward(model, cfg, tokens, max_len)
    return logits[:, -1:], cache


@torch.inference_mode()
def prefill_sequential(model: Transformer, cfg: ModelConfig, tokens,
                       max_len: int):
    """Sequential prefill through the decode path, one token at a time.

    S decode steps — not the serving path (that is ``prefill``); kept as
    the cache-exact oracle the tests hold the batched dump against."""
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    logits = None
    for i in range(S):
        logits, cache = decode_step(model, cache, cfg, tokens[:, i:i + 1], i)
    return logits, cache


@torch.inference_mode()
def generate(model: Transformer, cfg: ModelConfig, prompt, n_tokens: int,
             max_len: Optional[int] = None, *,
             sequential_prefill: bool = False):
    """Greedy generation. prompt: [B, S] int tensor on the model's device.
    Returns [B, S + n_tokens] in the prompt's dtype.
    ``sequential_prefill`` takes the O(S) oracle prefill."""
    B, S = prompt.shape
    max_len = max_len or (S + n_tokens)
    fill = prefill_sequential if sequential_prefill else prefill
    logits, cache = fill(model, cfg, prompt, max_len)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [prompt, tok.to(prompt.dtype)]
    for i in range(n_tokens - 1):
        tok, _, cache = serve_step(model, cache, cfg, tok, S + i)
        out.append(tok.to(prompt.dtype))
    return torch.cat(out, dim=1)
