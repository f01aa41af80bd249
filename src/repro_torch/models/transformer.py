"""Transformer backbone, serving subset (port of ``repro/models/transformer.py``).

The model holds a flat list of layers: layer ``i`` is ``model.layers[i]``.
The JAX package stacks layers per pattern cycle for ``lax.scan``;
``repro_torch.interop.params_from_jax`` unstacks cycle ``c``, position
``j`` into layer ``c*P + j``. PyTorch runs eagerly, so there is nothing to
gain from the stacked layout here.

This slice covers dense attention blocks (global and sliding-window) with a
dense FFN, and the batched serving prefill. SSD, RG-LRU and MoE blocks come
with the slice that ports their kernels.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, SSD,
                                      ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models.layers import (_act, _param, apply_embedding,
                                       apply_norm, dense_init, init_embedding,
                                       init_mlp, init_norm, softcap,
                                       torch_dtype)


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the slice that ports the "
        "SSD / RG-LRU / MoE block kernels")


# ============================================================== block params
class Block(nn.Module):
    """Pre-norm residual block: norm1 + attn, then norm2 + mlp."""

    def __init__(self, norm1, attn_mod, norm2=None, mlp=None):
        super().__init__()
        self.norm1 = norm1
        self.attn = attn_mod
        if mlp is not None:
            self.norm2 = norm2
            self.mlp = mlp


def _init_block(gen: torch.Generator, kind: str, cfg: ModelConfig,
                dtype) -> Block:
    dev = gen.device
    if kind in (SSD, RGLRU):
        raise _not_ported(f"block kind {kind!r}")
    if kind not in (ATTN_GLOBAL, ATTN_LOCAL):
        raise ValueError(kind)
    if cfg.moe is not None:
        raise _not_ported("the MoE FFN")
    norm1 = init_norm(cfg.norm, cfg.d_model, dtype, dev)
    a = attn.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim, cfg.qkv_bias, dtype)
    if cfg.d_ff <= 0:
        return Block(norm1, a)
    return Block(norm1, a, init_norm(cfg.norm, cfg.d_model, dtype, dev),
                 init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype))


def _apply_ffn(p: Block, h, cfg: ModelConfig):
    """Dense FFN branch of the JAX ``_apply_ffn`` (ungated, unsharded)."""
    mlp = p.mlp
    up = h @ mlp.w_up
    if cfg.mlp_gated:
        hid = _act(cfg.mlp_act)(h @ mlp.w_gate) * up
    else:
        hid = _act(cfg.mlp_act)(up)
    return hid @ mlp.w_down


# ========================================================== layer grouping
def layer_groups(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...], Tuple[str, ...]]:
    """Returns (n_cycles, pattern, remainder_kinds)."""
    pat = cfg.block_pattern
    n_cycles = cfg.n_layers // len(pat)
    rem = cfg.layer_kinds[n_cycles * len(pat):]
    return n_cycles, pat, rem


# ================================================================ model init
class Transformer(nn.Module):
    """embed, final_norm, a flat ``layers`` list and, when the embeddings
    are not tied, ``unembed`` [d_model, vocab]."""

    def __init__(self, embed, final_norm, layers: List[Block],
                 unembed: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = embed
        self.final_norm = final_norm
        self.layers = nn.ModuleList(layers)
        if unembed is not None:
            self.unembed = _param(unembed)


def init_model(gen: torch.Generator, cfg: ModelConfig) -> Transformer:
    """Random init on ``gen.device`` from the generator's stream (the
    numbers differ from ``jax.random``'s; tests carry JAX params over with
    ``interop.params_from_jax``)."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"frontend {cfg.frontend!r} is not ported yet")
    dtype = torch_dtype(cfg.param_dtype)
    embed = init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype)
    final_norm = init_norm(cfg.norm, cfg.d_model, dtype, gen.device)
    unembed = None if cfg.tie_embeddings else \
        dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    layers = [_init_block(gen, kind, cfg, dtype) for kind in cfg.layer_kinds]
    return Transformer(embed, final_norm, layers, unembed)


def logits_from_hidden(model: Transformer, cfg: ModelConfig, x):
    """Final norm, (tied) unembedding and softcap."""
    x = apply_norm(model.final_norm, x, cfg.norm)
    cdt = torch_dtype(cfg.compute_dtype)
    if cfg.tie_embeddings:
        logits = x @ model.embed.table.T.to(cdt)
    else:
        logits = x @ model.unembed.to(cdt)
    return softcap(logits, cfg.logit_softcap)


# ====================================================== prefill (cache dump)
def _prefill_block(p: Block, x, kind: str, cfg: ModelConfig):
    """One block of the batched prefill: the dense forward computation plus
    the post-rope K/V the block leaves behind. Returns (x, {"k","v"})."""
    h = apply_norm(p.norm1, x, cfg.norm)
    if kind not in (ATTN_GLOBAL, ATTN_LOCAL):
        raise _not_ported(f"block kind {kind!r}")
    window = cfg.window if kind == ATTN_LOCAL else 0
    c, k, v = attn.apply_attention(
        p.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, causal=cfg.causal, window=window,
        rope=cfg.rope, rope_theta=cfg.rope_theta, return_kv=True)
    x = x + c
    if hasattr(p, "mlp"):
        h2 = apply_norm(p.norm2, x, cfg.norm)
        x = x + _apply_ffn(p, h2, cfg)
    return x, {"k": k, "v": v}


def prefill_forward(model: Transformer, cfg: ModelConfig, tokens, *,
                    raw_kv: bool = True):
    """Batched serving prefill: one teacher-forced pass over the whole
    prompt that also returns each layer's post-rope K/V.

    tokens: [B, S] int. Returns (logits [B, S, vocab], cache) where cache is
    a flat per-layer list of ``{"k","v"}: [B, S, n_kv, hd]`` — the JAX
    package's ``raw_kv=True`` entries, which the paged engine slices into
    pages. The contiguous decode caches of ``raw_kv=False`` come with the
    port of ``serving/decode.py``.
    """
    if not raw_kv:
        raise NotImplementedError(
            "raw_kv=False (contiguous decode caches) is not ported yet")
    cdt = torch_dtype(cfg.compute_dtype)
    x = apply_embedding(model.embed, tokens).to(cdt)
    cache = []
    for p, kind in zip(model.layers, cfg.layer_kinds):
        x, entry = _prefill_block(p, x, kind, cfg)
        cache.append(entry)
    return logits_from_hidden(model, cfg, x), cache
