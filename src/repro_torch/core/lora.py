"""LoRA extension of D2FT (port of ``repro/core/lora.py``, paper §II-D).

LoRA adapters attach to the Q/K/V projections of every attention block; the
foundation weights stay frozen, gradients flow only into the low-rank A/B
matrices. Each adapter is co-located with its head's subnet, so the D2FT
gates act on the LoRA contribution exactly as on full fine-tuning (the
paper's "subnet = frozen head + its LoRA matrices").

Parameters are the flat name -> tensor dict of
``dict(model.named_parameters())``; the adapters are keyed by the same
names (``layers.<i>.attn.wq`` ...), one ``{"a": [..., in, r], "b": [...,
r, out]}`` per target, keeping the target's leading dims (an MoE
``moe.w_up`` [E, d, F] gets one adapter per expert). The JAX package
stacks adapters over scan cycles; ``interop.lora_from_jax`` unstacks them
as ``params_from_jax`` unstacks the layers. The model runs on the merged
weights through ``torch.func.functional_call`` (``call_with_weights``).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

LORA_TARGETS = ("wq", "wk", "wv")

Lora = Dict[str, Dict[str, torch.Tensor]]


def init_lora(gen: torch.Generator, params: Mapping[str, torch.Tensor],
              rank: int, targets: Sequence[str] = LORA_TARGETS) -> Lora:
    """{name: {"a": [..., in, r], "b": [..., r, out]}} for every target
    weight of 2 or more dims, in the params' order, float32 on
    ``gen.device``: the leading dims kept (one adapter per expert of an
    [E, in, out] weight, as the JAX package's ``lead + (din, rank)``),
    a ~ N(0, 1/in), b = 0, so the merged model starts as the base model.
    The adapters are leaves that require grad; their numbers differ from
    ``jax.random``'s."""
    lora: Lora = {}
    for name, w in params.items():
        if name.rsplit(".", 1)[-1] not in targets or w.ndim < 2:
            continue
        lead, (din, dout) = tuple(w.shape[:-2]), w.shape[-2:]
        a = torch.randn(lead + (din, rank), generator=gen,
                        device=gen.device) / din ** 0.5
        b = torch.zeros(lead + (rank, dout), device=gen.device)
        lora[name] = {"a": a.requires_grad_(), "b": b.requires_grad_()}
    return lora


def lora_params(lora: Lora) -> Dict[str, torch.Tensor]:
    """The adapters as one flat dict (``<name>.a``, ``<name>.b``) of the same
    tensors, for the optimizer and ``torch.autograd.grad``."""
    return {f"{name}.{k}": ab[k] for name, ab in lora.items()
            for k in ("a", "b")}


def merge_lora(params: Mapping[str, torch.Tensor], lora: Lora,
               scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """name -> W.detach() + scale * A @ B (batched over the leading dims)
    for the targets and t.detach() for every other tensor (the JAX
    ``stop_gradient(params)``): gradients flow only through the
    adapters."""
    merged = {n: t.detach() for n, t in params.items()}
    for name, ab in lora.items():
        w = merged[name]
        merged[name] = w + ((ab["a"] @ ab["b"]) * scale).to(w.dtype)
    return merged


def lora_param_count(lora: Lora) -> int:
    return sum(int(t.numel()) for ab in lora.values() for t in ab.values())


def lora_flops_fraction(cfg: ModelConfig, rank: int) -> float:
    """Relative LoRA-branch compute vs the frozen QKV matmuls — used to map
    the paper's rank-matched baselines (R=1/60/200/240)."""
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    qkv_cols = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    full = d * qkv_cols
    lora = rank * (d + qkv_cols)
    return lora / full


class _Bound(nn.Module):
    """``fn(model, ...)`` as a module call, so that ``functional_call`` can
    run it on weights other than the model's own."""

    def __init__(self, fn: Callable, model: nn.Module):
        super().__init__()
        self.fn = fn
        self.model = model

    def forward(self, *args, **kw):
        return self.fn(self.model, *args, **kw)


def call_with_weights(fn: Callable, model: nn.Module,
                      weights: Mapping[str, torch.Tensor], *args, **kw):
    """``fn(model, *args, **kw)`` (``lm_loss``, ``forward`` ...) computed
    with ``weights`` (name -> tensor for every parameter, e.g.
    ``merge_lora``'s) in place of the model's parameters, through
    ``torch.func.functional_call``; the model itself is left as it was."""
    return torch.func.functional_call(
        _Bound(fn, model), {f"model.{n}": t for n, t in weights.items()},
        args, kw, strict=True)
