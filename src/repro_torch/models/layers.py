"""Basic layers: norms, embeddings, RoPE, MLPs (port of ``repro/models/layers.py``).

Each layer is an ``nn.Module`` that holds its parameters under the JAX
package's names and layouts (dense weights ``[in, out]``, used as
``x @ W``), plus the function ``apply_<layer>(module, x, ...)`` that mirrors
the JAX function of the same name. Inits draw from an explicit
``torch.Generator`` on the target device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _param(t: torch.Tensor) -> nn.Parameter:
    """A trainable parameter. Serving runs under ``torch.inference_mode``,
    so it records no graph and leaves every ``.grad`` None."""
    return nn.Parameter(t)


# ---------------------------------------------------------------- init utils
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / np.sqrt(in_dim)
    return (torch.randn((in_dim, out_dim), generator=gen, device=gen.device)
            * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype):
    return (torch.randn((vocab, dim), generator=gen, device=gen.device)
            * 0.02).to(dtype)


# --------------------------------------------------------------------- norms
class Norm(nn.Module):
    def __init__(self, kind: str, dim: int, dtype, device):
        super().__init__()
        if kind not in ("rms", "layer"):
            raise ValueError(kind)
        self.scale = _param(torch.ones((dim,), dtype=dtype, device=device))
        if kind == "layer":
            self.bias = _param(torch.zeros((dim,), dtype=dtype, device=device))


def init_norm(kind: str, dim: int, dtype, device) -> Norm:
    return Norm(kind, dim, dtype, device)


def apply_norm(p: Norm, x, kind: str = "rms", eps: float = 1e-6):
    xf = x.float()
    if kind == "rms":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * p.scale.float()).to(x.dtype)
    elif kind == "layer":
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p.scale.float() + p.bias.float()
        return y.to(x.dtype)
    raise ValueError(kind)


# ---------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float):
    # numpy float64 on purpose: the JAX package computes the frequencies in
    # float64 and casts to float32 once; computing them in float32 drifts
    # the angles of late positions at theta 1e6
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., seq, heads, head_dim]; positions: [..., seq]. Halves split,
    not interleaved."""
    head_dim = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(head_dim, theta),
                            dtype=torch.float32, device=x.device)
    angles = positions[..., :, None].float() * freqs   # [..., S, hd/2]
    angles = angles[..., None, :]                       # broadcast heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------- MLP
class MLP(nn.Module):
    def __init__(self, w_up, w_down, w_gate=None):
        super().__init__()
        self.w_up = _param(w_up)
        self.w_down = _param(w_down)
        if w_gate is not None:
            self.w_gate = _param(w_gate)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, gated: bool,
             dtype) -> MLP:
    w_up = dense_init(gen, d_model, d_ff, dtype)
    w_down = dense_init(gen, d_ff, d_model, dtype)
    w_gate = dense_init(gen, d_model, d_ff, dtype) if gated else None
    return MLP(w_up, w_down, w_gate)


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation; torch defaults to erf
    return F.gelu(x, approximate="tanh")


def _act(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def apply_mlp(p: MLP, x, act: str = "silu", gated: bool = True):
    h = x @ p.w_up
    if gated:
        h = _act(act)(x @ p.w_gate) * h
    else:
        h = _act(act)(h)
    return h @ p.w_down


# ----------------------------------------------------------------- embedding
class Embedding(nn.Module):
    def __init__(self, table):
        super().__init__()
        self.table = _param(table)


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype) -> Embedding:
    return Embedding(embed_init(gen, vocab, d_model, dtype))


def apply_embedding(p: Embedding, tokens):
    return p.table[tokens]


def apply_unembedding(p: Embedding, x):
    return x @ p.table.T


def softcap(logits, cap: float):
    if cap and cap > 0:
        return torch.tanh(logits / cap) * cap
    return logits


def conv_tail(raw, width: int):
    """The last ``width - 1`` rows of a depthwise causal conv's raw inputs
    [B, S, Ch], left-padded with zeros when S < width - 1: the conv state a
    one-token decode step continues from (SSD and RG-LRU caches)."""
    pad = raw.new_zeros((raw.shape[0], width - 1, raw.shape[-1]))
    return torch.cat([pad, raw], dim=1)[:, -(width - 1):]
