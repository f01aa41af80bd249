"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427; port
of ``repro/models/rglru.py``).

Recurrence (per channel):
    r_t = sigmoid(W_a x_t)                 (recurrence gate)
    i_t = sigmoid(W_x x_t)                 (input gate)
    log a_t = -c * softplus(Lambda) * r_t  (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full recurrent block is
    x -> [gate branch: linear + gelu] * [linear -> conv1d -> RG-LRU] -> out

Ungated (full fine-tuning, and the scoring pass), the affine scan runs as
a log-depth doubling scan over S in plain PyTorch (``_assoc_scan``), where
the JAX package uses ``jax.lax.associative_scan``. Gated, the scan runs
in the chunked log-space form (``kernels/d2ft_rglru.py``): the plain
version on the masked path, the kernels on the kernel path. Serving
prefills through the same forward (``return_state``: the conv tail and
the last hidden state) and decodes with the single-step update
(``init_rglru_cache``, ``decode_rglru``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import RGLRUConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import (_gelu_tanh, _param, conv_tail,
                                       dense_init)

_C = 8.0
# chunk used by both the gated kernels and their masked plain version --
# they must match so the two paths see identical chunked-scan numerics
_SCAN_CHUNK = 128


class RGLRU(nn.Module):
    """w_gate_branch, w_rec_branch [d_model, W], conv_w [conv_width, W],
    conv_b, w_a, w_x [W, W], b_a, b_x, Lambda [W], w_out [W, d_model]: the
    JAX package's leaves."""

    def __init__(self, w_gate_branch, w_rec_branch, conv_w, conv_b, w_a, b_a,
                 w_x, b_x, Lambda, w_out):
        super().__init__()
        self.w_gate_branch = _param(w_gate_branch)
        self.w_rec_branch = _param(w_rec_branch)
        self.conv_w, self.conv_b = _param(conv_w), _param(conv_b)
        self.w_a, self.b_a = _param(w_a), _param(b_a)
        self.w_x, self.b_x = _param(w_x), _param(b_x)
        self.Lambda = _param(Lambda)
        self.w_out = _param(w_out)


def lambda_init(width: int) -> torch.Tensor:
    """``log(expm1(-log(linspace(0.9, 0.999, W)) / c))``, so that a^c lies
    in [0.9, 0.999] at r = 1 (Griffin appendix). Float32 on the host, as
    the JAX package computes it (x64 off), whatever the model's device.
    JAX's own float32 linspace rounds some entries an ulp away from
    torch's, and near 0.999 this function magnifies an ulp of its input
    about a thousandfold: the decays a agree within 1e-6, Lambda itself
    within 1e-4."""
    lin = torch.linspace(0.9, 0.999, width, dtype=torch.float32)
    return torch.log(torch.expm1(-torch.log(lin) / _C))


def init_rglru(gen: torch.Generator, d_model: int, cfg: RGLRUConfig,
               dtype) -> RGLRU:
    width = cfg.lru_width or d_model
    dev = gen.device

    def zeros():
        return torch.zeros((width,), dtype=dtype, device=dev)
    return RGLRU(
        dense_init(gen, d_model, width, dtype),
        dense_init(gen, d_model, width, dtype),
        (torch.randn((cfg.conv_width, width), generator=gen, device=dev)
         * 0.1).to(dtype),
        zeros(),
        dense_init(gen, width, width, dtype, scale=0.02), zeros(),
        dense_init(gen, width, width, dtype, scale=0.02), zeros(),
        lambda_init(width).to(device=dev, dtype=dtype),
        dense_init(gen, width, d_model, dtype))


def _rglru_log_gates(p: RGLRU, x):
    """x: [..., width] (post-conv). Returns (log_a, gated_input) in float32
    — the log-space operands the chunked and kernel scans consume."""
    r = torch.sigmoid(x @ p.w_a + p.b_a)
    i = torch.sigmoid(x @ p.w_x + p.b_x)
    log_a = -_C * F.softplus(p.Lambda.float()) * r.float()
    # JAX writes 1 - a * a with a = exp(log_a); XLA's algebraic simplifier
    # rewrites exp(x) * exp(x) to exp(x + x), so the jitted reference
    # computes 1 - exp(log_a + log_a), and so does the port
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(log_a + log_a), min=1e-12))
    b = beta * (i * x).float()
    return log_a, b


def _rglru_gates(p: RGLRU, x):
    """x: [..., width] (post-conv). Returns (a, gated_input)."""
    log_a, b = _rglru_log_gates(p, x)
    return torch.exp(log_a), b


def _assoc_scan(a, b):
    """Affine scan h_t = a_t h_{t-1} + b_t over dim 1 (a, b: [B, S, W]) as a
    doubling scan: after the step of offset k, (a_t, b_t) is the composed
    map of steps t-2k+1..t, so ceil(log2 S) elementwise steps give every
    prefix. Out of place, for autograd."""
    S = a.shape[1]
    k = 1
    while k < S:
        b = b + a * F.pad(b[:, :-k], (0, 0, k, 0))
        if 2 * k < S:
            a = a * F.pad(a[:, :-k], (0, 0, k, 0), value=1.0)
        k *= 2
    return b


def _causal_conv(x, conv_w, conv_b):
    """Depthwise causal conv over seq. x: [B, S, W]; conv_w: [conv_width,
    W]. The JAX package's order of sums."""
    K = conv_w.shape[0]
    S = x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], K - 1, x.shape[-1])), x], dim=1)
    out = xp[:, 0:S] * conv_w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * conv_w[i]
    return out + conv_b


def apply_rglru(p: RGLRU, x, cfg: RGLRUConfig,
                head_scale: Optional[torch.Tensor] = None,
                return_state: bool = False,
                gates: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                use_kernel: bool = False,
                live_bounds: Optional[Tuple[int, int]] = None):
    """Training forward. x: [B, S, d_model] -> [B, S, d_model].

    gates: optional per-group D2FT gates (g_f, g_b), each [B, G] in {0, 1}
    with g_b <= g_f — the G gate groups slice the LRU width into
    contiguous channel bands, gated on the scan output before the
    gate-branch multiply (the (1 - g_b) share detached). use_kernel runs
    the gated scan in the kernels (``ops._gated_rglru_impl``, unchecked:
    the fine-tune checks its gates once per step) with ``live_bounds`` =
    (live_fwd, live_bwd) band-slice upper bounds for compaction; otherwise
    the chunked plain version with the masked detach mix computes the same
    function. ``head_scale``: an optional [B, H] multiplier of H
    block-diagonal channel groups (each W / H wide) on the scan output.

    return_state: additionally return the decode cache after the last token
    (``init_rglru_cache``'s structure: the conv tail of raw pre-conv inputs
    plus the float32 hidden state) — the serving prefill dump. Under gates
    it takes the masked plain scan, as the JAX package does."""
    gate = _gelu_tanh(x @ p.w_gate_branch)
    u_raw = x @ p.w_rec_branch
    u = _causal_conv(u_raw, p.conv_w, p.conv_b)
    if gates is not None:
        g_f, g_b = gates
        log_a, b = _rglru_log_gates(p, u)
        lf, lb = live_bounds if live_bounds is not None else (None, None)
        h32 = kernel_ops._gated_rglru_impl(
            log_a, b, g_f, g_b, chunk=_SCAN_CHUNK, live_fwd=lf, live_bwd=lb,
            plain=return_state or not use_kernel)
    else:
        a, b = _rglru_gates(p, u)
        h32 = _assoc_scan(a, b)                         # [B, S, W] float32
    h = h32.to(x.dtype)
    if head_scale is not None:
        H = head_scale.shape[-1]
        # block-diagonal groups: channel c takes group c // (W / H)
        hs = torch.repeat_interleave(head_scale, h.shape[-1] // H, dim=-1)
        h = h * hs[:, None, :].to(h.dtype)
    out = (h * gate) @ p.w_out
    if return_state:
        return out, {"conv": conv_tail(u_raw, p.conv_w.shape[0]),
                     "h": h32[:, -1]}
    return out


def init_rglru_cache(batch: int, d_model: int, cfg: RGLRUConfig, dtype, *,
                     device):
    width = cfg.lru_width or d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, width), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, width), dtype=torch.float32, device=device),
    }


def decode_rglru(p: RGLRU, cache, x, cfg: RGLRUConfig):
    """One-token decode. x: [B,1,d_model]. Returns (y [B,1,d_model], new
    cache); the cache given is not modified. The gates take
    ``_rglru_log_gates``'s jitted form of 1 - a², as the forward does."""
    gate = _gelu_tanh(x @ p.w_gate_branch)
    u = x @ p.w_rec_branch
    conv_in = torch.cat([cache["conv"], u], dim=1)
    K = p.conv_w.shape[0]
    u1 = conv_in[:, 0] * p.conv_w[0]
    for i in range(1, K):
        u1 = u1 + conv_in[:, i] * p.conv_w[i]
    a, b = _rglru_gates(p, u1 + p.conv_b)               # [B, W]
    h = a * cache["h"] + b
    y = h.to(x.dtype)[:, None] * gate
    return y @ p.w_out, {"conv": conv_in[:, 1:], "h": h}
