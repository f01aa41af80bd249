"""Mamba-2 SSD (state-space duality) block, chunked-scan implementation
(port of the training and prefill forward of ``repro/models/ssm.py``).

Follows arXiv:2405.21060: per-head scalar decay a_t = exp(dt_t * A_h),
state update h_t = a_t h_{t-1} + dt_t * x_t B_t^T, output y_t = C_t h_t +
D x_t. The chunked algorithm (intra-chunk quadratic term, inter-chunk
recurrence) is ``kernels/d2ft_ssd.py::ssd_scan_ref``; the gated kernel
route is ``kernels/ops.py::gated_ssd_scan``. The decode recurrence
(``init_ssd_cache``, ``decode_ssd``) and ``return_state`` come with the
serving slice of this family.

Shapes: d_inner = expand * d_model, H = d_inner // head_dim (P), state N.
Single B/C group (ngroups=1) as in mamba2-130m.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import d2ft_ssd, ops as kernel_ops
from repro_torch.models.layers import _param, dense_init


def _dims(d_model: int, cfg: SSMConfig):
    d_inner = cfg.expand * d_model
    H = d_inner // cfg.head_dim
    return d_inner, H, cfg.head_dim, cfg.state_dim


class SSD(nn.Module):
    """w_in [d_model, 2*d_inner + 2N + H] (z | xBC | dt), conv_w
    [conv_width, d_inner + 2N], conv_b, A_log, dt_bias, D [H], norm_scale
    [d_inner], w_out [d_inner, d_model]: the JAX package's leaves."""

    def __init__(self, w_in, conv_w, conv_b, A_log, dt_bias, D, norm_scale,
                 w_out):
        super().__init__()
        self.w_in, self.conv_w, self.conv_b = (
            _param(w_in), _param(conv_w), _param(conv_b))
        self.A_log, self.dt_bias, self.D = (
            _param(A_log), _param(dt_bias), _param(D))
        self.norm_scale, self.w_out = _param(norm_scale), _param(w_out)


def init_ssd(gen: torch.Generator, d_model: int, cfg: SSMConfig,
             dtype) -> SSD:
    d_inner, H, P, N = _dims(d_model, cfg)
    conv_ch = d_inner + 2 * N
    dev = gen.device
    w_in = dense_init(gen, d_model, 2 * d_inner + 2 * N + H, dtype)
    conv_w = (torch.randn((cfg.conv_width, conv_ch), generator=gen,
                          device=dev) * 0.1).to(dtype)
    w_out = dense_init(gen, d_inner, d_model, dtype)

    def full(n, v):
        return torch.full((n,), v, dtype=dtype, device=dev)
    return SSD(w_in, conv_w, full(conv_ch, 0.0), full(H, 0.0), full(H, 0.0),
               full(H, 1.0), full(d_inner, 1.0), w_out)


def _split_in(p: SSD, x, d_model: int, cfg: SSMConfig):
    d_inner, H, P, N = _dims(d_model, cfg)
    zxbcdt = x @ p.w_in
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * N:]
    return z, xBC, dt


def _causal_conv(xBC, conv_w, conv_b, prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv over seq. xBC: [B,S,Ch]; prev: [B,W-1,Ch]."""
    W = conv_w.shape[0]
    if prev is None:
        prev = xBC.new_zeros((xBC.shape[0], W - 1, xBC.shape[-1]))
    xp = torch.cat([prev, xBC], dim=1)                  # [B, S+W-1, Ch]
    S = xBC.shape[1]
    out = xp[:, 0:S] * conv_w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * conv_w[i]
    return F.silu(out + conv_b)


def _gated_rmsnorm(y, z, scale, eps: float = 1e-6):
    y = y * F.silu(z)
    var = torch.mean(y.float() ** 2, dim=-1, keepdim=True)
    return (y.float() * torch.rsqrt(var + eps)).to(y.dtype) * scale


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int,
                return_final_state: bool = False):
    """Core SSD. xh: [B,S,H,P]; dt: [B,S,H]; A: [H] (negative); Bm, Cm:
    [B,S,N]. Returns y: [B,S,H,P]. Odd lengths zero-pad to the chunk (a
    padded row has zero log-decay and zero input)."""
    if return_final_state:
        raise NotImplementedError(
            "return_final_state is not ported yet: it comes with the serving "
            "slice of the SSM family")
    dA = dt * A[None, None, :]                          # [B,S,H] (negative)
    xbar = xh * dt[..., None]                           # dt-weighted input
    return kernel_ops._padded_scan(d2ft_ssd.ssd_scan_ref, xbar, dA, Bm, Cm,
                                   chunk=chunk).to(xh.dtype)


def apply_ssd(p: SSD, x, d_model: int, cfg: SSMConfig,
              head_scale: Optional[torch.Tensor] = None,
              return_state: bool = False,
              gates: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              use_kernel: bool = False,
              live_bounds: Optional[Tuple[int, int]] = None):
    """Training/prefill forward. x: [B,S,d_model] -> [B,S,d_model].

    gates: optional per-head D2FT gates (g_f, g_b), each [B, H] in {0, 1}
    with g_b <= g_f — the scan output is gated per (sample, head) *before*
    the D-residual (the skip connection IS the p_s shortcut path) with the
    (1 - g_b) share detached. use_kernel routes the gated scan through the
    kernels (``ops.gated_ssd_scan``, unchecked: the fine-tune checks its
    gates once per step) with ``live_bounds`` = (live_fwd, live_bwd)
    head-slice upper bounds for compaction; otherwise the plain version of
    the kernels (``d2ft_ssd.gated_ssd_ref``, the masked mix over the dense
    chunked scan) computes the same function.
    """
    if return_state:
        raise NotImplementedError(
            "return_state (the decode cache dump) is not ported yet: it "
            "comes with the serving slice of the SSM family")
    d_inner, H, P, N = _dims(d_model, cfg)
    z, xBC_raw, dt = _split_in(p, x, d_model, cfg)
    xBC = _causal_conv(xBC_raw, p.conv_w, p.conv_b)
    xin = xBC[..., :d_inner].reshape(*x.shape[:2], H, P)
    Bm = xBC[..., d_inner:d_inner + N]
    Cm = xBC[..., d_inner + N:]
    dt = F.softplus(dt + p.dt_bias)
    A = -torch.exp(p.A_log.float())
    if gates is None:
        y = ssd_chunked(xin, dt, A, Bm, Cm, cfg.chunk)
    else:
        # the kernel path and the masked path share the padding and the
        # operands; the masked path takes the plain version on any device
        g_f, g_b = gates
        dA = dt * A[None, None, :]
        xbar = xin * dt[..., None]
        lf, lb = live_bounds if live_bounds is not None else (None, None)
        y = kernel_ops._gated_ssd_impl(
            xbar, dA, Bm, Cm, g_f, g_b, chunk=cfg.chunk, live_fwd=lf,
            live_bwd=lb, plain=not use_kernel).to(xin.dtype)
    y = y + p.D[None, None, :, None] * xin
    if head_scale is not None:
        y = y * head_scale[:, None, :, None].to(y.dtype)
    y = y.reshape(*x.shape[:2], d_inner)
    y = _gated_rmsnorm(y, z, p.norm_scale)
    return y @ p.w_out
