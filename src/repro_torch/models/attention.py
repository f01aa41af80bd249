"""GQA attention: causal, bidirectional and sliding-window (block-local,
subquadratic), the gated kernel route of the fine-tune, and single-token
decode against full-length or ring KV caches. Port of the training,
prefill and contiguous-decode subset of ``repro/models/attention.py``:
plain tensor code, except ``gated_kernel_attention``, which calls the gated
flash kernels (``kernels/d2ft_attention.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.d2ft_attention import gated_flash_attention
from repro_torch.models.layers import _param, apply_rope, dense_init

NEG_INF = -2.0 ** 30


# ------------------------------------------------------------------- params
class Attention(nn.Module):
    """wq [d, H*hd], wk/wv [d, n_kv*hd], wo [H*hd, d]; optional biases."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (
            _param(wq), _param(wk), _param(wv), _param(wo))
        if bq is not None:
            self.bq, self.bk, self.bv = _param(bq), _param(bk), _param(bv)


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, qkv_bias: bool,
                   dtype) -> Attention:
    wq = dense_init(gen, d_model, n_heads * head_dim, dtype)
    wk = dense_init(gen, d_model, n_kv_heads * head_dim, dtype)
    wv = dense_init(gen, d_model, n_kv_heads * head_dim, dtype)
    wo = dense_init(gen, n_heads * head_dim, d_model, dtype)
    biases = {}
    if qkv_bias:
        dev = gen.device
        biases = {
            "bq": torch.zeros((n_heads * head_dim,), dtype=dtype, device=dev),
            "bk": torch.zeros((n_kv_heads * head_dim,), dtype=dtype,
                              device=dev),
            "bv": torch.zeros((n_kv_heads * head_dim,), dtype=dtype,
                              device=dev)}
    return Attention(wq, wk, wv, wo, **biases)


def _project_qkv(p: Attention, x, n_heads, n_kv_heads, head_dim):
    B, S, _ = x.shape
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if hasattr(p, "bq"):
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, S, n_kv_heads, head_dim)
    v = v.reshape(B, S, n_kv_heads, head_dim)
    return q, k, v


def _repeat_kv(k, Hq: int):
    """[B,S,Hkv,hd] -> [B,S,Hq,hd] (kv head g serves query heads
    g*rep .. g*rep+rep-1)."""
    Hkv = k.shape[2]
    if Hkv == Hq:
        return k
    return torch.repeat_interleave(k, Hq // Hkv, dim=2)


def gated_kernel_attention(q, k, v, g_f, g_b, *, causal: bool,
                           window: int = 0,
                           live_bounds: Optional[Tuple[int, int]] = None):
    """Kernel attention with D2FT (g_f, g_b) head gates.

    q: [B,S,Hq,hd]; k, v: [B,S,Hkv,hd] (GQA expanded here); g_f, g_b:
    [B,Hq] in {0,1}. Returns [B,S,Hq,hd]. The forward output is g_f-gated
    (p_s heads are zeros and run nothing); the backward skips every
    (sample, head) slice with g_b == 0 (p_o and p_s). live_bounds: optional
    (live_fwd, live_bwd) upper bounds on the g_f != 0 / g_b != 0 (sample,
    head) slice counts, for the kernels' compaction. Calls the kernel
    module's ``gated_flash_attention`` directly, with shape checks only:
    the gates' values are the caller's contract (no host sync per layer).
    """
    Hq = q.shape[2]
    k = _repeat_kv(k, Hq)
    v = _repeat_kv(v, Hq)
    live_f, live_b = live_bounds if live_bounds is not None else (None, None)
    out = gated_flash_attention(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), g_f, g_b, causal=causal,
        window=window, live_fwd=live_f, live_bwd=live_b)
    return out.transpose(1, 2)


def _scale(hd: int, dtype, device):
    # 1/sqrt(hd) rounded in float32 as the JAX package rounds it
    return (1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                          device=device))).to(dtype)


def _sdpa(q, k, v, mask):
    """q: [B,Sq,Hq,hd]; k,v: [B,Sk,Hkv,hd]; mask: broadcastable
    [B,1,Sq,Sk] boolean (True = attend). GQA via KV head repetition."""
    B, Sq, Hq, hd = q.shape
    k = _repeat_kv(k, Hq)
    v = _repeat_kv(v, Hq)
    logits = torch.einsum("bqhd,bkhd->bhqk", q * _scale(hd, q.dtype, q.device),
                          k)
    logits = torch.where(mask, logits.float(),
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _causal_mask(Sq, Sk, offset=0, device=None):
    # True where key position <= query position (+offset aligns positions)
    qpos = torch.arange(Sq, device=device)[:, None] + offset
    kpos = torch.arange(Sk, device=device)[None, :]
    return (kpos <= qpos)[None, None]


def _window_mask(Sq, Sk, window, offset=0, device=None):
    qpos = torch.arange(Sq, device=device)[:, None] + offset
    kpos = torch.arange(Sk, device=device)[None, :]
    return ((kpos <= qpos) & (kpos > qpos - window))[None, None]


# ----------------------------------------------------------- train / prefill
def dense_attention(q, k, v, *, causal: bool, window: int = 0):
    """Attention without the kernels: q [B,S,Hq,hd], k, v [B,S,Hkv,hd] ->
    [B,S,Hq,hd]. window > 0 selects sliding-window attention, block-local
    (subquadratic) when S > 2*window and S % window == 0; else the causal
    or full mask."""
    S = q.shape[1]
    if window and window > 0 and S > 2 * window and S % window == 0:
        return _block_local_attention(q, k, v, window)
    if window and window > 0:
        mask = _window_mask(S, S, window, device=q.device)
    elif causal:
        mask = _causal_mask(S, S, device=q.device)
    else:
        mask = torch.ones((1, 1, S, S), dtype=torch.bool, device=q.device)
    return _sdpa(q, k, v, mask)


def apply_attention(p: Attention, x, *, n_heads: int, n_kv_heads: int,
                    head_dim: int, causal: bool, window: int = 0,
                    rope: bool = True, rope_theta: float = 10_000.0,
                    positions: Optional[torch.Tensor] = None,
                    return_kv: bool = False):
    """Returns attention block output [B,S,d_model].

    window > 0 selects sliding-window attention; when S > 2*window and
    S % window == 0 the block-local (chunked) subquadratic implementation
    is used. return_kv: additionally return the post-rope (k, v)
    [B,S,n_kv,hd] that the serving prefill writes into the KV pages.
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    if rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    out = dense_attention(q, k, v, causal=causal, window=window)
    out = out.reshape(B, S, n_heads * head_dim) @ p.wo
    if return_kv:
        return out, k, v
    return out


def _block_local_attention(q, k, v, window: int):
    """Subquadratic sliding-window attention: chunk queries by `window`;
    each chunk attends to itself + the previous chunk under an exact
    (kpos <= qpos) & (kpos > qpos - window) mask. O(S * 2W) work."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    C = S // window
    qc = q.reshape(B, C, window, Hq, hd)
    kc = k.reshape(B, C, window, Hkv, hd)
    vc = v.reshape(B, C, window, Hkv, hd)
    # previous chunk (zeros for the first chunk)
    kprev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    kcat = torch.cat([kprev, kc], dim=2)          # [B,C,2W,Hkv,hd]
    vcat = torch.cat([vprev, vc], dim=2)
    kcat = _repeat_kv(kcat.reshape(B, C * 2 * window, Hkv, hd), Hq) \
        .reshape(B, C, 2 * window, Hq, hd)
    vcat = _repeat_kv(vcat.reshape(B, C * 2 * window, Hkv, hd), Hq) \
        .reshape(B, C, 2 * window, Hq, hd)
    dev = q.device
    qpos = torch.arange(window, device=dev)[:, None] + window  # in [W, 2W)
    kpos = torch.arange(2 * window, device=dev)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)      # [W, 2W]
    # first chunk: mask out the zero-padded "previous" half
    first = (kpos >= window) & mask
    mask_all = mask.expand(C, window, 2 * window).clone()
    mask_all[0] = first
    logits = torch.einsum("bcqhd,bckhd->bchqk",
                          qc * _scale(hd, q.dtype, dev), kcat)
    logits = torch.where(mask_all[None, :, None], logits.float(),
                         torch.tensor(NEG_INF, device=dev))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bchqk,bckhd->bcqhd", probs, vcat)
    return out.reshape(B, S, Hq, hd)


def kv_prefill_cache(k, v, window: int, max_len: int) -> dict:
    """Full-history prefill K/V [B,S,n_kv,hd] -> the ``init_kv_cache``
    decode layout, so ``decode_attention`` can continue from position S.

    Global layers get the zero-padded [B, max_len, ...] cache. Local layers
    get the [B, W, ...] ring buffer: slot ``p % W`` holds position ``p`` for
    the last ``min(S, W)`` positions — the state a sequential decode-path
    prefill would have left, so the next decode step (t = S) overwrites the
    slot whose position just fell out of the window."""
    B, S = k.shape[:2]
    if window and window > 0:
        L = window
        m = min(S, L)
        pos = torch.arange(S - m, S, device=k.device)
        kc = k.new_zeros((B, L) + tuple(k.shape[2:]))
        vc = v.new_zeros((B, L) + tuple(v.shape[2:]))
        kc[:, pos % L] = k[:, pos]
        vc[:, pos % L] = v[:, pos]
        return {"k": kc, "v": vc}
    if S > max_len:
        raise ValueError(f"prompt length {S} exceeds cache max_len "
                         f"{max_len}")
    kc = k.new_zeros((B, max_len) + tuple(k.shape[2:]))
    vc = v.new_zeros((B, max_len) + tuple(v.shape[2:]))
    kc[:, :S] = k
    vc[:, :S] = v
    return {"k": kc, "v": vc}


# -------------------------------------------------------------------- decode
def init_kv_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                  window: int, dtype, *, device) -> dict:
    L = window if window and window > 0 else max_len
    shape = (batch, L, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p: Attention, cache: dict, x, *, t: int, n_heads: int,
                     n_kv_heads: int, head_dim: int, window: int = 0,
                     rope: bool = True, rope_theta: float = 10_000.0):
    """One-token decode. x: [B, 1, d_model]; t: tokens already in the cache
    (the new token has position t), a host int. Global caches are
    [B, max_len, ...]; local caches are ring buffers [B, W, ...]. The new
    K/V row is written into the cache in place; returns (out [B, 1,
    d_model], cache)."""
    B = x.shape[0]
    t = int(t)
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    if rope:
        pos = torch.full((B, 1), t, dtype=torch.long, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    kc, vc = cache["k"], cache["v"]
    L = kc.shape[1]
    # ring buffer for local layers; a full-length cache's last slot takes
    # any position past it, as the JAX package's min(t, L - 1) does
    slot = t % L if window and window > 0 else min(t, L - 1)
    kc[:, slot] = k[:, 0]
    vc[:, slot] = v[:, 0]
    idx = torch.arange(L, device=x.device)
    if window and window > 0:
        # absolute position held by ring slot s after writing token t
        abs_pos = t - torch.remainder(t - idx, L)
        valid = (abs_pos >= 0) & (abs_pos <= t) & (abs_pos > t - window)
    else:
        valid = idx <= t
    out = _sdpa(q, kc, vc, valid[None, None, None, :])     # [B,1,Hq,hd]
    return out.reshape(B, 1, n_heads * head_dim) @ p.wo, cache
