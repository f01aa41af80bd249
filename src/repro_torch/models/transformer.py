"""Transformer backbone (port of ``repro/models/transformer.py``).

The model holds a flat list of layers: layer ``i`` is ``model.layers[i]``.
The JAX package stacks layers per pattern cycle for ``lax.scan``;
``repro_torch.interop.params_from_jax`` unstacks cycle ``c``, position
``j`` into layer ``c*P + j``. PyTorch runs eagerly, so there is nothing to
gain from the stacked layout here.

Ported so far: dense attention blocks (global and sliding-window, causal
or bidirectional, with or without q / k / v biases) with a dense or an
MoE FFN (shared experts too), SSD blocks (mamba2: no FFN), RG-LRU blocks
with a dense FFN (and so the hybrid recurrentgemma pattern), the
D2FT-gated block forward (``apply_block``), ``forward`` (with remat) with
the MoE aux losses and the stub frontends' features (a projector,
``frontend_proj``, puts them ahead of the token embeddings; an audio
encoder takes them alone), the LLM loss (``fused_xent``, ``lm_loss``,
over the text region where features come first), and serving:
the batched prefill with its cache dump (``prefill_forward``) and the
contiguous-cache decode (``init_cache``, ``decode_step``) of every block
kind.
Gating: ``gates = (g_f, g_b)`` of shape [n_layers, B, G]; per block, the
residual contribution is split into G head/width groups c_g and mixed as

    c_eff = g_f * (g_b * c_g + (1 - g_b) * c_g.detach()),

which is p_f (1, 1), p_o (1, 0) and p_s (0, ·) exactly: p_o keeps the
forward value but no gradient flows through the subnet for that sample;
p_s removes the contribution. An SSD block gates its scan per (sample,
head) instead (``models/ssm.apply_ssd``), an RG-LRU block per (sample,
channel band) (``models/rglru.apply_rglru``), and an MoE FFN is one group
whose gates also drive its dispatch (``models/moe.apply_moe``).

Tensor parallelism (``tp``: the tensor axis of a ``launch.mesh.Mesh``, a
``DataMesh`` of T ranks): Megatron-style, each rank computes only its
contiguous block of attention heads and of FFN columns (the weights stay
whole on every rank and the block is sliced where the layer reads them,
so a ZeRO-3 step's installed full views are sliced too), and the partial
residual contributions are summed over the axis. ``_tp_copy`` (identity
forward, all-reduce backward) enters each region and ``_tp_sum``
(all-reduce forward, identity backward) leaves it. SSD, RG-LRU and MoE
compute stays replicated under ``tp``, with no reduction. The
sharding-policy and expert-parallel branches come with a later slice.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import contract as kernel_contract

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, SSD,
                                      ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (_act, _param, apply_embedding,
                                       apply_norm, dense_init, init_embedding,
                                       init_mlp, init_norm, softcap,
                                       torch_dtype)


def _not_ported_dist(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the distributed slice")


# ============================================================ gating helpers
def gate_mix(c_g, g_f, g_b):
    """c_g: [B,S,G,D]; g_f,g_b: [B,G] in {0,1}. See module docstring."""
    gf = g_f[:, None, :, None].to(c_g.dtype)
    gb = g_b[:, None, :, None].to(c_g.dtype)
    return gf * (gb * c_g + (1.0 - gb) * c_g.detach())


def _group_project(heads_out, wo, G):
    """heads_out: [B,S,H,hd]; wo: [H*hd, D]. Returns per-group projected
    contributions [B,S,G,D] (sum over G == plain projection)."""
    B, S, H, hd = heads_out.shape
    D = wo.shape[-1]
    w3 = wo.reshape(H, hd, D)
    per_head = torch.einsum("bshd,hdD->bshD", heads_out, w3)
    return per_head.reshape(B, S, G, H // G, D).sum(dim=3)


# =================================================== tensor-parallel helpers
# tp: the tensor axis (``launch.mesh.DataMesh``: ``rank``, ``size`` and a
# counted ``sum_``). Every all-reduce of an activation or its cotangent
# counts under the kind "tp_act".
class _TPCopy(torch.autograd.Function):
    """Megatron's f operator: identity forward, all-reduce backward. It
    enters every tensor-parallel region, so the activation cotangent, which
    each rank computes only for its own head / column block, is summed,
    keeping the grads of everything upstream replicated and exact."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        ctx.tp.sum_(g, "tp_act")
        return g, None


class _TPSum(torch.autograd.Function):
    """Megatron's g operator: all-reduce forward, identity backward. It
    leaves every tensor-parallel region; the cotangent downstream is
    replicated over the axis, so the backward must NOT reduce it again
    (pinned here explicitly, as the JAX package's custom VJP does)."""

    @staticmethod
    def forward(ctx, x, tp):
        y = x.clone(memory_format=torch.contiguous_format)
        tp.sum_(y, "tp_act")
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _tp_copy(x, tp):
    return _TPCopy.apply(x, tp)


def _tp_sum(x, tp):
    return _TPSum.apply(x, tp)


def _tp_gate_slice(layer_gates, idx: int, G_local: int):
    """This rank's contiguous block of head-group gates ([B, G] pair)."""
    g_f, g_b = layer_gates
    return (g_f[:, idx * G_local:(idx + 1) * G_local],
            g_b[:, idx * G_local:(idx + 1) * G_local])


def _check_tp_heads(n_heads: int, n_kv: int, G: Optional[int], T: int):
    if n_heads % T or n_kv % T or (G is not None and G % T):
        raise ValueError(
            f"tensor={T} must divide n_heads={n_heads}, n_kv_heads={n_kv}"
            + ("" if G is None else f" and the G={G} gate groups"))


def _check_tp_ffn(F: int, G: Optional[int], T: int):
    if F % T or (G is not None and (G % T or F % G)):
        raise ValueError(
            f"tensor={T} must divide the FFN width {F}"
            + ("" if G is None else
               f", and the G={G} gate groups, which must divide it too"))


def check_tp_tiling(cfg: ModelConfig, G: int, T: int):
    """ValueError unless a tensor axis of T tiles the model at G gate
    groups: T divides the query and KV heads and G, and G divides a dense
    FFN's width (each rank's F/T columns are whole gate groups): the JAX
    package's assertions, which its layers make (so do the port's)."""
    _check_tp_heads(cfg.n_heads, cfg.n_kv_heads, G, T)
    if cfg.moe is None and cfg.d_ff > 0:
        _check_tp_ffn(cfg.d_ff, G, T)


# ============================================================== block params
class Block(nn.Module):
    """Pre-norm residual block: norm1 + a mixer (``attn``, ``ssd`` or
    ``rglru``), then, where the config has an FFN, norm2 + ``mlp`` (dense)
    or ``moe``."""

    def __init__(self, norm1, attn_mod=None, norm2=None, mlp=None, ssd=None,
                 rglru=None, moe=None):
        super().__init__()
        self.norm1 = norm1
        if attn_mod is not None:
            self.attn = attn_mod
        if ssd is not None:
            self.ssd = ssd
        if rglru is not None:
            self.rglru = rglru
        if mlp is not None or moe is not None:
            self.norm2 = norm2
        if mlp is not None:
            self.mlp = mlp
        if moe is not None:
            self.moe = moe

    def forward(self, x, kind: str, cfg: ModelConfig, layer_gates=None,
                use_kernel: bool = False, live_bounds=None, tp=None):
        """``apply_block`` as a module call, so that hooks on the block
        (the streamed ZeRO-3 step's) see the layer run."""
        return apply_block(self, x, kind, cfg, layer_gates,
                           use_kernel=use_kernel, live_bounds=live_bounds,
                           tp=tp)


def _init_block(gen: torch.Generator, kind: str, cfg: ModelConfig,
                dtype) -> Block:
    dev = gen.device
    if kind not in (ATTN_GLOBAL, ATTN_LOCAL, SSD, RGLRU):
        raise ValueError(kind)
    norm1 = init_norm(cfg.norm, cfg.d_model, dtype, dev)
    if kind == SSD:
        s = ssm_mod.init_ssd(gen, cfg.d_model, cfg.ssm, dtype)
        if cfg.d_ff <= 0:                   # mamba2: no FFN
            return Block(norm1, ssd=s)
        return Block(norm1, None, init_norm(cfg.norm, cfg.d_model, dtype, dev),
                     init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated,
                              dtype), ssd=s)
    a = r = None
    if kind == RGLRU:
        r = rglru_mod.init_rglru(gen, cfg.d_model, cfg.rglru, dtype)
    else:
        a = attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.resolved_head_dim,
                                cfg.qkv_bias, dtype)
    if cfg.moe is not None:
        return Block(norm1, a, init_norm(cfg.norm, cfg.d_model, dtype, dev),
                     rglru=r, moe=moe_mod.init_moe(gen, cfg.d_model,
                                                   cfg.moe, dtype))
    if cfg.d_ff <= 0:
        return Block(norm1, a, rglru=r)
    return Block(norm1, a, init_norm(cfg.norm, cfg.d_model, dtype, dev),
                 init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype),
                 rglru=r)


def _apply_ffn(p: Block, h, cfg: ModelConfig, layer_gates=None,
               use_kernel: bool = False, live_bounds=None, tp=None):
    """The JAX ``_apply_ffn`` but its policy branches. Returns (y, aux).

    MoE: one D2FT group, so the block's gates are those of group 0
    (``g_f[:, 0]``, ``g_b[:, 0]`` per sample), which also drive the
    dispatch; use_kernel runs the experts through the MoE kernels, whose
    grids stop at the live-token bounds ``min(B, live_bounds[k]) · S``
    (backward apart). ``gate_mix`` on group 0 mixes the output. Dense:
    plain, or split into G column groups of w_down and mixed by
    ``gate_mix``; aux is None. Under ``tp`` a dense FFN computes this
    rank's F/T-column block of w_up / w_gate / w_down (T | G and G | F
    keep the grouped w_down reshape exact) and sums the contribution over
    the axis; an MoE FFN runs replicated."""
    if hasattr(p, "moe"):
        moe_gates = live_toks = bwd_toks = None
        if layer_gates is not None:
            g_f, g_b = layer_gates
            moe_gates = (g_f[:, 0], g_b[:, 0])
            if live_bounds is not None:
                B, S = h.shape[:2]
                live_toks = min(B, live_bounds[0]) * S
                bwd_toks = min(B, live_bounds[1]) * S
        y, aux = moe_mod.apply_moe(p.moe, h, cfg.moe, act=cfg.mlp_act,
                                   gates=moe_gates, use_kernel=use_kernel,
                                   live_tokens=live_toks,
                                   live_bwd_tokens=bwd_toks)
        if layer_gates is not None:
            g_f, g_b = layer_gates
            y = gate_mix(y[:, :, None, :], g_f[:, :1], g_b[:, :1])[:, :, 0]
        return y, aux
    mlp = p.mlp
    if tp is not None:
        T, idx = tp.size, tp.rank
        F_full = mlp.w_up.shape[-1]
        G = None if layer_gates is None else layer_gates[0].shape[-1]
        _check_tp_ffn(F_full, G, T)
        if layer_gates is not None:
            layer_gates = _tp_gate_slice(layer_gates, idx, G // T)
        h = _tp_copy(h, tp)
        Fl = F_full // T
        mlp = SimpleNamespace(w_up=mlp.w_up.narrow(1, idx * Fl, Fl),
                              w_down=mlp.w_down.narrow(0, idx * Fl, Fl),
                              w_gate=mlp.w_gate.narrow(1, idx * Fl, Fl)
                              if cfg.mlp_gated else None)
    up = h @ mlp.w_up
    if cfg.mlp_gated:
        hid = _act(cfg.mlp_act)(h @ mlp.w_gate) * up
    else:
        hid = _act(cfg.mlp_act)(up)
    if layer_gates is None:
        y = hid @ mlp.w_down
    else:
        g_f, g_b = layer_gates
        G = g_f.shape[-1]
        B, S, F = hid.shape
        D = mlp.w_down.shape[-1]
        wd = mlp.w_down.reshape(G, F // G, D)
        c_g = torch.einsum("bsgf,gfD->bsgD", hid.reshape(B, S, G, F // G),
                           wd)
        y = gate_mix(c_g, g_f, g_b).sum(dim=2)
    return (y if tp is None else _tp_sum(y, tp)), None


def _apply_attn_inner(p, h, kind: str, cfg: ModelConfig, layer_gates,
                      use_kernel: bool = False, live_bounds=None, tp=None):
    """Attention contribution (pre-residual), with per-head-group gating
    (the JAX function but its policy branches).

    use_kernel routes attention through the gated flash kernels, whose
    backward skips every g_b == 0 (sample, head) slice. live_bounds: the
    (live_fwd, live_bwd) bounds at (sample, group) granularity
    (``core.schedule.live_slice_bounds``), scaled here to per-head slice
    counts for the kernels' compaction. tp: shard the heads over the
    tensor axis; contiguous head blocks keep the GQA query -> kv mapping and
    the head-group gate tiling exact when T divides H, H_kv and G (no
    kernel route)."""
    window = cfg.window if kind == ATTN_LOCAL else 0
    hd = cfg.resolved_head_dim
    B, S, _ = h.shape
    n_heads, n_kv = cfg.n_heads, cfg.n_kv_heads
    if tp is not None:
        T, idx = tp.size, tp.rank
        if use_kernel:
            raise ValueError("tensor parallelism has no kernel route")
        G = None if layer_gates is None else layer_gates[0].shape[-1]
        _check_tp_heads(n_heads, n_kv, G, T)
        h = _tp_copy(h, tp)
        hq, hkv = n_heads // T, n_kv // T

        def sl(a, width, dim):
            return a.narrow(dim, idx * width, width)

        q_cols, kv_cols = hq * hd, hkv * hd
        p = SimpleNamespace(
            wq=sl(p.wq, q_cols, 1), wk=sl(p.wk, kv_cols, 1),
            wv=sl(p.wv, kv_cols, 1), wo=sl(p.wo, q_cols, 0),
            **({"bq": sl(p.bq, q_cols, 0), "bk": sl(p.bk, kv_cols, 0),
                "bv": sl(p.bv, kv_cols, 0)} if hasattr(p, "bq") else {}))
        n_heads, n_kv = hq, hkv
        if layer_gates is not None:
            layer_gates = _tp_gate_slice(layer_gates, idx, G // T)
    q, k, v = attn._project_qkv(p, h, n_heads, n_kv, hd)
    if cfg.rope:
        pos = torch.arange(S, device=h.device)[None, :]
        q = attn.apply_rope(q, pos, cfg.rope_theta)
        k = attn.apply_rope(k, pos, cfg.rope_theta)
    if use_kernel:
        # the window branch is always causal-windowed, as _window_mask is
        kernel_bounds = None
        if layer_gates is None:
            gf_h = gb_h = torch.ones((B, n_heads), dtype=h.dtype,
                                     device=h.device)
        else:
            g_f, g_b = layer_gates
            rep = n_heads // g_f.shape[-1]
            gf_h = torch.repeat_interleave(g_f, rep, dim=1).to(h.dtype)
            gb_h = torch.repeat_interleave(g_b, rep, dim=1).to(h.dtype)
            if live_bounds is not None:
                # schedule bounds are per (sample, group); each group is
                # rep consecutive per-head slices after the expansion above
                kernel_bounds = (live_bounds[0] * rep, live_bounds[1] * rep)
        out = attn.gated_kernel_attention(q, k, v, gf_h, gb_h,
                                          causal=cfg.causal or window > 0,
                                          window=window,
                                          live_bounds=kernel_bounds)
    else:
        out = attn.dense_attention(q, k, v, causal=cfg.causal, window=window)
    if layer_gates is None:
        c = out.reshape(B, S, n_heads * hd) @ p.wo
    else:
        # group-wise projection + gate_mix: on the kernel path this also
        # cuts wo gradients for p_o groups, matching the masked path exactly
        g_f, g_b = layer_gates
        c_g = _group_project(out, p.wo, g_f.shape[-1])     # [B,S,G,D]
        c = gate_mix(c_g, g_f, g_b).sum(dim=2)
    return c if tp is None else _tp_sum(c, tp)


def _apply_ssd_inner(p: ssm_mod.SSD, h, cfg: ModelConfig, layer_gates,
                     use_kernel: bool = False, live_bounds=None):
    """SSD contribution (pre-residual), gated per SSD head."""
    if layer_gates is None:
        return ssm_mod.apply_ssd(p, h, cfg.d_model, cfg.ssm)
    g_f, g_b = layer_gates
    G = g_f.shape[-1]
    d_inner, H, P, N = ssm_mod._dims(cfg.d_model, cfg.ssm)
    if H % G != 0:
        # heads don't tile into gate groups: no kernel route. On the CPU
        # this takes JAX's coarse block-granularity run-twice mix
        # (test-scale only); on the card the kernel path refuses it
        if use_kernel:
            if h.device.type != "cpu":
                raise ValueError(
                    f"the {H} SSD heads do not tile into G={G} gate groups: "
                    "no kernel route; choose head_groups dividing the heads")
            kernel_contract.report_fallback(
                "ssd", f"H={H} not divisible by G={G} gate groups")
        full = ssm_mod.apply_ssd(p, h, cfg.d_model, cfg.ssm)
        sg = full.detach()
        gf = g_f[:, :1].mean(-1)[:, None, None]         # block granularity
        gb = g_b[:, :1].mean(-1)[:, None, None]
        return gf * (gb * full + (1 - gb) * sg)
    # gate per SSD head: each of the G schedule groups spans H // G
    # consecutive heads; the scan is gated per (sample, head) inside
    # apply_ssd (kernel or masked mix) before the D-residual shortcut
    rep = H // G
    gf_h = torch.repeat_interleave(g_f, rep, dim=1).float()
    gb_h = torch.repeat_interleave(g_b, rep, dim=1).float()
    kernel_bounds = None
    if live_bounds is not None:
        kernel_bounds = (live_bounds[0] * rep, live_bounds[1] * rep)
    return ssm_mod.apply_ssd(p, h, cfg.d_model, cfg.ssm, gates=(gf_h, gb_h),
                             use_kernel=use_kernel, live_bounds=kernel_bounds)


def _apply_rglru_inner(p: rglru_mod.RGLRU, h, cfg: ModelConfig, layer_gates,
                       use_kernel: bool = False, live_bounds=None):
    """RG-LRU contribution (pre-residual), gated per (sample, channel
    band)."""
    if layer_gates is None:
        return rglru_mod.apply_rglru(p, h, cfg.rglru)
    g_f, g_b = layer_gates
    G = g_f.shape[-1]
    W = cfg.rglru.lru_width or cfg.d_model
    if W % G != 0:
        # the width doesn't tile into gate groups: no kernel route. On the
        # CPU this takes JAX's coarse block-granularity run-twice mix
        # (test-scale only); on the card the kernel path refuses it
        if use_kernel:
            if h.device.type != "cpu":
                raise ValueError(
                    f"the lru width {W} does not tile into G={G} gate "
                    "groups: no kernel route; choose head_groups dividing "
                    "the width")
            kernel_contract.report_fallback(
                "rglru", f"lru width={W} not divisible by G={G} gate groups")
        full = rglru_mod.apply_rglru(p, h, cfg.rglru)
        sg = full.detach()
        gf = g_f[:, :1].mean(-1)[:, None, None]
        gb = g_b[:, :1].mean(-1)[:, None, None]
        return gf * (gb * full + (1 - gb) * sg)
    # gates stay at (sample, group) granularity: the G groups slice the LRU
    # width into contiguous channel bands (the kernel's slice axis is B*G,
    # so the schedule's live bounds pass through unscaled)
    return rglru_mod.apply_rglru(p, h, cfg.rglru,
                                 gates=(g_f.float(), g_b.float()),
                                 use_kernel=use_kernel,
                                 live_bounds=live_bounds)


def apply_block(p: Block, x, kind: str, cfg: ModelConfig, layer_gates=None,
                policy=None, use_kernel: bool = False, live_bounds=None,
                tp=None):
    """Pre-norm residual block. Returns (x, aux): the MoE block's aux
    losses, None for every other block. ``tp``: the tensor axis (see the
    module docstring); SSD, RG-LRU and MoE blocks run replicated under it.
    ``policy`` (the sharding policy) raises until a later slice ports
    it."""
    if policy is not None:
        raise _not_ported_dist("the sharding-policy branch of apply_block")
    h = apply_norm(p.norm1, x, cfg.norm)
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        c = _apply_attn_inner(p.attn, h, kind, cfg, layer_gates, use_kernel,
                              live_bounds, tp)
    elif kind == SSD:
        c = _apply_ssd_inner(p.ssd, h, cfg, layer_gates, use_kernel,
                             live_bounds)
    elif kind == RGLRU:
        c = _apply_rglru_inner(p.rglru, h, cfg, layer_gates, use_kernel,
                               live_bounds)
    else:
        raise ValueError(kind)
    x = x + c
    aux = None
    if hasattr(p, "norm2"):
        h2 = apply_norm(p.norm2, x, cfg.norm)
        y, aux = _apply_ffn(p, h2, cfg, layer_gates, use_kernel, live_bounds,
                            tp)
        x = x + y
    return x, aux


# ========================================================== layer grouping
def layer_groups(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...], Tuple[str, ...]]:
    """Returns (n_cycles, pattern, remainder_kinds)."""
    pat = cfg.block_pattern
    n_cycles = cfg.n_layers // len(pat)
    rem = cfg.layer_kinds[n_cycles * len(pat):]
    return n_cycles, pat, rem


# ================================================================ model init
class Transformer(nn.Module):
    """embed, final_norm, a flat ``layers`` list, ``unembed`` [d_model,
    vocab] when the embeddings are not tied, and ``frontend_proj``
    [frontend_dim, d_model] for an arch with a stub frontend."""

    def __init__(self, embed, final_norm, layers: List[Block],
                 unembed: Optional[torch.Tensor] = None,
                 frontend_proj: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = embed
        self.final_norm = final_norm
        self.layers = nn.ModuleList(layers)
        if unembed is not None:
            self.unembed = _param(unembed)
        if frontend_proj is not None:
            self.frontend_proj = _param(frontend_proj)


def init_model(gen: torch.Generator, cfg: ModelConfig) -> Transformer:
    """Random init on ``gen.device`` from the generator's stream (the
    numbers differ from ``jax.random``'s; tests carry JAX params over with
    ``interop.params_from_jax``)."""
    dtype = torch_dtype(cfg.param_dtype)
    embed = init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype)
    final_norm = init_norm(cfg.norm, cfg.d_model, dtype, gen.device)
    unembed = None if cfg.tie_embeddings else \
        dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    frontend_proj = None if cfg.frontend == "none" else \
        dense_init(gen, cfg.frontend_dim, cfg.d_model, dtype)
    layers = [_init_block(gen, kind, cfg, dtype) for kind in cfg.layer_kinds]
    return Transformer(embed, final_norm, layers, unembed, frontend_proj)


def logits_from_hidden(model: Transformer, cfg: ModelConfig, x):
    """Final norm, (tied) unembedding and softcap."""
    x = apply_norm(model.final_norm, x, cfg.norm)
    cdt = torch_dtype(cfg.compute_dtype)
    if cfg.tie_embeddings:
        logits = x @ model.embed.table.T.to(cdt)
    else:
        logits = x @ model.unembed.to(cdt)
    return softcap(logits, cfg.logit_softcap)


# ============================================================ model forward
def forward(model: Transformer, cfg: ModelConfig, tokens=None, features=None,
            gates=None, policy=None, remat: bool = False,
            use_kernel: bool = False, live_bounds=None, tp=None):
    """Returns (logits, aux) — logits [B, S, vocab], aux {"aux_loss"}.

    tokens: [B, S_text] int (None for an audio encoder). features: [B, T_f,
    frontend_dim] stub frontend embeddings (audio / vlm), projected by
    ``frontend_proj`` and put ahead of the token embeddings. gates:
    optional (g_f, g_b) of shape [n_layers, B, G]. use_kernel routes attention, SSD, RG-LRU and MoE blocks through
    the gated kernels; live_bounds: optional (live_fwd, live_bwd)
    per-layer max live (sample, group) slice counts
    (``core.schedule.live_slice_bounds``), one bound shared by every
    layer, for the kernels' compaction. The layers
    run as a plain loop over the flat layer list; the MoE blocks'
    load-balance and router-z losses sum into aux_loss in layer order.
    remat checkpoints one layer at a time: the same values and gradients,
    each layer's activations recomputed in the backward. tp: the tensor
    axis (see the module docstring), which has no kernel route. The
    sharding policy is not ported yet.
    """
    if policy is not None:
        raise _not_ported_dist("the sharding policy of forward")
    cdt = torch_dtype(cfg.compute_dtype)
    parts = []
    if features is not None:
        parts.append(features.to(cdt) @ model.frontend_proj.to(cdt))
    if tokens is not None:
        parts.append(apply_embedding(model.embed, tokens).to(cdt))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (p, kind) in enumerate(zip(model.layers, cfg.layer_kinds)):
        lg = None if gates is None else (gates[0][i], gates[1][i])
        if remat:
            x, a = checkpoint(p, x, kind, cfg, lg, use_kernel=use_kernel,
                              live_bounds=live_bounds, tp=tp,
                              use_reentrant=False)
        else:
            x, a = p(x, kind, cfg, lg, use_kernel=use_kernel,
                     live_bounds=live_bounds, tp=tp)
        if a is not None:
            aux_sum = aux_sum + a["load_balance"] + a["router_z"]
    return logits_from_hidden(model, cfg, x), {"aux_loss": aux_sum}


# ============================================================== loss helpers
class _FusedXent(torch.autograd.Function):
    """Mean token cross-entropy with a hand-written backward.

    The forward gathers the label logit first and reduces the logsumexp
    without a log-softmax buffer; the backward emits softmax - onehot
    directly, subtracting at the label positions by scatter, so no
    [B, S, V] one-hot is ever built."""

    @staticmethod
    def forward(ctx, logits, labels):
        labels = labels.long()
        label_logit = torch.gather(logits, -1,
                                   labels[..., None])[..., 0].float()
        m = torch.amax(logits, dim=-1)
        e = logits - m[..., None]
        lse = m.float() + torch.log(torch.sum(e.exp_(), dim=-1,
                                              dtype=torch.float32))
        del e
        ctx.save_for_backward(logits, labels, m, lse)
        return torch.mean(lse - label_logit)

    @staticmethod
    def backward(ctx, g):
        logits, labels, m, lse = ctx.saved_tensors
        n = logits.numel() // logits.shape[-1]
        z = (lse - m.float()).to(logits.dtype)
        gn = (g / n).to(logits.dtype)
        # softmax in the logits dtype, built in one buffer
        d = logits - m[..., None]
        d.sub_(z[..., None]).exp_().mul_(gn)
        d.scatter_add_(-1, labels[..., None],
                       (-gn).expand(labels.shape)[..., None].contiguous())
        return d, None


def fused_xent(logits, labels):
    """Mean token cross-entropy; see ``_FusedXent``."""
    return _FusedXent.apply(logits, labels)


def lm_loss(model: Transformer, cfg: ModelConfig, tokens, labels,
            features=None, gates=None, policy=None, remat: bool = False,
            use_kernel: bool = False, live_bounds=None, tp=None):
    """Next-token (or frame-classification) cross-entropy. Returns (loss,
    {"ce", "aux"}); with features ahead of tokens (a VLM), over the text
    region only, to which the labels align."""
    logits, aux = forward(model, cfg, tokens=tokens, features=features,
                          gates=gates, policy=policy, remat=remat,
                          use_kernel=use_kernel, live_bounds=live_bounds,
                          tp=tp)
    if features is not None and tokens is not None:
        logits = logits[:, -labels.shape[1]:]
    loss = fused_xent(logits, labels)
    return loss + aux["aux_loss"], {"ce": loss, "aux": aux["aux_loss"]}


# ================================================================== decoding
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device):
    """Per-layer decode caches, a flat list like the layers: attention
    ``{"k","v"}`` (global [B, max_len, ...], local the [B, W, ...] ring),
    SSD ``{"conv","state"}``, RG-LRU ``{"conv","h"}``."""
    dtype = torch_dtype(cfg.compute_dtype)
    caches = []
    for kind in cfg.layer_kinds:
        if kind in (ATTN_GLOBAL, ATTN_LOCAL):
            window = cfg.window if kind == ATTN_LOCAL else 0
            caches.append(attn.init_kv_cache(
                batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim,
                window, dtype, device=device))
        elif kind == SSD:
            caches.append(ssm_mod.init_ssd_cache(batch, cfg.d_model, cfg.ssm,
                                                 dtype, device=device))
        elif kind == RGLRU:
            caches.append(rglru_mod.init_rglru_cache(
                batch, cfg.d_model, cfg.rglru, dtype, device=device))
        else:
            raise ValueError(kind)
    return caches


def decode_recurrent(p: Block, c, h, kind: str, cfg: ModelConfig):
    """An SSD or RG-LRU mixer on one token: returns its contribution and
    copies the new state into the cache entry ``c`` in place (the paged
    pools and the contiguous caches both keep their tensors)."""
    if kind == SSD:
        y, new = ssm_mod.decode_ssd(p.ssd, c, h, cfg.d_model, cfg.ssm)
    elif kind == RGLRU:
        y, new = rglru_mod.decode_rglru(p.rglru, c, h, cfg.rglru)
    else:
        raise ValueError(kind)
    for name, t in new.items():
        c[name].copy_(t)
    return y


def decode_ffn(p: Block, x, cfg: ModelConfig):
    """The residual FFN of a decode step (dense or MoE, ungated); the MoE
    router sees every row of the batch, as the JAX package's does."""
    if not hasattr(p, "norm2"):
        return x
    return x + _apply_ffn(p, apply_norm(p.norm2, x, cfg.norm), cfg)[0]


def _decode_block(p: Block, c, x, kind: str, cfg: ModelConfig, t: int):
    h = apply_norm(p.norm1, x, cfg.norm)
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        y, _ = attn.decode_attention(
            p.attn, c, h, t=t, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            window=cfg.window if kind == ATTN_LOCAL else 0, rope=cfg.rope,
            rope_theta=cfg.rope_theta)
    else:
        y = decode_recurrent(p, c, h, kind, cfg)
    return decode_ffn(p, x + y, cfg)


def decode_step(model: Transformer, cache, cfg: ModelConfig, token, t,
                policy=None):
    """One decode step. token: [B, 1] int; t: tokens already cached (a host
    int). Returns (logits [B, 1, vocab], cache), the cache updated in place.
    ``policy`` raises until the distributed slice ports it."""
    if policy is not None:
        raise _not_ported_dist("the sharding policy of decode_step")
    cdt = torch_dtype(cfg.compute_dtype)
    x = apply_embedding(model.embed, token).to(cdt)
    for p, c, kind in zip(model.layers, cache, cfg.layer_kinds):
        x = _decode_block(p, c, x, kind, cfg, int(t))
    return logits_from_hidden(model, cfg, x), cache


# ====================================================== prefill (cache dump)
def _prefill_block(p: Block, x, kind: str, cfg: ModelConfig, max_len: int,
                   raw_kv: bool):
    """One block of the batched prefill: the dense forward computation of
    ``apply_block`` (ungated) plus the decode-cache entry the block leaves
    behind — post-rope K/V for attention, the final conv and recurrent
    state for SSD / RG-LRU. Returns (x, cache_entry)."""
    h = apply_norm(p.norm1, x, cfg.norm)
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        window = cfg.window if kind == ATTN_LOCAL else 0
        c, k, v = attn.apply_attention(
            p.attn, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, causal=cfg.causal, window=window,
            rope=cfg.rope, rope_theta=cfg.rope_theta, return_kv=True)
        entry = {"k": k, "v": v} if raw_kv else \
            attn.kv_prefill_cache(k, v, window, max_len)
    elif kind == SSD:
        c, entry = ssm_mod.apply_ssd(p.ssd, h, cfg.d_model, cfg.ssm,
                                     return_state=True)
    elif kind == RGLRU:
        c, entry = rglru_mod.apply_rglru(p.rglru, h, cfg.rglru,
                                         return_state=True)
    else:
        raise ValueError(kind)
    x = x + c
    if hasattr(p, "norm2"):
        h2 = apply_norm(p.norm2, x, cfg.norm)
        x = x + _apply_ffn(p, h2, cfg)[0]
    return x, entry


def prefill_forward(model: Transformer, cfg: ModelConfig, tokens,
                    max_len: int = 0, *, raw_kv: bool = False):
    """Batched serving prefill: one teacher-forced pass over the whole
    prompt that also dumps the decode caches.

    tokens: [B, S] int. Returns (logits [B, S, vocab], cache) where cache is
    ``init_cache(cfg, B, max_len)``'s flat per-layer list, filled so that
    decode continues from position S (max_len defaults to S). With
    ``raw_kv=True`` attention entries are instead the full post-rope
    history ``{"k","v"}: [B, S, n_kv, hd]`` — what the paged serving engine
    slices into pages. Recurrent entries are the same either way.
    """
    cdt = torch_dtype(cfg.compute_dtype)
    max_len = max_len or tokens.shape[1]
    x = apply_embedding(model.embed, tokens).to(cdt)
    cache = []
    for p, kind in zip(model.layers, cfg.layer_kinds):
        x, entry = _prefill_block(p, x, kind, cfg, max_len, raw_kv)
        cache.append(entry)
    return logits_from_hidden(model, cfg, x), cache
