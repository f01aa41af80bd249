"""Transformer backbone (port of ``repro/models/transformer.py``).

The model holds a flat list of layers: layer ``i`` is ``model.layers[i]``.
The JAX package stacks layers per pattern cycle for ``lax.scan``;
``repro_torch.interop.params_from_jax`` unstacks cycle ``c``, position
``j`` into layer ``c*P + j``. PyTorch runs eagerly, so there is nothing to
gain from the stacked layout here.

Ported so far: dense attention blocks (global and sliding-window) with a
dense FFN, SSD blocks (mamba2: no FFN), the batched serving prefill of the
attention blocks, the D2FT-gated block forward (``apply_block``), the
text-only ``forward`` and the LLM loss (``fused_xent``, ``lm_loss``).
Gating: ``gates = (g_f, g_b)`` of shape [n_layers, B, G]; per block, the
residual contribution is split into G head/width groups c_g and mixed as

    c_eff = g_f * (g_b * c_g + (1 - g_b) * c_g.detach()),

which is p_f (1, 1), p_o (1, 0) and p_s (0, ·) exactly: p_o keeps the
forward value but no gradient flows through the subnet for that sample;
p_s removes the contribution. An SSD block gates its scan per (sample,
head) instead (``models/ssm.apply_ssd``). RG-LRU and MoE blocks, the
frontends and the decode caches come with later slices; the
tensor-parallel and sharding-policy branches with the distributed slice.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import contract as kernel_contract

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, SSD,
                                      ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (_act, _param, apply_embedding,
                                       apply_norm, dense_init, init_embedding,
                                       init_mlp, init_norm, softcap,
                                       torch_dtype)


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: it comes with a later slice of the port")


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


# ============================================================== block params
class Block(nn.Module):
    """Pre-norm residual block: norm1 + a mixer (``attn``, or ``ssd``), then,
    where the config has an FFN, norm2 + mlp."""

    def __init__(self, norm1, attn_mod=None, norm2=None, mlp=None, ssd=None):
        super().__init__()
        self.norm1 = norm1
        if attn_mod is not None:
            self.attn = attn_mod
        if ssd is not None:
            self.ssd = ssd
        if mlp is not None:
            self.norm2 = norm2
            self.mlp = mlp


def _init_block(gen: torch.Generator, kind: str, cfg: ModelConfig,
                dtype) -> Block:
    dev = gen.device
    if kind == RGLRU:
        raise _not_ported(f"block kind {kind!r}")
    if kind not in (ATTN_GLOBAL, ATTN_LOCAL, SSD):
        raise ValueError(kind)
    norm1 = init_norm(cfg.norm, cfg.d_model, dtype, dev)
    if kind == SSD:
        s = ssm_mod.init_ssd(gen, cfg.d_model, cfg.ssm, dtype)
        if cfg.d_ff <= 0:                   # mamba2: no FFN
            return Block(norm1, ssd=s)
        return Block(norm1, None, init_norm(cfg.norm, cfg.d_model, dtype, dev),
                     init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated,
                              dtype), ssd=s)
    if cfg.moe is not None:
        raise _not_ported("the MoE FFN")
    a = attn.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim, cfg.qkv_bias, dtype)
    if cfg.d_ff <= 0:
        return Block(norm1, a)
    return Block(norm1, a, init_norm(cfg.norm, cfg.d_model, dtype, dev),
                 init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype))


def _apply_ffn(p: Block, h, cfg: ModelConfig, layer_gates=None):
    """Dense FFN branch of the JAX ``_apply_ffn`` (unsharded): plain, or
    split into G column groups of w_down and mixed by ``gate_mix``.
    Returns y (the JAX function's aux is always None for a dense FFN)."""
    mlp = p.mlp
    up = h @ mlp.w_up
    if cfg.mlp_gated:
        hid = _act(cfg.mlp_act)(h @ mlp.w_gate) * up
    else:
        hid = _act(cfg.mlp_act)(up)
    if layer_gates is None:
        return hid @ mlp.w_down
    g_f, g_b = layer_gates
    G = g_f.shape[-1]
    B, S, F = hid.shape
    D = mlp.w_down.shape[-1]
    wd = mlp.w_down.reshape(G, F // G, D)
    c_g = torch.einsum("bsgf,gfD->bsgD", hid.reshape(B, S, G, F // G), wd)
    return gate_mix(c_g, g_f, g_b).sum(dim=2)


def _apply_attn_inner(p, h, kind: str, cfg: ModelConfig, layer_gates,
                      use_kernel: bool = False, live_bounds=None):
    """Attention contribution (pre-residual), with per-head-group gating
    (the unsharded branches of the JAX function).

    use_kernel routes attention through the gated flash kernels, whose
    backward skips every g_b == 0 (sample, head) slice. live_bounds: the
    (live_fwd, live_bwd) bounds at (sample, group) granularity
    (``core.schedule.live_slice_bounds``), scaled here to per-head slice
    counts for the kernels' compaction."""
    window = cfg.window if kind == ATTN_LOCAL else 0
    hd = cfg.resolved_head_dim
    B, S, _ = h.shape
    n_heads, n_kv = cfg.n_heads, cfg.n_kv_heads
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
        return out.reshape(B, S, n_heads * hd) @ p.wo
    # group-wise projection + gate_mix: on the kernel path this also cuts
    # wo gradients for p_o groups, matching the masked path exactly
    g_f, g_b = layer_gates
    c_g = _group_project(out, p.wo, g_f.shape[-1])         # [B,S,G,D]
    return gate_mix(c_g, g_f, g_b).sum(dim=2)


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


def apply_block(p: Block, x, kind: str, cfg: ModelConfig, layer_gates=None,
                policy=None, use_kernel: bool = False, live_bounds=None,
                tp=None):
    """Pre-norm residual block. Returns (x, None): the JAX function's aux
    losses come only from MoE blocks, not ported yet. ``policy`` and ``tp``
    (sharding policy, tensor parallelism) raise until the distributed
    slice ports them."""
    if policy is not None:
        raise _not_ported_dist("the sharding-policy branch of apply_block")
    if tp is not None:
        raise _not_ported_dist("the tensor-parallel branch of apply_block")
    h = apply_norm(p.norm1, x, cfg.norm)
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        c = _apply_attn_inner(p.attn, h, kind, cfg, layer_gates, use_kernel,
                              live_bounds)
    elif kind == SSD:
        c = _apply_ssd_inner(p.ssd, h, cfg, layer_gates, use_kernel,
                             live_bounds)
    else:
        raise _not_ported(f"block kind {kind!r}")
    x = x + c
    if hasattr(p, "mlp"):
        h2 = apply_norm(p.norm2, x, cfg.norm)
        x = x + _apply_ffn(p, h2, cfg, layer_gates)
    return x, None


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


# ============================================================ model forward
def forward(model: Transformer, cfg: ModelConfig, tokens=None, features=None,
            gates=None, policy=None, remat: bool = False,
            use_kernel: bool = False, live_bounds=None, tp=None):
    """Returns (logits, aux) — logits [B, S, vocab], aux {"aux_loss"}.

    tokens: [B, S] int. gates: optional (g_f, g_b) of shape [n_layers, B,
    G]. use_kernel routes attention and SSD blocks through the gated
    kernels; live_bounds: optional (live_fwd, live_bwd) per-layer max live
    (sample, group) slice counts (``core.schedule.live_slice_bounds``), one
    bound shared by every layer, for the kernels' compaction. The layers
    run as a plain loop over the flat layer list. Frontend features, remat
    and the sharding branches (policy, tp) are not ported yet.
    """
    if features is not None:
        raise _not_ported("the frontend (features) path of forward")
    if remat:
        raise _not_ported("remat (activation checkpointing)")
    if policy is not None or tp is not None:
        raise _not_ported_dist("the sharding branches of forward")
    cdt = torch_dtype(cfg.compute_dtype)
    x = apply_embedding(model.embed, tokens).to(cdt)
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (p, kind) in enumerate(zip(model.layers, cfg.layer_kinds)):
        lg = None if gates is None else (gates[0][i], gates[1][i])
        x, _ = apply_block(p, x, kind, cfg, lg, use_kernel=use_kernel,
                           live_bounds=live_bounds)
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
    """Next-token cross-entropy. Returns (loss, {"ce", "aux"})."""
    logits, aux = forward(model, cfg, tokens=tokens, features=features,
                          gates=gates, policy=policy, remat=remat,
                          use_kernel=use_kernel, live_bounds=live_bounds,
                          tp=tp)
    loss = fused_xent(logits, labels)
    return loss + aux["aux_loss"], {"ce": loss, "aux": aux["aux_loss"]}


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
