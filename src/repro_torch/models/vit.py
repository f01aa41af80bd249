"""ViT for the paper's own experiments (port of ``repro/models/vit.py``).

The shared transformer blocks (bidirectional attention, learned positional
embeddings, classification head over the CLS token), so D2FT head-group
gating works as on the LLM backbones. Parameters carry the JAX package's
leaf names and layouts (``interop.vit_params_from_jax`` maps one onto the
other); images are NHWC, as there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig
from repro_torch.models.layers import _param, apply_norm, dense_init, init_norm
from repro_torch.models.transformer import Block, _init_block, apply_block


@dataclass(frozen=True)
class ViTConfig:
    n_layers: int = 12
    d_model: int = 384
    n_heads: int = 6
    d_ff: int = 1536
    patch: int = 16
    image_size: int = 224
    n_classes: int = 10

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2

    def backbone(self) -> ModelConfig:
        return ModelConfig(
            name="vit", arch_type="vit", n_layers=self.n_layers,
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_heads, d_ff=self.d_ff, vocab_size=self.n_classes,
            causal=False, rope=False, mlp_act="gelu", mlp_gated=False,
            norm="layer", block_pattern=(ATTN_GLOBAL,))


def vit_small(n_classes: int = 10) -> ViTConfig:
    return ViTConfig(n_classes=n_classes)


class ViT(nn.Module):
    """patch_proj [p*p*3, d], patch_bias [d], cls [1, 1, d], pos [1, S, d],
    ``blocks`` (one ``Block`` per layer), final_norm, head [d, n_classes]."""

    def __init__(self, patch_proj, patch_bias, cls, pos, blocks: List[Block],
                 final_norm, head):
        super().__init__()
        self.patch_proj = _param(patch_proj)
        self.patch_bias = _param(patch_bias)
        self.cls = _param(cls)
        self.pos = _param(pos)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.head = _param(head)


def init_vit(cfg: ViTConfig, seed: int = 0, *, device=None,
             dtype=torch.float32) -> ViT:
    """Random init from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (default: the CUDA card; pass ``device="cpu"`` for the CPU).
    The numbers differ from ``jax.random``'s; tests carry the JAX package's
    weights over with ``interop.vit_params_from_jax``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bb = cfg.backbone()
    patch_dim = cfg.patch * cfg.patch * 3
    patch_proj = dense_init(gen, patch_dim, cfg.d_model, dtype)
    cls = (torch.randn((1, 1, cfg.d_model), generator=gen, device=dev)
           * 0.02).to(dtype)
    pos = (torch.randn((1, cfg.n_patches + 1, cfg.d_model), generator=gen,
                       device=dev) * 0.02).to(dtype)
    blocks = [_init_block(gen, ATTN_GLOBAL, bb, dtype)
              for _ in range(cfg.n_layers)]
    head = dense_init(gen, cfg.d_model, cfg.n_classes, dtype)
    return ViT(patch_proj, torch.zeros((cfg.d_model,), dtype=dtype,
                                       device=dev),
               cls, pos, blocks, init_norm("layer", cfg.d_model, dtype, dev),
               head)


def patchify(images, patch: int):
    """images: [B, H, W, 3] -> [B, n_patches, patch*patch*3]."""
    B, H, W, C = images.shape
    ph, pw = H // patch, W // patch
    x = images.reshape(B, ph, patch, pw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, ph * pw, patch * patch * C)


def vit_forward(model: ViT, images, cfg: ViTConfig, gates=None,
                use_kernel: bool = False,
                live_bounds: Optional[Tuple[int, int]] = None):
    """images: [B,H,W,3]; gates: optional (g_f, g_b) [n_layers, B, G];
    use_kernel routes attention through the gated flash kernels (gate-aware
    backward) instead of the masked dense path; live_bounds is the optional
    (live_fwd, live_bwd) (sample, group) slice bound pair
    (``core.schedule.live_slice_bounds``) for the kernels' compaction.

    Returns logits [B, n_classes]."""
    bb = cfg.backbone()
    x = patchify(images, cfg.patch) @ model.patch_proj + model.patch_bias
    cls = model.cls.expand(x.shape[0], 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + model.pos
    for i, blk in enumerate(model.blocks):
        lg = None
        if gates is not None:
            lg = (gates[0][i], gates[1][i])
        x, _ = apply_block(blk, x, ATTN_GLOBAL, bb, lg,
                           use_kernel=use_kernel, live_bounds=live_bounds)
    x = apply_norm(model.final_norm, x, "layer")
    return x[:, 0] @ model.head


def vit_loss(model: ViT, images, labels, cfg: ViTConfig, gates=None,
             use_kernel: bool = False, live_bounds=None):
    logits = vit_forward(model, images, cfg, gates, use_kernel=use_kernel,
                         live_bounds=live_bounds)
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    loss = -ll.mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"acc": acc}
