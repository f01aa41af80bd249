"""Model configuration dataclasses (own copy of ``repro/configs/base.py``).

``ModelConfig``, the block kinds, ``InputShape`` and ``D2FTConfig`` are
verbatim, so a config built here compares field for field with the JAX
package's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Block kinds composable into a per-layer pattern.
ATTN_GLOBAL = "attn_global"      # full (causal or bidirectional) attention
ATTN_LOCAL = "attn_local"        # sliding-window attention
SSD = "ssd"                      # Mamba-2 state-space duality block
RGLRU = "rglru"                  # Griffin RG-LRU recurrent block

BLOCK_KINDS = (ATTN_GLOBAL, ATTN_LOCAL, SSD, RGLRU)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                     # per-expert hidden dim
    n_shared_experts: int = 0     # DeepSeek/Moonlight-style shared experts
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128          # N (SSD state size)
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256              # SSD chunk length


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: Optional[int] = None   # default: d_model
    conv_width: int = 4
    n_heads: Optional[int] = None     # block-diagonal gating heads


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int                      # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int                         # dense MLP hidden (0 if pure MoE/SSM)
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    # per-layer block pattern, cycled over n_layers. A trailing partial
    # cycle is allowed (e.g. gemma3: 5 local + 1 global over 26 layers).
    block_pattern: Tuple[str, ...] = (ATTN_GLOBAL,)
    window: int = 0                   # sliding window for ATTN_LOCAL
    causal: bool = True               # False for encoder-only (hubert)
    qkv_bias: bool = False
    mlp_act: str = "silu"             # silu|gelu
    mlp_gated: bool = True
    norm: str = "rms"                 # rms|layer
    rope_theta: float = 10_000.0
    rope: bool = True
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    frontend: str = "none"            # none|audio_stub|vision_stub
    # VLM/audio stub frontends: number of prepended embedding tokens the
    # stub produces per sample (the transformer consumes [emb; text]).
    frontend_tokens: int = 0
    frontend_dim: int = 0             # raw feature dim fed to the projector
    # Source citation from the assignment table.
    source: str = ""
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        assert self.n_heads > 0
        return self.d_model // self.n_heads

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Block kind of each of the n_layers layers (pattern cycled)."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def is_decoder(self) -> bool:
        return self.causal

    @property
    def supports_long_context(self) -> bool:
        """True if no layer requires O(S^2) global attention state growth.

        Used only for documentation; shape skips are listed in launch/shapes.
        """
        return all(k != ATTN_GLOBAL for k in self.layer_kinds)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train|prefill|decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class D2FTConfig:
    """Scheduler configuration for Distributed Dynamic Fine-Tuning."""
    n_microbatches: int = 5           # micro-batches per batch (paper: 5)
    # Budget expressed as number of micro-batches per subnet per batch.
    n_pf: int = 3                     # micro-batches doing full fwd+bwd
    n_po: int = 1                     # micro-batches doing forward-only
    # Relative costs (paper Table IV: fwd ~= 40% of fwd+bwd).
    cost_fwd: float = 0.4
    cost_bwd: float = 0.6
    backward_score: str = "weight_magnitude"   # paper's final choice
    forward_score: str = "fisher"
    head_groups: int = 0              # subnets per layer (0 = n_heads)
    mode: str = "packed"              # packed|masked
