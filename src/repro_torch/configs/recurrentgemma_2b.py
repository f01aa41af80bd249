"""recurrentgemma-2b — hybrid RG-LRU + local attention, 1:2 ratio.

[arXiv:2402.19427] Griffin/RecurrentGemma: repeating (recurrent, recurrent,
local-attn) pattern; 26 layers, d_model 2560, 10 Q heads with 1 KV head
(GQA), d_ff 7680, vocab 256000, local attention window 2048.
"""
from repro_torch.configs.base import (ATTN_LOCAL, RGLRU, ModelConfig,
                                      RGLRUConfig)

CONFIG = ModelConfig(
    name="recurrentgemma-2b", arch_type="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256_000,
    block_pattern=(RGLRU, RGLRU, ATTN_LOCAL), window=2048,
    mlp_act="gelu", mlp_gated=True, norm="rms",
    rglru=RGLRUConfig(lru_width=2560, conv_width=4),
    source="arXiv:2402.19427",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=256, vocab_size=512, window=16,
        rglru=RGLRUConfig(lru_width=128, conv_width=4))
