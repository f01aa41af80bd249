"""gemma3-1b — dense decoder with 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt] 26 layers, d_model 1152, 4 Q heads / 1 KV head
(head_dim 256), d_ff 6912, vocab 262144, sliding window 512 on local
layers; pattern = 5 local + 1 global (layers 5, 11, 17, 23 global, final
2 layers local remainder).
"""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", arch_type="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262_144,
    block_pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,), window=512,
    mlp_act="gelu", mlp_gated=True, rope_theta=1_000_000.0,
    tie_embeddings=True, logit_softcap=30.0,
    source="hf:google/gemma-3-1b-pt",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=7, d_model=128, n_heads=4, n_kv_heads=1,
                          head_dim=32, d_ff=256, vocab_size=512, window=8)
