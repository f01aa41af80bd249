"""mixtral-8x22b — sparse MoE decoder, 8 experts top-2, sliding-window attn.

[arXiv:2401.04088] 56 layers, d_model 6144, 48 heads (GQA kv=8), expert
d_ff 16384, vocab 32768, SWA window 4096 (per assignment card). All FFNs
are routed (d_ff=0 dense).
"""
from repro_torch.configs.base import ATTN_LOCAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", arch_type="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab_size=32_768, block_pattern=(ATTN_LOCAL,), window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=16384),
    mlp_act="silu", rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          head_dim=32, vocab_size=512, window=16,
                          moe=MoEConfig(n_experts=4, top_k=2, d_ff=128))
