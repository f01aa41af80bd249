"""olmoe-1b-7b — fully open MoE, 64 experts top-8.

[arXiv:2409.02060] 16 layers, d_model 2048, 16 heads (MHA), 64 experts
top-8 with expert d_ff 1024, vocab 50304. ~1B active / 7B total.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", arch_type="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=50_304, block_pattern=(ATTN_GLOBAL,),
    moe=MoEConfig(n_experts=64, top_k=8, d_ff=1024),
    mlp_act="silu",
    source="arXiv:2409.02060",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          head_dim=32, vocab_size=512,
                          moe=MoEConfig(n_experts=4, top_k=2, d_ff=64))
