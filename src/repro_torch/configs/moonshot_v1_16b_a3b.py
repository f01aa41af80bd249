"""moonshot-v1-16b-a3b — fine-grained MoE (Moonlight / DeepSeek-V3 style).

[hf:moonshotai/Moonlight-16B-A3B] 48 layers, d_model 2048, 16 heads,
64 routed experts top-6 with expert d_ff 1408 + 2 shared experts,
vocab 163840. ~3B active parameters.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", arch_type="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=163_840, block_pattern=(ATTN_GLOBAL,),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared_experts=2),
    mlp_act="silu",
    source="hf:moonshotai/Moonlight-16B-A3B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          head_dim=32, vocab_size=512,
                          moe=MoEConfig(n_experts=4, top_k=2, d_ff=64,
                                        n_shared_experts=1))
