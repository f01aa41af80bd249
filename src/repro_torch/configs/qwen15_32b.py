"""qwen1.5-32b — dense decoder with QKV bias.

[hf:Qwen/Qwen1.5-0.5B family] 64 layers, d_model 5120, 40 heads (GQA kv=40
i.e. MHA), d_ff 27392, vocab 152064, QKV bias, SwiGLU, RMSNorm, RoPE.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", arch_type="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
    d_ff=27392, vocab_size=152_064, qkv_bias=True,
    block_pattern=(ATTN_GLOBAL,), mlp_act="silu", mlp_gated=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          head_dim=32, d_ff=256, vocab_size=512)
