"""mamba2-130m — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060] 24 layers, d_model 768, no attention / no FFN (the SSD
mixer is the whole block), vocab 50280, state 128, head_dim 64, expand 2.
"""
from repro_torch.configs.base import SSD, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m", arch_type="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50_280, block_pattern=(SSD,), rope=False,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, vocab_size=512,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4,
                      chunk=8))
