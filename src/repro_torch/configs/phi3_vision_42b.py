"""phi-3-vision-4.2b — VLM: phi3-mini language backbone + CLIP vision stub.

[hf:microsoft/Phi-3-vision-128k-instruct] LM backbone: 32 layers,
d_model 3072, 32 heads (MHA), d_ff 8192, vocab 32064. The CLIP ViT-L/14
tower + projector is a STUB frontend emitting 576 patch embeddings of
dim 1024 that are prepended to the text tokens.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", arch_type="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32_064, block_pattern=(ATTN_GLOBAL,),
    mlp_act="silu", mlp_gated=True,
    frontend="vision_stub", frontend_tokens=576, frontend_dim=1024,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          head_dim=32, d_ff=256, vocab_size=512,
                          frontend_tokens=8, frontend_dim=32)
