"""stablelm-3b — dense decoder (stablelm-2 family scaled).

[hf:stabilityai/stablelm-2-1_6b] 32 layers, d_model 2560, 32 heads (MHA),
d_ff 6912, vocab 50304, SwiGLU-style gated MLP, RoPE (full, simplified
from the model's 25% partial rotary — noted in DESIGN.md).
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", arch_type="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab_size=50_304, block_pattern=(ATTN_GLOBAL,),
    mlp_act="silu", mlp_gated=True, norm="layer",
    source="hf:stabilityai/stablelm-2-1_6b",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          head_dim=32, d_ff=256, vocab_size=512)
