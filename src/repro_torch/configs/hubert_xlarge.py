"""hubert-xlarge — encoder-only audio transformer (w2v2-style backbone).

[arXiv:2106.07447] 48 layers, d_model 1280, 16 heads, d_ff 5120,
output vocabulary 504 (k-means targets). The mel + conv feature extractor
is a STUB frontend providing per-frame embeddings (frontend_dim 512);
encoder-only => bidirectional attention, no decode shapes.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", arch_type="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504, causal=False, rope=False,
    block_pattern=(ATTN_GLOBAL,), mlp_act="gelu", mlp_gated=False,
    norm="layer", frontend="audio_stub", frontend_dim=512,
    source="arXiv:2106.07447",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          head_dim=32, d_ff=256, vocab_size=64,
                          frontend_dim=32)
