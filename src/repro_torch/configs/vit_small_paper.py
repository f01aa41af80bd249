"""ViT-small — the paper's own experimental model (§III-A).

12 transformer blocks, 6 heads, d_model 384, d_ff 1536, patch 16,
input 224x224; the paper-validation model, on synthetic CIFAR-like data.
"""
from repro_torch.models.vit import ViTConfig

CONFIG = ViTConfig(n_layers=12, d_model=384, n_heads=6, d_ff=1536,
                   patch=16, image_size=224, n_classes=10)


def smoke_config() -> ViTConfig:
    return ViTConfig(n_layers=2, d_model=96, n_heads=6, d_ff=192,
                     patch=8, image_size=32, n_classes=10)
