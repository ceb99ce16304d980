"""internvl3-14b — the paper's own primary evaluation model (Table 2):
InternViT-300M + Qwen2.5-14B backbone.  Not part of the assigned pool;
included so the paper's experimental configuration is representable.
"""
from .base import ModelCfg, ViTCfg

CONFIG = ModelCfg(
    name="internvl3-14b",
    family="vlm",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_ff=13824,
    vocab=151674,
    img_tokens=256,
    vit=ViTCfg(n_layers=24, d_model=1024, n_heads=16, d_ff=4096,
               patch=14, image=448, group=2),
    source="arXiv:2504.10479 (paper Table 2)",
)
