"""olmoe-1b-7b [moe] — 64 experts, top-8 [arXiv:2409.02060]."""
from .base import ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1024,
    vocab=50304,
    ffn_pattern=("moe",),
    moe=MoECfg(n_experts=64, top_k=8, d_ff_expert=1024),
    source="arXiv:2409.02060",
)
