"""moonshot-v1-16b-a3b — Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B].

The assignment tags this [dense] but specifies 'MoE 64e top-6'; the
model card confirms a DeepSeek-V3-style MoE (64 routed experts, top-6,
~3B active).  Implemented as all-MoE layers with d_ff_expert=1408.
"""
from .base import ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1408,
    vocab=163840,
    ffn_pattern=("moe",),
    moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408),
    source="hf:moonshotai/Moonlight-16B-A3B",
)
