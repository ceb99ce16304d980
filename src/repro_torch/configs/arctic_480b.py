"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base].

Arctic's dense-MoE hybrid: every layer has a (small) dense residual MLP
in parallel with the 128-expert top-2 routed FFN.
"""
from .base import ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    d_ff=4864,
    vocab=32000,
    ffn_pattern=("moe",),
    moe=MoECfg(n_experts=128, top_k=2, d_ff_expert=4864, dense_residual=True),
    source="hf:Snowflake/snowflake-arctic-base",
)
