"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE
[arXiv:2403.19887].

32 layers in 4 blocks of 8: one attention layer per block (position 4),
Mamba elsewhere; MoE on odd positions (every other layer), 16 experts
top-2.  Note: Jamba v0.1 uses Mamba-1 (d_state=16); we implement the
SSD (Mamba-2) formulation of the same state size — recorded in
DESIGN.md as a hardware-adaptation substitution (SSD is the TPU/MXU-
friendly dual form).
"""
from .base import ModelCfg, MoECfg, SSMCfg

CONFIG = ModelCfg(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=65536,
    block_pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    ffn_pattern=("dense", "moe", "dense", "moe", "dense", "moe", "dense", "moe"),
    moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=14336),
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
    source="arXiv:2403.19887",
)
