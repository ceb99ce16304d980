"""mamba2-2.7b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

Attention-free: 64 SSD mixer layers (d_inner = 5120, 80 heads of 64,
d_state = 128).  d_ff=0: the reference Mamba-2 block is mixer-only (no MLP).
"""
from .base import ModelCfg, SSMCfg

CONFIG = ModelCfg(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=80,          # SSD heads (d_inner / head_dim)
    n_kv=80,
    d_ff=0,              # assignment: no MLP (mixer-only blocks)
    vocab=50280,
    block_pattern=("mamba",),
    ffn_pattern=("none",),
    ssm=SSMCfg(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
    source="arXiv:2405.21060",
)
