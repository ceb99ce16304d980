"""deepseek-7b [dense] — llama-arch, MHA (kv == heads) [arXiv:2401.02954]."""
from .base import ModelCfg

CONFIG = ModelCfg(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv=32,
    d_ff=11008,
    vocab=102400,
    source="arXiv:2401.02954",
)
