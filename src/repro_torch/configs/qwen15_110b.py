"""qwen1.5-110b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B family scaling]."""
from .base import ModelCfg

CONFIG = ModelCfg(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)
