"""mistral-large-123b [dense] [hf:mistralai/Mistral-Large-Instruct-2407]."""
from .base import ModelCfg

CONFIG = ModelCfg(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv=8,
    d_ff=28672,
    vocab=32768,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)
