"""internvl2-76b [vlm] — InternViT + LLM backbone [arXiv:2404.16821].

Per the assignment carve-out the vision frontend is a STUB:
``input_specs`` provides pre-computed patch embeddings (img_tokens per
frame at LM width); the config below is the language decoder that
consumes them.  The runnable (smoke/serving) variant instantiates a
small real ViT so the CodecFlow pruning path is exercised end-to-end.
"""
from .base import ModelCfg

CONFIG = ModelCfg(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=28672,
    vocab=128256,
    img_tokens=256,      # visual tokens per 448x448 frame after projector
    source="arXiv:2404.16821",
)
