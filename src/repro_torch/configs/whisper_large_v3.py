"""whisper-large-v3 [audio] — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356].

32 encoder + 32 decoder layers at d=1280.  The mel-spectrogram + conv
feature extractor is a STUB: ``input_specs`` provides (B, 1500, 1280)
frame embeddings.  Decode shapes apply to the decoder-side sequence;
long_500k is SKIPPED for this arch (full-attention enc-dec, DESIGN.md §5).
"""
from .base import ModelCfg

CONFIG = ModelCfg(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv=20,
    d_ff=5120,
    vocab=51866,
    enc_dec=True,
    enc_layers=32,
    enc_seq=1500,
    source="arXiv:2212.04356",
)
