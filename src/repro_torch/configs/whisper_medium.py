"""whisper-medium — encoder-decoder audio backbone (conv frontend stubbed).

[arXiv:2212.04356; unverified] 24L enc + 24L dec, d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865.  ``input_specs`` provides precomputed frame
embeddings (B, 1500, d_model); decode shapes lower the decoder serve_step.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv=16, d_ff=4096, vocab=51865,
    d_head=64,
    mlp="gelu",
    n_enc_layers=24, enc_seq=1500,
    frontend="audio",
    source="arXiv:2212.04356; unverified",
))
