"""gemma2-2b — local/global alternating attention + logit softcaps.

[arXiv:2408.00118; hf] 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000, head_dim=256 (q dim 2048 != d_model), tied embeddings.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-2b",
    family="decoder",
    n_layers=26, d_model=2304, n_heads=8, n_kv=4, d_ff=9216, vocab=256_000,
    d_head=256,
    rope_theta=10_000.0,
    swa_window=4096, swa_pattern="alternate",
    attn_softcap=50.0, final_softcap=30.0,
    post_norms=True,
    mlp="geglu",
    tie_embeddings=True,
    source="arXiv:2408.00118; hf",
))
