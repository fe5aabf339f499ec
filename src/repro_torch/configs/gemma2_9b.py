"""gemma2-9b — local/global alternating attention + logit softcaps.

[arXiv:2408.00118; hf] 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000, head_dim=256, sandwich norms, tied embeddings.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-9b",
    family="decoder",
    n_layers=42, d_model=3584, n_heads=16, n_kv=8, d_ff=14336, vocab=256_000,
    d_head=256,
    rope_theta=10_000.0,
    swa_window=4096, swa_pattern="alternate",
    attn_softcap=50.0, final_softcap=30.0,
    post_norms=True,
    mlp="geglu",
    tie_embeddings=True,
    source="arXiv:2408.00118; hf",
))
