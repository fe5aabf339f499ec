"""internvl2-1b — VLM: Qwen2-0.5B LM backbone, InternViT frontend stubbed.

[arXiv:2404.16821; hf] 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655.  ``input_specs`` provides 256 precomputed patch embeddings
prepended to the token sequence.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-1b",
    family="decoder",
    n_layers=24, d_model=896, n_heads=14, n_kv=2, d_ff=4864, vocab=151_655,
    d_head=64,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    mlp="swiglu",
    tie_embeddings=True,
    frontend="vision", frontend_tokens=256,
    source="arXiv:2404.16821; hf",
))
