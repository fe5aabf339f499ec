"""qwen2.5-32b — dense GQA transformer with QKV bias.

[hf:Qwen/Qwen2.5-0.5B family; hf] 64L d_model=5120 40H (GQA kv=8)
d_ff=27648 vocab=152064.  Full attention => long_500k skipped.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-32b",
    family="decoder",
    n_layers=64, d_model=5120, n_heads=40, n_kv=8, d_ff=27648, vocab=152064,
    d_head=128,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    mlp="swiglu",
    source="hf:Qwen/Qwen2.5-32B; hf",
))
