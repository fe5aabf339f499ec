"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf] 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
SWA on all layers => sub-quadratic => eligible for long_500k.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-1.8b",
    family="decoder",
    n_layers=24, d_model=2560, n_heads=32, n_kv=8, d_ff=6912, vocab=32000,
    d_head=80,
    rope_theta=10_000.0,
    swa_window=4096, swa_pattern="all",
    mlp="swiglu",
    source="arXiv:2401.16818; hf",
))
