"""zamba2-7b — hybrid: Mamba2 backbone + shared attention block every 6 layers.

[arXiv:2411.15242; unverified] 81L d_model=3584 32H (kv=32, MHA) d_ff=14336
vocab=32000, ssm_state=64.  Shared transformer block (attn+MLP) parameters
are reused at every application (every 6 SSM layers).  Sub-quadratic =>
eligible for long_500k.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_ff=14336, vocab=32000,
    d_head=112,
    rope_theta=10_000.0,
    mlp="swiglu",
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_chunk=128, ssm_conv=4,
    hybrid_attn_every=6,
    source="arXiv:2411.15242; unverified",
))
