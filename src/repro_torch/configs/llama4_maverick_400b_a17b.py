"""llama4-maverick-400b-a17b — MoE decoder, 128 routed experts top-1 + shared.

[hf:meta-llama/Llama-4 family; unverified] 48L d_model=5120 40H (GQA kv=8)
expert d_ff=8192 vocab=202048, MoE every other layer (maverick interleaves
dense/MoE), one always-on shared expert.  Full attention => long_500k skip.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="decoder",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192, vocab=202_048,
    d_head=128,
    rope_theta=500_000.0,
    mlp="swiglu",
    n_experts=128, top_k=1, n_shared_experts=1, expert_ff=8192, moe_every=2,
    capacity_factor=1.25,
    source="hf:meta-llama/Llama-4-Maverick-17B-128E; unverified",
))
