"""qwen2-moe-a2.7b — MoE decoder, 60 routed top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf] 24L d_model=2048 16H (kv=16, MHA)
expert d_ff=1408 vocab=151936.  MoE every layer.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="decoder",
    n_layers=24, d_model=2048, n_heads=16, n_kv=16, d_ff=1408, vocab=151_936,
    d_head=128,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    mlp="swiglu",
    n_experts=60, top_k=4, n_shared_experts=4, expert_ff=1408, moe_every=1,
    capacity_factor=1.25,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
))
