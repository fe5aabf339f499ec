"""deit-tiny — the paper's own training benchmark model (vision encoder).

[arXiv:2012.12877] 12L d_model=192 3H d_ff=768; patch embeddings are
provided by a stub (benchmarks feed synthetic patch tokens).  Used by
``benchmarks/table3_training.py`` to reproduce the paper's Table III row.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deit-tiny",
    family="encoder",
    n_layers=12, d_model=192, n_heads=3, n_kv=3, d_ff=768, vocab=0,
    d_head=64,
    mlp="gelu",
    frontend="vision", frontend_tokens=196,
    n_classes=100,
    source="arXiv:2012.12877; paper Table III",
))
