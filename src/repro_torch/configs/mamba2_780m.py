"""mamba2-780m — attention-free SSM (state-space duality / SSD).

[arXiv:2405.21060; unverified] 48L d_model=1536 vocab=50280 ssm_state=128,
d_inner=3072, headdim=64 (48 ssm heads).  Sub-quadratic => long_500k runs.
The paper's MX technique applies to in/out projections only (DESIGN.md §5):
the SSD recurrence itself is elementwise/scan, not a MAC-array matmul.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv=0, d_ff=0, vocab=50280,
    tie_embeddings=True,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=128, ssm_conv=4,
    ssm_ngroups=1,
    source="arXiv:2405.21060; unverified",
))
