"""Model/run configuration schema + registry (a copy of the JAX package's,
kept separate so this package imports nothing of it).

One ``ModelConfig`` describes any architecture in the assigned pool; family
selects the block assembly in ``repro_torch.models.model``.  ``reduced()`` returns
the CPU-smoke-test variant of the same family (small dims, same structure).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "register", "get_config",
           "list_configs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # 'decoder' | 'encdec' | 'ssm' | 'hybrid' | 'encoder'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None     # defaults to d_model // n_heads
    # attention features
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    swa_window: Optional[int] = None # sliding-window size
    swa_pattern: str = "none"        # 'none' | 'all' | 'alternate'
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    post_norms: bool = False         # gemma2 sandwich norms
    mlp: str = "swiglu"              # 'swiglu' | 'geglu' | 'gelu'
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0
    expert_ff: int = 0
    moe_every: int = 1               # MoE layer every N layers (1 = all)
    capacity_factor: float = 1.25
    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    hybrid_attn_every: int = 0       # zamba2: shared attn block every N ssm layers
    # encoder-decoder
    n_enc_layers: int = 0
    enc_seq: int = 0                 # whisper: 1500 frames
    # modality frontend stub
    frontend: str = "none"           # 'none' | 'audio' | 'vision'
    frontend_tokens: int = 0         # prepended embedding tokens (vlm)
    n_classes: int = 0               # encoder classifier head (vision bench)
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # notes for DESIGN/dry-run reporting
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def padded_experts(self) -> int:
        """Expert count padded to the TP axis (16); dead experts are masked
        out of the router, get no tokens, and only waste their weight rows."""
        if self.n_experts == 0:
            return 0
        return -(-self.n_experts // 16) * 16

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a TP/lane-friendly multiple (embedding/head rows
        beyond ``vocab`` are dead weight; losses/decoding mask them)."""
        if self.vocab == 0:
            return 0
        mult = 2048 if self.vocab >= 2048 else 128
        return -(-self.vocab // mult) * mult

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (see DESIGN.md §5)."""
        return self.family in ("ssm", "hybrid") or self.swa_pattern == "all"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/structure, tiny dims."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4 if self.hybrid_attn_every == 0 else 7),
            d_model=64, n_heads=4, n_kv=max(1, min(self.n_kv, 2)), d_head=16,
            d_ff=128, vocab=256,
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=min(self.top_k, 2),
                      n_shared_experts=min(self.n_shared_experts, 1),
                      expert_ff=64)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
        if self.hybrid_attn_every:
            kw.update(hybrid_attn_every=3)
        if self.n_enc_layers:
            kw.update(n_enc_layers=2, enc_seq=32)
        if self.swa_window:
            kw.update(swa_window=16)
        if self.frontend_tokens:
            kw.update(frontend_tokens=8)
        return self.replace(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")


def list_configs():
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from . import (h2o_danube_1_8b, qwen2_5_32b, gemma2_9b, gemma2_2b,  # noqa
                   llama4_maverick_400b_a17b, qwen2_moe_a2_7b, zamba2_7b,
                   whisper_medium, internvl2_1b, mamba2_780m, deit_tiny)
