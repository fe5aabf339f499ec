"""Quantization policy: which format/blocking applies where.

PyTorch counterpart of the JAX package's ``core/policy.py``.  The backend
names differ: ``"torch"`` is the value-domain emulation path (the JAX
package's ``"jnp"``) and ``"cuda"`` the kernel datapath (the JAX
package's ``"pallas"``).  ``use_kernels``/``use_attention_kernel`` keep the
predicates of ``use_pallas``/``use_pallas_attention``, and
``attention_kernel`` is ``pallas_attention``.
"""
from __future__ import annotations

import dataclasses

__all__ = ["QuantPolicy", "BF16", "MXSF_TRAIN", "MXSF_INFER"]


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    fwd_fmt: str = "mxsf"        # activations & weights, forward
    bwd_fmt: str = "mxsf"        # incoming gradients, backward
    block_mode: str = "2d"       # 'none' | '1d' | '2d'
    block_1d: int = 64           # 1D row-block length (paper: 64 inference)
    tile: int = 8                # 2D tile edge (paper: 8x8 training)
    quantize_bwd: bool = True    # quantize gradients in backward
    attn_matmuls: bool = True    # quantize QK^T and attn.V operands
    save_packed: bool = True     # store uint8-packed residuals for bwd
    kv_cache_fmt: str = ""       # e.g. 'mxsf': 8-bit packed KV cache (serving)
    backend: str = "torch"       # 'torch' | 'cuda': mx_dot matmul datapath
    attention_kernel: bool = True  # allow the packed-KV attention kernel
    # (the JAX package's ``pallas_attention``); False keeps the kernel
    # matmuls and sends cached attention to the value path

    @property
    def enabled(self) -> bool:
        return self.block_mode != "none"

    @property
    def use_kernels(self) -> bool:
        """True when mx_dot routes through the kernel datapath (the fused
        quantize->matmul over packed weights, ``kernels/``)."""
        if self.backend == "torch" or not self.enabled:
            return False
        if self.backend != "cuda":
            raise ValueError(f"unknown backend {self.backend!r}; "
                             "expected 'torch' or 'cuda'")
        if self.fwd_fmt != "mxsf" or (self.quantize_bwd
                                      and self.bwd_fmt != "mxsf"):
            raise ValueError("backend='cuda' kernels implement the MXSF "
                             f"codec only; got fwd_fmt={self.fwd_fmt!r}, "
                             f"bwd_fmt={self.bwd_fmt!r}")
        return True

    @property
    def use_attention_kernel(self) -> bool:
        """True when cached attention consumes the packed MXSF KV cache
        directly through the flash-attention kernel: the kernel backend, a
        packed MXSF cache and an inference policy (the kernel is
        forward-only)."""
        return (self.attention_kernel and self.use_kernels
                and self.kv_cache_fmt == "mxsf" and not self.quantize_bwd)

    def replace(self, **kw) -> "QuantPolicy":
        return dataclasses.replace(self, **kw)


BF16 = QuantPolicy(block_mode="none")
MXSF_TRAIN = QuantPolicy(fwd_fmt="mxsf", bwd_fmt="mxsf", block_mode="2d",
                         tile=8)
MXSF_INFER = QuantPolicy(fwd_fmt="mxsf", block_mode="1d", block_1d=64,
                         quantize_bwd=False)
