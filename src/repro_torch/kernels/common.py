"""Bit-level float helpers of the kernels, as plain PyTorch.

Counterpart of the JAX package's ``kernels/common.py``.  The same functions
exist as ``__device__`` helpers in ``csrc/mxsf_codec.cuh``, which every CUDA
kernel includes; the plain versions here are what the kernels' plain
PyTorch versions (and the CPU tests) run, as the JAX kernels' bodies run
them.  Exponents are read and powers of two built by bit-casting, exactly
as the kernels do.
"""
from __future__ import annotations

import torch

__all__ = ["flog2", "exp2i", "rne", "scale_by_exp2", "broadcast_block_scale",
           "decode_mxsf", "encode_mxsf", "decode_packed"]

_I32 = torch.int32
SCALE_BIAS = 127  # E8M0 storage bias


def flog2(a: torch.Tensor) -> torch.Tensor:
    """floor(log2(a)) for a >= 0 f32, exact down to subnormals; -127 for 0.

    Subnormals have a zero exponent field, so they are renormalized by 2^24
    first (exact) and the shift is taken back off."""
    a = a.float()
    sub = (a > 0) & (a < 2.0 ** -126)
    an = torch.where(sub, a * 2.0 ** 24, a)
    bits = an.view(_I32)
    return ((bits >> 23) & 0xFF) - 127 - torch.where(
        sub, torch.full_like(bits, 24), torch.zeros_like(bits))


def exp2i(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e for integer e, clipped to [-126, 127]."""
    e = e.clamp(-126, 127).to(_I32)
    return ((e + 127) << 23).view(torch.float32)


def scale_by_exp2(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """x * 2^e for integer e in [-252, 252], split so each factor is a
    representable power of two."""
    e = e.to(_I32)
    e1 = torch.div(e, 2, rounding_mode="floor")
    return x * exp2i(e1) * exp2i(e - e1)


def broadcast_block_scale(se: torch.Tensor, bm: int, bk: int):
    """Block-grid scale exponents (G1, G2) -> per-element (G1*bm, G2*bk)."""
    return se.repeat_interleave(bm, 0).repeat_interleave(bk, 1)


def rne(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x)  # round half to even


def decode_mxsf(code: torch.Tensor) -> torch.Tensor:
    """MXSF byte -> value relative to the shared exponent (f32)."""
    c = code.to(_I32)
    s = (c >> 7) & 1
    ee = (c >> 5) & 3
    m5 = (c & 31).float()
    eee = (c >> 2) & 7
    m2 = (c & 3).float()
    v25 = (1.0 + m5 / 32.0) * exp2i(ee - 3)
    v32n = (1.0 + m2 / 4.0) * exp2i(eee - 10)
    v32s = (m2 / 4.0) * (2.0 ** -9)
    mag = torch.where(ee > 0, v25, torch.where(eee > 0, v32n, v32s))
    return torch.where(s == 1, -mag, mag)


def encode_mxsf(xa: torch.Tensor) -> torch.Tensor:
    """Relative value (|xa| < 2) -> MXSF byte."""
    xa = xa.float()
    # sign straight from the bit pattern so -0.0 keeps its sign byte
    s = (xa.view(_I32) >> 31) & 1
    a = xa.abs()
    e = flog2(a)

    def f(v):
        return torch.full_like(a, v)

    # E2M5 regime (gap < 3)
    e25 = e.clamp(-2, 0)
    m25 = rne(a * exp2i(5 - e25))
    ovf = m25 >= 64
    e25 = torch.where(ovf, e25 + 1, e25)
    m25 = torch.where(ovf, f(32.0), m25)
    top = e25 > 0
    e25 = torch.where(top, torch.zeros_like(e25), e25)
    m25 = torch.where(top, f(63.0), m25)
    code25 = ((e25 + 3) << 5) | (m25.to(_I32) - 32)

    # E3M2 regime (gap >= 3)
    e32 = e.clamp(-9, -3)
    sub = a < 2.0 ** -9
    step = torch.where(sub, f(2.0 ** -11), exp2i(e32 - 2))
    q = rne(a / step)
    promote = sub & (q >= 4)
    q = torch.where(promote, f(4.0), q)
    e32 = torch.where(promote, torch.full_like(e32, -9), e32)
    sub = sub & ~promote
    novf = (~sub) & (q >= 8)
    e32 = torch.where(novf, e32 + 1, e32)
    q = torch.where(novf, f(4.0), q)
    cross = e32 > -3
    eee = torch.where(sub, torch.zeros_like(e32), e32 + 10)
    m2 = torch.where(sub, q, q - 4.0).to(_I32)
    code32 = (eee << 2) | m2
    code32 = torch.where(cross, torch.full_like(code32, 1 << 5), code32)

    code = torch.where(a == 0, torch.zeros_like(code25),
                       torch.where(e >= -2, code25, code32))
    return ((code | (s << 7)) & 0xFF).to(torch.uint8)


def decode_packed(codes: torch.Tensor, scales: torch.Tensor,
                  block) -> torch.Tensor:
    """f32 values of a packed 2D code grid under ``block``: the code's value
    times 2^(scale byte - 127), the exponent clipped as ``exp2i`` clips it
    (the decode of the kernels and of ``blocking.dequantize``, uncropped)."""
    se = scales.to(_I32) - SCALE_BIAS
    return decode_mxsf(codes) * exp2i(broadcast_block_scale(se, *block))
