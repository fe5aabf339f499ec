"""MX element formats: bit-exact encode/decode + value-domain quantizers.

PyTorch counterpart of the JAX package's ``core/formats.py`` (the paper's
idealized minifloat semantics, Eq. 1-6):

  * shared exponent  S_e = floor(log2(max|X|))  per block, stored E8M0
  * MXINT8  (Eq. 1): 2's-complement int8, 6 fractional bits relative to S_e
  * MXFP    (Eq. 2-4): generic e/m minifloat with subnormals
  * MXSF    (Alg. 1): dual-regime E2M5 (gap < 3) / sub-FP E3M2 bias-10
    (gap >= 3) packed in one byte.

Every function is elementwise torch on any device.  The codecs are bitwise
equal to the JAX ones (``tests/test_torch_codec.py``): the same f32 steps in
the same order, ``torch.round`` rounding half to even like ``jnp.round``.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "MXFormat",
    "FORMATS",
    "get_format",
    "floor_log2",
    "shared_exponent",
    "quantize_rel",
    "encode_rel",
    "decode_rel",
]


@dataclasses.dataclass(frozen=True)
class MXFormat:
    """Descriptor of one MX *element* format (``kind`` in int/fp/safe/none)."""

    name: str
    kind: str
    ebits: int = 0
    mbits: int = 0

    @property
    def bits(self) -> int:
        if self.kind == "int":
            return self.mbits
        if self.kind == "none":
            return 16
        return 1 + self.ebits + self.mbits


FORMATS = {
    "bf16": MXFormat("bf16", "none"),
    "mxint8": MXFormat("mxint8", "int", 0, 8),
    "mxfp8_e4m3": MXFormat("mxfp8_e4m3", "fp", 4, 3),
    "mxfp8_e5m2": MXFormat("mxfp8_e5m2", "fp", 5, 2),
    "mxfp8_e3m4": MXFormat("mxfp8_e3m4", "fp", 3, 4),
    "mxfp8_e2m5": MXFormat("mxfp8_e2m5", "fp", 2, 5),
    "mxfp6_e2m3": MXFormat("mxfp6_e2m3", "fp", 2, 3),
    "mxfp6_e3m2": MXFormat("mxfp6_e3m2", "fp", 3, 2),
    "mxfp4_e2m1": MXFormat("mxfp4_e2m1", "fp", 2, 1),
    "mxsf": MXFormat("mxsf", "safe", 2, 5),
}
FORMATS["boost"] = FORMATS["mxfp8_e2m5"]


def get_format(name: str) -> MXFormat:
    try:
        return FORMATS[name]
    except KeyError:
        raise ValueError(f"unknown MX format {name!r}; have {sorted(FORMATS)}")


# ---------------------------------------------------------------------------
# exponent helpers
# ---------------------------------------------------------------------------

def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2(|x|)) for finite nonzero x; 0 where x == 0."""
    x = x.float().abs()
    _, e = torch.frexp(x)  # x = m * 2^e with m in [0.5, 1)
    return torch.where(x > 0, e - 1, torch.zeros_like(e)).to(torch.int32)


def shared_exponent(amax: torch.Tensor) -> torch.Tensor:
    """S_e = floor(log2(amax)); 0-max blocks get the minimum exponent."""
    return torch.where(amax > 0, floor_log2(amax),
                       torch.full_like(amax, -127, dtype=torch.int32))


def _exp2(e: torch.Tensor) -> torch.Tensor:
    """2^e in f32 (0 below the subnormal range), like ``jnp.ldexp(1, e)``."""
    return torch.ldexp(torch.ones(e.shape, dtype=torch.float32,
                                  device=e.device), e.to(torch.int32))


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# value-domain quantizers (relative: operate on xa = x * 2^-S_e, |xa| < 2)
# ---------------------------------------------------------------------------

def _quantize_int_rel(xa, mbits: int):
    frac = mbits - 2
    q = torch.round(xa * (2.0 ** frac))
    q = q.clamp(-(2.0 ** (mbits - 1)), 2.0 ** (mbits - 1) - 1)
    return q * (2.0 ** -frac)


def _quantize_fp_rel(xa, ebits: int, mbits: int):
    emin = 2 - 2 ** ebits
    e = floor_log2(xa).clamp(emin, 0)
    step = _exp2(e - mbits)
    q = torch.round(xa / step) * step
    lim = 2.0 - 2.0 ** (-mbits)
    return q.clamp(-lim, lim)


def _quantize_safe_rel(xa):
    e = floor_log2(xa)
    wide = e >= -2
    step = torch.where(wide, _exp2(e - 5), _exp2(torch.clamp(e, min=-9) - 2))
    q = torch.round(xa / step) * step
    lim = 2.0 - 2.0 ** -5
    return q.clamp(-lim, lim)


def quantize_rel(xa: torch.Tensor, fmt: MXFormat) -> torch.Tensor:
    """Quantize values already scaled relative to the shared exponent."""
    xa = xa.float()
    if fmt.kind == "none":
        return xa
    if fmt.kind == "int":
        return _quantize_int_rel(xa, fmt.mbits)
    if fmt.kind == "fp":
        return _quantize_fp_rel(xa, fmt.ebits, fmt.mbits)
    if fmt.kind == "safe":
        return _quantize_safe_rel(xa)
    raise ValueError(fmt.kind)


# ---------------------------------------------------------------------------
# bit-exact codecs (relative domain) -> uint8 codes
# ---------------------------------------------------------------------------

def _sign(xa):
    return (xa < 0) | ((xa == 0) & torch.signbit(xa))


def _encode_safe_rel(xa: torch.Tensor) -> torch.Tensor:
    """Pack xa in (-2, 2) into the MXSF byte [s | ee | mmmmm]."""
    xa = xa.float()
    s = _sign(xa)
    a = xa.abs()
    e = floor_log2(a)
    i32 = torch.int32

    # ---- E2M5 regime (gap < 3, i.e. e >= -2) --------------------------------
    e25 = e.clamp(-2, 0)
    m25 = torch.round(a * _exp2(5 - e25))
    ovf = m25 >= 64
    e25 = torch.where(ovf, e25 + 1, e25)
    m25 = torch.where(ovf, _f32(32.0, a), m25)
    top = e25 > 0
    e25 = torch.where(top, torch.zeros_like(e25), e25)
    m25 = torch.where(top, _f32(63.0, a), m25)
    code25 = ((e25 + 3) << 5) | (m25.to(i32) - 32)

    # ---- E3M2 regime (gap >= 3, e <= -3) ------------------------------------
    e32 = e.clamp(-9, -3)
    sub = a < 2.0 ** -9
    step = torch.where(sub, _f32(2.0 ** -11, a), _exp2(e32 - 2))
    q = torch.round(a / step)
    promote = sub & (q >= 4)
    q_norm = torch.where(promote, _f32(4.0, a), q)
    e32 = torch.where(promote, torch.full_like(e32, -9), e32)
    sub = sub & (q < 4)
    novf = (~sub) & (q_norm >= 8)
    e32 = torch.where(novf, e32 + 1, e32)
    q_norm = torch.where(novf, _f32(4.0, a), q_norm)
    cross = e32 > -3
    eee = torch.where(sub, torch.zeros_like(e32), e32 + 10)
    m2 = torch.where(sub, q_norm, q_norm - 4.0).to(i32)
    code32 = (eee.to(i32) << 2) | m2
    code32 = torch.where(cross, torch.full_like(code32, 1 << 5), code32)

    wide = e >= -2
    code = torch.where(a == 0, torch.zeros_like(code25),
                       torch.where(wide, code25, code32))
    return (code & 0xFF).to(torch.uint8) | (s.to(torch.uint8) << 7)


def _decode_safe_rel(code: torch.Tensor) -> torch.Tensor:
    code = code.to(torch.int32)
    s = (code >> 7) & 1
    ee = (code >> 5) & 3
    m5 = code & 31
    eee = (m5 >> 2) & 7
    m2 = m5 & 3
    v25 = (1.0 + m5.float() / 32.0) * _exp2(ee - 3)
    v32n = (1.0 + m2.float() / 4.0) * _exp2(eee - 10)
    v32s = (m2.float() / 4.0) * (2.0 ** -9)
    mag = torch.where(ee > 0, v25, torch.where(eee > 0, v32n, v32s))
    return torch.where(s == 1, -mag, mag)


def _encode_fp_rel(xa: torch.Tensor, ebits: int, mbits: int) -> torch.Tensor:
    """Generic minifloat byte [s | e(ebits) | m(mbits)] (idealized, no NaN)."""
    xa = xa.float()
    s = _sign(xa)
    a = xa.abs()
    e = floor_log2(a)
    emin = 2 - 2 ** ebits
    eq = e.clamp(emin, 0)
    sub = a < 2.0 ** emin
    step = _exp2(eq - mbits)
    q = torch.round(a / step)
    half = float(2 ** mbits)
    promote = sub & (q >= half)
    sub = sub & (q < half)
    q = torch.where(promote, _f32(half, a), q)
    ovf = (~sub) & (q >= 2 * half)
    eq = torch.where(ovf, eq + 1, eq)
    q = torch.where(ovf, _f32(half, a), q)
    top = eq > 0
    eq = torch.where(top, torch.zeros_like(eq), eq)
    q = torch.where(top, _f32(2 * half - 1, a), q)
    E = 2 ** ebits - 1
    efield = torch.where(sub, torch.zeros_like(eq), eq + E)
    mfield = torch.where(sub, q, q - half).to(torch.int32)
    code = (efield.to(torch.int32) << mbits) | mfield
    code = torch.where(a == 0, torch.zeros_like(code), code)
    return (code & 0xFF).to(torch.uint8) | (s.to(torch.uint8) << (ebits + mbits))


def _decode_fp_rel(code: torch.Tensor, ebits: int, mbits: int) -> torch.Tensor:
    code = code.to(torch.int32)
    s = (code >> (ebits + mbits)) & 1
    efield = (code >> mbits) & (2 ** ebits - 1)
    m = (code & (2 ** mbits - 1)).float()
    E = 2 ** ebits - 1
    vn = (1.0 + m / 2 ** mbits) * _exp2(efield - E)
    vs = (m / 2 ** mbits) * (2.0 ** (2 - 2 ** ebits))
    mag = torch.where(efield > 0, vn, vs)
    return torch.where(s == 1, -mag, mag)


def _encode_int_rel(xa: torch.Tensor, mbits: int) -> torch.Tensor:
    frac = mbits - 2
    q = torch.round(xa.float() * (2.0 ** frac))
    q = q.clamp(-(2.0 ** (mbits - 1)), 2.0 ** (mbits - 1) - 1)
    return q.to(torch.int8)


def _decode_int_rel(code: torch.Tensor, mbits: int) -> torch.Tensor:
    return code.float() * (2.0 ** -(mbits - 2))


def encode_rel(xa: torch.Tensor, fmt: MXFormat) -> torch.Tensor:
    if fmt.kind == "safe":
        return _encode_safe_rel(xa)
    if fmt.kind == "fp":
        return _encode_fp_rel(xa, fmt.ebits, fmt.mbits)
    if fmt.kind == "int":
        return _encode_int_rel(xa, fmt.mbits)
    raise ValueError(f"format {fmt.name} has no packed codec")


def decode_rel(code: torch.Tensor, fmt: MXFormat) -> torch.Tensor:
    if fmt.kind == "safe":
        return _decode_safe_rel(code)
    if fmt.kind == "fp":
        return _decode_fp_rel(code, fmt.ebits, fmt.mbits)
    if fmt.kind == "int":
        return _decode_int_rel(code, fmt.mbits)
    raise ValueError(f"format {fmt.name} has no packed codec")
