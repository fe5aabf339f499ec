"""Block structure for MX tensors: 1D row blocks and 2D tiles (paper SIV-B).

PyTorch counterpart of the JAX package's ``core/blocking.py``.  A block
shares one E8M0 exponent; ``block`` applies to the trailing dims:

  * ``(64,)``    : 1D blocks along the last axis (inference layout)
  * ``(64, 1)``  : 1D blocks along the contraction rows of a weight
  * ``(8, 8)``   : 2D tiles over the last two axes (training layout)

Shapes that do not divide the block are zero-padded internally (zeros never
raise a block max) and cropped on dequantize.  Codes and scales are bitwise
equal to the JAX package's (``tests/test_torch_codec.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as Fn

from . import formats as F

__all__ = ["QuantizedTensor", "quantize", "dequantize", "qdq", "transpose_qt",
           "torch_dtype"]

SCALE_BIAS = 127  # E8M0 storage bias


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"``/``"float32"``/torch dtype -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


def dtype_name(dtype: torch.dtype) -> str:
    """torch dtype -> the JAX-style name a ``QuantizedTensor`` records."""
    return str(dtype).replace("torch.", "")


def _exp2i(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e via the exponent field (e clipped to [-126, 127])."""
    e = e.clamp(-126, 127).to(torch.int32)
    return ((e + 127) << 23).view(torch.float32)


def _scale_exp2(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Exact x * 2^e for integer e in [-252, 252].

    A single 2^e factor cannot represent e = -127 (a block whose amax sits
    in [2^127, 2^128)); splitting the shift keeps every factor a
    representable power of two.  Mirrors ``kernels/common.scale_by_exp2``."""
    e = e.to(torch.int32)
    e1 = torch.div(e, 2, rounding_mode="floor")
    return x * _exp2i(e1) * _exp2i(e - e1)


@dataclasses.dataclass
class QuantizedTensor:
    """Packed MX tensor: uint8/int8 codes + E8M0 per-block shared exponents.

    ``shape`` is the logical (unpadded) shape, ``dtype`` the name of the
    dtype ``dequantize`` returns (``"bfloat16"``, ``"float32"``)."""

    codes: torch.Tensor       # same shape as the (block-padded) original
    scale_e8m0: torch.Tensor  # uint8, block-grid shape
    fmt: str
    block: Tuple[int, ...]
    shape: Tuple[int, ...]
    dtype: str

    @property
    def format(self) -> F.MXFormat:
        return F.get_format(self.fmt)

    def nbytes_packed(self) -> int:
        """Storage cost of the packed representation (codes + scales)."""
        n = math.prod(self.shape)
        return n * self.format.bits // 8 + -(-n // math.prod(self.block))

    def to(self, device) -> "QuantizedTensor":
        return dataclasses.replace(self, codes=self.codes.to(device),
                                   scale_e8m0=self.scale_e8m0.to(device))


def _pad_to_block(x: torch.Tensor, block: Tuple[int, ...]) -> torch.Tensor:
    nb = len(block)
    pads = []
    for i, b in enumerate(block):
        pads.append((-x.shape[x.ndim - nb + i]) % b)
    if not any(pads):
        return x
    flat = []
    for extra in reversed(pads):  # F.pad lists the LAST dim first
        flat += [0, extra]
    return Fn.pad(x, flat)


def _to_blocks(x: torch.Tensor, block: Tuple[int, ...]) -> torch.Tensor:
    """(..., D1, D2) with block (b1, b2) -> (..., D1/b1, D2/b2, b1, b2)."""
    nb = len(block)
    lead = x.shape[: x.ndim - nb]
    split = []
    for i, b in enumerate(block):
        split += [x.shape[x.ndim - nb + i] // b, b]
    x = x.reshape(*lead, *split)
    nlead = len(lead)
    perm = list(range(nlead))
    perm += [nlead + 2 * i for i in range(nb)]
    perm += [nlead + 2 * i + 1 for i in range(nb)]
    return x.permute(perm)


def _block_amax(x: torch.Tensor, block: Tuple[int, ...]) -> torch.Tensor:
    xb = _to_blocks(x.abs(), block)
    return xb.amax(dim=tuple(range(xb.ndim - len(block), xb.ndim)))


def _se_per_element(se_grid: torch.Tensor, block: Tuple[int, ...]):
    """Block-grid (..., G1, G2) -> elementwise (..., G1*b1, G2*b2)."""
    nb = len(block)
    out = se_grid
    for i, b in enumerate(block):
        if b > 1:
            out = out.repeat_interleave(b, dim=out.ndim - nb + i)
    return out


def _crop(x: torch.Tensor, shape) -> torch.Tensor:
    if tuple(x.shape) == tuple(shape):
        return x
    return x[tuple(slice(0, d) for d in shape)]


# elements per codec pass: the elementwise codec keeps ~20 full-size
# temporaries alive, so a large leaf (the 5120 x 153600 LM head) is coded in
# slices of whole blocks along the last dim, which gives the same bytes
CHUNK_ELEMENTS = 1 << 26


def _slices(x: torch.Tensor, b_last: int):
    """Column ranges of whole blocks, each about CHUNK_ELEMENTS large."""
    width = x.shape[-1]
    rows = max(1, x.numel() // max(width, 1))
    step = max(b_last, CHUNK_ELEMENTS // rows // b_last * b_last)
    return [(i, min(i + step, width)) for i in range(0, width, step)] or \
        [(0, width)]


def quantize(x: torch.Tensor, fmt_name: str,
             block: Tuple[int, ...]) -> QuantizedTensor:
    """Bit-exact packed MX quantization."""
    fmt = F.get_format(fmt_name)
    if fmt.kind == "none":
        raise ValueError("bf16 passthrough has no packed form")
    orig_shape, orig_dtype = tuple(x.shape), dtype_name(x.dtype)
    x = _pad_to_block(x, block)
    codes, scales = [], []
    for a, b in _slices(x, block[-1]):
        xs = x[..., a:b].float()
        se = F.shared_exponent(_block_amax(xs, block))
        xa = _scale_exp2(xs, -_se_per_element(se, block))
        codes.append(F.encode_rel(xa, fmt))
        scales.append((se + SCALE_BIAS).clamp(0, 255).to(torch.uint8))
    cat = lambda ts: (ts[0] if len(ts) == 1 else
                      torch.cat(ts, dim=-1)).contiguous()
    return QuantizedTensor(cat(codes), cat(scales), fmt_name, tuple(block),
                           orig_shape, orig_dtype)


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    b_last = qt.block[-1]
    x = None
    for a, b in _slices(qt.codes, b_last):
        se = qt.scale_e8m0[..., a // b_last: b // b_last].to(torch.int32)
        xa = F.decode_rel(qt.codes[..., a:b], qt.format)
        part = xa * _exp2i(_se_per_element(se - SCALE_BIAS, qt.block))
        if b - a == qt.codes.shape[-1]:
            x = part
        else:
            if x is None:
                x = torch.empty(qt.codes.shape, dtype=torch.float32,
                                device=qt.codes.device)
            x[..., a:b] = part
    return _crop(x, qt.shape).to(torch_dtype(qt.dtype))


def qdq(x: torch.Tensor, fmt_name: str, block: Tuple[int, ...]) -> torch.Tensor:
    """Fused quantize-dequantize (simulated quantization, value domain)."""
    fmt = F.get_format(fmt_name)
    if fmt.kind == "none":
        return x
    orig_shape, orig_dtype = tuple(x.shape), x.dtype
    xf = _pad_to_block(x.float(), block)
    se_el = _se_per_element(F.shared_exponent(_block_amax(xf, block)), block)
    y = F.quantize_rel(_scale_exp2(xf, -se_el), fmt) * _exp2i(se_el)
    return _crop(y, orig_shape).to(orig_dtype)


def transpose_qt(qt: QuantizedTensor) -> QuantizedTensor:
    """Transpose without requantization (paper Fig. 4b).

    Valid for square 2D tiles: the tile holding x[i, j] in X^T is the
    transposed tile of X, so codes and scales swap their two trailing axes
    (views, as in the JAX package)."""
    if len(qt.block) != 2 or qt.block[0] != qt.block[1]:
        raise ValueError("transpose reuse requires square 2D tiles")
    shape = tuple(qt.shape[:-2]) + (qt.shape[-1], qt.shape[-2])
    return QuantizedTensor(qt.codes.transpose(-1, -2),
                           qt.scale_e8m0.transpose(-1, -2), qt.fmt, qt.block,
                           shape, qt.dtype)
