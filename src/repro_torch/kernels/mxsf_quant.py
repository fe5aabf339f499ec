"""MXSF quantize and packed->packed requantize: wrappers, plain versions and
launch counts.

Replaces the JAX package's Pallas TPU kernels
``kernels/mxsf_quant.py::mxsf_quantize_pallas`` (body ``_quant_kernel``)
and ``::mxsf_requantize_pallas`` (body ``_requant_kernel``), wrappers
``kernels/ops.py::mxsf_quantize`` / ``mxsf_requantize``.  Both share the
MXSF converter (``_encode_blocks`` here, ``_encode_tile`` there): block
amax -> shared exponent -> encode, through the bit-level codec of
``kernels/common.py``.

* ``mxsf_quantize(x, block)``: f32/bf16 (M, K) -> uint8 codes and E8M0
  scales, cropped to the block-padded shape (``QuantizedTensor``-ready).
* ``mxsf_requantize(codes, scales, from_block, to_block, transpose)``:
  re-block a packed tensor, bit for bit ``quantize(dequantize(qt),
  to_block)`` with the code grid treated as the value domain (zero padding
  to the lcm of both blocks, output cropped to the to-block-padded shape);
  ``transpose=True`` returns both grids transposed (what ``.T.contiguous()``
  of each would give), written so by the kernel.

CUDA tensors launch ``csrc/mxsf_quant.cu`` (bound by bytes) or raise; CPU
tensors take the plain versions.  There is no fallback.  The quantizer's
instance follows the block shape (``quantize_instance``): tiles of 32
16-byte pieces per row for (8,8), (64,1) and (1,64) (``tile_plan``), one
thread per MX block for any other shape.  The requantizer's follows the
block pair (``requantize_instance``): tiles of 64 rows x 512 codes for
(B,1)->(1,B) and (1,B)->(B,1), B in {32, 64} (``requant_plan``), one
thread per to-block for any other pair.
``launches`` counts kernel launches per wrapper (the CPU path does not
count).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import common as C

__all__ = ["mxsf_quantize", "mxsf_quantize_plain", "mxsf_requantize",
           "mxsf_requantize_plain", "quantize_instance", "tile_plan",
           "requantize_instance", "requant_plan", "reencode_table",
           "reencode_row", "reencode_check", "launches"]

# kernel launches per wrapper; reset by whoever reads them
launches = {"mxsf_quantize": 0, "mxsf_requantize": 0}

# elements per plain-codec pass: the elementwise codec keeps ~20 full-size
# temporaries, so large operands are coded in slices of whole block rows
_SLICE_ELEMENTS = 1 << 24


# the quantizer's tiled instances (csrc/mxsf_quant.cu::quantize_tiled) and
# the rows a thread holds in each
TILED = {(8, 8): "tiled (8,8)", (64, 1): "tiled (64,1)",
         (1, 64): "tiled (1,64)"}
ROWS_PER_THREAD = {(8, 8): 8, (64, 1): 8, (1, 64): 2}
PIECE_BYTES = 16   # bytes a lane reads at once


def quantize_instance(block) -> str:
    """The kernel instance the quantizer launches for ``block``."""
    return TILED.get(tuple(int(b) for b in block), "one thread per block")


def tile_plan(m: int, k: int, block, itemsize: int) -> dict:
    """Grid of a tiled quantizer launch on an (m, k) operand of
    ``itemsize``-byte elements: blocks of 8 warps over ``rows`` x ``cols``
    tiles of the block-padded (mb, kb); thread (warp w, lane l) of block
    (bx, by) holds rows ``rows`` by + ``rpt`` w .. + rpt - 1 of columns
    ``cols`` bx + v l .. + v - 1 (``v`` elements a 16-byte piece)."""
    bm, bk = block
    rpt = ROWS_PER_THREAD[(bm, bk)]
    v = PIECE_BYTES // itemsize
    mb, kb = _ceil_to(m, bm), _ceil_to(k, bk)
    rows, cols = 8 * rpt, 32 * v
    return dict(v=v, rpt=rpt, rows=rows, cols=cols, mb=mb, kb=kb,
                grid=(-(-kb // cols), -(-mb // rows)))


# the requantizer's tiled instances (csrc/mxsf_quant.cu::requantize_tiled):
# (from_block, to_block) -> instance; DIR 0 re-blocks (B,1) -> (1,B), DIR 1
# (1,B) -> (B,1)
REQUANT_B = (32, 64)
REQUANT_TILED = {
    **{((b, 1), (1, b)): f"tiled ({b},1)->(1,{b})" for b in REQUANT_B},
    **{((1, b), (b, 1)): f"tiled (1,{b})->({b},1)" for b in REQUANT_B}}
REQUANT_TILE = (64, 512)   # rows x codes of a tile: 8 warps x 8 rows, 32
                           # lanes x one 16-byte piece
REQUANT_BLOCKS_PER_SM = 2  # the persistent grid


def requantize_instance(from_block, to_block) -> str:
    """The kernel instance the requantizer launches for the block pair."""
    key = (tuple(int(b) for b in from_block), tuple(int(b) for b in to_block))
    return REQUANT_TILED.get(key, "one thread per block")


def requant_plan(m: int, k: int, from_block, to_block, sms: int = 132) -> dict:
    """Launch of a tiled requantize on an (m, k) code grid: ``b``, the
    direction ``dir`` (0: (B,1)->(1,B), 1: (1,B)->(B,1)), the output grid
    ``(mo, ko)`` (to-block padded) cut into ``tiles = (tx, ty)`` tiles of
    ``rows`` x ``cols``, and ``blocks`` persistent blocks of 8 warps on a
    card of ``sms`` SMs: block b takes tiles b, b + blocks, ..., tile t at
    column tile t % tx and row tile t // tx; thread (warp w, lane l) holds
    rows ``rows`` * (t // tx) + 8 w .. + 7 of codes ``cols`` * (t % tx) +
    16 l .. + 15."""
    fb, tb = tuple(from_block), tuple(to_block)
    if (fb, tb) not in REQUANT_TILED:
        raise ValueError(f"no tiled requantize instance for {fb}->{tb}")
    d = 0 if fb[1] == 1 else 1
    b = fb[0] if d == 0 else fb[1]
    mo, ko = _ceil_to(m, tb[0]), _ceil_to(k, tb[1])
    rows, cols = REQUANT_TILE
    tiles = (-(-ko // cols), -(-mo // rows))
    return dict(b=b, dir=d, mo=mo, ko=ko, rows=rows, cols=cols, tiles=tiles,
                blocks=min(tiles[0] * tiles[1], REQUANT_BLOCKS_PER_SM * sms))


# the re-encode table of the tiled requantizer (csrc/mxsf_quant.cu): row
# d - REENCODE_DMIN holds encode(decode(c) 2^d) for every code c; an element
# of from-exponent S in a block of exponent e (in [REENCODE_EMIN,
# REENCODE_EMAX]) codes as row clamp(S - e)
REENCODE_DMIN, REENCODE_DMAX = -13, 11
REENCODE_EMIN, REENCODE_EMAX = -149, 127


def reencode_table() -> torch.Tensor:
    """The re-encode table, (rows, 256) uint8, through the plain codec."""
    d = torch.arange(REENCODE_DMIN, REENCODE_DMAX + 1, dtype=torch.int32)
    lut = C.decode_mxsf(torch.arange(256, dtype=torch.int32))
    return C.encode_mxsf(lut[None, :] * C.exp2i(d)[:, None])


def reencode_row(s: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The table row of from-exponents ``s`` in blocks of exponent ``e``."""
    return (s - e - REENCODE_DMIN).clamp(0, REENCODE_DMAX - REENCODE_DMIN)


def reencode_check():
    """The card's re-encode table against its float path on every (code c,
    from-scale byte s, block exponent e) triple, index (e - REENCODE_EMIN)
    * 2^16 + s * 2^8 + c: ``(table_codes, float_codes, fits)``, uint8 CUDA
    tensors (``fits``: |value| < 2^(e+1), a value a block of exponent e
    can hold)."""
    from . import build
    n = (REENCODE_EMAX - REENCODE_EMIN + 1) << 16
    out = [torch.empty(n, dtype=torch.uint8, device="cuda")
           for _ in range(3)]
    lib = build.library("mxsf_quant")
    fn = lib.mxsf_reencode_check
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 4, ctypes.c_int
    err = fn(*(t.data_ptr() for t in out),
             C.raw_stream(torch.cuda.current_device()))
    build.check(lib, err, "mxsf_reencode_check")
    return tuple(out)


def _ceil_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _pad2d(x: torch.Tensor, m_to: int, k_to: int) -> torch.Tensor:
    m, k = x.shape
    if m_to == m and k_to == k:
        return x
    return torch.nn.functional.pad(x, (0, k_to - k, 0, m_to - m))


def _row_slices(m: int, k: int, bm: int):
    rows = max(bm, _SLICE_ELEMENTS // max(k, 1) // bm * bm)
    return [(i, min(i + rows, m)) for i in range(0, m, rows)] or [(0, 0)]


def _encode_blocks(x: torch.Tensor, bm: int, bk: int):
    """The converter body: f32 (M, K), both multiples of the block, ->
    (codes, scale bytes).  Mirrors the JAX package's ``_encode_tile``."""
    m, k = x.shape
    amax = x.abs().reshape(m // bm, bm, k // bk, bk).amax(dim=(1, 3))
    se = torch.where(amax > 0, C.flog2(amax),
                     torch.full_like(amax, -127, dtype=torch.int32))
    codes = C.encode_mxsf(C.scale_by_exp2(x, -C.broadcast_block_scale(
        se, bm, bk)))
    scales = (se + C.SCALE_BIAS).clamp(0, 255).to(torch.uint8)
    return codes, scales


def mxsf_quantize_plain(x: torch.Tensor, block=(1, 32)):
    """Plain PyTorch version: zero-pad to the block, encode through the
    codec of ``kernels/common.py``."""
    bm, bk = block
    m, k = x.shape
    mb, kb = _ceil_to(m, bm), _ceil_to(k, bk)
    xp = _pad2d(x, mb, kb)
    codes = torch.empty((mb, kb), dtype=torch.uint8, device=x.device)
    scales = torch.empty((mb // bm, kb // bk), dtype=torch.uint8,
                         device=x.device)
    for a, b in _row_slices(mb, kb, bm):
        codes[a:b], scales[a // bm:b // bm] = _encode_blocks(
            xp[a:b].float(), bm, bk)
    return codes, scales


def mxsf_requantize_plain(codes: torch.Tensor, scales: torch.Tensor,
                          from_block=(32, 1), to_block=(1, 32),
                          transpose: bool = False):
    """Plain PyTorch version: decode under ``from_block`` (the same exp2i
    product as ``blocking.dequantize``), re-encode under ``to_block``;
    ``transpose`` is ``.T.contiguous()`` of both results."""
    fbm, fbk = from_block
    tbm, tbk = to_block
    m, k = codes.shape
    bm, bk = math.lcm(fbm, tbm), math.lcm(fbk, tbk)
    mp, kp = _ceil_to(m, bm), _ceil_to(k, bk)
    c = _pad2d(codes, mp, kp)
    s = _pad2d(scales, mp // fbm, kp // fbk)
    out_c = torch.empty((mp, kp), dtype=torch.uint8, device=codes.device)
    out_s = torch.empty((mp // tbm, kp // tbk), dtype=torch.uint8,
                        device=codes.device)
    for a, b in _row_slices(mp, kp, bm):
        x = C.decode_packed(c[a:b], s[a // fbm:b // fbm], (fbm, fbk))
        out_c[a:b], out_s[a // tbm:b // tbm] = _encode_blocks(x, tbm, tbk)
    mb, kb = _ceil_to(m, tbm), _ceil_to(k, tbk)
    out_c, out_s = out_c[:mb, :kb], out_s[:mb // tbm, :kb // tbk]
    if transpose:
        out_c, out_s = out_c.T, out_s.T
    return out_c.contiguous(), out_s.contiguous()


_FNS: dict = {}  # entry point -> ctypes function, set at first launch


def _launch(name: str, argtypes, *args):
    from . import build
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.library("mxsf_quant"), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FNS[name] = fn
    err = fn(*args)
    if err:
        build.check(build.library("mxsf_quant"), err, name)
    launches[name] += 1


def _on_card(t: torch.Tensor, name: str) -> bool:
    """False for a CPU tensor (plain version), True for a contiguous CUDA
    tensor; anything else raises."""
    if t.device.type == "cpu":
        return False
    if not t.is_cuda:
        raise ValueError(f"{name}: unsupported device {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    return True


_Q_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_void_p]
_R_ARGS = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 + [
    ctypes.c_void_p] * 3


def mxsf_quantize(x: torch.Tensor, block=(1, 32)):
    """MXSF-quantize a 2D f32/bf16 tensor.  Returns ``(codes, scales)``
    cropped to the block-padded shape."""
    if x.ndim != 2:
        raise ValueError(f"x must be 2D; got {tuple(x.shape)}")
    bm, bk = (int(b) for b in block)
    if not _on_card(x, "mxsf_quantize"):
        return mxsf_quantize_plain(x, (bm, bk))
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: expected float32 or bfloat16")
    m, k = x.shape
    mb, kb = _ceil_to(m, bm), _ceil_to(k, bk)
    codes = torch.empty((mb, kb), dtype=torch.uint8, device=x.device)
    scales = torch.empty((mb // bm, kb // bk), dtype=torch.uint8,
                         device=x.device)
    _launch("mxsf_quantize", _Q_ARGS, x.data_ptr(),
            int(x.dtype == torch.bfloat16), m, k, bm, bk, codes.data_ptr(),
            scales.data_ptr(), C.raw_stream(x.get_device()))
    return codes, scales


def mxsf_requantize(codes: torch.Tensor, scales: torch.Tensor,
                    from_block=(32, 1), to_block=(1, 32),
                    transpose: bool = False):
    """Re-block a packed MXSF tensor.  ``codes`` is the from-block-padded
    grid; returns ``(codes, scales)`` cropped to the to-block-padded shape
    of that grid, or with ``transpose`` both transposed: (Kb, Mb) codes and
    (Kb/tbk, Mb/tbm) scales."""
    if codes.ndim != 2:
        raise ValueError(f"codes must be 2D; got {tuple(codes.shape)}")
    fbm, fbk = (int(b) for b in from_block)
    tbm, tbk = (int(b) for b in to_block)
    m, k = codes.shape
    if m % fbm or k % fbk or tuple(scales.shape) != (m // fbm, k // fbk):
        raise ValueError(f"codes {tuple(codes.shape)} / scales "
                         f"{tuple(scales.shape)} do not tile {from_block}")
    if not _on_card(codes, "mxsf_requantize"):
        return mxsf_requantize_plain(codes, scales, (fbm, fbk), (tbm, tbk),
                                     transpose)
    if codes.dtype != torch.uint8 or scales.dtype != torch.uint8:
        raise TypeError("codes and scales must be uint8")
    if scales.device != codes.device or not scales.is_contiguous():
        raise ValueError(f"scales must be contiguous on {codes.device}")
    mb, kb = _ceil_to(m, tbm), _ceil_to(k, tbk)
    shape_c, shape_s = (mb, kb), (mb // tbm, kb // tbk)
    if transpose:
        shape_c, shape_s = shape_c[::-1], shape_s[::-1]
    out_c = torch.empty(shape_c, dtype=torch.uint8, device=codes.device)
    out_s = torch.empty(shape_s, dtype=torch.uint8, device=codes.device)
    _launch("mxsf_requantize", _R_ARGS, codes.data_ptr(), scales.data_ptr(),
            m, k, fbm, fbk, tbm, tbk, int(bool(transpose)), out_c.data_ptr(),
            out_s.data_ptr(), C.raw_stream(codes.get_device()))
    return out_c, out_s
