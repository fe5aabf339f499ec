"""Fused MXSF quantize->matmul: wrapper, plain version and launch count.

Replaces the JAX package's Pallas TPU kernel
``kernels/mxsf_fused_matmul.py::mxsf_fused_matmul_pallas`` (wrapper
``kernels/ops.py::mxsf_fused_matmul``): x (M, K) against a packed weight
(codes (Kp, N) uint8 + E8M0 scales under ``wblk``),
``y = qdq_MXSF(x; xblk) @ decode(w)`` in f32.  x may have fewer K columns
than the block-padded weight has rows; the gap reads as zero.  The two
training switches of the JAX kernel:

* ``quantize_lhs=False`` feeds the raw x (the backward's unquantized g);
* ``emit_codes=True`` also returns x's codes and scales, cropped to x's
  block-padded shape -- the packed residual of the backward.

* CUDA tensors launch ``csrc/mxsf_fused_matmul.cu`` (blocks (1,64)/(64,1)
  or (8,8)/(8,8); a raw x against either weight block); anything else the
  kernel does not take raises.  There is no fallback.
* ``meta`` tensors (a dry run, ``launch/dryrun.py``) pass the same checks
  and get empty outputs of the kernel's shapes; the launch is recorded
  with ``launch/cost.py`` and nothing is computed.
* CPU tensors take ``mxsf_fused_matmul_plain``, the counterpart of the JAX
  package's ``kernels/ref.py::mxsf_fused_matmul_ref``; its emitted codes
  come from ``blocking.quantize``.

Bound on the H100: the weight bytes at serving shapes (a few to ~64 rows,
below the ~295 op/byte ridge), operations at training shapes.  A quantized
x runs on the tensor cores (bf16 products of exactly decoded tiles), with
K split across blocks where the output tiles are few (``common.mma_plan``);
a raw x keeps f32 FMAs.  See the source's note for the design.
``launches`` counts kernel launches (the CPU path does not count);
``common.read_f32_steps("mxsf_fused_matmul")`` the K steps that took the
kernel's f32 path.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import blocking as B
from ..launch import cost
from . import common as C

__all__ = ["mxsf_fused_matmul", "mxsf_fused_matmul_plain", "launches",
           "tile"]

launches = 0  # kernel launches; reset by whoever reads it
PREP_STEPS = 8  # K steps per producer block (quantizing x once per call)

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
             + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
# the kernel's quantized-x modes by (xblk, wblk), and its weight blocks
_XMODE = {((1, 64), (64, 1)): 1, ((8, 8), (8, 8)): 2}
_WB8 = {(64, 1): 0, (8, 8): 1}


def tile(xmode: int, m: int):
    """The kernel's output tile for a mode and M rows: 128 x 128 for a raw
    x (f32 FMAs); for a quantized x, 16 x 256 at 16 rows or fewer ((1,64)
    only), 64 x 256 up to 64 rows, and beyond that 128 x 128 with x
    prepared once per call by producer blocks (``prepared``)."""
    if xmode == 0:
        return 128, 128
    if m > 64:
        return 128, 128
    return (16, 256) if xmode == 1 and m <= 16 else (64, 256)


def prepared(xmode: int, m: int) -> bool:
    """Whether the launch quantizes x once, in producer blocks."""
    return xmode != 0 and m > 64


def mxsf_fused_matmul_plain(x, w_codes, w_scales, xblk=(1, 64),
                            wblk=(64, 1), quantize_lhs: bool = True,
                            emit_codes: bool = False):
    """Plain PyTorch version: qdq the LHS (bit-identical to encode/decode),
    dequantize the packed RHS, f32 matmul; with ``emit_codes`` also
    ``blocking.quantize``'s codes and scales of x."""
    k = x.shape[1]
    kw, n = w_codes.shape
    xv = x.float()
    if kw > k:
        xv = torch.nn.functional.pad(xv, (0, kw - k))
    if quantize_lhs:
        xv = B.qdq(xv, "mxsf", tuple(xblk))
    qw = B.QuantizedTensor(w_codes, w_scales, "mxsf", tuple(wblk), (kw, n),
                           "float32")
    y = torch.matmul(xv, B.dequantize(qw))
    if not emit_codes:
        return y
    qx = B.quantize(x, "mxsf", tuple(xblk))
    return y, qx.codes, qx.scale_e8m0


def _check(x, w_codes, w_scales, xblk, wblk, quantize_lhs, emit_codes):
    if x.ndim != 2 or w_codes.ndim != 2:
        raise ValueError(f"x {tuple(x.shape)} and w_codes "
                         f"{tuple(w_codes.shape)} must be 2D")
    k = x.shape[1]
    kw, n = w_codes.shape
    if kw < k or kw % wblk[0] != 0 or n % wblk[1] != 0:
        raise ValueError(f"w_codes {tuple(w_codes.shape)} must have >= "
                         f"K={k} rows and tile the weight block {wblk}")
    if tuple(w_scales.shape) != (kw // wblk[0], n // wblk[1]):
        raise ValueError(f"w_scales shape {tuple(w_scales.shape)} does not "
                         f"match codes {tuple(w_codes.shape)} / {wblk}")
    if emit_codes and not quantize_lhs:
        raise ValueError("emit_codes requires quantize_lhs")


def mxsf_fused_matmul(x, w_codes, w_scales, xblk=(1, 64), wblk=(64, 1),
                      quantize_lhs: bool = True, emit_codes: bool = False):
    """y (M, N) f32 = qdq_MXSF(x) @ decode(w_codes, w_scales); with
    ``emit_codes`` returns ``(y, x_codes, x_scales)``."""
    global launches
    xblk = tuple(int(b) for b in xblk)
    wblk = tuple(int(b) for b in wblk)
    _check(x, w_codes, w_scales, xblk, wblk, quantize_lhs, emit_codes)
    if x.device.type == "cpu":
        return mxsf_fused_matmul_plain(x, w_codes, w_scales, xblk, wblk,
                                       quantize_lhs, emit_codes)
    if not (x.is_cuda or x.is_meta):
        raise ValueError(f"unsupported device {x.device}")
    m, k = x.shape
    kw, n = w_codes.shape
    xmode = _XMODE.get((xblk, wblk)) if quantize_lhs else 0
    if xmode is None or wblk not in _WB8:
        raise ValueError(f"the CUDA kernel takes blocks (1,64)/(64,1) or "
                         f"(8,8)/(8,8) (any weight block of the two for a "
                         f"raw x); got {xblk}/{wblk}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: expected float32 or bfloat16")
    if w_codes.dtype != torch.uint8 or w_scales.dtype != torch.uint8:
        raise TypeError("w_codes and w_scales must be uint8")
    for name, t in (("x", x), ("w_codes", w_codes), ("w_scales", w_scales)):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous on {x.device}")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    prep = prepared(xmode, m)
    codes = scales = None
    mb = kb = 0
    if emit_codes or prep:  # a prepared launch keeps x's codes for its
        # f32 path, emitted or not
        mb, kb = -(-m // xblk[0]) * xblk[0], -(-k // xblk[1]) * xblk[1]
        codes = torch.empty((mb, kb), dtype=torch.uint8, device=x.device)
        scales = torch.empty((mb // xblk[0], kb // xblk[1]),
                             dtype=torch.uint8, device=x.device)
    if m == 0 or n == 0:
        if emit_codes and codes.numel():
            raise ValueError("emit_codes needs at least one output column")
        return (y, codes, scales) if emit_codes else y
    if xmode == 0:  # the raw-x kernel reads f32 rows
        x = x.float().contiguous()
    plan = C.mma_plan(m, kw, n, *tile(xmode, m),
                      prep=PREP_STEPS if prep else 0)
    if x.is_meta:
        cost.record_launch("mxsf_fused_matmul", cost.fused_matmul_work(
            m, k, kw, n, x.element_size(), xblk, wblk, quantize_lhs,
            emit_codes), scratch=4 * plan["workspace"] + plan["prep_bytes"])
        return (y, codes, scales) if emit_codes else y
    work, counters, f32, pbuf, ready, epoch = C.gemm_scratch(
        "mxsf_fused_matmul", x.device, plan)
    a_cp = C.cp_width(x, k * x.element_size())
    b_cp = C.cp_width(w_codes, n)
    from . import build
    lib = build.library("mxsf_fused_matmul")
    fn = lib.mxsf_fused_matmul
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
             w_codes.data_ptr(), w_scales.data_ptr(), y.data_ptr(),
             work.data_ptr() if work is not None else None,
             counters.data_ptr(), f32.data_ptr(), m, k, kw, n, xmode,
             _WB8[wblk], codes.data_ptr() if codes is not None else None,
             scales.data_ptr() if codes is not None else None, mb, kb, a_cp,
             b_cp, plan["per"], plan["splits"], plan["bm"], plan["bn"],
             pbuf.data_ptr() if pbuf is not None else None, ready.data_ptr(),
             epoch, PREP_STEPS,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "mxsf_fused_matmul")
    launches += 1
    return (y, codes, scales) if emit_codes else y
