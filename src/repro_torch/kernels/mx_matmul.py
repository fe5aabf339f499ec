"""Packed x packed MXSF matmul: wrapper, plain version and launch count.

Replaces the JAX package's Pallas TPU kernel
``kernels/mx_matmul.py::mxsf_matmul_pallas`` (body ``_matmul_kernel``,
wrapper ``kernels/ops.py::mxsf_matmul``): ``y = decode(x) @ decode(w)`` in
f32 for packed operands (uint8 codes + E8M0 scales per block), each with
its own block shape.  The training path takes it for the 2D backward
(``dx = g @ w^T``, ``dw = x^T @ g`` on 8x8 tiles reused by
``transpose_qt``).

CUDA tensors launch ``csrc/mx_matmul.cu`` (bound by operations at training
shapes; see the source's note for the design) or raise; CPU tensors take
``mxsf_matmul_plain``, the counterpart of the JAX package's
``kernels/ref.py::mxsf_matmul_ref``: decode both operands through
``kernels/common.py`` (``decode_packed``), then an f32 matmul.  Operands
are made contiguous (a ``transpose_qt`` view is copied).  ``launches``
counts kernel launches (the CPU path does not count).
"""
from __future__ import annotations

import ctypes

import torch

from . import common as C

__all__ = ["mxsf_matmul", "mxsf_matmul_plain", "launches"]

launches = 0  # kernel launches; reset by whoever reads it

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def mxsf_matmul_plain(x_codes, x_scales, w_codes, w_scales, xblk=(1, 32),
                      wblk=(32, 1)):
    """Plain PyTorch version: decode both operands, f32 matmul."""
    return torch.matmul(C.decode_packed(x_codes, x_scales, xblk),
                        C.decode_packed(w_codes, w_scales, wblk))


def _check(x_codes, x_scales, w_codes, w_scales, xblk, wblk):
    if x_codes.ndim != 2 or w_codes.ndim != 2:
        raise ValueError("codes must be 2D")
    m, k = x_codes.shape
    k2, n = w_codes.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: x {tuple(x_codes.shape)}, "
                         f"w {tuple(w_codes.shape)}")
    for name, (r, c), (br, bc), s in (("x", (m, k), xblk, x_scales),
                                      ("w", (k, n), wblk, w_scales)):
        if r % br or c % bc or tuple(s.shape) != (r // br, c // bc):
            raise ValueError(f"{name}: codes ({r}, {c}) / scales "
                             f"{tuple(s.shape)} do not tile block "
                             f"({br}, {bc})")


def mxsf_matmul(x_codes, x_scales, w_codes, w_scales, xblk=(1, 32),
                wblk=(32, 1)):
    """y (M, N) f32 = decode(x) @ decode(w) for block-padded packed
    operands."""
    global launches
    xblk = tuple(int(b) for b in xblk)
    wblk = tuple(int(b) for b in wblk)
    _check(x_codes, x_scales, w_codes, w_scales, xblk, wblk)
    if x_codes.device.type == "cpu":
        return mxsf_matmul_plain(x_codes, x_scales, w_codes, w_scales, xblk,
                                 wblk)
    if not x_codes.is_cuda:
        raise ValueError(f"unsupported device {x_codes.device}")
    ops = [t.contiguous() for t in (x_codes, x_scales, w_codes, w_scales)]
    for t in ops:
        if t.dtype != torch.uint8 or t.device != x_codes.device:
            raise TypeError(f"codes and scales must be uint8 on "
                            f"{x_codes.device}")
    m, k = x_codes.shape
    n = w_codes.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x_codes.device)
    from . import build
    lib = build.library("mx_matmul")
    fn = lib.mxsf_matmul
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(*(t.data_ptr() for t in ops), y.data_ptr(), m, k, n, *xblk,
             *wblk, torch.cuda.current_stream(x_codes.device).cuda_stream)
    build.check(lib, err, "mxsf_matmul")
    launches += 1
    return y
