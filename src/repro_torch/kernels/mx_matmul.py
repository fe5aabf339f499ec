"""Packed x packed MXSF matmul: wrapper, plain version and launch count.

Replaces the JAX package's Pallas TPU kernel
``kernels/mx_matmul.py::mxsf_matmul_pallas`` (body ``_matmul_kernel``,
wrapper ``kernels/ops.py::mxsf_matmul``): ``y = decode(x) @ decode(w)`` in
f32 for packed operands (uint8 codes + E8M0 scales per block), each with
its own block shape.  The training path takes it for the 2D backward
(``dx = g @ w^T``, ``dw = x^T @ g`` on 8x8 tiles reused by
``transpose_qt``).

CUDA tensors launch ``csrc/mx_matmul.cu`` for blocks (8,8)/(8,8),
(1,64)/(64,1) or (1,32)/(32,1) (bound by operations at training shapes:
bf16 tensor-core products of exactly decoded tiles, see the source's note)
or raise; ``meta`` tensors pass the same checks, get an empty output and
record the launch with ``launch/cost.py``; CPU tensors take
``mxsf_matmul_plain``, the counterpart of the JAX package's
``kernels/ref.py::mxsf_matmul_ref``: decode both operands through
``kernels/common.py`` (``decode_packed``), then an f32 matmul.  Operands
are made contiguous (a ``transpose_qt`` view is copied).  ``launches``
counts kernel launches (the CPU path does not count);
``common.read_f32_steps("mxsf_matmul")`` the K steps that took the kernel's
f32 path.
"""
from __future__ import annotations

import ctypes

import torch

from ..launch import cost
from . import common as C

__all__ = ["mxsf_matmul", "mxsf_matmul_plain", "launches", "TILE", "BLOCKS"]

launches = 0  # kernel launches; reset by whoever reads it

TILE = (128, 128)  # the kernel's output tile (kBM, kBN)
PREP_STEPS = 16    # K steps per producer block (decoding A once per call)
BLOCKS = (((8, 8), (8, 8)), ((1, 64), (64, 1)), ((1, 32), (32, 1)))
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 13
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


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
    if not (x_codes.is_cuda or x_codes.is_meta):
        raise ValueError(f"unsupported device {x_codes.device}")
    if (xblk, wblk) not in BLOCKS:
        raise ValueError(f"the CUDA kernel takes blocks {BLOCKS}; got "
                         f"{xblk}/{wblk}")
    ops = [t.contiguous() for t in (x_codes, x_scales, w_codes, w_scales)]
    for t in ops:
        if t.dtype != torch.uint8 or t.device != x_codes.device:
            raise TypeError(f"codes and scales must be uint8 on "
                            f"{x_codes.device}")
    m, k = x_codes.shape
    n = w_codes.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x_codes.device)
    plan = C.mma_plan(m, k, n, *TILE, prep=PREP_STEPS)
    if y.is_meta:
        cost.record_launch("mxsf_matmul", cost.mx_matmul_work(
            m, k, n, xblk, wblk),
            scratch=4 * plan["workspace"] + plan["prep_bytes"])
        return y
    work, counters, f32, pbuf, ready, epoch = C.gemm_scratch(
        "mxsf_matmul", x_codes.device, plan)
    a_cp, b_cp = C.cp_width(ops[0], k), C.cp_width(ops[2], n)
    from . import build
    lib = build.library("mx_matmul")
    fn = lib.mxsf_matmul
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(*(t.data_ptr() for t in ops), y.data_ptr(),
             work.data_ptr() if work is not None else None,
             counters.data_ptr(), f32.data_ptr(), m, k, n, *xblk, *wblk,
             a_cp, b_cp, plan["per"], plan["splits"], *TILE,
             pbuf.data_ptr() if pbuf is not None else None,
             ready.data_ptr(), epoch, PREP_STEPS,
             torch.cuda.current_stream(x_codes.device).cuda_stream)
    build.check(lib, err, "mxsf_matmul")
    launches += 1
    return y
