"""Fused MXSF quantize->matmul: wrapper, plain version and launch count.

Replaces the JAX package's Pallas TPU kernel
``kernels/mxsf_fused_matmul.py::mxsf_fused_matmul_pallas`` (wrapper
``kernels/ops.py::mxsf_fused_matmul``) on the serving path: unquantized x
(M, K) against a packed weight (codes (Kp, N) uint8 + E8M0 scales
(Kp/64, N)), ``y = qdq_MXSF(x) @ decode(w)`` in f32.  x may have fewer K
columns than the block-padded weight has rows; the gap reads as zero.

* CUDA tensors launch ``csrc/mxsf_fused_matmul.cu`` (serving switches only:
  ``quantize_lhs=True, emit_codes=False``, blocks (1,64)/(64,1)); anything
  else the kernel does not take raises.  There is no fallback.
* CPU tensors take ``mxsf_fused_matmul_plain``, the counterpart of the JAX
  package's ``kernels/ref.py::mxsf_fused_matmul_ref``.

Bound on the H100: the weight bytes at serving shapes (a few to ~64 rows,
below the ~295 op/byte ridge).  The kernel streams each weight byte once per
64-row M tile and keeps every product exact in f32; see the source's note
for the design.  ``launches`` counts kernel launches (the CPU path does not
count).
"""
from __future__ import annotations

import ctypes

import torch

from ..core import blocking as B

__all__ = ["mxsf_fused_matmul", "mxsf_fused_matmul_plain", "launches"]

launches = 0  # kernel launches; reset by whoever reads it

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def mxsf_fused_matmul_plain(x, w_codes, w_scales, xblk=(1, 64),
                            wblk=(64, 1), quantize_lhs: bool = True):
    """Plain PyTorch version: qdq the LHS (bit-identical to encode/decode),
    dequantize the packed RHS, f32 matmul."""
    k = x.shape[1]
    kw, n = w_codes.shape
    xv = x.float()
    if kw > k:
        xv = torch.nn.functional.pad(xv, (0, kw - k))
    if quantize_lhs:
        xv = B.qdq(xv, "mxsf", tuple(xblk))
    qw = B.QuantizedTensor(w_codes, w_scales, "mxsf", tuple(wblk), (kw, n),
                           "float32")
    return torch.matmul(xv, B.dequantize(qw))


def _check(x, w_codes, w_scales, xblk, wblk):
    if x.ndim != 2 or w_codes.ndim != 2:
        raise ValueError(f"x {tuple(x.shape)} and w_codes "
                         f"{tuple(w_codes.shape)} must be 2D")
    k = x.shape[1]
    kw, n = w_codes.shape
    if kw < k or kw % wblk[0] != 0:
        raise ValueError(f"w_codes rows {kw} must be >= K={k} and a "
                         f"multiple of the weight block {wblk}")
    if tuple(w_scales.shape) != (kw // wblk[0], n // wblk[1]):
        raise ValueError(f"w_scales shape {tuple(w_scales.shape)} does not "
                         f"match codes {tuple(w_codes.shape)} / {wblk}")


def mxsf_fused_matmul(x, w_codes, w_scales, xblk=(1, 64), wblk=(64, 1),
                      quantize_lhs: bool = True, emit_codes: bool = False):
    """y (M, N) f32 = qdq_MXSF(x) @ decode(w_codes, w_scales)."""
    global launches
    _check(x, w_codes, w_scales, xblk, wblk)
    if x.device.type == "cpu":
        if emit_codes:
            raise NotImplementedError("emit_codes serves training; see "
                                      "ROADMAP.md, deferred item 3")
        return mxsf_fused_matmul_plain(x, w_codes, w_scales, xblk, wblk,
                                       quantize_lhs)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if not quantize_lhs or emit_codes:
        raise NotImplementedError(
            "the CUDA kernel takes the serving switches only "
            "(quantize_lhs=True, emit_codes=False); see ROADMAP.md, "
            "deferred item 3")
    if tuple(xblk) != (1, 64) or tuple(wblk) != (64, 1):
        raise ValueError(f"the CUDA kernel takes blocks (1,64)/(64,1); got "
                         f"{tuple(xblk)}/{tuple(wblk)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: expected float32 or bfloat16")
    if w_codes.dtype != torch.uint8 or w_scales.dtype != torch.uint8:
        raise TypeError("w_codes and w_scales must be uint8")
    for name, t in (("x", x), ("w_codes", w_codes), ("w_scales", w_scales)):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous on {x.device}")
    m, k = x.shape
    kw, n = w_codes.shape
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    vec_ok = int(n % 16 == 0 and w_codes.data_ptr() % 16 == 0
                 and w_scales.data_ptr() % 16 == 0)
    from . import build
    lib = build.library("mxsf_fused_matmul")
    fn = lib.mxsf_fused_matmul
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
             w_codes.data_ptr(), w_scales.data_ptr(), y.data_ptr(),
             m, k, kw, n, vec_ok,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "mxsf_fused_matmul")
    launches += 1
    return y
