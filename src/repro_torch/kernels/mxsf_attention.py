"""Flash attention over an MXSF-packed KV cache: wrapper, plain version and
launch count.

Replaces the JAX package's Pallas TPU kernel
``kernels/mxsf_attention.py::_flash_attention_jit`` (public
``mxsf_flash_attention``, wrapper ``kernels/ops.py::mxsf_attention``): the
cached attention of S=1 decode steps and S=C prefill chunks.

  q        : (BH, S, dh) f32/bf16 -- one row per (batch x q-head)
  K/V      : cache layout codes (B, L, kv, dh) uint8 + scales (B, L, kv, 1)
             uint8, read in place; or row layout (BKV, L, dh) + (BKV, L),
             which is the same call on a (BKV, L, 1, dh) view.
  kv_len, q_offset, window : per-row runtime values (None / int / (BH,)).

* CUDA tensors launch ``csrc/mxsf_attention.cu``; what it does not take
  raises.  There is no fallback.
* CPU tensors take ``mxsf_attention_plain``, the counterpart of the JAX
  package's ``kernels/ref.py::mxsf_flash_attention_ref``.

Bound on the H100: the bytes of the valid K/V codes and scales plus q and
out, a few microseconds per layer at decode, where launch overhead is
expected to dominate.  ``launches`` counts kernel launches (the CPU path
does not count).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core import blocking as B

__all__ = ["NO_WINDOW", "per_row_scalar", "mxsf_attention",
           "mxsf_attention_plain", "launches"]

NO_WINDOW = 1 << 30  # matches models/transformer.py sentinel
NEG_INF = -1e30

launches = 0  # kernel launches; reset by whoever reads it

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
             + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])


def per_row_scalar(val, default: int, BH: int, device) -> torch.Tensor:
    """None / python int / scalar / (BH,) tensor -> (BH,) int32.

    Negative entries mean "use the default" (the kv_len=-1 = "all of L"
    convention of the JAX package)."""
    if val is None:
        return torch.full((BH,), default, dtype=torch.int32, device=device)
    val = torch.as_tensor(val, dtype=torch.int32, device=device)
    val = torch.where(val < 0, torch.full_like(val, default), val)
    return val.expand(BH).contiguous() if val.ndim == 0 else \
        val.reshape(BH).contiguous()


def _cache_layout(k_codes, k_scales, v_codes, v_scales):
    """Row layout (BKV, L, dh) -> the cache layout view (BKV, L, 1, dh)."""
    if k_codes.ndim == 4:
        return k_codes, k_scales, v_codes, v_scales
    return (k_codes[:, :, None, :], k_scales[:, :, None, None],
            v_codes[:, :, None, :], v_scales[:, :, None, None])


def mxsf_attention_plain(q, k_codes, k_scales, v_codes, v_scales, *,
                         causal: bool = True, kv_len=None, q_offset=None,
                         window=None):
    """Plain PyTorch version: dequantize the packed cache, masked softmax
    attention in f32; rows with no visible key return 0."""
    BH, S, dh = q.shape
    kc, ks, vc, vs = _cache_layout(k_codes, k_scales, v_codes, v_scales)
    Bc, L, KV, _ = kc.shape
    h = BH // Bc
    g = h // KV

    def rows(c, s):  # (B, L, kv, dh) -> (B*kv, L, dh) f32 values
        qt = B.QuantizedTensor(c, s, "mxsf", (dh,), tuple(c.shape),
                               "float32")
        return B.dequantize(qt).permute(0, 2, 1, 3).reshape(Bc * KV, L, dh)

    k = rows(kc, ks).repeat_interleave(g, dim=0)
    v = rows(vc, vs).repeat_interleave(g, dim=0)
    dev = q.device
    kvl = torch.clamp(per_row_scalar(kv_len, L, BH, dev), max=L)
    off = per_row_scalar(q_offset, 0, BH, dev)
    win = per_row_scalar(window, NO_WINDOW, BH, dev)
    s = torch.einsum("bsd,bld->bsl", q.float(), k) / math.sqrt(dh)
    qpos = off[:, None, None] + torch.arange(S, device=dev)[None, :, None]
    kpos = torch.arange(L, device=dev)[None, None, :]
    mask = kpos < kvl[:, None, None]
    if causal:
        mask = mask & (kpos <= qpos)
    mask = mask & (kpos > qpos - win[:, None, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("bsl,bld->bsd", p, v).to(q.dtype)


def mxsf_attention(q, k_codes, k_scales, v_codes, v_scales, *,
                   causal: bool = True, kv_len=None, q_offset=None,
                   window=None):
    """Flash attention over MXSF-packed K/V; returns (BH, S, dh) in q.dtype."""
    global launches
    BH, S, dh = q.shape
    kc, ks, vc, vs = _cache_layout(k_codes, k_scales, v_codes, v_scales)
    Bc, L, KV, dh2 = kc.shape
    if dh2 != dh or BH % Bc or (BH // Bc) % KV:
        raise ValueError(f"q {tuple(q.shape)} does not match K/V "
                         f"{tuple(kc.shape)}")
    if q.device.type == "cpu":
        return mxsf_attention_plain(q, kc, ks, vc, vs, causal=causal,
                                    kv_len=kv_len, q_offset=q_offset,
                                    window=window)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: expected float32 or bfloat16")
    if dh > 128:
        raise ValueError(f"head dim {dh} > 128 is not supported")
    for name, t in (("q", q), ("k_codes", kc), ("k_scales", ks),
                    ("v_codes", vc), ("v_scales", vs)):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous on {q.device}")
        if name != "q" and t.dtype != torch.uint8:
            raise TypeError(f"{name} must be uint8")
    kvl = torch.clamp(per_row_scalar(kv_len, L, BH, q.device), max=L)
    off = per_row_scalar(q_offset, 0, BH, q.device)
    win = per_row_scalar(window, NO_WINDOW, BH, q.device)
    out = torch.empty_like(q)
    if BH == 0 or S == 0:
        return out
    from . import build
    lib = build.library("mxsf_attention")
    fn = lib.mxsf_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), int(q.dtype == torch.bfloat16), kc.data_ptr(),
             ks.data_ptr(), vc.data_ptr(), vs.data_ptr(), kvl.data_ptr(),
             off.data_ptr(), win.data_ptr(), out.data_ptr(), BH, S, dh, Bc,
             L, KV, int(causal), math.sqrt(dh),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "mxsf_attention")
    launches += 1
    return out
