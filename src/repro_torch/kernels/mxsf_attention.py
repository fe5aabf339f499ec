"""Flash attention over an MXSF-packed KV cache: wrapper, launch plan, plain
version and launch count.

Replaces the JAX package's Pallas TPU kernel
``kernels/mxsf_attention.py::_flash_attention_jit`` (public
``mxsf_flash_attention``, wrapper ``kernels/ops.py::mxsf_attention``): the
cached attention of S=1 decode steps and S=C prefill chunks.

  q        : (BH, S, dh) f32/bf16 -- one row per (batch x q-head)
  K/V      : cache layout codes (B, L, kv, dh) uint8 + scales (B, L, kv, 1)
             uint8, read in place; or row layout (BKV, L, dh) + (BKV, L),
             which is the same call on a (BKV, L, 1, dh) view.
  kv_len, q_offset, window : per-row runtime values (None / int / (BH,)).

* CUDA tensors launch ``csrc/mxsf_attention.cu`` (one block per slot, kv
  head, row tile of the GQA group and key split; design in its header);
  what it does not take raises.  There is no fallback.
* ``meta`` tensors pass the same checks and get an empty output; the
  launch is recorded with ``launch/cost.py`` (``meta_visible``: the
  lengths are not known there, so every row counts its keys up to the
  cache's end) and nothing is computed.
* CPU tensors take ``mxsf_attention_plain``, the counterpart of the JAX
  package's ``kernels/ref.py::mxsf_flash_attention_ref``.

``attention_plan`` is the launch's grid, computed from shapes alone (the
per-row lengths stay on the device).  Bound on the H100: the bytes of the
valid K/V codes and scales plus q and out, a few microseconds per layer.
``launches`` counts kernel launches (the CPU path does not count); the
tiles whose scores took the f32 path are read with
``common.read_f32_steps("mxsf_attention")``.
"""
from __future__ import annotations

import ctypes
import functools
import math
import types

import torch

from ..core import blocking as B
from ..launch import cost
from . import common as C

__all__ = ["NO_WINDOW", "per_row_scalar", "attention_plan", "mxsf_attention",
           "mxsf_attention_plain", "meta_visible", "division", "launches"]

NO_WINDOW = 1 << 30  # matches models/transformer.py sentinel
NEG_INF = -1e30

launches = 0  # kernel launches; reset by whoever reads it

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
             + [ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_void_p]
             + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 4
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_LIB: dict = {}  # the loaded library and its function, set at first launch

# the kernel's tiles (csrc/mxsf_attention.cu)
KEY_TILE = 64     # kKT: keys per tile
MAX_ROWS = 80     # kMaxMT: rows per row tile, at most (a multiple of 16)
MAX_SPLITS = 32   # kMaxSplits
MIN_CTAS = 264    # kMinCtas: two waves of 132 SMs
ONE_WAVE_ROWS = 48  # kOneWaveRows: row tiles this tall take one wave


@functools.lru_cache(maxsize=256)
def attention_plan(batch: int, kv: int, g: int, S: int, L: int,
                   dh: int) -> dict:
    """Grid of one launch.  The g * S query rows of a kv head's GQA group
    go in row tiles of ``mt`` (16 .. MAX_ROWS, a multiple of 16);
    ``groups`` = batch x kv x row tiles.  The cache length is cut into
    ``splits`` ranges of ``per`` tiles of KEY_TILE keys, so that groups x
    splits reaches MIN_CTAS blocks (two waves) where L allows, at most
    MAX_SPLITS splits; row tiles of ONE_WAVE_ROWS or more, whose blocks
    each keep an SM busy, take at most one wave (N_SMS blocks) instead.
    ``workspace``: f32 partials (acc[dh], m, l per row and split; none
    unsplit); ``counters``: one int32 per group.  Cached, so read-only."""
    m = g * S
    mt = 16 * min(MAX_ROWS // 16, max(1, -(-m // 16)))
    m_tiles = max(1, -(-m // mt))
    groups = batch * kv * m_tiles
    tiles = max(1, -(-L // KEY_TILE))
    if mt >= ONE_WAVE_ROWS:  # at most one block per SM
        want = max(1, min(tiles, MAX_SPLITS, C.N_SMS // groups))
        per = -(-tiles // want)
    else:  # at least two waves
        want = min(tiles, MAX_SPLITS, -(-MIN_CTAS // groups))
        per = max(tiles // want, -(-tiles // MAX_SPLITS))
    splits = -(-tiles // per)
    return types.MappingProxyType(dict(
        mt=mt, m_tiles=m_tiles, groups=groups, tiles=tiles, per=per,
        splits=splits, ctas=groups * splits,
        workspace=groups * splits * mt * (dh + 2) if splits > 1 else 0,
        counters=groups if splits > 1 else 0))


def _row_arg(val, BH: int, device):
    """A per-row argument as the kernel takes it: (a (BH,) int32 tensor on
    the device, or None, and the value every row takes without one).
    Negative values mean the default; the kernel applies it, so a (BH,)
    int32 tensor costs no torch op."""
    if val is None:
        return None, -1
    if not isinstance(val, torch.Tensor):
        return None, int(val)
    if (val.dtype is torch.int32 and val.dim() == 1 and val.shape[0] == BH
            and val.is_contiguous() and val.get_device() == device.index):
        return val, -1
    if val.dtype != torch.int32 or val.get_device() != device.index:
        val = val.to(device=device, dtype=torch.int32)
    if val.ndim == 0:
        val = val.expand(BH)
    return val.reshape(BH).contiguous(), -1


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


def meta_visible(S: int, L: int, causal: bool, kv_len, q_offset, window):
    """(keys a row reads, visible (query, key) pairs of one row) for a
    launch whose per-row values may be unknown (tensors on ``meta``):
    ``kv_len`` all of L, the S queries at the end of the keys, no window
    -- what a decode step at the cache's last position needs.  Python
    ints are taken as given."""
    n = min(kv_len, L) if isinstance(kv_len, int) and kv_len >= 0 else L
    off = q_offset if isinstance(q_offset, int) else max(n - S, 0)
    win = window if isinstance(window, int) else NO_WINDOW
    vis = 0
    for i in range(S):
        hi = min(n, off + i + 1) if causal else n
        vis += max(0, hi - max(0, off + i - win + 1))
    return n, vis


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
    if not (q.is_cuda or q.is_meta):
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: expected float32 or bfloat16")
    if dh > 128:
        raise ValueError(f"head dim {dh} > 128 is not supported")
    dev = q.get_device()
    for name, t in (("q", q), ("k_codes", kc), ("k_scales", ks),
                    ("v_codes", vc), ("v_scales", vs)):
        if not t.is_contiguous() or t.get_device() != dev:
            raise ValueError(f"{name} must be contiguous on {q.device}")
        if name != "q" and t.dtype != torch.uint8:
            raise TypeError(f"{name} must be uint8")
    out = torch.empty_like(q)
    if BH == 0 or S == 0:
        return out
    plan = attention_plan(Bc, KV, BH // Bc // KV, S, L, dh)
    if q.is_meta:
        n, vis = meta_visible(S, L, causal, kv_len, q_offset, window)
        cost.record_launch("mxsf_attention", cost.attention_work(
            Bc * n, KV, dh, q.numel(), q.element_size(), BH * vis),
            scratch=4 * plan["workspace"])
        return out
    rows = [_row_arg(v, BH, q.device) for v in (kv_len, q_offset, window)]
    if plan["groups"] >= 1 << 31:
        raise ValueError(f"{plan['groups']} row groups: too many blocks")
    work, counters, f32 = C.split_scratch("mxsf_attention", q.device, plan)
    vec = int(dh % 16 == 0 and kc.data_ptr() % 16 == 0
              and vc.data_ptr() % 16 == 0)
    q_vec = int(dh * q.element_size() % 16 == 0 and q.data_ptr() % 16 == 0)
    if not _LIB:
        from . import build
        lib = build.library("mxsf_attention")
        lib.mxsf_attention.argtypes = _ARGTYPES
        lib.mxsf_attention.restype = ctypes.c_int
        _LIB.update(lib=lib, fn=lib.mxsf_attention)
    lib, fn = _LIB["lib"], _LIB["fn"]
    ptr = lambda t: None if t is None else t.data_ptr()
    err = fn(q.data_ptr(), int(q.dtype == torch.bfloat16), kc.data_ptr(),
             ks.data_ptr(), vc.data_ptr(), vs.data_ptr(),
             ptr(rows[0][0]), rows[0][1], ptr(rows[1][0]), rows[1][1],
             ptr(rows[2][0]), rows[2][1], out.data_ptr(), BH, S, dh, Bc,
             L, KV, int(causal), math.sqrt(dh), plan["mt"], plan["m_tiles"],
             plan["splits"], plan["per"], ptr(work), counters.data_ptr(),
             f32.data_ptr(), vec, q_vec,
             C.raw_stream(dev))
    if err:
        from . import build
        build.check(lib, err, "mxsf_attention")
    launches += 1
    return out


def division(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` for contiguous f32 CUDA tensors of one shape, computed as
    the kernel divides (scores by sqrt(dh), outputs by l): its branch-free
    sequence where the operands allow, the IEEE division elsewhere -- for
    the card's check that the two give the same bits."""
    if (not a.is_cuda or a.dtype != torch.float32 or b.dtype != a.dtype
            or a.shape != b.shape or not a.is_contiguous()
            or not b.is_contiguous() or b.device != a.device):
        raise ValueError("division takes two contiguous f32 CUDA tensors "
                         "of one shape")
    from . import build
    lib = build.library("mxsf_attention")
    fn = lib.mxsf_attention_division
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    q = torch.empty_like(a)
    err = fn(a.data_ptr(), b.data_ptr(), q.data_ptr(), a.numel(),
             C.raw_stream(a.get_device()))
    build.check(lib, err, "mxsf_attention_division")
    return q
