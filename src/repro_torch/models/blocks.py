"""Model blocks: dense, norms, rotary embeddings, MLPs, attention.

PyTorch counterpart of the decoder and encoder parts of the JAX package's
``models/blocks.py``.  Every matmul goes through ``mx_dot`` /
``mx_einsum``; softmax, norms and residual math stay in f32 or the compute
dtype as in the JAX package.

Attention covers uncached self-attention (training and full-sequence
forward: ``_attend``/``_scores_block``, query-chunked with a
``torch.utils.checkpoint`` per chunk) and cached causal self-attention over
a packed MXSF KV cache through the flash kernel
(``kernels/mxsf_attention.py``), for S=1 decode steps and S=C prefill
chunks.  Cross-attention, un-packed or value-domain caches, and ``moe``
are not ported and raise ``NotImplementedError`` (ROADMAP.md, Queue 1
items 4a, 4b and 4d).

Where the JAX package returns a new cache, ``attention`` writes the new
K/V codes into the given cache tensors in place and returns the same dict.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn
import torch.utils.checkpoint as ckpt

from ..configs.base import ModelConfig
from ..core import blocking as mxblk
from ..core.blocking import QuantizedTensor
from ..core.mx_dot import mx_dot, mx_einsum, qdq_along
from ..core.policy import QuantPolicy
from ..kernels import mxsf_attention as MA


def dense(x, w, policy):
    """mx_dot with cast-at-use: f32 master weights -> activation dtype.

    A resident packed weight (``QuantizedTensor``) was cast to the compute
    dtype at pack time; mx_dot consumes its codes directly."""
    if isinstance(w, QuantizedTensor):
        return mx_dot(x, w, policy)
    return mx_dot(x, w.to(x.dtype), policy)


def rmsnorm(p, x, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["w"]).to(x.dtype)


def layernorm_init(d, device=None):
    return {"w": torch.ones(d, device=device),
            "b": torch.zeros(d, device=device)}


def layernorm(p, x, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["w"] + p["b"]).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, D), positions: (B, S) or (S,)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freq  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _split_heads(x, n, dh):
    return x.reshape(*x.shape[:-1], n, dh)


def attn_kernel_eligible(cfg: ModelConfig, policy: QuantPolicy) -> bool:
    """Static (cfg x policy) half of the packed-attention kernel gate:
    softcaps and SWA patterns need the value-domain path."""
    return (policy.use_attention_kernel and not cfg.attn_softcap
            and cfg.swa_pattern == "none")


def _write_cache(buf, upd, slot, write_len):
    """Write ``upd`` (B, S, ...) into ``buf`` (B, W, ...) in place.

    ``write_len=None``: rows 0..S-1 land on columns slot..slot+S-1, the
    start clamped to W-S as ``lax.dynamic_update_slice`` clamps it.
    Otherwise rows past ``write_len`` are dropped, as are rows whose column
    falls past the cache end -- never clamped, so a masked slot deep in its
    sequence cannot shift a chunk onto live history."""
    Bsz, S = upd.shape[:2]
    W = buf.shape[1]
    ar = torch.arange(S, device=buf.device)
    if write_len is None:
        start = torch.clamp(slot, max=W - S)
        cols = start[:, None] + ar[None, :]
        buf[torch.arange(Bsz, device=buf.device)[:, None], cols] = upd
        return
    cols = slot[:, None] + ar[None, :]
    keep = (ar[None, :] < write_len[:, None]) & (cols < W)
    bi, si = keep.nonzero(as_tuple=True)
    buf[bi, cols[bi, si]] = upd[bi, si]


def _attn_mask_bias(qpos, kpos, *, causal: bool, window):
    """Additive mask from broadcast position comparisons."""
    qp, kp = qpos[:, :, None], kpos[:, None, :]
    allowed = kp >= 0  # negative positions mark unwritten cache slots
    if causal:
        allowed = allowed & (kp <= qp)
    if window is not None:
        allowed = allowed & (kp > qp - window)
    zero = torch.zeros((), dtype=torch.float32, device=kpos.device)
    return torch.where(allowed, zero, torch.full_like(zero, -1e30))


def attention(p, x, cfg: ModelConfig, policy: QuantPolicy, *, positions=None,
              causal=True, window=None, cache=None, cache_pos=None,
              cache_write_len=None):
    """Self-attention.

    * train / full-sequence forward: ``cache=None``, ``positions`` (B, S)
      or (S,) -- query-chunked value-domain attention (``_attend``);
    * decode: ``cache`` a packed MXSF KV cache, ``cache_pos`` a scalar or
      (B,) position, all S rows written;
    * chunked prefill: ``cache_pos`` (B,) and ``cache_write_len`` (B,)
      valid tokens of this S-token chunk -- only columns pos..pos+len-1 are
      written, so a slot with len=0 leaves its cache untouched.  Queries
      past ``len`` produce rows the caller must ignore.
    Returns (out, cache) -- the cache dict updated in place, or None."""
    if cache is not None and ("k_codes" not in cache
                              or not attn_kernel_eligible(cfg, policy)):
        raise NotImplementedError(
            "cached attention is ported only over a packed MXSF KV cache "
            "through the kernel (not backend 'torch', softcaps or SWA "
            "patterns); see ROADMAP.md, Queue 1 item 4a")
    B, S, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    dev = x.device

    q = dense(x, p["wq"], policy)
    if "bq" in p:
        q = (q + p["bq"]).to(x.dtype)
    q = _split_heads(q, h, dh)
    k = dense(x, p["wk"], policy)
    v = dense(x, p["wv"], policy)
    if "bk" in p:
        k = (k + p["bk"]).to(x.dtype)
        v = (v + p["bv"]).to(x.dtype)
    k = _split_heads(k, kv, dh)
    v = _split_heads(v, kv, dh)
    use_rope = cfg.rope_theta > 0 and cfg.family != "encdec"

    if cache is None:
        qpos = (positions if positions.ndim == 2
                else positions[None, :]).expand(B, S)
        if use_rope:
            q = rope(q, qpos, cfg.rope_theta)
            k = rope(k, qpos, cfg.rope_theta)
        return _attend(q, k, v, qpos, qpos, causal, window, p, x, cfg,
                       policy), None

    pos_vec = torch.as_tensor(cache_pos, dtype=torch.int64,
                              device=dev).expand(B)
    if use_rope:
        positions = pos_vec[:, None] + torch.arange(S, device=dev)[None, :]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    W = cache["k_codes"].shape[1]
    slot = pos_vec % W
    wl = (None if cache_write_len is None else
          torch.as_tensor(cache_write_len, dtype=torch.int64,
                          device=dev).expand(B))
    fmt = policy.kv_cache_fmt or "mxsf"
    for nm, val in (("k", k), ("v", v)):
        qt = mxblk.quantize(val, fmt, (dh,))
        _write_cache(cache[f"{nm}_codes"], qt.codes, slot, wl)
        _write_cache(cache[f"{nm}_scales"], qt.scale_e8m0, slot, wl)
    return _attend_packed(q, cache, pos_vec, window, p, cfg, policy), cache


ATTN_CHUNK = 1024  # query-chunk target (flash-style; bounds score memory)


def _pick_chunk(S: int) -> int:
    for c in range(min(S, ATTN_CHUNK), 0, -1):
        if S % c == 0:
            return c
    return S


def _scores_block(qg_c, kk, vv, qpos_c, kpos, causal, window, dh, cfg,
                  policy, out_dtype):
    """One query block: (B,kv,g,C,dh) x (B,kv,L,dh) -> (B,kv,g,C,dh)."""
    scores = mx_einsum("bkgsd,bkld->bkgsl", qg_c, kk, policy,
                       axes=(-1, -1), g_axes=(-1, -2))
    scores = scores.float() / math.sqrt(dh)
    if cfg.attn_softcap:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    bias = _attn_mask_bias(qpos_c, kpos, causal=causal, window=window)
    scores = scores + bias[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(out_dtype)
    return mx_einsum("bkgsl,bkld->bkgsd", probs, vv, policy,
                     axes=(-1, -2), g_axes=(-1, -2))


def _attend(q, k, v, qpos, kpos, causal, window, p, x, cfg: ModelConfig,
            policy: QuantPolicy):
    """Query-chunked attention: the full (S x L) score tensor never exists
    at once; each chunk is recomputed in the backward
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``)."""
    B, S, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(B, S, kv, g, dh).permute(0, 2, 3, 1, 4)
    kk = k.permute(0, 2, 1, 3)   # (B, kv, L, dh)
    vv = v.permute(0, 2, 1, 3)
    chunk = _pick_chunk(S)
    if S <= chunk:
        ctx = _scores_block(qg, kk, vv, qpos, kpos, causal, window, dh, cfg,
                            policy, x.dtype)
    else:
        parts = []
        for c0 in range(0, S, chunk):
            parts.append(ckpt.checkpoint(
                _scores_block, qg[:, :, :, c0:c0 + chunk], kk, vv,
                qpos[:, c0:c0 + chunk], kpos, causal, window, dh, cfg,
                policy, x.dtype, use_reentrant=False))
        ctx = torch.cat(parts, dim=3)
    ctx = ctx.permute(0, 3, 1, 2, 4).reshape(B, S, h * dh)
    return dense(ctx, p["wo"], policy)


def _attend_packed(q, cache, pos_vec, window, p, cfg: ModelConfig,
                   policy: QuantPolicy):
    """Cached attention consuming the packed MXSF cache directly (S=1 decode
    and S=C prefill).  q is 1D-quantized along dh when
    ``policy.attn_matmuls``; the probabilities stay f32 in the kernel's
    online softmax."""
    B, S, h, dh = q.shape
    qr = q.permute(0, 2, 1, 3).reshape(B * h, S, dh)
    if policy.attn_matmuls:
        qr = qdq_along(qr, policy.fwd_fmt, policy, -1)
    kvl = (pos_vec + S).repeat_interleave(h)  # slots 0..pos hold 0..pos
    off = pos_vec.repeat_interleave(h)        # the query's absolute pos
    win = None if window is None else torch.full_like(off, int(window))
    y = MA.mxsf_attention(qr.contiguous(), cache["k_codes"],
                          cache["k_scales"], cache["v_codes"],
                          cache["v_scales"], causal=True, kv_len=kvl,
                          q_offset=off, window=win)
    ctx = y.reshape(B, h, S, dh).permute(0, 2, 1, 3).reshape(B, S, h * dh)
    return dense(ctx, p["wo"], policy)


def mlp(p, x, cfg: ModelConfig, policy: QuantPolicy):
    if cfg.mlp in ("swiglu", "geglu"):
        act = Fn.silu if cfg.mlp == "swiglu" else \
            (lambda v: Fn.gelu(v, approximate="tanh"))
        gate = act(dense(x, p["wg"], policy))
        up = dense(x, p["wu"], policy)
        return dense(gate * up, p["wd"], policy)
    hdn = Fn.gelu(dense(x, p["wu"], policy), approximate="tanh")
    return dense(hdn, p["wd"], policy)


def dense_init(gen, d_in, d_out, device, scale=None):
    """normal * 1/sqrt(d_in) -- the JAX package's ``_dense_init``
    distribution (not its bits)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=gen, device=device,
                       dtype=torch.float32) * scale
