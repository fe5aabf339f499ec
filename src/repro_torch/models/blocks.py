"""Model blocks: dense, norms, rotary embeddings, MLPs, attention, MoE.

PyTorch counterpart of the decoder and encoder parts of the JAX package's
``models/blocks.py``.  Every matmul goes through ``mx_dot`` /
``mx_einsum``; softmax, norms, router and residual math stay in f32 or the
compute dtype as in the JAX package.

Attention covers uncached self-attention (training and full-sequence
forward: ``_attend``/``_scores_block``, query-chunked with a
``torch.utils.checkpoint`` per chunk) and cached causal self-attention for
S=1 decode steps and S=C prefill chunks, over a value cache (``k``/``v``)
or a packed MXSF KV cache.  A packed cache is read in place by the flash
kernel (``kernels/mxsf_attention.py``) where ``attn_kernel_eligible``
allows, else dequantized into the value path (``kv_prequant``).  The
value path is ring-aware (``kpos``), so softcaps and SWA windows take it.
Cross-attention (encoder-decoder) takes the value path too: keys and
values projected from ``kv_x`` (training, ``encode``) or read from a
precomputed cross cache (``kv_cached``, decode), no rope and no mask.

``moe`` is the JAX package's capacity-based per-row dispatch
(``_row_dispatch``) with its combine; the router and the expert FFNs run
in values through ``mx_einsum``.

Where the JAX package returns a new cache, ``attention`` writes the new
K/V rows (values or codes) into the given cache tensors in place and
returns the same dict.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn
import torch.utils.checkpoint as ckpt

from ..configs.base import ModelConfig
from ..core import blocking as mxblk
from ..core.blocking import QuantizedTensor, dtype_name
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
    """Additive mask from broadcast position comparisons (``qpos`` None:
    cross-attention, only ``kpos`` masks)."""
    kp = kpos[:, None, :]
    allowed = kp >= 0  # negative positions mark unwritten cache slots
    if qpos is not None:
        qp = qpos[:, :, None]
        if causal:
            allowed = allowed & (kp <= qp)
        if window is not None:
            allowed = allowed & (kp > qp - window)
    zero = torch.zeros((), dtype=torch.float32, device=kpos.device)
    return torch.where(allowed, zero, torch.full_like(zero, -1e30))


def attention(p, x, cfg: ModelConfig, policy: QuantPolicy, *, positions=None,
              kv_x=None, kv_cached=None, causal=True, window=None,
              cache=None, cache_pos=None, cache_write_len=None):
    """Self- and cross-attention.

    * train / full-sequence forward: ``cache=None``, ``positions`` (B, S)
      or (S,) -- query-chunked value-domain attention (``_attend``);
    * decode: ``cache`` a value cache ``{k, v}`` or a packed MXSF cache
      ``{k_codes, k_scales, v_codes, v_scales}``, ``cache_pos`` a scalar
      or (B,) position, all S rows written at ``pos % W`` (a ring when the
      cache is narrower than the sequence);
    * chunked prefill: ``cache_pos`` (B,) and ``cache_write_len`` (B,)
      valid tokens of this S-token chunk -- only columns pos..pos+len-1 are
      written, so a slot with len=0 leaves its cache untouched.  Queries
      past ``len`` produce rows the caller must ignore;
    * cross-attention: keys and values from ``kv_x`` (B, L, d) -- the
      encoder's states -- or from ``kv_cached`` ``{k, v}`` (B, L, kv, dh),
      the precomputed cross cache; no rope, every key visible.
    Returns (out, cache) -- the cache dict updated in place, or None."""
    B, S, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    dev = x.device

    q = dense(x, p["wq"], policy)
    if "bq" in p:
        q = (q + p["bq"]).to(x.dtype)
    q = _split_heads(q, h, dh)
    if kv_cached is not None:
        k, v = (kv_cached[n].to(x.dtype) for n in ("k", "v"))
        kpos = torch.zeros((B, k.shape[1]), dtype=torch.int64, device=dev)
        return _attend(q, k, v, None, kpos, False, None, p, x, cfg,
                       policy), None
    src = x if kv_x is None else kv_x
    k = dense(src, p["wk"], policy)
    v = dense(src, p["wv"], policy)
    if "bk" in p:
        k = (k + p["bk"]).to(x.dtype)
        v = (v + p["bv"]).to(x.dtype)
    k = _split_heads(k, kv, dh)
    v = _split_heads(v, kv, dh)
    use_rope = (kv_x is None and cfg.rope_theta > 0
                and cfg.family != "encdec")

    if cache is None:
        if kv_x is not None:  # cross-attention: all encoder slots valid
            kpos = torch.zeros((B, k.shape[1]), dtype=torch.int64,
                               device=dev)
            return _attend(q, k, v, None, kpos, False, window, p, x, cfg,
                           policy), None
        qpos = (positions if positions.ndim == 2
                else positions[None, :]).expand(B, S)
        if use_rope:
            q = rope(q, qpos, cfg.rope_theta)
            k = rope(k, qpos, cfg.rope_theta)
        return _attend(q, k, v, qpos, qpos, causal, window, p, x, cfg,
                       policy), None

    pos_vec = torch.as_tensor(cache_pos, dtype=torch.int64,
                              device=dev).expand(B)
    ar = torch.arange(S, device=dev)
    if use_rope:
        positions = pos_vec[:, None] + ar[None, :]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    packed = "k_codes" in cache
    W = cache["k_codes" if packed else "k"].shape[1]
    slot = pos_vec % W
    wl = (None if cache_write_len is None else
          torch.as_tensor(cache_write_len, dtype=torch.int64,
                          device=dev).expand(B))
    if packed:
        fmt = policy.kv_cache_fmt or "mxsf"
        for nm, val in (("k", k), ("v", v)):
            qt = mxblk.quantize(val, fmt, (dh,))
            _write_cache(cache[f"{nm}_codes"], qt.codes, slot, wl)
            _write_cache(cache[f"{nm}_scales"], qt.scale_e8m0, slot, wl)
        if attn_kernel_eligible(cfg, policy) and causal:
            return _attend_packed(q, cache, pos_vec, window, p, cfg,
                                  policy), cache
        k, v = (mxblk.dequantize(QuantizedTensor(
            cache[f"{nm}_codes"], cache[f"{nm}_scales"], fmt, (dh,),
            tuple(cache[f"{nm}_codes"].shape), dtype_name(x.dtype)))
            for nm in ("k", "v"))
    else:
        _write_cache(cache["k"], k.to(cache["k"].dtype), slot, wl)
        _write_cache(cache["v"], v.to(cache["v"].dtype), slot, wl)
        k, v = cache["k"], cache["v"]
    # the last absolute position written this call: all S rows on the
    # slice path, only write_len on the masked-chunk path (a partial
    # chunk's padded tail would push ``end`` past the ring and relabel its
    # earliest columns as future positions)
    end = pos_vec + (S if wl is None else wl) - 1
    idx = torch.arange(W, device=dev)
    # absolute position each ring column holds (unwritten columns < 0);
    # tensor % is floor modulo, as in the JAX package
    kpos = end[:, None] - ((end[:, None] - idx[None, :]) % W)
    qpos = pos_vec[:, None] + ar[None, :]
    return _attend(q, k, v, qpos, kpos, causal, window, p, x, cfg, policy,
                   kv_prequant=packed), cache


ATTN_CHUNK = 1024  # query-chunk target (flash-style; bounds score memory)


def _pick_chunk(S: int) -> int:
    for c in range(min(S, ATTN_CHUNK), 0, -1):
        if S % c == 0:
            return c
    return S


def _scores_block(qg_c, kk, vv, qpos_c, kpos, causal, window, dh, cfg,
                  policy, out_dtype, kv_prequant=False):
    """One query block: (B,kv,g,C,dh) x (B,kv,L,dh) -> (B,kv,g,C,dh).
    ``kv_prequant``: K and V are a dequantized MXSF cache, fed to the
    matmuls as they are (re-quantizing V along L would change it: the
    cache blocks it along dh)."""
    quant_ops = (True, not kv_prequant)
    scores = mx_einsum("bkgsd,bkld->bkgsl", qg_c, kk, policy,
                       axes=(-1, -1), g_axes=(-1, -2), quant_ops=quant_ops)
    scores = scores.float() / math.sqrt(dh)
    if cfg.attn_softcap:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    bias = _attn_mask_bias(qpos_c, kpos, causal=causal, window=window)
    scores = scores + bias[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(out_dtype)
    return mx_einsum("bkgsl,bkld->bkgsd", probs, vv, policy,
                     axes=(-1, -2), g_axes=(-1, -2), quant_ops=quant_ops)


def _attend(q, k, v, qpos, kpos, causal, window, p, x, cfg: ModelConfig,
            policy: QuantPolicy, kv_prequant: bool = False):
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
    if S <= chunk or qpos is None:  # cross-attention: one block
        ctx = _scores_block(qg, kk, vv, qpos, kpos, causal, window, dh, cfg,
                            policy, x.dtype, kv_prequant)
    else:
        parts = []
        for c0 in range(0, S, chunk):
            parts.append(ckpt.checkpoint(
                _scores_block, qg[:, :, :, c0:c0 + chunk], kk, vv,
                qpos[:, c0:c0 + chunk], kpos, causal, window, dh, cfg,
                policy, x.dtype, kv_prequant, use_reentrant=False))
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


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort; ``torch.topk`` promises no tie order,
    and dead padded experts tie at probability 0)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _row_dispatch(x, topi, topv, E: int, C: int):
    """Dispatch each row of tokens into (E, C, d) expert buffers: the JAX
    package's ``_row_dispatch`` over every row at once.

    x: (R, S, d); topi/topv: (R, S, k).  Returns (xe (R, E, C, d), slot,
    valid, st, sw), each (R, S*k) in expert order: a token's assignment
    past its expert's capacity C goes to the dummy row E*C, which is
    written (several times) and never read."""
    R, S, k = topi.shape
    dev = x.device
    flat_e = topi.reshape(R, S * k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    se = torch.gather(flat_e, 1, order)
    st = torch.arange(S, device=dev).repeat_interleave(k)[order]
    sw = torch.gather(topv.reshape(R, S * k), 1, order)
    first = torch.searchsorted(se.contiguous(), se.contiguous(), side="left")
    pos_in_e = torch.arange(S * k, device=dev) - first
    valid = pos_in_e < C
    slot = torch.where(valid, se * C + pos_in_e, E * C)
    rows = torch.arange(R, device=dev)[:, None].expand(R, S * k)
    buf = x.new_zeros((R, E * C + 1, x.shape[-1]))
    buf = buf.index_put((rows, slot), x[rows, st])
    return buf[:, :E * C].reshape(R, E, C, x.shape[-1]), slot, valid, st, sw


def _combine(ye, slot, valid, st, sw, S: int, k: int):
    """Back to tokens: each token's k weighted expert outputs summed in
    the dispatch's (expert) order, one addition at a time from zero -- the
    order of XLA's scatter-add on the CPU, and the same bits on every run
    (``index_add_`` would add in the card's atomic order)."""
    R, E, C, d = ye.shape
    flat = torch.cat([ye.reshape(R, E * C, d), ye.new_zeros((R, 1, d))], 1)
    rows = torch.arange(R, device=ye.device)[:, None]
    w = torch.where(valid, sw, torch.zeros((), dtype=sw.dtype,
                                           device=sw.device))
    contrib = flat[rows, slot] * w[..., None]
    # each token's k entries, in dispatch order (a stable sort by token)
    per_tok = torch.sort(st, dim=-1, stable=True).indices.reshape(R, S, k)
    ordered = contrib[rows[:, :, None], per_tok]  # (R, S, k, d)
    y = ye.new_zeros((R, S, d))
    for j in range(k):
        y = y + ordered[:, :, j]
    return y


def moe(p, x, cfg: ModelConfig, policy: QuantPolicy):
    """x: (B, S, d) -> (B, S, d).  Row = sequence (decode regroups the
    batch into one row upstream)."""
    B, S, d = x.shape
    E, k = cfg.padded_experts, cfg.top_k
    C = max(1, int(math.ceil(S * k * cfg.capacity_factor / cfg.n_experts)))
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    if E != cfg.n_experts:  # mask padded (dead) experts out of routing
        dead = torch.arange(E, device=x.device) >= cfg.n_experts
        logits = logits + torch.where(dead, -1e30, 0.0)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(probs, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    xe, slot, valid, st, sw = _row_dispatch(x, topi, topv, E, C)
    act = Fn.silu if cfg.mlp != "gelu" else \
        (lambda v: Fn.gelu(v, approximate="tanh"))
    # one expert stack cast to the activation dtype at a time (each cast
    # is a full copy of the stack)
    gate = act(mx_einsum("becd,edf->becf", xe, p["we_g"].to(xe.dtype),
                         policy, axes=(-1, -2), g_axes=(-1, -2)))
    up = mx_einsum("becd,edf->becf", xe, p["we_u"].to(xe.dtype), policy,
                   axes=(-1, -2), g_axes=(-1, -2))
    ye = mx_einsum("becf,efd->becd", gate * up, p["we_d"].to(xe.dtype),
                   policy, axes=(-1, -2), g_axes=(-1, -2))
    y = _combine(ye, slot, valid, st, sw.to(x.dtype), S, k)
    if "shared" in p:
        y = y + mlp(p["shared"], x, cfg, policy)
    return y


def moe_aux_loss(x, p, cfg: ModelConfig):
    """Switch-style load-balancing loss (fraction * probability per
    expert)."""
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = torch.mean(Fn.one_hot(top1, cfg.padded_experts).float(),
                      dim=(0, 1))
    pmean = torch.mean(probs, dim=(0, 1))
    return cfg.n_experts * torch.sum(frac * pmean)
