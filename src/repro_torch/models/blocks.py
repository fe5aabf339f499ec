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

Tensor parallelism (inside the serving engine's ``sharding.mesh_context``
with a ``TPPlan``): each rank holds its slices of the store, and ``use``
brings a leaf to the layout the scheme computes with (gathering what the
stored spec splits otherwise).  wq/wk/wv (and biases), wg/wu and the head
are column-parallel; wo and wd row-parallel, each followed by one f32
all-reduce over the model axis; head counts come from the local shapes.
Expert parallelism: an MoE layer routes and dispatches whole on every
rank, each rank runs its own experts, and their outputs are gathered
before the combine; the shared expert splits as a dense FFN does.
Where the cache's position axis is sharded (sequence parallelism) each
rank writes the columns it owns and gathers the cache at use.  Outside a
context all of this is a no-op.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as Fn
import torch.utils.checkpoint as ckpt

from ..configs.base import ModelConfig
from ..core import blocking as mxblk
from ..core import sharding as shd
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


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

class TPPlan(NamedTuple):
    """Which parts of a decoder split over the model axis: ``heads`` the
    query and kv heads together (wq/wk/wv and biases by columns, wo by
    rows; the attention kernel reads whole kv heads of its query heads, so
    the query heads never split without theirs), ``mlp`` a dense FFN's
    d_ff (wg/wu columns, wd rows), ``vocab`` the embedding rows and head
    columns, ``experts`` the MoE expert dim (each rank runs its own
    experts), ``shared`` the MoE shared expert's width as ``mlp`` splits
    d_ff.  A part that cannot split whole heads, whole MX blocks or whole
    activation blocks runs replicated; the expert dim always splits, as
    GSPMD splits it, unevenly too."""
    heads: bool
    mlp: bool
    vocab: bool
    experts: bool = False
    shared: bool = False


def _block(w, dim: int) -> int:
    return w.block[dim] if isinstance(w, QuantizedTensor) else 1


def tp_plan(cfg: ModelConfig, policy: QuantPolicy, layer, top,
            tp_size: int) -> TPPlan:
    """The plan of one decoder super-layer's leaves ``layer`` (``sub{j}``:
    attn, ffn; a dense FFN and an MoE one wherever they sit) and the
    top-level ``top`` (emb, head) at ``tp_size``.  A row-parallel input is
    quantized along K in the policy's blocks, so its local K must hold
    whole blocks: then its codes equal the one-device codes."""
    xk = (policy.block_1d if policy.block_mode == "1d" else
          policy.tile if policy.block_mode == "2d" else 1)

    def cols(w, n):
        return n % tp_size == 0 and (n // tp_size) % _block(w, -1) == 0

    def rows(w, n):
        local = n // tp_size
        return (n % tp_size == 0 and local % _block(w, 0) == 0
                and local % xk == 0)

    def ffn_splits(f, width):
        return f is not None and cols(f["wu"], width) and \
            rows(f["wd"], width)

    subs = [layer[k] for k in sorted(layer)]
    ffns = [s["ffn"] for s in subs]
    dense = next((f for f in ffns if "router" not in f), None)
    moe_ffn = next((f for f in ffns if "router" in f), None)
    dh, a = cfg.head_dim, subs[0]["attn"]
    heads = (cfg.n_heads % tp_size == 0 and cfg.n_kv % tp_size == 0
             and cols(a["wq"], cfg.n_heads * dh)
             and rows(a["wo"], cfg.n_heads * dh)
             and cols(a["wk"], cfg.n_kv * dh))
    head = top.get("head")
    vocab = cfg.padded_vocab % tp_size == 0 and (
        head is None or cols(head, cfg.padded_vocab))
    shared = moe_ffn is not None and ffn_splits(
        moe_ffn.get("shared"), cfg.expert_ff * cfg.n_shared_experts)
    return TPPlan(heads, ffn_splits(dense, cfg.d_ff), vocab,
                  moe_ffn is not None and tp_size > 1, shared)


def plan():
    """The active TP plan (None outside an engine's mesh context)."""
    ctx = shd.active()
    return None if ctx is None else ctx.get("plan")


def use(p, name, split=None, key=None):
    """Leaf ``p[name]`` in the compute layout of the active mesh context
    (``sharding.to_compute``: ``split`` the dim kept split over the model
    axis); the leaf itself outside one.  ``key``: the name the context
    files the leaf's spec under, where it is not ``name`` (the MoE shared
    expert's ``shared/wg``...)."""
    ctx = shd.active()
    leaf, key = p[name], key or name
    if ctx is None or key not in ctx.get("specs", {}):
        return leaf
    spec, shape = ctx["specs"][key]
    return shd.to_compute(leaf, spec, shape, split)


def _row_parallel(x, p, name, split: bool, policy, key=None):
    """``dense`` of a row-parallel linear: the local K slice's f32 partial
    sums, all-reduced over the model axis, cast once (as ``dense`` casts
    one device's sums).  Replicated (``split`` False) or outside a
    context: ``dense``."""
    w = use(p, name, 0 if split else None, key)
    if not split:
        return dense(x, w, policy)
    if isinstance(w, QuantizedTensor):
        out = torch.promote_types(x.dtype, mxblk.torch_dtype(w.dtype))
    else:
        w, out = w.to(x.dtype), x.dtype
    return shd.all_reduce(mx_dot(x, w, policy, f32_out=True)).to(out)


def _split(part: str):
    """Whether the active TP plan splits ``part`` (a ``TPPlan`` field)."""
    pl = plan()
    return pl is not None and getattr(pl, part)


def rmsnorm(p, x, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * use(p, "w")).to(x.dtype)


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
    sequence cannot shift a chunk onto live history.  A dropped row writes
    back what its column (taken modulo W, which no kept row of its slot
    reaches) already holds, so the write has a fixed shape: no
    data-dependent index set, no host sync, and a ``meta`` trace passes."""
    Bsz, S = upd.shape[:2]
    W = buf.shape[1]
    bi = torch.arange(Bsz, device=buf.device)[:, None]
    if write_len is None:
        ar = torch.arange(S, device=buf.device)
        start = torch.clamp(slot, max=W - S)
        buf[bi, start[:, None] + ar[None, :]] = upd
        return
    S = min(S, W)  # rows past W never land
    upd = upd[:, :S]
    ar = torch.arange(S, device=buf.device)
    cols = slot[:, None] + ar[None, :]
    keep = (ar[None, :] < write_len[:, None]) & (cols < W)
    cols = cols % W
    keep = keep.reshape(keep.shape + (1,) * (upd.ndim - 2))
    buf[bi, cols] = torch.where(keep, upd, buf[bi, cols])


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
    dh = cfg.head_dim
    dev = x.device
    hc = 1 if _split("heads") else None  # the column dim kept split
    hb = None if hc is None else 0

    q = dense(x, use(p, "wq", hc), policy)
    if "bq" in p:
        q = (q + use(p, "bq", hb)).to(x.dtype)
    q = _split_heads(q, q.shape[-1] // dh, dh)  # the local heads
    if kv_cached is not None:
        k, v = (kv_cached[n].to(x.dtype) for n in ("k", "v"))
        kpos = torch.zeros((B, k.shape[1]), dtype=torch.int64, device=dev)
        return _attend(q, k, v, None, kpos, False, None, p, x, cfg,
                       policy), None
    src = x if kv_x is None else kv_x
    k = dense(src, use(p, "wk", hc), policy)
    v = dense(src, use(p, "wv", hc), policy)
    if "bk" in p:
        k = (k + use(p, "bk", hb)).to(x.dtype)
        v = (v + use(p, "bv", hb)).to(x.dtype)
    k = _split_heads(k, k.shape[-1] // dh, dh)
    v = _split_heads(v, v.shape[-1] // dh, dh)
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
    # a mesh context may split the cache where the layer does not: its
    # positions (sequence parallelism, ``cache_sp``) or its kv heads while
    # the layer computes every kv head (``cache_heads``); each is
    # (axes, this rank's first column or head, shard count).  Each rank
    # writes what it holds and gathers the whole cache at use.
    ctx = shd.active()
    sp = None if ctx is None else ctx.get("cache_sp")
    ch = None if ctx is None else ctx.get("cache_heads")
    W = cache["k_codes" if packed else "k"].shape[1] * (sp[2] if sp else 1)
    slot = pos_vec % W
    wl = (None if cache_write_len is None else
          torch.as_tensor(cache_write_len, dtype=torch.int64,
                          device=dev).expand(B))
    if ch is not None:
        n = cache["k_codes" if packed else "k"].shape[2]
        k_w, v_w = k[:, :, ch[1]:ch[1] + n], v[:, :, ch[1]:ch[1] + n]
    else:
        k_w, v_w = k, v
    write = (_write_cache if sp is None else
             lambda buf, upd, sl, n: _write_owned(buf, upd, sl, n, W, sp[1]))

    def gathered():
        out = cache
        if sp is not None:
            out = {nm: shd.all_gather(t, sp[0], 1) for nm, t in out.items()}
        if ch is not None:
            out = {nm: shd.all_gather(t, ch[0], 2) for nm, t in out.items()}
        return out

    if packed:
        fmt = policy.kv_cache_fmt or "mxsf"
        for nm, val in (("k", k_w), ("v", v_w)):
            qt = mxblk.quantize(val, fmt, (dh,))
            write(cache[f"{nm}_codes"], qt.codes, slot, wl)
            write(cache[f"{nm}_scales"], qt.scale_e8m0, slot, wl)
        seen = gathered()
        if attn_kernel_eligible(cfg, policy) and causal:
            return _attend_packed(q, seen, pos_vec, window, p, cfg,
                                  policy), cache
        k, v = (mxblk.dequantize(QuantizedTensor(
            seen[f"{nm}_codes"], seen[f"{nm}_scales"], fmt, (dh,),
            tuple(seen[f"{nm}_codes"].shape), dtype_name(x.dtype)))
            for nm in ("k", "v"))
    else:
        write(cache["k"], k_w.to(cache["k"].dtype), slot, wl)
        write(cache["v"], v_w.to(cache["v"].dtype), slot, wl)
        seen = gathered()
        k, v = seen["k"], seen["v"]
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


def _write_owned(buf, upd, slot, write_len, W: int, lo: int):
    """``_write_cache`` into this rank's columns lo..lo+Wl-1 of a
    position-sharded cache of W columns: rows whose column another rank
    owns are dropped here (that rank writes them).  A dropped row writes
    back what its local column (taken modulo Wl) holds; S <= Wl keeps the
    S columns distinct modulo Wl, so no two rows meet."""
    Bsz, S = upd.shape[:2]
    Wl = buf.shape[1]
    if S > Wl:
        raise ValueError(f"a {S}-row write spans more than the {Wl} columns "
                         "a rank holds; use a narrower prefill chunk")
    bi = torch.arange(Bsz, device=buf.device)[:, None]
    ar = torch.arange(S, device=buf.device)
    if write_len is None:
        cols = torch.clamp(slot, max=W - S)[:, None] + ar[None, :]
        keep = torch.ones_like(cols, dtype=torch.bool)
    else:
        cols = slot[:, None] + ar[None, :]
        keep = (ar[None, :] < write_len[:, None]) & (cols < W)
    keep = keep & (cols >= lo) & (cols < lo + Wl)
    local = (cols - lo) % Wl
    keep = keep.reshape(keep.shape + (1,) * (upd.ndim - 2))
    buf[bi, local] = torch.where(keep, upd, buf[bi, local])


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
    return _row_parallel(ctx, p, "wo", _split("heads"), policy)


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
    return _row_parallel(ctx, p, "wo", _split("heads"), policy)


def mlp(p, x, cfg: ModelConfig, policy: QuantPolicy, part: str = "mlp"):
    """The FFN; ``part`` the ``TPPlan`` field that splits it: ``"mlp"`` a
    dense FFN, ``"shared"`` an MoE layer's shared expert (its leaves'
    specs filed as ``shared/<name>``)."""
    split = _split(part)
    col = 1 if split else None
    pre = "" if part == "mlp" else part + "/"
    if cfg.mlp in ("swiglu", "geglu"):
        act = Fn.silu if cfg.mlp == "swiglu" else \
            (lambda v: Fn.gelu(v, approximate="tanh"))
        gate = act(dense(x, use(p, "wg", col, pre + "wg"), policy))
        hdn = gate * dense(x, use(p, "wu", col, pre + "wu"), policy)
    else:
        hdn = Fn.gelu(dense(x, use(p, "wu", col, pre + "wu"), policy),
                      approximate="tanh")
    return _row_parallel(hdn, p, "wd", split, policy, pre + "wd")


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


def _expert_ffn(p, xe, cfg: ModelConfig, policy: QuantPolicy):
    """The expert FFNs on the dispatched rows xe (R, E, C, d) -> ye (R, E,
    C, d).  Under a plan that splits the experts each rank runs its own
    c = ceil(E / ranks) of them (zero rows past the end: never routed, and
    zero out) and ye is gathered over the model axis along the expert dim:
    whole expert outputs move, so the combine sees one device's rows."""
    split = _split("experts")
    wg, wu, wd = (use(p, n, 0 if split else None)
                  for n in ("we_g", "we_u", "we_d"))
    R, E = xe.shape[:2]
    if split:
        ctx = shd.active()
        c = wg.shape[0]
        lo = min(ctx["mesh"].coord(ctx["tp"]) * c, E)
        xe = xe[:, lo:lo + c]
        if xe.shape[1] < c:
            xe = torch.cat([xe, xe.new_zeros((R, c - xe.shape[1]) +
                                             tuple(xe.shape[2:]))], 1)
    act = Fn.silu if cfg.mlp != "gelu" else \
        (lambda v: Fn.gelu(v, approximate="tanh"))
    # one expert stack cast to the activation dtype at a time (each cast
    # is a full copy of the stack)
    gate = act(mx_einsum("becd,edf->becf", xe, wg.to(xe.dtype), policy,
                         axes=(-1, -2), g_axes=(-1, -2)))
    up = mx_einsum("becd,edf->becf", xe, wu.to(xe.dtype), policy,
                   axes=(-1, -2), g_axes=(-1, -2))
    ye = mx_einsum("becf,efd->becd", gate * up, wd.to(xe.dtype), policy,
                   axes=(-1, -2), g_axes=(-1, -2))
    if split:
        ye = shd.all_gather(ye, ctx["tp"], 1)[:, :E]
    return ye


def moe(p, x, cfg: ModelConfig, policy: QuantPolicy):
    """x: (B, S, d) -> (B, S, d).  Row = sequence (decode regroups the
    batch into one row upstream).  Under a mesh context the router, the
    routing and the dispatch run whole on every rank, on the same input,
    so every rank's slots are one device's; only the expert FFNs split
    (``_expert_ffn``), and the combine runs on the gathered outputs in
    one device's order."""
    B, S, d = x.shape
    E, k = cfg.padded_experts, cfg.top_k
    C = max(1, int(math.ceil(S * k * cfg.capacity_factor / cfg.n_experts)))
    logits = torch.einsum("bsd,de->bse", x.float(), use(p, "router"))
    if E != cfg.n_experts:  # mask padded (dead) experts out of routing
        dead = torch.arange(E, device=x.device) >= cfg.n_experts
        logits = logits + torch.where(dead, -1e30, 0.0)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(probs, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    xe, slot, valid, st, sw = _row_dispatch(x, topi, topv, E, C)
    ye = _expert_ffn(p, xe, cfg, policy)
    y = _combine(ye, slot, valid, st, sw.to(x.dtype), S, k)
    if "shared" in p:
        y = y + mlp(p["shared"], x, cfg, policy, part="shared")
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
