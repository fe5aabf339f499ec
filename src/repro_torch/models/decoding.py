"""KV/SSM-state caches, whole-prompt and chunked prefill, and decode.

PyTorch counterpart of the JAX package's ``models/decoding.py``.
``prefill`` runs a whole prompt from position 0 (every family; an
encoder-decoder's encodes the frames and precomputes the cross K/V),
``prefill_step`` one C-token chunk at per-slot positions with masked cache
writes (decoders only: a recurrent state advances per token, as in the JAX
package), ``decode_step`` one token.  The decoder's three share
``_decoder_layers``, a Python loop over layers (the JAX package scans).

Cache layouts (the JAX ones):
  * decoder : stacked (n_super, moe_every, B, W, ...): a value cache
    ``k``/``v`` (..., W, kv, dh) in the cache's dtype, or a packed MXSF
    cache ``k_codes``/``v_codes`` (..., W, kv, dh) uint8 with
    ``k_scales``/``v_scales`` (..., W, kv, 1) uint8.  W is the SWA window
    for an all-SWA config with ``ring=True`` (a ring: position p sits in
    column p % W), else the full length (a VLM's prefix included);
  * ssm     : ``state`` (L, B, G, H/G, P, N) f32 and ``conv`` (L, B, K-1,
    C), f32 when zeroed and the projection's dtype after ``prefill``;
  * hybrid  : ``groups`` (G, per, ...) and ``tail`` (tail, ...) SSM caches
    plus ``attn``, one attention cache (G, B, W, ...) per application of
    the shared block;
  * encdec  : ``self`` (n_layers, B, W, ...), the cross K/V ``cross``
    (n_layers, B, enc_seq, kv, dh) (bf16 after ``prefill``) and
    ``cross_ready``.
Where the JAX package returns a new cache, these functions update the
given cache in place and return it: attention columns and decode states
are written into the tensors, while ``prefill`` replaces the SSM and cross
entries of the dict with the new tensors (whose dtypes it sets).

Under a serving mesh context (``sharding.mesh_context``, as the engine's
``Placement`` runs a dispatch) every family takes the vocab-parallel
token lookup (``transformer.embed_tokens``) and its layers' tensor
parallelism (``blocks``, ``ssd``); the cache holds this rank's slices
(``prefill`` writes the new SSM and cross entries as those slices).  An
encoder-decoder's cross K/V are column-parallel plain matmuls of the
values by kv heads, and stay unquantized as in the JAX package.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core import sharding as shd
from ..core.blocking import QuantizedTensor, torch_dtype
from ..core.policy import QuantPolicy
from ..device import resolve_device
from . import blocks as blk
from . import ssd
from .transformer import (NO_WINDOW, _apply_sublayer, embed_tokens, encode,
                          hybrid_split, is_moe_sublayer, layer_windows,
                          lm_head)

__all__ = ["init_cache", "decode_step", "prefill_step", "prefill",
           "kv_cache_rows", "layer_params"]


def kv_cache_rows(cache):
    """One layer's packed KV cache in the flash-kernel *row* layout:
    codes (B*kv, W, dh), scales (B*kv, W), rows batch-major.  The serving
    path does not call this (the kernel reads the cache layout in place);
    it is for tests and offline tools.
    Returns ``(k_codes, k_scales, v_codes, v_scales)``."""
    kc = cache["k_codes"]
    B, W, kv, dh = kc.shape

    def rows(c):
        return c.permute(0, 2, 1, 3).reshape(B * kv, W, dh)

    def srows(s):
        return s[..., 0].permute(0, 2, 1).reshape(B * kv, W)

    return (rows(kc), srows(cache["k_scales"]),
            rows(cache["v_codes"]), srows(cache["v_scales"]))


def _attn_cache(cfg: ModelConfig, lead, batch, W, dtype, kv_fmt, device):
    shape = (*lead, batch, W, cfg.n_kv, cfg.head_dim)
    if kv_fmt:  # 8-bit MX-packed: 1 B codes + 1 B E8M0 scale per head row
        z = lambda s: torch.zeros(s, dtype=torch.uint8, device=device)
        sshape = (*lead, batch, W, cfg.n_kv, 1)
        return {"k_codes": z(shape), "k_scales": z(sshape),
                "v_codes": z(shape), "v_scales": z(sshape)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cache_window(cfg: ModelConfig, max_len: int) -> int:
    if cfg.swa_pattern == "all" and cfg.swa_window:
        return min(cfg.swa_window, max_len)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, ring: bool = True, kv_fmt: str = "",
               device=None):
    """Zeroed decode cache of any family but the encoder (layouts in the
    module docstring): attention columns in ``dtype`` (a torch dtype or
    its name), or packed when ``kv_fmt`` names an MX format (``"mxsf"``;
    an encoder-decoder's cross cache stays values).  ``ring=True`` shrinks
    an all-SWA decoder's cache to its window (a ring; decode and
    window-aligned chunks); ``ring=False`` keeps the full ``max_len``.  On
    ``device`` (``None``: the card; CPU callers pass ``device="cpu"``)."""
    dtype, device = torch_dtype(dtype), resolve_device(device)
    if cfg.family == "decoder":
        full = max_len + cfg.frontend_tokens
        W = _cache_window(cfg, full) if ring else full
        return _attn_cache(cfg, (cfg.n_layers // cfg.moe_every,
                                 cfg.moe_every), batch, W, dtype, kv_fmt,
                           device)
    if cfg.family == "ssm":
        return ssd.ssd_init_cache(cfg, batch, (cfg.n_layers,), device)
    if cfg.family == "hybrid":
        G, per, tail = hybrid_split(cfg)
        cache = {"groups": ssd.ssd_init_cache(cfg, batch, (G, per), device),
                 "attn": _attn_cache(cfg, (G,), batch, max_len, dtype,
                                     kv_fmt, device)}
        if tail:
            cache["tail"] = ssd.ssd_init_cache(cfg, batch, (tail,), device)
        return cache
    if cfg.family == "encdec":
        lead = (cfg.n_layers,)
        return {"self": _attn_cache(cfg, lead, batch, max_len, dtype, kv_fmt,
                                    device),
                "cross": _attn_cache(cfg, lead, batch, cfg.enc_seq, dtype, "",
                                     device),
                "cross_ready": torch.zeros((), dtype=torch.int32,
                                           device=device)}
    raise ValueError(f"family {cfg.family} has no decode step")


def _at(cache: dict, *idx):
    """The cache entries of one layer (views: writes land in the stack)."""
    return {k: v[idx] for k, v in cache.items()}


def layer_params(tree, i: int):
    """Slice layer ``i`` out of a stacked tree (values or packed leaves)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(tree.codes[i], tree.scale_e8m0[i], tree.fmt,
                               tree.block, tuple(tree.shape[1:]), tree.dtype)
    return tree[i]


def _decoder_layers(params, x, cache, pos, cfg: ModelConfig,
                    policy: QuantPolicy, write_len=None):
    """Every sublayer over the cache (columns from ``pos``, scalar or
    (B,)), then the head: the full per-position logits (B, S, vocab)."""
    n_super = cfg.n_layers // cfg.moe_every
    windows = layer_windows(cfg, cfg.n_layers)
    for i in range(n_super):
        lp = layer_params(params["layers"], i)
        for j in range(cfg.moe_every):
            x = _apply_sublayer(lp[f"sub{j}"], x, cfg, policy,
                                window=windows[i * cfg.moe_every + j],
                                is_moe=is_moe_sublayer(cfg, j),
                                cache=_at(cache, i, j), cache_pos=pos,
                                cache_write_len=write_len)
    return _mask_pad(lm_head(params, x, cfg, policy), cfg)


def _decoder_forward(params, tokens, cache, pos, cfg: ModelConfig,
                     policy: QuantPolicy, write_len=None):
    """Cached decoder forward over an S-token slice; returns the full
    per-position logits (B, S, vocab) and the (in-place updated) cache."""
    x = embed_tokens(params, tokens, cfg)
    pos_eff = pos + cfg.frontend_tokens  # a VLM prefix holds 0..T-1
    return _decoder_layers(params, x, cache, pos_eff, cfg, policy,
                           write_len), cache


def _ssm_step(lp, x, c, cfg: ModelConfig, policy: QuantPolicy):
    y, _ = ssd.ssd_decode_step(lp["ssd"], blk.rmsnorm(lp["ln"], x), c, cfg,
                               policy)
    return x + y


def _shared_block(params, x, cache, pos, cfg: ModelConfig,
                  policy: QuantPolicy):
    """A hybrid's shared attention sublayer over one application's cache
    (columns from ``pos``; no VLM offset, no window)."""
    return _apply_sublayer(params["shared"], x, cfg, policy,
                           window=NO_WINDOW, cache=cache, cache_pos=pos)


@torch.no_grad()
def decode_step(params, tokens, cache, pos, cfg: ModelConfig,
                policy: QuantPolicy):
    """One token step.  tokens: (B, 1); pos: scalar or (B,) positions.
    Returns (logits (B, vocab), cache)."""
    if cfg.family == "decoder":
        logits, cache = _decoder_forward(params, tokens, cache, pos, cfg,
                                         policy)
        return logits[:, 0], cache
    if cfg.family == "encdec":
        return _decode_encdec(params, tokens, cache, pos, cfg, policy)
    x = embed_tokens(params, tokens, cfg)
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = _ssm_step(layer_params(params["layers"], i), x,
                          _at(cache, i), cfg, policy)
    elif cfg.family == "hybrid":
        x = _decode_hybrid(params, x, cache, pos, cfg, policy)
    else:
        raise ValueError(cfg.family)
    logits = _mask_pad(lm_head(params, x, cfg, policy), cfg)
    return logits[:, 0], cache


def _decode_hybrid(params, x, cache, pos, cfg: ModelConfig,
                   policy: QuantPolicy):
    G, per, tail = hybrid_split(cfg)
    for g in range(G):
        glp = layer_params(params["layers"], g)
        for j in range(per):
            x = _ssm_step(layer_params(glp, j), x, _at(cache["groups"], g, j),
                          cfg, policy)
        x = _shared_block(params, x, _at(cache["attn"], g), pos, cfg, policy)
    for i in range(tail):
        x = _ssm_step(layer_params(params["tail"], i), x,
                      _at(cache["tail"], i), cfg, policy)
    return x


def dynamic_sinusoid(pos: torch.Tensor, d: int):
    """Sinusoidal positions of per-slot positions ``pos`` (B,): (B, 1, d)
    f32 (the JAX package's ``_dynamic_sinusoid``, vmapped)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos.float()[:, None] / (10_000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, None, :]


def _decode_encdec(params, tokens, cache, pos, cfg: ModelConfig,
                   policy: QuantPolicy):
    """One decoder token of an encoder-decoder: sinusoidal position, self-
    attention over ``cache["self"]``, cross-attention over the precomputed
    ``cache["cross"]`` (in values), the MLP."""
    x = embed_tokens(params, tokens, cfg)
    pv = torch.as_tensor(pos, dtype=torch.int64,
                         device=x.device).expand(x.shape[0])
    x = x + dynamic_sinusoid(pv, cfg.d_model).to(x.dtype)
    for i in range(cfg.n_layers):
        lp = layer_params(params["dec_layers"], i)
        h = blk.rmsnorm(lp["ln1"], x)
        a, _ = blk.attention(lp["self"], h, cfg, policy,
                             cache=_at(cache["self"], i), cache_pos=pv)
        x = x + a
        h = blk.rmsnorm(lp["ln2"], x)
        c, _ = blk.attention(lp["cross"], h, cfg, policy,
                             kv_cached=_at(cache["cross"], i), causal=False,
                             pre="cross/")
        x = x + c
        x = x + blk.mlp(lp["mlp"], blk.rmsnorm(lp["ln3"], x), cfg, policy)
    logits = _mask_pad(lm_head(params, x, cfg, policy), cfg)
    return logits[:, 0], cache


@torch.no_grad()
def prefill_step(params, tokens, cache, pos, n_valid, cfg: ModelConfig,
                 policy: QuantPolicy):
    """One C-token prompt chunk in one dispatch (decoders only: an SSM or
    hybrid state advances per token, as in the JAX package).

    tokens (B, C); pos scalar or (B,) start positions; n_valid (B,) valid
    tokens per slot in [0, C] -- 0 masks the slot out (its cache stays
    bit-identical, its logits row is garbage the caller ignores).  On a
    ring cache a chunk must not straddle the ring's end (window-aligned
    chunks), as in the JAX package.
    Returns (logits (B, vocab) at each slot's last valid token, cache)."""
    if cfg.family != "decoder":
        raise NotImplementedError(
            "chunked prefill needs attention caches; SSM/hybrid recurrent "
            "state advances per token (see ROADMAP: per-slot state "
            "checkpointing)")
    B, C = tokens.shape
    nv = torch.as_tensor(n_valid, dtype=torch.int64,
                         device=tokens.device).expand(B)
    logits, cache = _decoder_forward(params, tokens, cache, pos, cfg, policy,
                                     write_len=nv)
    last = torch.clamp(nv - 1, 0, C - 1)
    return logits[torch.arange(B, device=tokens.device), last], cache


def _ssm_prefill(stack, x, n: int, cfg: ModelConfig, policy: QuantPolicy):
    """``n`` stacked SSM layers over the whole prompt: (x, their new
    caches stacked (n, ...))."""
    states, tails = [], []
    for i in range(n):
        lp = layer_params(stack, i)
        y, c = ssd.ssd_forward(lp["ssd"], blk.rmsnorm(lp["ln"], x), cfg,
                               policy, return_state=True)
        x = x + y
        states.append(c["state"])
        tails.append(c["conv"])
    return x, {"state": torch.stack(states), "conv": torch.stack(tails)}


@torch.no_grad()
def prefill(params, batch, cache, cfg: ModelConfig, policy: QuantPolicy):
    """The whole prompt through the model, filling the cache from position
    0 (lockstep batch; S no wider than the cache; an SSM's or hybrid's S a
    multiple of its SSD chunk when longer).  ``batch``: ``tokens`` (B, S),
    a VLM's ``embeds`` (B, T, d) prefix, an encoder-decoder's ``frames``
    (B, enc_seq, d) alone.  Returns (last-position logits (B, vocab) --
    None for the encoder-decoder, whose first token comes from
    ``decode_step`` -- and the cache)."""
    if cfg.family == "encdec":
        enc = encode(params, batch["frames"], cfg, policy)
        ks, vs = [], []
        col = 1 if blk._split("heads") else None
        ctx = shd.active()
        own = (None, None) if ctx is None else ctx.get("cross_cache",
                                                       (None, None))
        for i in range(cfg.n_layers):
            lp = layer_params(params["dec_layers"], i)["cross"]
            # plain matmuls of the values, as in the JAX package; under a
            # plan that splits the heads, of this rank's kv heads
            for out, name in ((ks, "wk"), (vs, "wv")):
                t = enc @ blk.use(lp, name, col, "cross/" + name).to(
                    enc.dtype)
                t = t.reshape(*t.shape[:2], -1, cfg.head_dim)
                out.append(blk.own_columns(t.to(torch.bfloat16), *own))
        cache["cross"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
        cache["cross_ready"] = torch.ones((), dtype=torch.int32,
                                          device=enc.device)
        return None, cache
    if cfg.family == "decoder":
        x = embed_tokens(params, batch["tokens"], cfg)
        if "embeds" in batch and cfg.frontend_tokens:
            x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
        logits = _decoder_layers(params, x, cache, 0, cfg, policy)
        return logits[:, -1], cache
    x = embed_tokens(params, batch["tokens"], cfg)
    if cfg.family == "ssm":
        x, new = _ssm_prefill(params["layers"], x, cfg.n_layers, cfg, policy)
        cache.update(new)
    elif cfg.family == "hybrid":
        G, per, tail = hybrid_split(cfg)
        groups = []
        for g in range(G):
            x, new = _ssm_prefill(layer_params(params["layers"], g), x, per,
                                  cfg, policy)
            groups.append(new)
            x = _shared_block(params, x, _at(cache["attn"], g), 0, cfg,
                              policy)
        cache["groups"] = {k: torch.stack([c[k] for c in groups])
                           for k in ("state", "conv")}
        if tail:
            x, cache["tail"] = _ssm_prefill(params["tail"], x, tail, cfg,
                                            policy)
    else:
        raise ValueError(cfg.family)
    logits = _mask_pad(lm_head(params, x, cfg, policy), cfg)
    return logits[:, -1], cache


def _mask_pad(logits, cfg):
    if cfg.padded_vocab == cfg.vocab:
        return logits
    dead = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
    return logits + torch.where(dead, -1e30, 0.0)
