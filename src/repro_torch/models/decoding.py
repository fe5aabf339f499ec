"""KV caches, whole-prompt and chunked prefill, and decode for the decoder
family.

PyTorch counterpart of the decoder parts of the JAX package's
``models/decoding.py``.  ``prefill`` runs a whole prompt from position 0,
``prefill_step`` one C-token chunk at per-slot positions with masked cache
writes, ``decode_step`` one token.  All three share ``_decoder_layers``, a
Python loop over layers (the JAX package scans).

Cache layout (the JAX one), stacked (n_super, moe_every, B, W, ...): a
value cache ``k``/``v`` (..., W, kv, dh) in the cache's dtype, or a packed
MXSF cache ``k_codes``/``v_codes`` (..., W, kv, dh) uint8 with
``k_scales``/``v_scales`` (..., W, kv, 1) uint8.  W is the SWA window for
an all-SWA config with ``ring=True`` (a ring: position p sits in column
p % W), else the full length.  Where the JAX package returns a new cache,
these functions write the new columns into the given cache in place and
return it.  Families other than the decoder raise ``NotImplementedError``
naming their ROADMAP.md item.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.blocking import QuantizedTensor, torch_dtype
from ..core.policy import QuantPolicy
from ..device import resolve_device
from .transformer import (_FAMILY_ITEM, _apply_sublayer, embed_tokens,
                          is_moe_sublayer, layer_windows, lm_head)

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


def _check_decoder(cfg: ModelConfig, what: str):
    if cfg.family != "decoder":
        item = _FAMILY_ITEM.get(cfg.family, "4")
        raise NotImplementedError(f"family {cfg.family!r} has no ported "
                                  f"{what}; see ROADMAP.md, Queue 1 item "
                                  f"{item}")


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
    """Zeroed KV cache of a decoder config: values in ``dtype`` (a torch
    dtype or its name), or packed when ``kv_fmt`` names an MX format
    (``"mxsf"``).  ``ring=True`` shrinks an all-SWA cache to its window (a
    ring; decode and window-aligned chunks); ``ring=False`` keeps the full
    ``max_len``.  On ``device`` (``None``: the card; CPU callers pass
    ``device="cpu"``)."""
    _check_decoder(cfg, "cache")
    n_super = cfg.n_layers // cfg.moe_every
    full = max_len + cfg.frontend_tokens
    W = _cache_window(cfg, full) if ring else full
    return _attn_cache(cfg, (n_super, cfg.moe_every), batch, W,
                       torch_dtype(dtype), kv_fmt, resolve_device(device))


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
                                cache={k: v[i, j] for k, v in cache.items()},
                                cache_pos=pos, cache_write_len=write_len)
    return _mask_pad(lm_head(params, x, cfg, policy), cfg)


def _decoder_forward(params, tokens, cache, pos, cfg: ModelConfig,
                     policy: QuantPolicy, write_len=None):
    """Cached decoder forward over an S-token slice; returns the full
    per-position logits (B, S, vocab) and the (in-place updated) cache."""
    x = embed_tokens(params, tokens, cfg)
    pos_eff = pos + cfg.frontend_tokens  # a VLM prefix holds 0..T-1
    return _decoder_layers(params, x, cache, pos_eff, cfg, policy,
                           write_len), cache


@torch.no_grad()
def decode_step(params, tokens, cache, pos, cfg: ModelConfig,
                policy: QuantPolicy):
    """One token step.  tokens: (B, 1); pos: scalar or (B,) positions.
    Returns (logits (B, vocab), cache)."""
    _check_decoder(cfg, "decode step")
    logits, cache = _decoder_forward(params, tokens, cache, pos, cfg, policy)
    return logits[:, 0], cache


@torch.no_grad()
def prefill_step(params, tokens, cache, pos, n_valid, cfg: ModelConfig,
                 policy: QuantPolicy):
    """One C-token prompt chunk in one dispatch.

    tokens (B, C); pos scalar or (B,) start positions; n_valid (B,) valid
    tokens per slot in [0, C] -- 0 masks the slot out (its cache stays
    bit-identical, its logits row is garbage the caller ignores).  On a
    ring cache a chunk must not straddle the ring's end (window-aligned
    chunks), as in the JAX package.
    Returns (logits (B, vocab) at each slot's last valid token, cache)."""
    _check_decoder(cfg, "chunked prefill")
    B, C = tokens.shape
    nv = torch.as_tensor(n_valid, dtype=torch.int64,
                         device=tokens.device).expand(B)
    logits, cache = _decoder_forward(params, tokens, cache, pos, cfg, policy,
                                     write_len=nv)
    last = torch.clamp(nv - 1, 0, C - 1)
    return logits[torch.arange(B, device=tokens.device), last], cache


@torch.no_grad()
def prefill(params, batch, cache, cfg: ModelConfig, policy: QuantPolicy):
    """The whole prompt ``batch["tokens"]`` (B, S) through the model,
    filling the cache from position 0 (lockstep batch; S no wider than the
    cache).  Returns (last-position logits (B, vocab), cache)."""
    _check_decoder(cfg, "whole-prompt prefill")
    if "embeds" in batch and cfg.frontend_tokens:
        raise NotImplementedError("VLM prefix tokens are not ported yet; "
                                  "see ROADMAP.md, Queue 1 item 4c")
    x = embed_tokens(params, batch["tokens"], cfg)
    logits = _decoder_layers(params, x, cache, 0, cfg, policy)
    return logits[:, -1], cache


def _mask_pad(logits, cfg):
    if cfg.padded_vocab == cfg.vocab:
        return logits
    dead = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
    return logits + torch.where(dead, -1e30, 0.0)
