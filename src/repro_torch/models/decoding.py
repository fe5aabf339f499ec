"""Packed KV cache, chunked prefill and decode for the decoder family.

PyTorch counterpart of the decoder parts of the JAX package's
``models/decoding.py``.  ``prefill_step`` runs one C-token chunk at per-slot
positions with masked cache writes; ``decode_step`` runs one token.  Both
share ``_decoder_forward``, a Python loop over layers (the JAX package
scans).

Cache layout (the JAX one): ``k_codes``/``v_codes`` (n_super, moe_every,
B, W, kv, dh) uint8 and ``k_scales``/``v_scales`` (n_super, moe_every, B,
W, kv, 1) uint8.  Where the JAX package returns a new cache, these
functions write the new columns into the given cache in place and return
it.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.blocking import QuantizedTensor
from ..core.policy import QuantPolicy
from ..device import resolve_device
from .transformer import (_apply_sublayer, embed_tokens, layer_windows,
                          lm_head)

__all__ = ["init_cache", "decode_step", "prefill_step", "kv_cache_rows",
           "layer_params"]


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


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               kv_fmt: str = "mxsf"):
    """Zeroed packed MXSF KV cache for a decoder config (the full
    ``max_len`` width: the ring-shrunk all-SWA cache is not ported), on
    ``device`` (``None``: the card; CPU callers pass ``device="cpu"``)."""
    if cfg.family != "decoder":
        raise NotImplementedError(f"family {cfg.family!r} has no ported "
                                  "cache; see ROADMAP.md, Queue 1 item 9")
    if kv_fmt != "mxsf":
        raise NotImplementedError("only the packed MXSF KV cache is ported; "
                                  "see ROADMAP.md, Deferred item 3")
    lead = (cfg.n_layers // cfg.moe_every, cfg.moe_every, batch,
            max_len + cfg.frontend_tokens, cfg.n_kv)
    codes = lead + (cfg.head_dim,)
    scales = lead + (1,)
    device = resolve_device(device)
    z = lambda shape: torch.zeros(shape, dtype=torch.uint8, device=device)
    return {"k_codes": z(codes), "k_scales": z(scales),
            "v_codes": z(codes), "v_scales": z(scales)}


def layer_params(tree, i: int):
    """Slice layer ``i`` out of a stacked tree (values or packed leaves)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(tree.codes[i], tree.scale_e8m0[i], tree.fmt,
                               tree.block, tuple(tree.shape[1:]), tree.dtype)
    return tree[i]


def _decoder_forward(params, tokens, cache, pos, cfg: ModelConfig,
                     policy: QuantPolicy, write_len=None):
    """Cached decoder forward over an S-token slice; returns the full
    per-position logits (B, S, vocab) and the (in-place updated) cache."""
    x = embed_tokens(params, tokens, cfg)
    pos_eff = pos + cfg.frontend_tokens
    n_super = cfg.n_layers // cfg.moe_every
    windows = layer_windows(cfg, cfg.n_layers)
    for i in range(n_super):
        lp = layer_params(params["layers"], i)
        for j in range(cfg.moe_every):
            x = _apply_sublayer(lp[f"sub{j}"], x, cfg, policy,
                                window=windows[i * cfg.moe_every + j],
                                cache={k: v[i, j] for k, v in cache.items()},
                                cache_pos=pos_eff, cache_write_len=write_len)
    return _mask_pad(lm_head(params, x, cfg, policy), cfg), cache


@torch.no_grad()
def decode_step(params, tokens, cache, pos, cfg: ModelConfig,
                policy: QuantPolicy):
    """One token step.  tokens: (B, 1); pos: scalar or (B,) positions.
    Returns (logits (B, vocab), cache)."""
    logits, cache = _decoder_forward(params, tokens, cache, pos, cfg, policy)
    return logits[:, 0], cache


@torch.no_grad()
def prefill_step(params, tokens, cache, pos, n_valid, cfg: ModelConfig,
                 policy: QuantPolicy):
    """One C-token prompt chunk in one dispatch.

    tokens (B, C); pos scalar or (B,) start positions; n_valid (B,) valid
    tokens per slot in [0, C] -- 0 masks the slot out (its cache stays
    bit-identical, its logits row is garbage the caller ignores).
    Returns (logits (B, vocab) at each slot's last valid token, cache)."""
    B, C = tokens.shape
    nv = torch.as_tensor(n_valid, dtype=torch.int64,
                         device=tokens.device).expand(B)
    logits, cache = _decoder_forward(params, tokens, cache, pos, cfg, policy,
                                     write_len=nv)
    last = torch.clamp(nv - 1, 0, C - 1)
    return logits[torch.arange(B, device=tokens.device), last], cache


def _mask_pad(logits, cfg):
    if cfg.padded_vocab == cfg.vocab:
        return logits
    dead = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
    return logits + torch.where(dead, -1e30, 0.0)
