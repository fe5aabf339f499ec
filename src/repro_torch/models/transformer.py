"""Decoder-family parameter tree, embeddings, sublayer, forward, LM head.

PyTorch counterpart of the decoder parts of the JAX package's
``models/transformer.py``: the training forward (``forward_hidden``) and
the pieces the cached decoder (``decoding.py``) shares with it.  The parameter tree has the JAX layout -- layers
stacked on a leading ``(n_super, ...)`` axis with ``sub{j}`` keys per
super-layer -- so ``convert.params_from_numpy`` carries a JAX tree across
leaf for leaf.

``init_params(cfg, generator, device)`` draws the same *distributions* as
the JAX init (normal * 1/sqrt(d_in) for projections, * 0.02 for embedding
and head, zero biases, unit norms), not the same bits.  Every weight is
drawn one layer at a time in a fixed order (``decoder_leaves``), so
``model.init_packed_params`` can draw the same values and pack each one as
it is drawn, without ever holding the f32 tree.
"""
from __future__ import annotations

import math
from typing import Iterator, Tuple

import torch
import torch.utils.checkpoint as ckpt

from ..configs.base import ModelConfig
from ..core.policy import QuantPolicy
from . import blocks as blk

NO_WINDOW = 1 << 30

# (path under the super-layer, per-layer shape, init kind); kind "dense" is
# normal * 1/sqrt(rows), "ones"/"zeros" are constants
_Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str]


def _sublayer_leaves(cfg: ModelConfig) -> Iterator[_Leaf]:
    d, dh, h, kv, f = (cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv,
                       cfg.d_ff)
    yield ("ln1", "w"), (d,), "ones"
    yield ("attn", "wq"), (d, h * dh), "dense"
    yield ("attn", "wk"), (d, kv * dh), "dense"
    yield ("attn", "wv"), (d, kv * dh), "dense"
    yield ("attn", "wo"), (h * dh, d), "dense"
    if cfg.qkv_bias:
        yield ("attn", "bq"), (h * dh,), "zeros"
        yield ("attn", "bk"), (kv * dh,), "zeros"
        yield ("attn", "bv"), (kv * dh,), "zeros"
    yield ("ln2", "w"), (d,), "ones"
    if cfg.mlp in ("swiglu", "geglu"):
        yield ("ffn", "wg"), (d, f), "dense"
    yield ("ffn", "wu"), (d, f), "dense"
    yield ("ffn", "wd"), (f, d), "dense"
    if cfg.post_norms:
        yield ("pn1", "w"), (d,), "ones"
        yield ("pn2", "w"), (d,), "ones"


def _check_dense_decoder(cfg: ModelConfig):
    if cfg.family != "decoder":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet; "
                                  "see ROADMAP.md, Queue 1 item 9")
    if cfg.n_experts > 0:
        raise NotImplementedError("MoE layers are not ported yet; see "
                                  "ROADMAP.md, Queue 1 item 9")


def decoder_leaves(cfg: ModelConfig) -> Iterator[_Leaf]:
    """Per-layer leaves of one super-layer, keyed ``(sub{j}, ...)``."""
    _check_dense_decoder(cfg)
    for j in range(cfg.moe_every):
        for path, shape, kind in _sublayer_leaves(cfg):
            yield (f"sub{j}",) + path, shape, kind


def draw_leaf(shape, kind: str, gen, device) -> torch.Tensor:
    if kind == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return blk.dense_init(gen, shape[0], shape[1], device)


def draw_embedding(cfg: ModelConfig, gen, device) -> torch.Tensor:
    return torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                       device=device, dtype=torch.float32) * 0.02


def draw_head(cfg: ModelConfig, gen, device) -> torch.Tensor:
    return torch.randn((cfg.d_model, cfg.padded_vocab), generator=gen,
                       device=device, dtype=torch.float32) * 0.02


def set_path(tree: dict, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """f32 parameter tree of a decoder config (the JAX layout), on
    ``device`` (``None``: the generator's own device)."""
    if device is None:
        device = generator.device
    params = {"final_norm": {"w": torch.ones(cfg.d_model, device=device)}}
    params["emb"] = draw_embedding(cfg, generator, device)
    if not cfg.tie_embeddings:
        params["head"] = draw_head(cfg, generator, device)
    n_super = cfg.n_layers // cfg.moe_every
    leaves = list(decoder_leaves(cfg))
    per_layer = [[] for _ in leaves]
    for _ in range(n_super):
        for i, (_, shape, kind) in enumerate(leaves):
            per_layer[i].append(draw_leaf(shape, kind, generator, device))
    layers: dict = {}
    for (path, _, _), vals in zip(leaves, per_layer):
        set_path(layers, path, torch.stack(vals))
    params["layers"] = layers
    return params


def layer_windows(cfg: ModelConfig, n: int):
    """Per-layer effective SWA window (NO_WINDOW = global attention)."""
    if cfg.swa_pattern == "all":
        return [cfg.swa_window] * n
    if cfg.swa_pattern == "alternate":
        return [cfg.swa_window if i % 2 == 0 else NO_WINDOW for i in range(n)]
    return [NO_WINDOW] * n


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig):
    """Embedding gather in the compute dtype (the cached decoder's order:
    cast first, then gemma2's sqrt(d) scale in that dtype).  The training
    forward scales first and casts after: ``_embed_tokens``."""
    x = params["emb"][tokens.long()].to(getattr(torch, cfg.compute_dtype))
    if cfg.name.startswith("gemma2"):
        x = x * torch.tensor(math.sqrt(cfg.d_model)).to(x.dtype)
    return x


def lm_head(params, x, cfg: ModelConfig, policy: QuantPolicy):
    x = blk.rmsnorm(params["final_norm"], x)
    # tied configs project through emb.T unless a packed store injected a
    # pre-packed "head" (model.pack_model_params)
    w = params["head"] if "head" in params else params["emb"].T
    logits = blk.dense(x, w, policy).float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _embed_tokens(params, batch, cfg: ModelConfig):
    """The training forward's embedding (the JAX package's
    ``_embed_tokens``): gather in f32, gemma2's sqrt(d) scale in f32, then
    the cast to the compute dtype -- not the cached decoder's order."""
    if "embeds" in batch and cfg.frontend_tokens:
        raise NotImplementedError("VLM prefix tokens are not ported yet; "
                                  "see ROADMAP.md, Queue 1 item 9")
    x = params["emb"][batch["tokens"].long()]
    if cfg.name.startswith("gemma2"):
        x = x * math.sqrt(cfg.d_model)
    return x.to(getattr(torch, cfg.compute_dtype))


def _apply_sublayer(p, x, cfg: ModelConfig, policy: QuantPolicy, *,
                    window, positions=None, cache=None, cache_pos=None,
                    cache_write_len=None):
    """Pre-norm attention + MLP sublayer (dense decoders), uncached
    (``positions``) or over a packed KV cache (``cache``...)."""
    h = blk.rmsnorm(p["ln1"], x)
    a, _ = blk.attention(p["attn"], h, cfg, policy, positions=positions,
                         window=window, cache=cache, cache_pos=cache_pos,
                         cache_write_len=cache_write_len)
    if cfg.post_norms:
        a = blk.rmsnorm(p["pn1"], a)
    x = x + a
    h = blk.rmsnorm(p["ln2"], x)
    f = blk.mlp(p["ffn"], h, cfg, policy)
    if cfg.post_norms:
        f = blk.rmsnorm(p["pn2"], f)
    return x + f


def _unstack(tree, n: int):
    """A stacked ``(n, ...)`` tree -> n per-layer trees (``torch.unbind``:
    one backward node per leaf gathers the layers' gradients at once)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def forward_hidden(params, batch, cfg: ModelConfig, policy: QuantPolicy,
                   remat: str = "none"):
    """Pre-head hidden states (B, S, d) of a dense decoder -- the chunked
    loss's entry point.  ``remat="full"`` recomputes each layer in the
    backward (``torch.utils.checkpoint``); the JAX package's ``"dots"``
    policy has no PyTorch counterpart."""
    _check_dense_decoder(cfg)
    if remat not in ("none", "full"):
        raise NotImplementedError(
            f"remat={remat!r}: only 'none' and 'full' are ported; see "
            "ROADMAP.md, Deferred item 2")
    x = _embed_tokens(params, batch, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    n_super = cfg.n_layers // cfg.moe_every
    windows = layer_windows(cfg, cfg.n_layers)

    def body(x, lp, i):
        for j in range(cfg.moe_every):
            x = _apply_sublayer(lp[f"sub{j}"], x, cfg, policy,
                                positions=positions,
                                window=windows[i * cfg.moe_every + j])
        return x

    for i, lp in enumerate(_unstack(params["layers"], n_super)):
        if remat == "full":
            x = ckpt.checkpoint(body, x, lp, i, use_reentrant=False)
        else:
            x = body(x, lp, i)
    return x
