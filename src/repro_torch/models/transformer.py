"""Decoder-family parameter tree, embedding, LM head and layer windows.

PyTorch counterpart of the decoder parts of the JAX package's
``models/transformer.py``.  The parameter tree has the JAX layout -- layers
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


def decoder_leaves(cfg: ModelConfig) -> Iterator[_Leaf]:
    """Per-layer leaves of one super-layer, keyed ``(sub{j}, ...)``."""
    if cfg.family != "decoder":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet; "
                                  "see ROADMAP.md, deferred item 5")
    if cfg.n_experts > 0:
        raise NotImplementedError("MoE layers are not ported yet; see "
                                  "ROADMAP.md, deferred item 5")
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
                device="cpu") -> dict:
    """f32 parameter tree of a decoder config (the JAX layout)."""
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
    cast first, then gemma2's sqrt(d) scale in that dtype)."""
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
