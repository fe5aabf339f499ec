"""Decoder- and encoder-family parameter trees, embeddings, sublayer,
forward, LM head.

PyTorch counterpart of the decoder and encoder parts of the JAX package's
``models/transformer.py``: the training forward (``forward``,
``forward_hidden``, ``_encoder_forward``) and the pieces the cached decoder
(``decoding.py``) shares with it.  The parameter tree has the JAX layout --
decoder layers stacked on a leading ``(n_super, ...)`` axis with ``sub{j}``
keys per super-layer, encoder layers stacked ``(n_layers, ...)`` with no
``sub{j}`` level -- so ``convert.params_from_numpy`` carries a JAX tree
across leaf for leaf.

``init_params(cfg, generator, device)`` draws the same *distributions* as
the JAX init (normal * 1/sqrt(d_in) for projections and each expert's
matrices, * 0.02 for embedding, router, positions and head, zero biases
and cls token, unit norms), not the same bits.  Every weight is drawn one
layer at a time in a fixed order (``layer_leaves``), so
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


def _mlp_leaves(cfg: ModelConfig, d_ff: int, prefix=("ffn",)):
    d = cfg.d_model
    if cfg.mlp in ("swiglu", "geglu"):
        yield prefix + ("wg",), (d, d_ff), "dense"
    yield prefix + ("wu",), (d, d_ff), "dense"
    yield prefix + ("wd",), (d_ff, d), "dense"


def _sublayer_leaves(cfg: ModelConfig, is_moe: bool = False
                     ) -> Iterator[_Leaf]:
    d, dh, h, kv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv
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
    if is_moe:  # the JAX package's moe_init leaves
        E, f = cfg.padded_experts, cfg.expert_ff
        yield ("ffn", "router"), (d, E), "router"
        yield ("ffn", "we_g"), (E, d, f), "dense"
        yield ("ffn", "we_u"), (E, d, f), "dense"
        yield ("ffn", "we_d"), (E, f, d), "dense"
        if cfg.n_shared_experts:
            yield from _mlp_leaves(cfg, f * cfg.n_shared_experts,
                                   ("ffn", "shared"))
    else:
        yield from _mlp_leaves(cfg, cfg.d_ff)
    if cfg.post_norms:
        yield ("pn1", "w"), (d,), "ones"
        yield ("pn2", "w"), (d,), "ones"


# Queue 1 item (ROADMAP.md) that ports each family still missing
_FAMILY_ITEM = {"encdec": "4d", "ssm": "4e", "hybrid": "4e"}


def check_ported(cfg: ModelConfig, encoder: bool = False):
    """Raise for a family the calling path does not have yet: decoders
    (dense and MoE) everywhere, the encoder where ``encoder`` says the
    path takes it."""
    if cfg.family not in (("decoder", "encoder") if encoder
                          else ("decoder",)):
        item = _FAMILY_ITEM.get(cfg.family, "4")
        raise NotImplementedError(f"family {cfg.family!r} is not ported on "
                                  f"this path; see ROADMAP.md, Queue 1 item "
                                  f"{item}")


def is_moe_sublayer(cfg: ModelConfig, j: int) -> bool:
    """Whether sublayer ``j`` of a super-layer is the MoE one (the last)."""
    return cfg.n_experts > 0 and j == cfg.moe_every - 1


def n_stacked(cfg: ModelConfig) -> int:
    """Leading dim of the stacked layer leaves: n_layers for the encoder,
    the super-layer count for a decoder."""
    if cfg.family == "encoder":
        return cfg.n_layers
    return cfg.n_layers // cfg.moe_every


def layer_leaves(cfg: ModelConfig) -> Iterator[_Leaf]:
    """Per-layer leaves of one stacked layer: ``(sub{j}, ...)`` keys for a
    decoder super-layer, the sublayer's own keys for the encoder."""
    check_ported(cfg, encoder=True)
    if cfg.family == "encoder":
        yield from _sublayer_leaves(cfg)
        return
    for j in range(cfg.moe_every):
        for path, shape, kind in _sublayer_leaves(cfg,
                                                  is_moe_sublayer(cfg, j)):
            yield (f"sub{j}",) + path, shape, kind


def draw_leaf(shape, kind: str, gen, device) -> torch.Tensor:
    """One leaf: constants, "dense" normal * 1/sqrt(rows) (per expert for
    a stacked (E, rows, cols) leaf), the "router" normal * 0.02."""
    if kind == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    scale = 0.02 if kind == "router" else 1.0 / math.sqrt(shape[-2])
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * scale


def draw_embedding(cfg: ModelConfig, gen, device) -> torch.Tensor:
    return torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                       device=device, dtype=torch.float32) * 0.02


def head_shape(cfg: ModelConfig) -> Tuple[int, int]:
    """The head's (d, N): the classifier's for the encoder, else the LM's."""
    if cfg.family == "encoder":
        return (cfg.d_model, cfg.n_classes)
    return (cfg.d_model, cfg.padded_vocab)


def draw_head(cfg: ModelConfig, gen, device) -> torch.Tensor:
    return torch.randn(head_shape(cfg), generator=gen, device=device,
                       dtype=torch.float32) * 0.02


def set_path(tree: dict, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """f32 parameter tree of a decoder or encoder config (the JAX layout),
    on ``device`` (``None``: the generator's own device)."""
    if device is None:
        device = generator.device
    params = {"final_norm": {"w": torch.ones(cfg.d_model, device=device)}}
    if cfg.family == "encoder":
        params["pos"] = torch.randn(
            (cfg.frontend_tokens + 1, cfg.d_model), generator=generator,
            device=device, dtype=torch.float32) * 0.02
        params["cls"] = torch.zeros((1, 1, cfg.d_model), device=device)
        params["head"] = draw_head(cfg, generator, device)
    else:
        params["emb"] = draw_embedding(cfg, generator, device)
        if not cfg.tie_embeddings:
            params["head"] = draw_head(cfg, generator, device)
    leaves = list(layer_leaves(cfg))
    per_layer = [[] for _ in leaves]
    for _ in range(n_stacked(cfg)):
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
                                  "see ROADMAP.md, Queue 1 item 4c")
    x = params["emb"][batch["tokens"].long()]
    if cfg.name.startswith("gemma2"):
        x = x * math.sqrt(cfg.d_model)
    return x.to(getattr(torch, cfg.compute_dtype))


def _apply_ffn(p, x, cfg: ModelConfig, policy: QuantPolicy, is_moe: bool):
    if not is_moe:
        return blk.mlp(p, x, cfg, policy)
    if x.shape[1] == 1:  # decode: route across the batch, not the row
        return blk.moe(p, x.transpose(0, 1), cfg, policy).transpose(0, 1)
    return blk.moe(p, x, cfg, policy)


def _apply_sublayer(p, x, cfg: ModelConfig, policy: QuantPolicy, *,
                    window, is_moe=False, positions=None, cache=None,
                    cache_pos=None, cache_write_len=None, causal=True):
    """Pre-norm attention + FFN sublayer (decoders, MoE ones included; the
    encoder with ``causal=False``), uncached (``positions``) or over a KV
    cache (``cache``...)."""
    h = blk.rmsnorm(p["ln1"], x)
    a, _ = blk.attention(p["attn"], h, cfg, policy, positions=positions,
                         causal=causal, window=window, cache=cache,
                         cache_pos=cache_pos, cache_write_len=cache_write_len)
    if cfg.post_norms:
        a = blk.rmsnorm(p["pn1"], a)
    x = x + a
    h = blk.rmsnorm(p["ln2"], x)
    f = _apply_ffn(p["ffn"], h, cfg, policy, is_moe)
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


def _run_layers(layers, n: int, body, x, remat: str):
    """``x = body(x, layer_params, i)`` over the stacked layers;
    ``remat="full"`` recomputes each layer in the backward
    (``torch.utils.checkpoint``).  The JAX package's ``"dots"`` policy has
    no PyTorch counterpart yet."""
    if remat not in ("none", "full"):
        raise NotImplementedError(
            f"remat={remat!r}: only 'none' and 'full' are ported; see "
            "ROADMAP.md, Queue 1 item 6")
    for i, lp in enumerate(_unstack(layers, n)):
        if remat == "full":
            x = ckpt.checkpoint(body, x, lp, i, use_reentrant=False)
        else:
            x = body(x, lp, i)
    return x


def forward(params, batch, cfg: ModelConfig, policy: QuantPolicy,
            remat: str = "none"):
    """Full-sequence logits (f32) for training: the encoder's class logits
    (B, n_classes), a decoder's LM logits (B, S, padded_vocab)."""
    if cfg.family == "encoder":
        return _encoder_forward(params, batch, cfg, policy, remat)
    return lm_head(params, forward_hidden(params, batch, cfg, policy, remat),
                   cfg, policy)


def forward_hidden(params, batch, cfg: ModelConfig, policy: QuantPolicy,
                   remat: str = "none"):
    """Pre-head hidden states (B, S, d) of a decoder -- the chunked loss's
    entry point."""
    if cfg.family == "encoder":
        raise ValueError("the encoder has no LM hidden states; use forward")
    check_ported(cfg)
    x = _embed_tokens(params, batch, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    windows = layer_windows(cfg, cfg.n_layers)

    def body(x, lp, i):
        for j in range(cfg.moe_every):
            x = _apply_sublayer(lp[f"sub{j}"], x, cfg, policy,
                                positions=positions,
                                window=windows[i * cfg.moe_every + j],
                                is_moe=is_moe_sublayer(cfg, j))
        return x

    return _run_layers(params["layers"], n_stacked(cfg), body, x, remat)


def _encoder_forward(params, batch, cfg: ModelConfig, policy: QuantPolicy,
                     remat: str):
    """Encoder classifier: the cls token and learned positions before
    non-causal sublayers, the final rmsnorm, and the head on the cls row,
    in f32."""
    x = batch["embeds"].to(getattr(torch, cfg.compute_dtype))
    B = x.shape[0]
    cls = params["cls"].to(x.dtype).expand(B, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos"].to(x.dtype)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)

    def body(x, lp, i):
        return _apply_sublayer(lp, x, cfg, policy, positions=positions,
                               window=NO_WINDOW, causal=False)

    x = _run_layers(params["layers"], n_stacked(cfg), body, x, remat)
    x = blk.rmsnorm(params["final_norm"], x)
    return blk.dense(x[:, 0], params["head"], policy).float()
