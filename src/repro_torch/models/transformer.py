"""Parameter trees, embeddings, sublayers, forwards and the LM head of
every family: decoders (dense, GQA, SWA, softcap, MoE, VLM prefix), the
SSM stack (mamba2), the hybrid (zamba2: SSM groups around one shared
attention sublayer), the encoder-decoder (whisper, frontend stubbed) and
the encoder classifier (deit).

PyTorch counterpart of the JAX package's ``models/transformer.py``: the
training forward (``forward``, ``forward_hidden``) and the pieces the
cached decoder (``decoding.py``) shares with it.  The parameter tree has
the JAX layout -- each stack of ``stacks(cfg)`` on its leading axes (a
decoder's super-layers with ``sub{j}`` keys, a hybrid's ``(groups, per)``
SSM layers, ...) -- so ``convert.params_from_numpy`` carries a JAX tree
across leaf for leaf.  The JAX package scans over layers; here a Python
loop runs them (``_run_layers``), one remat region per layer.

``init_params(cfg, generator, device)`` draws the same *distributions* as
the JAX init (normal * 1/sqrt(d_in) for projections and each expert's
matrices, * 0.02 for embedding, router, positions and head, zero biases
and cls token, unit norms, the SSD's own, ``ssd.ssd_leaves``), not the
same bits.  Every weight is drawn one layer at a time in a fixed order
(``stacks``), so ``model.init_packed_params`` can draw the same values and
pack each one as it is drawn, without ever holding the f32 tree.
"""
from __future__ import annotations

import math
from typing import Iterator, Tuple

import torch
import torch.utils.checkpoint as ckpt

from ..configs.base import ModelConfig
from ..core import sharding as shd
from ..core.blocking import QuantizedTensor
from ..core.mx_dot import save_dots
from ..core.policy import QuantPolicy
from . import blocks as blk
from . import ssd

NO_WINDOW = 1 << 30

# (path under the stacked layer, per-layer shape, init kind): see
# ``draw_leaf``
_Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str]


def _mlp_leaves(cfg: ModelConfig, d_ff: int, prefix=("ffn",)):
    d = cfg.d_model
    if cfg.mlp in ("swiglu", "geglu"):
        yield prefix + ("wg",), (d, d_ff), "dense"
    yield prefix + ("wu",), (d, d_ff), "dense"
    yield prefix + ("wd",), (d_ff, d), "dense"


def _attn_leaves(cfg: ModelConfig, prefix):
    d, dh, h, kv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv
    yield prefix + ("wq",), (d, h * dh), "dense"
    yield prefix + ("wk",), (d, kv * dh), "dense"
    yield prefix + ("wv",), (d, kv * dh), "dense"
    yield prefix + ("wo",), (h * dh, d), "dense"
    if cfg.qkv_bias:
        yield prefix + ("bq",), (h * dh,), "zeros"
        yield prefix + ("bk",), (kv * dh,), "zeros"
        yield prefix + ("bv",), (kv * dh,), "zeros"


def _sublayer_leaves(cfg: ModelConfig, is_moe: bool = False
                     ) -> Iterator[_Leaf]:
    d = cfg.d_model
    yield ("ln1", "w"), (d,), "ones"
    yield from _attn_leaves(cfg, ("attn",))
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


def _declayer_leaves(cfg: ModelConfig) -> Iterator[_Leaf]:
    """An encoder-decoder's decoder layer: self- and cross-attention and
    the MLP, each behind its rmsnorm."""
    d = cfg.d_model
    yield ("ln1", "w"), (d,), "ones"
    yield from _attn_leaves(cfg, ("self",))
    yield ("ln2", "w"), (d,), "ones"
    yield from _attn_leaves(cfg, ("cross",))
    yield ("ln3", "w"), (d,), "ones"
    yield from _mlp_leaves(cfg, cfg.d_ff, ("mlp",))


def _ssm_layer_leaves(cfg: ModelConfig) -> Iterator[_Leaf]:
    yield ("ln", "w"), (cfg.d_model,), "ones"
    for path, shape, kind in ssd.ssd_leaves(cfg):
        yield ("ssd",) + path, shape, kind


def is_moe_sublayer(cfg: ModelConfig, j: int) -> bool:
    """Whether sublayer ``j`` of a super-layer is the MoE one (the last)."""
    return cfg.n_experts > 0 and j == cfg.moe_every - 1


def hybrid_split(cfg: ModelConfig):
    """(groups, SSM layers per group, tail SSM layers) of a hybrid."""
    per = cfg.hybrid_attn_every
    n_groups = cfg.n_layers // per
    return n_groups, per, cfg.n_layers - n_groups * per


def stacks(cfg: ModelConfig):
    """The stacked subtrees of the parameter tree, in draw order:
    ``(key, lead dims, per-layer leaves)``.  A decoder's layers are
    super-layers with ``sub{j}`` keys, the encoder's plain sublayers; a
    hybrid stacks its SSM layers ``(groups, per)`` plus a ``tail`` and
    holds ONE ``shared`` attention sublayer (lead ``()``); an
    encoder-decoder stacks ``enc_layers`` and ``dec_layers`` and has an
    ``enc_norm``."""
    if cfg.family == "encoder":
        return [("layers", (cfg.n_layers,), list(_sublayer_leaves(cfg)))]
    if cfg.family == "decoder":
        leaves = [((f"sub{j}",) + path, shape, kind)
                  for j in range(cfg.moe_every)
                  for path, shape, kind in _sublayer_leaves(
                      cfg, is_moe_sublayer(cfg, j))]
        return [("layers", (cfg.n_layers // cfg.moe_every,), leaves)]
    if cfg.family == "ssm":
        return [("layers", (cfg.n_layers,), list(_ssm_layer_leaves(cfg)))]
    if cfg.family == "hybrid":
        G, per, tail = hybrid_split(cfg)
        out = [("layers", (G, per), list(_ssm_layer_leaves(cfg)))]
        if tail:
            out.append(("tail", (tail,), list(_ssm_layer_leaves(cfg))))
        return out + [("shared", (), list(_sublayer_leaves(cfg)))]
    if cfg.family == "encdec":
        return [("enc_layers", (cfg.n_enc_layers,),
                 list(_sublayer_leaves(cfg))),
                ("dec_layers", (cfg.n_layers,),
                 list(_declayer_leaves(cfg))),
                ("enc_norm", (), [(("w",), (cfg.d_model,), "ones")])]
    raise ValueError(f"unknown family {cfg.family!r}")


def draw_leaf(shape, kind: str, gen, device) -> torch.Tensor:
    """One leaf: constants ("ones", "zeros", the SSD's "a_log" and
    "dt_bias"), "dense" normal * 1/sqrt(rows) (per expert for a stacked
    (E, rows, cols) leaf), the "router" normal * 0.02, the SSD's "conv"
    normal * 0.2."""
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "ones":
        return torch.ones(shape, **f32)
    if kind == "zeros":
        return torch.zeros(shape, **f32)
    if kind == "a_log":
        return torch.log(torch.linspace(1.0, 16.0, shape[-1], **f32))
    if kind == "dt_bias":
        return torch.log(torch.expm1(torch.full(shape, 0.01, **f32)))
    scale = {"router": 0.02, "conv": 0.2}.get(kind)
    if scale is None:
        scale = 1.0 / math.sqrt(shape[-2])
    return torch.randn(shape, generator=gen, **f32) * scale


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
    """f32 parameter tree of any family (the JAX layout), on ``device``
    (``None``: the generator's own device)."""
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
    for name, lead, leaves in stacks(cfg):
        per_layer = [[] for _ in leaves]
        for _ in range(math.prod(lead)):
            for i, (_, shape, kind) in enumerate(leaves):
                per_layer[i].append(draw_leaf(shape, kind, generator,
                                              device))
        tree: dict = {}
        for (path, shape, _), vals in zip(leaves, per_layer):
            set_path(tree, path, torch.stack(vals).reshape(lead + shape))
        params[name] = tree
    return params


def layer_windows(cfg: ModelConfig, n: int):
    """Per-layer effective SWA window (NO_WINDOW = global attention)."""
    if cfg.swa_pattern == "all":
        return [cfg.swa_window] * n
    if cfg.swa_pattern == "alternate":
        return [cfg.swa_window if i % 2 == 0 else NO_WINDOW for i in range(n)]
    return [NO_WINDOW] * n


def _lookup(params, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``.  Where the stored table splits the
    vocab over the model axis (a TP mesh context), each rank looks up the
    rows it holds, zeros the rest, and one all-reduce sums them (exact:
    every row comes from one rank, x + 0 = x); a d split over the DP axes
    is gathered at use, as every FSDP dim is."""
    tok = tokens.long()
    ctx = shd.active()
    if ctx is None or "emb" not in ctx.get("specs", {}):
        return params["emb"][tok]
    split = shd.axes_of(ctx["specs"]["emb"][0][0]) == (ctx["tp"],)
    emb = blk.use(params, "emb", 0 if split else None)
    if not split:
        return emb[tok]
    n = emb.shape[0]
    idx = tok - ctx["mesh"].coord(ctx["tp"]) * n
    ok = (idx >= 0) & (idx < n)
    rows = emb[torch.clamp(idx, 0, n - 1)]
    return shd.all_reduce(torch.where(ok[..., None], rows,
                                      torch.zeros_like(rows)))


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig):
    """Embedding gather in the compute dtype (the cached decoder's order:
    cast first, then gemma2's sqrt(d) scale in that dtype).  The training
    forward scales first and casts after: ``_embed_tokens``."""
    x = _lookup(params, tokens).to(getattr(torch, cfg.compute_dtype))
    if cfg.name.startswith("gemma2"):
        x = x * torch.tensor(math.sqrt(cfg.d_model)).to(x.dtype)
    return x


def lm_head(params, x, cfg: ModelConfig, policy: QuantPolicy):
    x = blk.rmsnorm(params["final_norm"], x)
    # tied configs project through emb.T unless a packed store injected a
    # pre-packed "head" (model.pack_model_params); under a TP plan the
    # vocab columns split over the model axis and are gathered after
    pl = blk.plan()
    split = pl is not None and pl.vocab
    if "head" in params:
        w = blk.use(params, "head", 1 if split else None)
    else:
        w = blk.use(params, "emb", 0 if split else None).T
    logits = blk.dense(x, w, policy).float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if split:
        logits = shd.all_gather(logits, shd.active()["tp"], -1)
    return logits


def _embed_tokens(params, batch, cfg: ModelConfig):
    """The training forward's embedding (the JAX package's
    ``_embed_tokens``): gather in f32, gemma2's sqrt(d) scale in f32, a
    VLM's patch embeddings (``batch["embeds"]``) prepended, then the cast
    to the compute dtype -- not the cached decoder's order."""
    x = params["emb"][batch["tokens"].long()]
    if cfg.name.startswith("gemma2"):
        x = x * math.sqrt(cfg.d_model)
    if "embeds" in batch and cfg.frontend_tokens:
        x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
    return x.to(getattr(torch, cfg.compute_dtype))


def _apply_ffn(p, x, cfg: ModelConfig, policy: QuantPolicy, is_moe: bool):
    if not is_moe:
        return blk.mlp(p, x, cfg, policy)
    if x.shape[1] != 1:
        return blk.moe(p, x, cfg, policy)
    # decode: route across the batch, not the row.  Where a mesh context
    # splits the slot batch over the DP axes (``batch_rows``: the axes and
    # this rank's first row), the rows of every DP rank are gathered and
    # routed as one row, as the one-device engine routes them (the
    # capacity and the drops come from the whole batch); this rank keeps
    # its own rows of the output
    ctx = shd.active()
    rows = None if ctx is None else ctx.get("batch_rows")
    if rows is None:
        return blk.moe(p, x.transpose(0, 1), cfg, policy).transpose(0, 1)
    axes, lo = rows
    whole = shd.all_gather(x, axes, 0)
    y = blk.moe(p, whole.transpose(0, 1), cfg, policy).transpose(0, 1)
    return y[lo:lo + x.shape[0]]


def _apply_sublayer(p, x, cfg: ModelConfig, policy: QuantPolicy, *,
                    window, is_moe=False, positions=None, cache=None,
                    cache_pos=None, cache_write_len=None, causal=True):
    """Pre-norm attention + FFN sublayer (decoders, MoE ones included; the
    encoder with ``causal=False``; a hybrid's shared block), uncached
    (``positions``) or over a KV cache (``cache``...)."""
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


def _ssm_layer(lp, x, cfg: ModelConfig, policy: QuantPolicy):
    return x + ssd.ssd_forward(lp["ssd"], blk.rmsnorm(lp["ln"], x), cfg,
                               policy)


def _unstack(tree, n: int):
    """A stacked ``(n, ...)`` tree (values or packed leaves) -> n per-layer
    trees (``torch.unbind``: one backward node per leaf gathers the
    layers' gradients at once)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(tree, QuantizedTensor):
        return [QuantizedTensor(c, s, tree.fmt, tree.block,
                                tuple(tree.shape[1:]), tree.dtype)
                for c, s in zip(torch.unbind(tree.codes, 0),
                                torch.unbind(tree.scale_e8m0, 0))]
    return list(torch.unbind(tree, 0))


def _run_layers(layers, n: int, body, x, remat: str):
    """``x = body(x, layer_params, i)`` over the stacked layers.  Each
    layer is one remat region, as each scan step is in the JAX package:
    ``"full"`` recomputes it whole in the backward
    (``torch.utils.checkpoint``); ``"dots"`` (the JAX package's
    ``dots_with_no_batch_dims_saveable``) keeps every ``mx_dot`` output of
    the layer and recomputes the rest -- including the quantization of
    each matmul's operands, but no matmul (``mx_dot.save_dots``)."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat={remat!r}: expected 'none', 'dots' or "
                         "'full'")
    for i, lp in enumerate(_unstack(layers, n)):
        if remat == "none":
            x = body(x, lp, i)
        else:
            x = ckpt.checkpoint(
                body, x, lp, i, use_reentrant=False,
                **({"context_fn": save_dots} if remat == "dots" else {}))
    return x


def forward(params, batch, cfg: ModelConfig, policy: QuantPolicy,
            remat: str = "none"):
    """Full-sequence logits (f32) for training: the encoder's class logits
    (B, n_classes), an LM's logits (B, S, padded_vocab)."""
    if cfg.family == "encoder":
        return _encoder_forward(params, batch, cfg, policy, remat)
    return lm_head(params, forward_hidden(params, batch, cfg, policy, remat),
                   cfg, policy)


def forward_hidden(params, batch, cfg: ModelConfig, policy: QuantPolicy,
                   remat: str = "none"):
    """Pre-head hidden states (B, S, d) of an LM -- the chunked loss's
    entry point (a VLM's include its prefix positions)."""
    if cfg.family == "encoder":
        raise ValueError("the encoder has no LM hidden states; use forward")
    if cfg.family == "encdec":
        return _encdec_forward(params, batch, cfg, policy, remat)
    x = _embed_tokens(params, batch, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    if cfg.family == "ssm":
        return _run_layers(params["layers"], cfg.n_layers,
                           lambda x, lp, i: _ssm_layer(lp, x, cfg, policy),
                           x, remat)
    if cfg.family == "hybrid":
        return _hybrid_forward(params, x, positions, cfg, policy, remat)
    windows = layer_windows(cfg, cfg.n_layers)

    def body(x, lp, i):
        for j in range(cfg.moe_every):
            x = _apply_sublayer(lp[f"sub{j}"], x, cfg, policy,
                                positions=positions,
                                window=windows[i * cfg.moe_every + j],
                                is_moe=is_moe_sublayer(cfg, j))
        return x

    return _run_layers(params["layers"], cfg.n_layers // cfg.moe_every, body,
                       x, remat)


def _hybrid_forward(params, x, positions, cfg: ModelConfig,
                    policy: QuantPolicy, remat: str):
    """Groups of ``per`` SSM layers, each followed by the ONE shared
    attention sublayer (its gradient sums over the applications), then the
    tail; each group and each tail layer is one remat region."""
    G, per, tail = hybrid_split(cfg)

    def group(x, glp, i):
        for lp in _unstack(glp, per):
            x = _ssm_layer(lp, x, cfg, policy)
        return _apply_sublayer(params["shared"], x, cfg, policy,
                               positions=positions, window=NO_WINDOW)

    x = _run_layers(params["layers"], G, group, x, remat)
    if tail:
        x = _run_layers(params["tail"], tail,
                        lambda x, lp, i: _ssm_layer(lp, x, cfg, policy),
                        x, remat)
    return x


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

    x = _run_layers(params["layers"], cfg.n_layers, body, x, remat)
    x = blk.rmsnorm(params["final_norm"], x)
    return blk.dense(x[:, 0], params["head"], policy).float()


def sinusoid_pos(S: int, d: int, offset: int = 0, device=None):
    """Whisper-style sinusoidal positions (S, d) in f32: the JAX package's
    ``_sinusoid_pos``."""
    pos = torch.arange(offset, offset + S, dtype=torch.float32,
                       device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10_000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encode(params, frames, cfg: ModelConfig, policy: QuantPolicy,
           remat: str = "none"):
    """The encoder-decoder's encoder: (B, enc_seq, d) frame embeddings
    (the stubbed frontend's output) plus sinusoidal positions through
    non-causal sublayers, then ``enc_norm``."""
    x = frames.to(getattr(torch, cfg.compute_dtype))
    B, S, _ = x.shape
    x = x + sinusoid_pos(S, cfg.d_model, device=x.device).to(x.dtype)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)

    def body(x, lp, i):
        return _apply_sublayer(lp, x, cfg, policy, positions=positions,
                               window=NO_WINDOW, causal=False)

    x = _run_layers(params["enc_layers"], cfg.n_enc_layers, body, x, remat)
    return blk.rmsnorm(params["enc_norm"], x)


def _encdec_forward(params, batch, cfg: ModelConfig, policy: QuantPolicy,
                    remat: str):
    """Decoder hidden states of an encoder-decoder: ``encode`` the
    ``frames``, then causal self-attention, cross-attention to the
    encoder's states and the MLP per layer."""
    enc = encode(params, batch["frames"], cfg, policy, remat)
    x = params["emb"][batch["tokens"].long()].to(
        getattr(torch, cfg.compute_dtype))
    B, S, _ = x.shape
    x = x + sinusoid_pos(S, cfg.d_model, device=x.device).to(x.dtype)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)

    def body(x, lp, i):
        h = blk.rmsnorm(lp["ln1"], x)
        a, _ = blk.attention(lp["self"], h, cfg, policy, positions=positions,
                             causal=True)
        x = x + a
        h = blk.rmsnorm(lp["ln2"], x)
        c, _ = blk.attention(lp["cross"], h, cfg, policy, kv_x=enc,
                             causal=False)
        x = x + c
        return x + blk.mlp(lp["mlp"], blk.rmsnorm(lp["ln3"], x), cfg, policy)

    return _run_layers(params["dec_layers"], cfg.n_layers, body, x, remat)
