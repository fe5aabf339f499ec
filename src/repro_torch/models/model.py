"""Public model API: init, pack-once store, cached decode entry points.

PyTorch counterpart of the serving parts of the JAX package's
``models/model.py``, plus ``init_packed_params``: a packed store drawn leaf
by leaf, so a model whose f32 weights would not fit the device (qwen2.5-32b
at full width: ~131 GB of f32 against ~36 GB packed) can be served from
random weights.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core import packed_store
from ..core.blocking import QuantizedTensor
from ..core.policy import QuantPolicy
from . import decoding, transformer

init_params = transformer.init_params
init_cache = decoding.init_cache
decode_step = decoding.decode_step
prefill_step = decoding.prefill_step


def pack_model_params(cfg: ModelConfig, params, policy: QuantPolicy,
                      dtype=None):
    """Quantize the model's weight tree ONCE into the serving format.

    Tied embeddings get a packed ``"head"`` (the transposed table quantized
    at pack time) while ``"emb"`` stays a gatherable value table; leaves are
    cast to ``cfg.compute_dtype`` before quantizing, matching
    ``blocks.dense``.  Idempotent: already-packed leaves pass through."""
    if not packed_store.packable_policy(policy):
        return params
    dtype = cfg.compute_dtype if dtype is None else dtype
    params = dict(params)
    if cfg.tie_embeddings and "head" not in params and "emb" in params:
        params["head"] = packed_store.pack_leaf(params["emb"].T, policy,
                                                dtype)
    exclude = ("cross",) if cfg.family == "encdec" else ()
    return packed_store.pack_params(params, policy, dtype=dtype,
                                    exclude=exclude)


def _empty_stack(leaf, n: int):
    """Uninitialized ``(n, ...)`` stack shaped like one layer's leaf."""
    empty = lambda t: torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                  device=t.device)
    if isinstance(leaf, QuantizedTensor):
        return QuantizedTensor(empty(leaf.codes), empty(leaf.scale_e8m0),
                               leaf.fmt, leaf.block,
                               (n,) + tuple(leaf.shape), leaf.dtype)
    return empty(leaf)


def _set_layer(stack, i: int, leaf):
    if isinstance(leaf, QuantizedTensor):
        stack.codes[i] = leaf.codes
        stack.scale_e8m0[i] = leaf.scale_e8m0
    else:
        stack[i] = leaf


@torch.no_grad()
def init_packed_params(cfg: ModelConfig, policy: QuantPolicy,
                       generator: torch.Generator, device=None):
    """The packed store of ``init_params(cfg, generator, device)``, built
    leaf by leaf: each weight is drawn in f32, packed, and freed before the
    next one is drawn, so the f32 tree never exists.  Draws the same values
    in the same order as ``init_params``, so on one device
    ``pack_model_params(init_params(g))`` and this agree bitwise.
    ``device=None`` is the generator's own device."""
    if device is None:
        device = generator.device
    if not packed_store.packable_policy(policy):
        raise ValueError("init_packed_params needs a quantizing policy")
    dtype = cfg.compute_dtype
    params = {"final_norm": {"w": torch.ones(cfg.d_model, device=device)}}
    params["emb"] = transformer.draw_embedding(cfg, generator, device)
    if not cfg.tie_embeddings:
        params["head"] = packed_store.pack_leaf(
            transformer.draw_head(cfg, generator, device), policy, dtype)
    else:
        params["head"] = packed_store.pack_leaf(params["emb"].T, policy,
                                                dtype)
    n_super = cfg.n_layers // cfg.moe_every
    leaves = list(transformer.decoder_leaves(cfg))
    stacked = [None] * len(leaves)
    for layer in range(n_super):
        for i, (path, shape, kind) in enumerate(leaves):
            val = transformer.draw_leaf(shape, kind, generator, device)
            if path[-1] in packed_store.PACKED_LEAF_NAMES:
                val = packed_store.pack_leaf(val, policy, dtype)
            if stacked[i] is None:
                stacked[i] = _empty_stack(val, n_super)
            _set_layer(stacked[i], layer, val)
            del val
    layers: dict = {}
    for (path, _, _), val in zip(leaves, stacked):
        transformer.set_path(layers, path, val)
    params["layers"] = layers
    return params


def decode_attn_backend(cfg: ModelConfig, policy: QuantPolicy) -> str:
    """Which datapath cached attention takes (decode steps and prefill
    chunks share one gate): ``'cuda-packed'`` -- the flash kernel reads the
    packed cache codes directly -- or ``'torch'``, the value-domain path
    (not ported yet)."""
    from . import blocks
    return "cuda-packed" if blocks.attn_kernel_eligible(cfg, policy) \
        else "torch"
