"""Public model API: init, pack-once store, cached decode entry points.

PyTorch counterpart of the serving parts of the JAX package's
``models/model.py``, plus ``init_packed_params``: a packed store drawn leaf
by leaf, so a model whose f32 weights would not fit the device (qwen2.5-32b
at full width: ~131 GB of f32 against ~36 GB packed) can be served from
random weights.  ``packed_model_specs`` is the store's structure on the
``meta`` device, the restore target of a packed checkpoint.
"""
from __future__ import annotations

import math

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
prefill = decoding.prefill


def pack_model_params(cfg: ModelConfig, params, policy: QuantPolicy,
                      dtype=None):
    """Quantize the model's weight tree ONCE into the serving format.

    Tied embeddings get a packed ``"head"`` (the transposed table quantized
    at pack time) while ``"emb"`` stays a gatherable value table; an
    encoder-decoder's cross-attention stays in values (its prefill
    consumes the raw ``wk``/``wv``); leaves are cast to
    ``cfg.compute_dtype`` before quantizing, matching ``blocks.dense``.
    Idempotent: already-packed leaves pass through."""
    if not packed_store.packable_policy(policy):
        return params
    dtype = cfg.compute_dtype if dtype is None else dtype
    params = dict(params)
    if cfg.tie_embeddings and "head" not in params and "emb" in params:
        params["head"] = packed_store.pack_leaf(params["emb"].T, policy,
                                                dtype)
    return packed_store.pack_params(params, policy, dtype=dtype,
                                    exclude=_excluded(cfg))


def _excluded(cfg: ModelConfig):
    """Subtrees ``pack_model_params`` leaves in values: an encoder-decoder's
    cross-attention (its prefill projects the encoder's states through the
    raw ``wk``/``wv``)."""
    return ("cross",) if cfg.family == "encdec" else ()


def _packs(cfg: ModelConfig, path) -> bool:
    """Whether the store packs the stacked leaf at ``path``."""
    return (path[-1] in packed_store.PACKED_LEAF_NAMES
            and not set(path) & set(_excluded(cfg)))


def packed_model_specs(cfg: ModelConfig, policy: QuantPolicy, dtype=None):
    """The structure of ``pack_model_params(cfg, init_params(cfg, g),
    policy, dtype)`` without drawing a weight: ``meta`` tensors for the
    value leaves and for packed leaves' codes and scales, with the packed
    leaves' static MX metadata -- the ``ckpt.restore`` target of a packed
    checkpoint.  The JAX package gets it from ``jax.eval_shape``; here it
    follows ``transformer.stacks`` and ``packed_store``'s leaf rules
    (tied configs get the injected packed ``"head"``)."""
    pack = packed_store.packable_policy(policy)
    dtype = cfg.compute_dtype if dtype is None else dtype
    meta = lambda shape: torch.empty(shape, dtype=torch.float32,
                                     device="meta")

    def leaf(packs, shape):
        if pack and packs and len(shape) > 1:
            return packed_store.pack_leaf_spec(shape, policy, dtype)
        return meta(shape)

    specs = {"final_norm": {"w": meta((cfg.d_model,))}}
    if cfg.family == "encoder":
        specs["pos"] = meta((cfg.frontend_tokens + 1, cfg.d_model))
        specs["cls"] = meta((1, 1, cfg.d_model))
        specs["head"] = leaf(True, transformer.head_shape(cfg))
    else:
        specs["emb"] = meta((cfg.padded_vocab, cfg.d_model))
        if pack or not cfg.tie_embeddings:
            specs["head"] = leaf(True, transformer.head_shape(cfg))
    for name, lead, leaves in transformer.stacks(cfg):
        tree: dict = {}
        for path, shape, _ in leaves:
            transformer.set_path(tree, path,
                                 leaf(_packs(cfg, path), lead + shape))
        specs[name] = tree
    return specs


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


def _with_lead(stack, lead):
    """A ``(prod(lead), ...)`` stack viewed with the ``lead`` dims (none:
    the single layer's leaf itself)."""
    if isinstance(stack, QuantizedTensor):
        view = lambda t: t.reshape(lead + tuple(t.shape[1:]))
        return QuantizedTensor(view(stack.codes), view(stack.scale_e8m0),
                               stack.fmt, stack.block,
                               lead + tuple(stack.shape[1:]), stack.dtype)
    return stack.reshape(lead + tuple(stack.shape[1:]))


@torch.no_grad()
def init_packed_params(cfg: ModelConfig, policy: QuantPolicy,
                       generator: torch.Generator, device=None):
    """The packed store of ``init_params(cfg, generator, device)``, built
    leaf by leaf: each weight is drawn in f32, packed, and freed before the
    next one is drawn, so the f32 tree never exists.  Draws the same values
    in the same order as ``init_params``, so on one device
    ``pack_model_params(init_params(g))`` and this agree bitwise.  MoE
    routers and expert stacks stay f32 values, as in the JAX package's
    store (only their shared expert's MLP is packed), and so does an
    encoder-decoder's cross-attention.  ``device=None`` is the generator's
    own device."""
    if cfg.family == "encoder":
        raise ValueError("init_packed_params builds LM stores; pack an "
                         "encoder with pack_model_params")
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
    for name, lead, leaves in transformer.stacks(cfg):
        n = math.prod(lead)
        stacked = [None] * len(leaves)
        for layer in range(n):
            for i, (path, shape, kind) in enumerate(leaves):
                val = transformer.draw_leaf(shape, kind, generator, device)
                if _packs(cfg, path):
                    val = packed_store.pack_leaf(val, policy, dtype)
                if stacked[i] is None:
                    stacked[i] = _empty_stack(val, n)
                _set_layer(stacked[i], layer, val)
                del val
        tree: dict = {}
        for (path, _, _), val in zip(leaves, stacked):
            transformer.set_path(tree, path, _with_lead(val, lead))
        params[name] = tree
    return params


def decode_attn_backend(cfg: ModelConfig, policy: QuantPolicy) -> str:
    """Which datapath cached attention takes (decode steps and prefill
    chunks share one gate, ``blocks.attn_kernel_eligible``):
    ``'cuda-packed'`` -- the flash kernel reads the packed cache codes
    directly -- or ``'torch'``, the value-domain path (the JAX package's
    ``'jnp'``): ``mx_einsum`` over a value cache, or over the dequantized
    packed cache, with the ring-aware window and softcap math."""
    from . import blocks
    return "cuda-packed" if blocks.attn_kernel_eligible(cfg, policy) \
        else "torch"
