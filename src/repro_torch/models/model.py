"""Public model API: init, pack-once store, cached decode entry points and
the input specs of an (arch x shape) cell.

PyTorch counterpart of the JAX package's ``models/model.py``, plus
``init_packed_params``: a packed store drawn leaf by leaf, so a model whose
f32 weights would not fit the device (qwen2.5-32b at full width: ~131 GB
of f32 against ~36 GB packed) can be served from random weights.
``packed_model_specs`` is the store's structure on the ``meta`` device, the
restore target of a packed checkpoint; ``train_specs`` and
``decode_specs`` give a cell's inputs as ``meta`` tensors where the JAX
package has ``ShapeDtypeStruct``s -- the dry run (``launch/dryrun.py``)
runs against them.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core import packed_store, sharding
from ..core.blocking import QuantizedTensor
from ..core.policy import QuantPolicy
from . import decoding, transformer

init_params = transformer.init_params
forward = transformer.forward
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


def _keep(val, ns, lead: int):
    """This rank's slice of one drawn leaf (``lead`` stacked dims fewer
    than the sharding ``ns`` of its stack), a copy: the whole leaf can be
    freed.  ``ns`` None keeps the leaf."""
    if ns is None:
        return val
    one = ns.codes if isinstance(ns, QuantizedTensor) else ns
    dims = tuple(d - lead for d in sharding.uneven_dims(one))
    local = packed_store.shard_leaf(val, tuple(one.spec)[lead:], one.mesh,
                                    dims)
    return sharding.map_parts(local, torch.clone)


def _at_path(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@torch.no_grad()
def init_packed_params(cfg: ModelConfig, policy: QuantPolicy,
                       generator: torch.Generator, device=None,
                       shardings=None):
    """The packed store of ``init_params(cfg, generator, device)``, built
    leaf by leaf: each weight is drawn in f32, packed, and freed before the
    next one is drawn, so the f32 tree never exists.  Draws the same values
    in the same order as ``init_params``, so on one device
    ``pack_model_params(init_params(g))`` and this agree bitwise.  MoE
    routers and expert stacks stay f32 values, as in the JAX package's
    store (only their shared expert's MLP is packed), and so does an
    encoder-decoder's cross-attention.  ``device=None`` is the generator's
    own device.  ``shardings`` (``launch/mesh.MeshRules.
    param_sharding_tree`` of ``packed_model_specs``): each leaf is drawn
    whole, as one device draws it, and only this rank's slice is kept, so
    the slices equal those of the one-device store bit for bit."""
    if cfg.family == "encoder":
        raise ValueError("init_packed_params builds LM stores; pack an "
                         "encoder with pack_model_params")
    if device is None:
        device = generator.device
    if not packed_store.packable_policy(policy):
        raise ValueError("init_packed_params needs a quantizing policy")
    dtype = cfg.compute_dtype
    sh = (lambda *path: None) if shardings is None else \
        (lambda *path: _at_path(shardings, path))
    params = {"final_norm": {"w": _keep(torch.ones(
        cfg.d_model, device=device), sh("final_norm", "w"), 0)}}
    emb = transformer.draw_embedding(cfg, generator, device)
    head = (emb.T if cfg.tie_embeddings else
            transformer.draw_head(cfg, generator, device))
    params["emb"] = _keep(emb, sh("emb"), 0)
    params["head"] = _keep(packed_store.pack_leaf(head, policy, dtype),
                           sh("head"), 0)
    del emb, head
    for name, lead, leaves in transformer.stacks(cfg):
        n = math.prod(lead)
        stacked = [None] * len(leaves)
        for layer in range(n):
            for i, (path, shape, kind) in enumerate(leaves):
                val = transformer.draw_leaf(shape, kind, generator, device)
                if _packs(cfg, path):
                    val = packed_store.pack_leaf(val, policy, dtype)
                val = _keep(val, sh(name, *path), len(lead))
                if stacked[i] is None:
                    stacked[i] = _empty_stack(val, n)
                _set_layer(stacked[i], layer, val)
                del val
        tree: dict = {}
        for (path, _, _), val in zip(leaves, stacked):
            transformer.set_path(tree, path, _with_lead(val, lead))
        params[name] = tree
    return params


def decode_attn_backend(cfg: ModelConfig, policy: QuantPolicy,
                        cache_shardings=None) -> str:
    """Which datapath cached attention takes (decode steps and prefill
    chunks share one gate, ``blocks.attn_kernel_eligible``):
    ``'cuda-packed'`` -- the flash kernel reads the packed cache codes
    directly -- or ``'torch'``, the value-domain path (the JAX package's
    ``'jnp'``): ``mx_einsum`` over a value cache, or over the dequantized
    packed cache, with the ring-aware window and softcap math.

    ``cache_shardings`` (a NamedSharding tree of the cache, from
    ``launch/mesh.cache_shardings``) adds the per-shard half of the gate:
    where the cache's position axis is sharded (sequence parallelism),
    each rank holds a slice of every sequence and the kernel's per-row
    online softmax cannot run shard-local, so those layouts take the
    value path.  Batch- and kv-head-sharded caches keep the kernel."""
    from . import blocks
    if not blocks.attn_kernel_eligible(cfg, policy):
        return "torch"
    if cache_shardings is not None and \
            cache_position_axis_sharded(cache_shardings):
        return "torch"
    return "cuda-packed"


_KV_LEAVES = ("k", "v", "k_codes", "v_codes", "k_scales", "v_scales")


def cache_position_axis_sharded(cache_shardings) -> bool:
    """True when any KV-cache leaf shards its position/window axis (the
    ``W`` of ``(..., B, W, kv, dh)``): the one cache layout the packed
    flash-attention kernel cannot consume shard-local."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return any(walk(v, k) for k, v in node.items())
        if name not in _KV_LEAVES:
            return False
        spec = tuple(node.spec)
        w_ax = len(spec) - 3
        return w_ax >= 0 and spec[w_ax] is not None

    return walk(cache_shardings)


def param_count(params) -> int:
    """Elements of every leaf (a packed leaf: its codes and scales)."""
    total = 0
    for leaf in packed_store.tree_leaves(params):
        if isinstance(leaf, QuantizedTensor):
            total += leaf.codes.numel() + leaf.scale_e8m0.numel()
        else:
            total += leaf.numel()
    return total


def active_param_count(cfg: ModelConfig, params) -> int:
    """Active params per token (MoE: top_k + shared experts only)."""
    total = param_count(params)
    if not cfg.n_experts:
        return total
    expert_p = 3 * cfg.d_model * cfg.expert_ff  # gate/up/down per expert
    n_moe_layers = cfg.n_layers // cfg.moe_every
    inactive = n_moe_layers * (cfg.n_experts - cfg.top_k) * expert_p
    return total - inactive


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """``meta`` tensors for one train/prefill step's batch."""
    B, S = shape.global_batch, shape.seq_len
    specs = {}
    if cfg.family == "encoder":
        specs["embeds"] = _spec((B, cfg.frontend_tokens, cfg.d_model),
                                torch.bfloat16)
        specs["label"] = _spec((B,), torch.int32)
        return specs
    specs["tokens"] = _spec((B, S), torch.int32)
    if shape.kind == "train":
        specs["labels"] = _spec((B, S), torch.int32)
    if cfg.family == "encdec":
        specs["frames"] = _spec((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    if cfg.frontend == "vision" and cfg.frontend_tokens:
        specs["embeds"] = _spec((B, cfg.frontend_tokens, cfg.d_model),
                                torch.bfloat16)
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, ring: bool = True,
                 kv_fmt: str = "") -> Dict:
    """``meta`` tensors for one serve step: the new token, the KV/state
    cache at seq_len and the position."""
    B = shape.global_batch
    return {
        "tokens": _spec((B, 1), torch.int32),
        "cache": decoding.init_cache(cfg, B, shape.seq_len, ring=ring,
                                     kv_fmt=kv_fmt, device="meta"),
        "pos": _spec((), torch.int32),
    }


def cell_supported(cfg: ModelConfig, shape: ShapeConfig):
    """(supported, reason) for an (arch x shape) cell -- DESIGN.md §5 rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 524k-token decode cache is the "
                       "quadratic regime the assignment skips")
    return True, ""
