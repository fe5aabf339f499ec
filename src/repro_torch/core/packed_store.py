"""Pack-once weight store: resident MXSF codes for serving.

PyTorch counterpart of the JAX package's ``core/packed_store.py``.
``pack_params`` walks a parameter tree (nested dicts of tensors) and
replaces every matmul weight leaf with a ``blocking.QuantizedTensor``
quantized ONCE: 1D row blocks ``(block_1d, 1)`` along the contraction dim
for inference policies, TxT tiles for training policies.  ``mx_dot`` then
consumes the resident codes directly.  Stacked (per-layer) leaves pack with
the block on the trailing dims, so a layer slice of the codes is that
layer's packed weight.

Sharded placement (``packed_spec``, ``shard_block_aligned``) waits for the
multi-GPU slice (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import blocking as B
from . import formats as F
from .policy import QuantPolicy

__all__ = ["PACKED_LEAF_NAMES", "packable_policy", "weight_block",
           "pack_params", "unpack_params", "pack_leaf", "store_nbytes",
           "tree_map"]

# dict keys of matmul-weight leaves; each is consumed through
# blocks.dense -> mx_dot
PACKED_LEAF_NAMES = frozenset({
    "wq", "wk", "wv", "wo",           # attention projections
    "wg", "wu", "wd",                 # MLP (and MoE shared-expert MLP)
    "in_proj", "out_proj",            # SSD / Mamba2 projections
    "head",                           # LM / classifier head
})


def tree_map(fn, *trees):
    """Apply ``fn`` to the leaves (tensors or QuantizedTensors) of dict trees
    of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """Leaves in sorted-key order, as ``jax.tree.leaves`` visits a dict."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def packable_policy(policy: QuantPolicy) -> bool:
    """Whether this policy has a packed form at all: quantization enabled
    AND a real element format (bf16 passthrough has no codes)."""
    return policy.enabled and F.get_format(policy.fwd_fmt).kind != "none"


def weight_block(policy: QuantPolicy) -> Tuple[int, int]:
    """The weight-side block the kernels consume (see mx_dot._pol_blocks)."""
    if policy.block_mode == "2d":
        return (policy.tile, policy.tile)
    return (policy.block_1d, 1)


def pack_leaf(w: torch.Tensor, policy: QuantPolicy,
              dtype=None) -> B.QuantizedTensor:
    """Quantize one weight leaf into the policy's resident layout.

    ``dtype`` is the cast-at-use compute dtype (``blocks.dense`` casts f32
    master weights to the activation dtype before quantizing); packing
    through the same cast keeps packed and per-call quantization
    bit-identical."""
    if dtype is not None:
        w = w.to(B.torch_dtype(dtype))
    return B.quantize(w, policy.fwd_fmt, weight_block(policy))


def _packable(leaf) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
            and leaf.numel() > 0)


def pack_params(params, policy: QuantPolicy, dtype=None,
                names=PACKED_LEAF_NAMES, exclude: Tuple[str, ...] = ()):
    """Quantize the whole weight tree once (idempotent on packed leaves).

    ``exclude`` names dict subtrees to leave in values."""
    if not packable_policy(policy):
        return params

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for key, val in node.items():
            if key in exclude:
                out[key] = val
            elif isinstance(val, dict):
                out[key] = walk(val)
            elif key in names and _packable(val):
                out[key] = pack_leaf(val, policy, dtype)
            else:
                out[key] = val
        return out

    return walk(params)


def unpack_params(params):
    """Dequantize every packed leaf back to values (tests / offline tools;
    the serving path never calls this)."""
    return tree_map(lambda leaf: B.dequantize(leaf)
                    if isinstance(leaf, B.QuantizedTensor) else leaf, params)


def store_nbytes(params) -> dict:
    """Memory accounting for a (possibly packed) parameter tree: bytes of
    packed leaves, of value leaves, the total, and what the packed leaves
    would cost in f32 and bf16."""
    packed = value = f32 = bf16 = 0
    for leaf in tree_leaves(params):
        if isinstance(leaf, B.QuantizedTensor):
            packed += leaf.nbytes_packed()
            n = math.prod(leaf.shape)
            f32 += n * 4
            bf16 += n * 2
        else:
            value += leaf.numel() * leaf.element_size()
    return {"packed": packed, "value": value, "total": packed + value,
            "value_f32": f32, "value_bf16": bf16}
