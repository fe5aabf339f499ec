"""Pack-once weight store: resident MXSF codes for serving.

PyTorch counterpart of the JAX package's ``core/packed_store.py``.
``pack_params`` walks a parameter tree (nested dicts of tensors) and
replaces every matmul weight leaf with a ``blocking.QuantizedTensor``
quantized ONCE: 1D row blocks ``(block_1d, 1)`` along the contraction dim
for inference policies, TxT tiles for training policies.  ``mx_dot`` then
consumes the resident codes directly.  Stacked (per-layer) leaves pack with
the block on the trailing dims, so a layer slice of the codes is that
layer's packed weight.

Sharded placement: ``packed_spec`` derives one partition spec for a packed
leaf's codes and scales (a dim splits only where its scale grid divides the
mesh axes), ``shard_block_aligned`` is the kernels' per-shard gate, and
``shard_leaf`` cuts the slice of a leaf (codes and scales together) that
one rank holds under a spec.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import blocking as B
from . import formats as F
from . import sharding as shd
from .policy import QuantPolicy

__all__ = ["PACKED_LEAF_NAMES", "packable_policy", "weight_block",
           "pack_params", "unpack_params", "pack_leaf", "pack_leaf_spec",
           "store_nbytes", "tree_map", "packed_spec", "shard_block_aligned",
           "shard_leaf"]

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


def pack_leaf_spec(shape, policy: QuantPolicy,
                   dtype) -> B.QuantizedTensor:
    """What ``pack_leaf`` makes of a weight of ``shape``, with ``meta``
    tensors for codes and scales: the block-padded codes, the block grid of
    scale bytes and the static MX metadata, and no weight drawn or
    quantized."""
    block = weight_block(policy)
    nb = len(block)
    lead, tail = tuple(shape[:-nb]), tuple(shape[-nb:])
    grid = tuple(-(-d // b) for d, b in zip(tail, block))
    # the codes' dtype is the codec's (uint8 for MXSF): read it off one block
    probe = B.quantize(torch.zeros(block), policy.fwd_fmt, block)
    meta = lambda s, dt: torch.empty(s, dtype=dt, device="meta")
    return B.QuantizedTensor(
        meta(lead + tuple(g * b for g, b in zip(grid, block)),
             probe.codes.dtype),
        meta(lead + grid, probe.scale_e8m0.dtype), policy.fwd_fmt,
        tuple(block), tuple(shape), B.dtype_name(B.torch_dtype(dtype)))


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


# ---------------------------------------------------------------------------
# sharding: packed-layout partition specs
# ---------------------------------------------------------------------------
#
# A QuantizedTensor must shard its uint8 codes and its E8M0 scale grid
# consistently: every rank needs the scale bytes of exactly the blocks
# whose codes it holds.  A mesh axis of size A may therefore split dim i
# only when the scale-grid extent of that dim divides A -- then each shard
# holds whole blocks.  Anything else is replicated, the same divisibility
# contract ``launch/mesh.py::MeshRules`` applies to f32 parameters.


def packed_spec(qt: B.QuantizedTensor, base_spec, mesh_axis_sizes) -> tuple:
    """The spec of a packed leaf, derived from the f32 rule ``base_spec``
    for its logical shape; ``mesh_axis_sizes`` maps axis name -> size.
    One spec for both codes and scales: a dim keeps its axes only when the
    scale grid (the padded extents, ``qt.scale_e8m0.shape``) divides
    them."""
    nd = qt.scale_e8m0.ndim
    spec = list(base_spec) + [None] * (nd - len(base_spec))
    out = []
    for dim in range(nd):
        entry = spec[dim]
        if entry is None:
            out.append(None)
            continue
        grid = qt.scale_e8m0.shape[dim]
        size = shd.axis_size(entry, mesh_axis_sizes)
        out.append(entry if size > 0 and grid % size == 0 else None)
    return tuple(out)


def shard_block_aligned(qt: B.QuantizedTensor, spec,
                        mesh_axis_sizes) -> bool:
    """Whether ``spec`` keeps whole MX blocks per shard: the kernel gate
    for a spec that did not come from ``packed_spec``."""
    for dim, entry in enumerate(tuple(spec)[: qt.scale_e8m0.ndim]):
        if entry is None:
            continue
        if qt.scale_e8m0.shape[dim] % shd.axis_size(entry,
                                                    mesh_axis_sizes):
            return False
    return True


def shard_leaf(leaf, spec, mesh, uneven=()):
    """This rank's slice of ``leaf`` (a tensor, or a QuantizedTensor whose
    codes and scales share ``spec``) on ``mesh``; views, no copy.  A
    packed slice's logical shape is the part of the logical extent it
    covers.  A tensor dim in ``uneven`` may split unevenly: a short slice
    is zero-padded to the rows every rank holds (a copy), as GSPMD pads
    the dim."""
    if not isinstance(leaf, B.QuantizedTensor):
        local = leaf[shd.shard_slices(leaf.shape, spec, mesh, uneven)]
        full = shd.shard_shape(leaf.shape, spec, mesh.shape, uneven)
        if tuple(local.shape) == full:
            return local
        out = local.new_zeros(full)
        out[tuple(slice(0, n) for n in local.shape)] = local
        return out
    spec = tuple(spec) + (None,) * (leaf.codes.ndim - len(spec))
    lead = leaf.codes.ndim - len(leaf.shape)  # a layer slice keeps no lead
    shape = tuple(
        shd.local_extent(n, p, e, mesh)
        for n, p, e in zip(leaf.shape, leaf.codes.shape[lead:],
                           spec[lead:]))
    return B.QuantizedTensor(
        leaf.codes[shd.shard_slices(leaf.codes.shape, spec, mesh)],
        leaf.scale_e8m0[shd.shard_slices(leaf.scale_e8m0.shape, spec,
                                         mesh)],
        leaf.fmt, tuple(leaf.block), shape, leaf.dtype)
