"""MXSF-compressed data-parallel gradient reduction.

PyTorch counterpart of the JAX package's ``runtime/compress.py``.  The MXSF
format is a natural wire format for the DP gradient all-reduce: each rank
quantizes its gradient to MXSF (8-bit codes + one E8M0 byte per block of
64, ~8.1 bits an element against 32), the quantized values are summed, and
the sum is divided by the rank count.  As in the JAX package the sum runs
on the dequantized values (no collective sums 8-bit MX codes), so the
numerics of the compressed collective are exact and the traffic saving is
modeled (``wire_bytes``).

Each rank's local tree takes the place of one shard of the JAX package's
``shard_map``: ``make_compressed_allreduce(mesh, axis)`` returns
``reduce(tree) -> (tree, stats)``, the mean over ``axis`` of every rank's
``blocking.qdq`` of each leaf (flattened, blocks of 64), on every rank.
"""
from __future__ import annotations

import torch

from ..core import blocking as B
from ..core import sharding as shd
from ..core.packed_store import tree_leaves, tree_map

__all__ = ["compressed_psum", "make_compressed_allreduce", "wire_bytes"]


def compressed_psum(x: torch.Tensor, axis: str, fmt: str = "mxsf",
                    block: int = 64, mesh=None) -> torch.Tensor:
    """Sum over ``axis`` with an 8-bit MX wire format: each rank's ``x``
    quantized along its last dim in blocks of ``block``, then summed
    (``mesh``: default the active context's)."""
    if x.ndim == 0 or x.shape[-1] < 2:
        return shd.all_reduce(x.clone(), axis, mesh)
    return shd.all_reduce(B.qdq(x, fmt, (block,)), axis, mesh)


def wire_bytes(x: torch.Tensor, fmt: str = "mxsf", block: int = 64) -> int:
    """Modeled on-wire payload of one rank's ``x`` (vs 4 * size in f32):
    1 byte a code plus 1 scale byte a block."""
    if fmt == "none":
        return x.numel() * x.element_size()
    return x.numel() + -(-x.numel() // block)


def make_compressed_allreduce(mesh, axis: str = "data", fmt: str = "mxsf",
                              block: int = 64):
    """``reduce(tree) -> (tree, stats)``: the MXSF-compressed mean of every
    leaf over ``axis`` (the DP gradient aggregation), and the modeled
    bytes each rank puts on the wire, compressed and in f32."""
    n = mesh.shape[axis]

    def reduce_leaf(g):
        flat = g.reshape(-1).float()
        return (compressed_psum(flat, axis, fmt, block, mesh) / n
                ).reshape(g.shape).to(g.dtype)

    def reduce_tree(grads):
        leaves = list(tree_leaves(grads))
        stats = {
            "wire_bytes_compressed": sum(wire_bytes(g, fmt, block)
                                         for g in leaves),
            "wire_bytes_f32": sum(4 * g.numel() for g in leaves),
        }
        return tree_map(reduce_leaf, grads), stats

    return reduce_tree
