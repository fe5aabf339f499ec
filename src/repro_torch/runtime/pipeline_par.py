"""GPipe-style pipeline parallelism over one mesh axis.

PyTorch counterpart of the JAX package's ``runtime/pipeline_par.py``:
layers split into S contiguous stages, one per index of ``stage_axis``; a
stream of M microbatches flows stage to stage, M + S - 1 ticks in all, so
the bubble is the classic (S - 1) / (S - 1 + M).  Where the JAX package
hands activations on with ``ppermute`` inside ``shard_map``, each rank
here runs its own stage and passes its output to the next stage's rank
with ``torch.distributed.batch_isend_irecv``; the last stage's outputs
are then broadcast over the axis, so every rank returns them.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core import sharding as shd

__all__ = ["pipeline_apply"]


def _stage(tree, s: int, n_stages: int):
    """This rank's stage of a tree stacked on a leading stage dim: (S, ...)
    holds every stage, (1, ...) only this rank's (as a ``shard_map`` body
    sees it)."""
    if isinstance(tree, dict):
        return {k: _stage(v, s, n_stages) for k, v in tree.items()}
    if tree.shape[0] == n_stages:
        return tree[s]
    if tree.shape[0] == 1:
        return tree[0]
    raise ValueError(f"stage params lead with {tree.shape[0]}, expected "
                     f"{n_stages} or 1")


def pipeline_apply(mesh, stage_axis: str, layer_fn: Callable,
                   stage_params, x_microbatches: torch.Tensor):
    """Run ``layer_fn(params, x) -> x`` (shape-preserving) as a GPipe
    pipeline over ``stage_axis`` of ``mesh``.

    stage_params   : a tree stacked on a leading stage dim (see ``_stage``);
                     this rank runs stage ``mesh.coord(stage_axis)``.
    x_microbatches : (M, mb, ...) on every rank; stage 0 ingests them.
    Returns the (M, mb, ...) outputs after all S stages, on every rank."""
    import torch.distributed as dist
    S, s = mesh.shape[stage_axis], mesh.coord(stage_axis)
    M = x_microbatches.shape[0]
    local = _stage(stage_params, s, S)
    group = mesh.group(stage_axis) if S > 1 else None
    peer = (lambda i: dist.get_global_rank(group, i)) if S > 1 else None
    outs = torch.zeros_like(x_microbatches)
    buf = torch.zeros_like(x_microbatches[0])
    sends = []
    for t in range(M + S - 1):
        m = t - s  # the microbatch this stage holds at tick t
        if not 0 <= m < M:
            continue
        if s == 0:
            x_in = x_microbatches[m]
        else:
            for req in dist.batch_isend_irecv(
                    [dist.P2POp(dist.irecv, buf, peer(s - 1), group)]):
                req.wait()
            x_in = buf.clone()
        y = layer_fn(local, x_in).contiguous()
        if s < S - 1:  # y stays referenced until its send completes
            sends.append((y, dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, y, peer(s + 1), group)])))
        else:
            outs[m] = y
    for _, reqs in sends:
        for req in reqs:
            req.wait()
    return shd.broadcast(outs, stage_axis, S - 1, mesh)
