"""AdamW + schedules, plain PyTorch.

PyTorch counterpart of the JAX package's ``optim/adamw.py``, with the same
arithmetic in f32.  One difference: ``apply_updates`` writes the new
parameters, moments and master weights into the given tensors in place
(the JAX version returns new trees), so a step never holds two copies of
the parameters and moments -- at full width of h2o-danube-1.8b that is
~22 GB saved.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import torch

from ..core import sharding as shd
from ..core.packed_store import tree_leaves, tree_map

__all__ = ["OptConfig", "init_opt_state", "apply_updates", "lr_at",
           "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"         # 'cosine' | 'constant'
    moment_dtype: str = "float32"    # 'bfloat16' halves optimizer memory
    # keep f32 master weights when params are stored in bf16
    master_weights: bool = False

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_opt_state(params, cfg: OptConfig):
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    some = next(tree_leaves(params))
    state = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
             "step": torch.zeros((), dtype=torch.int32, device=some.device)}
    if cfg.master_weights:
        state["master"] = tree_map(lambda p: p.float().clone(), params)
    return state


def lr_at(step, cfg: OptConfig) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


def global_norm(tree, shardings=None) -> torch.Tensor:
    """The L2 norm of every leaf together.  With ``shardings`` (a tree of
    ``sharding.NamedSharding``: ``tree`` holds this rank's slices) each
    leaf's sum of squares is summed over the axes of size > 1 its spec
    splits, so every element counts once and every rank holds one
    device's norm: the leaves are grouped by those axes, in order, and
    each group's sum all-reduced over each of them.  On a mesh of one
    rank that is one device's sum, term for term.  The zero rows an
    uneven split pads (the MoE expert dim) add nothing: the norm is one
    device's there too."""
    if shardings is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree_leaves(tree)))
    groups: dict = {}
    for x, ns in zip(tree_leaves(tree), tree_leaves(shardings)):
        split = set(shd.split_axes(ns.spec, ns.mesh.shape))
        key = tuple(a for a in ns.mesh.axis_names if a in split)
        sq = torch.sum(torch.square(x.float()))
        groups[key] = (ns.mesh, sq if key not in groups
                       else groups[key][1] + sq)
    total = None
    for key, (mesh, sq) in groups.items():
        for axis in key:
            sq = shd.all_reduce(sq, axis, mesh)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptConfig, shardings=None):
    """One AdamW step, in place.  Returns (params, state, metrics): the same
    trees, updated.  ``shardings`` (the params' NamedSharding tree, on a
    mesh): the trees hold this rank's slices; every update is
    elementwise, and only the clip's global norm sums over the mesh
    (``global_norm``)."""
    step = state["step"] + 1
    lr = lr_at(state["step"], cfg)
    gnorm = global_norm(grads, shardings)
    scale = (None if cfg.clip_norm is None else
             torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0))
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    masters = state.get("master")
    flat = zip(tree_leaves(params), tree_leaves(grads),
               tree_leaves(state["m"]), tree_leaves(state["v"]),
               tree_leaves(masters) if masters is not None
               else itertools.repeat(None))
    for p, g, m, v, master in flat:
        if scale is not None:  # clip_by_global_norm, leaf by leaf
            g = (g.float() * scale).to(g.dtype)
        g32 = g.float()
        m32 = m.float() * b1 + (1 - b1) * g32
        v32 = v.float() * b2 + (1 - b2) * g32 * g32
        mhat = m32 / c1
        vhat = v32 / c2
        base = master if master is not None else p.float()
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * base
        new_master = base - lr * delta
        p.copy_(new_master)
        m.copy_(m32)
        v.copy_(v32)
        if master is not None:
            master.copy_(new_master)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
