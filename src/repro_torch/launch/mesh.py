"""Meshes and the parameter / batch / cache sharding rules.

PyTorch counterpart of the JAX package's ``launch/mesh.py``.  The rules
(``MeshRules``, ``state_shardings``, ``batch_shardings``,
``cache_shardings``) are the JAX package's, line for line: pure functions
from shapes to specs (``core/sharding.py``), which the engine uses to
place each rank's slices.

Mesh axes:
  * single pod : (16, 16)    -> ("data", "model")
  * multi pod  : (2, 16, 16) -> ("pod", "data", "model")

Parallelism mapping:
  * DP   : batch over ("pod",) "data"
  * FSDP : parameters sharded over the DP axes on one dim, gathered at use
  * TP   : heads / ffn hidden / vocab over "model"
  * EP   : MoE expert dim over "model"
  * SP   : the KV cache's sequence dim, where batch and heads cannot split

A mesh lives on a ``torch.distributed`` process group that the caller
initialised (``nccl`` with one rank per card, ``gloo`` on the CPU or for
ranks that share a card); neither maker starts one.  A dry run traces one
rank of a mesh without any: ``make_production_mesh(trace_rank=r)`` (the
counterpart of the JAX package's 512 forced host devices), or
``make_tracing_mesh`` for any shape (``sharding.TracingMesh``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from ..core import packed_store
from ..core import sharding as shd
from ..core.blocking import QuantizedTensor
from ..core.sharding import (AbstractMesh, Mesh, NamedSharding, P,
                             TracingMesh)

__all__ = ["make_production_mesh", "make_tracing_mesh", "make_test_mesh",
           "make_mesh", "mesh_axes", "MESH_AXES", "MeshRules",
           "AbstractMesh", "Mesh", "TracingMesh", "state_shardings",
           "batch_shardings", "cache_shardings", "specs_by_name"]


def _world() -> int:
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group "
            "first ('nccl' with one rank per card, 'gloo' on the CPU)")
    return dist.get_world_size()


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
              device_type: Optional[str] = None) -> Mesh:
    """A mesh of ``shape`` over every rank of the process group (row-major:
    rank r sits at the coordinates of r).  ``device_type`` of the
    ``DeviceMesh``: ``"cuda"`` under nccl, else ``"cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = _world()
    if math.prod(shape) != n:
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} "
                         f"ranks; the process group has {n}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, tuple(shape),
                          mesh_dim_names=tuple(names))
    return Mesh(dict(zip(names, shape)), dm)


# a mesh's axis names by its number of axes: one pod, or across pods
MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def mesh_axes(shape: Tuple[int, ...]) -> Tuple[str, ...]:
    """The axis names of a mesh of ``shape`` (``MESH_AXES``)."""
    names = MESH_AXES.get(len(shape))
    if names is None:
        raise ValueError(f"mesh {tuple(shape)}: expected 2 axes (data, "
                         "model) or 3 (pod, data, model)")
    return names


def make_tracing_mesh(shape: Tuple[int, ...], rank: int = 0) -> Mesh:
    """The tracing mesh of rank ``rank`` of a ``shape`` mesh, which needs
    no process group (``sharding.TracingMesh``)."""
    return TracingMesh(tuple(shape), mesh_axes(shape), rank)


def make_production_mesh(*, multi_pod: bool = False,
                         trace_rank: Optional[int] = None) -> Mesh:
    """The production mesh, (16, 16) or (2, 16, 16) across two pods, over
    the process group's ranks; with ``trace_rank`` the tracing mesh of
    that one rank instead (``make_tracing_mesh``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    if trace_rank is not None:
        return make_tracing_mesh(shape, trace_rank)
    n = math.prod(shape)
    have = _world()
    if have < n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, have {have}")
    return make_mesh(shape, mesh_axes(shape))


def clamp_test_mesh(data: int, model: int, n: int) -> Tuple[int, int]:
    """``make_test_mesh``'s clamp: both axes to the rank count ``n``, the
    floor (1, 1)."""
    model = max(1, min(model, n))
    data = max(1, min(data, n // model))
    return data, model


def make_test_mesh(data: int = 2, model: int = 2) -> Mesh:
    """A small ("data", "model") mesh over the process group, both axes
    clamped to its rank count; the clamped mesh must cover every rank."""
    return make_mesh(clamp_test_mesh(data, model, _world()),
                     ("data", "model"))


class MeshRules:
    """Sharding rule oracle bound to one mesh."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.dp: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in mesh.axis_names)
        self.tp: Optional[str] = "model" if "model" in mesh.axis_names \
            else None
        self.dp_size = 1
        for a in self.dp:
            self.dp_size *= mesh.shape[a]
        self.tp_size = mesh.shape.get("model", 1)

    # -- helpers ---------------------------------------------------------
    def _dp(self, dim: int):
        return self.dp if self.dp and dim % self.dp_size == 0 else None

    def _tp(self, dim: int):
        return self.tp if self.tp and dim % self.tp_size == 0 else None

    def named(self, spec) -> NamedSharding:
        return NamedSharding(self.mesh, tuple(spec))

    # -- parameter rules -------------------------------------------------
    def param_spec(self, name: str, shape: Tuple[int, ...]) -> tuple:
        dims = len(shape)
        if dims <= 1:
            # norms/bias vectors: TP if they match a TP-sharded activation
            if dims == 1 and shape[0] >= 1024:
                return P(self._tp(shape[0]))
            return P()
        if name == "emb":          # (V, d)
            return P(self._tp(shape[0]), self._dp(shape[1]))
        if name == "head":         # (d, V)
            return P(self._dp(shape[0]), self._tp(shape[1]))
        if name in ("wq", "wk", "wv", "wg", "wu", "in_proj"):
            return P(self._dp(shape[0]), self._tp(shape[1]))
        if name in ("wo", "wd", "out_proj"):
            return P(self._tp(shape[0]), self._dp(shape[1]))
        if name == "router":       # (d, E): replicate E (small)
            return P(self._dp(shape[0]), None)
        if name in ("we_g", "we_u", "we_d"):  # (E, d|f, f|d): EP + FSDP
            return P(self.tp, self._dp(shape[1]), None)
        if name == "conv_w":
            return P(None, self._tp(shape[1]))
        if name == "pos":
            return P(None, None)
        return P(*([None] * dims))

    def packed_leaf_spec(self, name: str, qt: QuantizedTensor) -> tuple:
        """Spec of a pack-once store leaf: the f32 rule on the logical
        shape, filtered through ``packed_store.packed_spec`` (codes and
        scales split together, only where the scale grid divides)."""
        lead = len(qt.shape) - _base_rank(name)
        spec = self.param_spec(name, tuple(qt.shape[lead:]))
        base = P(*([None] * lead + list(spec)))
        return packed_store.packed_spec(qt, base, self.mesh.shape)

    def param_sharding_tree(self, params_shapes):
        """Param tree -> NamedSharding tree (layer-stack aware).  Takes
        trees of tensors (``meta`` ones included) and packed trees: a
        ``QuantizedTensor`` leaf maps to a QuantizedTensor carrying one
        NamedSharding for its codes and one for its scales."""

        def rule(path, leaf):
            name = next((k for k in reversed(path) if not k.isdigit()),
                        None)
            if isinstance(leaf, QuantizedTensor):
                ns = self.named(self.packed_leaf_spec(name, leaf))
                return QuantizedTensor(ns, ns, leaf.fmt, leaf.block,
                                       leaf.shape, leaf.dtype)
            shape = tuple(leaf.shape)
            lead = len(shape) - _base_rank(name)
            spec = self.param_spec(name, shape[lead:])
            ns = self.named(P(*([None] * lead + list(spec))))
            if name in _EXPERT_LEAVES:  # GSPMD pads an uneven expert dim
                ns = ns._replace(uneven=((lead, shape[lead]),))
            return ns

        return _map_with_path(rule, params_shapes)

    def shard_nbytes(self, tree, shardings=None) -> int:
        """Bytes one rank holds of ``tree`` (tensors, ``meta`` ones
        included, and packed leaves) placed by ``shardings`` (default:
        ``param_sharding_tree(tree)``): each leaf's local shape
        (``sharding.shard_shape``).  An uneven expert split counts the
        ceil(E / shards) rows every rank holds, zero rows included, so
        every rank holds the same bytes."""
        shardings = shardings or self.param_sharding_tree(tree)
        total = 0
        for leaf, ns in zip(packed_store.tree_leaves(tree),
                            packed_store.tree_leaves(shardings)):
            parts = ((leaf.codes, ns.codes), (leaf.scale_e8m0,
                                              ns.scale_e8m0)) \
                if isinstance(leaf, QuantizedTensor) else ((leaf, ns),)
            for t, n in parts:
                local = shd.shard_shape(t.shape, n.spec, self.mesh.shape,
                                        shd.uneven_dims(n))
                total += math.prod(local) * t.element_size()
        return total

    # -- activation/batch rules ------------------------------------------
    def data_spec(self, shape: Tuple[int, ...], batch_axis: int = 0) -> tuple:
        spec = [None] * len(shape)
        if shape[batch_axis] % self.dp_size == 0 and self.dp:
            spec[batch_axis] = self.dp
        return P(*spec)


_EXPERT_LEAVES = ("we_g", "we_u", "we_d")

_BASE_RANK = {
    "emb": 2, "head": 2, "wq": 2, "wk": 2, "wv": 2, "wo": 2, "wg": 2,
    "wu": 2, "wd": 2, "in_proj": 2, "out_proj": 2, "router": 2,
    "we_g": 3, "we_u": 3, "we_d": 3, "conv_w": 2, "pos": 2, "cls": 3,
    "w": 1, "b": 1, "bq": 1, "bk": 1, "bv": 1, "A_log": 1, "D": 1,
    "dt_bias": 1, "norm_w": 1, "conv_b": 1,
}


def _base_rank(name: str) -> int:
    return _BASE_RANK.get(name, 0)


def specs_by_name(store, shardings, path=()) -> dict:
    """``{leaf name: (stored spec, logical shape)}`` of each leaf's base
    dims (the stacked-layer dims are never split): what ``blocks.use``
    reads.  An MoE shared expert's leaves are filed as ``shared/<name>``,
    apart from a dense FFN's of the same names, and an encoder-decoder's
    cross-attention leaves (values, where the self-attention's are packed)
    as ``cross/<name>``; every leaf of a name must share them."""
    out = {}
    if isinstance(store, dict):
        for k in store:
            for name, got in specs_by_name(store[k], shardings[k],
                                           path + (k,)).items():
                if out.setdefault(name, got) != got:
                    raise NotImplementedError(
                        f"leaves named {name!r} differ in shape or spec: "
                        f"{out[name]} vs {got}")
        return out
    r = _base_rank(path[-1])
    if r == 0:
        return out
    ns = shardings.codes if isinstance(shardings, QuantizedTensor) \
        else shardings
    spec = tuple(ns.spec)
    spec += (None,) * (len(store.shape) - len(spec))
    parent = path[-2] if len(path) > 1 else None
    name = f"{parent}/{path[-1]}" if parent in _FILED_APART else path[-1]
    return {name: (spec[-r:], tuple(store.shape[-r:]))}


_FILED_APART = ("shared", "cross")


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (keys as
    strings, indices as digits); tensors and QuantizedTensors are leaves."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def state_shardings(rules: MeshRules, state_shapes):
    """Shardings for {'params','opt'} train state (moments follow params)."""
    out = {"params": rules.param_sharding_tree(state_shapes["params"])}
    if "opt" in state_shapes:
        out["opt"] = {
            "m": rules.param_sharding_tree(state_shapes["opt"]["m"]),
            "v": rules.param_sharding_tree(state_shapes["opt"]["v"]),
            "step": rules.named(P()),
        }
        if "master" in state_shapes["opt"]:
            out["opt"]["master"] = rules.param_sharding_tree(
                state_shapes["opt"]["master"])
    return out


def batch_shardings(rules: MeshRules, batch_shapes):
    """Token/label/frontend batches: dim 0 (global batch) over DP."""
    return _map_with_path(
        lambda _, s: rules.named(rules.data_spec(tuple(s.shape))),
        batch_shapes)


def cache_shardings(rules: MeshRules, cache_shapes, batch_size: int):
    """KV/state caches.  The batch dim goes over DP when divisible;
    otherwise the sequence/window dim of attention caches goes over DP
    (sequence parallelism) and SSM states shard their head dim over TP.
    KV heads go over TP when divisible, else the cache length does."""

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        name = path[-1] if path else ""
        if name in ("k_codes", "v_codes", "k_scales", "v_scales"):
            name = "k"  # packed codes and scales shard like the kv tensor
        spec = [None] * len(shape)
        if name in ("k", "v"):
            # (..., B, W, kv, dh)
            b_ax, w_ax, kv_ax = len(shape) - 4, len(shape) - 3, len(shape) - 2
            w_axes = []
            if batch_size % rules.dp_size == 0 and rules.dp:
                spec[b_ax] = rules.dp
            elif shape[w_ax] % rules.dp_size == 0 and rules.dp:
                w_axes += list(rules.dp)  # SP over the cache sequence
            if rules.tp and shape[kv_ax] % rules.tp_size == 0:
                spec[kv_ax] = rules.tp
            elif rules.tp and shape[w_ax] % (rules.tp_size or 1) == 0:
                w_axes.append(rules.tp)
            if w_axes:
                spec[w_ax] = tuple(w_axes)
        elif name in ("state", "conv"):
            # state: (..., B, G, Hg, P, N) / conv: (..., B, K-1, C)
            nb = 5 if name == "state" else 3
            b_ax = len(shape) - nb
            if batch_size % rules.dp_size == 0 and rules.dp:
                spec[b_ax] = rules.dp
            if name == "state" and rules.tp:
                hg_ax = len(shape) - 3
                if shape[hg_ax] % rules.tp_size == 0:
                    spec[hg_ax] = rules.tp
            if name == "conv" and rules.tp:
                c_ax = len(shape) - 1
                if shape[c_ax] % rules.tp_size == 0:
                    spec[c_ax] = rules.tp
        return rules.named(P(*spec))

    return _map_with_path(rule, cache_shapes)
