"""Meshes, partition specs, sharding roles and the collectives they imply.

PyTorch counterpart of the JAX package's ``core/sharding.py``.  There is
no GSPMD in eager PyTorch, so where the JAX package constrains a global
array and lets the compiler place collectives, the port runs one process
per device, each holding its local slices, and the model code calls the
collectives itself (``all_reduce``, ``all_gather``) over a named mesh
axis.  Outside a ``mesh_context`` every collective is a no-op and
``spec_for`` returns None, so every one-device path is unchanged.

* ``Mesh`` -- named axes over the ranks of the default process group, on
  a ``torch.distributed.device_mesh.DeviceMesh`` (one group per axis,
  ``DeviceMesh.get_group(name)``); without a device mesh it only carries
  the axis sizes (``AbstractMesh``: spec rules, no collectives); with
  given coordinates and no process group it traces one rank
  (``TracingMesh``: every collective returns an output of the right
  shape and is recorded, and nothing is sent -- a dry run's mesh on
  ``meta`` tensors).  Rank r sits at the row-major coordinates of r, as
  ``launch/mesh.make_mesh`` lays a device mesh out.
* Specs are tuples of ``None | str | tuple[str, ...]``, one entry per
  dim, as ``jax.sharding.PartitionSpec``; ``NamedSharding`` pairs one with
  its mesh.  ``normalize`` compares two specs as JAX does (``("data",)``
  is ``"data"``, trailing ``None`` dims drop).
* ``shard_slices`` / ``local_extent``: which slice of a dim a rank holds
  (a tuple of axes splits major to minor, as in JAX).  A dim that
  ``NamedSharding.uneven`` names may split unevenly, as GSPMD pads it:
  each rank holds ``c = ceil(n / shards)`` rows, ``[i c, min((i+1) c,
  n))``, and zero rows past the end (``shard_shape``).
* Roles (``spec_for``): 'batch' -> DP axes; 'heads'/'kv'/'experts'/'ff'/
  'hidden'/'seq'/'vocab' -> the TP axis, divisibility-guarded.
* ``counts()`` -- collectives issued since ``reset_counts()``, by kind,
  with their host seconds, operand bytes (the local tensor each call is
  handed) and a breakdown by mesh axis; a real rank and a trace of it
  count alike.  ``add_sink`` registers a callback that sees each call
  (``launch/cost.count``).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import time
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .blocking import QuantizedTensor

__all__ = ["Mesh", "AbstractMesh", "TracingMesh", "NamedSharding", "P", "normalize",
           "axes_of", "mesh_context", "active", "spec_for", "all_reduce",
           "all_gather", "broadcast", "counts", "reset_counts",
           "per_device_nbytes", "shard_slices", "shard_shape",
           "uneven_dims", "local_extent", "to_compute", "map_parts",
           "axis_size", "shard_index", "TP_ROLES", "add_sink",
           "remove_sink"]

_CTX: contextvars.ContextVar = contextvars.ContextVar("mx_mesh_ctx",
                                                      default=None)

TP_ROLES = ("heads", "kv", "experts", "ff", "hidden", "seq", "vocab")


# ---------------------------------------------------------------------------
# meshes and specs
# ---------------------------------------------------------------------------

class Mesh:
    """Named mesh axes (``shape``: name -> size, in mesh order) and, when
    ``device_mesh`` is given, this rank's coordinate and process group on
    each axis; when ``coords`` is given instead (axis name -> index), the
    coordinates of the one rank a trace stands for."""

    def __init__(self, shape, device_mesh=None, coords=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.device_mesh = device_mesh
        self.coords = None if coords is None else dict(coords)

    def __repr__(self):
        if self.coords is not None:
            return f"TracingMesh({self.shape}, rank {self.rank})"
        return f"Mesh({self.shape})"

    @property
    def tracing(self) -> bool:
        """A tracing mesh: coordinates, no process group."""
        return self.coords is not None

    @property
    def rank(self) -> int:
        """This rank's row-major index (0 on an abstract mesh)."""
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + self.coord(a)
        return r

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 on an abstract mesh)."""
        if self.coords is not None:
            return self.coords[axis]
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        if self.device_mesh is None:
            raise RuntimeError(f"{self} has no process groups (make one "
                               "with launch.mesh.make_test_mesh inside a "
                               "process group)")
        return self.device_mesh.get_group(axis)


def AbstractMesh(sizes: Sequence[int], names: Sequence[str]) -> Mesh:
    """Axis sizes only (the JAX package's ``AbstractMesh``): the spec
    rules run on it; collectives do not."""
    return Mesh(dict(zip(names, sizes)))


def TracingMesh(sizes: Sequence[int], names: Sequence[str],
                rank: int = 0) -> Mesh:
    """The mesh one rank of a ``sizes`` mesh sees, with no process group:
    rank ``rank`` at its row-major coordinates.  Collectives on it return
    outputs of the shape a real group would and are recorded, so a trace
    on ``meta`` tensors counts what that rank would send."""
    n = math.prod(sizes)
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} is not on a mesh of {n} ranks")
    coords, r = {}, rank
    for name, size in reversed(list(zip(names, sizes))):
        coords[name] = r % size
        r //= size
    return Mesh(dict(zip(names, sizes)), coords=coords)


class NamedSharding(NamedTuple):
    """A spec on a mesh; ``uneven`` holds a ``(dim, logical extent)`` pair
    for each dim that may split unevenly (the MoE expert dim)."""
    mesh: Mesh
    spec: tuple
    uneven: Tuple[Tuple[int, int], ...] = ()


def uneven_dims(ns) -> Tuple[int, ...]:
    """The dims a sharding lets split unevenly (none for a QuantizedTensor
    of shardings: packed leaves split only where their blocks divide)."""
    return tuple(d for d, _ in getattr(ns, "uneven", ()))


def P(*entries) -> tuple:
    return tuple(entries)


def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None -> ())."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def normalize(spec) -> tuple:
    """A spec as JAX compares it: one-axis tuples as the axis name, empty
    tuples as None, trailing None dims dropped."""
    out = []
    for e in tuple(spec):
        ax = axes_of(e)
        out.append(None if not ax else ax[0] if len(ax) == 1 else ax)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def axis_size(entry, sizes) -> int:
    return math.prod(sizes[a] for a in axes_of(entry))


def shard_index(entry, mesh: Mesh) -> int:
    """This rank's shard index along a dim split over ``entry``'s axes,
    the first axis major."""
    idx = 0
    for a in axes_of(entry):
        idx = idx * mesh.shape[a] + mesh.coord(a)
    return idx


def _extent(dim: int, n: int, d: int, uneven) -> int:
    """Rows each of ``n`` shards holds of dim ``d`` (extent ``dim``)."""
    if dim % n == 0:
        return dim // n
    if d in uneven:
        return -(-dim // n)
    raise ValueError(f"dim {d} of extent {dim} does not split {n} ways")


def shard_slices(shape, spec, mesh: Mesh, uneven=()) -> Tuple[slice, ...]:
    """The slice of each dim of a ``shape`` array that this rank holds
    under ``spec``.  A split dim divides its axes evenly (the rules
    guarantee it), except the dims in ``uneven``: there the slice of a
    rank near the end is short, or empty."""
    out = []
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for d, (dim, entry) in enumerate(zip(shape, spec)):
        c = _extent(dim, axis_size(entry, mesh.shape), d, uneven)
        i = shard_index(entry, mesh)
        out.append(slice(min(i * c, dim), min((i + 1) * c, dim)))
    return tuple(out)


def shard_shape(shape, spec, sizes, uneven=()) -> Tuple[int, ...]:
    """The shape of one rank's slice of a ``shape`` array under ``spec``
    (``sizes``: axis name -> size), zero rows of an uneven dim
    included: every rank holds the same shape."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(_extent(dim, axis_size(entry, sizes), d, uneven)
                 for d, (dim, entry) in enumerate(zip(shape, spec)))


def local_extent(logical: int, padded: int, entry, mesh: Mesh) -> int:
    """The logical extent of this rank's shard of a dim whose storage is
    ``padded`` long (block padding sits at the end of the dim, so only the
    last shards are short)."""
    n = axis_size(entry, mesh.shape)
    c = padded // n
    return max(0, min(logical - shard_index(entry, mesh) * c, c))


# ---------------------------------------------------------------------------
# the role context
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def mesh_context(mesh: Mesh, dp: Tuple[str, ...], tp: Optional[str],
                 **layout):
    """Activate ``mesh`` for the model code: roles resolve to its axes and
    the collectives run over its groups.  ``layout`` carries what a caller
    placed (the engine: the stored spec of each leaf by name, the cache's
    position-axis split), read by ``models/blocks.py``."""
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    ctx = {"mesh": mesh, "dp": tuple(dp), "tp": tp, "dp_size": dp_size,
           "tp_size": mesh.shape.get(tp, 1) if tp else 1, **layout}
    tok = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(tok)


def active() -> Optional[dict]:
    return _CTX.get()


def spec_for(shape: Sequence[int], roles: Sequence[Optional[str]],
             allow_uneven: Sequence[str] = ("experts",)) -> Optional[tuple]:
    """A spec from per-dim roles; None when no context."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    spec = []
    for dim, role in zip(shape, roles):
        if role == "batch" and ctx["dp"] and dim % ctx["dp_size"] == 0:
            spec.append(ctx["dp"])
        else:
            spec.append(None)
    if ctx["tp"]:
        for i, (dim, role) in enumerate(zip(shape, roles)):
            if spec[i] is not None or role not in TP_ROLES:
                continue
            if dim % ctx["tp_size"] == 0 or role in allow_uneven:
                spec[i] = ctx["tp"]
                break
    return tuple(spec)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

_COUNTS: dict = {}
_SINKS: list = []


def reset_counts():
    _COUNTS.clear()


def counts() -> dict:
    """``{kind: {"calls": n, "seconds": host s, "bytes": operand bytes,
    "axes": {axis: {"calls", "bytes", "size"}}}}`` since ``reset_counts``
    (host seconds include the wait; on the card a synchronising
    collective's wait is the device work queued before it; a traced call
    takes none).  The operand is the local tensor a call is handed; an
    all-gather over several axes is one call per axis of size > 1, minor
    axis first, each handed what the one before gathered."""
    return {k: dict(v, axes={a: dict(c) for a, c in v["axes"].items()})
            for k, v in _COUNTS.items()}


def add_sink(fn):
    """Call ``fn(kind, axis, size, nbytes)`` on every collective issued
    from now on (real or traced) until ``remove_sink(fn)``."""
    _SINKS.append(fn)


def remove_sink(fn):
    _SINKS.remove(fn)


def _record(kind: str, t0: float, axis: str, size: int, t: torch.Tensor):
    nbytes = t.numel() * t.element_size()
    c = _COUNTS.setdefault(kind, {"calls": 0, "seconds": 0.0, "bytes": 0,
                                  "axes": {}})
    c["calls"] += 1
    c["seconds"] += time.perf_counter() - t0
    c["bytes"] += nbytes
    a = c["axes"].setdefault(axis, {"calls": 0, "bytes": 0, "size": size})
    a["calls"] += 1
    a["bytes"] += nbytes
    for fn in _SINKS:
        fn(kind, axis, size, nbytes)


def _traced(mesh: Mesh, t: torch.Tensor, kind: str) -> bool:
    """Whether ``mesh`` is a tracing mesh.  It sends nothing, so it takes
    only ``meta`` tensors: a real one would come back unsummed or gathered
    from empty parts."""
    if not mesh.tracing:
        return False
    if t.device.type != "meta":
        raise RuntimeError(f"{kind} on {mesh}: a tracing mesh takes only "
                           f"meta tensors, not one on {t.device}")
    return True


def _run(op, t: torch.Tensor, group, out=None):
    """Run ``op(t, group)`` (in place on ``t``, or into ``out``).  gloo
    keeps two ranks on one card: a CUDA tensor goes through host memory
    there, and only there."""
    import torch.distributed as dist
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        res = op(host, group)
        if res is None:
            t.copy_(host)
            return None
        return [r.to(t.device) for r in res]
    return op(t, group)


def all_reduce(x: torch.Tensor, axis: Optional[str] = None,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum of ``x`` over ``axis`` (default: the context's TP axis), issued
    whatever the axis size (a one-rank sum is the identity).  No-op
    outside a context when no mesh is given; on a tracing mesh (``meta``
    tensors only) ``x`` itself (the sum's shape), recorded."""
    import torch.distributed as dist
    ctx = _CTX.get()
    mesh = mesh or (ctx["mesh"] if ctx else None)
    axis = axis or (ctx["tp"] if ctx else None)
    if mesh is None or axis is None:
        return x
    t0 = time.perf_counter()
    x = x.contiguous()
    if not _traced(mesh, x, "all_reduce"):
        _run(lambda t, g: dist.all_reduce(t, group=g), x, mesh.group(axis))
    _record("all_reduce", t0, axis, mesh.shape[axis], x)
    return x


def all_gather(x: torch.Tensor, axes, dim: int,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Concatenate the shards of ``x`` along ``dim`` over ``axes`` (one
    axis name or a tuple, major to minor, as in a spec).  Axes of size 1
    hold the whole dim and are skipped; no-op outside a context when no
    mesh is given.  On a tracing mesh (``meta`` tensors only) each part is
    an empty tensor of the shard's shape (what a real rank receives into), concatenated."""
    import torch.distributed as dist
    ctx = _CTX.get()
    mesh = mesh or (ctx["mesh"] if ctx else None)
    if mesh is None:
        return x
    for axis in reversed(axes_of(axes)):  # minor axis first
        n = mesh.shape[axis]
        if n == 1:
            continue
        t0 = time.perf_counter()

        def gather(t, g):
            parts = [torch.empty_like(t) for _ in range(n)]
            if g is not None:
                dist.all_gather(parts, t, group=g)
            return parts

        src = x.contiguous()
        parts = (gather(src, None) if _traced(mesh, src, "all_gather")
                 else _run(gather, src, mesh.group(axis)))
        x = torch.cat(parts, dim=dim)
        _record("all_gather", t0, axis, n, src)
    return x


def broadcast(x: torch.Tensor, axis: str, src: int,
              mesh: Mesh) -> torch.Tensor:
    """``x`` of the rank at index ``src`` along ``axis``, on every rank of
    the axis (in place; on a tracing mesh, ``meta`` tensors only, ``x``
    itself, recorded)."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    x = x.contiguous()
    if not _traced(mesh, x, "broadcast"):
        group = mesh.group(axis)
        root = dist.get_global_rank(group, src)
        _run(lambda t, g: dist.broadcast(t, src=root, group=g), x, group)
    _record("broadcast", t0, axis, mesh.shape[axis], x)
    return x


def map_parts(leaf, fn):
    """``fn`` on a tensor, or on a packed leaf's codes and scales alike."""
    if isinstance(leaf, QuantizedTensor):
        return dataclasses.replace(leaf, codes=fn(leaf.codes),
                                   scale_e8m0=fn(leaf.scale_e8m0))
    return fn(leaf)


def to_compute(leaf, spec, shape, split: Optional[int]):
    """A rank's slice ``leaf`` of a leaf of logical ``shape`` stored under
    ``spec``, in the layout the tensor-parallel scheme computes with:
    every dim the spec splits is gathered, except ``split`` where the spec
    splits it over the TP axis alone; ``split`` is cut to this rank's TP
    slice where the spec does not split it so.  A packed leaf moves whole
    blocks, codes and scales together, so every step is exact."""
    ctx = _CTX.get()
    mesh, tp = ctx["mesh"], ctx["tp"]
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for d, entry in enumerate(spec):
        if axes_of(entry) and not (d == split and axes_of(entry) == (tp,)):
            leaf = map_parts(leaf, lambda t: all_gather(t, entry, d))
    if split is not None and axes_of(spec[split]) != (tp,):
        n, i = mesh.shape[tp], mesh.coord(tp)
        leaf = map_parts(leaf, lambda t: t.narrow(
            split, i * (t.shape[split] // n), t.shape[split] // n))
    if isinstance(leaf, QuantizedTensor):
        logical = list(shape)
        if split is not None:
            logical[split] = local_extent(
                shape[split], leaf.codes.shape[split] * mesh.shape[tp], tp,
                mesh)
        leaf = dataclasses.replace(leaf, shape=tuple(logical))
    return leaf


def per_device_nbytes(tree, device=None, mesh: Optional[Mesh] = None) -> dict:
    """Bytes resident per device of a tree of live tensors (packed leaves:
    codes and scales), ``{device: bytes}``.  With a ``mesh`` every rank's
    bytes are gathered (a collective: every rank calls it), keyed
    ``rank<r>:<device>``; a replicated leaf counts full-size on each rank,
    as the JAX package counts it per device.  A tracing mesh has only its
    own rank to report."""
    import torch.distributed as dist
    from .packed_store import tree_leaves
    total, dev = 0, device
    for leaf in tree_leaves(tree):
        for t in ((leaf.codes, leaf.scale_e8m0)
                  if isinstance(leaf, QuantizedTensor) else (leaf,)):
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
                dev = dev if dev is not None else t.device
    dev = str(dev if dev is not None else "cpu")
    if mesh is not None and mesh.tracing:
        return {f"rank{mesh.rank}:{dev}": total}
    if mesh is None or mesh.device_mesh is None:
        return {dev: total}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (dist.get_rank(), dev, total))
    return {f"rank{r}:{d}": n for r, d, n in every}
