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
* Adjoints: a collective that autograd passes through states what its
  backward is, at each call site, since that depends on whether its
  consumer on the axis is replicated or split (there is no default: a
  call that needs a gradient without one raises).  ``all_reduce`` of
  partial sums with a replicated consumer: ``"identity"``; with a split
  consumer (each rank reads the sum for its own part of the work, as the
  SSD's gated norm reads the summed squares for its own heads):
  ``"all_reduce"``, the gradient summed over the axis; ``all_gather``
  with a replicated consumer: ``"narrow"`` (this rank's slice of the
  gradient), with a consumer whose batch differs by rank (an FSDP leaf
  over the DP axes) or whose part of the work does (a leaf whose columns
  each TP rank reads its own of): ``"reduce_scatter"``; ``enter_split``
  (the identity at the entry to a column-parallel region) all-reduces its
  gradient over the TP axis; ``to_compute`` states its own from its
  ``consumer``.  The backward runs the
  collective on the mesh and axis its forward ran on, wherever autograd
  runs it; ``carry`` keeps the context for a checkpoint's recompute.
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
           "remove_sink", "reduce_scatter", "enter_split", "carry",
           "split_axes", "take_slots"]

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


def carry(fn):
    """``fn`` run under the mesh context active now, wherever it is called:
    a checkpoint's recompute runs inside the backward, on whatever thread
    the autograd engine gives the device, where the context variable is
    unset."""
    ctx = _CTX.get()
    if ctx is None:
        return fn

    def run(*args, **kwargs):
        tok = _CTX.set(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            _CTX.reset(tok)

    return run


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


def _run(op, t: torch.Tensor, group):
    """Run ``op(t, group)`` (in place on ``t``, or returning its result: a
    tensor or a list of them).  gloo keeps two ranks on one card: a CUDA
    tensor goes through host memory there, and only there."""
    import torch.distributed as dist
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        res = op(host, group)
        if res is None:
            t.copy_(host)
            return None
        if isinstance(res, torch.Tensor):
            return res.to(t.device)
        return [r.to(t.device) for r in res]
    return op(t, group)


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _differentiable(kind: str, adjoint, allowed, x: torch.Tensor) -> bool:
    """Whether a call runs as an autograd op: ``x`` needs a gradient, and
    then the call site must have stated an ``adjoint`` of ``allowed``."""
    if adjoint is not None and adjoint not in allowed:
        raise ValueError(f"{kind}: adjoint {adjoint!r}, expected one of "
                         f"{allowed}")
    if not _needs_grad(x):
        return False
    if adjoint is None:
        raise ValueError(f"{kind} of a tensor that needs a gradient: the "
                         f"call site states its adjoint, one of {allowed} "
                         "(replicated or split consumer)")
    return True


def _mesh_of(mesh):
    ctx = _CTX.get()
    return mesh or (ctx["mesh"] if ctx else None)


def _all_reduce(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    """The sum over ``axis``, in place on ``x`` made contiguous; recorded."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    x = x.contiguous()
    if not _traced(mesh, x, "all_reduce"):
        _run(lambda t, g: dist.all_reduce(t, group=g), x, mesh.group(axis))
    _record("all_reduce", t0, axis, mesh.shape[axis], x)
    return x


def _all_gather(x: torch.Tensor, axis: str, dim: int,
                mesh: Mesh) -> torch.Tensor:
    """The shards of ``x`` along ``dim`` over one axis of size > 1,
    concatenated; recorded."""
    import torch.distributed as dist
    n = mesh.shape[axis]
    t0 = time.perf_counter()

    def gather(t, g):
        parts = [torch.empty_like(t) for _ in range(n)]
        if g is not None:
            dist.all_gather(parts, t, group=g)
        return parts

    src = x.contiguous()
    parts = (gather(src, None) if _traced(mesh, src, "all_gather")
             else _run(gather, src, mesh.group(axis)))
    _record("all_gather", t0, axis, n, src)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, axis: str, dim: int,
                    mesh: Mesh) -> torch.Tensor:
    """Over one axis of size > 1: the sum of ``x`` over the axis, of which
    this rank keeps its shard along ``dim``; recorded (the operand: the
    whole ``x``)."""
    import torch.distributed as dist
    n = mesh.shape[axis]
    t0 = time.perf_counter()
    src = x.contiguous()
    if src.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of extent "
                         f"{src.shape[dim]} does not split {n} ways")

    def scatter(t, g):
        parts = [p.contiguous() for p in torch.chunk(t, n, dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=g)
        return out

    if _traced(mesh, src, "reduce_scatter"):
        shape = list(src.shape)
        shape[dim] //= n
        out = torch.empty(shape, dtype=src.dtype, device=src.device)
    else:
        out = _run(scatter, src, mesh.group(axis))
    _record("reduce_scatter", t0, axis, n, src)
    return out


class _AllReduce(torch.autograd.Function):
    """Sum over an axis, its adjoint stated: ``"identity"`` (the consumer
    is replicated over the axis, so every rank holds the sum's whole
    gradient, which is each addend's) or ``"all_reduce"`` (each rank's
    consumer reads the sum for its own part of the work, so each rank
    holds a partial gradient of the sum, and every addend's is their sum
    over the axis)."""

    @staticmethod
    def forward(ctx, x, axis, mesh, adjoint):
        ctx.axis, ctx.mesh, ctx.adjoint = axis, mesh, adjoint
        return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                           axis, mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.adjoint == "all_reduce":
            g = _all_reduce(g.clone(memory_format=torch.contiguous_format),
                            ctx.axis, ctx.mesh)
        return g, None, None, None


class _AllGather(torch.autograd.Function):
    """All-gather over one axis, its adjoint stated: ``"narrow"`` (the
    consumer is replicated over the axis, so every rank holds the same
    whole gradient) or ``"reduce_scatter"`` (each rank's whole gradient
    is its own batch's part)."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh, adjoint):
        ctx.axis, ctx.mesh, ctx.adjoint = axis, mesh, adjoint
        ctx.dim = dim % x.ndim
        ctx.local = x.shape[ctx.dim]
        return _all_gather(x, axis, ctx.dim, mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.adjoint == "narrow":
            i = ctx.mesh.coord(ctx.axis)
            dx = g.narrow(ctx.dim, i * ctx.local, ctx.local).contiguous()
        else:
            dx = reduce_scatter(g, ctx.axis, ctx.dim, ctx.mesh)
        return dx, None, None, None, None


class _EnterSplit(torch.autograd.Function):
    """The identity at the entry to a column-parallel region: each rank's
    columns take the replicated input, so its gradient is the sum of the
    ranks' gradients over the axis."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(memory_format=torch.contiguous_format),
                           ctx.axis, ctx.mesh), None, None


def _take(x: torch.Tensor, axis: str, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's ``c = ceil(n / ranks)`` slots along ``dim`` (extent
    ``n``) of ``x``, replicated over ``axis``: ``[i c, min((i+1) c, n))``,
    zero rows past ``n`` (a copy where it pads, else a view)."""
    n = x.shape[dim]
    c = -(-n // mesh.shape[axis])
    lo = min(mesh.coord(axis) * c, n)
    part = x.narrow(dim, lo, min(lo + c, n) - lo)
    if part.shape[dim] == c:
        return part
    pad = list(x.shape)
    pad[dim] = c - part.shape[dim]
    return torch.cat([part, x.new_zeros(pad)], dim)


class _Take(torch.autograd.Function):
    """``_take`` of a tensor that needs a gradient: the whole tensor's
    gradient is the ranks' disjoint slices, gathered over the axis and
    trimmed to the extent (no sum: 1 / ranks of an all-reduce's bytes;
    an even split's slices, a leaf cut to its TP columns, gather as they
    are)."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh, ctx.n = axis, dim, mesh, x.shape[dim]
        return _take(x, axis, dim, mesh).clone()

    @staticmethod
    def backward(ctx, g):
        whole = _all_gather(g, ctx.axis, ctx.dim, ctx.mesh)
        return whole.narrow(ctx.dim, 0, ctx.n), None, None, None


def take_slots(x: torch.Tensor, dim: int, axis: Optional[str] = None,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's slots along ``dim`` of ``x``, which is replicated over
    ``axis`` (default: the context's TP axis): ``c = ceil(n / ranks)`` of
    the ``n`` rows, zero rows past ``n`` on the last ranks, as an uneven
    split of the expert dim pads them.  With a gradient, the backward
    all-gathers the ranks' gradient slices over the axis (recorded, on a
    tracing mesh too) and trims them to ``n``: the slices are disjoint,
    so that is the whole gradient, exactly.  ``x`` itself outside a
    context when no mesh is given, or on an axis of one rank."""
    ctx = _CTX.get()
    mesh = _mesh_of(mesh)
    axis = axis or (ctx["tp"] if ctx else None)
    if mesh is None or axis is None or mesh.shape[axis] == 1:
        return x
    dim = dim % x.ndim
    if _needs_grad(x):
        return _Take.apply(x, axis, dim, mesh)
    return _take(x, axis, dim, mesh)


def all_reduce(x: torch.Tensor, axis: Optional[str] = None,
               mesh: Optional[Mesh] = None, adjoint=None) -> torch.Tensor:
    """Sum of ``x`` over ``axis`` (default: the context's TP axis), issued
    whatever the axis size (a one-rank sum is the identity).  No-op
    outside a context when no mesh is given; on a tracing mesh (``meta``
    tensors only) ``x`` itself (the sum's shape), recorded.  Without a
    gradient the sum is taken in place on ``x`` (made contiguous); with
    one, the call site's ``adjoint`` must be ``"identity"`` (a replicated
    consumer) or ``"all_reduce"`` (a split consumer: the backward sums the
    gradient over the same axis, recorded) and the sum is a new tensor."""
    ctx = _CTX.get()
    mesh = _mesh_of(mesh)
    axis = axis or (ctx["tp"] if ctx else None)
    if mesh is None or axis is None:
        return x
    if _differentiable("all_reduce", adjoint, ("identity", "all_reduce"),
                       x):
        return _AllReduce.apply(x, axis, mesh, adjoint)
    return _all_reduce(x, axis, mesh)


def all_gather(x: torch.Tensor, axes, dim: int,
               mesh: Optional[Mesh] = None, adjoint=None) -> torch.Tensor:
    """Concatenate the shards of ``x`` along ``dim`` over ``axes`` (one
    axis name or a tuple, major to minor, as in a spec).  Axes of size 1
    hold the whole dim and are skipped; no-op outside a context when no
    mesh is given.  On a tracing mesh (``meta`` tensors only) each part is
    an empty tensor of the shard's shape (what a real rank receives
    into), concatenated.  A gradient needs the call site's ``adjoint``:
    ``"narrow"`` or ``"reduce_scatter"`` (``_AllGather``)."""
    mesh = _mesh_of(mesh)
    if mesh is None:
        return x
    grad = _differentiable("all_gather", adjoint,
                           ("narrow", "reduce_scatter"), x)
    for axis in reversed(axes_of(axes)):  # minor axis first
        if mesh.shape[axis] == 1:
            continue
        x = (_AllGather.apply(x, axis, dim, mesh, adjoint) if grad
             else _all_gather(x, axis, dim, mesh))
    return x


def reduce_scatter(x: torch.Tensor, axes, dim: int,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum of ``x`` over ``axes`` (one axis name or a tuple, major to
    minor), each rank keeping its shard along ``dim`` as ``all_gather``
    over the same axes would have gathered it (its adjoint).  Axes of size
    1 are skipped; no-op outside a context when no mesh is given; on a
    tracing mesh (``meta`` tensors only) an empty shard, recorded."""
    mesh = _mesh_of(mesh)
    if mesh is None:
        return x
    for axis in axes_of(axes):  # major axis first
        if mesh.shape[axis] > 1:
            x = _reduce_scatter(x, axis, dim, mesh)
    return x


def enter_split(x: torch.Tensor) -> torch.Tensor:
    """The entry to a column-parallel region of the context's TP axis: the
    identity, whose backward all-reduces the gradient over the axis
    (issued whatever its size, as the row-parallel sum is).  ``x`` itself
    outside a context or without a gradient."""
    ctx = _CTX.get()
    if ctx is None or ctx["tp"] is None or not _needs_grad(x):
        return x
    return _EnterSplit.apply(x, ctx["tp"], ctx["mesh"])


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


def split_axes(spec, sizes=None) -> Tuple[str, ...]:
    """The mesh axes a spec splits some dim over, in spec order (with
    ``sizes``: only those of size > 1)."""
    out = []
    for entry in spec:
        out += [a for a in axes_of(entry) if sizes is None or sizes[a] > 1]
    return tuple(out)


def to_compute(leaf, spec, shape, split: Optional[int],
               consumer: str = "replicated"):
    """A rank's slice ``leaf`` of a leaf of logical ``shape`` stored under
    ``spec``, in the layout the tensor-parallel scheme computes with:
    every dim the spec splits is gathered, except ``split`` where the spec
    splits it over the TP axis alone; ``split`` is cut to this rank's TP
    slice (``take_slots``) where the spec does not split it so.  A packed
    leaf moves whole blocks, codes and scales together, so every step is
    exact.  The adjoints: a gather over a DP axis reduce-scatters the
    gradient (each DP rank's batch is its own), and the take gathers it.
    Over the TP axis the whole leaf's ``consumer`` decides:
    ``"replicated"`` (every TP rank computes with all of it alike), the
    gather narrows the gradient; ``"split"`` (each TP rank reads its own
    parts of the whole leaf, parts that may overlap, as the SSD's heads
    read their segments of in_proj and all of its B and C columns), each
    rank holds a partial gradient of the whole leaf: the gather
    reduce-scatters it into the stored slice, and a leaf the spec keeps
    whole over the TP axis enters the split (``enter_split``: its
    gradient all-reduced over the axis)."""
    if consumer not in ("replicated", "split"):
        raise ValueError(f"consumer {consumer!r}: expected 'replicated' or "
                         "'split'")
    ctx = _CTX.get()
    mesh, tp = ctx["mesh"], ctx["tp"]
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    split_tp = consumer == "split"
    for d, entry in enumerate(spec):
        if axes_of(entry) and not (d == split and axes_of(entry) == (tp,)):
            for axis in reversed(axes_of(entry)):  # minor axis first
                adj = ("reduce_scatter" if axis in ctx["dp"]
                       or (split_tp and axis == tp) else "narrow")
                leaf = map_parts(leaf, lambda t: all_gather(
                    t, axis, d, adjoint=adj))
    if split_tp and tp is not None and tp not in split_axes(spec):
        leaf = map_parts(leaf, enter_split)
    if split is not None and axes_of(spec[split]) != (tp,):
        leaf = map_parts(leaf, lambda t: take_slots(t, split, tp, mesh))
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
