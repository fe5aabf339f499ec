"""Launch-level FLOP, byte and memory count of an eager PyTorch program,
held against the H100's peaks.

Counterpart of the JAX package's ``launch/hlo_cost.py`` (and of the
``memory_analysis`` its dry run reads).  That module walks the compiled
HLO, because the compiled module is the program that runs.  Eager PyTorch
compiles nothing: the program that runs is the sequence of aten ops and
kernel launches, issued one by one, every loop already unrolled by
Python.  So ``count`` counts that sequence while it runs -- on ``meta``
tensors for a dry run (shapes only, nothing computed, no card needed) or
on real tensors:

* **aten ops**, through a ``TorchDispatchMode``: FLOPs of matmuls and
  convolutions from ``torch.utils.flop_counter``'s formulas, at the bf16
  tensor rate when their operands are bf16 and the f32 rate otherwise;
  elementwise ops 1 per output element and reductions 1 per input element,
  at the f32 rate.  Bytes: each op reads its operands and writes its
  results once -- ``hlo_cost``'s per-op traffic model, with no fusion,
  since every eager op is its own HBM round trip -- except that views and
  factory ops move 0 bytes, an operand counts the distinct elements it
  covers (a broadcast reads its source once), ``copy_`` and fills write
  their destination without reading it, and gathers and in-place scatters
  move the rows they touch, not the whole table they index (``hlo_cost``'s
  dynamic-slice and dynamic-update-slice rule).
* **kernel launches**, recorded by each kernel wrapper's ``meta`` branch
  (``record_launch``) with the work the kernel does, from this module's one
  reckoning per kernel (``*_work``) -- the same reckoning the card run's
  per-kernel bound uses.  The wrapper's ``meta`` branch issues only the
  factory ops of its outputs, so no aten op is counted for a launch.
* **live bytes**: every storage from its creation to its release (a weak
  reference to it), so ``peak_bytes`` is the most bytes alive at once,
  argument storages included, plus each launch's scratch while it runs --
  the counterpart of XLA's argument + temp bytes.
* **collectives**, recorded by ``core/sharding.py`` for every call a rank
  issues (on a tracing mesh too): by kind and mesh axis, with the operand
  bytes each call is handed -- ``parse_collectives``' sum of operand
  shapes in the JAX package's dry run.  A process-group op the dispatcher
  shows (``c10d``) is no aten op: its traffic is the collective term.  A
  train step's backward issues its collectives as it runs (the adjoints
  of ``core/sharding.py``: an FSDP gather's reduce-scatter, a column
  entry's all-reduce, an expert take's all-gather of its rows'
  gradient), and a collective inside a recomputed region (remat
  ``"dots"`` or ``"full"``, ``_attend``'s per-chunk checkpoint; an MoE
  layer's gather of its experts' outputs among them) runs again when the
  region is recomputed, and is counted again, as GSPMD's rematerialized
  collectives are.  (A checkpoint's recompute stops at the last tensor
  the backward needs, so a collective after it, such as a layer's last
  row-parallel sum without a post-norm, runs once.)

The roofline has the JAX dry run's three terms: ``compute_s``,
``memory_s`` and ``collective_s``, the last with its ring multipliers
(``COLL_MULT``: 2 for an all-reduce, 1 otherwise) over each axis's own
link rate (``axis_links``): ranks sit row-major on 8-GPU nodes, an axis
whose every group stays within one node runs on NVLink, any other on the
node's network.  ``dominant`` is the largest of the three.

Published H100 SXM peaks (NVIDIA H100 Tensor Core GPU data sheet, dense,
at the 700 W limit): HBM 3.35 TB/s and 80 GB, bf16 tensor cores 989
TFLOP/s, f32 67 TFLOP/s, fourth-generation NVLink 900 GB/s per GPU (450
GB/s each direction).  The network: one ConnectX-7 400 Gb/s adapter per
GPU (NVIDIA DGX H100 data sheet), 50 GB/s.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from collections import Counter
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..core import sharding as shd

__all__ = ["HBM_BYTES_PER_S", "HBM_BYTES", "BF16_TENSOR_FLOPS", "F32_FLOPS",
           "NVLINK_BYTES_PER_S", "NIC_BYTES_PER_S", "NODE_GPUS", "KINDS",
           "COLLECTIVES", "COLL_MULT", "Work", "bound_ms",
           "fused_matmul_work", "mx_matmul_work", "attention_work",
           "quantize_work", "requantize_work", "record_launch", "count",
           "storage_bytes", "axis_links", "summarize", "extrapolate",
           "collectives_by_axis"]

HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
NVLINK_BYTES_PER_S = 450e9   # NVLink 4, per H100 SXM, each direction
NIC_BYTES_PER_S = 50e9       # ConnectX-7, 400 Gb/s per GPU (DGX H100)
NODE_GPUS = 8                # GPUs of one NVLink node (HGX / DGX H100)

# the JAX dry run's collective kinds and ring multipliers (bytes on the
# wire per device over the operand bytes), and the port's kind names
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
COLL_MULT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
             "all-to-all": 1.0, "collective-permute": 1.0, "broadcast": 1.0}
KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "broadcast": "broadcast"}


@dataclasses.dataclass(frozen=True)
class Work:
    """What one launch moves and computes: ``nbytes`` (each input read
    once, each output written once) and ``ops``, (operations, peak rate)
    pairs, each run at its own rate."""
    nbytes: float
    ops: Tuple[Tuple[float, float], ...] = ()

    @property
    def compute_s(self) -> float:
        return sum(n / rate for n, rate in self.ops)

    @property
    def memory_s(self) -> float:
        return self.nbytes / HBM_BYTES_PER_S


def bound_ms(work: Work):
    """(least ms the card could take for the work, "bytes" or
    "operations"): the larger of its bytes over the memory rate and its
    operations over their peak rates."""
    t_bytes, t_ops = work.memory_s, work.compute_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _pad(n: int, b: int) -> int:
    return -(-n // b) * b


def fused_matmul_work(m: int, k: int, kw: int, n: int, x_itemsize: int,
                      xblk=(1, 64), wblk=(64, 1), quantize_lhs: bool = True,
                      emit_codes: bool = False) -> Work:
    """The fused quantize->matmul: x (m, k) read once, the packed weight
    (kw, n) codes and scales, y (m, n) f32, and with ``emit_codes`` x's
    codes and scales; 2 m k n operations on the bf16 tensor cores for a
    quantized x, at the f32 rate for a raw one."""
    nbytes = m * k * x_itemsize + kw * n + (kw // wblk[0]) * (n // wblk[1]) \
        + m * n * 4
    if emit_codes:
        mb, kb = _pad(m, xblk[0]), _pad(k, xblk[1])
        nbytes += mb * kb + (mb // xblk[0]) * (kb // xblk[1])
    rate = BF16_TENSOR_FLOPS if quantize_lhs else F32_FLOPS
    return Work(nbytes, ((2.0 * m * k * n, rate),))


def mx_matmul_work(m: int, k: int, n: int, xblk, wblk) -> Work:
    """Packed x packed: both operands' codes and scales, y (m, n) f32;
    2 m k n operations on the bf16 tensor cores."""
    nbytes = (m * k + (m // xblk[0]) * (k // xblk[1]) + k * n
              + (k // wblk[0]) * (n // wblk[1]) + m * n * 4)
    return Work(nbytes, ((2.0 * m * k * n, BF16_TENSOR_FLOPS),))


def attention_work(kv_rows: int, kv: int, dh: int, q_elems: int,
                   q_itemsize: int, visible: float) -> Work:
    """Packed-KV flash attention: the ``kv_rows`` cache rows it needs
    ((slot, position) pairs, each ``kv`` heads of K and V codes plus a
    scale byte) read once, q read and the output written in q's dtype;
    over the ``visible`` (query row, key) pairs, QK^T at the bf16 tensor
    rate (a quantized q against decoded K is exact in bf16) and PV at the
    f32 rate (P stays f32), 2 dh operations each."""
    nbytes = kv_rows * kv * 2 * (dh + 1) + 2 * q_elems * q_itemsize
    ops = 2.0 * dh * visible
    return Work(nbytes, ((ops, BF16_TENSOR_FLOPS), (ops, F32_FLOPS)))


def quantize_work(m: int, k: int, block, itemsize: int) -> Work:
    """The quantizer: x read once, its codes and scales (block-padded)
    written."""
    mb, kb = _pad(m, block[0]), _pad(k, block[1])
    return Work(m * k * itemsize + mb * kb
                + (mb // block[0]) * (kb // block[1]))


def requantize_work(m: int, k: int, from_block, to_block) -> Work:
    """The requantizer: the (m, k) codes and their scales read once, the
    to-block codes and scales written."""
    mb, kb = _pad(m, to_block[0]), _pad(k, to_block[1])
    return Work(m * k + (m // from_block[0]) * (k // from_block[1])
                + mb * kb + (mb // to_block[0]) * (kb // to_block[1]))


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

_ACTIVE: List["count"] = []  # the counters open in this process

# factory ops: they read no operand (the "_like" ones read only a shape)
_FACTORY = {"empty", "empty_like", "empty_strided", "zeros", "zeros_like",
            "ones", "ones_like", "full", "full_like", "new_empty",
            "new_empty_strided", "new_zeros", "new_ones", "new_full",
            "arange", "linspace", "logspace", "scalar_tensor", "eye",
            "rand", "randn", "randint", "rand_like", "randn_like",
            "randint_like", "randperm", "tensor"}
_VIEW_LIKE = {"_unsafe_view", "detach", "alias",
              "_reshape_alias", "view_as"}
_WRITE_ONLY = {"fill_", "zero_", "normal_", "uniform_", "random_",
               "bernoulli_", "exponential_", "copy_"}
_GATHER = {"index", "index_select", "gather", "embedding", "take",
           "take_along_dim"}
_SCATTER_INPLACE = {"index_put_", "_index_put_impl_", "index_copy_",
                    "index_add_", "scatter_", "scatter_add_",
                    "scatter_reduce_", "index_fill_", "masked_scatter_"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "logsumexp", "var", "std", "var_mean", "std_mean", "norm",
               "linalg_vector_norm", "argmax", "argmin", "cumsum", "cumprod",
               "any", "all", "count_nonzero", "_softmax", "_log_softmax",
               "softmax", "log_softmax", "aminmax", "nansum", "topk", "sort"}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _touched(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor covers (a stride-0 dim
    repeats its source)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0 or size == 0:
            n *= size
    return n * t.element_size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under a tree of tensors (packed
    leaves: codes and scales)."""
    seen = {}
    for t in _leaf_tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _leaf_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaf_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaf_tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif hasattr(tree, "codes") and hasattr(tree, "scale_e8m0"):  # packed
        yield tree.codes
        yield tree.scale_e8m0


def _is_view(func) -> bool:
    rets = func._schema.returns
    return (func.overloadpacket.__name__ in _VIEW_LIKE
            or (len(rets) > 0 and rets[0].alias_info is not None
                and not rets[0].alias_info.is_write))


def _rate(args) -> float:
    """The peak rate of a matmul-like op: bf16 tensor cores for bf16 or
    fp16 operands, the f32 rate otherwise."""
    first = next((t for t in _tensors(args) if t.is_floating_point()), None)
    return (BF16_TENSOR_FLOPS if first is not None
            and first.dtype in (torch.bfloat16, torch.float16)
            else F32_FLOPS)


def record_launch(name: str, work: Work, scratch: int = 0):
    """A kernel wrapper's ``meta`` branch: one launch of kernel ``name``
    doing ``work``, with ``scratch`` bytes of workspace alive while it
    runs, for every open counter (each also sees every aten op)."""
    for counter in _ACTIVE:
        counter._launch(name, work, scratch)


class count(TorchDispatchMode):
    """Count the program run inside ``with count(args) as c:`` -- ``args``
    a tree of the program's input tensors (their storages are the
    argument bytes) -- then read ``c.summary(outputs)``."""

    def __init__(self, args=None):
        super().__init__()
        self.flops_bf16 = self.flops_f32 = 0.0
        self.aten_bytes = 0.0
        self.aten_ops = 0
        self.launches: Counter = Counter()
        self.launch_bytes = 0.0
        self._live: Dict[int, Tuple[int, weakref.ref]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._args = args
        self.argument_bytes = 0
        self.collectives: Dict[Tuple[str, str], List[int]] = {}
        self.axis_sizes: Dict[str, int] = {}

    # -- storages ---------------------------------------------------------
    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        nbytes = st.nbytes()

        def release(_, key=key, nbytes=nbytes, live=self._live):
            if live.pop(key, None) is not None:
                self.live_bytes -= nbytes

        self._live[key] = (nbytes, weakref.ref(st, release))
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __enter__(self):
        for t in _leaf_tensors(self._args):
            self._track(t)
        self.argument_bytes = self.live_bytes
        _ACTIVE.append(self)
        shd.add_sink(self._collective)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        shd.remove_sink(self._collective)
        return super().__exit__(*exc)

    # -- collectives ------------------------------------------------------
    def _collective(self, kind: str, axis: str, size: int, nbytes: int):
        c = self.collectives.setdefault((KINDS[kind], axis), [0, 0])
        c[0] += 1
        c[1] += nbytes
        self.axis_sizes[axis] = size

    # -- launches ---------------------------------------------------------
    def _launch(self, name: str, work: Work, scratch: int):
        self.launches[name] += 1
        self.launch_bytes += work.nbytes
        for n, rate in work.ops:
            if rate == BF16_TENSOR_FLOPS:
                self.flops_bf16 += n
            else:
                self.flops_f32 += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes + scratch)

    # -- aten ops ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        # a constant's wrapper is no op on the device; a process-group op
        # is counted as its collective
        if func.overloadpacket.__name__ != "lift_fresh" and \
                func.namespace not in ("c10d", "_c10d_functional"):
            self.aten_ops += 1
            self._tally(func, args, kwargs, outs)
        return out

    def _tally(self, func, args, kwargs, outs):
        name = func.overloadpacket.__name__
        ins = _tensors((args, kwargs))
        if _is_view(func) or name in _FACTORY or not ins:
            return
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out_of(outs))
            if _rate(args) == BF16_TENSOR_FLOPS:
                self.flops_bf16 += flops
            else:
                self.flops_f32 += flops
        elif torch.Tag.pointwise in func.tags:
            self.flops_f32 += sum(t.numel() for t in outs[:1])
        elif name in _REDUCTIONS:
            self.flops_f32 += ins[0].numel()
        self.aten_bytes += self._bytes(name, ins, outs)

    @staticmethod
    def _bytes(name, ins, outs) -> float:
        if name in _WRITE_ONLY:  # copy_ reads its source, fills nothing
            return sum(_touched(t) for t in ins[1:]) + sum(
                _nbytes(t) for t in outs[:1])
        if name in _GATHER:  # the indices, the rows read, the result
            return sum(_touched(t) for t in ins[1:]) + 2 * sum(
                _nbytes(t) for t in outs)
        if name in _SCATTER_INPLACE:  # the indices, the rows written
            idx, vals = (ins[1:-1], ins[-1:]) if len(ins) > 2 else (ins[1:],
                                                                     [])
            return sum(_touched(t) for t in idx) + 2 * sum(
                _touched(t) for t in vals)
        return sum(_touched(t) for t in ins) + sum(_nbytes(t) for t in outs)

    # -- results ----------------------------------------------------------
    def tally(self, outputs=None) -> dict:
        """The raw counts of what ran (what ``extrapolate`` scales):
        ``outputs`` the program's results, whose storages that are not
        arguments are the output bytes."""
        arg_keys = {t.untyped_storage()._cdata
                    for t in _leaf_tensors(self._args)}
        out_bytes = {}
        for t in _leaf_tensors(outputs):
            st = t.untyped_storage()
            if st._cdata not in arg_keys:
                out_bytes[st._cdata] = st.nbytes()
        coll: dict = {}
        for (kind, axis), (n, b) in sorted(self.collectives.items()):
            coll.setdefault(kind, {})[axis] = {"count": n, "bytes": b}
        return {"flops_bf16": self.flops_bf16, "flops_f32": self.flops_f32,
                "aten_bytes": self.aten_bytes, "aten_ops": self.aten_ops,
                "launch_bytes": self.launch_bytes,
                "launches": dict(self.launches),
                "argument_bytes": self.argument_bytes,
                "output_bytes": sum(out_bytes.values()),
                "peak_bytes": self.peak_bytes, "collectives": coll}

    def summary(self, outputs=None, mesh_shape=None) -> dict:
        """FLOPs, HBM bytes, the memory terms, the collectives and the
        roofline of what ran (``summarize``)."""
        return summarize(self.tally(outputs), mesh_shape)


def axis_links(mesh_shape) -> dict:
    """Each axis of a mesh (``{name: size}``, in mesh order; ranks
    row-major, ``NODE_GPUS`` to a node): ``{"size", "link", "bytes_per_s"}``
    -- NVLink where every group along the axis stays within one node, the
    node's network otherwise."""
    names, sizes = list(mesh_shape), list(mesh_shape.values())
    n = math.prod(sizes)
    out = {}
    for i, name in enumerate(names):
        stride = math.prod(sizes[i + 1:])
        inside = all((r + k * stride) // NODE_GPUS == r // NODE_GPUS
                     for r in range(n) if (r // stride) % sizes[i] == 0
                     for k in range(sizes[i]))
        out[name] = {"size": sizes[i],
                     "link": "nvlink" if inside else "network",
                     "bytes_per_s": (NVLINK_BYTES_PER_S if inside
                                     else NIC_BYTES_PER_S)}
    return out


def summarize(t: dict, mesh_shape=None) -> dict:
    """A ``count.tally`` (or an ``extrapolate``d one) as the dry run's
    record: ``memory``, ``cost``, ``collectives`` (the JAX package's five
    kinds, each ``{"count", "bytes", "by_axis"}``, plus any other kind the
    port issued; empty without a mesh), ``collective_axes`` (each axis's
    link and rate) and the three-term ``roofline``."""
    flops = t["flops_bf16"] + t["flops_f32"]
    hbm = t["aten_bytes"] + t["launch_bytes"]
    compute_s = (t["flops_bf16"] / BF16_TENSOR_FLOPS
                 + t["flops_f32"] / F32_FLOPS)
    memory_s = hbm / HBM_BYTES_PER_S
    coll, axes, coll_s = {}, {}, 0.0
    if mesh_shape is not None:
        axes = axis_links(mesh_shape)
        for kind in COLLECTIVES + tuple(k for k in t["collectives"]
                                        if k not in COLLECTIVES):
            by_axis = t["collectives"].get(kind, {})
            coll[kind] = {"count": sum(v["count"] for v in by_axis.values()),
                          "bytes": sum(v["bytes"] for v in by_axis.values()),
                          "by_axis": {a: dict(v) for a, v in by_axis.items()}}
            coll_s += sum(COLL_MULT[kind] * v["bytes"]
                          / axes[a]["bytes_per_s"]
                          for a, v in by_axis.items())
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    return {
        "memory": {"argument_bytes": t["argument_bytes"],
                   "output_bytes": t["output_bytes"],
                   "temp_bytes": t["peak_bytes"] - t["argument_bytes"],
                   "peak_bytes_per_device": t["peak_bytes"]},
        "cost": {"flops_per_device": flops,
                 "flops_bf16_tensor": t["flops_bf16"],
                 "flops_f32": t["flops_f32"],
                 "hbm_bytes_per_device": hbm,
                 "aten_ops": t["aten_ops"],
                 "aten_bytes": t["aten_bytes"],
                 "launch_bytes": t["launch_bytes"],
                 "launches": dict(t["launches"])},
        "collectives": coll,
        "collective_axes": axes,
        "roofline": {"compute_s": compute_s, "memory_s": memory_s,
                     "collective_s": coll_s,
                     "dominant": max(terms, key=terms.get)},
    }


def collectives_by_axis(collectives) -> dict:
    """``{kind: {axis: [calls, operand bytes]}}`` (the record's kind names)
    of ``sharding.counts()`` on a real rank or of a summary's
    ``collectives`` (kinds with no call left out): the form a rank's run
    and its trace are compared in."""
    out = {}
    for kind, c in collectives.items():
        if "axes" in c:  # sharding.counts()
            kind, by_axis = KINDS[kind], {a: (v["calls"], v["bytes"])
                                          for a, v in c["axes"].items()}
        else:
            by_axis = {a: (v["count"], v["bytes"])
                       for a, v in c["by_axis"].items()}
        if by_axis:
            out[kind] = {a: list(v) for a, v in by_axis.items()}
    return out


def extrapolate(one: dict, two: dict, k: int) -> dict:
    """The tally of ``k`` repeats of a program's period from the tallies
    of one (``one``) and of two (``two``): each count c(1) + (k - 1)
    (c(2) - c(1)), leaf by leaf (a key missing on one side counts 0).
    Exact wherever each period adds the same counts."""
    if isinstance(one, dict) or isinstance(two, dict):
        one, two = one or {}, two or {}
        return {key: extrapolate(one.get(key, 0), two.get(key, 0), k)
                for key in list(one) + [x for x in two if x not in one]}
    return one + (k - 1) * (two - one)


def out_of(outs):
    """The value a flop formula takes as ``out_val``."""
    if not outs:
        return None
    return outs[0] if len(outs) == 1 else tuple(outs)
