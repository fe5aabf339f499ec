"""Quantized matmul with its backward -- the paper's training datapath.

PyTorch counterpart of the JAX package's ``core/mx_dot.py``.
``mx_dot(x, w, policy)`` quantizes both operands to the policy's MX format
before the matmul and (optionally) quantizes the incoming gradient in the
backward pass, as one ``torch.autograd.Function`` (the JAX package's
``jax.custom_vjp``).  Two block layouts (paper Fig. 4):

  * 1D row blocks: the backward re-quantizes x, w, g along their
    transposed contraction dims (6 quantization passes / layer / step);
  * 2D TxT tiles: quantize once, reuse via ``transpose_qt`` in the
    backward (3 passes).

Backends (``policy.backend``):

  * ``"torch"``: value-domain quantize/dequantize roundtrips (the JAX
    package's ``"jnp"``); residuals are packed ``QuantizedTensor``s when
    ``policy.save_packed``, else the quantized values (bit-identical).
  * ``"cuda"``: the kernel datapath (``kernels/``).  The weight is packed
    by the quantizer kernel; x is quantized inside the fused matmul's
    prologue, which also emits x's codes.  The saved residuals are these
    packed uint8 tensors.  The 2D backward quantizes g once and runs the
    packed x packed matmul on tiles reused by ``transpose_qt``; the 1D
    backward re-blocks w and x packed->packed through the requantize
    kernel and feeds g to the fused matmul.  On CPU tensors every kernel
    wrapper takes its plain version.

A packed weight (``blocking.QuantizedTensor`` from the pack-once store) is
frozen: its forward quantizes x only, its backward returns dx alone (pass
counts 1D = 3, 2D = 2).  Every leading dim of x is flattened into rows.
Kernels are called through their module attributes (``FM.``, ``MQ.``,
``MM.``), so a caller may wrap them.

``count_quant_passes`` counts the quantize passes (paper Fig. 4
accounting), ticking where the JAX package ticks.

``save_dots`` is the ``torch.utils.checkpoint`` ``context_fn`` of the
``"dots"`` remat policy (the JAX package's
``dots_with_no_batch_dims_saveable``): inside a checkpointed region the
forward keeps each raw-weight ``mx_dot``'s output, and the recompute
returns the kept output and quantizes the operands again for the
backward's residuals without running the matmul.  (PyTorch's selective
checkpointing picks ops by aten name; the kernel datapath's matmul is a
kernel launch, not an aten op, so the policy is applied here.)
"""
from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch

from . import blocking as B
from .policy import QuantPolicy
from ..kernels import mx_matmul as MM
from ..kernels import mxsf_fused_matmul as FM
from ..kernels import mxsf_quant as MQ

__all__ = ["mx_dot", "mx_einsum", "qdq_along", "count_quant_passes",
           "save_dots"]

_COUNTER = {"n": 0, "active": False}
_DOTS = {"mode": None}  # the "dots" region being run or recomputed


@contextlib.contextmanager
def count_quant_passes():
    """Count quantize passes made inside this context."""
    prev = dict(_COUNTER)
    _COUNTER.update(n=0, active=True)
    try:
        yield _COUNTER
    finally:
        _COUNTER["active"] = prev["active"]


def _tick():
    if _COUNTER["active"]:
        _COUNTER["n"] += 1


def _qdq(x, fmt, block):
    _tick()
    return B.qdq(x, fmt, block)


def _quantize(x, fmt, block):
    _tick()
    return B.quantize(x, fmt, block)


def qdq_along(x: torch.Tensor, fmt: str, policy: QuantPolicy, axis: int = -1):
    """Quantize-dequantize with 1D blocks along ``axis`` (-1 or -2)."""
    if not policy.enabled:
        return x
    blk = ((policy.block_1d,) if axis in (-1, x.ndim - 1)
           else (policy.block_1d, 1))
    return _qdq(x, fmt, blk)


class _DotsMode:
    """One remat region's ``mx_dot`` outputs: ``record`` appends each
    output, ``replay`` hands them back in call order (re-entrant: every
    recompute starts from the first)."""

    def __init__(self, saved: list, replay: bool):
        self.saved, self.replay, self.i, self.prev = saved, replay, 0, None

    def __enter__(self):
        self.prev, self.i = _DOTS["mode"], 0
        _DOTS["mode"] = self
        return self

    def __exit__(self, *exc):
        _DOTS["mode"] = self.prev

    def next(self) -> torch.Tensor:
        self.i += 1
        return self.saved[self.i - 1]


def save_dots():
    """``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for remat
    ``"dots"``: (the forward's recording context, the recompute's replaying
    context) over one list of kept ``mx_dot`` outputs."""
    saved: list = []
    return _DotsMode(saved, False), _DotsMode(saved, True)


def _mm(a: torch.Tensor, b: torch.Tensor,
        f32_out: bool = False) -> torch.Tensor:
    """matmul with the JAX package's type promotion; ``f32_out``: in f32,
    the sums kept unrounded to the operands' dtype."""
    dt = (torch.float32 if f32_out else
          torch.promote_types(a.dtype, b.dtype))
    return torch.matmul(a.to(dt), b.to(dt))


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _flatten_lead(x: torch.Tensor):
    lead = tuple(x.shape[:-1])
    return x.reshape(math.prod(lead), x.shape[-1]), lead


def _pol_blocks(policy: QuantPolicy):
    """(xblk, wblk) 2D block shapes for the kernel datapath."""
    if policy.block_mode == "2d":
        t = (policy.tile, policy.tile)
        return t, t
    return (1, policy.block_1d), (policy.block_1d, 1)


# ---------------------------------------------------------------------------
# kernel datapath (backend="cuda")
# ---------------------------------------------------------------------------

def _kernel_fwd(policy: QuantPolicy, xm, w, with_residuals: bool,
                f32_out: bool = False):
    """Fused-kernel forward: pack w once, quantize x inside the matmul
    (``f32_out``: the kernel's f32 sums, uncast)."""
    xblk, wblk = _pol_blocks(policy)
    xm = xm.contiguous()
    _tick()  # w quantized (packed) by the quantizer kernel
    wc, ws = MQ.mxsf_quantize(w.contiguous(), wblk)
    _tick()  # x quantized on the fly in the fused matmul prologue
    if with_residuals:
        y, xc, xs = FM.mxsf_fused_matmul(xm, wc, ws, xblk, wblk,
                                         emit_codes=True)
        res = (B.QuantizedTensor(xc, xs, policy.fwd_fmt, xblk,
                                 tuple(xm.shape), B.dtype_name(xm.dtype)),
               B.QuantizedTensor(wc, ws, policy.fwd_fmt, wblk,
                                 tuple(w.shape), B.dtype_name(w.dtype)))
    else:
        y = FM.mxsf_fused_matmul(xm, wc, ws, xblk, wblk)
        res = None
    y = y[:, :w.shape[-1]]
    if not f32_out:
        y = y.to(torch.promote_types(xm.dtype, w.dtype))
    return y, res


def _kernel_residuals(policy: QuantPolicy, xm, w):
    """The forward's residuals without its matmul (remat ``"dots"``
    recompute): w by the quantizer kernel, x too (the codes the fused
    prologue emits, bit for bit)."""
    xblk, wblk = _pol_blocks(policy)
    wc, ws = MQ.mxsf_quantize(w.contiguous(), wblk)
    xc, xs = MQ.mxsf_quantize(xm.contiguous(), xblk)
    return (B.QuantizedTensor(xc, xs, policy.fwd_fmt, xblk, tuple(xm.shape),
                              B.dtype_name(xm.dtype)),
            B.QuantizedTensor(wc, ws, policy.fwd_fmt, wblk, tuple(w.shape),
                              B.dtype_name(w.dtype)))


def _kernel_dx_2d(policy: QuantPolicy, qtw: B.QuantizedTensor, gm):
    """Fig. 4b dx: reuse the w tiles via transpose_qt.  Returns
    ``(dx_uncropped, (gc, gs) or None)`` -- the quantized g is handed back
    so the raw-weight backward reuses it for dw (g quantized ONCE)."""
    blk = (policy.tile, policy.tile)
    qwT = B.transpose_qt(qtw)
    if policy.quantize_bwd:
        _tick()
        gc, gs = MQ.mxsf_quantize(gm, blk)
        return MM.mxsf_matmul(gc, gs, qwT.codes, qwT.scale_e8m0, blk,
                              blk), (gc, gs)
    return FM.mxsf_fused_matmul(gm, qwT.codes.contiguous(),
                                qwT.scale_e8m0.contiguous(), blk, blk,
                                quantize_lhs=False), None


def _kernel_dx_1d(policy: QuantPolicy, qtw: B.QuantizedTensor, gm):
    """Fig. 4a dx: re-block w along N packed->packed (codes in, codes out),
    written transposed by the requantizer as the (N, K) operand of
    ``g @ w^T``, then g (quantized along N in the fused prologue) against
    it."""
    b = policy.block_1d
    _tick()  # w re-blocked along N (one Fig. 4a quantize pass)
    wrc, wrs = MQ.mxsf_requantize(qtw.codes, qtw.scale_e8m0, qtw.block,
                                  (1, b), transpose=True)
    if policy.quantize_bwd:
        _tick()  # g quantized along N inside the fused prologue
    return FM.mxsf_fused_matmul(gm, wrc, wrs, (1, b), (b, 1),
                                quantize_lhs=policy.quantize_bwd)


def _kernel_bwd(policy: QuantPolicy, qtx, qtw, gm):
    """Kernel-datapath backward for both layouts: (dx, dw) in f32."""
    m, k = qtx.shape
    n = qtw.shape[-1]
    gm = gm.float().contiguous()
    if policy.block_mode == "2d":
        # Fig. 4b: quantize g ONCE as TxT tiles, reuse x/w via transpose_qt
        blk = (policy.tile, policy.tile)
        dx, g_packed = _kernel_dx_2d(policy, qtw, gm)
        qxT = B.transpose_qt(qtx)
        if g_packed is not None:
            gc, gs = g_packed
            dw = MM.mxsf_matmul(qxT.codes, qxT.scale_e8m0, gc, gs, blk, blk)
        else:
            dw = FM.mxsf_fused_matmul(gm.T.contiguous(), qtx.codes,
                                      qtx.scale_e8m0, blk, blk,
                                      quantize_lhs=False)[:n, :k].T
        return dx[:m, :k], dw[:k, :n]
    # Fig. 4a: re-quantize x, w, g along the transposed contraction dims
    b = policy.block_1d
    quant_g = policy.quantize_bwd
    dx = _kernel_dx_1d(policy, qtw, gm)
    _tick()  # x re-blocked along M (packed->packed, like w above)
    xrc, xrs = MQ.mxsf_requantize(qtx.codes, qtx.scale_e8m0, qtx.block,
                                  (b, 1))
    if quant_g:
        _tick()  # g quantized along M inside the fused prologue
    dw = FM.mxsf_fused_matmul(gm.T.contiguous(), xrc, xrs, (1, b), (b, 1),
                              quantize_lhs=quant_g)[:n, :k].T
    return dx[:m, :k], dw


def _kernel_shapes_ok(x, w) -> bool:
    """Zero-sized operands have nothing to quantize; the value path already
    gives the (empty) result, so skip the kernel dispatch."""
    return (math.prod(x.shape[:-1]) > 0 and x.shape[-1] > 0
            and w.shape[-1] > 0)


# ---------------------------------------------------------------------------
# raw weight: quantized per call, custom backward
# ---------------------------------------------------------------------------

def _value_residuals(policy: QuantPolicy, xm, w):
    """Value-domain residuals (backend="torch") and the quantized
    operands: (residuals, xq, wq)."""
    if policy.block_mode == "2d":
        xblk = wblk = (policy.tile, policy.tile)
    else:  # 1d: x blocks along K (last), w blocks along K (rows)
        xblk, wblk = (policy.block_1d,), (policy.block_1d, 1)
    if policy.save_packed:
        qtx = _quantize(xm, policy.fwd_fmt, xblk)
        qtw = _quantize(w, policy.fwd_fmt, wblk)
        return (qtx, qtw), B.dequantize(qtx), B.dequantize(qtw)
    xq = _qdq(xm, policy.fwd_fmt, xblk)
    wq = _qdq(w, policy.fwd_fmt, wblk)
    return (xq, wq), xq, wq


def _value_fwd(policy: QuantPolicy, xm, w, f32_out: bool = False):
    """Value-domain forward (backend="torch"): (y, residuals)."""
    res, xq, wq = _value_residuals(policy, xm, w)
    return _mm(xq, wq, f32_out), res


def _value_bwd(policy: QuantPolicy, res, gm):
    """Value-domain backward: (dx, dw)."""
    if policy.save_packed:
        qtx, qtw = res
    else:
        xq, wq = res
    if policy.block_mode == "2d":
        # quantize g once as TxT tiles; reuse x/w tiles transposed (Fig. 4b)
        blk = (policy.tile, policy.tile)
        gq = _qdq(gm, policy.bwd_fmt, blk) if policy.quantize_bwd else gm
        if policy.save_packed:
            wTq = B.dequantize(B.transpose_qt(qtw))   # (N, K), no requant
            xTq = B.dequantize(B.transpose_qt(qtx))   # (K, M), no requant
        else:
            wTq, xTq = wq.T, xq.T
        return _mm(gq, wTq), _mm(xTq, gq)
    # 1D: re-quantize along the new contraction dims (Fig. 4a)
    if policy.save_packed:
        xq, wq = B.dequantize(qtx), B.dequantize(qtw)
    b = policy.block_1d
    if policy.quantize_bwd:
        g_for_dx = _qdq(gm, policy.bwd_fmt, (b,))       # blocks along N
        g_for_dw = _qdq(gm, policy.bwd_fmt, (b, 1))     # blocks along M
    else:
        g_for_dx = g_for_dw = gm
    w_re = _qdq(wq, policy.fwd_fmt, (1, b))             # blocks along N
    x_re = _qdq(xq, policy.fwd_fmt, (b, 1))             # blocks along M
    return _mm(g_for_dx, w_re.T), _mm(x_re.T, g_for_dw)


def _save(ctx, res):
    """Residuals (tensors or QuantizedTensors) through save_for_backward."""
    tensors, meta = [], []
    for r in res:
        if isinstance(r, B.QuantizedTensor):
            tensors += [r.codes, r.scale_e8m0]
            meta.append((r.fmt, r.block, r.shape, r.dtype))
        else:
            tensors.append(r)
            meta.append(None)
    ctx.save_for_backward(*tensors)
    ctx.res_meta = meta


def _load(ctx):
    it = iter(ctx.saved_tensors)
    return [next(it) if m is None else
            B.QuantizedTensor(next(it), next(it), *m) for m in ctx.res_meta]


class _MxDot(torch.autograd.Function):
    """``x @ w`` per the policy with the MX backward; residuals are the
    packed uint8 ``QuantizedTensor``s (kernel path, or ``save_packed``)."""

    @staticmethod
    def forward(ctx, x, w, policy):
        xm, lead = _flatten_lead(x)
        dots = _DOTS["mode"]
        kernels = policy.use_kernels and _kernel_shapes_ok(x, w)
        if dots is not None and dots.replay:  # remat "dots" recompute
            y = dots.next()
            res = (_kernel_residuals(policy, xm, w) if kernels else
                   _value_residuals(policy, xm, w)[0])
        else:
            if kernels:
                y, res = _kernel_fwd(policy, xm, w, with_residuals=True)
            else:
                y, res = _value_fwd(policy, xm, w)
            if dots is not None:
                dots.saved.append(y)
        _save(ctx, res)
        ctx.policy, ctx.lead = policy, lead
        return y.reshape(*lead, w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        policy, lead = ctx.policy, ctx.lead
        res = _load(ctx)
        gm, _ = _flatten_lead(g)
        if (policy.use_kernels and gm.shape[0] > 0 and gm.shape[1] > 0
                and res[0].shape[-1] > 0):
            dx, dw = _kernel_bwd(policy, *res, gm)
        else:
            dx, dw = _value_bwd(policy, res, gm)
        return (dx.reshape(*lead, dx.shape[-1]).to(g.dtype),
                dw.to(g.dtype), None)


def _mx_dot_primal(policy: QuantPolicy, x, w, f32_out: bool = False):
    """Forward with no gradient wanted: no residuals are emitted."""
    xm, lead = _flatten_lead(x)
    if policy.use_kernels and _kernel_shapes_ok(x, w):
        y, _ = _kernel_fwd(policy, xm, w, with_residuals=False,
                           f32_out=f32_out)
    else:
        y, _ = _value_fwd(policy, xm, w, f32_out)
    return y.reshape(*lead, w.shape[-1])


# ---------------------------------------------------------------------------
# packed weight operand: resident MXSF codes, frozen
# ---------------------------------------------------------------------------

def _layer_qt(qt: B.QuantizedTensor) -> B.QuantizedTensor:
    """Drop stacked leading dims from the static ``shape`` of a layer slice
    (a slice taken from a stacked store that kept the stacked shape)."""
    drop = len(qt.shape) - qt.codes.ndim
    if drop <= 0:
        return qt
    return B.QuantizedTensor(qt.codes, qt.scale_e8m0, qt.fmt, qt.block,
                             tuple(qt.shape[drop:]), qt.dtype)


def _check_packed(policy: QuantPolicy, qw: B.QuantizedTensor):
    if len(qw.shape) != 2:
        raise ValueError(f"packed mx_dot weight must be 2D after layer "
                         f"slicing; got shape {qw.shape}")
    if not policy.enabled:
        return
    if qw.fmt != policy.fwd_fmt:
        raise ValueError(f"packed weight format {qw.fmt!r} != policy "
                         f"fwd_fmt {policy.fwd_fmt!r}; re-pack the store "
                         "for this policy")
    _, wblk = _pol_blocks(policy)
    if tuple(qw.block) != tuple(wblk):
        raise ValueError(f"packed weight block {tuple(qw.block)} != the "
                         f"policy's kernel layout {tuple(wblk)} "
                         f"(block_mode={policy.block_mode!r}); re-pack the "
                         "store for this policy")


def _packed_fwd(policy: QuantPolicy, xm: torch.Tensor,
                qw: B.QuantizedTensor, f32_out: bool = False) -> torch.Tensor:
    """Forward against resident codes: zero weight-quantize passes.
    ``f32_out`` keeps the kernel's f32 sums (a row-parallel partial)."""
    k, n = qw.shape
    if policy.use_kernels and xm.shape[0] > 0 and k > 0 and n > 0:
        xblk, wblk = _pol_blocks(policy)
        _tick()  # x quantized on the fly; w codes are resident
        y = FM.mxsf_fused_matmul(xm.contiguous(), qw.codes, qw.scale_e8m0,
                                 xblk, wblk)
        if f32_out:
            return y[:, :n]
        return y[:, :n].to(torch.promote_types(xm.dtype,
                                               B.torch_dtype(qw.dtype)))
    wq = B.dequantize(qw)
    if not policy.enabled:
        return _mm(xm, wq.to(xm.dtype), f32_out)
    if policy.block_mode == "2d":
        xq = _qdq(xm, policy.fwd_fmt, (policy.tile, policy.tile))
    else:
        xq = _qdq(xm, policy.fwd_fmt, (policy.block_1d,))
    return _mm(xq, wq, f32_out)


def _value_packed_dx(policy: QuantPolicy, qw: B.QuantizedTensor, gm):
    if policy.block_mode == "2d":
        blk = (policy.tile, policy.tile)
        gq = _qdq(gm, policy.bwd_fmt, blk) if policy.quantize_bwd else gm
        return _mm(gq, B.dequantize(B.transpose_qt(qw)))
    b = policy.block_1d
    g_for_dx = (_qdq(gm, policy.bwd_fmt, (b,)) if policy.quantize_bwd
                else gm)
    w_re = _qdq(B.dequantize(qw), policy.fwd_fmt, (1, b))
    return _mm(g_for_dx, w_re.T)


def _kernel_packed_dx(policy: QuantPolicy, qw: B.QuantizedTensor, gm):
    """dx against the resident store: the dx halves of the raw-weight
    backward, minus any dw work (packed weights are frozen)."""
    m = gm.shape[0]
    k = qw.shape[0]
    gm = gm.float().contiguous()
    if policy.block_mode == "2d":
        dx, _ = _kernel_dx_2d(policy, qw, gm)
    else:
        dx = _kernel_dx_1d(policy, qw, gm)
    return dx[:m, :k]


class _MxDotPacked(torch.autograd.Function):
    """``x @ w`` against a frozen packed weight: the backward returns dx
    only (the residual IS the resident store)."""

    @staticmethod
    def forward(ctx, x, qw, policy):
        xm, lead = _flatten_lead(x)
        ctx.save_for_backward(qw.codes, qw.scale_e8m0)
        ctx.meta = (qw.fmt, qw.block, qw.shape, qw.dtype)
        ctx.policy, ctx.lead = policy, lead
        return _packed_fwd(policy, xm, qw).reshape(*lead, qw.shape[-1])

    @staticmethod
    def backward(ctx, g):
        policy, lead = ctx.policy, ctx.lead
        qw = B.QuantizedTensor(*ctx.saved_tensors, *ctx.meta)
        gm, _ = _flatten_lead(g)
        k = qw.shape[0]
        if (policy.use_kernels and gm.shape[0] > 0 and gm.shape[1] > 0
                and k > 0):
            dx = _kernel_packed_dx(policy, qw, gm)
        elif policy.enabled:
            dx = _value_packed_dx(policy, qw, gm)
        else:
            dx = torch.matmul(gm, B.dequantize(qw).to(gm.dtype).T)
        return dx.reshape(*lead, k).to(g.dtype), None, None


def mx_dot(x: torch.Tensor, w, policy: QuantPolicy,
           f32_out: bool = False) -> torch.Tensor:
    """Quantized ``x @ w`` (x: (..., K), w: (K, N)) per the MX policy.

    ``w`` is a raw tensor (quantized per call, with the MX backward) or a
    resident ``blocking.QuantizedTensor`` from the pack-once store (zero
    weight-quantize passes; frozen, so only dx flows back).  ``f32_out``
    (no gradient): the f32 sums before the cast to the operands' dtype,
    the partial a row-parallel linear all-reduces."""
    if isinstance(w, B.QuantizedTensor):
        qw = _layer_qt(w)
        _check_packed(policy, qw)
        if _needs_grad(x):
            return _MxDotPacked.apply(x, qw, policy)
        xm, lead = _flatten_lead(x)
        return _packed_fwd(policy, xm, qw, f32_out).reshape(
            *lead, qw.shape[-1])
    if not policy.enabled:
        return _mm(x, w, f32_out) if f32_out else torch.matmul(x, w)
    if _needs_grad(x, w):
        return _MxDot.apply(x, w, policy)
    return _mx_dot_primal(policy, x, w, f32_out)


# ---------------------------------------------------------------------------
# mx_einsum: two-operand quantized einsum (attention matmuls)
# ---------------------------------------------------------------------------

def _einsum_vjp_subs(subs: str) -> Tuple[str, str]:
    """Subscripts of the two cotangent einsums of ``a,b->out``: da from
    (g, b) and db from (g, a).  Each operand index must appear in the other
    operand or the output, as in every einsum of the models."""
    ins, out = subs.replace(" ", "").split("->")
    sa, sb = ins.split(",")
    for mine, other in ((sa, sb), (sb, sa)):
        if set(mine) - set(other) - set(out) or len(set(mine)) != len(mine):
            raise NotImplementedError(f"mx_einsum backward of {subs!r}")
    return f"{out},{sb}->{sa}", f"{out},{sa}->{sb}"


class _MxEinsum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b, subs, policy, axes, g_axes, quant_ops):
        qa = qdq_along(a, policy.fwd_fmt, policy, axes[0]) \
            if quant_ops[0] else a
        qb = qdq_along(b, policy.fwd_fmt, policy, axes[1]) \
            if quant_ops[1] else b
        ctx.save_for_backward(qa, qb)
        ctx.subs, ctx.policy, ctx.g_axes = subs, policy, g_axes
        return _einsum(subs, qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        policy = ctx.policy
        da_subs, db_subs = _einsum_vjp_subs(ctx.subs)
        if policy.quantize_bwd:
            # the hardware re-quantizes g along each backward contraction
            ga = qdq_along(g, policy.bwd_fmt, policy, ctx.g_axes[0])
            gb = qdq_along(g, policy.bwd_fmt, policy, ctx.g_axes[1])
        else:
            ga = gb = g
        da = _einsum(da_subs, ga, qb).to(qa.dtype)
        db = _einsum(db_subs, gb, qa).to(qb.dtype)
        return da, db, None, None, None, None, None


def _einsum(subs: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with the JAX package's type promotion (a bf16 query against
    an f32 value cache computes in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(subs, a.to(dt), b.to(dt))


def mx_einsum(subs: str, a: torch.Tensor, b: torch.Tensor,
              policy: QuantPolicy, axes: Tuple[int, int] = (-1, -1),
              g_axes: Tuple[int, int] = (-1, -2),
              quant_ops: Tuple[bool, bool] = (True, True)) -> torch.Tensor:
    """Two-operand einsum with MX-quantized operands (and gradients).

    ``axes``: contraction axis of each forward operand (-1 or -2), which
    orients the 1D quantization blocks; ``g_axes``: contraction axis of the
    incoming gradient for (da, db); ``quant_ops``: per-operand
    quantization -- False marks an operand that is already quantized (a
    dequantized MXSF KV cache), which skips the forward qdq and is saved
    as it is."""
    if not policy.enabled or not policy.attn_matmuls:
        return _einsum(subs, a, b)
    return _MxEinsum.apply(a, b, subs, policy, tuple(axes), tuple(g_axes),
                           tuple(quant_ops))
