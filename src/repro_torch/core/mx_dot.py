"""Quantized matmul ``x @ w`` per the MX policy -- forward, packed weights.

PyTorch counterpart of the forward packed path of the JAX package's
``core/mx_dot.py``.  ``mx_dot(x, w, policy)`` with ``w`` a resident
``blocking.QuantizedTensor`` (the pack-once store) runs the fused
quantize->matmul kernel (``kernels/mxsf_fused_matmul.py``): x is quantized
to MXSF inside the kernel, the weight codes are decoded in place, and no
weight is quantized per call.  Every leading dim of x is flattened into
rows, so a decode step is ``B`` rows and a prefill chunk ``B*C`` rows.

Not in this slice (each raises ``NotImplementedError``):

  * ``backend="torch"`` with quantization on -- the value-domain emulation
    (the JAX package's ``jnp`` backend), ROADMAP "deferred" item 1;
  * a raw (unpacked) weight under a quantizing policy -- it needs the
    quantizer kernel, ROADMAP "deferred" item 2;
  * every backward (training slice), ROADMAP "deferred" item 3.

``count_quant_passes`` counts the quantize passes the forward makes (paper
Fig. 4 accounting): one per linear (x quantized in the kernel prologue) and
one per ``qdq_along``.
"""
from __future__ import annotations

import contextlib
import math

import torch

from . import blocking as B
from .policy import QuantPolicy
from ..kernels import mxsf_fused_matmul as FM

__all__ = ["mx_dot", "qdq_along", "count_quant_passes"]

_COUNTER = {"n": 0, "active": False}


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


def qdq_along(x: torch.Tensor, fmt: str, policy: QuantPolicy, axis: int = -1):
    """Quantize-dequantize with 1D blocks along ``axis`` (-1 or -2)."""
    if not policy.enabled:
        return x
    blk = ((policy.block_1d,) if axis in (-1, x.ndim - 1)
           else (policy.block_1d, 1))
    return _qdq(x, fmt, blk)


def _flatten_lead(x: torch.Tensor):
    lead = tuple(x.shape[:-1])
    return x.reshape(math.prod(lead), x.shape[-1]), lead


def _pol_blocks(policy: QuantPolicy):
    """(xblk, wblk) 2D block shapes for the kernel datapath."""
    if policy.block_mode == "2d":
        t = (policy.tile, policy.tile)
        return t, t
    return (1, policy.block_1d), (policy.block_1d, 1)


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
                qw: B.QuantizedTensor) -> torch.Tensor:
    """Forward against resident codes: zero weight-quantize passes."""
    k, n = qw.shape
    out_dtype = torch.promote_types(xm.dtype, B.torch_dtype(qw.dtype))
    if not policy.enabled:
        return torch.matmul(xm, B.dequantize(qw).to(xm.dtype))
    if not policy.use_kernels:
        raise NotImplementedError(
            "backend='torch' (value-domain emulation) is not ported yet; "
            "see ROADMAP.md, deferred item 1")
    if xm.shape[0] == 0 or k == 0 or n == 0:
        return xm.new_zeros((xm.shape[0], n), dtype=out_dtype)
    xblk, wblk = _pol_blocks(policy)
    _tick()  # x quantized on the fly; w codes are resident
    y = FM.mxsf_fused_matmul(xm, qw.codes, qw.scale_e8m0, xblk, wblk)
    return y[:, :n].to(out_dtype)


def mx_dot(x: torch.Tensor, w, policy: QuantPolicy) -> torch.Tensor:
    """Quantized ``x @ w`` (x: (..., K), w: (K, N)) per the MX policy.

    ``w`` is a resident ``blocking.QuantizedTensor`` from the pack-once
    store, or a raw tensor under a non-quantizing policy."""
    if isinstance(w, B.QuantizedTensor):
        qw = _layer_qt(w)
        _check_packed(policy, qw)
        xm, lead = _flatten_lead(x)
        return _packed_fwd(policy, xm, qw).reshape(*lead, qw.shape[-1])
    if not policy.enabled:
        return torch.matmul(x, w)
    raise NotImplementedError(
        "mx_dot with a raw weight under a quantizing policy needs the "
        "quantizer kernel; pack the weights (pack_params) or see "
        "ROADMAP.md, deferred item 2")
