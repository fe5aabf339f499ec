"""The port's ``mx_dot`` forward and backward (a ``torch.autograd.Function``)
against the JAX package's ``jax.vjp`` of its ``custom_vjp``, plus the
paper's Fig. 4 quantize-pass counts and ``mx_einsum`` gradients.

Grid: block layout {1d, 2d} x ``quantize_bwd`` {True, False} x weight
{raw, packed} x backends {port "torch" vs JAX "jnp", port "cuda" on CPU
tensors (the kernels' plain versions) vs JAX "pallas" (interpret mode)} x
dtype {float32, bfloat16}.  Inputs, weights and the cotangent g come from
numpy with a seed; both packages get the same values.

Tolerances.  float32: every product of two quantized operands is exact, so
y, dx and dw differ by f32 summation order only -- rtol 1e-5 with atol
1e-5 of the largest magnitude (the raw-g path, ``quantize_bwd=False``,
also rounds each product in both packages alike).  bfloat16: each result
is that f32 sum rounded once to bf16, so the two packages may land on
neighbouring bf16 values: rtol 2^-7 (one bf16 ulp) with the same atol.
Codes never differ: the quantized operands are bit-identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocking as JB
from repro.core import mx_dot as JD
from repro.core.policy import QuantPolicy as JPolicy
from repro_torch import convert
from repro_torch.core import mx_dot as TD
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.models import blocks as TBL

torch.set_num_threads(2)

PAIRS = {"torch": "jnp", "cuda": "pallas"}  # port backend -> JAX backend


def _data(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 8, 64)).astype(np.float32)
    w = rng.standard_normal((64, 40)).astype(np.float32)
    g = rng.standard_normal((3, 8, 40)).astype(np.float32)
    if dtype == "bfloat16":  # bf16-exact values for both packages
        x, w, g = (np.array(jnp.asarray(a).astype(jnp.bfloat16)
                            .astype(jnp.float32)) for a in (x, w, g))
    return x, w, g


def _policies(block_mode, quantize_bwd, backend):
    kw = dict(block_mode=block_mode, quantize_bwd=quantize_bwd)
    return (TPolicy(backend=backend, **kw),
            JPolicy(backend=PAIRS[backend], **kw))


@functools.partial(jax.jit, static_argnums=(0, 4))
def _jax_vjp(policy, x, w, g, packed_block):
    """(y, dx, dw) of the JAX package; with ``packed_block`` the weight is
    packed first (frozen: dw is None)."""
    if packed_block is not None:
        qw = JB.quantize(w, "mxsf", packed_block)
        y, vjp = jax.vjp(lambda a: JD.mx_dot(a, qw, policy), x)
        return y, vjp(g)[0], None
    y, vjp = jax.vjp(lambda a, b: JD.mx_dot(a, b, policy), x, w)
    dx, dw = vjp(g)
    return y, dx, dw


def _close(got: torch.Tensor, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("weight", ["raw", "packed"])
@pytest.mark.parametrize("quantize_bwd", [True, False])
@pytest.mark.parametrize("block_mode", ["1d", "2d"])
def test_mx_dot_forward_and_grads_match_jax(block_mode, quantize_bwd, weight,
                                            backend, dtype):
    x, w, g = _data(dtype, seed=len(block_mode + weight + backend))
    tp, jp = _policies(block_mode, quantize_bwd, backend)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    wblk = TD._pol_blocks(tp)[1]
    packed_block = wblk if weight == "packed" else None
    y_j, dx_j, dw_j = _jax_vjp(jp, jnp.asarray(x).astype(jdt),
                               jnp.asarray(w).astype(jdt),
                               jnp.asarray(g).astype(jdt), packed_block)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    if weight == "packed":
        qw = JB.quantize(jnp.asarray(w).astype(jdt), "mxsf", wblk)
        wt = convert.qt_from_numpy(np.asarray(qw.codes),
                                   np.asarray(qw.scale_e8m0), qw.fmt,
                                   qw.block, qw.shape, qw.dtype)
        y_t = TD.mx_dot(xt, wt, tp)
        (dx_t,) = torch.autograd.grad(y_t, [xt], torch.from_numpy(g).to(tdt))
    else:
        wt = torch.from_numpy(w).to(tdt).requires_grad_()
        y_t = TD.mx_dot(xt, wt, tp)
        dx_t, dw_t = torch.autograd.grad(y_t, [xt, wt],
                                         torch.from_numpy(g).to(tdt))
        assert dw_t.dtype == tdt
        _close(dw_t, dw_j, dtype)
    assert y_t.dtype == tdt and dx_t.dtype == tdt
    _close(y_t, y_j, dtype)
    _close(dx_t, dx_j, dtype)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fig4_quant_pass_counts(backend):
    """Paper Fig. 4: 1D needs 6 passes per step, 2D tiles 3; with a frozen
    packed weight 3 and 2 -- the JAX package's counts."""
    x, w, g = _data("float32", seed=3)
    for block_mode, raw, packed in (("1d", 6, 3), ("2d", 3, 2)):
        tp, jp = _policies(block_mode, True, backend)
        wblk = TD._pol_blocks(tp)[1]
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        with TD.count_quant_passes() as c:
            torch.autograd.grad(TD.mx_dot(xt, wt, tp), [xt, wt],
                                torch.from_numpy(g))
        assert c["n"] == raw, (block_mode, c["n"])
        qw = TD.B.quantize(torch.from_numpy(w), "mxsf", wblk)
        with TD.count_quant_passes() as c:
            torch.autograd.grad(TD.mx_dot(xt, qw, tp), [xt],
                                torch.from_numpy(g))
        assert c["n"] == packed, (block_mode, c["n"])
        with JD.count_quant_passes() as cj:  # counted while tracing
            jax.jit(jax.grad(lambda a, b: (JD.mx_dot(a, b, jp) ** 2).sum(),
                             argnums=(0, 1))).lower(jnp.asarray(x),
                                                    jnp.asarray(w))
        assert cj["n"] == raw


def test_no_grad_forward_emits_no_residual_and_counts_two():
    """A forward with no gradient wanted quantizes w and x (2 passes) and
    equals the forward of the differentiable call."""
    x, w, _ = _data("float32", seed=4)
    tp = TPolicy(block_mode="2d", backend="cuda")
    with torch.no_grad(), TD.count_quant_passes() as c:
        y0 = TD.mx_dot(torch.from_numpy(x), torch.from_numpy(w), tp)
    assert c["n"] == 2
    y1 = TD.mx_dot(torch.from_numpy(x).requires_grad_(),
                   torch.from_numpy(w), tp)
    assert torch.equal(y0, y1.detach())


def test_packed_residuals_bit_identical():
    """Packed (uint8) and value-domain residuals give the same gradients
    bit for bit, and the kernel path saves uint8 residuals only."""
    x, w, g = _data("float32", seed=5)
    grads = {}
    for sp in (True, False):
        tp = TPolicy(block_mode="2d", backend="torch", save_packed=sp)
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        grads[sp] = torch.autograd.grad(TD.mx_dot(xt, wt, tp), [xt, wt],
                                        torch.from_numpy(g))
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.dtype) or t, lambda t: t):
        TD.mx_dot(torch.from_numpy(x).requires_grad_(),
                  torch.from_numpy(w).requires_grad_(),
                  TPolicy(block_mode="2d", backend="cuda"))
    assert saved and all(dt == torch.uint8 for dt in saved)


def test_dense_master_weight_grad_is_rounded_like_jax():
    """Under bf16 compute the weight gradient leaves mx_dot in bf16 before
    the cast back to the f32 master weight, in both packages."""
    x, w, g = _data("bfloat16", seed=6)
    tp, jp = _policies("2d", True, "torch")
    from repro.models import blocks as JBL
    dw_j = jax.jit(jax.grad(
        lambda b: (JBL.dense(jnp.asarray(x, jnp.bfloat16), b, jp)
                   .astype(jnp.float32) * jnp.asarray(g)).sum()))(
        jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    y = TBL.dense(torch.from_numpy(x).to(torch.bfloat16), wt, tp)
    (dw_t,) = torch.autograd.grad((y.float() * torch.from_numpy(g)).sum(),
                                  [wt])
    assert dw_t.dtype == torch.float32
    assert torch.equal(dw_t, dw_t.to(torch.bfloat16).float())
    _close(dw_t, dw_j, "bfloat16")


def _einsum_vjp(subs, policy, a, b, g):
    y, vjp = jax.vjp(lambda a_, b_: JD.mx_einsum(subs, a_, b_, policy), a, b)
    return (y, *vjp(g))


@pytest.mark.parametrize("quantize_bwd", [True, False])
def test_mx_einsum_grads_match_jax(quantize_bwd):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 4, 16, 32)).astype(np.float32)
    k = rng.standard_normal((2, 4, 16, 32)).astype(np.float32)
    g = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    kw = dict(block_mode="1d", block_1d=32, quantize_bwd=quantize_bwd)
    subs = "bhqd,bhkd->bhqk"
    with JD.count_quant_passes() as cj:  # counted while tracing
        y_j, dq_j, dk_j = jax.jit(_einsum_vjp, static_argnums=(0, 1))(
            subs, JPolicy(**kw), jnp.asarray(q), jnp.asarray(k),
            jnp.asarray(g))
    qt = torch.from_numpy(q).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    with TD.count_quant_passes() as c:
        y_t = TD.mx_einsum(subs, qt, kt, TPolicy(**kw))
        dq_t, dk_t = torch.autograd.grad(y_t, [qt, kt], torch.from_numpy(g))
    assert c["n"] == cj["n"] == (4 if quantize_bwd else 2)
    for got, want in ((y_t, y_j), (dq_t, dq_j), (dk_t, dk_j)):
        _close(got, want, "float32")
