"""The port's encoder family (deit-tiny) and codec leftovers against the JAX
package, on the CPU at the reduced deit-tiny config (4 layers, d 64, 8
patch tokens + cls, 100 classes).

Parameters come from the JAX package (``init_params(PRNGKey(0))``) through
``convert``; batches from its ``vision_batch`` through numpy.  The JAX side
runs its value-domain backend, the port both of its backends (``"cuda"`` on
CPU tensors takes the kernels' plain versions).

Tolerances, and why (those of ``tests/test_torch_train.py``):

* float32: the packages differ by f32 summation order and their own
  rsqrt/exp routines (~1e-6 relative): logits and loss rtol 1e-5, every
  gradient leaf within 1e-4 relative L2.
* bfloat16: bf16 rounds at other places in the two frameworks, and a
  one-ulp difference becomes an MX code step, so the port's loss and
  gradients must be no farther from the JAX package's bf16 results than
  those are from its own f32 results.
* The codec leftovers are exact: bitwise, or the same f32 powers of two
  (rtol 1e-6 for the error bound, whose powers XLA computes through pow).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import get_config as jax_config
from repro.core import blocking as JB
from repro.core import formats as JF
from repro.core.policy import MXSF_TRAIN as JAX_TRAIN
from repro.data.pipeline import vision_batch as jax_vision_batch
from repro.models import blocks as JBL
from repro.models import model as JM
from repro.train import step as JT
from repro_torch import convert
from repro_torch.configs.base import get_config as torch_config
from repro_torch.core import blocking as TB
from repro_torch.core import formats as TF
from repro_torch.core.policy import MXSF_TRAIN as TORCH_TRAIN
from repro_torch.core.policy import QuantPolicy
from repro_torch.data.pipeline import vision_batch
from repro_torch.models import blocks as TBL
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import step as TS

torch.set_num_threads(2)

ARCH = "deit-tiny-reduced"
BATCH = 4
FMTS = ["mxsf", "mxfp8_e4m3", "mxfp8_e2m5", "mxint8", "mxfp4_e2m1"]


def _cfgs(dtype="float32"):
    return (jax_config(ARCH).replace(compute_dtype=dtype),
            torch_config(ARCH).replace(compute_dtype=dtype))


def _jax_batch(step=0):
    cfg = jax_config(ARCH)
    x, y = jax_vision_batch(0, step, BATCH, cfg.frontend_tokens, cfg.d_model,
                            cfg.n_classes)
    return {"embeds": x, "label": y}


def _torch_batch(jb):
    return {k: convert.tensor_from_numpy(np.asarray(v))
            for k, v in jb.items()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def params0():
    cj, _ = _cfgs()
    return JM.init_params(jax.random.PRNGKey(0), cj)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_value_and_grad(params, batch, cfg, policy, tcfg):
    return jax.value_and_grad(JT.loss_fn, has_aux=True)(params, batch, cfg,
                                                        policy, tcfg)


@pytest.fixture(scope="module")
def jax_grads(params0):
    """The JAX package's step-0 (loss, acc, grads) in f32 and bf16."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        cj, _ = _cfgs(dtype)
        (loss, aux), g = _jax_value_and_grad(params0, _jax_batch(), cj,
                                             JAX_TRAIN,
                                             JT.TrainConfig(remat="none"))
        out[dtype] = (float(loss), float(aux["acc"]), dict(TS._flatten(
            jax.tree.map(lambda a: np.asarray(a, np.float32), g))))
    return out


# ---------------------------------------------------------------------------
# the deit-tiny rows of tests/test_models_smoke.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_forward_shapes_and_one_train_step(backend):
    cfg = torch_config(ARCH)
    pol = QuantPolicy(block_mode="2d", tile=8, block_1d=16, backend=backend)
    gen = torch.Generator().manual_seed(0)
    state = TS.init_state(gen, cfg, OptConfig(lr=1e-3, total_steps=10),
                          device="cpu")
    batch = {"embeds": torch.ones((2, cfg.frontend_tokens, cfg.d_model),
                                  dtype=torch.bfloat16),
             "label": torch.zeros(2, dtype=torch.int32)}
    logits = TT.forward(state["params"], batch, cfg, pol)
    assert logits.shape == (2, cfg.n_classes) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    before = [t.clone() for _, t in TS._flatten(state["params"])]
    step = TS.make_train_step(cfg, pol, OptConfig(lr=1e-3, total_steps=10),
                              TS.TrainConfig())
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert 0.0 <= float(metrics["acc"]) <= 1.0
    assert any(not torch.equal(a, b) for a, (_, b) in
               zip(before, TS._flatten(state["params"])))


def test_encoder_tree_has_the_jax_layout(params0):
    """Stacked (n_layers, ...) layers with no sub{j} level, cls, pos and a
    classifier head -- leaf for leaf the JAX package's tree."""
    _, ct = _cfgs()
    mine = TT.init_params(ct, torch.Generator().manual_seed(0))
    want = {k: np.shape(v) for k, v in TS._flatten(params0)}
    got = {k: tuple(v.shape) for k, v in TS._flatten(mine)}
    assert got == want
    assert "sub0" not in mine["layers"]
    assert not mine["cls"].any()


# ---------------------------------------------------------------------------
# forward logits, step-0 loss and gradients against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_forward_logits_match_jax(params0, backend):
    cj, ct = _cfgs()
    want = np.asarray(jax.jit(JM.forward, static_argnums=(2, 3))(
        params0, _jax_batch(), cj, JAX_TRAIN))
    params = convert.params_from_numpy(jax.tree.map(np.array, params0), ct)
    got = TT.forward(params, _torch_batch(_jax_batch()), ct,
                     TORCH_TRAIN.replace(backend=backend))
    assert got.shape == want.shape == (BATCH, ct.n_classes)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step0_loss_and_grads_match_jax(params0, jax_grads, backend, dtype):
    _, ct = _cfgs(dtype)
    params = convert.params_from_numpy(jax.tree.map(np.array, params0), ct)
    pairs = TS._flatten(params)
    leaves = [v.detach().requires_grad_() for _, v in pairs]
    tree = TS._unflatten((k, v) for (k, _), v in zip(pairs, leaves))
    loss, aux = TS.loss_fn(tree, _torch_batch(_jax_batch()), ct,
                           TORCH_TRAIN.replace(backend=backend),
                           TS.TrainConfig())
    grads = {k: g.float().numpy() for (k, _), g in
             zip(pairs, torch.autograd.grad(loss, leaves))}
    loss = float(loss.detach())
    want_loss, want_acc, want = jax_grads[dtype]
    assert sorted(grads) == sorted(want)
    assert float(aux["acc"]) == want_acc
    if dtype == "float32":
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        for k in want:
            assert _rel(grads[k], want[k]) <= 1e-4, k
        return
    f32_loss, _, f32 = jax_grads["float32"]
    assert abs(loss - want_loss) <= abs(want_loss - f32_loss)
    for k in want:
        assert _rel(grads[k], want[k]) <= _rel(want[k], f32[k]), k


def test_convert_takes_the_encoder_stack(params0):
    _, ct = _cfgs()
    tree = jax.tree.map(np.array, params0)
    params = convert.params_from_numpy(tree, ct)
    assert params["layers"]["attn"]["wq"].shape[0] == ct.n_layers
    cut = dict(tree, layers=jax.tree.map(lambda a: a[:2], tree["layers"]))
    with pytest.raises(ValueError, match="leading dim 2"):
        convert.params_from_numpy(cut, ct)


def test_vision_batch_shapes_and_determinism():
    x, y = vision_batch(3, 5, 8, 6, 16, 10, device="cpu")
    assert x.shape == (8, 6, 16) and x.dtype == torch.bfloat16
    assert y.shape == (8,) and y.dtype == torch.int32
    assert bool(((y >= 0) & (y < 10)).all())
    again = vision_batch(3, 5, 8, 6, 16, 10, device="cpu")
    assert torch.equal(x, again[0]) and torch.equal(y, again[1])
    other = vision_batch(3, 6, 8, 6, 16, 10, device="cpu")
    assert not torch.equal(x, other[0])
    # one fixed prototype per class: two draws of a class differ by noise
    # alone (std 1.5 sqrt 2), draws of two classes by the prototypes too
    xs, ys = vision_batch(0, 0, 256, 4, 32, 2, device="cpu")
    xs = xs.float()
    same = (xs[ys == 0][:1] - xs[ys == 0][1:2]).std()
    cross = (xs[ys == 0][:1] - xs[ys == 1][:1]).std()
    assert 1.6 < float(same) < 2.7 and float(cross) > float(same)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision_batch(0, 0, 2, 4, 8, 10)


def test_forward_hidden_and_other_families_raise():
    """The encoder has no LM hidden states; the other families, ported
    since, build their parameter trees (the JAX package's layout)."""
    _, ct = _cfgs()
    with pytest.raises(ValueError, match="use forward"):
        TT.forward_hidden({}, {}, ct, TORCH_TRAIN)
    whisper = TT.init_params(torch_config("whisper-medium-reduced"),
                             torch.Generator())
    assert {"enc_layers", "dec_layers", "enc_norm"} <= set(whisper)
    mamba = TT.init_params(torch_config("mamba2-780m-reduced"),
                           torch.Generator())
    assert mamba["layers"]["ssd"]["in_proj"].shape[0] == 4


# ---------------------------------------------------------------------------
# codec leftovers: format offsets, Eq. 5-6, exponent gaps, layernorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", sorted(JF.FORMATS))
def test_format_offsets_match_jax(fmt):
    j, t = JF.get_format(fmt), TF.get_format(fmt)
    assert (t.emax_offset, t.emin_offset, t.max_rel) == \
        (j.emax_offset, j.emin_offset, j.max_rel)


@pytest.mark.parametrize("fmt", FMTS)
def test_error_bound_matches_jax(fmt):
    gap = np.arange(0, 40, dtype=np.float32)
    for s_e in (0.0, -7.0, 12.0):
        want = np.asarray(JF.max_quant_error_bound(
            jnp.asarray(gap), JF.get_format(fmt), s_e=jnp.float32(s_e)))
        got = TF.max_quant_error_bound(torch.from_numpy(gap),
                                       TF.get_format(fmt), s_e=s_e)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_eq56_error_crossover():
    """Paper SIII-A: INT8 wins only at gap 0; equal at 1; E2M5 wins after."""
    g = torch.arange(0, 8, dtype=torch.float32)
    e_int = TF.max_quant_error_bound(g, TF.get_format("mxint8")).numpy()
    e_fp = TF.max_quant_error_bound(g, TF.get_format("mxfp8_e2m5")).numpy()
    assert e_int[0] < e_fp[0]
    assert e_int[1] == pytest.approx(e_fp[1])
    assert (e_int[2:] > e_fp[2:]).all()


_LIM = float(np.float32(1e20))
finite_f32 = st.floats(min_value=-_LIM, max_value=_LIM, allow_nan=False,
                       allow_infinity=False, width=32)


@st.composite
def small_arrays(draw, max_rows=6, cols=32):
    rows = draw(st.integers(1, max_rows))
    data = draw(st.lists(finite_f32, min_size=rows * cols,
                         max_size=rows * cols))
    return np.asarray(data, np.float32).reshape(rows, cols)


def _block_se(x):
    amax = np.abs(x).max(axis=-1, keepdims=True)
    se = np.where(amax > 0, np.floor(np.log2(np.maximum(amax, 1e-300))), 0)
    return np.broadcast_to(se, x.shape).astype(np.float32)


@settings(max_examples=40, deadline=None)
@given(x=small_arrays(), fmt=st.sampled_from(FMTS))
def test_error_bound_halfulp(x, fmt):
    """|q(x) - x| <= half ULP at each element's regime (Eq. 5-6)."""
    xt = torch.from_numpy(x)
    q = TB.qdq(xt, fmt, (32,)).numpy().astype(np.float64)
    gaps = TB.exponent_gaps(xt, (32,))
    bound = TF.max_quant_error_bound(
        torch.clamp(gaps, max=60).float(), TF.get_format(fmt),
        s_e=torch.from_numpy(_block_se(x))).numpy().astype(np.float64)
    gaps = gaps.numpy()
    # top-of-format clamp (gap == 0 binade) can reach one full ULP
    bound = np.where(gaps == 0, bound * 2, bound)
    err = np.abs(q - x.astype(np.float64))
    ok = err <= bound * (1 + 1e-6) + 1e-30
    assert ok.all(), (x[~ok][:3], err[~ok][:3], bound[~ok][:3])


@pytest.mark.parametrize("block", [(32,), (8, 8), (16, 1)])
def test_exponent_gaps_and_scaled_view_match_jax(block):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((20, 40))
         * np.exp2(rng.integers(-30, 30, (20, 40)))).astype(np.float32)
    x[3, :7] = 0.0
    gaps = TB.exponent_gaps(torch.from_numpy(x), block)
    assert gaps.dtype == torch.int32
    np.testing.assert_array_equal(gaps.numpy(), np.asarray(jax.jit(
        JB.exponent_gaps, static_argnums=1)(jnp.asarray(x), block)))
    assert int(gaps[3, 0]) == 127  # zeros
    qt_j = jax.jit(JB.quantize, static_argnums=(1, 2))(jnp.asarray(x),
                                                       "mxsf", block)
    qt_t = TB.quantize(torch.from_numpy(x), "mxsf", block)
    for got, want in zip(TB.block_scaled_view(qt_t),
                         jax.jit(JB.block_scaled_view)(qt_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 48)) * 3 + 1).astype(np.float32)
    p = {"w": rng.standard_normal(48).astype(np.float32),
         "b": rng.standard_normal(48).astype(np.float32)}
    want = np.asarray(JBL.layernorm(jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(x).astype(dtype)),
                      np.float32)
    got = TBL.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2 ** -7  # one bf16 ulp
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)
    init = TBL.layernorm_init(48)
    assert torch.equal(init["w"], torch.ones(48))
    assert torch.equal(init["b"], torch.zeros(48))
