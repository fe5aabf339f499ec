"""The port's training path against the JAX package's, on reduced
h2o-danube-1.8b at seq 32 (longer than the reduced SWA window of 16, so
the window mask bites).

Parameters and AdamW state come from the JAX package
(``init_state(PRNGKey(0))``) through ``convert``; batches from its
``lm_batch`` through numpy.  The JAX side runs the value-domain backend
(``"jnp"``), which its own tests hold bit-identical to ``"pallas"`` at these
sizes; the port runs both its backends (``"cuda"`` on CPU tensors takes the
kernels' plain versions).

Tolerances, and why:

* float32, one forward/backward: the two packages differ by f32 summation
  order and their own rsqrt/exp routines (~1e-6 relative).  Loss rtol
  1e-5; every gradient leaf within 1e-4 relative L2.  A difference that
  lands on an MX rounding midpoint flips one code and moves the gradients
  by ~1% (see the MXSF steps below); at step 0 of these inputs none does.
* bfloat16: bf16 rounds at other places in the two frameworks (silu, the
  order of autodiff's products), and a one-ulp difference becomes an MX
  code step.  The port's loss and gradients must be no farther from the
  JAX package's bf16 results than those are from its own f32 results.
* AdamW steps, unquantized policy: the first AdamW update is +-lr for any
  |g| >> eps, which turns ~1e-6 gradient differences into ~1e-4 relative
  update differences: updates within 1e-3 and moments within 1e-4
  relative L2.  With ``grad_compress`` the gradients are MX-quantized, so
  a midpoint flip moves a moment by a code step: 1e-2.
* AdamW steps, ``MXSF_TRAIN``, each step from the JAX package's state: one
  code flipped by f32 order moves the moments by ~1.3% and the update by
  ~7% relative L2 (measured at the second step); loss rtol 1e-5,
  grad_norm rtol 1e-3, moments within 5e-2, updates within 2e-1.  The
  per-operation tests (``test_torch_mx_dot_grad.py``,
  ``test_torch_train_kernels.py``) hold each kernel call tightly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core.policy import BF16 as JAX_BF16
from repro.core.policy import MXSF_TRAIN as JAX_TRAIN
from repro.data.pipeline import lm_batch as jax_lm_batch
from repro.models import blocks as JBL
from repro.optim import adamw as JA
from repro.train import step as JT
from repro_torch import convert
from repro_torch.configs.base import get_config as torch_config
from repro_torch.core.packed_store import tree_map
from repro_torch.core.policy import BF16 as TORCH_BF16
from repro_torch.core.policy import MXSF_TRAIN as TORCH_TRAIN
from repro_torch.data.pipeline import lm_batch
from repro_torch.launch import train as cli
from repro_torch.models import blocks as TBL
from repro_torch.optim import adamw as TA
from repro_torch.train import step as TT

torch.set_num_threads(2)

ARCH = "h2o-danube-1.8b-reduced"
SEQ, BATCH = 32, 2


def _cfgs(dtype="float32", **kw):
    return (jax_config(ARCH).replace(compute_dtype=dtype, **kw),
            torch_config(ARCH).replace(compute_dtype=dtype, **kw))


def _jax_batch(step, batch=BATCH):
    toks, labs = jax_lm_batch(0, step, batch, SEQ, jax_config(ARCH).vocab)
    return {"tokens": toks, "labels": labs}


def _torch_batch(jb):
    return {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _leaves(tree):
    return dict(TT._flatten(jax.tree.map(
        lambda a: np.asarray(a, np.float32), tree)))


def _tleaves(tree):
    return {k: v.detach().float().numpy() for k, v in TT._flatten(tree)}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_value_and_grad(params, batch, cfg, policy, tcfg):
    return jax.value_and_grad(JT.loss_fn, has_aux=True)(params, batch, cfg,
                                                        policy, tcfg)


def _port_value_and_grad(params, batch, cfg, policy, tcfg):
    pairs = TT._flatten(params)
    leaves = [v.detach().requires_grad_() for _, v in pairs]
    tree = TT._unflatten((k, v) for (k, _), v in zip(pairs, leaves))
    loss, _ = TT.loss_fn(tree, batch, cfg, policy, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), {k: g.float().numpy()
                                  for (k, _), g in zip(pairs, grads)}


@pytest.fixture(scope="module")
def state0():
    cj, _ = _cfgs()
    return JT.init_state(jax.random.PRNGKey(0), cj, JA.OptConfig())


@pytest.fixture(scope="module")
def jax_grads(state0):
    """The JAX package's step-0 (loss, grads) in f32 and bf16 compute."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        cj, _ = _cfgs(dtype)
        (loss, _), g = _jax_value_and_grad(state0["params"], _jax_batch(0),
                                           cj, JAX_TRAIN,
                                           JT.TrainConfig(remat="none"))
        out[dtype] = (float(loss), _leaves(g))
    return out


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step0_loss_and_grads_match_jax(state0, jax_grads, backend, dtype):
    _, ct = _cfgs(dtype)
    params = convert.params_from_numpy(jax.tree.map(np.array,
                                                    state0["params"]), ct)
    loss, grads = _port_value_and_grad(
        params, _torch_batch(_jax_batch(0)), ct,
        TORCH_TRAIN.replace(backend=backend), TT.TrainConfig())
    want_loss, want = jax_grads[dtype]
    assert sorted(grads) == sorted(want)
    if dtype == "float32":
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        for k in want:
            assert _rel(grads[k], want[k]) <= 1e-4, k
        return
    f32_loss, f32 = jax_grads["float32"]
    assert abs(loss - want_loss) <= abs(want_loss - f32_loss)
    for k in want:
        assert _rel(grads[k], want[k]) <= _rel(want[k], f32[k]), k


def test_chunked_attention_matches_jax(state0, monkeypatch):
    """Query-chunked attention (each chunk a torch.utils.checkpoint) with 4
    chunks of 8 queries, against the JAX package chunked the same way."""
    monkeypatch.setattr(JBL, "ATTN_CHUNK", 8)
    monkeypatch.setattr(TBL, "ATTN_CHUNK", 8)
    cj, ct = _cfgs(n_layers=1)
    jp = jax.tree.map(lambda a: a[:1], state0["params"]["layers"])
    pj = dict(state0["params"], layers=jp)
    (want_loss, _), want = _jax_value_and_grad(
        pj, _jax_batch(0), cj, JAX_TRAIN, JT.TrainConfig(remat="none"))
    want = _leaves(want)
    params = convert.params_from_numpy(jax.tree.map(np.array, pj), ct)
    loss, grads = _port_value_and_grad(
        params, _torch_batch(_jax_batch(0)), ct,
        TORCH_TRAIN.replace(backend="cuda"), TT.TrainConfig())
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    for k in want:
        assert _rel(grads[k], want[k]) <= 1e-4, k


def test_remat_full_equals_none_and_dots_raises(state0):
    _, ct = _cfgs()
    params = convert.params_from_numpy(jax.tree.map(np.array,
                                                    state0["params"]), ct)
    batch = _torch_batch(_jax_batch(0))
    pol = TORCH_TRAIN.replace(backend="cuda")
    l0, g0 = _port_value_and_grad(params, batch, ct, pol, TT.TrainConfig())
    l1, g1 = _port_value_and_grad(params, batch, ct, pol,
                                  TT.TrainConfig(remat="full"))
    assert l0 == l1
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k])
    with pytest.raises(NotImplementedError, match="dots"):
        TT.loss_fn(params, batch, ct, pol, TT.TrainConfig(remat="dots"))


def _run_steps(cj, ct, jpol, tpol, tk, steps, teacher_forced):
    """(per-step JAX and port metrics, final states) of ``steps`` train
    steps; with ``teacher_forced`` each port step starts from the JAX
    package's state."""
    ocfg = dict(warmup_steps=2, total_steps=10)
    sj = JT.init_state(jax.random.PRNGKey(0), cj, JA.OptConfig(**ocfg))
    fj = jax.jit(JT.make_train_step(cj, jpol, JA.OptConfig(**ocfg),
                                    JT.TrainConfig(remat="none", **tk)))
    ft = TT.make_train_step(ct, tpol, TA.OptConfig(**ocfg),
                            TT.TrainConfig(**tk))
    st = convert.train_state_from_numpy(jax.tree.map(np.array, sj), ct)
    rows = []
    for i in range(steps):
        if teacher_forced:
            st = convert.train_state_from_numpy(jax.tree.map(np.array, sj),
                                                ct)
        p0 = _leaves(sj["params"])
        jb = _jax_batch(i)
        sj, mj = fj(sj, jb)
        st, mt = ft(st, _torch_batch(jb))
        rows.append(dict(
            jax={k: float(v) for k, v in mj.items()},
            port={k: float(v) for k, v in mt.items()},
            update=max(_rel(_tleaves(st["params"])[k] - p0[k],
                            v - p0[k])
                       for k, v in _leaves(sj["params"]).items()),
            moments=max(_rel(_tleaves(st["opt"][n])[k], v)
                        for n in ("m", "v")
                        for k, v in _leaves(sj["opt"][n]).items()),
            step=(int(sj["opt"]["step"]), int(st["opt"]["step"]))))
    return rows


@pytest.mark.parametrize("tk,moment_tol", [
    ({}, 1e-4),
    (dict(microbatches=2, xent_chunk=16, grad_compress="mxsf"), 1e-2)],
    ids=["plain", "microbatch-chunked-compressed"])
def test_adamw_steps_match_jax_unquantized(tk, moment_tol):
    cj, ct = _cfgs(n_layers=2)
    rows = _run_steps(cj, ct, JAX_BF16, TORCH_BF16, tk, steps=3,
                      teacher_forced=False)
    for i, r in enumerate(rows):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(r["port"][key], r["jax"][key],
                                       rtol=1e-5, err_msg=f"{i} {key}")
        assert r["update"] <= 1e-3 and r["moments"] <= moment_tol, (i, r)
        assert r["step"] == (i + 1, i + 1)


def test_adamw_steps_match_jax_mxsf_teacher_forced():
    cj, ct = _cfgs(n_layers=2)
    rows = _run_steps(cj, ct, JAX_TRAIN, TORCH_TRAIN.replace(backend="cuda"),
                      {}, steps=3, teacher_forced=True)
    for i, r in enumerate(rows):
        np.testing.assert_allclose(r["port"]["loss"], r["jax"]["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(r["port"]["grad_norm"],
                                   r["jax"]["grad_norm"], rtol=1e-3)
        np.testing.assert_allclose(r["port"]["lr"], r["jax"]["lr"],
                                   rtol=1e-7)
        assert r["moments"] <= 5e-2 and r["update"] <= 2e-1, (i, r)
        assert r["step"] == (i + 1, i + 1)


def test_apply_updates_matches_jax_on_the_same_grads():
    """The optimizer alone, on identical gradients: elementwise f32 ops in
    the same order, so rtol 1e-6 (sqrt and pow may differ by an ulp);
    global-norm clipping and bf16 params with f32 master weights."""
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 16), "b": {"c": (16,), "d": (4, 4, 4)}}
    mk = lambda s, scale: (rng.standard_normal(s) * scale).astype(np.float32)
    p = jax.tree.map(lambda s: mk(s, 1.0), shapes,
                     is_leaf=lambda s: isinstance(s, tuple))
    for param_dtype in ("float32", "bfloat16"):
        ocfg = dict(warmup_steps=3, total_steps=20, clip_norm=0.5,
                    master_weights=param_dtype != "float32")
        jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(param_dtype),
                               p)
        jstate = JA.init_opt_state(jax.tree.map(jnp.asarray, p),
                                   JA.OptConfig(**ocfg))
        tparams = tree_map(lambda a: torch.from_numpy(a).to(
            getattr(torch, param_dtype)), p)
        tstate = TA.init_opt_state(tree_map(torch.from_numpy, p),
                                   TA.OptConfig(**ocfg))
        for _ in range(4):
            g = jax.tree.map(lambda a: mk(a.shape, 3.0), p)
            jparams, jstate, jm = JA.apply_updates(
                jparams, jax.tree.map(jnp.asarray, g), jstate,
                JA.OptConfig(**ocfg))
            tparams, tstate, tm = TA.apply_updates(
                tparams, tree_map(torch.from_numpy, g), tstate,
                TA.OptConfig(**ocfg))
            for key in ("lr", "grad_norm"):
                np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                           rtol=1e-6)
        for got, want in ((tparams, jparams), (tstate["m"], jstate["m"]),
                          (tstate["v"], jstate["v"])):
            want = _leaves(want)
            for k, v in _tleaves(got).items():
                np.testing.assert_allclose(v, want[k], rtol=1e-6,
                                           atol=1e-7 * np.abs(want[k]).max())
        if param_dtype != "float32":
            want = _leaves(jstate["master"])
            for k, v in _tleaves(tstate["master"]).items():
                np.testing.assert_allclose(v, want[k], rtol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"]) == 4


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_schedule_matches_jax(schedule):
    kw = dict(lr=3e-4, warmup_steps=5, total_steps=40, schedule=schedule)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 100):
        np.testing.assert_allclose(
            float(TA.lr_at(torch.tensor(step, dtype=torch.int32),
                           TA.OptConfig(**kw))),
            float(JA.lr_at(jnp.int32(step), JA.OptConfig(**kw))), rtol=1e-6)


def test_lm_batch_shapes_labels_and_determinism():
    toks, labs = lm_batch(3, 5, 4, 24, 97, device="cpu")
    assert toks.shape == labs.shape == (4, 24)
    assert toks.dtype == labs.dtype == torch.int32
    assert bool(((toks >= 0) & (toks < 97)).all())
    assert torch.equal(toks[:, 1:], labs[:, :-1])  # labels = next token
    again = lm_batch(3, 5, 4, 24, 97, device="cpu")
    assert torch.equal(toks, again[0]) and torch.equal(labs, again[1])
    other = lm_batch(3, 6, 4, 24, 97, device="cpu")
    assert not torch.equal(toks, other[0])
    # the chain follows the table: most steps land on a favourite successor
    from repro_torch.data.pipeline import make_transition
    trans = make_transition(3, 97, device="cpu")
    toks, labs = lm_batch(3, 0, 16, 64, 97, device="cpu")
    fav = trans.topk(4, dim=-1).indices
    hit = (fav[toks.long()] == labs.long()[..., None]).any(-1)
    assert float(hit.float().mean()) > 0.5


def test_training_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` means CUDA: without a card the training state and the
    batches raise instead of quietly building on the CPU."""
    from repro_torch.data.pipeline import make_transition
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_config(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_state(torch.Generator().manual_seed(0), cfg, TA.OptConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_batch(0, 0, 2, 8, 97)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_transition(0, 97)


def test_cli_trains_on_cpu(capsys):
    state = cli.main(["--arch", ARCH, "--steps", "2", "--batch", "2",
                      "--seq", "32", "--device", "cpu", "--log-every", "1"])
    out = capsys.readouterr().out
    losses = [float(ln.split("loss=")[1].split()[0])
              for ln in out.splitlines() if ln.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert abs(losses[0] - np.log(256)) < 0.5  # near ln(vocab) at init
    assert int(state["opt"]["step"]) == 2
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        cli.main(["--arch", ARCH, "--steps", "1", "--device", "cpu",
                  "--ckpt-dir", "unused"])
