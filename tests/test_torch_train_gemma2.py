"""gemma2's training path in the port against the JAX package's, on reduced
gemma2-2b: 2 layers (layer 0 local with the reduced window of 16, layer 1
global), batch 2 x seq 64, both packages' query chunk (``ATTN_CHUNK``) 16
and both ``TrainConfig``s' ``xent_chunk`` 16.  So the query-chunked
attention (4 chunks, each a checkpoint; chunks 1-3 lose keys on layer 0),
the sequence-chunked loss (4 head calls), both softcaps and the tied head
all run.  Parameters, AdamW state and batches come from the JAX package
through numpy (``init_state(PRNGKey(0))``, ``lm_batch``).

Tolerances, and why:

* The unquantized policy in f32, one forward and backward: the two
  packages differ only by f32 summation order and their own rsqrt, exp
  and tanh (~1e-7 relative here).  Loss rtol 1e-5; every gradient leaf,
  ``emb``'s (its lookup plus the tied head) among them, within 1e-5
  relative L2.  Dropping the window or the attention softcap moves them
  far past that, which the negative controls check.
* ``MXSF_TRAIN``, 2D and the 1D layout, one AdamW step from the JAX
  package's state (teacher-forced): ``test_torch_train.py``'s
  tolerances (ROADMAP.md, "Chaos under MX": one f32 ulp on an MX rounding
  midpoint flips a code, which moves the moments by ~1% and the update by
  ~7%): loss rtol 1e-5, grad norm rtol 1e-3, lr rtol 1e-7, moments within
  5e-2 and the update within 2e-1 relative L2, ``emb`` included.
* The training embedding order in bf16: the port's ``_embed_tokens``
  equals the JAX package's bit for bit, at gemma2-2b's width (sqrt(2304)
  = 48 is no power of two, so the order shows; the reduced width's
  sqrt(64) = 8 commutes with any rounding).
* The card script's teacher-forced slice (``chip_smoke.phase_train_slice``)
  on the CPU, as its rehearsal runs it (the kernels' plain versions), on
  the port's own state with the final norm scaled by 40 so the logits
  reach the final softcap, in f32 compute (in bf16 the loss gate's
  tolerance carries one bf16 ulp of logits near the cap, 0.25, about
  what one chunk's mean loss differs from the whole's): it passes, and it
  fails its loss gate without the final softcap or with one head chunk
  read.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import chip_smoke as CS
from repro.configs.base import get_config as jax_config
from repro.core.policy import BF16 as JAX_BF16
from repro.core.policy import MXSF_TRAIN as JAX_TRAIN
from repro.data.pipeline import lm_batch as jax_lm_batch
from repro.models import blocks as JBL
from repro.models import transformer as JTF
from repro.optim import adamw as JA
from repro.train import step as JT
from repro_torch import convert
from repro_torch.configs.base import get_config as torch_config
from repro_torch.core.policy import BF16 as TORCH_BF16
from repro_torch.core.policy import MXSF_TRAIN as TORCH_TRAIN
from repro_torch.models import blocks as TBL
from repro_torch.models import transformer as TTF
from repro_torch.optim import adamw as TA
from repro_torch.train import step as TT

torch.set_num_threads(2)

ARCH = "gemma2-2b"
LAYERS, SEQ, BATCH, CHUNK = 2, 64, 2, 16
OCFG = dict(warmup_steps=2, total_steps=10)
LAYOUTS = {
    "2d": (JAX_TRAIN, TORCH_TRAIN.replace(backend="cuda")),
    "1d": (JAX_TRAIN.replace(block_mode="1d", quantize_bwd=True),
           TORCH_TRAIN.replace(block_mode="1d", quantize_bwd=True,
                               backend="cuda"))}


@pytest.fixture(autouse=True)
def _chunks(monkeypatch):
    """Both packages' query chunk at CHUNK (read when a step is traced or
    run)."""
    monkeypatch.setattr(JBL, "ATTN_CHUNK", CHUNK)
    monkeypatch.setattr(TBL, "ATTN_CHUNK", CHUNK)


def _cfgs(dtype="float32", **kw):
    return tuple(get(ARCH).reduced().replace(n_layers=LAYERS,
                                             compute_dtype=dtype, **kw)
                 for get in (jax_config, torch_config))


def _jax_batch(step):
    toks, labs = jax_lm_batch(0, step, BATCH, SEQ,
                              jax_config(ARCH).reduced().vocab)
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
    return JT.init_state(jax.random.PRNGKey(0), cj, JA.OptConfig(**OCFG))


@pytest.fixture(scope="module")
def jax_side(state0):
    """The JAX package's jitted programs on ``state0`` and the first batch,
    chunked as the module says: the unquantized f32 loss and gradients
    (``"f32"``: (loss, leaves)) and one ``MXSF_TRAIN`` train step of each
    layout (``"2d"``, ``"1d"``: (metrics, new state as leaves)).  Each is
    traced in turn and compiled in a thread of its own (XLA's compile
    runs outside the GIL, beside the next trace)."""
    cj, _ = _cfgs()
    jb = _jax_batch(0)
    tk = JT.TrainConfig(remat="none", xent_chunk=CHUNK)
    progs = {"f32": (jax.value_and_grad(functools.partial(
        JT.loss_fn, cfg=cj, policy=JAX_BF16, tcfg=tk), has_aux=True),
        (state0["params"], jb))}
    for name, (jpol, _) in LAYOUTS.items():
        progs[name] = (JT.make_train_step(cj, jpol, JA.OptConfig(**OCFG), tk),
                       (state0, jb))
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(3) as ex:
        mp.setattr(JBL, "ATTN_CHUNK", CHUNK)
        built = {name: ex.submit(jax.jit(fn).lower(*args).compile)
                 for name, (fn, args) in progs.items()}
        out = {name: f.result()(*progs[name][1]) for name, f in built.items()}
    (loss, _), grads = out.pop("f32")
    return {"f32": (float(loss), _leaves(grads)),
            **{name: ({k: float(v) for k, v in m.items()}, _leaves(new))
               for name, (new, m) in out.items()}}


def _port_f32(state0, **kw):
    """The port's loss and gradients on the JAX package's parameters, the
    config changed by ``kw`` (a negative control)."""
    _, ct = _cfgs(**kw)
    params = convert.params_from_numpy(jax.tree.map(np.array,
                                                    state0["params"]), ct)
    return _port_value_and_grad(params, _torch_batch(_jax_batch(0)), ct,
                                TORCH_BF16, TT.TrainConfig(xent_chunk=CHUNK))


def _f32_faults(got, want):
    """What the unquantized f32 gate rejects: the loss past rtol 1e-5, each
    leaf past 1e-5 relative L2."""
    (loss, grads), (want_loss, want_g) = got, want
    faults = [] if abs(loss - want_loss) <= 1e-5 * abs(want_loss) else [
        "loss"]
    return faults + [k for k in want_g if _rel(grads[k], want_g[k]) > 1e-5]


def test_f32_loss_and_grads_match_jax_through_both_chunkings(
        state0, jax_side, monkeypatch):
    calls = {"lm_head": 0, "_scores_block": 0}
    for mod, name in ((TTF, "lm_head"), (TBL, "_scores_block")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    got = _port_f32(state0)
    assert sorted(got[1]) == sorted(jax_side["f32"][1]) and ("emb",) in got[1]
    assert _f32_faults(got, jax_side["f32"]) == []
    # 4 head calls of 16 rows; 4 query chunks a layer, each run in the
    # forward, in its layer's recompute (remat "dots") and by its own
    # checkpoint in the backward
    assert calls == {"lm_head": SEQ // CHUNK,
                     "_scores_block": 3 * LAYERS * SEQ // CHUNK}


@pytest.mark.parametrize("drop", [dict(swa_pattern="none"),
                                  dict(attn_softcap=0.0)],
                         ids=["window", "attn_softcap"])
def test_dropping_the_window_or_the_attention_softcap_fails_the_gate(
        state0, jax_side, drop):
    """Either moves every gradient leaf past the gate (the window by
    0.72-1.0, the attention softcap by 7e-4 to 2.1e-3 relative L2: at init
    the scores are ~1 against a cap of 50, so the loss moves 2.7e-6 only)."""
    faults = _f32_faults(_port_f32(state0, **drop), jax_side["f32"])
    assert set(jax_side["f32"][1]) <= set(faults), faults


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mxsf_step_matches_jax_teacher_forced(state0, jax_side, layout):
    """One AdamW step of each layout from the JAX package's state.  (A
    second step from the JAX package's next state reads, in 2D, a loss
    1.43e-5 relative from the JAX package's: one code flip, chaos under
    MX; 1D reads 1.5e-6.)"""
    _, ct = _cfgs()
    want, new_j = jax_side[layout]
    st = convert.train_state_from_numpy(jax.tree.map(np.array, state0), ct)
    p0 = _leaves(state0["params"])
    st, got = TT.make_train_step(
        ct, LAYOUTS[layout][1], TA.OptConfig(**OCFG),
        TT.TrainConfig(xent_chunk=CHUNK))(st, _torch_batch(_jax_batch(0)))
    got = {k: float(v) for k, v in got.items()}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-3)
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-7)
    new_t = _tleaves(st)
    params = [k for k in new_j if k[0] == "params"]
    assert ("params", "emb") in params
    for k in params:
        assert _rel(new_t[k] - p0[k[1:]], new_j[k] - p0[k[1:]]) <= 2e-1, k
    for k in new_j:
        if k[:2] in (("opt", "m"), ("opt", "v")):
            assert _rel(new_t[k], new_j[k]) <= 5e-2, k


def test_training_embedding_order_is_the_jax_packages():
    """bf16 at gemma2-2b's width: scale in f32, then cast -- bit for bit
    the JAX package's ``_embed_tokens``, and not the cached decoder's
    cast-then-scale on these rows."""
    cj, ct = (c.replace(d_model=2304) for c in _cfgs("bfloat16"))
    rng = np.random.default_rng(0)
    emb = (rng.standard_normal((cj.vocab, 2304)) * 0.02).astype(np.float32)
    toks = rng.integers(0, cj.vocab, (BATCH, SEQ)).astype(np.int32)
    want = np.asarray(JTF._embed_tokens({"emb": emb}, {"tokens": toks}, cj)
                      .astype(np.float32))
    got = TTF._embed_tokens({"emb": torch.from_numpy(emb)},
                            {"tokens": torch.from_numpy(toks)}, ct)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    cached = TTF.embed_tokens({"emb": torch.from_numpy(emb)},
                              torch.from_numpy(toks), ct)
    assert not torch.equal(cached, got)


@pytest.fixture(scope="module")
def slice_run():
    """``phase_train_slice``'s inputs as the rehearsal builds them: the
    port's reduced gemma2-2b state (the final norm scaled by 40, so the
    logits reach the final softcap of 30) and a batch of ``lm_batch``."""
    cfg = torch_config(ARCH).reduced().replace(n_layers=LAYERS,
                                               compute_dtype="float32")
    state = TT.init_state(torch.Generator().manual_seed(0), cfg,
                          TA.OptConfig(), device="cpu")
    state["params"]["final_norm"]["w"].mul_(40.0)
    batch = CS.make_batches(torch, cfg, 0, 1, BATCH, SEQ,
                            torch.device("cpu"))[0]
    return cfg, state, batch


def _slice(slice_run):
    cfg, state, batch = slice_run
    return CS.phase_train_slice(
        torch, torch.device("cpu"), cfg, LAYOUTS["2d"][1], state, batch,
        "test", tcfg=TT.TrainConfig(xent_chunk=CHUNK))


def test_train_slice_holds_every_head_chunk_with_the_softcap(slice_run,
                                                             capsys):
    rows = _slice(slice_run)
    assert rows["mxsf_fused_matmul"]["calls"] == (
        CS.layer_matmuls(slice_run[0]) + SEQ // CHUNK)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if '"loss_plain_head"' in ln][-1]
    assert f'"head_calls": {SEQ // CHUNK}' in line


@pytest.mark.parametrize("fault", ["no_final_softcap", "one_head_chunk"])
def test_train_slice_loss_gate_rejects(slice_run, monkeypatch, fault):
    if fault == "no_final_softcap":
        sums = CS.head_sums
        monkeypatch.setattr(CS, "head_sums", lambda torch, cfg, *a: sums(
            torch, cfg.replace(final_softcap=0.0), *a))
    else:
        loss = CS.plain_head_loss
        monkeypatch.setattr(CS, "plain_head_loss",
                            lambda heads: loss(heads[-1:]))
    with pytest.raises(AssertionError, match="'loss'"):
        _slice(slice_run)
