"""The port's value-domain cached attention against the JAX package's, on
reduced gemma2-2b (attention and final softcaps, alternating SWA with
window 16, sandwich norms) over a value cache.  The same runner
(``run_steps``) holds gemma2-9b's packed cache on the kernel datapath in
``test_torch_value_cache_packed.py`` and the all-SWA ring cache of reduced
h2o-danube-1.8b in ``test_torch_ring_cache.py`` (the JAX package's
compiles take most of each file's time, so the cases run as three
files).

Weights are the JAX package's (``init_params(PRNGKey(0))``) carried across
by ``convert``; tokens come from a numpy seed.  Each case runs the same
calls through both packages: four 8-token ``prefill_step`` chunks over two
slots (the second slot's last chunk holds 5 valid tokens), so queries pass
the window at position 16, then four ``decode_step``s.  The JAX side is
jitted and runs as its own tests run it (``backend="jnp"``; ``"pallas"``
in interpret mode for the kernel datapath); the port runs ``"torch"`` or
``"cuda"`` on CPU tensors (the kernels' plain versions).

Tolerances, and why:

* float32 compute: the packages differ by f32 summation order and their
  own tanh/rsqrt/exp/sin/cos (~2e-7 of the largest logit measured):
  logits rtol 1e-5 and atol 1e-5 of the largest logit, value caches the
  same; packed cache bytes bitwise (the K/V rows quantize identically).
* bfloat16 compute: bf16 rounds at other places in the two frameworks and
  a one-ulp difference becomes an MX code step (measured 3-6% relative L2
  of the logits).  The port's logits must be no farther (relative L2) from
  the JAX package's bf16 logits than those are from its own f32 logits
  (measured 5-13%), as ``test_torch_train.py`` holds bf16 gradients.
* ``kpos`` (the absolute position held by each cache column) is integer
  math: bitwise, captured in both packages where the mask is built.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core.policy import MXSF_INFER as JAX_INFER
from repro.models import blocks as JB
from repro.models import model as JM
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs.base import get_config as torch_config
from repro_torch.core.policy import MXSF_INFER as TORCH_INFER
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(2)

B, C, MAX_LEN = 2, 8, 40
JAX_BACKEND = {"torch": "jnp", "cuda": "pallas"}


def calls():
    """(kind, tokens, pos, n_valid) of one case, from a fixed seed."""
    rng = np.random.default_rng(0)
    out, pos = [], np.zeros(B, np.int32)
    for c in range(4):
        nv = np.array([C, C if c < 3 else 5], np.int32)
        out.append(("prefill", rng.integers(0, 256, size=(B, C)).astype(
            np.int32), pos.copy(), nv))
        pos = pos + nv
    for _ in range(4):
        out.append(("decode", rng.integers(0, 256, size=(B, 1)).astype(
            np.int32), pos.copy(), None))
        pos = pos + 1
    return out


def cfgs(arch, dtype, **kw):
    return (jax_config(arch).reduced().replace(compute_dtype=dtype, **kw),
            torch_config(arch).reduced().replace(compute_dtype=dtype, **kw))


@functools.lru_cache(maxsize=None)
def params(arch):
    cj, ct = cfgs(arch, "float32")
    pj = JM.init_params(jax.random.PRNGKey(0), cj)
    return pj, convert.params_from_numpy(jax.tree.map(np.asarray, pj), ct)


def _record_kpos(monkeypatch, sink):
    """Append the ``kpos`` of every cached attention call in both packages
    to ``sink["jax"]`` / ``sink["torch"]`` (the JAX one through a host
    callback, since it runs jitted: the callback reads ``sink`` when it
    fires, so the caller may swap in new lists between calls)."""
    jax_mask, torch_mask = JB._attn_mask_bias, TB._attn_mask_bias

    def jax_wrap(qpos, kpos, **kw):
        jax.debug.callback(lambda k: sink["jax"].append(np.asarray(k)),
                           kpos, ordered=True)
        return jax_mask(qpos, kpos, **kw)

    def torch_wrap(qpos, kpos, **kw):
        sink["torch"].append(kpos.numpy().copy())
        return torch_mask(qpos, kpos, **kw)

    monkeypatch.setattr(JB, "_attn_mask_bias", jax_wrap)
    monkeypatch.setattr(TB, "_attn_mask_bias", torch_wrap)


@functools.lru_cache(maxsize=None)
def run_steps(arch, kv_fmt, dtype, backend="torch", ring=True):
    """Both packages through ``calls()`` on one case: per call the logits
    (and the ``kpos`` of each layer's attention), the final caches."""
    cj, ct = cfgs(arch, dtype)
    pj, pt = params(arch)
    pol_j = JAX_INFER.replace(backend=JAX_BACKEND[backend],
                              kv_cache_fmt=kv_fmt)
    pol_t = TORCH_INFER.replace(backend=backend, kv_cache_fmt=kv_fmt)
    if backend == "cuda":
        pj = JM.pack_model_params(cj, pj, pol_j)
        pt = TM.pack_model_params(ct, pt, pol_t)
    cache_j = JM.init_cache(cj, B, MAX_LEN, dtype=jnp.dtype(dtype),
                            ring=ring, kv_fmt=kv_fmt)
    cache_t = TM.init_cache(ct, B, MAX_LEN, dtype=getattr(torch, dtype),
                            ring=ring, kv_fmt=kv_fmt, device="cpu")
    # fresh jitted functions: the recorder must be in the traced program
    jdec = jax.jit(lambda *a: JM.decode_step(*a, cj, pol_j))
    jpre = jax.jit(lambda *a: JM.prefill_step(*a, cj, pol_j))
    out = {"jax": [], "torch": [], "kpos_jax": [], "kpos_torch": []}
    sink = {}
    with pytest.MonkeyPatch.context() as mp:
        _record_kpos(mp, sink)
        for kind, toks, pos, nv in calls():
            sink["jax"], sink["torch"] = kj, kt = [], []
            if kind == "prefill":
                lj, cache_j = jpre(pj, jnp.asarray(toks), cache_j,
                                   jnp.asarray(pos), jnp.asarray(nv))
                lt, cache_t = TM.prefill_step(
                    pt, torch.from_numpy(toks), cache_t,
                    torch.from_numpy(pos), torch.from_numpy(nv), ct, pol_t)
            else:
                lj, cache_j = jdec(pj, jnp.asarray(toks), cache_j,
                                   jnp.asarray(pos))
                lt, cache_t = TM.decode_step(pt, torch.from_numpy(toks),
                                             cache_t, torch.from_numpy(pos),
                                             ct, pol_t)
            jax.effects_barrier()
            out["jax"].append(np.asarray(lj, np.float32))
            out["torch"].append(lt.float().numpy())
            out["kpos_jax"].append(kj)
            out["kpos_torch"].append(kt)
    out["cache_jax"] = {k: np.asarray(v.astype(jnp.float32)
                                      if v.dtype == jnp.bfloat16 else v)
                        for k, v in cache_j.items()}
    out["cache_torch"] = {k: (v.float() if v.is_floating_point() else v)
                          .numpy() for k, v in cache_t.items()}
    return out


def close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def check_logits(arch, kv_fmt, dtype, backend, call, ring=True):
    """Logits of one call within the module docstring's tolerances (slot 1
    of the partial chunk included: its last valid token is row 4)."""
    got = run_steps(arch, kv_fmt, dtype, backend, ring)
    if dtype == "float32":
        close(got["torch"][call], got["jax"][call])
        return
    f32 = run_steps(arch, kv_fmt, "float32", backend, ring)
    assert rel(got["torch"][call], got["jax"][call]) <= \
        rel(got["jax"][call], f32["jax"][call])


def check_kpos(arch, kv_fmt, call, ring=True):
    got = run_steps(arch, kv_fmt, "float32", "torch", ring)
    kj, kt = got["kpos_jax"][call], got["kpos_torch"][call]
    cfg = cfgs(arch, "float32")[0]
    assert len(kj) == len(kt) == cfg.n_layers
    for a, b in zip(kt, kj):
        np.testing.assert_array_equal(a, b)
    return kt[0]


def check_cache(arch, kv_fmt, backend="torch", ring=True):
    got = run_steps(arch, kv_fmt, "float32", backend, ring)
    cj, ct = got["cache_jax"], got["cache_torch"]
    assert sorted(cj) == sorted(ct)
    for k in cj:
        assert ct[k].shape == cj[k].shape and ct[k].dtype == cj[k].dtype, k
        if kv_fmt:
            np.testing.assert_array_equal(ct[k], cj[k])
        else:
            close(ct[k], cj[k])


CALLS = range(len(calls()))


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_logits_match_jax(dtype, call):
    check_logits("gemma2-2b", "", dtype, "torch", call)


def test_cache_contents_match_jax():
    check_cache("gemma2-2b", "")


@pytest.mark.parametrize("call", CALLS)
def test_kpos_bitwise(call):
    kpos = check_kpos("gemma2-2b", "", call)
    assert kpos.shape == (B, MAX_LEN)


def test_softcap_and_swa_take_the_value_path():
    """Twin of ``test_attention_backend.py::test_softcap_and_swa_fall_back``:
    the kernel gate stays closed for softcaps and SWA patterns, as in the
    JAX package, and the gated decode runs finite over a packed cache."""
    pol = TORCH_INFER.replace(backend="cuda", kv_cache_fmt="mxsf")
    soft = torch_config("gemma2-2b").reduced().replace(
        compute_dtype="float32")
    plain = torch_config("qwen2.5-32b").reduced()
    assert TM.decode_attn_backend(plain, pol) == "cuda-packed"
    assert TM.decode_attn_backend(soft, pol) == "torch"
    for pat in ("all", "alternate"):
        swa = plain.replace(swa_pattern=pat, swa_window=8)
        assert TM.decode_attn_backend(swa, pol) == "torch"
    cache = TM.init_cache(soft, 1, 4, kv_fmt="mxsf", device="cpu")
    logits, _ = TM.decode_step(params("gemma2-2b")[1],
                               torch.zeros((1, 1), dtype=torch.int64), cache,
                               0, soft, pol)
    assert bool(torch.isfinite(logits).all())


def test_value_cache_layout_matches_jax():
    """``init_cache``'s value cache: the JAX shapes and dtypes, bf16 by
    default, the compute dtype when asked."""
    cj, ct = cfgs("gemma2-2b", "float32")
    for kw_j, kw_t in (({}, {}), ({"dtype": jnp.float32},
                                  {"dtype": torch.float32})):
        want = JM.init_cache(cj, 3, 10, **kw_j)
        got = TM.init_cache(ct, 3, 10, device="cpu", **kw_t)
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


@pytest.mark.parametrize("kv_fmt", ["", "mxsf"])
def test_convert_carries_a_jax_cache(kv_fmt):
    """A JAX cache written by a prefill (bf16 values, or codes and scales)
    arrives through ``convert.cache_from_numpy`` bit for bit, and the
    port's next decode step over it gives the JAX package's logits."""
    cj, ct = cfgs("gemma2-2b", "float32")
    pj, pt = params("gemma2-2b")
    pol_j = JAX_INFER.replace(kv_cache_fmt=kv_fmt)
    pol_t = TORCH_INFER.replace(kv_cache_fmt=kv_fmt)
    toks = np.random.default_rng(6).integers(0, 256, size=(B, 6))
    cache = JM.init_cache(cj, B, 8, kv_fmt=kv_fmt)
    _, cache = jax.jit(JM.prefill, static_argnums=(3, 4))(
        pj, {"tokens": jnp.asarray(toks, jnp.int32)}, cache, cj, pol_j)
    got = convert.cache_from_numpy(jax.tree.map(np.asarray, cache))
    for k, v in cache.items():
        assert got[k].dtype == {"bfloat16": torch.bfloat16,
                                "uint8": torch.uint8}[str(v.dtype)]
        np.testing.assert_array_equal(
            got[k].float().numpy() if kv_fmt == "" else got[k].numpy(),
            np.asarray(v.astype(jnp.float32) if kv_fmt == "" else v))
    nxt = np.full((B, 1), 7, np.int32)
    lj, _ = jax.jit(JM.decode_step, static_argnums=(4, 5))(
        pj, jnp.asarray(nxt), cache, jnp.int32(6), cj, pol_j)
    lt, _ = TM.decode_step(pt, torch.from_numpy(nxt), got, 6, ct, pol_t)
    close(lt.numpy(), lj)


def test_engine_token_streams_match_jax():
    """The default policy (value cache) on both engines, reduced gemma2-2b
    at f32 compute, chunk 8: the same greedy tokens and dispatch counts."""
    cj, ct = cfgs("gemma2-2b", "float32")
    pj, pt = params("gemma2-2b")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cj.vocab, size=n).tolist() for n in (19, 4)]
    jeng = JaxEngine(cj, pj, JAX_INFER, slots=2, max_len=32, prefill_chunk=8)
    eng = ServeEngine(ct, pt, TORCH_INFER, slots=2, max_len=32,
                      prefill_chunk=8, device="cpu")
    assert eng.attn_backend == "torch"
    assert {k: v.dtype for k, v in eng.cache.items()} == \
        {"k": torch.float32, "v": torch.float32}
    outs = []
    for e in (jeng, eng):
        reqs = [e.submit(p, 4) for p in prompts]
        e.run()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    assert eng.prefill_dispatches == jeng.prefill_dispatches
    assert eng.decode_dispatches == jeng.decode_dispatches
