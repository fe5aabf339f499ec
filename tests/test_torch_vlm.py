"""The port's VLM prefix (internvl2: a decoder whose sequence starts with
``frontend_tokens`` patch embeddings from a stubbed vision frontend)
against the JAX package's, on the reduced internvl2-1b config (4 layers of
d_model 64, GQA 4/2, qkv biases, tied embeddings, an 8-token prefix).

Weights come from the JAX package through ``convert``; the JAX side runs
its value-domain reference (``"jnp"``, jitted) or, for the engines, its
kernel datapath (``"pallas"``, interpret mode); the port its own
(``"torch"``) or its kernels' plain versions (``"cuda"`` on CPU tensors).
Tolerances are ``torch_families``'s; cache codes and scales are compared
bitwise; the kernel datapath's attention calls are held one by one
against the JAX package's kernel on the same inputs.  The text-only
engines must give the same tokens.

Under ``MXSF_TRAIN`` the free-running forward is chaotic, as for the
encoder-decoder (``test_torch_encdec.py``): the two frameworks' rmsnorm
differ by an f32 ulp, and an ulp on an MX rounding midpoint flips a code
(here 4% of the reduced model's logits part by up to a code step).  So the
forward and the step-0 gradients are held free-running under the
unquantized policy at the whole depth, and, as the MoE tests do, under
``MXSF_TRAIN`` at one layer (no flip: within 1e-5 and 1e-4).
"""
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.policy import BF16 as JAX_BF16
from repro.core.policy import MXSF_INFER as JAX_INFER
from repro.core.policy import MXSF_TRAIN as JAX_TRAIN
from repro.models import model as JM
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.core.policy import BF16, MXSF_INFER, MXSF_TRAIN
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import ServeEngine
from torch_families import (JAX_DECODE, JAX_FORWARD, JAX_PACK, JAX_PREFILL,
                            assert_attention_calls_match_jax, assert_step0,
                            attention_calls, cfgs, close, flat, jax_params,
                            step0_both, to_port)

ARCH = "internvl2-1b-reduced"


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def _embeds(cfg, B=2, seed=3):
    return (np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_tokens, cfg.d_model)) * 0.5).astype(np.float32)


def _serve(store, cfg, policy, toks, embeds, prefill, decode, init_cache,
           **kw):
    """``prefill`` of the prefix and 12 tokens, then 3 decode steps (at
    text positions 12-14): (logits of each dispatch, cache)."""
    cache = init_cache(cfg, 2, 16, ring=False, kv_fmt="mxsf", **kw)
    lg, cache = prefill(store, {"tokens": toks[:, :12], "embeds": embeds},
                        cache, cfg, policy)
    out = [lg]
    for t in (12, 13, 14):
        lg, cache = decode(store, toks[:, t:t + 1], cache, t, cfg, policy)
        out.append(lg)
    return out, cache


def test_forward_with_the_prefix_matches_jax():
    """Unquantized at the whole depth, ``MXSF_TRAIN`` at one layer."""
    toks = _tokens(cfgs(ARCH)[0], 2, 16)
    for jpol, tpol, kw in ((JAX_BF16, BF16, {}),
                           (JAX_TRAIN, MXSF_TRAIN.replace(backend="cuda"),
                            {"n_layers": 1})):
        cj, ct = cfgs(ARCH, **kw)
        params, emb = jax_params(cj), _embeds(cj)
        want = JAX_FORWARD(params, {"tokens": jnp.asarray(toks),
                                    "embeds": jnp.asarray(emb)}, cj, jpol)
        got = TT.forward(to_port(params, ct),
                         {"tokens": torch.from_numpy(toks),
                          "embeds": torch.from_numpy(emb)}, ct, tpol)
        assert got.shape == (2, ct.frontend_tokens + 16, ct.padded_vocab)
        close(got, want)


def test_prefill_with_embeds_then_decode_match_jax():
    """Packed store and packed MXSF cache on the value path: the prefix
    fills cache columns 0-7, the prompt 8-19, decode steps 20-22 -- logits
    and every cache byte."""
    cj, ct = cfgs(ARCH)
    jpol = JAX_INFER.replace(kv_cache_fmt="mxsf")
    tpol = MXSF_INFER.replace(kv_cache_fmt="mxsf", backend="torch")
    store = JAX_PACK(cj, jax_params(cj), jpol)
    toks, emb = _tokens(cj, 2, 15), _embeds(cj)
    lj, cache_j = _serve(store, cj, jpol, jnp.asarray(toks),
                         jnp.asarray(emb), JAX_PREFILL, JAX_DECODE,
                         JM.init_cache, dtype=jnp.float32)
    lt, cache_t = _serve(to_port(store, ct), ct, tpol,
                         torch.from_numpy(toks), torch.from_numpy(emb),
                         TM.prefill, TM.decode_step, TM.init_cache,
                         dtype=torch.float32, device="cpu")
    assert cache_t["k_codes"].shape[3] == ct.frontend_tokens + 16
    for got, want in zip(lt, lj):
        close(got, want)
    fj, ft = flat(cache_j), flat(cache_t)
    for k in fj:
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=str(k))
    written = (ft[("k_scales",)] > 0).any(axis=(0, 1, 2, 4, 5))
    assert written.tolist() == [True] * 23 + [False]


def test_kernel_path_attention_calls_match_jax():
    """The kernel datapath: the prefill's calls (S = 8 + 12) and each
    decode step's, one per layer, against the JAX package's kernel."""
    cj, ct = cfgs(ARCH)
    tpol = MXSF_INFER.replace(kv_cache_fmt="mxsf", backend="cuda")
    st = TM.pack_model_params(
        ct, TM.init_params(ct, torch.Generator().manual_seed(0)), tpol)
    calls = attention_calls(lambda: _serve(
        st, ct, tpol, torch.from_numpy(_tokens(ct, 2, 15)),
        torch.from_numpy(_embeds(ct)), TM.prefill, TM.decode_step,
        TM.init_cache, dtype=torch.float32, device="cpu"))
    assert [c[0][0].shape[1] for c in calls] == \
        [20] * ct.n_layers + [1] * 3 * ct.n_layers
    assert_attention_calls_match_jax(calls)


def test_loss_runs_over_the_text_positions():
    """The LM loss drops the prefix positions (labels cover the text
    only); step-0 loss and gradients against the JAX package's,
    unquantized at the whole depth and ``MXSF_TRAIN`` at one layer."""
    cj, ct = cfgs(ARCH)
    toks = _tokens(cj, 2, 16)
    batch = {"tokens": jnp.asarray(toks),
             "labels": jnp.asarray(np.roll(toks, -1, axis=1)),
             "embeds": jnp.asarray(_embeds(cj))}
    assert_step0(step0_both(jax_params(cj), cj, ct, batch, JAX_BF16, BF16))
    cj, ct = cfgs(ARCH, n_layers=1)
    assert_step0(step0_both(jax_params(cj), cj, ct, batch, JAX_TRAIN,
                            MXSF_TRAIN.replace(backend="cuda")))


def test_text_only_engine_tokens_match_jax():
    """Continuous batching serves the VLM text-only: positions shift by
    the prefix (``pos + frontend_tokens``), whose columns are never
    written.  Greedy tokens and dispatches against the JAX engine."""
    cj, ct = cfgs(ARCH)
    params = jax_params(cj)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cj.vocab, size=n)) for n in (3, 6)]
    jeng = JaxEngine(cj, params, JAX_INFER.replace(kv_cache_fmt="mxsf"),
                     slots=2, max_len=16, backend="pallas", prefill_chunk=4)
    jreqs = [jeng.submit(p, 3) for p in prompts]
    jeng.run()
    eng = ServeEngine(ct, to_port(params, ct),
                      MXSF_INFER.replace(kv_cache_fmt="mxsf"), slots=2,
                      max_len=16, backend="cuda", prefill_chunk=4,
                      device="cpu")
    reqs = [eng.submit(p, 3) for p in prompts]
    eng.run()
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    for key in ("prefill_dispatches", "decode_dispatches"):
        assert eng.stats()[key] == jeng.stats()[key]
    assert not bool((eng.cache["k_scales"][:, :, :, :ct.frontend_tokens]
                     > 0).any())
