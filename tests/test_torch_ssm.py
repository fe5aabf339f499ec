"""The port's SSD block and mamba2 (``family="ssm"``) against the JAX
package's, on the reduced mamba2-780m config (4 layers of d_model 64, 8
SSD heads of 16, state 16, chunk 16).

Weights come from the JAX package through ``convert``; the JAX side runs
its value-domain reference (``backend="jnp"``, jitted), the port its
kernels' plain versions (``backend="cuda"`` on CPU tensors).  Tolerances
are ``torch_families``'s (rtol 1e-5 of the largest magnitude for outputs
and logits, 1e-4 relative L2 for gradients), except the chunk-invariance
and continuation checks inside the port, which reassociate the recurrence
(chunked sums against the token-by-token one) and take the JAX package's
own 2e-4 (``tests/test_attention_ssd.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import BF16 as JAX_BF16
from repro.core.policy import MXSF_INFER as JAX_INFER
from repro.core.policy import MXSF_TRAIN as JAX_TRAIN
from repro.models import model as JM
from repro.models import ssd as JS
from repro_torch.core.policy import BF16, MXSF_INFER, MXSF_TRAIN
from repro_torch.models import model as TM
from repro_torch.models import ssd as TS
from repro_torch.models import transformer as TT
from torch_families import (JAX_DECODE, JAX_FORWARD, JAX_PACK, JAX_PREFILL,
                            assert_step0, cfgs, close, dtypes, flat,
                            jax_params, rel_l2, step0_both, to_port)

ARCH = "mamba2-780m-reduced"
INFER = MXSF_INFER.replace(backend="cuda")
POLICIES = {"bf16": (JAX_BF16, BF16), "mxsf": (JAX_INFER, INFER)}


def _u(cfg, L, B=2, seed=0):
    return (np.random.default_rng(seed).standard_normal(
        (B, L, cfg.d_model)) * 0.5).astype(np.float32)


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_ssd_forward_matches_jax(pol):
    cj, ct = cfgs(ARCH)
    jpol, tpol = POLICIES[pol]
    p = JS.ssd_init(jax.random.PRNGKey(0), cj)
    pt = to_port(p, ct)
    u = _u(cj, 48)  # three chunks of 16
    yj, cache_j = JS.ssd_forward(p, jnp.asarray(u), cj, jpol,
                                 return_state=True)
    yt, cache_t = TS.ssd_forward(pt, torch.from_numpy(u), ct, tpol,
                                 return_state=True)
    close(yt, yj)
    close(cache_t["state"], cache_j["state"])
    close(cache_t["conv"], cache_j["conv"])


def test_ssd_chunk_invariance():
    """The chunked SSD is independent of the chunk (a reassociation) and
    equals the JAX package's at every chunk."""
    cj, ct = cfgs(ARCH)
    p = JS.ssd_init(jax.random.PRNGKey(0), cj)
    pt = to_port(p, ct)
    u = _u(cj, 32)
    outs = []
    for chunk in (4, 8, 16, 32):
        yt = TS.ssd_forward(pt, torch.from_numpy(u),
                            ct.replace(ssm_chunk=chunk), BF16)
        close(yt, JS.ssd_forward(p, jnp.asarray(u),
                                 cj.replace(ssm_chunk=chunk), JAX_BF16))
        outs.append(yt)
    for y in outs[1:]:
        np.testing.assert_allclose(y.numpy(), outs[0].numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_ssd_decode_step_matches_jax():
    """The recurrent step against the JAX package's from the same cache,
    token by token, and the prefill state continuing into it."""
    cj, ct = cfgs(ARCH, ssm_chunk=8)
    p = JS.ssd_init(jax.random.PRNGKey(0), cj)
    pt = to_port(p, ct)
    u = _u(cj, 17, B=1)
    _, cj_ = JS.ssd_forward(p, jnp.asarray(u[:, :16]), cj, JAX_BF16,
                            return_state=True)
    _, c16 = TS.ssd_forward(pt, torch.from_numpy(u[:, :16]), ct, BF16,
                            return_state=True)
    want, _ = JS.ssd_decode_step(p, jnp.asarray(u[:, 16:17]), cj_, cj,
                                 JAX_BF16)
    c16 = {k: v.clone() for k, v in c16.items()}
    got, _ = TS.ssd_decode_step(pt, torch.from_numpy(u[:, 16:17]), c16, ct,
                                BF16)
    close(got, want)
    cache = TS.ssd_init_cache(ct, 1)
    for t in range(17):
        last, cache = TS.ssd_decode_step(pt, torch.from_numpy(u[:, t:t + 1]),
                                         cache, ct, BF16)
    np.testing.assert_allclose(got.numpy(), last.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_prefill_then_decode_continues_the_forward():
    """``prefill`` of 16 tokens (two chunks of 8) and 4 ``decode_step``s
    give the full forward's logits at those positions."""
    _, ct = cfgs(ARCH, ssm_chunk=8)
    cj, _ = cfgs(ARCH)
    params = to_port(jax_params(cj), ct)
    toks = torch.from_numpy(_tokens(ct, 2, 24))
    full = TT.forward(params, {"tokens": toks}, ct, BF16)
    cache = TM.init_cache(ct, 2, 20, dtype=torch.float32, device="cpu")
    last, cache = TM.prefill(params, {"tokens": toks[:, :16]}, cache, ct,
                             BF16)
    np.testing.assert_allclose(last.numpy(), full[:, 15].numpy(),
                               rtol=2e-4, atol=2e-5)
    for t in range(16, 20):
        lg, cache = TM.decode_step(params, toks[:, t:t + 1], cache, t, ct,
                                   BF16)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=2e-4, atol=2e-5)


def _prefill_decode_jax(cj, params, toks, policy):
    cache = JM.init_cache(cj, 2, 32)
    _, cache = JAX_PREFILL(params, {"tokens": jnp.asarray(toks)}, cache, cj,
                           policy)
    return JAX_DECODE(params, jnp.asarray(toks[:, :1]), cache, 16, cj,
                      policy)[1]


def test_cache_dtypes_match_jax():
    """bf16 compute: a zeroed cache holds f32 state and conv tail; after
    ``prefill`` the conv tail is the projection's bf16 (the state stays
    f32), and decode keeps it so -- in both packages.  The values are
    held to the JAX package's own bf16-vs-f32 distance (bf16 rounds at
    other places in the two frameworks: silu, exp)."""
    cj, ct = cfgs(ARCH, "bfloat16")
    params = jax_params(cj)
    pt = to_port(params, ct)
    toks = _tokens(cj, 2, 16)
    cache_j = JM.init_cache(cj, 2, 32)
    cache_t = TM.init_cache(ct, 2, 32, device="cpu")
    assert dtypes(cache_t) == dtypes(cache_j) == {
        ("state",): "float32", ("conv",): "float32"}
    _, cache_j = JAX_PREFILL(params, {"tokens": jnp.asarray(toks)}, cache_j,
                             cj, JAX_BF16)
    _, cache_t = TM.prefill(pt, {"tokens": torch.from_numpy(toks)}, cache_t,
                            ct, BF16)
    assert dtypes(cache_t) == dtypes(cache_j) == {
        ("state",): "float32", ("conv",): "bfloat16"}
    _, cache_t = TM.decode_step(pt, torch.from_numpy(toks[:, :1]), cache_t,
                                16, ct, BF16)
    want = _prefill_decode_jax(cj, params, toks, JAX_BF16)
    assert dtypes(cache_t) == dtypes(want)
    ref = flat(_prefill_decode_jax(cfgs(ARCH)[0], params, toks, JAX_BF16))
    got, want = flat(cache_t), flat(want)
    for k in want:  # relative L2, as test_torch_train.py holds bf16
        assert rel_l2(got[k], want[k]) <= rel_l2(want[k], ref[k]), k


def test_mamba2_forward_logits_match_jax():
    cj, ct = cfgs(ARCH)
    params = jax_params(cj)
    toks = _tokens(cj, 2, 32)
    want = JAX_FORWARD(params, {"tokens": jnp.asarray(toks)}, cj, JAX_TRAIN)
    got = TT.forward(to_port(params, ct), {"tokens": torch.from_numpy(toks)},
                     ct, MXSF_TRAIN.replace(backend="cuda"))
    close(got, want)


def test_mamba2_packed_prefill_and_decode_logits_match_jax():
    """The packed store (``MXSF_INFER``): prefill of 16 tokens, then 3
    decode steps, logits and caches against the JAX package's."""
    cj, ct = cfgs(ARCH)
    store = JAX_PACK(cj, jax_params(cj), JAX_INFER)
    st = to_port(store, ct)
    toks = _tokens(cj, 2, 19)
    cache_j = JM.init_cache(cj, 2, 19, dtype=jnp.float32)
    cache_t = TM.init_cache(ct, 2, 19, dtype=torch.float32, device="cpu")
    lj, cache_j = JAX_PREFILL(store, {"tokens": jnp.asarray(toks[:, :16])},
                              cache_j, cj, JAX_INFER)
    lt, cache_t = TM.prefill(st, {"tokens": torch.from_numpy(toks[:, :16])},
                             cache_t, ct, INFER)
    close(lt, lj)
    for t in range(16, 19):
        lj, cache_j = JAX_DECODE(store, jnp.asarray(toks[:, t:t + 1]),
                                 cache_j, t, cj, JAX_INFER)
        lt, cache_t = TM.decode_step(st, torch.from_numpy(toks[:, t:t + 1]),
                                     cache_t, t, ct, INFER)
        close(lt, lj)
    fj, ft = flat(cache_j), flat(cache_t)
    for k in fj:
        close(ft[k], fj[k])


def test_step0_loss_and_grads_match_jax():
    cj, ct = cfgs(ARCH)
    toks = _tokens(cj, 2, 32)
    batch = {"tokens": jnp.asarray(toks),
             "labels": jnp.asarray(np.roll(toks, -1, axis=1))}
    assert_step0(step0_both(jax_params(cj), cj, ct, batch, JAX_TRAIN,
                            MXSF_TRAIN.replace(backend="cuda")))
