"""The port's hybrid family (zamba2: groups of SSD layers, each followed by
ONE shared attention sublayer, then a tail) against the JAX package's, on
the reduced zamba2-7b config (7 layers: 2 groups of 3 and a tail of 1).

Weights come from the JAX package through ``convert``.  The JAX side runs
its value-domain reference (``"jnp"``, jitted), the port its own
(``"torch"``) or its kernels' plain versions (``"cuda"`` on CPU tensors).
Cache codes and scales are compared bitwise; logits, SSD states and
gradients with ``torch_families``'s tolerances, except where MX rounding
makes a free-running comparison chaotic:

* the kernel datapath's shared block reads the packed cache through the
  flash-attention kernel, whose f32 order differs from the JAX package's
  kernel by an ulp: fed the same input, one context row of the reduced
  model's first application lands on an MX rounding midpoint of ``wo``'s
  input in one package and not the other (one code step, 0.005).  So each
  attention-kernel call of the path is held against the JAX package's
  kernel (``"pallas"``, interpret mode) on the same inputs (rtol 1e-5), as
  the card run teacher-forces every kernel call;
* ``MXSF_TRAIN`` gradients at the whole depth: an f32 ulp on a rounding
  midpoint flips a gradient code in the backward and moves the first
  group's gradients by ~0.5% (the embedding's by 2%), while the
  unquantized policy agrees to ~2e-6 and the quantized forward's logits
  bit for bit.  As the MoE tests do, the quantized step-0 is held at one
  group (3 SSD layers and the shared block: no flip, every leaf within
  1e-4) and the unquantized one at the whole depth.
"""
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.policy import BF16 as JAX_BF16
from repro.core.policy import MXSF_INFER as JAX_INFER
from repro.core.policy import MXSF_TRAIN as JAX_TRAIN
from repro.models import model as JM
from repro_torch.core.policy import BF16, MXSF_INFER, MXSF_TRAIN
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from torch_families import (JAX_DECODE, JAX_FORWARD, JAX_PACK, JAX_PREFILL,
                            assert_attention_calls_match_jax, assert_step0,
                            attention_calls, cfgs, close, flat, jax_params,
                            step0_both, to_port)

ARCH = "zamba2-7b-reduced"


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def test_tree_is_the_jax_packages():
    """Groups stacked (G, per, ...), a tail, ONE shared sublayer: the
    port's own init has the JAX tree's paths and shapes."""
    cj, ct = cfgs(ARCH)
    want = {p: v.shape for p, v in flat(jax_params(cj)).items()}
    got = {p: tuple(v.shape) for p, v in flat(
        TM.init_params(ct, torch.Generator().manual_seed(0))).items()}
    assert got == want
    assert got[("layers", "ssd", "in_proj")][:2] == (2, 3)
    assert got[("tail", "ssd", "in_proj")][0] == 1
    assert got[("shared", "attn", "wq")] == (ct.d_model,
                                             ct.n_heads * ct.head_dim)


def test_forward_logits_match_jax():
    cj, ct = cfgs(ARCH)
    params = jax_params(cj)
    toks = _tokens(cj, 2, 32)
    want = JAX_FORWARD(params, {"tokens": jnp.asarray(toks)}, cj, JAX_TRAIN)
    got = TT.forward(to_port(params, ct), {"tokens": torch.from_numpy(toks)},
                     ct, MXSF_TRAIN.replace(backend="cuda"))
    close(got, want)


def _serve(store, cfg, policy, toks, prefill, decode, init_cache, **kw):
    """``prefill`` of 16 tokens, then 2 decode steps: (logits, cache)."""
    cache = init_cache(cfg, 2, 24, kv_fmt="mxsf", **kw)
    lg, cache = prefill(store, {"tokens": toks[:, :16]}, cache, cfg, policy)
    out = [lg]
    for t in (16, 17):
        lg, cache = decode(store, toks[:, t:t + 1], cache, t, cfg, policy)
        out.append(lg)
    return out, cache


def test_packed_prefill_and_decode_match_jax():
    """Packed store and packed MXSF cache on the value path: ``prefill``
    of 16 tokens, then 2 ``decode_step``s -- logits, every cache code and
    scale byte, SSD states and conv tails."""
    cj, ct = cfgs(ARCH)
    jpol = JAX_INFER.replace(kv_cache_fmt="mxsf")
    tpol = MXSF_INFER.replace(kv_cache_fmt="mxsf", backend="torch")
    store = JAX_PACK(cj, jax_params(cj), jpol)
    toks = _tokens(cj, 2, 18)
    lj, cache_j = _serve(store, cj, jpol, jnp.asarray(toks), JAX_PREFILL,
                         JAX_DECODE, JM.init_cache, dtype=jnp.float32)
    lt, cache_t = _serve(to_port(store, ct), ct, tpol,
                         torch.from_numpy(toks), TM.prefill, TM.decode_step,
                         TM.init_cache, dtype=torch.float32, device="cpu")
    for got, want in zip(lt, lj):
        close(got, want)
    fj, ft = flat(cache_j), flat(cache_t)
    assert sorted(ft) == sorted(fj)
    for k in fj:
        if k[0] == "attn":
            np.testing.assert_array_equal(ft[k], fj[k], err_msg=str(k))
        else:
            close(ft[k], fj[k])


def test_kernel_path_attention_calls_match_jax():
    """The kernel datapath (packed cache read by the flash-attention
    kernel): each of the shared block's kernel calls -- one per group in
    the prefill (S = 16) and in each decode step -- against the JAX
    package's kernel on the same inputs."""
    cj, ct = cfgs(ARCH)
    tpol = MXSF_INFER.replace(kv_cache_fmt="mxsf", backend="cuda")
    st = TM.pack_model_params(
        ct, TM.init_params(ct, torch.Generator().manual_seed(0)), tpol)
    calls = attention_calls(lambda: _serve(
        st, ct, tpol, torch.from_numpy(_tokens(ct, 2, 18)), TM.prefill,
        TM.decode_step, TM.init_cache, dtype=torch.float32, device="cpu"))
    G = ct.n_layers // ct.hybrid_attn_every
    assert [c[0][0].shape[1] for c in calls] == [16] * G + [1] * 2 * G
    assert_attention_calls_match_jax(calls)


def _batch(cj):
    toks = _tokens(cj, 2, 32)
    return {"tokens": jnp.asarray(toks),
            "labels": jnp.asarray(np.roll(toks, -1, axis=1))}


def test_step0_grads_and_the_shared_blocks_match_jax():
    """Step-0 loss and gradients: unquantized at the whole depth (the
    shared sublayer's gradient sums its two applications, as the JAX
    package's scan does), ``MXSF_TRAIN`` at one group (see the module
    docstring)."""
    cj, ct = cfgs(ARCH)
    assert_step0(step0_both(jax_params(cj), cj, ct, _batch(cj), JAX_BF16,
                            BF16))
    cj, ct = cfgs(ARCH, n_layers=ct.hybrid_attn_every)
    both = step0_both(jax_params(cj), cj, ct, _batch(cj), JAX_TRAIN,
                      MXSF_TRAIN.replace(backend="cuda"))
    assert_step0(both)
    _, (_, gt) = both
    assert np.abs(gt[("shared", "attn", "wq")]).max() > 0
