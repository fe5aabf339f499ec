"""The port's MoE training forward and its step-0 gradients against the
JAX package's, on reduced qwen2-moe-a2.7b here and on reduced
llama4-maverick (``moe_every=2``, ``top_k=1``) in
``test_torch_moe_train_llama4.py`` (the JAX package's compile of each
quantized step takes ~20 s, so the two configs run as two files), with the
JAX package's weights and its ``lm_batch`` (batch 2 x seq 16: capacity
C = 10 and 5 per expert).

Tolerances are ``test_torch_train.py``'s: float32 loss rtol 1e-5 and every
gradient leaf within 1e-4 relative L2; bfloat16 no farther from the JAX
package's bf16 results than those are from its own f32 results (under
``MXSF_TRAIN``, where that distance is the MX codes').  One exception: at
``top_k=1`` the normalized top weight is p / p = 1, so the router's
gradient is zero in exact arithmetic and both packages return rounding
noise (~1e-9 against ~0.1 for the other leaves); a leaf whose JAX f32
gradient is below 1e-6 of the largest leaf's norm must be that small in
the port too.

Depth, and why: under ``MXSF_TRAIN`` the 4-layer reduced qwen2-moe leaves
the jitted JAX package by 0.9% at its second layer -- an f32 rounding
difference of ~1e-7 that lands on an MX rounding midpoint and flips a code
(``ROADMAP.md`` Queue 3, "whole-step comparisons are chaotic").  The JAX
package flips the same code against itself: that layer, jitted and run op
by op on the same input, differs as much, and the port agrees with the
op-by-op run within two f32 ulps.  So the quantized step-0 gradients
run on one super-layer (qwen2-moe 1 layer, llama4 its dense + MoE pair),
the whole reduced depth runs unquantized (``BF16`` policy), where no code
can flip, and ``test_torch_moe_train_layers.py`` holds every quantized
sublayer at the whole reduced depth against the JAX package's op-by-op
sublayer.  (An op-by-op gradient of the whole depth takes minutes on a
CPU, too long for a test.)
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core.policy import BF16 as JAX_BF16
from repro.core.policy import MXSF_TRAIN as JAX_TRAIN
from repro.data.pipeline import lm_batch as jax_lm_batch
from repro.models import model as JM
from repro.train import step as JT
from repro_torch import convert
from repro_torch.configs.base import get_config as torch_config
from repro_torch.core.policy import BF16 as TORCH_BF16
from repro_torch.core.policy import MXSF_TRAIN as TORCH_TRAIN
from repro_torch.train import step as TT

torch.set_num_threads(2)

SEQ, BATCH = 16, 2


def cases(arch):
    """(arch, policy, compute dtype): the quantized policy at one
    super-layer in both dtypes, BF16 at the reduced config's full depth
    (see the module docstring)."""
    return [(arch, "mxsf", "float32"), (arch, "mxsf", "bfloat16"),
            (arch, "none", "float32")]


POLICIES = {"mxsf": (JAX_TRAIN, TORCH_TRAIN), "none": (JAX_BF16, TORCH_BF16)}


def _cfgs(arch, pol, dtype):
    cj = jax_config(arch).reduced()
    n = cj.moe_every if pol == "mxsf" else cj.n_layers
    kw = dict(compute_dtype=dtype, n_layers=n)
    return cj.replace(**kw), torch_config(arch).reduced().replace(**kw)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_value_and_grad(params, batch, cfg, policy, tcfg):
    return jax.value_and_grad(JT.loss_fn, has_aux=True)(params, batch, cfg,
                                                        policy, tcfg)


@functools.lru_cache(maxsize=None)
def _params(arch, pol):
    cj, ct = _cfgs(arch, pol, "float32")
    pj = JM.init_params(jax.random.PRNGKey(0), cj)
    return pj, convert.params_from_numpy(jax.tree.map(np.asarray, pj), ct)


@functools.lru_cache(maxsize=None)
def _batch(vocab):
    toks, labs = jax_lm_batch(0, 0, BATCH, SEQ, vocab)
    return {"tokens": toks, "labels": labs}


@functools.lru_cache(maxsize=None)
def _jax_grads(arch, pol, dtype):
    cj, _ = _cfgs(arch, pol, dtype)
    (loss, _), g = _jax_value_and_grad(
        _params(arch, pol)[0], _batch(cj.vocab), cj, POLICIES[pol][0],
        JT.TrainConfig(remat="none"))
    return float(loss), {"/".join(k): v for k, v in TT._flatten(
        jax.tree.map(lambda a: np.asarray(a, np.float32), g))}


def check_step0(arch, pol, dtype):
    """The port's step-0 loss and gradients against the JAX package's
    within the module docstring's tolerances."""
    cj, ct = _cfgs(arch, pol, dtype)
    want_loss, want = _jax_grads(arch, pol, dtype)
    want = dict(want)  # the cached dict stays whole for the next case
    pairs = TT._flatten(_params(arch, pol)[1])
    leaves = [v.detach().clone().requires_grad_() for _, v in pairs]
    tree = TT._unflatten((k, v) for (k, _), v in zip(pairs, leaves))
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in _batch(cj.vocab).items()}
    loss, _ = TT.loss_fn(tree, batch, ct, POLICIES[pol][1], TT.TrainConfig())
    grads = {"/".join(k): g.float().numpy() for (k, _), g in zip(
        pairs, torch.autograd.grad(loss, leaves))}
    loss = float(loss.detach())
    assert sorted(grads) == sorted(want)
    assert any("we_g" in k for k in want)
    f32_loss, f32 = _jax_grads(arch, pol, "float32")
    norm = lambda a: float(np.linalg.norm(a))
    zero = 1e-6 * max(norm(g) for g in f32.values())
    for k in [k for k in want if norm(f32[k]) < zero]:
        assert cj.top_k == 1 and k.endswith("router"), k
        assert norm(grads.pop(k)) < zero and norm(want.pop(k)) < zero, k
    if dtype == "float32":
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        for k in want:
            assert _rel(grads[k], want[k]) <= 1e-4, k
        return
    assert abs(loss - want_loss) <= abs(want_loss - f32_loss)
    for k in want:
        assert _rel(grads[k], want[k]) <= _rel(want[k], f32[k]), k


@pytest.mark.parametrize("arch,pol,dtype", cases("qwen2-moe-a2.7b"))
def test_step0_loss_and_grads_match_jax(arch, pol, dtype):
    check_step0(arch, pol, dtype)

