"""The port's MoE layers against the JAX package's, on reduced
qwen2-moe-a2.7b (MoE every layer, top-2 of 4 live experts padded to 16, one
shared expert) and reduced llama4-maverick (MoE every other layer, top-1).

Weights are the JAX package's (``init_params(PRNGKey(0))``) carried across
by ``convert``; activations and tokens come from a numpy seed.

Tolerances, and why:

* dispatch (slots, validity, token order, weights) and the top-k choice,
  ties included: bitwise -- integer and selection logic.
* ``moe`` output and ``moe_aux_loss`` in float32: the two packages sum the
  router and expert matmuls in different orders (~1e-7 relative):
  within 1e-5 of the largest output; the aux loss rtol 1e-6.
* cached decode logits in float32: rtol 1e-5 and atol 1e-5 of the largest
  logit, as ``test_torch_decoding.py``.

The training forward and its gradients are held in
``test_torch_moe_train.py``.
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
from repro_torch.core.packed_store import tree_leaves
from repro_torch.core.policy import MXSF_INFER as TORCH_INFER
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as TT

torch.set_num_threads(2)

ARCHS = ["qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"]
JAX_DECODE = jax.jit(JM.decode_step, static_argnums=(4, 5))
JAX_MOE = jax.jit(JB.moe, static_argnums=(2, 3))


def _cfgs(arch, dtype="float32", **kw):
    return (jax_config(arch).reduced().replace(compute_dtype=dtype, **kw),
            torch_config(arch).reduced().replace(compute_dtype=dtype, **kw))


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The JAX package's params and the port's copy (f32 leaves)."""
    cj, ct = _cfgs(arch)
    pj = JM.init_params(jax.random.PRNGKey(0), cj)
    return pj, convert.params_from_numpy(jax.tree.map(np.asarray, pj), ct)


def _moe_layer(arch):
    """The first MoE sublayer's ``ffn`` params of both packages."""
    cj, _ = _cfgs(arch)
    pj, pt = _params(arch)
    sub = f"sub{cj.moe_every - 1}"
    return (jax.tree.map(lambda a: a[0], pj["layers"][sub]["ffn"]),
            TM.decoding.layer_params(pt["layers"][sub]["ffn"], 0))


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("C", [1, 2, 5])
def test_row_dispatch_bitwise(C):
    """Slots, validity, token order and weights of the dispatch; C=1 and 2
    drop assignments past capacity into the dummy row."""
    rng = np.random.default_rng(C)
    R, S, k, E, d = 3, 6, 2, 8, 5
    x = rng.standard_normal((R, S, d)).astype(np.float32)
    topi = np.stack([np.stack([rng.choice(E, k, replace=False)
                               for _ in range(S)]) for _ in range(R)])
    topi = topi.astype(np.int32)
    topv = rng.random((R, S, k)).astype(np.float32)
    want = jax.vmap(lambda xr, ti, tv: JB._row_dispatch(xr, ti, tv, E, C))(
        jnp.asarray(x), jnp.asarray(topi), jnp.asarray(topv))
    got = TB._row_dispatch(torch.from_numpy(x), torch.from_numpy(topi).long(),
                           torch.from_numpy(topv), E, C)
    assert not bool(got[2].all()) or C == 5  # some assignment dropped
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_top_k_ties_match_lax():
    """Ties go to the lower index, as ``lax.top_k`` gives them: equal live
    experts, and dead padded experts tied at probability 0 when k exceeds
    the live ones."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25, 0, 0, 0, 0],
                      [0.1, 0.4, 0.1, 0.4, 0, 0, 0, 0],
                      [0, 0, 0.5, 0, 0, 0.5, 0, 0]], np.float32)
    for k in (1, 2, 3, 6):
        vj, ij = jax.lax.top_k(jnp.asarray(probs), k)
        vt, it = TB._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("top_k", [2, 6])
def test_tied_router_routes_like_jax(top_k):
    """A zero router makes every live expert tie (and, at top_k=6 > 4 live
    experts, two dead ones tie at 0): the choice and the output match."""
    cj, ct = _cfgs("qwen2-moe-a2.7b", top_k=top_k)
    pj, pt = _moe_layer("qwen2-moe-a2.7b")
    pj = dict(pj, router=jnp.zeros_like(pj["router"]))
    pt = dict(pt, router=torch.zeros_like(pt["router"]))
    x = np.random.default_rng(1).standard_normal((2, 5, cj.d_model))
    x = x.astype(np.float32)
    _close(TB.moe(pt, torch.from_numpy(x), ct, TORCH_INFER).numpy(),
           JAX_MOE(pj, jnp.asarray(x), cj, JAX_INFER))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_output_and_aux_loss_match_jax(arch):
    cj, ct = _cfgs(arch)
    pj, pt = _moe_layer(arch)
    x = np.random.default_rng(0).standard_normal((3, 10, cj.d_model))
    x = x.astype(np.float32)
    _close(TB.moe(pt, torch.from_numpy(x), ct, TORCH_INFER).numpy(),
           JAX_MOE(pj, jnp.asarray(x), cj, JAX_INFER))
    np.testing.assert_allclose(
        float(TB.moe_aux_loss(torch.from_numpy(x), pt, ct)),
        float(JB.moe_aux_loss(jnp.asarray(x), pj, cj)), rtol=1e-6)


@pytest.mark.parametrize("arch,backend,kv_fmt", [
    ("qwen2-moe-a2.7b", "torch", ""), ("qwen2-moe-a2.7b", "cuda", "mxsf"),
    ("llama4-maverick-400b-a17b", "torch", "")])
def test_cached_decode_logits_match_jax(arch, backend, kv_fmt):
    """Decode steps route across the batch (S == 1); the kernel datapath
    with the packed cache is the card's serving path."""
    cj, ct = _cfgs(arch)
    pj, pt = _params(arch)
    jax_backend = {"torch": "jnp", "cuda": "pallas"}[backend]
    pol_j = JAX_INFER.replace(backend=jax_backend, kv_cache_fmt=kv_fmt)
    pol_t = TORCH_INFER.replace(backend=backend, kv_cache_fmt=kv_fmt)
    if backend == "cuda":
        pj = JM.pack_model_params(cj, pj, pol_j)
        pt = TM.pack_model_params(ct, pt, pol_t)
    B, W = 3, 8
    cache_j = JM.init_cache(cj, B, W, dtype=jnp.float32, ring=False,
                            kv_fmt=kv_fmt)
    cache_t = TM.init_cache(ct, B, W, dtype=torch.float32, ring=False,
                            kv_fmt=kv_fmt, device="cpu")
    rng = np.random.default_rng(2)
    for s in range(4):
        toks = rng.integers(0, cj.vocab, size=(B, 1)).astype(np.int32)
        pos = np.full(B, s, np.int32)
        lj, cache_j = JAX_DECODE(pj, jnp.asarray(toks), cache_j,
                                 jnp.asarray(pos), cj, pol_j)
        lt, cache_t = TM.decode_step(pt, torch.from_numpy(toks), cache_t,
                                     torch.from_numpy(pos), ct, pol_t)
        _close(lt.numpy(), lj)


# -- store, conversion, engine ----------------------------------------------

def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_packed_params_equals_packing_init_params(arch):
    """Leaf by leaf, bitwise; the experts and the router stay f32 values,
    the shared expert is packed, and the specs have the store's layout."""
    _, ct = _cfgs(arch)
    pol = TORCH_INFER.replace(backend="cuda")
    store = TM.init_packed_params(ct, pol, torch.Generator().manual_seed(3))
    full = TM.pack_model_params(
        ct, TM.init_params(ct, torch.Generator().manual_seed(3)), pol)
    a, b = list(tree_leaves(store)), list(tree_leaves(full))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if hasattr(y, "codes"):
            assert torch.equal(x.codes, y.codes) and x.shape == y.shape
            assert torch.equal(x.scale_e8m0, y.scale_e8m0)
        else:
            assert torch.equal(x, y)
    ffn = store["layers"][f"sub{ct.moe_every - 1}"]["ffn"]
    assert ffn["we_g"].dtype == torch.float32
    assert ffn["router"].dtype == torch.float32
    assert hasattr(ffn["shared"]["wg"], "codes")
    specs = TM.packed_model_specs(ct, pol)
    meta = lambda t: (_layout(t.codes), _layout(t.scale_e8m0)) \
        if hasattr(t, "codes") else _layout(t)
    for (ka, x), (kb, y) in zip(TT._flatten(specs), TT._flatten(store)):
        assert ka == kb and meta(x) == meta(y), ka


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_the_jax_moe_params(arch):
    """Every leaf of the JAX tree (router, we_*, shared/*) arrives with its
    key, shape and values; the port's init draws the same layout."""
    cj, ct = _cfgs(arch)
    pj, pt = _params(arch)
    want = dict(TT._flatten(jax.tree.map(np.asarray, pj)))
    got = dict(TT._flatten(pt))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert _layout(TM.init_params(ct, torch.Generator().manual_seed(0))) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), pj)


def test_engine_token_streams_match_jax():
    """The default policy (value cache) on both engines at f32 compute: the
    same greedy tokens and dispatch counts, token by token (chunk 1)."""
    cj, ct = _cfgs("qwen2-moe-a2.7b")
    pj, pt = _params("qwen2-moe-a2.7b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cj.vocab, size=n).tolist() for n in (3, 5, 2)]
    jeng = JaxEngine(cj, pj, JAX_INFER, slots=2, max_len=16,
                     prefill_chunk=8)
    eng = ServeEngine(ct, pt, TORCH_INFER, slots=2, max_len=16,
                      prefill_chunk=8, device="cpu")
    assert eng.prefill_chunk == jeng.prefill_chunk == 1
    assert eng.attn_backend == "torch"
    outs = []
    for e in (jeng, eng):
        reqs = [e.submit(p, 3) for p in prompts]
        e.run()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    assert eng.prefill_dispatches == jeng.prefill_dispatches
    assert eng.decode_dispatches == jeng.decode_dispatches
