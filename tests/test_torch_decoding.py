"""The port's packed-MXSF decoder against the JAX package's, on the reduced
qwen2.5-32b config in float32.

The weights are the JAX package's (``init_params(PRNGKey(0))``) carried
across through numpy by ``repro_torch.convert``.  The JAX side runs the
kernel datapath (``backend="pallas"``, Pallas in interpret mode) and the
port its kernels' plain versions (``backend="cuda"`` on CPU tensors).

Packed codes, E8M0 scales and KV-cache bytes are compared bitwise.  Logits
are f32 and compared with rtol 1e-5 and atol 1e-5 of the largest logit:
the two packages sum the same exact MXSF products in different orders and
evaluate rsqrt/exp/sin/cos with their own f32 routines.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core import mx_dot as JD
from repro.core.policy import MXSF_INFER as JAX_INFER
from repro.models import decoding as JDEC
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs.base import get_config as torch_config
from repro_torch.core import mx_dot as TD
from repro_torch.core.blocking import QuantizedTensor
from repro_torch.core.policy import MXSF_INFER as TORCH_INFER
from repro_torch.models import decoding as TDEC
from repro_torch.models import model as TM

torch.set_num_threads(2)

CACHE_KEYS = ["k_codes", "k_scales", "v_codes", "v_scales"]
LEAVES = [("layers", "sub0", "attn", "wq"), ("layers", "sub0", "attn", "wk"),
          ("layers", "sub0", "attn", "wv"), ("layers", "sub0", "attn", "wo"),
          ("layers", "sub0", "ffn", "wg"), ("layers", "sub0", "ffn", "wu"),
          ("layers", "sub0", "ffn", "wd"), ("head",)]


# the JAX entry points, jitted once per shape (cfg and policy are static)
JAX_DECODE = jax.jit(JM.decode_step, static_argnums=(4, 5))
JAX_PREFILL = jax.jit(JM.prefill_step, static_argnums=(5, 6))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    atol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.fixture(scope="module")
def ref():
    cfg_j = jax_config("qwen2.5-32b").reduced().replace(
        compute_dtype="float32")
    cfg_t = torch_config("qwen2.5-32b").reduced().replace(
        compute_dtype="float32")
    params_j = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = convert.params_from_numpy(
        jax.tree.map(np.asarray, params_j), cfg_t)
    pol_j = JAX_INFER.replace(kv_cache_fmt="mxsf", backend="pallas")
    pol_t = TORCH_INFER.replace(kv_cache_fmt="mxsf", backend="cuda")
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_t=params_t,
                store_j=JM.pack_model_params(cfg_j, params_j, pol_j),
                store_t=TM.pack_model_params(cfg_t, params_t, pol_t),
                pol_j=pol_j, pol_t=pol_t)


@pytest.mark.parametrize("path", LEAVES, ids=lambda p: p[-1])
def test_pack_model_params_bitwise(ref, path):
    qj, qt = _get(ref["store_j"], path), _get(ref["store_t"], path)
    assert isinstance(qt, QuantizedTensor)
    np.testing.assert_array_equal(qt.codes.numpy(), np.asarray(qj.codes))
    np.testing.assert_array_equal(qt.scale_e8m0.numpy(),
                                  np.asarray(qj.scale_e8m0))
    assert (qt.fmt, qt.block, qt.shape, qt.dtype) == (
        qj.fmt, tuple(qj.block), tuple(qj.shape), str(qj.dtype))


def test_pack_is_idempotent_and_keeps_values(ref):
    from repro.core import packed_store as JPS
    from repro_torch.core import packed_store as TPS
    again = TM.pack_model_params(ref["cfg_t"], ref["store_t"], ref["pol_t"])
    assert again["head"] is ref["store_t"]["head"]
    np.testing.assert_array_equal(ref["store_t"]["emb"].numpy(),
                                  np.asarray(ref["store_j"]["emb"]))
    assert TPS.store_nbytes(ref["store_t"]) == JPS.store_nbytes(
        ref["store_j"])
    np.testing.assert_array_equal(
        TPS.unpack_params(ref["store_t"])["head"].numpy(),
        np.asarray(JPS.unpack_params(ref["store_j"])["head"]))


@pytest.fixture(scope="module")
def steps(ref):
    """One decode step (every slot writes column 0), then one prefill chunk
    with slot 2 masked out (n_valid=0), then a decode step -- through both
    packages, under the forward quant-pass counters."""
    cfg_j, cfg_t = ref["cfg_j"], ref["cfg_t"]
    rng = np.random.default_rng(0)
    B, C, W = 3, 7, 16
    first = rng.integers(0, cfg_j.vocab, size=(B, 1)).astype(np.int32)
    chunk = rng.integers(0, cfg_j.vocab, size=(B, C)).astype(np.int32)
    nv = np.array([7, 4, 0], np.int32)
    pos = np.ones(B, np.int32)
    nxt = rng.integers(0, cfg_j.vocab, size=(B, 1)).astype(np.int32)
    calls = [("decode", first, np.zeros(B, np.int32), None),
             ("prefill", chunk, pos, nv),
             ("decode", nxt, pos + nv, None)]
    out = {"jax": [], "torch": []}
    cache_j = JM.init_cache(cfg_j, B, W, dtype=jnp.float32, ring=False,
                            kv_fmt="mxsf")
    cache_t = TM.init_cache(cfg_t, B, W, dtype=torch.float32, ring=False,
                            kv_fmt="mxsf", device="cpu")
    for kind, toks, p, n in calls:
        with JD.count_quant_passes() as cj:
            if kind == "decode":
                lj, cache_j = JAX_DECODE(
                    ref["store_j"], jnp.asarray(toks), cache_j,
                    jnp.asarray(p), cfg_j, ref["pol_j"])
            else:
                lj, cache_j = JAX_PREFILL(
                    ref["store_j"], jnp.asarray(toks), cache_j,
                    jnp.asarray(p), jnp.asarray(n), cfg_j, ref["pol_j"])
        before = {k: v.clone() for k, v in cache_t.items()}
        with TD.count_quant_passes() as ct:
            args = [torch.from_numpy(toks), cache_t, torch.from_numpy(p)]
            if kind == "decode":
                lt, cache_t = TM.decode_step(ref["store_t"], *args, cfg_t,
                                             ref["pol_t"])
            else:
                lt, cache_t = TM.prefill_step(ref["store_t"], *args,
                                              torch.from_numpy(n), cfg_t,
                                              ref["pol_t"])
        out["jax"].append((np.asarray(lj), jax.tree.map(np.asarray, cache_j),
                           cj["n"]))
        out["torch"].append((lt.numpy(), {k: v.numpy().copy()
                                          for k, v in cache_t.items()},
                             ct["n"], before))
    return out


@pytest.mark.parametrize("call", [0, 1, 2], ids=["decode", "prefill",
                                                 "decode2"])
def test_step_logits_match_jax(steps, call):
    lj, lt = steps["jax"][call][0], steps["torch"][call][0]
    if call == 1:  # slot 2 is masked out: its logits row is garbage
        lj, lt = lj[:2], lt[:2]
    assert lt.shape == lj.shape
    _close(lt, lj)


@pytest.mark.parametrize("call", [0, 1, 2], ids=["decode", "prefill",
                                                 "decode2"])
@pytest.mark.parametrize("key", CACHE_KEYS)
def test_step_cache_bytes_bitwise(steps, call, key):
    np.testing.assert_array_equal(steps["torch"][call][1][key],
                                  steps["jax"][call][1][key])


def test_masked_slot_leaves_cache_bit_identical(steps):
    _, after, _, before = steps["torch"][1]
    for key in CACHE_KEYS:
        np.testing.assert_array_equal(after[key][:, :, 2],
                                      before[key][:, :, 2].numpy())
        # slot 1 wrote exactly its 4 valid columns 1..4
        changed = (after[key][:, :, 1] != before[key][:, :, 1].numpy())
        cols = np.nonzero(changed.reshape(*changed.shape[:2],
                                          changed.shape[2], -1).any(
            axis=(0, 1, 3)))[0]
        assert set(cols.tolist()) <= {1, 2, 3, 4}, (key, cols)


def _first_layer(tree):
    """Cut a stacked store to its first layer (both packages' trees)."""
    if isinstance(tree, dict):
        return {k: _first_layer(v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(tree.codes[:1], tree.scale_e8m0[:1], tree.fmt,
                               tree.block, (1,) + tree.shape[1:], tree.dtype)
    return tree[:1]


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_forward_quant_pass_counts_equal(ref, steps, kind):
    """The JAX counter ticks at trace time, once for the scanned layer
    body; the port's ticks per call.  They count the same thing on a
    one-layer cut of the same store, and the port's four-layer count is
    that per-layer count times four, plus the head."""
    cfg_j = ref["cfg_j"].replace(n_layers=1)
    cfg_t = ref["cfg_t"].replace(n_layers=1)
    store_j = dict(ref["store_j"],
                   layers=jax.tree.map(lambda a: a[:1],
                                       ref["store_j"]["layers"]))
    store_t = dict(ref["store_t"],
                   layers=_first_layer(ref["store_t"]["layers"]))
    B, C = 2, 1 if kind == "decode" else 5
    toks = np.ones((B, C), np.int32)
    pos, nv = np.zeros(B, np.int32), np.full(B, C, np.int32)
    cache_j = JM.init_cache(cfg_j, B, 8, dtype=jnp.float32, ring=False,
                            kv_fmt="mxsf")
    cache_t = TM.init_cache(cfg_t, B, 8, dtype=torch.float32, ring=False,
                            kv_fmt="mxsf", device="cpu")
    with JD.count_quant_passes() as cj, TD.count_quant_passes() as ct:
        if kind == "decode":
            JM.decode_step(store_j, jnp.asarray(toks), cache_j,
                           jnp.asarray(pos), cfg_j, ref["pol_j"])
            TM.decode_step(store_t, torch.from_numpy(toks), cache_t,
                           torch.from_numpy(pos), cfg_t, ref["pol_t"])
        else:
            JM.prefill_step(store_j, jnp.asarray(toks), cache_j,
                            jnp.asarray(pos), jnp.asarray(nv), cfg_j,
                            ref["pol_j"])
            TM.prefill_step(store_t, torch.from_numpy(toks), cache_t,
                            torch.from_numpy(pos), torch.from_numpy(nv),
                            cfg_t, ref["pol_t"])
    # 7 linears + the q quantize per layer, plus the LM head
    assert ct["n"] == cj["n"] == 8 + 1
    call = 0 if kind == "decode" else 1
    assert steps["torch"][call][2] == 8 * ref["cfg_t"].n_layers + 1


def test_ring_position_regression(ref):
    """A final partial chunk whose padded extent overhangs the cache end
    (max_len=16, P=15, C=7: the last chunk starts at 14) must not shift or
    clamp its write, and its logits must match the JAX package."""
    cfg_j, cfg_t = ref["cfg_j"], ref["cfg_t"]
    W, P, C = 16, 15, 7
    prompt = np.random.default_rng(15).integers(0, cfg_j.vocab, size=P)
    cache_j = JM.init_cache(cfg_j, 1, W, dtype=jnp.float32, ring=False,
                            kv_fmt="mxsf")
    cache_t = TM.init_cache(cfg_t, 1, W, dtype=torch.float32, ring=False,
                            kv_fmt="mxsf", device="cpu")
    for start in range(0, P, C):
        n = min(C, P - start)
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = prompt[start:start + n]
        pos, nv = np.array([start], np.int32), np.array([n], np.int32)
        lj, cache_j = JAX_PREFILL(ref["store_j"], jnp.asarray(toks),
                                      cache_j, jnp.asarray(pos),
                                      jnp.asarray(nv), cfg_j, ref["pol_j"])
        lt, cache_t = TM.prefill_step(ref["store_t"], torch.from_numpy(toks),
                                      cache_t, torch.from_numpy(pos),
                                      torch.from_numpy(nv), cfg_t,
                                      ref["pol_t"])
    _close(lt.numpy(), np.asarray(lj))
    for key in CACHE_KEYS:
        np.testing.assert_array_equal(cache_t[key].numpy(),
                                      np.asarray(cache_j[key]))
    assert not cache_t["k_codes"][:, :, 0, P:].any()  # column 15 unwritten


def test_kv_cache_rows_matches_jax(steps):
    cache = steps["torch"][2][1]
    layer_t = {k: torch.from_numpy(v[0, 0]) for k, v in cache.items()}
    layer_j = {k: jnp.asarray(v[0, 0]) for k, v in cache.items()}
    for got, want in zip(TDEC.kv_cache_rows(layer_t),
                         JDEC.kv_cache_rows(layer_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_packed_params_equals_packing_init_params(ref):
    """The leaf-by-leaf store draws the same values as init_params."""
    cfg, pol = ref["cfg_t"], ref["pol_t"]
    store = TM.init_packed_params(cfg, pol, torch.Generator().manual_seed(3))
    full = TM.pack_model_params(
        cfg, TM.init_params(cfg, torch.Generator().manual_seed(3)), pol)
    for path in LEAVES:
        a, b = _get(store, path), _get(full, path)
        assert torch.equal(a.codes, b.codes) and a.shape == b.shape
        assert torch.equal(a.scale_e8m0, b.scale_e8m0)
    assert torch.equal(store["emb"], full["emb"])
    assert torch.equal(store["layers"]["sub0"]["attn"]["bq"],
                       full["layers"]["sub0"]["attn"]["bq"])


CONFIG_NAMES = ["deit-tiny", "gemma2-2b", "gemma2-9b", "h2o-danube-1.8b",
                "internvl2-1b", "llama4-maverick-400b-a17b", "mamba2-780m",
                "qwen2-moe-a2.7b", "qwen2.5-32b", "whisper-medium",
                "zamba2-7b"]


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_configs_match_field_by_field(name):
    import dataclasses
    from repro.configs.base import list_configs
    assert sorted(CONFIG_NAMES) == list_configs()
    for variant in (lambda c: c, lambda c: c.reduced()):
        j, t = variant(jax_config(name)), variant(torch_config(name))
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.padded_vocab == j.padded_vocab
        if j.n_heads:  # attention-free configs have no head dim
            assert t.head_dim == j.head_dim


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("kv_fmt", ["", "mxsf"])
@pytest.mark.parametrize("block_mode", ["none", "1d", "2d"])
def test_policy_predicates_match(backend, kv_fmt, block_mode):
    from repro.core.policy import MXSF_TRAIN
    port_backend = {"jnp": "torch", "pallas": "cuda"}[backend]
    for base_j in (JAX_INFER, MXSF_TRAIN):
        pj = base_j.replace(backend=backend, kv_cache_fmt=kv_fmt,
                            block_mode=block_mode)
        fields = {f: getattr(pj, f) for f in (
            "fwd_fmt", "bwd_fmt", "block_mode", "block_1d", "tile",
            "quantize_bwd", "attn_matmuls", "kv_cache_fmt")}
        pt = TORCH_INFER.replace(backend=port_backend, **fields)
        assert pt.enabled == pj.enabled
        assert pt.use_kernels == pj.use_pallas
        assert pt.use_attention_kernel == pj.use_pallas_attention


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("name", ["qwen2.5-32b", "h2o-danube-1.8b",
                                  "gemma2-2b"])
def test_init_params_tree_layout_matches_jax(name):
    """Same keys, stacked shapes and dtypes; zero biases and unit norms."""
    cfg_j, cfg_t = jax_config(name).reduced(), torch_config(name).reduced()
    pj = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg_j))
    pt = TM.init_params(cfg_t, torch.Generator().manual_seed(0))
    assert _layout(pt) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), pj)
    sub = pt["layers"]["sub0"]
    assert bool((sub["ln1"]["w"] == 1).all())
    if cfg_t.qkv_bias:
        assert not sub["attn"]["bq"].any()
    # normal * 1/sqrt(d_in): the spread of a projection, within sampling
    std = float(sub["attn"]["wq"].std()) * cfg_t.d_model ** 0.5
    assert 0.9 < std < 1.1, std
