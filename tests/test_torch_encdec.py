"""The port's encoder-decoder family (whisper: ``encode`` over stubbed frame
embeddings, causal self-attention, cross-attention to the encoder's states)
against the JAX package's, on the reduced whisper-medium config (2 encoder
and 4 decoder layers of d_model 64, 32 frames).

Weights come from the JAX package through ``convert``; the JAX side runs
its value-domain reference (``"jnp"``, jitted), the port its own
(``"torch"``) or its kernels' plain versions (``"cuda"`` on CPU tensors).
Tolerances are ``torch_families``'s; the kernel datapath's self-attention
calls are held one by one against the JAX package's kernel on the same
inputs (``assert_attention_calls_match_jax``).

Sinusoidal positions: the two frameworks' f32 sin/cos differ by a few ulps
(at the reduced 32 x 64 table by at most 6e-8; at whisper's 1500 frames,
angles up to 1500 rad, by 3e-5).  Added to the embeddings before an MX
quantization, such an ulp now and then lands on a rounding midpoint and
flips a code, and the free-running logits part by a code step.  So the
tables are compared on their own (``test_sinusoid_positions_match_jax``),
and the model tests feed the port the JAX package's tables
(``jax_positions``), as the card run teacher-forces each kernel call.
The cross K/V that ``prefill`` precomputes is a plain bf16 matmul in both
packages: on the JAX package's encoder output all but one element in a
thousand are bit-identical and each is within a bf16 rounding of the
largest (the two libraries order the f32 sum differently before the one
rounding to bf16).

Under ``MXSF_TRAIN`` the free-running forward is chaotic: the two
frameworks' rmsnorm (rsqrt, mean) differ by an f32 ulp, and an ulp on an
MX rounding midpoint flips a code (two rows of the reduced model's 32
logit rows part by a code step).  Fed the JAX package's input, every
sublayer of the port gives the JAX package's output bit for bit.  So the
quantized forward is held sublayer by sublayer at the whole depth
(``test_sublayers_match_jax_op_by_op``), the unquantized forward and
gradients free-running within 1e-5 and 1e-4 at the whole depth, and, as
the MoE tests do, the quantized step-0 loss and gradients at one encoder
and one decoder layer (at the whole depth flips move the gradient leaves
by 1-2%; at one layer each every leaf agrees within 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import BF16 as JAX_BF16
from repro.core.policy import MXSF_INFER as JAX_INFER
from repro.core.policy import MXSF_TRAIN as JAX_TRAIN
from repro.models import blocks as JB
from repro.models import decoding as JD
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.core.policy import BF16, MXSF_INFER, MXSF_TRAIN
from repro_torch.models import blocks as TB
from repro_torch.models import decoding as TD
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from torch_families import (JAX_DECODE, JAX_FORWARD, JAX_PACK, JAX_PREFILL,
                            assert_attention_calls_match_jax, assert_step0,
                            attention_calls, cfgs, close, dtypes, flat,
                            jax_params, step0_both, to_port)

ARCH = "whisper-medium-reduced"
TRAIN = MXSF_TRAIN.replace(backend="cuda")


def _frames(cfg, B=2, seed=2):
    return (np.random.default_rng(seed).standard_normal(
        (B, cfg.enc_seq, cfg.d_model)) * 0.5).astype(np.float32)


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def _jax_table(S, d, offset=0, device=None):
    return torch.from_numpy(np.asarray(JT._sinusoid_pos(S, d, offset)))


def _jax_dynamic(pos, d):
    return torch.from_numpy(np.asarray(jax.vmap(
        lambda p: JD._dynamic_sinusoid(p, d))(jnp.asarray(pos.numpy()))))


@pytest.fixture
def jax_positions(monkeypatch):
    """The port computes with the JAX package's sinusoid tables."""
    monkeypatch.setattr(TT, "sinusoid_pos", _jax_table)
    monkeypatch.setattr(TD, "dynamic_sinusoid", _jax_dynamic)


def test_sinusoid_positions_match_jax():
    cj, _ = cfgs(ARCH)
    close(TT.sinusoid_pos(cj.enc_seq, cj.d_model),
          JT._sinusoid_pos(cj.enc_seq, cj.d_model))
    pos = torch.arange(0, 16, 3)
    close(TD.dynamic_sinusoid(pos, cj.d_model),
          _jax_dynamic(pos, cj.d_model).numpy())


def test_encode_matches_jax(jax_positions):
    cj, ct = cfgs(ARCH)
    params = jax_params(cj)
    frames = _frames(cj)
    want = JT.encode(params, jnp.asarray(frames), cj, JAX_TRAIN)
    got = TT.encode(to_port(params, ct), torch.from_numpy(frames), ct, TRAIN)
    close(got, want)


def test_encdec_forward_matches_jax(jax_positions):
    """The unquantized forward, free-running."""
    cj, ct = cfgs(ARCH)
    params = jax_params(cj)
    batch = {"tokens": _tokens(cj, 2, 16), "frames": _frames(cj)}
    want = JAX_FORWARD(params, {k: jnp.asarray(v) for k, v in batch.items()},
                       cj, JAX_BF16)
    got = TT.forward(to_port(params, ct),
                     {k: torch.from_numpy(v) for k, v in batch.items()}, ct,
                     BF16)
    close(got, want)


def test_sublayers_match_jax_op_by_op():
    """``MXSF_TRAIN``, every decoder sublayer of the whole depth fed the
    JAX package's op-by-op input (self-attention, cross-attention to the
    JAX package's encoder output, MLP): the port's output within 1e-5."""
    cj, ct = cfgs(ARCH)
    params = jax_params(cj)
    pt = to_port(params, ct)
    toks, frames = _tokens(cj, 2, 16), _frames(cj)
    enc = JT.encode(params, jnp.asarray(frames), cj, JAX_TRAIN)
    enc_t = torch.from_numpy(np.array(enc))
    x = params["emb"][toks] + JT._sinusoid_pos(16, cj.d_model)
    pos = jnp.broadcast_to(jnp.arange(16)[None], (2, 16))
    t = lambda a: torch.from_numpy(np.array(a))
    layers = TT._unstack(pt["dec_layers"], ct.n_layers)
    for i, lt in enumerate(layers):
        lj = {k: {n: v[i] for n, v in d.items()}
              for k, d in params["dec_layers"].items()}
        h = JB.rmsnorm(lj["ln1"], x)
        a, _ = JB.attention(lj["self"], h, cj, JAX_TRAIN, positions=pos)
        close(TB.attention(lt["self"], t(h), ct, TRAIN, positions=t(pos))[0],
              a)
        x = x + a
        h = JB.rmsnorm(lj["ln2"], x)
        c, _ = JB.attention(lj["cross"], h, cj, JAX_TRAIN, positions=pos,
                            kv_x=enc, causal=False)
        close(TB.attention(lt["cross"], t(h), ct, TRAIN, kv_x=enc_t,
                           causal=False)[0], c)
        x = x + c
        h = JB.rmsnorm(lj["ln3"], x)
        m = JB.mlp(lj["mlp"], h, cj, JAX_TRAIN)
        close(TB.mlp(lt["mlp"], t(h), ct, TRAIN), m)
        x = x + m


def test_prefill_cross_kv_is_bitwise_in_bf16(monkeypatch):
    """bf16 compute: ``prefill`` encodes the frames and precomputes each
    decoder layer's cross K/V as a plain bf16 matmul -- the same bits in
    both packages on the same encoder output -- returns no logits and sets
    ``cross_ready``."""
    cj, ct = cfgs(ARCH, "bfloat16")
    params = jax_params(cj)
    frames = _frames(cj)
    enc = torch.from_numpy(np.asarray(
        JT.encode(params, jnp.asarray(frames), cj, JAX_BF16)
        .astype(jnp.float32))).to(torch.bfloat16)
    monkeypatch.setattr(TD, "encode", lambda *a, **k: enc)
    cache_j = JM.init_cache(cj, 2, 16)
    cache_t = TM.init_cache(ct, 2, 16, device="cpu")
    assert dtypes(cache_t) == dtypes(cache_j)
    lj, cache_j = JAX_PREFILL(params, {"frames": jnp.asarray(frames)},
                              cache_j, cj, JAX_BF16)
    lt, cache_t = TM.prefill(to_port(params, ct),
                             {"frames": torch.from_numpy(frames)}, cache_t,
                             ct, BF16)
    assert lj is None and lt is None
    assert dtypes(cache_t) == dtypes(cache_j)
    assert dtypes(cache_t)[("cross", "k")] == "bfloat16"
    assert int(cache_t["cross_ready"]) == int(cache_j["cross_ready"]) == 1
    fj, ft = flat(cache_j), flat(cache_t)
    for k in (("cross", "k"), ("cross", "v")):
        assert ft[k].shape == (ct.n_layers, 2, ct.enc_seq, ct.n_kv,
                               ct.head_dim)
        _bf16_close(ft[k], fj[k])


def _bf16_close(got, want):
    """All but one in a thousand bit-identical, the rest within a bf16
    rounding of the largest magnitude (a small element's f32 sums can
    part by more than an ulp of itself)."""
    assert np.mean(got != want) <= 1e-3
    close(got, want, rtol=2.0 ** -8)


# the self-attention cache's width: not tests/test_serve_engine.py's 16, at
# which the JAX kernel calls below would trace that test's decode grid (the
# same q and cache shapes) earlier on a shared pytest-xdist worker and
# leave it nothing to compile
SELF_CACHE = 24


def _serve(store, cfg, policy, frames, toks, prefill, decode, init_cache,
           **kw):
    """``prefill`` of the frames, then a decode step per token: (logits of
    each step, cache)."""
    cache = init_cache(cfg, 2, SELF_CACHE, kv_fmt="mxsf", **kw)
    _, cache = prefill(store, {"frames": frames}, cache, cfg, policy)
    out = []
    for t in range(toks.shape[1]):
        lg, cache = decode(store, toks[:, t:t + 1], cache, t, cfg, policy)
        out.append(lg)
    return out, cache


def test_packed_decode_logits_match_jax(jax_positions):
    """Packed store (cross-attention in values) and packed self cache on
    the value path: 4 decode steps after ``prefill`` -- logits, every self
    cache byte, the cross K/V."""
    cj, ct = cfgs(ARCH)
    jpol = JAX_INFER.replace(kv_cache_fmt="mxsf")
    tpol = MXSF_INFER.replace(kv_cache_fmt="mxsf", backend="torch")
    store = JAX_PACK(cj, jax_params(cj), jpol)
    frames, toks = _frames(cj), _tokens(cj, 2, 4)
    lj, cache_j = _serve(store, cj, jpol, jnp.asarray(frames),
                         jnp.asarray(toks), JAX_PREFILL, JAX_DECODE,
                         JM.init_cache, dtype=jnp.float32)
    st = to_port(store, ct)
    # the cross-attention stays in values, the self-attention is packed
    assert isinstance(st["dec_layers"]["cross"]["wq"], torch.Tensor)
    assert not isinstance(st["dec_layers"]["self"]["wq"], torch.Tensor)
    lt, cache_t = _serve(st, ct, tpol, torch.from_numpy(frames),
                         torch.from_numpy(toks), TM.prefill, TM.decode_step,
                         TM.init_cache, dtype=torch.float32, device="cpu")
    for got, want in zip(lt, lj):
        close(got, want)
    fj, ft = flat(cache_j), flat(cache_t)
    assert sorted(ft) == sorted(fj)
    for k in fj:
        if k[0] == "self":
            np.testing.assert_array_equal(ft[k], fj[k], err_msg=str(k))
        elif k[0] == "cross":
            _bf16_close(ft[k], fj[k])
        else:
            close(ft[k], fj[k])


def test_kernel_path_attention_calls_match_jax():
    """The kernel datapath: every self-attention kernel call of 4 decode
    steps (one per decoder layer each) against the JAX package's kernel on
    the same inputs."""
    cj, ct = cfgs(ARCH)
    tpol = MXSF_INFER.replace(kv_cache_fmt="mxsf", backend="cuda")
    st = TM.pack_model_params(
        ct, TM.init_params(ct, torch.Generator().manual_seed(0)), tpol)
    calls = attention_calls(lambda: _serve(
        st, ct, tpol, torch.from_numpy(_frames(ct)),
        torch.from_numpy(_tokens(ct, 2, 4)), TM.prefill, TM.decode_step,
        TM.init_cache, dtype=torch.float32, device="cpu"))
    assert len(calls) == 4 * ct.n_layers
    assert_attention_calls_match_jax(calls)


def test_step0_loss_and_grads_match_jax(jax_positions):
    """Unquantized at the whole depth, ``MXSF_TRAIN`` at one encoder and
    one decoder layer (see the module docstring)."""
    cj, ct = cfgs(ARCH)
    toks = _tokens(cj, 2, 16)
    batch = {"tokens": jnp.asarray(toks),
             "labels": jnp.asarray(np.roll(toks, -1, axis=1)),
             "frames": jnp.asarray(_frames(cj))}
    assert_step0(step0_both(jax_params(cj), cj, ct, batch, JAX_BF16, BF16))
    cj, ct = cfgs(ARCH, n_layers=1, n_enc_layers=1)
    assert_step0(step0_both(jax_params(cj), cj, ct, batch, JAX_TRAIN, TRAIN))
