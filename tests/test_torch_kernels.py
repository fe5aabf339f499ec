"""The port's kernels: plain versions against the JAX package's Pallas
kernels (interpret mode, as the JAX package's own tests run them), and the
CUDA kernels against their plain versions on the card (marked ``gpu``).

Inputs come from numpy with a seed.  Tolerances: both sides sum f32
products in different orders (XLA's dot and online softmax vs torch's
matmul and full softmax).  The matmul products are exact (decoded MXSF
values carry at most 6 significant bits), so the results differ by f32
summation rounding only: rtol 1e-5 with atol 1e-5 of the output's largest
magnitude.  Attention adds exp() and the softmax division: the same
bound.

The JAX package is imported inside a fixture: the card's machine has no
JAX, and there ``pytest -m gpu tests/test_torch_kernels.py`` runs the card
test alone.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import blocking as TB
from repro_torch.kernels import mxsf_attention as TA
from repro_torch.kernels import mxsf_fused_matmul as TM

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules the parity tests use."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import blocking
    from repro.kernels import ops
    return types.SimpleNamespace(jnp=jnp, B=blocking, ops=ops)


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = rtol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _packed_weight(jx, kp: int, n: int, seed: int):
    w = np.random.default_rng(seed).standard_normal((kp, n)).astype(
        np.float32)
    qt = jx.B.quantize(jx.jnp.asarray(w), "mxsf", (64, 1))
    return np.array(qt.codes), np.array(qt.scale_e8m0)


# K is x's width, the weight is block-padded to 64 or 192 rows: K gap
@pytest.mark.parametrize("m", [1, 5, 16])
@pytest.mark.parametrize("k,kp", [(40, 64), (150, 192)])
@pytest.mark.parametrize("n", [32, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_matmul_plain_matches_jax(jx, m, k, kp, n, dtype):
    rng = np.random.default_rng(m * 1000 + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32) * 3.0
    wc, ws = _packed_weight(jx, kp, n, seed=k + n)
    jnp = jx.jnp
    want = jx.ops.mxsf_fused_matmul(jnp.asarray(x).astype(dtype),
                                    jnp.asarray(wc), jnp.asarray(ws),
                                    (1, 64), (64, 1))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = TM.mxsf_fused_matmul(xt, torch.from_numpy(wc), torch.from_numpy(ws),
                               (1, 64), (64, 1))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    _close(got.numpy(), want)
    assert TM.launches == 0  # the CPU path launches nothing


def _cache(jx, Bsz, L, kv, dh, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        val = rng.standard_normal((Bsz, L, kv, dh)).astype(np.float32)
        qt = jx.B.quantize(jx.jnp.asarray(val), "mxsf", (dh,))
        out += [np.array(qt.codes), np.array(qt.scale_e8m0)]
    return out  # k_codes, k_scales, v_codes, v_scales


def _rows(Bsz, h, S, L, seed):
    """Per-row kv_len (one row 0), q_offset and a q tensor."""
    rng = np.random.default_rng(seed)
    BH = Bsz * h
    kvl = rng.integers(S, L + 1, size=BH).astype(np.int32)
    kvl[1] = 0
    off = np.maximum(kvl - S, 0).astype(np.int32)
    off[0] = max(0, off[0] - 3)  # a chunk whose queries see a shorter past
    q = rng.standard_normal((BH, S, 16)).astype(np.float32)
    return q, kvl, off


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("S", [1, 7])
@pytest.mark.parametrize("window", [None, 5])
def test_attention_plain_matches_jax_cache_layout(jx, g, S, window):
    Bsz, L, kv, dh = 2, 24, 2, 16
    h = kv * g
    jnp = jx.jnp
    cache = _cache(jx, Bsz, L, kv, dh, seed=g + S)
    q, kvl, off = _rows(Bsz, h, S, L, seed=S)
    win = None if window is None else np.full(Bsz * h, window, np.int32)
    want = jx.ops.mxsf_attention(jnp.asarray(q), *map(jnp.asarray, cache),
                               causal=True, kv_len=jnp.asarray(kvl),
                               q_offset=jnp.asarray(off),
                               window=None if win is None else
                               jnp.asarray(win), ck=8)
    got = TA.mxsf_attention(torch.from_numpy(q),
                            *map(torch.from_numpy, cache), causal=True,
                            kv_len=torch.from_numpy(kvl),
                            q_offset=torch.from_numpy(off),
                            window=None if win is None else
                            torch.from_numpy(win))
    _close(got.numpy(), want)
    assert not got[1].any()  # kv_len=0 row returns 0


def test_attention_plain_matches_jax_row_layout(jx):
    Bsz, L, kv, dh, g, S = 2, 24, 2, 16, 2, 3
    h = kv * g
    jnp = jx.jnp
    kc, ks, vc, vs = _cache(jx, Bsz, L, kv, dh, seed=11)

    def rows(c):  # (B, L, kv, dh) -> (B*kv, L, dh)
        return np.ascontiguousarray(c.transpose(0, 2, 1, 3).reshape(
            Bsz * kv, L, -1))

    rk = [rows(kc), rows(ks)[..., 0], rows(vc), rows(vs)[..., 0]]
    q, kvl, off = _rows(Bsz, h, S, L, seed=12)
    args = dict(causal=True, kv_len=kvl, q_offset=off)
    want = jx.ops.mxsf_attention(jnp.asarray(q), *map(jnp.asarray, rk),
                               **{k: jnp.asarray(v) if k != "causal" else v
                                  for k, v in args.items()})
    got_rows = TA.mxsf_attention(
        torch.from_numpy(q), *map(torch.from_numpy, rk), causal=True,
        kv_len=torch.from_numpy(kvl), q_offset=torch.from_numpy(off))
    got_cache = TA.mxsf_attention(
        torch.from_numpy(q), *map(torch.from_numpy, (kc, ks, vc, vs)),
        causal=True, kv_len=torch.from_numpy(kvl),
        q_offset=torch.from_numpy(off))
    _close(got_rows.numpy(), want)
    np.testing.assert_array_equal(got_rows.numpy(), got_cache.numpy())


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _edge_x(m, k, seed):
    """Activations with zero, subnormal, +-3e38 and S_e near +-127 blocks."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0, :64] = 0.0
    if m > 1:
        x[1, :64] *= np.float32(1e-40)
        x[1, 64:128] = np.float32(3e38) * np.sign(x[1, 64:128])
    x[-1, -64:] *= np.float32(2.0 ** -120)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    dev, dt = cuda_device, getattr(torch, dtype)
    for m, k, kp, n in ((4, 320, 320, 1000), (64, 200, 256, 4096),
                        (16, 5120, 5120, 1024)):
        x = torch.from_numpy(_edge_x(m, k, seed=m)).to(dev, dt)
        w = torch.randn((kp, n), generator=torch.Generator().manual_seed(n))
        w[64:128] *= 2.0 ** -100  # x's 3e38 block: products stay finite
        qt = TB.quantize(w.to(dev), "mxsf", (64, 1))
        got = TM.mxsf_fused_matmul(x, qt.codes, qt.scale_e8m0)
        want = TM.mxsf_fused_matmul_plain(x, qt.codes, qt.scale_e8m0)
        torch.cuda.synchronize()
        # exact products, different f32 summation order; row by row, as
        # the edge rows differ in scale by many orders of magnitude
        assert bool(torch.isfinite(got).all() and torch.isfinite(want).all())
        for r in range(m):
            _close(got[r].cpu().numpy(), want[r].cpu().numpy())
    Bsz, L, kv, dh, h, S = 3, 100, 8, 128, 40, 16
    gen = torch.Generator().manual_seed(0)
    k = TB.quantize(torch.randn((Bsz, L, kv, dh), generator=gen).to(dev),
                    "mxsf", (dh,))
    v = TB.quantize(torch.randn((Bsz, L, kv, dh), generator=gen).to(dev),
                    "mxsf", (dh,))
    for s in (1, S):
        q = torch.randn((Bsz * h, s, dh), generator=gen).to(dev, dt)
        kvl = torch.tensor([0, 37, 100], dtype=torch.int32).repeat_interleave(h)
        off = torch.clamp(kvl - s, min=0)
        win = torch.tensor([1 << 30, 9, 1 << 30]).repeat_interleave(h)
        args = dict(causal=True, kv_len=kvl.to(dev), q_offset=off.to(dev),
                    window=win.to(dev))
        got = TA.mxsf_attention(q, k.codes, k.scale_e8m0, v.codes,
                                v.scale_e8m0, **args)
        want = TA.mxsf_attention_plain(q, k.codes, k.scale_e8m0, v.codes,
                                       v.scale_e8m0, **args)
        torch.cuda.synchronize()
        # bf16 outputs may round one bf16 ulp apart
        rtol = 1e-5 if dtype == "float32" else 2.0 ** -8
        _close(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_matmul_codec_bitwise(cuda_device, dtype):
    """The kernel's quantize prologue bit for bit: against an identity
    weight every output is one exact product, so y == qdq(x) exactly --
    random values, values on rounding midpoints (k + 1/2 steps of each
    regime), and the edge blocks, with a K gap and a ragged M."""
    dev, dt = cuda_device, getattr(torch, dtype)
    m, k, kp = 37, 1000, 1024
    rng = np.random.default_rng(7)
    ties = np.array([(q + 0.5) * 2.0 ** (e - 5) for e in (-2, -1, 0)
                     for q in range(32, 64)]
                    + [(q + 0.5) * 2.0 ** (e - 2) for e in range(-9, -2)
                       for q in range(4, 8)]
                    + [(q + 0.5) * 2.0 ** -11 for q in range(4)], np.float32)
    tie_x = ties[rng.integers(len(ties), size=(m, k))]
    tie_x[:, ::64] = 1.9921875  # the block max: S_e = 0 before the 2^j
    tie_x *= np.where(rng.random((m, k)) < 0.5, -1, 1).astype(np.float32)
    tie_x *= np.exp2(rng.integers(-40, 41, size=(m, 1))).astype(np.float32)
    eye = TB.quantize(torch.eye(kp, device=dev), "mxsf", (64, 1))
    for x in (rng.standard_normal((m, k)).astype(np.float32), tie_x,
              _edge_x(m, k, seed=3)):
        xt = torch.from_numpy(x).to(dev, dt)
        got = TM.mxsf_fused_matmul(xt, eye.codes, eye.scale_e8m0)
        want = TB.qdq(torch.nn.functional.pad(xt.float(), (0, kp - k)),
                      "mxsf", (1, 64))
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_serving_matmul_exact_sum_bitwise(cuda_device):
    """The serving instances (16 x 256 mma.sync tiles at 16 rows or fewer,
    64 x 256 wgmma tiles up to 64) with K split across blocks and reduced
    in order: bit for bit against the plain version on operands whose
    every partial sum is exact in f32, so no summation order can differ."""
    dev = cuda_device
    rng = np.random.default_rng(11)
    vals = np.array([0.0, 0.5, -0.5, 1.0, -1.0, 2.0, -2.0], np.float32)

    def exact(shape, block):
        x = vals[rng.integers(0, 7, size=shape)]
        bi = np.arange(shape[0])[:, None] // block[0]
        bj = np.arange(shape[1])[None, :] // block[1]
        return x * np.exp2((bi + bj) % 2).astype(np.float32)

    for m, k, n in ((4, 5120, 1024), (16, 2048, 520), (64, 5120, 1024)):
        x = torch.from_numpy(exact((m, k), (1, 64))).to(dev, torch.bfloat16)
        qt = TB.quantize(torch.from_numpy(exact((k, n), (64, 1))).to(dev),
                         "mxsf", (64, 1))
        got = TM.mxsf_fused_matmul(x, qt.codes, qt.scale_e8m0)
        want = TM.mxsf_fused_matmul_plain(x, qt.codes, qt.scale_e8m0)
        assert torch.equal(got, want), (m, k, n)
