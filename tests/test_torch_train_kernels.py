"""The port's training kernels: the plain versions of the quantizer, the
packed->packed requantize, the packed x packed matmul and the fused
matmul's training switches (``emit_codes``, ``quantize_lhs=False``, (8,8)
tiles) against the JAX package's Pallas kernels (interpret mode, as its
own tests run them) and its ``kernels/ref.py`` oracles; the CUDA kernels
against their plain versions on the card (marked ``gpu``).

Inputs come from numpy with a seed.  The sweeps hold the port against the
``ref.py`` oracles (jitted jnp); one case per kernel and switch also runs
the Pallas kernel itself, which the JAX package's own tests hold bitwise to
the same oracles.  Codes and E8M0 scales are compared bitwise.
Matmuls: with quantized operands every product is exact (decoded MXSF
values carry at most 6 significant bits), so the packages differ by f32
summation order only: rtol 1e-5 with atol 1e-5 of the output's
largest magnitude.  The raw-x path (``quantize_lhs=False``) also rounds
each product, in both packages alike; K stays <= 256 here, so the same
bound holds.

Subnormals: XLA's CPU runtime flushes them, so a subnormal block is held
against the JAX package on the same block scaled by 2^64 (codes are
scale-free; the E8M0 byte moves by 64 unless it clips at 0), and the
requantize of tiny scales against the port's own
``quantize(dequantize(.))``.

The JAX package is imported inside a fixture: the card's machine has no
JAX, and there ``pytest -m gpu tests/test_torch_train_kernels.py`` runs the
card tests alone.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import blocking as TB
from repro_torch.kernels import mx_matmul as TMM
from repro_torch.kernels import mxsf_fused_matmul as TFM
from repro_torch.kernels import mxsf_quant as TQ

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's functions the parity tests use; the oracles are
    jitted (one compile per shape is far quicker than eager dispatch)."""
    jax = pytest.importorskip("jax")
    from repro.core import blocking
    from repro.kernels import ops, ref
    jit = jax.jit
    return types.SimpleNamespace(
        jnp=jax.numpy, B=blocking, ops=ops,
        quantize=jit(blocking.quantize, static_argnums=(1, 2)),
        ref=types.SimpleNamespace(
            mxsf_quantize_ref=jit(ref.mxsf_quantize_ref, static_argnums=1),
            mxsf_requantize_ref=jit(ref.mxsf_requantize_ref,
                                    static_argnums=(2, 3)),
            mxsf_matmul_ref=jit(ref.mxsf_matmul_ref, static_argnums=(4, 5)),
            mxsf_fused_matmul_ref=jit(ref.mxsf_fused_matmul_ref,
                                      static_argnums=(3, 4, 5))))


def _rand(shape, seed, sigma=2.0):
    """Values spread over many binades (exercises both MXSF regimes)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp(rng.standard_normal(shape)
                                            * sigma)
    return x.astype(np.float32)


def _edge(shape, seed):
    """Zero and -0.0 blocks, +-3e38, S_e near +127 and -126, and values on
    rounding midpoints of every regime (all normal floats)."""
    x = _rand(shape, seed)
    x[0, :16] = 0.0
    x[1, :16] = -0.0
    x[2, 16:32] = np.float32(3e38) * np.sign(x[2, 16:32])
    x[3, :] *= np.float32(2.0 ** -100)
    ties = np.array([(q + 0.5) * 2.0 ** (e - 5) for e in (-2, -1, 0)
                     for q in range(32, 64, 7)]
                    + [(q + 0.5) * 2.0 ** (e - 2) for e in range(-9, -2)
                       for q in range(4, 8)], np.float32)
    row = np.resize(ties, shape[1])
    row[::8] = 1.9921875
    x[4, :] = row
    return x


def _same(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = rtol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


BLOCKS = [(1, 64), (64, 1), (8, 8), (1, 32)]


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("shape", [(64, 128), (37, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_plain_matches_jax(jx, block, shape, dtype):
    x = _edge(shape, seed=shape[0] + block[0])
    xj = jx.jnp.asarray(x).astype(dtype)
    got_c, got_s = TQ.mxsf_quantize(torch.from_numpy(x).to(getattr(torch,
                                                                 dtype)),
                                    block)
    wants = [jx.ref.mxsf_quantize_ref(xj, block)]
    if shape == (37, 100) and block in ((8, 8), (1, 64)):
        wants.append(jx.ops.mxsf_quantize(xj, block=block))  # Pallas
    for want_c, want_s in wants:
        _same(got_c, want_c)
        _same(got_s, want_s)
    # the plain version is blocking.quantize, byte for byte
    qt = TB.quantize(torch.from_numpy(x).to(getattr(torch, dtype)), "mxsf",
                     block)
    assert torch.equal(got_c, qt.codes) and torch.equal(got_s, qt.scale_e8m0)
    assert TQ.launches["mxsf_quantize"] == 0  # the CPU path launches nothing


@pytest.mark.parametrize("block", BLOCKS)
def test_quantize_subnormal_blocks_scaled(jx, block):
    """A whole-subnormal operand codes like its 2^64-scaled copy."""
    x = _rand((64, 64), seed=5, sigma=0.5) * np.float32(1e-39)
    assert (np.abs(x) < 2.0 ** -126).all()
    got_c, got_s = TQ.mxsf_quantize(torch.from_numpy(x), block)
    want_c, want_s = jx.ref.mxsf_quantize_ref(
        jx.jnp.asarray(x * np.float32(2.0 ** 64)), block)
    _same(got_c, want_c)
    np.testing.assert_array_equal(
        got_s.numpy(), np.clip(np.asarray(want_s).astype(np.int32) - 64, 0, 255))


# ---------------------------------------------------------------------------
# requantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fb,tb", [((64, 1), (1, 64)), ((1, 64), (64, 1)),
                                   ((8, 8), (1, 8)), ((1, 32), (32, 1))])
@pytest.mark.parametrize("shape", [(64, 128), (40, 100)])
def test_requantize_plain_matches_jax(jx, fb, tb, shape):
    x = _edge(shape, seed=7 + fb[0])
    qt = jx.quantize(jx.jnp.asarray(x), "mxsf", fb)
    got_c, got_s = TQ.mxsf_requantize(torch.from_numpy(np.array(qt.codes)),
                                      torch.from_numpy(
                                          np.array(qt.scale_e8m0)), fb, tb)
    wants = [jx.ref.mxsf_requantize_ref(qt.codes, qt.scale_e8m0, fb, tb)]
    if shape == (40, 100) and fb in ((64, 1), (1, 64)):
        wants.append(jx.ops.mxsf_requantize(qt.codes, qt.scale_e8m0, fb,
                                            tb))  # Pallas
    for want_c, want_s in wants:
        _same(got_c, want_c)
        _same(got_s, want_s)
    assert TQ.launches["mxsf_requantize"] == 0


@pytest.mark.parametrize("fb,tb", [((64, 1), (1, 64)), ((1, 64), (64, 1))])
def test_requantize_tiny_scales_is_quantize_of_dequantize(fb, tb):
    """Blocks whose decode is subnormal (scale bytes near 0) and S_e = 127
    blocks: bit for bit ``quantize(dequantize(qt), to_block)`` in the port
    (IEEE subnormals, where XLA's CPU runtime would flush them)."""
    x = _rand((64, 128), seed=9)
    x[:8] *= np.float32(1e-39)
    x[8:16] *= np.float32(2.0 ** -140)
    x[16:24] = np.float32(3e38) * np.sign(x[16:24])
    qt = TB.quantize(torch.from_numpy(x), "mxsf", fb)
    got_c, got_s = TQ.mxsf_requantize(qt.codes, qt.scale_e8m0, fb, tb)
    full = TB.QuantizedTensor(qt.codes, qt.scale_e8m0, "mxsf", fb,
                              tuple(qt.codes.shape), "float32")
    want = TB.quantize(TB.dequantize(full), "mxsf", tb)
    assert torch.equal(got_c, want.codes)
    assert torch.equal(got_s, want.scale_e8m0)


@pytest.mark.parametrize("block_1d", [64, 32])
def test_kernel_dx_1d_operands_unchanged_by_the_transposed_write(
        monkeypatch, block_1d):
    """_kernel_dx_1d hands the fused matmul the requantizer's transposed
    output; those operands are bit for bit the ``.T.contiguous()`` copies
    of the plain re-blocked weight that it took before (plain path)."""
    from repro_torch.core import mx_dot as TD
    from repro_torch.core.policy import QuantPolicy
    policy = QuantPolicy(block_mode="1d", block_1d=block_1d, backend="cuda")
    w = torch.from_numpy(_edge((192, 100), seed=13))
    qtw = TB.quantize(w, "mxsf", (block_1d, 1))
    gm = torch.from_numpy(_rand((24, 100), seed=14))
    seen = []

    def fused(*args, **kw):
        seen.append((args, kw))
        return torch.zeros(())

    monkeypatch.setattr(TD.FM, "mxsf_fused_matmul", fused)
    TD._kernel_dx_1d(policy, qtw, gm)
    (g_arg, wc, ws, xblk, wblk), kw = seen[0]
    rc, rs = TQ.mxsf_requantize(qtw.codes, qtw.scale_e8m0, qtw.block,
                                (1, block_1d))
    assert g_arg is gm and (xblk, wblk) == ((1, block_1d), (block_1d, 1))
    assert kw == {"quantize_lhs": True}
    assert torch.equal(wc, rc.T.contiguous()) and wc.is_contiguous()
    assert torch.equal(ws, rs.T.contiguous()) and ws.is_contiguous()


# ---------------------------------------------------------------------------
# packed x packed matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xblk,wblk", [((8, 8), (8, 8)), ((1, 64), (64, 1)),
                                       ((1, 32), (32, 1))])
@pytest.mark.parametrize("m,k,n", [(24, 64, 40), (64, 192, 128)])
def test_mx_matmul_plain_matches_jax(jx, xblk, wblk, m, k, n):
    jnp = jx.jnp
    xq = jx.quantize(jnp.asarray(_rand((m, k), seed=m)), "mxsf", xblk)
    wq = jx.quantize(jnp.asarray(_rand((k, n), seed=n)), "mxsf", wblk)
    args = [xq.codes, xq.scale_e8m0, wq.codes, wq.scale_e8m0]
    got = TMM.mxsf_matmul(*(torch.from_numpy(np.array(a)) for a in args),
                          xblk, wblk)
    wants = [jx.ref.mxsf_matmul_ref(*args, xblk, wblk)]
    if (m, xblk) == (24, (8, 8)):
        wants.append(jx.ops.mxsf_matmul(*args, xblk=xblk, wblk=wblk))
    for want in wants:
        assert got.dtype == torch.float32
        assert tuple(got.shape) == tuple(np.shape(want))
        _close(got.numpy(), want)
    assert TMM.launches == 0


def test_mx_matmul_reuses_transposed_tiles(jx):
    """dx = g @ w^T on ``transpose_qt`` views, as the 2D backward calls it:
    the same values as the JAX package's transpose_qt."""
    jnp = jx.jnp
    g = _rand((40, 48), seed=1)   # (M, N)
    w = _rand((56, 48), seed=2)   # the forward's (K, N)
    gq = jx.quantize(jnp.asarray(g), "mxsf", (8, 8))
    wq = jx.quantize(jnp.asarray(w), "mxsf", (8, 8))
    wT = jx.B.transpose_qt(wq)
    want = jx.ref.mxsf_matmul_ref(gq.codes, gq.scale_e8m0, wT.codes,
                                  wT.scale_e8m0, (8, 8), (8, 8))
    tw = TB.QuantizedTensor(torch.from_numpy(np.array(wq.codes)),
                            torch.from_numpy(np.array(wq.scale_e8m0)), "mxsf",
                            (8, 8), tuple(wq.shape), "float32")
    twT = TB.transpose_qt(tw)
    assert twT.shape == tuple(wT.shape)
    got = TMM.mxsf_matmul(torch.from_numpy(np.array(gq.codes)),
                          torch.from_numpy(np.array(gq.scale_e8m0)), twT.codes,
                          twT.scale_e8m0, (8, 8), (8, 8))
    _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# fused matmul: the training switches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xblk,wblk", [((8, 8), (8, 8)), ((1, 64), (64, 1))])
@pytest.mark.parametrize("m,k,kp,n", [(37, 100, 128, 48), (16, 64, 64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_emit_codes_matches_jax(jx, xblk, wblk, m, k, kp, n, dtype):
    jnp = jx.jnp
    x = _edge((m, k), seed=m + k)
    x[3] = _rand((k,), seed=3)  # keep products finite against any weight
    x[2] = _rand((k,), seed=4)
    wq = jx.quantize(jnp.asarray(_rand((kp, n), seed=n)), "mxsf", wblk)
    xj = jnp.asarray(x).astype(dtype)
    got_y, got_c, got_s = TFM.mxsf_fused_matmul(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        torch.from_numpy(np.array(wq.codes)),
        torch.from_numpy(np.array(wq.scale_e8m0)), xblk, wblk,
        emit_codes=True)
    wants = [(jx.ref.mxsf_fused_matmul_ref(xj, wq.codes, wq.scale_e8m0,
                                           xblk, wblk, True),
              *jx.ref.mxsf_quantize_ref(xj, xblk))]
    if (m, dtype) == (37, "bfloat16"):
        wants.append(jx.ops.mxsf_fused_matmul(
            xj, wq.codes, wq.scale_e8m0, xblk, wblk, emit_codes=True))
    for want_y, want_c, want_s in wants:
        _close(got_y.numpy(), want_y)
        _same(got_c, want_c)
        _same(got_s, want_s)
    # the emitted residual is the quantizer's output on x
    qc, qs = TQ.mxsf_quantize(torch.from_numpy(x).to(getattr(torch, dtype)),
                              xblk)
    assert torch.equal(got_c, qc) and torch.equal(got_s, qs)
    assert TFM.launches == 0


@pytest.mark.parametrize("xblk,wblk", [((8, 8), (8, 8)), ((1, 64), (64, 1))])
@pytest.mark.parametrize("m,k,kp,n", [(37, 100, 128, 48), (64, 256, 256, 40)])
def test_fused_raw_lhs_matches_jax(jx, xblk, wblk, m, k, kp, n):
    """quantize_lhs=False: the backward's unquantized f32 g."""
    jnp = jx.jnp
    g = _rand((m, k), seed=11 + m)
    wq = jx.quantize(jnp.asarray(_rand((kp, n), seed=12)), "mxsf", wblk)
    got = TFM.mxsf_fused_matmul(torch.from_numpy(g),
                                torch.from_numpy(np.array(wq.codes)),
                                torch.from_numpy(np.array(wq.scale_e8m0)),
                                xblk, wblk, quantize_lhs=False)
    wants = [jx.ref.mxsf_fused_matmul_ref(jnp.asarray(g), wq.codes,
                                          wq.scale_e8m0, xblk, wblk, False)]
    if m == 37:
        wants.append(jx.ops.mxsf_fused_matmul(
            jnp.asarray(g), wq.codes, wq.scale_e8m0, xblk, wblk,
            quantize_lhs=False))
    for want in wants:
        _close(got.numpy(), want)


def test_fused_emit_requires_quantized_lhs():
    x = torch.zeros((8, 64))
    codes = torch.zeros((64, 8), dtype=torch.uint8)
    scales = torch.zeros((8, 1), dtype=torch.uint8)
    with pytest.raises(ValueError, match="emit_codes"):
        TFM.mxsf_fused_matmul(x, codes, scales, (8, 8), (8, 8),
                              quantize_lhs=False, emit_codes=True)


# ---------------------------------------------------------------------------
# on the card: each new CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _edge_with_subnormals(shape, seed):
    x = _edge(shape, seed)
    x[5, :] = _rand((shape[1],), seed=seed, sigma=0.5) * np.float32(1e-40)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_quantize_matches_plain(cuda_device, dtype):
    for shape in ((64, 128), (37, 100), (300, 6912 // 8)):
        x = torch.from_numpy(_edge_with_subnormals(shape, 1)).to(
            cuda_device, getattr(torch, dtype))
        for block in BLOCKS:
            got = TQ.mxsf_quantize(x, block)
            want = TQ.mxsf_quantize_plain(x, block)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]), (shape, block)
            assert torch.equal(got[1], want[1]), (shape, block)


@pytest.mark.gpu
def test_cuda_requantize_matches_plain(cuda_device):
    """Every tiled instance (both directions, B = 32 and 64) and the
    one-thread-per-block kernel, plain and transposed, on edge blocks and
    on grids that are neither 512 nor 16 codes wide."""
    pairs = list(TQ.REQUANT_TILED) + [((8, 8), (1, 8))]
    for shape in ((64, 128), (40, 100), (200, 1100), (96, 40)):
        x = torch.from_numpy(_edge_with_subnormals(shape, 2)).to(cuda_device)
        for fb, tb in pairs:
            qt = TB.quantize(x, "mxsf", fb)
            for transpose in (False, True):
                got = TQ.mxsf_requantize(qt.codes, qt.scale_e8m0, fb, tb,
                                         transpose=transpose)
                want = TQ.mxsf_requantize_plain(qt.codes, qt.scale_e8m0, fb,
                                                tb, transpose=transpose)
                torch.cuda.synchronize()
                case = (shape, fb, tb, transpose,
                        TQ.requantize_instance(fb, tb))
                assert torch.equal(got[0], want[0]), case
                assert torch.equal(got[1], want[1]), case


@pytest.mark.gpu
def test_cuda_reencode_table_matches_float_path(cuda_device):
    """The card's re-encode table against its float path on every (code,
    from-scale byte, block exponent) triple a block can hold."""
    tab, flt, fits = TQ.reencode_check()
    torch.cuda.synchronize()
    fits = fits.bool()
    assert int(fits.sum()) == 8583424
    assert int(((tab != flt) & fits).sum()) == 0


@pytest.mark.gpu
def test_cuda_mx_matmul_matches_plain(cuda_device):
    for (m, k, n), blk in (((200, 320, 1000), (8, 8)),
                           ((64, 64, 72), (8, 8)),
                           ((37, 128, 96), (1, 64))):
        wblk = blk if blk == (8, 8) else (64, 1)
        xq = TB.quantize(torch.from_numpy(_rand((m, k), 3)).to(cuda_device),
                         "mxsf", blk)
        wq = TB.quantize(torch.from_numpy(_rand((k, n), 4)).to(cuda_device),
                         "mxsf", wblk)
        args = (xq.codes, xq.scale_e8m0, wq.codes, wq.scale_e8m0, blk, wblk)
        got = TMM.mxsf_matmul(*args)
        want = TMM.mxsf_matmul_plain(*args)
        torch.cuda.synchronize()
        _close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_training_switches_match_plain(cuda_device, dtype):
    dt = getattr(torch, dtype)
    for m, k, kp, n in ((200, 100, 128, 96), (16, 64, 64, 64),
                        (3, 40, 64, 40)):
        x = torch.from_numpy(_rand((m, k), 5)).to(cuda_device, dt)
        for xblk, wblk in (((8, 8), (8, 8)), ((1, 64), (64, 1))):
            wq = TB.quantize(torch.from_numpy(_rand((kp, n), 6)).to(
                cuda_device), "mxsf", wblk)
            w = (wq.codes, wq.scale_e8m0)
            got = TFM.mxsf_fused_matmul(x, *w, xblk, wblk, emit_codes=True)
            want = TFM.mxsf_fused_matmul_plain(x, *w, xblk, wblk,
                                               emit_codes=True)
            raw = TFM.mxsf_fused_matmul(x, *w, xblk, wblk,
                                        quantize_lhs=False)
            raw_want = TFM.mxsf_fused_matmul_plain(x, *w, xblk, wblk,
                                                   quantize_lhs=False)
            torch.cuda.synchronize()
            _close(got[0].cpu().numpy(), want[0].cpu().numpy())
            assert torch.equal(got[1], want[1]) and torch.equal(got[2],
                                                                want[2])
            _close(raw.cpu().numpy(), raw_want.cpu().numpy())


def _exact_sum(shape, block, seed):
    """0, +-1/2, +-1, +-2 times 2^b, b alternating between neighbouring
    blocks: every partial sum of products is exact in f32 in any order
    (``chip_smoke.py``'s exact-sum operands), and MXSF holds the values
    exactly."""
    rng = np.random.default_rng(seed)
    vals = np.array([0.0, 0.5, -0.5, 1.0, -1.0, 2.0, -2.0], np.float32)
    x = vals[rng.integers(0, 7, size=shape)]
    bi = np.arange(shape[0])[:, None] // block[0]
    bj = np.arange(shape[1])[None, :] // block[1]
    return x * np.exp2((bi + bj) % 2).astype(np.float32)


@pytest.mark.gpu
def test_cuda_tensor_core_matmuls_exact_sum_bitwise(cuda_device):
    """On exact-sum operands the tensor-core kernels equal their plain
    versions bit for bit, whatever order they sum in: mx_matmul (every
    block shape it takes, ragged tiles) and the fused matmul's training
    switches (x prepared by producer blocks above 64 rows, quantized in
    each block at 64 rows or fewer)."""
    dev = cuda_device
    for (m, k, n), xblk, wblk in (((200, 1088, 264), (8, 8), (8, 8)),
                                  ((136, 640, 128), (1, 64), (64, 1)),
                                  ((64, 320, 96), (1, 32), (32, 1))):
        xq = TB.quantize(torch.from_numpy(_exact_sum((m, k), xblk, 1)).to(
            dev), "mxsf", xblk)
        wq = TB.quantize(torch.from_numpy(_exact_sum((k, n), wblk, 2)).to(
            dev), "mxsf", wblk)
        args = (xq.codes, xq.scale_e8m0, wq.codes, wq.scale_e8m0, xblk, wblk)
        assert torch.equal(TMM.mxsf_matmul(*args),
                           TMM.mxsf_matmul_plain(*args)), (m, k, n, xblk)
    for m, k, n in ((200, 1000, 264), (48, 640, 520)):
        for xblk, wblk in (((8, 8), (8, 8)), ((1, 64), (64, 1))):
            kp = -(-k // wblk[0]) * wblk[0]
            x = torch.from_numpy(_exact_sum((m, k), xblk, 3)).to(
                dev, torch.bfloat16)
            wq = TB.quantize(torch.from_numpy(_exact_sum((kp, n), wblk, 4)).to(
                dev), "mxsf", wblk)
            w = (wq.codes, wq.scale_e8m0)
            got = TFM.mxsf_fused_matmul(x, *w, xblk, wblk, emit_codes=True)
            want = TFM.mxsf_fused_matmul_plain(x, *w, xblk, wblk,
                                               emit_codes=True)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (m, k, n, xblk)


@pytest.mark.gpu
def test_cuda_tensor_core_matmuls_take_the_f32_path(cuda_device):
    """Edge blocks (zero, subnormal, 3e38 against 2^-100, S_e near -120)
    send their steps to the kernels' f32 path, which must have run and
    stay within the matmul tolerance; the codes stay bit for bit."""
    from repro_torch.kernels import common as C
    dev = cuda_device
    x = _edge((136, 256), 5)
    w = _rand((256, 192), 6)
    w[16:32] *= np.float32(2.0 ** -100)  # meets x's 3e38 block
    for xblk, wblk in (((8, 8), (8, 8)), ((1, 64), (64, 1))):
        xq = TB.quantize(torch.from_numpy(x).to(dev), "mxsf", xblk)
        wq = TB.quantize(torch.from_numpy(w).to(dev), "mxsf", wblk)
        args = (xq.codes, xq.scale_e8m0, wq.codes, wq.scale_e8m0, xblk, wblk)
        C.read_f32_steps("mxsf_matmul", reset=True)
        got = TMM.mxsf_matmul(*args)
        assert C.read_f32_steps("mxsf_matmul", reset=True) > 0
        _close(got.cpu().numpy(), TMM.mxsf_matmul_plain(*args).cpu().numpy())
        xt = torch.from_numpy(x).to(dev)
        C.read_f32_steps("mxsf_fused_matmul", reset=True)
        got = TFM.mxsf_fused_matmul(xt, wq.codes, wq.scale_e8m0, xblk, wblk,
                                    emit_codes=True)
        assert C.read_f32_steps("mxsf_fused_matmul", reset=True) > 0
        want = TFM.mxsf_fused_matmul_plain(xt, wq.codes, wq.scale_e8m0, xblk,
                                           wblk, emit_codes=True)
        for r in range(x.shape[0]):  # edge rows differ in scale by far
            _close(got[0][r].cpu().numpy(), want[0][r].cpu().numpy())
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
