"""The port's MX codec against the JAX package's, bitwise.

Inputs are made with numpy from a seed and handed to both packages.  Every
comparison here is on bit patterns (codes, E8M0 scales, and f32 values
viewed as uint32, so -0.0 and subnormals count), with no tolerance: the two
codecs run the same f32 steps in the same order.

Subnormals: XLA's CPU runtime treats subnormal f32 inputs as zero and
flushes subnormal results (denormals-are-zero; ``jnp.float32(1e-45) > 0``
is False there), while the port keeps IEEE subnormals as the reference
code intends (``kernels/common.flog2``) and as the CUDA kernels do.  So
subnormal values are checked against numpy (IEEE) or, for a whole block,
against the JAX package on the same block scaled by 2^64 into the normal
range: codes are scale-free and the E8M0 byte shifts by 64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocking as JB
from repro.core import formats as JF
from repro.kernels import common as JC
from repro_torch.core import blocking as TB
from repro_torch.core import formats as TF
from repro_torch.kernels import common as TC

torch.set_num_threads(2)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(_bits(t.numpy()), _bits(np.asarray(j)))


CODES = np.arange(256, dtype=np.uint8)


def test_all_256_mxsf_codes_decode_bitwise():
    t = TF.decode_rel(torch.from_numpy(CODES), TF.FORMATS["mxsf"])
    _same(t, JF.decode_rel(jnp.asarray(CODES), JF.FORMATS["mxsf"]))
    _same(TC.decode_mxsf(torch.from_numpy(CODES)),
          JC.decode_mxsf(jnp.asarray(CODES)))
    _same(t, JC.decode_mxsf(jnp.asarray(CODES)))


def _relative_values(seed: int = 0) -> np.ndarray:
    """Every decoded MXSF value, the midpoints between neighbours (RNE
    ties), random values in (-2, 2), subnormals, zeros and -0.0."""
    rng = np.random.default_rng(seed)
    dec = np.asarray(JF.decode_rel(jnp.asarray(CODES), JF.FORMATS["mxsf"]))
    pos = np.unique(np.abs(dec))
    mids = (pos[1:] + pos[:-1]) / 2
    sub = np.array([1e-45, 1e-40, 2.0 ** -130, 2.0 ** -126], np.float32)
    vals = np.concatenate([dec, mids, -mids, rng.uniform(-2, 2, 4000),
                           sub, -sub, [0.0, -0.0, 1.9999, -1.9999]])
    return vals.astype(np.float32)


def test_relative_encode_bitwise():
    xa = _relative_values()
    t = torch.from_numpy(xa)
    j = jnp.asarray(xa)
    _same(TF.encode_rel(t, TF.FORMATS["mxsf"]),
          JF.encode_rel(j, JF.FORMATS["mxsf"]))
    _same(TC.encode_mxsf(t), JC.encode_mxsf(j))


def _np_exp2i(e):
    e = np.clip(e, -126, 127).astype(np.int32)
    return ((e + 127) << 23).astype(np.int32).view(np.float32)


@pytest.mark.parametrize("fn", ["flog2", "exp2i", "scale_by_exp2", "rne"])
def test_plain_kernel_helpers_bitwise(fn):
    rng = np.random.default_rng(1)
    if fn == "flog2":
        x = np.abs(np.concatenate([_relative_values(), rng.standard_normal(
            500) * 1e30, [3e38, 0.0]])).astype(np.float32)
        normal = (x == 0) | (x >= 2.0 ** -126)
        _same(TC.flog2(torch.from_numpy(x[normal])),
              JC.flog2(jnp.asarray(x[normal])))
        sub = x[~normal]
        assert sub.size  # subnormals against exact IEEE floor(log2)
        expect = np.frexp(sub.astype(np.float64))[1] - 1
        np.testing.assert_array_equal(TC.flog2(torch.from_numpy(sub)).numpy(),
                                      expect)
    elif fn == "exp2i":
        e = np.arange(-140, 140, dtype=np.int32)
        _same(TC.exp2i(torch.from_numpy(e)), JC.exp2i(jnp.asarray(e)))
    elif fn == "scale_by_exp2":
        x = (rng.standard_normal(560) * 1e3).astype(np.float32)
        e = np.arange(-280, 280, dtype=np.int32) % 505 - 252
        got = TC.scale_by_exp2(torch.from_numpy(x), torch.from_numpy(e))
        e1 = np.floor_divide(e, 2)
        with np.errstate(over="ignore", under="ignore"):
            expect = x * _np_exp2i(e1) * _np_exp2i(e - e1)  # IEEE f32
        _same(got, expect)
        normal = (np.abs(expect) >= 2.0 ** -126) & np.isfinite(expect)
        _same(got[torch.from_numpy(normal)],
              np.asarray(JC.scale_by_exp2(jnp.asarray(x),
                                          jnp.asarray(e)))[normal])
    else:
        x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.49, 1e7 + 0.5],
                     np.float32)
        _same(TC.rne(torch.from_numpy(x)), JC.rne(jnp.asarray(x)))


def _block_input(case: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if case == "wide":      # block scales from 2^-140 to 2^127
        e = rng.integers(-140, 127, size=shape)
        x = (x * np.exp2(e.astype(np.float64))).astype(np.float32)
    elif case == "zeros":   # whole zero blocks, -0.0 entries
        x[: shape[0] // 2] = 0.0
        x[-1, ::3] = -0.0
    elif case == "subnormal":
        x = (x * 1e-40).astype(np.float32)
    elif case == "extreme":  # +-3e38 next to tiny values: S_e near +-127
        x[::2, ::5] = 3e38
        x[1::2, ::7] = -3e38
        x[::3, 1::4] = 1e-38
    return x


CASES = ["normal", "wide", "zeros", "subnormal", "extreme"]
BLOCKS = [(64,), (1, 64), (64, 1), (8, 8)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("block", BLOCKS, ids=lambda b: "x".join(map(str, b)))
def test_quantize_codes_and_scales_bitwise(case, block):
    x = _block_input(case, (37, 150),
                     seed=10 * CASES.index(case) + BLOCKS.index(block))
    qt = TB.quantize(torch.from_numpy(x), "mxsf", block)
    assert qt.shape == (37, 150) and qt.block == tuple(block)
    if case == "subnormal":  # see the module docstring
        qj = JB.quantize(jnp.asarray(x * np.float32(2.0 ** 64)), "mxsf",
                         block)
        _same(qt.codes, qj.codes)
        expect = np.clip(np.asarray(qj.scale_e8m0).astype(np.int32) - 64,
                         0, 255).astype(np.uint8)
        _same(qt.scale_e8m0, expect)
        return
    qj = JB.quantize(jnp.asarray(x), "mxsf", block)
    _same(qt.codes, qj.codes)
    _same(qt.scale_e8m0, qj.scale_e8m0)
    _same(TB.dequantize(qt), JB.dequantize(qj))


@pytest.mark.parametrize("case", [c for c in CASES if c != "subnormal"])
def test_qdq_bitwise(case):
    x = _block_input(case, (9, 130), seed=7)
    _same(TB.qdq(torch.from_numpy(x), "mxsf", (64,)),
          JB.qdq(jnp.asarray(x), "mxsf", (64,)))


@pytest.mark.parametrize("fmt", ["mxint8", "mxfp8_e4m3", "mxfp8_e5m2",
                                 "mxfp6_e2m3", "mxfp4_e2m1", "boost"])
def test_other_formats_bitwise(fmt):
    x = _block_input("wide", (12, 96), seed=3)
    qt = TB.quantize(torch.from_numpy(x), fmt, (32,))
    qj = JB.quantize(jnp.asarray(x), fmt, (32,))
    _same(qt.codes, qj.codes)
    _same(qt.scale_e8m0, qj.scale_e8m0)
    _same(TB.dequantize(qt), JB.dequantize(qj))
    _same(TB.qdq(torch.from_numpy(x), fmt, (32,)),
          JB.qdq(jnp.asarray(x), fmt, (32,)))


def test_bf16_input_and_packed_bytes():
    x = _block_input("normal", (16, 128), seed=5)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    qt, qj = TB.quantize(xt, "mxsf", (64, 1)), JB.quantize(xj, "mxsf", (64, 1))
    _same(qt.codes, qj.codes)
    assert qt.dtype == str(qj.dtype) == "bfloat16"
    assert qt.nbytes_packed() == qj.nbytes_packed()


@pytest.mark.parametrize("block", [(64, 1), (8, 8), (64,)],
                         ids=lambda b: "x".join(map(str, b)))
def test_large_leaves_code_in_slices_bitwise(monkeypatch, block):
    """Big leaves are coded in slices of whole blocks along the last dim;
    the bytes are those of one pass (and of the JAX package)."""
    x = _block_input("wide", (70, 203), seed=21)
    monkeypatch.setattr(TB, "CHUNK_ELEMENTS", 1000)
    qt = TB.quantize(torch.from_numpy(x), "mxsf", block)
    qj = JB.quantize(jnp.asarray(x), "mxsf", block)
    _same(qt.codes, qj.codes)
    _same(qt.scale_e8m0, qj.scale_e8m0)
    _same(TB.dequantize(qt), JB.dequantize(qj))
