"""The tensor-core matmul engine's plain-Python side (no card, no JAX).

The CUDA engine (``csrc/mxsf_mma.cuh``) runs a K step on the tensor cores
only where a predicate on the blocks' shared exponents holds, and splits K
across blocks by a plan the wrapper computes.  These tests pin both down on
the CPU:

* the predicate is sound, exhaustively: every decoded value it admits is a
  normal bf16, and every product of two admitted values is exact and normal
  in f32, so bf16 x bf16 -> f32 products equal the plain version's;
* its constants, and the wrappers' tiles, are the ones in the CUDA source;
* the exact-sum operands of ``chip_smoke.py``'s matmul gates give the same
  bits under any summation order, as that gate assumes (and random
  operands do not, which is why the gate needs them);
* the launch plan at every shape of the kernel table.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import common as C
from repro_torch.kernels import mx_matmul as MM
from repro_torch.kernels import mxsf_fused_matmul as FM

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
F32_MAX = float(np.finfo(np.float32).max)


def _admitted_bytes():
    return [s for s in range(256) if C.tc_scale_ok(s)]


def test_predicate_admits_only_exact_normal_bf16_values():
    codes = torch.arange(256)
    rel = C.decode_mxsf(codes)                       # (256,)
    s = torch.arange(256)
    vals = rel[:, None] * C.exp2i(s - C.SCALE_BIAS)[None, :]  # (256, 256)
    ok = torch.tensor([C.tc_scale_ok(int(b)) for b in s])
    adm = vals[:, ok]
    assert adm.shape[1] == C.TC_MAX_EXP - C.TC_MIN_EXP + 1
    assert torch.equal(adm.to(torch.bfloat16).float(), adm)
    nz = adm[adm != 0].abs()
    assert float(nz.min()) >= 2.0 ** -126           # normal, not subnormal
    assert bool(torch.isfinite(adm).all())
    # zero codes decode to zero under any scale (the blocks that carry
    # scale byte 0 need no admission)
    zero = vals[(codes & 0x7F) == 0]
    assert bool((zero == 0).all())


def test_predicate_admits_only_exact_normal_f32_products():
    rel = C.decode_mxsf(torch.arange(256)).double()
    table = (rel[:, None] * rel[None, :]).abs()
    pmin, pmax = float(table[table > 0].min()), float(table.max())
    # the relative products are exact in f32 (at most 12 significant bits)
    assert torch.equal(table.float().double(), table)
    exps = [b - C.SCALE_BIAS for b in _admitted_bytes()]
    lo, hi = min(exps), max(exps)
    for ex in exps:
        for ew in exps:
            e = 2.0 ** (ex + ew)
            assert pmin * e >= 2.0 ** -126 and pmax * e <= F32_MAX
    # the range is tight at the bottom: one exponent lower would make
    # the smallest product subnormal
    assert pmin * 2.0 ** (2 * lo) == 2.0 ** -126
    assert pmin * 2.0 ** (2 * (lo - 1)) < 2.0 ** -126
    assert pmax * 2.0 ** (2 * hi) < 2.0 ** 128


def _cu(name):
    return (CSRC / name).read_text()


def _const(src, name):
    m = re.search(rf"constexpr int {name} = (-?\d+);", src)
    assert m, name
    return int(m.group(1))


def test_predicate_and_plan_constants_match_the_cuda_source():
    src = _cu("mxsf_mma.cuh")
    assert _const(src, "kTcMinExp") == C.TC_MIN_EXP
    assert _const(src, "kTcMaxExp") == C.TC_MAX_EXP
    assert _const(src, "kMinCtas") == C.MIN_CTAS
    assert _const(src, "kBK") == C.K_STEP
    mm = _cu("mx_matmul.cu")
    m = re.search(r"constexpr int kBM = (\d+), kBN = (\d+);", mm)
    assert (int(m.group(1)), int(m.group(2))) == MM.TILE
    for (xb, wb) in MM.BLOCKS:
        assert (f"xbm == {xb[0]} && xbk == {xb[1]} && wbm == {wb[0]} && "
                f"wbn == {wb[1]}") in mm
    fused = _cu("mxsf_fused_matmul.cu")
    inst = set(re.findall(r"if \(xmode == (\d) && !?wb8 && bm == (\d+) && "
                          r"bn == (\d+)\)", fused))
    for xmode, ms in ((0, (1, 64, 2048)), (1, (1, 16, 17, 64, 2048)),
                      (2, (8, 64, 2048))):
        for m_ in ms:
            bm, bn = FM.tile(xmode, m_)
            assert (str(xmode), str(bm), str(bn)) in inst, (xmode, m_)


def _exact_sum_np(shape, block, rng):
    """numpy twin of chip_smoke._exact_sum_values: 0, +-1/2, +-1, +-2
    times 2^b, b alternating by block in a checkerboard."""
    vals = np.array([0.0, 0.5, -0.5, 1.0, -1.0, 2.0, -2.0], np.float32)
    x = vals[rng.integers(0, 7, size=shape)]
    bi = np.arange(shape[0])[:, None] // block[0]
    bj = np.arange(shape[1])[None, :] // block[1]
    return x * np.exp2((bi + bj) % 2).astype(np.float32)


def _serial(x, w):
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k in range(x.shape[1]):
        acc += x[:, k, None] * w[k][None, :]
    return acc


def _stepped(x, w, step=64, chunk=16):
    """The engine's grouping: per 64-k step a zeroed fragment summed in
    16-k chunks (each chunk pairwise, as a tensor core may), then one f32
    add into the accumulator."""
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, x.shape[1], step):
        frag = np.zeros_like(acc)
        for c0 in range(k0, min(k0 + step, x.shape[1]), chunk):
            p = x[:, c0:c0 + chunk, None] * w[None, c0:c0 + chunk, :]
            while p.shape[1] > 1:
                if p.shape[1] % 2:
                    p = np.concatenate([p, np.zeros_like(p[:, :1])], 1)
                p = p[:, 0::2] + p[:, 1::2]
            frag = frag + p[:, 0]
        acc = acc + frag
    return acc


@pytest.mark.parametrize("k", [6912, 32768])
def test_exact_sum_operands_give_the_same_bits_in_any_order(k):
    rng = np.random.default_rng(k)
    x = _exact_sum_np((4, k), (8, 8), rng)
    w = _exact_sum_np((k, 8), (8, 8), rng)
    ref = (x.astype(np.float64) @ w.astype(np.float64)).astype(np.float32)
    for got in (torch.matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                _serial(x, w), _stepped(x, w), _serial(x[:, ::-1],
                                                       w[::-1])):
        np.testing.assert_array_equal(got, ref)
    # random operands do not: the order shows in the last bits
    xr = rng.standard_normal((4, k)).astype(np.float32)
    wr = rng.standard_normal((k, 8)).astype(np.float32)
    assert not np.array_equal(_serial(xr, wr), _stepped(xr, wr))


def _table_shapes():
    """(name, m, kp, n, tile) of every matmul call in the kernel table."""
    serving = [(5120, 5120), (5120, 1024), (5120, 27648), (27648, 5120),
               (5120, 153600)]
    out = [(f"fused serving M={m}", m, k, n, FM.tile(1, m))
           for m in (4, 64) for k, n in serving]
    out += [("fused (8,8) emit", 2048, 2560, 6912, FM.tile(2, 2048)),
            ("fused (1,64) emit", 2048, 2560, 6912, FM.tile(1, 2048)),
            ("fused raw g", 2048, 6912, 2560, FM.tile(0, 2048)),
            ("mx_matmul dx", 2048, 6912, 2560, MM.TILE),
            ("mx_matmul dw", 2560, 2048, 6912, MM.TILE)]
    return out


def _prep(name, m):
    """K steps per producer block of the prepared-A launches (every
    mx_matmul, and the fused kernel's on a quantized x of more than 64
    rows), else 0."""
    if name.startswith("mx_matmul"):
        return MM.PREP_STEPS
    if "raw" not in name and FM.prepared(2 if "(8,8)" in name else 1, m):
        return FM.PREP_STEPS
    return 0


@pytest.mark.parametrize("name,m,kp,n,tile", _table_shapes(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_plan_at_table_shapes(name, m, kp, n, tile):
    prep = _prep(name, m)
    p = C.mma_plan(m, kp, n, *tile, prep=prep)
    tiles = p["m_tiles"] * p["n_tiles"]
    assert p["m_tiles"] * tile[0] >= m > (p["m_tiles"] - 1) * tile[0]
    assert p["n_tiles"] * tile[1] >= n > (p["n_tiles"] - 1) * tile[1]
    assert p["steps"] == -(-kp // C.K_STEP)
    # whole K steps per split, every step in exactly one split
    assert p["per"] * (p["splits"] - 1) < p["steps"] <= p["per"] * p["splits"]
    assert p["ctas"] == tiles * p["splits"] + p["producers"]
    assert (p["workspace"] > 0) == (p["splits"] > 1)
    if prep:  # one producer per `prep` steps of a split of a row tile;
        # K split only to fill the last wave of output tiles, <= 4 ways
        assert p["producers"] == p["m_tiles"] * p["splits"] * -(
            -p["per"] // prep)
        assert p["prep_bytes"] == p["m_tiles"] * p["steps"] * tile[0] * 128
        assert p["ready"] == p["m_tiles"] * p["steps"]
        assert 1 <= p["splits"] <= 4
    elif tiles * p["steps"] < C.MIN_CTAS:  # too few for 264 blocks
        assert p["per"] == 1
    if tiles * p["steps"] >= C.MIN_CTAS:
        assert p["ctas"] >= C.MIN_CTAS
    if p["splits"] > 1:
        assert prep or tiles < C.MIN_CTAS
        assert p["workspace"] == p["splits"] * m * n
        assert p["counters"] == tiles
    else:
        assert p["workspace"] == 0 and p["counters"] == 0
    assert p["m_tiles"] <= 65535 and p["splits"] <= 65535


def _encode_fast(xa: torch.Tensor) -> torch.Tensor:
    """Plain twin of the converter's encode_mxsf_fast (csrc/mxsf_mma.cuh):
    RNE on the f32 bits instead of rint(a / step)."""
    bits = xa.float().view(torch.int32).long() & 0xFFFFFFFF
    ab = bits & 0x7FFFFFFF
    r5 = ab + 0x1FFFF + ((ab >> 18) & 1)
    e5 = (r5 >> 23) - 127
    c25 = torch.where(e5 > 0, torch.full_like(e5, 0x7F),
                      ((e5 + 3) << 5) | ((r5 >> 18) & 31))
    r2 = ab + 0xFFFFF + ((ab >> 21) & 1)
    e2 = (r2 >> 23) - 127
    c32 = torch.where(e2 >= -2, torch.full_like(e2, 0x20),
                      ((e2 + 10) << 2) | ((r2 >> 21) & 3))
    a = (ab.to(torch.int32)).view(torch.float32)
    q = torch.round(a * 2048.0)
    csub = torch.where(q >= 4, torch.full_like(q, 4.0), q).long()
    code = torch.where(ab >= 0x3E800000, c25,
                       torch.where(ab >= 0x3B000000, c32, csub))
    return (code | ((bits >> 31) << 7)).to(torch.uint8)


def test_fast_encoder_matches_the_reference_encoder():
    """Every bf16 in (-2, 2), random f32 bit patterns below 2 and every
    rounding midpoint of each regime (and one f32 ulp either side)."""
    bf = torch.arange(0, 0x4000, dtype=torch.int32).to(torch.int16)
    vals = [bf.view(torch.bfloat16).float()]
    g = torch.Generator().manual_seed(0)
    vals.append(torch.randint(0, 0x40000000, (1 << 20,), generator=g,
                              dtype=torch.int32).view(torch.float32))
    ties = ([(q + 0.5) * 2.0 ** (e - 5) for e in (-2, -1, 0)
             for q in range(32, 64)]
            + [(q + 0.5) * 2.0 ** (e - 2) for e in range(-9, -2)
               for q in range(4, 8)]
            + [(q + 0.5) * 2.0 ** -11 for q in range(4)])
    t = torch.tensor(ties, dtype=torch.float32)
    nxt = lambda v, d: torch.nextafter(v, torch.full_like(v, d))
    vals += [t, nxt(t, 0.0), nxt(t, 2.0), torch.tensor([0.0, 1e-45, 2.0 ** -126])]
    x = torch.cat(vals)
    x = torch.cat([x, -x])
    assert torch.equal(_encode_fast(x), C.encode_mxsf(x))


def test_cp_width_takes_the_widest_aligned_copy():
    t = torch.empty(64, dtype=torch.uint8)
    base = t.data_ptr() % 16 == 0
    if base:
        assert C.cp_width(t, 2560) == 16
        assert C.cp_width(t, 200) == 8
        assert C.cp_width(t, 100) == 4
    with pytest.raises(ValueError):
        C.cp_width(t, 6)
