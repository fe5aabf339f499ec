"""The launch plans of the redesigned attention and quantizer kernels, on
the CPU (no card).

* ``attention_plan``: row tiles of the GQA group, key splits and scratch at
  the smoke shapes and at ragged ones.
* The attention kernel's algorithm -- rows of a kv head's GQA group in one
  block, keys cut into splits of whole tiles, the online softmax over each
  split's tiles, partials merged in split order with empty splits skipped
  -- emulated in plain torch and held against the JAX package's attention
  (Pallas in interpret mode).  Tolerance: rtol 1e-5 with atol 1e-5 of the
  largest output, as in ``test_torch_kernels.py``: both sides sum f32
  products in different orders and take exp() of different maxima.
* The plans' constants are the CUDA sources'.
* The quantizer's tiles cover every element of the block-padded operand
  exactly once, and every MX block lies in one amax group (one thread,
  the lanes of one shuffle group, or one block's column).
"""
import math
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import blocking as TB
from repro_torch.kernels import common as C
from repro_torch.kernels import mxsf_attention as TA
from repro_torch.kernels import mxsf_quant as TQ

torch.set_num_threads(2)
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import blocking
    from repro.kernels import ops
    return types.SimpleNamespace(jnp=jnp, B=blocking, ops=ops)


# ---------------------------------------------------------------------------
# attention_plan
# ---------------------------------------------------------------------------

# (batch, kv, g, S, L, dh): the smoke shapes (qwen2.5-32b decode and
# 16-token prefill at slots=4, L=512), then ragged and large ones
PLAN_SHAPES = [(4, 8, 5, 1, 512, 128), (4, 8, 5, 16, 512, 128),
               (2, 2, 1, 7, 24, 16), (3, 8, 5, 7, 100, 128),
               (1, 8, 4, 64, 4096, 80), (1, 1, 8, 16, 40000, 64),
               (64, 8, 5, 1, 2048, 128), (2, 4, 3, 33, 1, 96)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_attention_plan(shape):
    batch, kv, g, S, L, dh = shape
    p = TA.attention_plan(*shape)
    m = g * S
    assert p["mt"] % 16 == 0 and 16 <= p["mt"] <= TA.MAX_ROWS
    if m <= TA.MAX_ROWS:  # the whole group in one row tile, 16-row padded
        assert p["m_tiles"] == 1 and p["mt"] == 16 * -(-m // 16)
    else:
        assert p["mt"] == TA.MAX_ROWS
    assert p["mt"] * (p["m_tiles"] - 1) < m <= p["mt"] * p["m_tiles"]
    assert p["groups"] == batch * kv * p["m_tiles"]
    # whole tiles per split, every tile in exactly one split
    assert p["tiles"] == max(1, -(-L // TA.KEY_TILE))
    assert p["per"] * (p["splits"] - 1) < p["tiles"] <= p["per"] * p["splits"]
    assert 1 <= p["splits"] <= TA.MAX_SPLITS
    assert p["ctas"] == p["groups"] * p["splits"]
    if p["mt"] >= TA.ONE_WAVE_ROWS:  # tall row tiles: one wave at most
        assert p["ctas"] <= max(C.N_SMS, p["groups"])
        if p["groups"] * 2 <= C.N_SMS and p["tiles"] >= 2:
            assert p["splits"] >= 2
    else:  # two waves where the keys allow
        want = -(-TA.MIN_CTAS // p["groups"])
        if want <= TA.MAX_SPLITS // 2 and (p["groups"] * p["tiles"]
                                           >= TA.MIN_CTAS):
            assert p["ctas"] >= TA.MIN_CTAS
        if p["groups"] >= TA.MIN_CTAS:
            assert p["splits"] == 1
    if p["splits"] > 1:
        assert p["workspace"] == p["groups"] * p["splits"] * p["mt"] * (
            dh + 2)
        assert p["counters"] == p["groups"]
    else:
        assert p["workspace"] == 0 and p["counters"] == 0


def test_attention_plan_at_the_smoke_shapes():
    for S, mt, splits, per in ((1, 16, 8, 1), (16, 80, 4, 2)):
        p = TA.attention_plan(4, 8, 5, S, 512, 128)
        assert (p["mt"], p["m_tiles"], p["splits"], p["per"], p["ctas"]) == (
            mt, 1, splits, per, 32 * splits)


# ---------------------------------------------------------------------------
# the kernel's split-and-merge, emulated
# ---------------------------------------------------------------------------

def _decode(codes, scales):
    return TB.dequantize(TB.QuantizedTensor(
        codes, scales, "mxsf", (codes.shape[-1],), tuple(codes.shape),
        "float32"))


def emulate(q, kc, ks, vc, vs, kvl, off, win, *, tile, per, causal=True):
    """The CUDA kernel's algorithm in plain torch: per (slot, kv head) the
    g * S rows (row r = head r // S, query r % S); the keys any row sees
    (the union of the rows' ranges); splits of ``per`` tiles of ``tile``
    keys; per split an online softmax over its tiles from (m, l, acc) =
    (-1e30, 0, 0); the splits merged in order, those with l = 0 skipped.
    Returns (out, number of (group, split) blocks with no visible key)."""
    BH, S, dh = q.shape
    Bc, L, KV, _ = kc.shape
    h = BH // Bc
    g = h // KV
    kd, vd = _decode(kc, ks), _decode(vc, vs)
    tiles = max(1, -(-L // tile))
    splits = -(-tiles // per)
    out = torch.zeros(BH, S, dh)
    empty = 0
    for b in range(Bc):
        for kvh in range(KV):
            bh = torch.tensor([b * h + kvh * g + r // S for r in range(g * S)])
            s_of = torch.tensor([r % S for r in range(g * S)])
            pos = off[bh].long() + s_of
            lo = torch.clamp(pos - win[bh].long() + 1, min=0)
            hi = torch.minimum(kvl[bh].long().clamp(max=L), pos + 1) \
                if causal else kvl[bh].long().clamp(max=L)
            seen = hi > lo
            ulo = int(lo[seen].min()) if seen.any() else L + tile
            uhi = int(hi[seen].max()) if seen.any() else 0
            Q = q[bh, s_of].float()
            parts = []
            for sp in range(splits):
                k0 = sp * per * tile
                k1 = min(L, k0 + per * tile)
                t_lo, t_hi = max(k0, ulo // tile * tile), min(k1, uhi)
                m = torch.full((g * S,), -1e30)
                l = torch.zeros(g * S)
                acc = torch.zeros(g * S, dh)
                if t_lo >= t_hi:
                    empty += 1
                for j0 in range(t_lo, t_hi, tile):
                    keys = torch.arange(j0, j0 + tile)
                    ok = (keys < L) & (keys >= ulo) & (keys < uhi)
                    kk = keys.clamp(max=L - 1)
                    K = torch.where(ok[:, None], kd[b, kk, kvh], 0.0)
                    V = torch.where(ok[:, None], vd[b, kk, kvh], 0.0)
                    s = (Q @ K.T) / math.sqrt(dh)
                    vis = (keys[None] >= lo[:, None]) & (keys[None] < hi[:, None])
                    s = torch.where(vis, s, torch.full_like(s, -1e30))
                    m_new = torch.maximum(m, s.amax(1))
                    p = torch.where(vis, torch.exp(s - m_new[:, None]), 0.0)
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + p @ V
                    m = m_new
                parts.append((m, l, acc))
            mx = torch.full((g * S,), -1e30)
            for m, l, _ in parts:
                mx = torch.where(l > 0, torch.maximum(mx, m), mx)
            tot_l = torch.zeros(g * S)
            tot = torch.zeros(g * S, dh)
            for m, l, acc in parts:  # in split order
                w = torch.where(l > 0, torch.exp(m - mx), 0.0)
                tot_l = tot_l + w * l
                tot = tot + torch.where(l[:, None] > 0, w[:, None] * acc, 0.0)
            out[bh, s_of] = tot / torch.clamp(tot_l, min=1e-30)[:, None]
    return out, empty


def _cache(jx, Bsz, L, kv, dh, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        val = rng.standard_normal((Bsz, L, kv, dh)).astype(np.float32)
        qt = jx.B.quantize(jx.jnp.asarray(val), "mxsf", (dh,))
        out += [np.array(qt.codes), np.array(qt.scale_e8m0)]
    return out  # k_codes, k_scales, v_codes, v_scales


@pytest.mark.parametrize("g", [1, 5])
@pytest.mark.parametrize("S", [1, 7])
@pytest.mark.parametrize("window", [None, 5])
def test_split_and_merge_matches_jax(jx, g, S, window):
    Bsz, L, kv, dh = 2, 24, 2, 16
    h = kv * g
    BH = Bsz * h
    rng = np.random.default_rng(100 * g + 10 * S + (window or 0))
    cache = _cache(jx, Bsz, L, kv, dh, seed=g + S)
    kvl = rng.integers(S, L + 1, size=BH).astype(np.int32)
    kvl[:h] = rng.integers(S, 9)  # slot 0: short, so late splits are empty
    kvl[1] = 0                    # a row with no visible key
    off = np.maximum(kvl - S, 0).astype(np.int32)
    win = np.full(BH, TA.NO_WINDOW if window is None else window, np.int32)
    q = rng.standard_normal((BH, S, dh)).astype(np.float32)
    jnp = jx.jnp
    want = np.asarray(jx.ops.mxsf_attention(
        jnp.asarray(q), *map(jnp.asarray, cache), causal=True,
        kv_len=jnp.asarray(kvl), q_offset=jnp.asarray(off),
        window=None if window is None else jnp.asarray(win), ck=8))
    tq = [torch.from_numpy(a) for a in (q, *cache, kvl, off, win)]
    for tile, per in ((4, 1), (4, 2), (8, 2)):
        got, empty = emulate(*tq, tile=tile, per=per)
        atol = 1e-5 * float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)
        assert empty > 0  # splits with no visible key were merged
        assert not got[1].any()  # kv_len = 0: zero
    # the plain version agrees with the same inputs
    plain = TA.mxsf_attention(tq[0], *tq[1:5], causal=True, kv_len=tq[5],
                              q_offset=tq[6], window=tq[7])
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# constants against the CUDA sources
# ---------------------------------------------------------------------------

def _const(src, name):
    m = re.search(rf"constexpr int {name} = (-?\d+);", src)
    assert m, name
    return int(m.group(1))


def test_attention_and_quantizer_constants_match_the_cuda_source():
    src = (CSRC / "mxsf_attention.cu").read_text()
    assert _const(src, "kKT") == TA.KEY_TILE
    assert _const(src, "kMaxMT") == TA.MAX_ROWS
    assert _const(src, "kMaxSplits") == TA.MAX_SPLITS
    assert _const(src, "kMinCtas") == TA.MIN_CTAS
    assert _const(src, "kOneWaveRows") == TA.ONE_WAVE_ROWS
    assert "constexpr int kNoWindow = 1 << 30;" in src
    assert TA.NO_WINDOW == 1 << 30
    # an instance for every row tile the plan can pick
    inst = {int(v) for v in re.findall(r"if \(mt == (\d+)\) return launch",
                                       src)}
    if re.search(r"if \(mt == kMaxMT\) return launch", src):
        inst.add(TA.MAX_ROWS)
    assert inst == set(range(16, TA.MAX_ROWS + 1, 16))
    quant = (CSRC / "mxsf_quant.cu").read_text()
    for (bm, bk) in TQ.TILED:
        assert (f"if (bm == {bm} && bk == {bk})\n    return launch_tiled<"
                f"{bm}, {bk}>") in quant
    m = re.search(r"constexpr int RPT = BM == 1 \? (\d+) : (\d+);", quant)
    assert m and {(1, 64): int(m.group(1)), (8, 8): int(m.group(2)),
                  (64, 1): int(m.group(2))} == TQ.ROWS_PER_THREAD
    assert "constexpr int V = 16 / ES;" in quant and TQ.PIECE_BYTES == 16
    assert TQ.quantize_instance((1, 32)) == "one thread per block"


# ---------------------------------------------------------------------------
# the quantizer's tiles
# ---------------------------------------------------------------------------

def _tile_elements(plan):
    """(row, col, amax group) of every element every thread of the grid
    holds, as the kernel maps them (numpy)."""
    gx, gy = plan["grid"]
    v, rpt = plan["v"], plan["rpt"]
    bx, by, w, lane, i, j = np.meshgrid(
        np.arange(gx), np.arange(gy), np.arange(8), np.arange(32),
        np.arange(rpt), np.arange(v), indexing="ij", sparse=True)
    r = by * plan["rows"] + rpt * w + i
    c = bx * plan["cols"] + v * lane + j
    return r, c, (bx, by, w, lane, i, j)


@pytest.mark.parametrize("block", sorted(TQ.TILED))
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", [(37, 100), (64, 128), (2048, 2560)])
def test_quantizer_tiles_cover_every_element_once(block, itemsize, shape):
    plan = TQ.tile_plan(*shape, block, itemsize)
    bm, bk = block
    mb, kb = plan["mb"], plan["kb"]
    assert (mb % bm, kb % bk) == (0, 0) and mb >= shape[0] and kb >= shape[1]
    r, c, (bx, by, w, lane, i, j) = _tile_elements(plan)
    r, c = np.broadcast_arrays(r, c)
    keep = (r < mb) & (c < kb)
    count = np.bincount((r[keep] * kb + c[keep]).ravel(),
                        minlength=mb * kb)
    assert (count == 1).all()
    # the amax group of each element: (1,64) a row of a shuffle group of
    # 64 / v lanes, (8,8) one thread (or a lane pair for f32), (64,1) a
    # column of one block of threads
    v = plan["v"]
    if block == (1, 64):
        grp = (bx, by, w, lane // (64 // v), i)
    elif block == (8, 8):
        grp = (bx, by, w, lane // (8 // v))
    else:
        grp = (bx, by, lane, j)
    gid = np.zeros(r.shape, np.int64)
    for part in grp:
        gid = gid * (int(np.max(part)) + 1) + np.broadcast_to(part, r.shape)
    gid, r, c = gid[keep], r[keep], c[keep]
    blk = (r // bm) * (kb // bk) + c // bk
    # every element of a block in its first element's group, and as many
    # groups as blocks: one group per block and one block per group
    first = (r % bm == 0) & (c % bk == 0)
    rep = np.full((mb // bm) * (kb // bk), -1, np.int64)
    rep[blk[first]] = gid[first]
    assert (rep >= 0).all() and (gid == rep[blk]).all()
    assert np.count_nonzero(np.bincount(gid)) == len(rep)
