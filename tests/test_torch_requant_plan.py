"""The tiled requantizer's plan, on the CPU (no card).

* The index maths of ``csrc/mxsf_quant.cu::requantize_tiled``, emulated in
  numpy, write every output code and every output scale exactly once, in
  both directions ((B,1)->(1,B) and (1,B)->(B,1)), for B in {32, 64}, for
  the plain and the transposed write, on aligned and ragged grids: the
  persistent blocks' walk over the tiles, the threads' pieces, the
  swizzled stage (its write and its column reads), the byte transposes
  (``__byte_perm`` emulated), the column maxima and the exponents handed
  back through shared memory, and every amax group holding one to-block.
* The Python mirror's constants and instances are the CUDA source's.
* ``mxsf_requantize_plain(..., transpose=True)`` equals the JAX package's
  ``ops.mxsf_requantize`` (Pallas in interpret mode) transposed, bit for
  bit (numpy inputs from a seed).
* The re-encode table codes as the float path (decode, ``scale_by_exp2``,
  ``encode_mxsf``) on every (code, from-scale byte, block exponent)
  triple a block can hold: 256 x 256 x 277 cases.
"""
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import common as C
from repro_torch.kernels import mxsf_quant as TQ

torch.set_num_threads(2)
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.core import blocking
    from repro.kernels import ops
    return types.SimpleNamespace(
        jnp=jax.numpy, ops=ops,
        quantize=jax.jit(blocking.quantize, static_argnums=(1, 2)))


PAIRS = [((b, 1), (1, b)) for b in TQ.REQUANT_B] + [
    ((1, b), (b, 1)) for b in TQ.REQUANT_B]


def _grid(fb, shape):
    """An (m, k) code grid the from-block tiles (ragged along the other
    dimension)."""
    m, k = shape
    return (-(-m // fb[0]) * fb[0], -(-k // fb[1]) * fb[1])


# ---------------------------------------------------------------------------
# the kernel's index maths, emulated
# ---------------------------------------------------------------------------

def stage_chunk(row, chunk):
    return chunk ^ (((row >> 4) & 3) << 1)


def colmax_chunk(chunk):
    return chunk ^ ((chunk >> 3) & 7)


def byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 numpy arrays."""
    both = [(x >> (8 * k)) & 0xFF for k in range(4)] + [
        (y >> (8 * k)) & 0xFF for k in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= both[(sel >> (4 * n)) & 7] << (8 * n)
    return out


def _tiles_of_blocks(plan):
    """Each persistent block's tiles: b, b + blocks, ...; every tile once."""
    tx, ty = plan["tiles"]
    seen = np.concatenate([np.arange(b, tx * ty, plan["blocks"])
                           for b in range(plan["blocks"])])
    assert np.array_equal(np.sort(seen), np.arange(tx * ty))
    return [(t // tx * plan["rows"], t % tx * plan["cols"])
            for t in range(tx * ty)]


W, L, I, J = np.meshgrid(np.arange(8), np.arange(32), np.arange(8),
                         np.arange(16), indexing="ij")  # warp, lane, row, byte


def _emulate(plan, transpose):
    """(code writes, scale writes): per output index, the (row, column) of
    the to-padded grid whose code the kernel stores there (-1 = never
    written), and per scale index the to-block's (row, column) of its
    first element; raises if an index is written twice."""
    mo, ko, b, d = plan["mo"], plan["ko"], plan["b"], plan["dir"]
    codes = np.full(mo * ko, -1, np.int64)
    nbs = (mo * (ko // b)) if d == 0 else ((mo // b) * ko)
    scales = np.full(nbs, -1, np.int64)

    def write(arr, idx, val):
        idx, val = np.broadcast_arrays(idx, val)
        assert np.bincount(idx.ravel(), minlength=arr.size).max() <= 1
        assert (arr[idx] == -1).all(), "written twice"
        arr[idx] = val

    for rt, ct in _tiles_of_blocks(plan):
        r = rt + 8 * W + I        # the element each thread holds
        c = ct + 16 * L + J
        elem = r * ko + c          # its index in the to-padded grid
        live = (r < mo) & (c < ko)
        if not transpose:
            write(codes, elem[live], elem[live])
        else:
            # stage: row 8 w + i, chunk l at its swizzled chunk
            row = 8 * W + I
            stage = np.full(64 * 512, -1, np.int64)
            stage[row * 512 + 16 * stage_chunk(row, L) + J] = elem
            # column reads: lane -> (b4, qq); 16 words of 4 bytes each
            w_, l_, it, i_ = np.meshgrid(np.arange(8), np.arange(32),
                                         np.arange(2), np.arange(16),
                                         indexing="ij")
            b4, qq = l_ & 3, (2 * w_ + it) * 8 + (l_ >> 2)
            at = 16 * stage_chunk(16 * b4, qq >> 2) + 4 * (qq & 3)
            addr = (16 * b4 + i_) * 512 + at
            # each word's bytes as element ids (4 per word): emulate the
            # 4x4 byte transposes on the ids' tile positions
            wv = [stage[addr + k] for k in range(4)]  # byte k of word i_
            for k in range(4):
                # column k of the thread's block: rows 16 b4 + i_ in order
                got = wv[k]
                cc = ct + 4 * qq + k
                rr = rt + 16 * b4 + i_
                ok = (cc < ko) & (rt + 16 * b4 < mo)
                write(codes, (cc * mo + rr)[ok], got[ok])
        # scales
        if d == 0:
            grp = b // 16  # lanes of a row block
            lanes = (L % grp == 0) & (J == 0) & live
            first = r * ko + c
            if not transpose:
                write(scales, (r * (ko // b) + c // b)[lanes], first[lanes])
            else:
                small = np.full((512 // b) * 64, -1, np.int64)
                small[((16 * L // b) * 64 + 8 * W + I)[lanes]] = first[lanes]
                tid = np.arange((512 // b) * 4)
                cb, rs = ct // b + (tid >> 2), rt + 16 * (tid & 3)
                for p in range(16):
                    ok = (cb * b < ko) & (rs < mo)
                    write(scales, (cb * mo + rs + p)[ok],
                          small[(tid >> 2) * 64 + 16 * (tid & 3) + p][ok])
        else:
            nb, wpb = 64 // b, 8 // (64 // b)
            # column maxima: warp w's columns 16 l + 4 t .. at the
            # swizzled chunk; thread tid reads columns 2 tid, 2 tid + 1
            colmax = np.full(8 * 512, -1, np.int64)
            w_, l_, t_, e_ = np.meshgrid(np.arange(8), np.arange(32),
                                         np.arange(4), np.arange(4),
                                         indexing="ij")
            colmax[w_ * 512 + colmax_chunk(4 * l_ + t_) * 4 + e_] = (
                w_ * 1000 + 16 * l_ + 4 * t_ + e_)
            tid = np.arange(256)
            at = colmax_chunk(tid >> 1) * 4 + 2 * (tid & 1)
            for h in range(nb):
                for k in range(wpb):
                    for e in range(2):
                        assert (colmax[(h * wpb + k) * 512 + at + e]
                                == (h * wpb + k) * 1000 + 2 * tid + e).all()
                band = rt // b + h
                for e in range(2):
                    cc = ct + 2 * tid + e
                    ok = (band < mo // b) & (cc < ko)
                    idx = cc * (mo // b) + band if transpose \
                        else band * ko + cc
                    write(scales, idx[ok], ((band * b) * ko + cc)[ok])
            # the exponents read back: warp w's band w / wpb, its columns
            band_of_warp = (8 * np.arange(8)) // b
            assert (band_of_warp == np.arange(8) // wpb).all()
    return codes, scales


@pytest.mark.parametrize("fb,tb", PAIRS, ids=str)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("shape", [(128, 1024), (192, 1100), (100, 64),
                                   (320, 2100)], ids=str)
def test_requant_tiles_write_every_output_once(fb, tb, transpose, shape):
    """On a card of 2 SMs, so the persistent blocks walk several tiles."""
    m, k = _grid(fb, shape)
    plan = TQ.requant_plan(m, k, fb, tb, sms=2)
    b = plan["b"]
    assert plan["blocks"] <= TQ.REQUANT_BLOCKS_PER_SM * 2
    mo, ko = plan["mo"], plan["ko"]
    codes, scales = _emulate(plan, transpose)
    # every code once, and the right one: the element at (r, c) of the
    # to-padded grid lands at r * ko + c, or c * mo + r transposed
    r, c = np.divmod(np.arange(mo * ko), ko)
    want = (c * mo + r) if transpose else (r * ko + c)
    got = np.full(mo * ko, -1, np.int64)
    got[want] = r * ko + c
    assert (codes == got).all()
    # every scale once, each at its to-block's place
    if plan["dir"] == 0:
        rb, cb = np.divmod(np.arange(mo * (ko // b)), ko // b)
        first = rb * ko + cb * b
        idx = cb * mo + rb if transpose else rb * (ko // b) + cb
    else:
        rb, cb = np.divmod(np.arange((mo // b) * ko), ko)
        first = rb * b * ko + cb
        idx = cb * (mo // b) + rb if transpose else rb * ko + cb
    want_s = np.full(scales.size, -1, np.int64)
    want_s[idx] = first
    assert (scales == want_s).all()


@pytest.mark.parametrize("fb,tb", PAIRS, ids=str)
def test_requant_amax_groups_hold_one_to_block(fb, tb):
    """(1,B) out: a row block is one row of B/16 lanes of one warp (their
    shuffle group); (B,1) out: a column of B rows is one column of the
    warps of one band (the column reduction)."""
    plan = TQ.requant_plan(*_grid(fb, (256, 1024)), fb, tb)
    b = plan["b"]
    r, c = 8 * W + I, 16 * L + J
    if plan["dir"] == 0:
        grp = (W, I, L // (b // 16))
        blk = (r, c // b)
    else:
        grp = ((8 * W) // b, L, J)
        blk = (r // b, c)
    gid = np.ravel_multi_index(np.broadcast_arrays(*grp),
                               [int(np.max(g)) + 1 for g in grp])
    bid = np.ravel_multi_index(np.broadcast_arrays(*blk),
                               [int(np.max(x)) + 1 for x in blk])
    pairs = np.unique(np.stack([gid.ravel(), bid.ravel()]), axis=1)
    assert len(np.unique(pairs[0])) == pairs.shape[1]  # a group: one block
    assert len(np.unique(pairs[1])) == pairs.shape[1]  # a block: one group


def test_stage_transpose_byte_perms():
    """The 4x4 byte transposes of the stage read: word g of column k holds
    byte k of rows 4 g .. 4 g + 3, in row order."""
    rng = np.random.default_rng(0)
    wv = rng.integers(0, 1 << 32, size=(16, 64), dtype=np.uint64)
    for g in range(4):
        a, b_, c, d = (wv[4 * g + n] for n in range(4))
        x0, x1 = byte_perm(a, b_, 0x5140), byte_perm(a, b_, 0x7362)
        x2, x3 = byte_perm(c, d, 0x5140), byte_perm(c, d, 0x7362)
        tw = [byte_perm(x0, x2, 0x5410), byte_perm(x0, x2, 0x7632),
              byte_perm(x1, x3, 0x5410), byte_perm(x1, x3, 0x7632)]
        for k in range(4):
            for n in range(4):
                assert ((tw[k] >> (8 * n)) & 0xFF
                        == (wv[4 * g + n] >> (8 * k)) & 0xFF).all()


# ---------------------------------------------------------------------------
# constants against the CUDA source
# ---------------------------------------------------------------------------

def _const(src, name):
    m = re.search(rf"constexpr int {name} = (-?\d+);", src)
    assert m, name
    return int(m.group(1))


def test_requant_constants_match_the_cuda_source():
    src = (CSRC / "mxsf_quant.cu").read_text()
    assert (_const(src, "kRqTileRows"), _const(src, "kRqTileCols")) \
        == TQ.REQUANT_TILE
    assert _const(src, "kRqBlocksPerSm") == TQ.REQUANT_BLOCKS_PER_SM
    assert _const(src, "kReDMin") == TQ.REENCODE_DMIN
    assert _const(src, "kReDMax") == TQ.REENCODE_DMAX
    assert _const(src, "kReEMin") == TQ.REENCODE_EMIN
    assert _const(src, "kReEMax") == TQ.REENCODE_EMAX
    # an instance for every pair the mirror names, and no other
    inst = set()
    for d, (cond, key) in enumerate((("fbk == 1 && tbm == 1 && tbk == fbm",
                                      "fbm"),
                                     ("fbm == 1 && tbk == 1 && tbm == fbk",
                                      "fbk"))):
        body = src[src.index(f"if ({cond})"):]
        body = body[:body.index("}")]
        for b, dd in re.findall(rf"if \({key} == (\d+)\)\s+return "
                                rf"launch_requant<(\d+), {d}>", body):
            assert b == dd
            inst.add(((int(b), 1), (1, int(b))) if d == 0
                     else ((1, int(b)), (int(b), 1)))
    assert inst == set(TQ.REQUANT_TILED)
    # the swizzles this file emulates
    assert "return chunk ^ (((row >> 4) & 3) << 1);" in src
    assert "return chunk ^ ((chunk >> 3) & 7);" in src
    assert "0x5140" in src and "0x7362" in src and "0x5410" in src
    assert TQ.requantize_instance((64, 1), (1, 64)) == "tiled (64,1)->(1,64)"
    assert TQ.requantize_instance((8, 8), (1, 8)) == "one thread per block"


# ---------------------------------------------------------------------------
# the transposed plain version against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fb,tb", PAIRS, ids=str)
def test_requantize_plain_transposed_matches_jax(jx, fb, tb):
    rng = np.random.default_rng(11 + fb[0])
    x = (rng.standard_normal((96, 200)) * np.exp(
        rng.standard_normal((96, 200)) * 2.0)).astype(np.float32)
    qt = jx.quantize(jx.jnp.asarray(x), "mxsf", fb)
    want_c, want_s = jx.ops.mxsf_requantize(qt.codes, qt.scale_e8m0, fb, tb)
    got_c, got_s = TQ.mxsf_requantize(
        torch.from_numpy(np.array(qt.codes)),
        torch.from_numpy(np.array(qt.scale_e8m0)), fb, tb, transpose=True)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c).T)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s).T)
    assert TQ.launches["mxsf_requantize"] == 0


# ---------------------------------------------------------------------------
# the re-encode table, exhaustively
# ---------------------------------------------------------------------------

def test_reencode_table_matches_the_float_path_on_every_triple():
    """table[clamp(S - e)][c] == encode(scale_by_exp2(decode(c) 2^S, -e))
    for every code c, from-scale byte s (S = clip(s - 127)) and block
    exponent e in [-149, 127] whose block can hold the value (|v| <
    2^(e+1), or v = 0)."""
    tab = TQ.reencode_table()
    lut = C.decode_mxsf(torch.arange(256, dtype=torch.int32))
    e = torch.arange(TQ.REENCODE_EMIN, TQ.REENCODE_EMAX + 1,
                     dtype=torch.int32)[:, None]
    codes = torch.arange(256)[None, :]
    fits_total = 0
    for sb in range(256):
        S = torch.tensor(sb - 127, dtype=torch.int32).clamp(-126, 127)
        v = (lut * C.exp2i(S))[None, :].expand(e.shape[0], 256)
        flt = C.encode_mxsf(C.scale_by_exp2(v, -e))
        got = tab[TQ.reencode_row(S, e).long(), codes]
        fits = (v == 0) | (C.flog2(v.abs()) <= e)
        bad = (got != flt) & fits
        assert not bool(bad.any()), (sb, int(bad.sum()))
        fits_total += int(fits.sum())
    assert fits_total == 8583424
