"""Bit-level float helpers of the kernels, as plain PyTorch.

Counterpart of the JAX package's ``kernels/common.py``.  The same functions
exist as ``__device__`` helpers in ``csrc/mxsf_codec.cuh``, which every CUDA
kernel includes; the plain versions here are what the kernels' plain
PyTorch versions (and the CPU tests) run, as the JAX kernels' bodies run
them.  Exponents are read and powers of two built by bit-casting, exactly
as the kernels do.
"""
from __future__ import annotations

import torch

__all__ = ["flog2", "exp2i", "rne", "scale_by_exp2", "broadcast_block_scale",
           "decode_mxsf", "encode_mxsf", "decode_packed", "tc_scale_ok",
           "mma_plan", "cp_width", "gemm_scratch", "split_scratch",
           "read_f32_steps", "raw_stream"]

_I32 = torch.int32
SCALE_BIAS = 127  # E8M0 storage bias


def flog2(a: torch.Tensor) -> torch.Tensor:
    """floor(log2(a)) for a >= 0 f32, exact down to subnormals; -127 for 0.

    Subnormals have a zero exponent field, so they are renormalized by 2^24
    first (exact) and the shift is taken back off."""
    a = a.float()
    sub = (a > 0) & (a < 2.0 ** -126)
    an = torch.where(sub, a * 2.0 ** 24, a)
    bits = an.view(_I32)
    return ((bits >> 23) & 0xFF) - 127 - torch.where(
        sub, torch.full_like(bits, 24), torch.zeros_like(bits))


def exp2i(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e for integer e, clipped to [-126, 127]."""
    e = e.clamp(-126, 127).to(_I32)
    return ((e + 127) << 23).view(torch.float32)


def scale_by_exp2(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """x * 2^e for integer e in [-252, 252], split so each factor is a
    representable power of two."""
    e = e.to(_I32)
    e1 = torch.div(e, 2, rounding_mode="floor")
    return x * exp2i(e1) * exp2i(e - e1)


def broadcast_block_scale(se: torch.Tensor, bm: int, bk: int):
    """Block-grid scale exponents (G1, G2) -> per-element (G1*bm, G2*bk)."""
    return se.repeat_interleave(bm, 0).repeat_interleave(bk, 1)


def rne(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x)  # round half to even


def decode_mxsf(code: torch.Tensor) -> torch.Tensor:
    """MXSF byte -> value relative to the shared exponent (f32)."""
    c = code.to(_I32)
    s = (c >> 7) & 1
    ee = (c >> 5) & 3
    m5 = (c & 31).float()
    eee = (c >> 2) & 7
    m2 = (c & 3).float()
    v25 = (1.0 + m5 / 32.0) * exp2i(ee - 3)
    v32n = (1.0 + m2 / 4.0) * exp2i(eee - 10)
    v32s = (m2 / 4.0) * (2.0 ** -9)
    mag = torch.where(ee > 0, v25, torch.where(eee > 0, v32n, v32s))
    return torch.where(s == 1, -mag, mag)


def encode_mxsf(xa: torch.Tensor) -> torch.Tensor:
    """Relative value (|xa| < 2) -> MXSF byte."""
    xa = xa.float()
    # sign straight from the bit pattern so -0.0 keeps its sign byte
    s = (xa.view(_I32) >> 31) & 1
    a = xa.abs()
    e = flog2(a)

    def f(v):
        return torch.full_like(a, v)

    # E2M5 regime (gap < 3)
    e25 = e.clamp(-2, 0)
    m25 = rne(a * exp2i(5 - e25))
    ovf = m25 >= 64
    e25 = torch.where(ovf, e25 + 1, e25)
    m25 = torch.where(ovf, f(32.0), m25)
    top = e25 > 0
    e25 = torch.where(top, torch.zeros_like(e25), e25)
    m25 = torch.where(top, f(63.0), m25)
    code25 = ((e25 + 3) << 5) | (m25.to(_I32) - 32)

    # E3M2 regime (gap >= 3)
    e32 = e.clamp(-9, -3)
    sub = a < 2.0 ** -9
    step = torch.where(sub, f(2.0 ** -11), exp2i(e32 - 2))
    q = rne(a / step)
    promote = sub & (q >= 4)
    q = torch.where(promote, f(4.0), q)
    e32 = torch.where(promote, torch.full_like(e32, -9), e32)
    sub = sub & ~promote
    novf = (~sub) & (q >= 8)
    e32 = torch.where(novf, e32 + 1, e32)
    q = torch.where(novf, f(4.0), q)
    cross = e32 > -3
    eee = torch.where(sub, torch.zeros_like(e32), e32 + 10)
    m2 = torch.where(sub, q, q - 4.0).to(_I32)
    code32 = (eee << 2) | m2
    code32 = torch.where(cross, torch.full_like(code32, 1 << 5), code32)

    code = torch.where(a == 0, torch.zeros_like(code25),
                       torch.where(e >= -2, code25, code32))
    return ((code | (s << 7)) & 0xFF).to(torch.uint8)


def decode_packed(codes: torch.Tensor, scales: torch.Tensor,
                  block) -> torch.Tensor:
    """f32 values of a packed 2D code grid under ``block``: the code's value
    times 2^(scale byte - 127), the exponent clipped as ``exp2i`` clips it
    (the decode of the kernels and of ``blocking.dequantize``, uncropped)."""
    se = scales.to(_I32) - SCALE_BIAS
    return decode_mxsf(codes) * exp2i(broadcast_block_scale(se, *block))


# ---------------------------------------------------------------------------
# the tensor-core matmul engine (csrc/mxsf_mma.cuh), mirrored as plain Python
# ---------------------------------------------------------------------------

K_STEP = 64       # kBK: K per step
TC_MIN_EXP = -52  # kTcMinExp, kTcMaxExp: the S_e range of a nonzero block
TC_MAX_EXP = 63   # that admits the tensor-core path
MIN_CTAS = 264    # kMinCtas: two waves of 132 SMs
N_SMS = 132       # the H100's streaming multiprocessors


def tc_scale_ok(scale_byte: int) -> bool:
    """The kernels' predicate for one nonzero block's E8M0 byte: S_e =
    byte - 127 in [TC_MIN_EXP, TC_MAX_EXP].  Then every decoded value is a
    normal bf16 and every product of two such values is exact and normal in
    f32; a step with a nonzero block outside takes the f32 path."""
    return (SCALE_BIAS + TC_MIN_EXP <= int(scale_byte)
            <= SCALE_BIAS + TC_MAX_EXP)


def mma_plan(m: int, kp: int, n: int, bm: int, bn: int,
             prep: int = 0) -> dict:
    """Grid of one launch: bm x bn output tiles, K in steps of K_STEP, and
    where the tiles are fewer than MIN_CTAS, K split into whole steps
    (``per`` steps a split) so that the grid reaches MIN_CTAS blocks where
    K allows.  ``workspace``: f32 partials the wrapper allocates (splits x
    m x n, none unsplit); ``counters``: one int32 per output tile.  With
    ``prep`` (prepared A: that many K steps per producer block), producer
    blocks build every A tile once into ``prep_bytes`` of bf16 tiles, each
    published by a ``ready`` word (producers start at each split's first
    step), and K is split, at most 4 ways, only where that fills the last
    wave of output tiles clearly better."""
    m_tiles, n_tiles = -(-m // bm), -(-n // bn)
    steps = -(-kp // K_STEP)
    tiles = m_tiles * n_tiles
    if prep:
        # the share of the last wave's SMs kept busy; a split (and its
        # ordered reduction) must raise it by a tenth to be taken
        fill = lambda s: tiles * s / N_SMS / -(-tiles * s // N_SMS)
        cand = [s for s in range(2, 5) if steps >= 16 * s]
        best = max(cand, key=fill, default=1)
        per = -(-steps // (best if fill(best) >= fill(1) + 0.1 else 1))
    else:
        target = -(-MIN_CTAS // max(tiles, 1))
        per = max(1, steps // target)
    splits = max(1, -(-steps // per))
    producers = m_tiles * splits * -(-per // prep) if prep else 0
    return dict(bm=bm, bn=bn, m_tiles=m_tiles, n_tiles=n_tiles, steps=steps,
                per=per, splits=splits, ctas=tiles * splits + producers,
                producers=producers,
                workspace=splits * m * n if splits > 1 else 0,
                counters=tiles if splits > 1 else 0,
                prep_bytes=m_tiles * bm * steps * K_STEP * 2 if prep else 0,
                ready=m_tiles * steps if prep else 0)


def cp_width(t: torch.Tensor, row_bytes: int) -> int:
    """The widest cp.async (16, 8 or 4 bytes) that the rows of ``t`` allow."""
    for w in (16, 8, 4):
        if t.data_ptr() % w == 0 and row_bytes % w == 0:
            return w
    raise ValueError(f"rows of {row_bytes} bytes: the kernel copies 4-byte "
                     f"aligned rows only")


_SCRATCH: dict = {}


def gemm_scratch(kind: str, device, plan: dict):
    """Scratch of one launch of kernel ``kind``: (workspace or None, tile
    counters, f32-step counter, prepared-A buffer or None, ready words,
    epoch).  The counters persist per device: each launch leaves them zero
    (the last block of a tile resets its own); the f32-step counter
    accumulates until ``read_f32_steps(reset=True)``; the ready words
    persist too, and each launch publishes its steps under a new epoch, so
    no word of an earlier launch reads as ready."""
    st = _SCRATCH.get((kind, device))
    if (st is None or st[0].numel() < plan["counters"]
            or st[2].numel() < plan["ready"]):
        counters = torch.zeros(max(plan["counters"], 1), dtype=_I32,
                               device=device)
        ready = torch.zeros(max(plan["ready"], 1), dtype=_I32, device=device)
        f32 = st[1] if st else torch.zeros(1, dtype=_I32, device=device)
        st = _SCRATCH[(kind, device)] = [counters, f32, ready, 0]
    work = (torch.empty(plan["workspace"], dtype=torch.float32,
                        device=device) if plan["workspace"] else None)
    prep = (torch.empty(plan["prep_bytes"], dtype=torch.uint8, device=device)
            if plan["prep_bytes"] else None)
    st[3] = st[3] % (1 << 29) + 1
    return work, st[0], st[1], prep, st[2], st[3]


def split_scratch(kind: str, device, plan: dict):
    """Scratch of one launch of kernel ``kind`` whose key splits are merged
    by the last block of each group: (f32 workspace or None, group
    counters, f32-step counter), kept per device and grown as needed.  The
    counters are zero between launches (the merging block resets its own);
    the workspace is rewritten by every launch before it is read, so
    launches in stream order share it."""
    st = _SCRATCH.get((kind, device))
    if st is None:
        zeros = lambda: torch.zeros(1, dtype=_I32, device=device)
        st = _SCRATCH[(kind, device)] = [zeros(), zeros(), None, 0, None]
    if st[0].numel() < plan["counters"]:
        st[0] = torch.zeros(plan["counters"], dtype=_I32, device=device)
    if plan["workspace"] and (st[4] is None
                              or st[4].numel() < plan["workspace"]):
        st[4] = torch.empty(plan["workspace"], dtype=torch.float32,
                            device=device)
    return (st[4] if plan["workspace"] else None), st[0], st[1]


def raw_stream(device_index: int) -> int:
    """The current CUDA stream of a device as an int handle -- what
    ``torch.cuda.current_stream(d).cuda_stream`` returns, without building
    a Stream object (5 us a call on the card's host)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def read_f32_steps(kind: str, reset: bool = False) -> int:
    """Steps that took the f32 path in kernel ``kind`` on every device
    (synchronises); with ``reset`` the counters go back to 0."""
    total = 0
    for (k, _), st in _SCRATCH.items():
        f32 = st[1]
        if k == kind:
            total += int(f32.item())
            if reset:
                f32.zero_()
    return total
