#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100 by design).

    python3 chip_smoke.py            # the card run (needs one CUDA device)
    python3 chip_smoke.py --cpu-rehearsal   # reduced config on the CPU

Phases, each printed as one JSON line:

1. device  -- ``nvidia-smi`` name and power limit, torch's device name/count.
2. build   -- ``nvcc`` for every CUDA source (in parallel) with each
              kernel's registers, shared memory and spills.
3. kernels -- each CUDA kernel against its plain PyTorch version at the
              serving path's shapes of qwen2.5-32b (bf16 activations, plus
              edge blocks, which must reach the matmul kernels' f32 path):
              max error against the stated tolerance; the fused matmul
              also bit for bit on exact-sum operands of the same shape
              (values whose every partial sum is exact in f32, so any
              summation order gives the same bits) and its quantize
              prologue bit for bit against the plain codec (identity
              weight: y == qdq(x)); the attention's V decode bit for bit
              (one visible key: out == V), its key-split plan, two calls
              giving the same bits, no tile of the path's data on its f32
              path, and an edge-scale case (K/V rows at S_e = -127, -123
              and 127, zero rows) held per slot that must reach it; kernel
              time (CUDA events, L2 flushed before every launch), its
              device time alone (the profiler), plain time, one PyTorch
              library call as a yardstick the port never calls (also
              both ways), and the bound (least time the card could take).  Then the training
              kernels at the shapes of full-width h2o-danube-1.8b at batch
              4 x seq 512 (M = 2048): the quantizer ((8,8) on the bf16
              weight wg and on an f32 g, (64,1) on wg, (1,64) on x; each
              row names the kernel instance that ran) and the
              requantize ((64,1)->(1,64) on wg's codes, (1,64)->(64,1) on
              x's, each plain and transposed, each row naming its
              instance, with its device time) bit for bit, edge blocks
              included, every tiled instance (B = 32 and 64) on ragged
              grids, and its re-encode table against the float path on
              every triple a block can hold; the packed x packed
              matmul (dx and dw of wg, (8,8)) within tolerance and bit for
              bit on exact-sum operands; the fused matmul's training
              switches (emit_codes with (8,8) and (1,64)/(64,1), codes bit
              for bit against the quantizer's; quantize_lhs=False within
              tolerance; each bit for bit on exact-sum operands); both
              matmuls on edge blocks, through their f32 path.
4. serve   -- the packed store of full-width qwen2.5-32b built leaf by leaf
              on the card from ``--seed``, then ``ServeEngine`` (kernel
              datapath, packed MXSF KV cache) on a few requests: tokens,
              stats, host-clock tokens/s, peak memory, and the launch count
              of each kernel, which must equal the path's count.
5. slice   -- the first prefill dispatch and two decode dispatches of one
              engine state through the kernels, each kernel call teacher-
              forced: its plain version runs on the same inputs and the
              kernel must meet phase 3's tolerance there, so the logits
              match the plain head within its tolerance and the tokens
              agree wherever the plain top-1/top-2 gap is wider than twice
              it; the cache changes at the written rows only.
6. train   -- full-width h2o-danube-1.8b, all 24 layers, on the card:
              ``init_state`` from ``--seed``, batches from ``lm_batch``
              (4 x 512), ``make_train_step(MXSF_TRAIN, backend="cuda")``
              for 3 steps, then a fourth under the profiler: loss, grad
              norm, lr, step seconds (host clock, synchronised), tokens/s,
              peak memory, each kernel's launches, which must equal the
              path's count, and the K steps the matmul kernels sent down
              their f32 path.  Then the 1D
              layout (``block_mode="1d"``, ``quantize_bwd=True``) at the
              same width with the depth cut to 4 layers, for 2 steps and
              a third under the profiler (with the requantizer's summed
              device time).
7. train_slice -- one more train step of each layout (on the state the
              phase "train" left, with its first batch) teacher-forced:
              every quantize and requantize call (plain or transposed)
              and every set of emitted codes bit for bit against its plain
              version on the same
              inputs, every matmul call within ``train_rtol(K)`` =
              TRAIN_SUM_C sqrt(K) 2^-24 of sum|x w| of the plain version,
              and the loss within the head's tolerance of the loss of the
              plain head's logits.
8. the ``kernels`` line (every CUDA kernel, its launches on the serving
   and both training paths), then the ``{"ok": true, ...}`` line.

Any failure raises, so the run exits non-zero and prints no ok line.  The
rehearsal runs the same phases on the CPU at the reduced config (the
kernels' plain versions, no build, no launch counts) and prints no ok line.
``--out FILE`` also writes every phase's results to FILE as one JSON.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

MATMUL_RTOL = 1e-5      # of sum_k |x_k w_k|: f32 summation order only
TRAIN_SUM_C = 4.0       # train_rtol's multiple of sqrt(K) u: twice the
                        # worst measured on the H100 (1.55, head's dx)
F32_EPS = 2.0 ** -24    # f32 unit roundoff
ATTN_ATOL = 1e-5        # of max|v|: f32 summation order and expf

RESULTS: dict = {}


def emit(phase: str, **fields):
    RESULTS.setdefault(phase, []).append(fields)
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu-rehearsal", action="store_true",
                   help="reduced config on the CPU; prints no ok line")
    p.add_argument("--out", default=None,
                   help="also write all results to this JSON file")
    return p.parse_args(argv)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Mean ms of ``fn()`` over ``iters`` calls after a warm-up: CUDA events
    around each call with the L2 cache flushed before it on the card, the
    host clock on the CPU."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.flush = (torch.empty(64 << 20, dtype=torch.uint8, device=device)
                      if device.type == "cuda" else None)

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        if self.flush is None:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    def device_time(self, fn, iters: int = 20):
        """Mean device time of ``fn()`` in ms (the profiler's time of every
        kernel it launches, L2 flushed before each call as above, the
        flush's own kernel left out): the kernel without the host's share
        of the call.  None on the CPU."""
        if self.flush is None:
            return None
        from torch.profiler import ProfilerActivity, profile
        fn()
        self.torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                self.flush.zero_()
                fn()
            self.torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages()
                 if "FillFunctor<unsigned char>" not in e.key)
        return us / iters / 1e3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch, rehearsal: bool) -> str:
    if rehearsal:
        emit("device", kind="cpu", count=0, nvidia_smi=None)
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return kind


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    results = build.build_all()
    wall = time.perf_counter() - t0
    for name, res in results.items():
        info = [ln.split(":", 1)[-1].strip() for ln in res.ptxas.splitlines()
                if "Used" in ln or "spill" in ln]
        emit("build", source=f"src/repro_torch/kernels/csrc/{name}.cu",
             seconds=round(res.seconds, 2), ptxas=info)
    emit("build", wall_seconds=round(wall, 2))


def _bound_ms(nbytes: float, *work):
    """Least time for the work: the larger of its bytes over the memory rate
    and its operations, given as (count, peak rate) pairs, at their rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(ops / peak for ops, peak in work)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _edge_x(torch, m, k, gen, device):
    """f32 activations with zero, subnormal, +-3e38 and S_e ~ +-127 blocks
    (each value bf16-exact)."""
    x = torch.randn((m, k), generator=gen, device=device)
    x[0, :64] = 0.0
    x[min(1, m - 1), :64] *= 1e-40
    x[min(1, m - 1), 64:128] = 3e38 * torch.sign(x[min(1, m - 1), 64:128])
    x[-1, -64:] *= 2.0 ** -120
    return x.to(torch.bfloat16).float()


def _tie_x(torch, m, k, gen, device):
    """f32 activations (bf16-exact) whose values sit on the encoder's
    rounding midpoints: each 64-block has one max element 1.9921875 and 63
    ties (k + 1/2) steps of every MXSF regime (E2M5, E3M2, the subnormal
    step, and the ties that round up into the next exponent), the whole
    block times a random 2^j."""
    ties = ([(q + 0.5) * 2.0 ** (e - 5) for e in (-2, -1, 0)
             for q in range(32, 64)]
            + [(q + 0.5) * 2.0 ** (e - 2) for e in range(-9, -2)
               for q in range(4, 8)]
            + [(q + 0.5) * 2.0 ** -11 for q in range(4)])
    ties = torch.tensor(ties, device=device)
    pick = torch.randint(len(ties), (m, k), generator=gen, device=device)
    x = ties[pick]
    x[:, ::64] = 1.9921875
    sign = torch.randint(2, (m, k), generator=gen, device=device) * 2 - 1
    j = torch.randint(-40, 41, (m, k // 64), generator=gen, device=device)
    pow2 = ((j + 127).to(torch.int32) << 23).view(torch.float32)  # exact
    return x * sign * pow2.repeat_interleave(64, dim=1)


def _exact_sum_values(torch, shape, block, gen, device):
    """f32 values 0, +-1/2, +-1, +-2 times 2^b, b = 0 or 1 alternating
    between neighbouring blocks of ``block`` (a checkerboard).  Each product
    of two is a multiple of 2^-2 no larger than 2^4 in magnitude, so every
    partial sum of up to 2^18 of them is a multiple of 2^-2 no larger than
    2^22: exact in f32, in any order and any grouping, and so also in the
    tensor cores' sums.  MXSF holds them exactly under any block (qdq is the
    identity on them), so a matmul kernel must equal its plain version bit
    for bit on them, whatever its order."""
    r, c = shape
    f = torch.randint(7, shape, generator=gen, device=device,
                      dtype=torch.uint8).float()
    # 0 -> 0; 1, 2 -> +-1/2; 3, 4 -> +-1; 5, 6 -> +-2
    x = torch.exp2(torch.div(f + 1, 2, rounding_mode="floor") - 2)
    x.mul_(1 - 2 * (f % 2 == 0).float()).masked_fill_(f == 0, 0.0)
    del f
    bi = torch.arange(r, device=device) // block[0]
    bj = torch.arange(c, device=device) // block[1]
    x.mul_(torch.exp2(((bi[:, None] + bj[None, :]) % 2).float()))
    return x


def _f32_steps(kind, reset=True):
    """K steps that took the kernel's f32 path since the last reset."""
    from repro_torch.kernels import common as C
    return C.read_f32_steps(kind, reset=reset)


def held_to_plain(torch, y, y_ref, xq, wq, keep=False, rtol=MATMUL_RTOL):
    """A matmul kernel's y against the plain version's y_ref on the same
    inputs (xq, wq: the f32 operands both multiply): max error and its
    ratio to rtol * sum_k |x_k w_k|; with ``keep`` also the plain output
    and the tolerance (tensors)."""
    err = (y - y_ref).abs()
    tol = rtol * torch.matmul(xq.abs(), wq.abs()) + 1e-30
    out = dict(max_abs_err=float(err.max()),
               err_over_tol=float((err / tol).max()),
               finite=bool(torch.isfinite(y).all()
                           and torch.isfinite(y_ref).all()))
    if keep:
        out.update(y_ref=y_ref, tol=tol)
    return out


def fused_operands(torch, x, codes, scales, xblk=(1, 64), wblk=(64, 1),
                   quantize_lhs=True):
    """The f32 operands the fused matmul multiplies: qdq(x) (or x) padded to
    the weight's rows, and the decoded weight."""
    from repro_torch.core import blocking as B
    from repro_torch.kernels import common as C
    xv = torch.nn.functional.pad(x.float(), (0, codes.shape[0] - x.shape[1]))
    if quantize_lhs:
        xv = B.qdq(xv, "mxsf", tuple(xblk))
    return xv, C.decode_packed(codes, scales, wblk)


def matmul_against_plain(torch, x, codes, scales, y, keep: bool = False,
                         xblk=(1, 64), wblk=(64, 1), quantize_lhs=True,
                         rtol=MATMUL_RTOL):
    """The fused kernel's y against its plain version (``held_to_plain``)."""
    from repro_torch.kernels import mxsf_fused_matmul as FM
    y_ref = FM.mxsf_fused_matmul_plain(x, codes, scales, xblk, wblk,
                                       quantize_lhs)
    xq, wq = fused_operands(torch, x, codes, scales, xblk, wblk,
                            quantize_lhs)
    return held_to_plain(torch, y, y_ref, xq, wq, keep, rtol)


def _gate(name, res):
    if not res["finite"] or res["err_over_tol"] > 1.0:
        raise AssertionError(f"{name}: error {res['max_abs_err']} is "
                             f"{res['err_over_tol']:.3g}x the tolerance")


def fused_exact_sum(torch, gen, device, m, k, n, xblk=(1, 64),
                    wblk=(64, 1), quantize_lhs=True, dtype=None):
    """The fused kernel bit for bit against its plain version on exact-sum
    operands (``_exact_sum_values``): y, and with a quantized x the emitted
    codes and scales."""
    from repro_torch.core import blocking as B
    from repro_torch.kernels import mxsf_fused_matmul as FM
    dtype = dtype or torch.bfloat16
    x = _exact_sum_values(torch, (m, k), xblk, gen, device).to(dtype)
    qt = B.quantize(_exact_sum_values(torch, (k, n), wblk, gen, device),
                    "mxsf", wblk)
    _f32_steps("mxsf_fused_matmul")
    got = FM.mxsf_fused_matmul(x, qt.codes, qt.scale_e8m0, xblk, wblk,
                               quantize_lhs, quantize_lhs)
    want = FM.mxsf_fused_matmul_plain(x, qt.codes, qt.scale_e8m0, xblk,
                                      wblk, quantize_lhs, quantize_lhs)
    f32_steps = _f32_steps("mxsf_fused_matmul")
    if quantize_lhs:
        same = all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        same = torch.equal(got, want)
    if not same:
        raise AssertionError(f"fused {m}x{k}x{n} {xblk}/{wblk} raw="
                             f"{not quantize_lhs}: not bit for bit on the "
                             "exact-sum operands")
    return dict(exact_sum_bitwise=same, exact_sum_f32_steps=f32_steps)


def check_matmul(torch, timer, gen, device, m, k, n, edge=False):
    from repro_torch.core import blocking as B
    from repro_torch.kernels import mxsf_fused_matmul as FM
    x = (_edge_x(torch, m, k, gen, device) if edge else
         torch.randn((m, k), generator=gen, device=device)).to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device=device)
    if edge:  # zero, tiny and huge weight blocks, sized so that no sum
        # overflows (where it did, the overflow would depend on the order)
        w[:64, : n // 4] = 0.0
        w[64:128] *= 2.0 ** -100      # meets x's 3e38 block
        w[128:192, : n // 4] *= 1e37  # S_e near +127
        w[192:256, : n // 4] *= 1e-38  # subnormal weights
        x[:, 128:192] *= 1e-3
    qt = B.quantize(w.to(torch.bfloat16), "mxsf", (64, 1))
    del w
    codes, scales = qt.codes, qt.scale_e8m0
    on_card = device.type == "cuda"
    if on_card:
        _f32_steps("mxsf_fused_matmul")
    y = FM.mxsf_fused_matmul(x, codes, scales)
    f32_steps = _f32_steps("mxsf_fused_matmul") if on_card else None
    res = matmul_against_plain(torch, x, codes, scales, y)
    _gate(f"matmul {m}x{k}x{n} edge={edge}", res)
    if edge and on_card and not f32_steps:
        raise AssertionError(f"matmul {m}x{k}x{n}: the edge blocks did not "
                             "reach the f32 path")
    row = dict(kernel="mxsf_fused_matmul", m=m, k=k, n=n, edge=edge,
               max_abs_err=res["max_abs_err"],
               err_over_tol=res["err_over_tol"], f32_steps=f32_steps)
    if not edge:
        row.update(fused_exact_sum(torch, gen, device, m, k, n))
        w_lib = B.dequantize(B.QuantizedTensor(
            codes, scales, "mxsf", (64, 1), tuple(codes.shape), "bfloat16"))
        row["ms"] = timer(lambda: FM.mxsf_fused_matmul(x, codes, scales), 10)
        row["plain_ms"] = timer(
            lambda: FM.mxsf_fused_matmul_plain(x, codes, scales), 3, 1)
        row["library_ms"] = timer(lambda: torch.matmul(x, w_lib), 10)
        nbytes = m * k * 2 + codes.numel() + scales.numel() + m * n * 4
        row["bound_ms"], row["bound_by"] = _bound_ms(
            nbytes, (2.0 * m * k * n, BF16_TENSOR_FLOPS))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["over_library"] = row["ms"] / row["library_ms"]
        del w_lib
    emit("kernels", **row)
    return row


def check_codec_exact(torch, gen, device, m, k):
    """The fused kernel's quantize prologue bit for bit: against an identity
    weight (every decoded block one-hot, value 1.0) each output is one exact
    product, so y == qdq(x) exactly -- for random, tie-heavy and edge x, in
    f32 and bf16."""
    from repro_torch.core import blocking as B
    from repro_torch.kernels import mxsf_fused_matmul as FM
    eye = B.quantize(torch.eye(k, device=device), "mxsf", (64, 1))
    inputs = {"random": torch.randn((m, k), generator=gen, device=device),
              "ties": _tie_x(torch, m, k, gen, device),
              "edge": _edge_x(torch, m, k, gen, device)}
    for name, x32 in inputs.items():
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            y = FM.mxsf_fused_matmul(x, eye.codes, eye.scale_e8m0)
            want = B.qdq(x.float(), "mxsf", (1, 64))
            n_diff = int((y != want).sum())
            emit("kernels", kernel="mxsf_fused_matmul", check="codec_exact",
                 x=name, dtype=str(dt).split(".")[-1], m=m, k=k,
                 rounded=int((want != x.float()).sum()), n_diff=n_diff)
            if n_diff:
                raise AssertionError(f"fused matmul codec ({name}, {dt}): "
                                     f"{n_diff} values differ from qdq(x)")


def _bf16_ulp(torch, t):
    """One bf16 ulp at each |t|: 2^(floor(log2|t|) - 7)."""
    _, e = torch.frexp(t.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(t), e - 8)


def attention_against_plain(torch, out, q, kv_args, args, per_slot=False):
    """The kernel's out against the plain version on the same inputs: max
    error and its ratio to ATTN_ATOL * max|v| (max over the row's slot with
    ``per_slot``; plus one bf16 ulp of the plain value for bf16 q: the f32
    results may round to neighbours)."""
    from repro_torch.core import blocking as B
    from repro_torch.kernels import mxsf_attention as MA
    ref = MA.mxsf_attention_plain(q, *kv_args, **args).float()
    vc, vs = kv_args[2], kv_args[3]
    vabs = B.dequantize(B.QuantizedTensor(
        vc, vs, "mxsf", (vc.shape[-1],), tuple(vc.shape),
        "float32")).abs()
    if per_slot:  # (slots,) -> one per q row
        vmax = vabs.flatten(1).amax(dim=1).repeat_interleave(
            q.shape[0] // vc.shape[0])[:, None, None]
    else:
        vmax = float(vabs.max())
    tol = ATTN_ATOL * vmax
    if q.dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(torch, ref)
    err = (out.float() - ref).abs()
    return float(err.max()), float((err / tol).max())


def check_attention(torch, timer, gen, device, cfg, slots, L, S):
    from repro_torch.core import blocking as B
    from repro_torch.kernels import mxsf_attention as MA
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    g = h // kv
    cache = {}
    for nm in ("k", "v"):
        qt = B.quantize(torch.randn((slots, L, kv, dh), generator=gen,
                                    device=device), "mxsf", (dh,))
        cache[nm] = (qt.codes, qt.scale_e8m0)
    q32 = torch.randn((slots * h, S, dh), generator=gen, device=device)
    q = q32.to(torch.bfloat16)
    lens = [0, L // 3, L - 5, L][:slots] + [L] * max(0, slots - 4)
    kvl = torch.tensor(lens, dtype=torch.int32).repeat_interleave(h)
    off = torch.clamp(kvl - S, min=0)
    win = torch.full_like(kvl, MA.NO_WINDOW)
    win[h:2 * h] = 64  # one slot with a sliding window
    args = dict(causal=True, kv_len=kvl.to(device), q_offset=off.to(device),
                window=win.to(device))
    kv_args = (cache["k"][0], cache["k"][1], cache["v"][0], cache["v"][1])
    call = lambda qq=q: MA.mxsf_attention(qq, *kv_args, **args)
    plain = lambda qq=q: MA.mxsf_attention_plain(qq, *kv_args, **args)
    on_card = device.type == "cuda"
    # the path's data (bf16 q, random K/V): no tile on the f32 path, and
    # the same bits from two calls (the splits merge in a fixed order)
    _f32_steps("mxsf_attention")
    first, second = call(), call()
    path_f32 = _f32_steps("mxsf_attention") if on_card else None
    if path_f32:
        raise AssertionError(f"attention S={S}: {path_f32} tiles of the "
                             "path's data took the f32 path")
    if not torch.equal(first, second):
        raise AssertionError(f"attention S={S}: two calls differ")
    errs = {}
    for name, qq in (("bfloat16", q), ("float32", q32)):
        out = call(qq)
        errs[name] = attention_against_plain(torch, out, qq, kv_args, args)
        if errs[name][1] > 1.0 or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"attention S={S} {name}: error "
                                 f"{errs[name][0]} is {errs[name][1]:.3g}x "
                                 "the tolerance")
        if not bool((out[:h] == 0).all()):
            raise AssertionError("attention: a kv_len=0 row is not zero")
    # V decode bit for bit: with one visible key p = 1 and l = 1, so every
    # f32 output row is that key's decoded V row exactly
    one = dict(args, kv_len=torch.ones_like(args["kv_len"]),
               q_offset=torch.zeros_like(args["q_offset"]))
    out1 = MA.mxsf_attention(q32[:, :1].contiguous(), *kv_args, **one)
    v0 = B.dequantize(B.QuantizedTensor(
        cache["v"][0][:, :1], cache["v"][1][:, :1], "mxsf", (dh,),
        (slots, 1, kv, dh), "float32"))  # (slots, 1, kv, dh)
    want = v0[:, 0].repeat_interleave(g, dim=1).reshape(slots * h, 1, dh)
    v_diff = int((out1 != want).sum())
    if v_diff:
        raise AssertionError(f"attention: {v_diff} V values differ from "
                             "the plain decode with one visible key")
    # library yardstick: SDPA on the dequantized cache (GQA expanded)
    deq = {nm: B.dequantize(B.QuantizedTensor(
        c, s, "mxsf", (dh,), tuple(c.shape), "bfloat16"))
        .permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
        for nm, (c, s) in cache.items()}
    qpos = off[:, None] + torch.arange(S)[None, :]
    kpos = torch.arange(L)
    mask = ((kpos[None, None, :] < kvl[:, None, None])
            & (kpos[None, None, :] <= qpos[:, :, None])
            & (kpos[None, None, :] > (qpos - win[:, None])[:, :, None]))
    mask = mask.reshape(slots, h, S, L).to(device)
    qb = q.reshape(slots, h, S, dh)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    plan = MA.attention_plan(slots, kv, g, S, L, dh)
    row = dict(kernel="mxsf_attention", slots=slots, L=L, S=S, h=h, kv=kv,
               dh=dh, kv_len=lens, max_abs_err=errs["bfloat16"][0],
               err_over_tol=errs["bfloat16"][1],
               f32_max_abs_err=errs["float32"][0],
               f32_err_over_tol=errs["float32"][1], v_decode_diff=v_diff,
               splits=plan["splits"], keys_per_split=plan["per"] * MA.KEY_TILE,
               row_tile=plan["mt"], blocks=plan["ctas"],
               f32_steps=path_f32, deterministic=True)
    library = lambda: sdpa(qb, deq["k"], deq["v"], attn_mask=mask)
    row["ms"] = timer(call, 20)
    row["plain_ms"] = timer(plain, 5)
    row["library_ms"] = timer(library, 20)
    # device time alone (the profiler), without the host's share of a call,
    # and that share: the host's time a call (calls queued back to back)
    row["device_ms"] = timer.device_time(call)
    row["library_device_ms"] = timer.device_time(library)
    for key, fn in (("host_us", call), ("library_host_us", library)):
        fn()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        row[key] = (time.perf_counter() - t0) / 50 * 1e6
        if on_card:
            torch.cuda.synchronize()
    # bytes: the valid K/V rows of each (slot, kv head) once, q and out;
    # operations over the visible keys of every query row: QK^T at the bf16
    # tensor rate (on the path q is MXSF-quantized and decoded K has at most
    # 6 significant bits, so its products are bf16-exact), PV at the f32
    # rate (P stays f32)
    vis = mask.reshape(slots * h, S, L)
    rows_needed = [int(vis[b * h:(b + 1) * h].any(dim=(0, 1)).sum())
                   for b in range(slots)]
    nbytes = sum(rows_needed) * kv * 2 * (dh + 1) + 2 * q.numel() * 2
    ops = 2.0 * dh * float(vis.sum())
    row["bound_ms"], row["bound_by"] = _bound_ms(
        nbytes, (ops, BF16_TENSOR_FLOPS), (ops, F32_FLOPS))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    emit("kernels", **row)
    return row


def check_attention_edge(torch, gen, device, cfg, slots, L, S):
    """The attention kernel on edge scale bytes, held to its plain version
    per slot (ATTN_ATOL of the slot's largest |v|), all inside the rows'
    visible keys: in slots 1 and 2, K rows at S_e = -127 and -123 (bytes 0
    and 4), V rows at S_e = -123 and zero rows carrying byte 255; in slot
    3, two keys whose K and V rows are at S_e = 127 (byte 254) with the
    smallest codes (+-2^-11: values +-2^116, every sum finite), which take
    the softmax, so the slot's output is one of their V rows.  Their tiles
    must take the f32 path."""
    from repro_torch.core import blocking as B
    from repro_torch.kernels import mxsf_attention as MA
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    cache = {}
    for nm in ("k", "v"):
        qt = B.quantize(torch.randn((slots, L, kv, dh), generator=gen,
                                    device=device), "mxsf", (dh,))
        cache[nm] = [qt.codes.clone(), qt.scale_e8m0.clone()]
    kc, ks = cache["k"]
    vc, vs = cache["v"]
    lens = [0, L // 3, L - 5, L][:slots] + [L] * max(0, slots - 4)
    last = [n - 1 for n in lens]
    small = torch.tensor([1, 129], dtype=torch.uint8, device=device)
    for b in (1, 2):
        kp = last[b] - 12
        if b >= slots or kp < 0:
            continue
        ks[b, kp:kp + 2] = 0                    # S_e = -127
        ks[b, kp + 2:kp + 4] = 4                # S_e = -123
        vs[b, kp + 4:kp + 6] = 4
        for c, sc in ((kc, ks), (vc, vs)):      # zero rows, byte 255
            c[b, kp + 6:kp + 8] = 0
            sc[b, kp + 6:kp + 8] = 255
    kp = last[min(3, slots - 1)] - 3
    if slots > 3 and kp >= 0:
        for c, sc in ((kc, ks), (vc, vs)):      # S_e = 127, small codes
            c[3, kp:kp + 2] = small.repeat(dh // 2)
            sc[3, kp:kp + 2] = 254
    q32 = torch.randn((slots * h, S, dh), generator=gen, device=device)
    kvl = torch.tensor(lens, dtype=torch.int32).repeat_interleave(h)
    off = torch.clamp(kvl - S, min=0)
    win = torch.full_like(kvl, MA.NO_WINDOW)
    win[h:2 * h] = 64
    args = dict(causal=True, kv_len=kvl.to(device), q_offset=off.to(device),
                window=win.to(device))
    kv_args = (kc, ks, vc, vs)
    row = dict(kernel="mxsf_attention", case="edge scales", S=S)
    for name, qq in (("bfloat16", q32.to(torch.bfloat16)), ("float32", q32)):
        _f32_steps("mxsf_attention")
        out = MA.mxsf_attention(qq, *kv_args, **args)
        steps = (_f32_steps("mxsf_attention") if device.type == "cuda"
                 else None)
        err, ratio = attention_against_plain(torch, out, qq, kv_args, args,
                                             per_slot=True)
        if ratio > 1.0 or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"attention edge S={S} {name}: error {err} "
                                 f"is {ratio:.3g}x the tolerance")
        if device.type == "cuda" and not steps:
            raise AssertionError(f"attention edge S={S} {name}: no tile "
                                 "took the f32 path")
        row.update({f"{name}_max_abs_err": err,
                    f"{name}_err_over_tol": ratio,
                    f"{name}_f32_steps": steps})
    emit("kernels", **row)
    return row


def check_attention_shapes(torch, gen, device):
    """The attention kernel's other code paths against its plain version:
    head dims that are not multiples of 16 (byte-wise K/V loads) or are
    odd (scalar stores and merge), a q one element off 16-byte alignment
    (element-wise q loads), ragged lengths with kv_len=0 rows and a
    window, several key splits, and a group of 80 rows -- f32 and bf16 q,
    within ATTN_ATOL of max|v| (plus one bf16 ulp of the output)."""
    from repro_torch.core import blocking as B
    from repro_torch.kernels import mxsf_attention as MA
    worst = 0.0
    for dh, S, g, L in ((100, 1, 3, 70), (33, 7, 2, 130), (64, 20, 4, 200)):
        Bc, kv = 2, 2
        h = kv * g
        kv_args = []
        for _ in range(2):
            qt = B.quantize(torch.randn((Bc, L, kv, dh), generator=gen,
                                        device=device), "mxsf", (dh,))
            kv_args += [qt.codes, qt.scale_e8m0]
        kvl = torch.randint(S, L + 1, (Bc * h,), generator=gen,
                            device=device).to(torch.int32)
        kvl[1] = 0
        args = dict(causal=True, kv_len=kvl, q_offset=torch.clamp(
            kvl - S, min=0), window=torch.full_like(kvl, 9))
        n = Bc * h * S * dh
        for dt in (torch.float32, torch.bfloat16):
            # one element past the start: q's rows leave 16-byte alignment
            q = torch.randn(n + 1, generator=gen, device=device).to(dt)[1:]
            q = q.view(Bc * h, S, dh)
            out = MA.mxsf_attention(q, *kv_args, **args)
            err, ratio = attention_against_plain(torch, out, q, kv_args,
                                                 args)
            if ratio > 1.0 or not bool((out[1] == 0).all()):
                raise AssertionError(f"attention dh={dh} S={S} {dt}: error "
                                     f"{err} is {ratio:.3g}x the tolerance")
            worst = max(worst, ratio)
    emit("kernels", kernel="mxsf_attention", case="ragged shapes",
         worst_err_over_tol=worst)


def check_division(torch, gen, device, n=1 << 24):
    """The attention kernel's division (a branch-free sequence where the
    operands allow) bit for bit against the IEEE division ``/`` on the
    card: random bit patterns and moderate values over several decades, of
    either sign, by random positive divisors."""
    from repro_torch.kernels import mxsf_attention as MA
    if device.type != "cuda":
        return None
    bits = lambda: torch.randint(0, 0x7F800000, (n,), generator=gen,
                                 device=device, dtype=torch.int32).view(
        torch.float32)
    decades = 10.0 ** torch.randint(-4, 5, (n,), generator=gen,
                                    device=device).float()
    sign = torch.where(torch.rand(n, generator=gen, device=device) < 0.5,
                       -1.0, 1.0)
    mismatches = pairs = 0
    for a in (bits() * sign, torch.randn(n, generator=gen, device=device)
              * decades):
        for b in (bits(), torch.rand(n, generator=gen, device=device) * 600
                  + 1e-3):
            q, ref = MA.division(a, b), a / b
            same = q.view(torch.int32) == ref.view(torch.int32)
            mismatches += int((~same & ~torch.isnan(ref)).sum())
            pairs += n
    emit("kernels", kernel="mxsf_attention", case="division",
         pairs=pairs, mismatches=mismatches)
    if mismatches:
        raise AssertionError(f"attention division: {mismatches} of {pairs} "
                             "quotients differ from IEEE division")
    return mismatches


def phase_kernels(torch, device, cfg, slots, chunk, max_len, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    timer = Timer(torch, device)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    hd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv * cfg.head_dim
    shapes = [(d, hd), (d, kvd), (d, f), (f, d), (d, v)]
    if hd != d:
        shapes.insert(1, (hd, d))
    rows = {}
    for m in (slots, slots * chunk):
        for k, n in shapes:
            rows[(m, k, n)] = check_matmul(torch, timer, gen, device, m, k, n)
    check_matmul(torch, timer, gen, device, slots, d, kvd, edge=True)
    check_matmul(torch, timer, gen, device, slots * chunk, d, kvd, edge=True)
    check_codec_exact(torch, gen, device, slots * chunk, d)
    attn = {S: check_attention(torch, timer, gen, device, cfg, slots,
                               max_len, S) for S in (1, chunk)}
    for S in (1, chunk):
        check_attention_edge(torch, gen, device, cfg, slots, max_len, S)
    check_attention_shapes(torch, gen, device)
    check_division(torch, gen, device)
    del timer
    return rows, attn


# ---------------------------------------------------------------------------
# training kernels at the training path's shapes (phase 3, continued)
# ---------------------------------------------------------------------------

def _codec_edge(torch, m, k, gen, device):
    """f32 values with zero, -0.0, subnormal, +-3e38 and S_e ~ +-127 blocks
    and values on the encoder's rounding midpoints (every 8x8 tile and
    64-long row or column block of the first 64 rows holds one kind)."""
    x = torch.randn((m, k), generator=gen, device=device)
    x[:8] = 0.0
    x[8:16] = -0.0
    x[16:24] *= 1e-40
    x[24:32] = 3e38 * torch.sign(x[24:32])
    x[32:40] *= 2.0 ** -120
    x[40:64] = _tie_x(torch, 24, k, gen, device)
    x[:, :8] *= 1e-39   # subnormal column blocks along K
    return x


def check_quantize(torch, timer, x, block, name, edge=None):
    """Quantizer kernel against its plain version, bit for bit (codes and
    scales), on x and on the edge inputs; times at x's shape."""
    from repro_torch.kernels import mxsf_quant as MQ
    got = MQ.mxsf_quantize(x, block)
    want = MQ.mxsf_quantize_plain(x, block)
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    edge_same = None
    if edge is not None:
        eg = MQ.mxsf_quantize(edge, block)
        ew = MQ.mxsf_quantize_plain(edge, block)
        edge_same = torch.equal(eg[0], ew[0]) and torch.equal(eg[1], ew[1])
    if not same or edge_same is False:
        raise AssertionError(f"quantize {name} {block}: not bit for bit "
                             f"(random {same}, edge {edge_same})")
    m, k = x.shape
    row = dict(kernel="mxsf_quantize", operand=name, m=m, k=k,
               block=list(block), dtype=str(x.dtype).split(".")[-1],
               instance=MQ.quantize_instance(block), bitwise=same,
               edge_bitwise=edge_same, max_abs_err=0.0)
    row["ms"] = timer(lambda: MQ.mxsf_quantize(x, block), 10)
    row["plain_ms"] = timer(lambda: MQ.mxsf_quantize_plain(x, block), 3, 1)
    row["library_ms"] = None  # no single PyTorch call computes it
    row["device_ms"] = timer.device_time(lambda: MQ.mxsf_quantize(x, block))
    nbytes = x.numel() * x.element_size() + got[0].numel() + got[1].numel()
    row["bound_ms"], row["bound_by"] = _bound_ms(nbytes)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    emit("kernels", **row)
    return row, got


def check_requantize(torch, timer, codes, scales, fb, tb, name, edge=None,
                     transpose=False):
    """Requantize kernel against its plain version, bit for bit (codes and
    scales, plain or transposed), on the operand and on the edge blocks;
    times at the operand's shape (event ms, device ms)."""
    from repro_torch.kernels import mxsf_quant as MQ
    call = lambda c, s: MQ.mxsf_requantize(c, s, fb, tb, transpose=transpose)
    plain = lambda c, s: MQ.mxsf_requantize_plain(c, s, fb, tb,
                                                  transpose=transpose)
    got, want = call(codes, scales), plain(codes, scales)
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    edge_same = None
    if edge is not None:
        eg, ew = call(*edge), plain(*edge)
        edge_same = torch.equal(eg[0], ew[0]) and torch.equal(eg[1], ew[1])
    if not same or edge_same is False:
        raise AssertionError(f"requantize {name} {fb}->{tb} transpose="
                             f"{transpose}: not bit for bit (random {same}, "
                             f"edge {edge_same})")
    m, k = codes.shape
    row = dict(kernel="mxsf_requantize", operand=name, m=m, k=k,
               from_block=list(fb), to_block=list(tb), transpose=transpose,
               instance=MQ.requantize_instance(fb, tb), bitwise=same,
               edge_bitwise=edge_same, max_abs_err=0.0)
    row["ms"] = timer(lambda: call(codes, scales), 10)
    row["plain_ms"] = timer(lambda: plain(codes, scales), 3, 1)
    row["library_ms"] = None  # no single PyTorch call computes it
    row["device_ms"] = timer.device_time(lambda: call(codes, scales))
    nbytes = (codes.numel() + scales.numel() + got[0].numel()
              + got[1].numel())
    row["bound_ms"], row["bound_by"] = _bound_ms(nbytes)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    if row["device_ms"]:
        row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
    emit("kernels", **row)
    return row


def check_requantize_shapes(torch, gen, device):
    """Every tiled requantize instance -- both directions, B = 32 and 64 --
    plain and transposed, bit for bit against the plain version on random
    and edge operands whose grids are neither 512 nor 16 codes wide (and,
    for B = 32, half a tile tall)."""
    from repro_torch.core import blocking as B
    from repro_torch.kernels import mxsf_quant as MQ
    cases = 0
    for shape in ((200, 1100), (96, 200), (40, 3000)):
        x = torch.randn(shape, generator=gen, device=device) * 3.0
        e = _codec_edge(torch, 128, 1152, gen, device)[:, :1100]
        for fb, tb in MQ.REQUANT_TILED:
            for t in (x, e):
                qt = B.quantize(t, "mxsf", fb)
                for transpose in (False, True):
                    got = MQ.mxsf_requantize(qt.codes, qt.scale_e8m0, fb, tb,
                                             transpose=transpose)
                    want = MQ.mxsf_requantize_plain(qt.codes, qt.scale_e8m0,
                                                    fb, tb, transpose)
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        raise AssertionError(
                            f"requantize {tuple(qt.codes.shape)} {fb}->{tb} "
                            f"transpose={transpose}: not bit for bit")
                    cases += 1
    emit("kernels", kernel="mxsf_requantize", case="instances and shapes",
         instances=sorted(MQ.REQUANT_TILED.values()), cases=cases,
         bitwise=True)


def check_reencode(torch, device):
    """The tiled requantizer's re-encode table against its float path on
    the card, on every (code, from-scale byte, block exponent) triple a
    block can hold."""
    from repro_torch.kernels import mxsf_quant as MQ
    if device.type != "cuda":
        return None
    tab, flt, fits = MQ.reencode_check()
    fits = fits.bool()
    n, bad = int(fits.sum()), int(((tab != flt) & fits).sum())
    emit("kernels", kernel="mxsf_requantize", case="re-encode table",
         triples=tab.numel(), triples_a_block_can_hold=n, mismatches=bad)
    if bad or n != 8583424:
        raise AssertionError(f"re-encode table: {bad} of {n} triples differ "
                             "from the float path")
    del tab, flt, fits
    return bad


def mx_exact_sum(torch, gen, device, m, k, n, blk=(8, 8)):
    """mx_matmul bit for bit against its plain version on exact-sum
    operands, packed under ``blk``."""
    from repro_torch.core import blocking as B
    from repro_torch.kernels import mx_matmul as MM
    xq, wq = (B.quantize(_exact_sum_values(torch, shape, blk, gen, device),
                         "mxsf", blk) for shape in ((m, k), (k, n)))
    args = (xq.codes, xq.scale_e8m0, wq.codes, wq.scale_e8m0, blk, blk)
    _f32_steps("mxsf_matmul")
    same = torch.equal(MM.mxsf_matmul(*args), MM.mxsf_matmul_plain(*args))
    f32_steps = _f32_steps("mxsf_matmul")
    if not same:
        raise AssertionError(f"mx_matmul {m}x{k}x{n}: not bit for bit on "
                             "the exact-sum operands")
    return dict(exact_sum_bitwise=same, exact_sum_f32_steps=f32_steps)


def check_mx_matmul(torch, timer, gen, name, x, w, blk=(8, 8)):
    """Packed x packed kernel against its plain version: random operands
    within tolerance, exact-sum operands of the same shape bit for bit."""
    from repro_torch.kernels import common as C
    from repro_torch.kernels import mx_matmul as MM
    on_card = x[0].is_cuda
    _f32_steps("mxsf_matmul")
    y = MM.mxsf_matmul(*x, *w, blk, blk)
    f32_steps = _f32_steps("mxsf_matmul") if on_card else None
    y_ref = MM.mxsf_matmul_plain(*x, *w, blk, blk)
    xq, wq = C.decode_packed(*x, blk), C.decode_packed(*w, blk)
    res = held_to_plain(torch, y, y_ref, xq, wq)
    _gate(f"mx_matmul {name}", res)
    m, k = x[0].shape
    n = w[0].shape[1]
    row = dict(kernel="mxsf_matmul", operand=name, m=m, k=k, n=n,
               block=list(blk), max_abs_err=res["max_abs_err"],
               err_over_tol=res["err_over_tol"], f32_steps=f32_steps,
               **mx_exact_sum(torch, gen, x[0].device, m, k, n, blk))
    row["ms"] = timer(lambda: MM.mxsf_matmul(*x, *w, blk, blk), 10)
    row["plain_ms"] = timer(lambda: MM.mxsf_matmul_plain(*x, *w, blk, blk),
                            3, 1)
    xb, wb = xq.to(torch.bfloat16), wq.to(torch.bfloat16)
    row["library_ms"] = timer(lambda: torch.matmul(xb, wb), 10)
    del xq, wq, xb, wb
    nbytes = sum(t.numel() for t in (*x, *w)) + m * n * 4
    row["bound_ms"], row["bound_by"] = _bound_ms(
        nbytes, (2.0 * m * k * n, BF16_TENSOR_FLOPS))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["over_library"] = row["ms"] / row["library_ms"]
    emit("kernels", **row)
    return row


def check_mx_matmul_edge(torch, gen, device, blk=(8, 8)):
    """mx_matmul on edge blocks (zero, subnormal, 3e38 against 2^-100,
    S_e near -120): within tolerance, and the f32 path must have run."""
    from repro_torch.core import blocking as B
    from repro_torch.kernels import common as C
    from repro_torch.kernels import mx_matmul as MM
    x = _edge_x(torch, 128, 256, gen, device)
    w = torch.randn((256, 192), generator=gen, device=device)
    w[64:128] *= 2.0 ** -100
    xq, wq = B.quantize(x, "mxsf", blk), B.quantize(w, "mxsf", blk)
    args = (xq.codes, xq.scale_e8m0, wq.codes, wq.scale_e8m0, blk, blk)
    _f32_steps("mxsf_matmul")
    y = MM.mxsf_matmul(*args)
    f32_steps = _f32_steps("mxsf_matmul")
    res = held_to_plain(torch, y, MM.mxsf_matmul_plain(*args),
                        C.decode_packed(xq.codes, xq.scale_e8m0, blk),
                        C.decode_packed(wq.codes, wq.scale_e8m0, blk))
    _gate("mx_matmul edge", res)
    if device.type == "cuda" and not f32_steps:
        raise AssertionError("mx_matmul: the edge blocks did not reach the "
                             "f32 path")
    emit("kernels", kernel="mxsf_matmul", operand="edge", m=128, k=256,
         n=192, block=list(blk), max_abs_err=res["max_abs_err"],
         err_over_tol=res["err_over_tol"], f32_steps=f32_steps)


def check_fused_train(torch, timer, gen, name, x, codes, scales, xblk, wblk,
                      quantize_lhs=True, want_codes=None):
    """The fused matmul's training switches: with ``emit_codes`` the codes
    must equal the quantizer kernel's (``want_codes``) and the plain
    version's bit for bit, and y its plain version within tolerance; the
    raw-x path within tolerance; and each mode bit for bit on exact-sum
    operands of the same shape."""
    from repro_torch.kernels import mxsf_fused_matmul as FM
    emit_codes = quantize_lhs
    call = lambda: FM.mxsf_fused_matmul(x, codes, scales, xblk, wblk,
                                        quantize_lhs, emit_codes)
    on_card = x.is_cuda
    _f32_steps("mxsf_fused_matmul")
    out = call()
    f32_steps = _f32_steps("mxsf_fused_matmul") if on_card else None
    y = out[0] if emit_codes else out
    res = matmul_against_plain(torch, x, codes, scales, y, xblk=xblk,
                               wblk=wblk, quantize_lhs=quantize_lhs)
    _gate(f"fused {name}", res)
    codes_ok = None
    if emit_codes:
        plain = FM.mxsf_fused_matmul_plain(x, codes, scales, xblk, wblk,
                                           True, True)
        codes_ok = (torch.equal(out[1], plain[1])
                    and torch.equal(out[2], plain[2])
                    and torch.equal(out[1], want_codes[0])
                    and torch.equal(out[2], want_codes[1]))
        if not codes_ok:
            raise AssertionError(f"fused {name}: emitted codes differ")
    m, k = x.shape
    n = codes.shape[1]
    row = dict(kernel="mxsf_fused_matmul", operand=name, m=m, k=k, n=n,
               xblk=list(xblk), wblk=list(wblk), quantize_lhs=quantize_lhs,
               emit_codes=emit_codes, emitted_codes_bitwise=codes_ok,
               dtype=str(x.dtype).split(".")[-1],
               max_abs_err=res["max_abs_err"],
               err_over_tol=res["err_over_tol"], f32_steps=f32_steps,
               **fused_exact_sum(torch, gen, x.device, m, k, n, xblk, wblk,
                                 quantize_lhs, x.dtype))
    row["ms"] = timer(call, 10)
    row["plain_ms"] = timer(lambda: FM.mxsf_fused_matmul_plain(
        x, codes, scales, xblk, wblk, quantize_lhs, emit_codes), 3, 1)
    _, wq = fused_operands(torch, x, codes, scales, xblk, wblk, False)
    lib_dt = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    xl, wl = x.to(lib_dt), wq[:k].to(lib_dt)
    row["library_ms"] = timer(lambda: torch.matmul(xl, wl), 10)
    del wq, xl, wl
    nbytes = (x.numel() * x.element_size() + codes.numel() + scales.numel()
              + m * n * 4)
    if emit_codes:
        nbytes += out[1].numel() + out[2].numel()
    rate = BF16_TENSOR_FLOPS if quantize_lhs else F32_FLOPS
    row["bound_ms"], row["bound_by"] = _bound_ms(
        nbytes, (2.0 * m * k * n, rate))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["over_library"] = row["ms"] / row["library_ms"]
    emit("kernels", **row)
    return row, out


def check_fused_train_edge(torch, gen, device, xblk, wblk):
    """The fused matmul's emit path on edge blocks: y within tolerance,
    codes bit for bit, and the f32 path must have run."""
    from repro_torch.core import blocking as B
    from repro_torch.kernels import mxsf_fused_matmul as FM
    x = _edge_x(torch, 128, 256, gen, device)
    w = torch.randn((256, 192), generator=gen, device=device)
    w[64:128] *= 2.0 ** -100
    qt = B.quantize(w, "mxsf", wblk)
    _f32_steps("mxsf_fused_matmul")
    out = FM.mxsf_fused_matmul(x, qt.codes, qt.scale_e8m0, xblk, wblk,
                               emit_codes=True)
    f32_steps = _f32_steps("mxsf_fused_matmul")
    res = matmul_against_plain(torch, x, qt.codes, qt.scale_e8m0, out[0],
                               xblk=xblk, wblk=wblk)
    _gate(f"fused edge {xblk}", res)
    plain = FM.mxsf_fused_matmul_plain(x, qt.codes, qt.scale_e8m0, xblk,
                                       wblk, True, True)
    if not (torch.equal(out[1], plain[1]) and torch.equal(out[2], plain[2])):
        raise AssertionError(f"fused edge {xblk}: emitted codes differ")
    if device.type == "cuda" and not f32_steps:
        raise AssertionError(f"fused edge {xblk}: the edge blocks did not "
                             "reach the f32 path")
    emit("kernels", kernel="mxsf_fused_matmul", operand="edge", m=128,
         k=256, n=192, xblk=list(xblk), wblk=list(wblk),
         max_abs_err=res["max_abs_err"], err_over_tol=res["err_over_tol"],
         emitted_codes_bitwise=True, f32_steps=f32_steps)


def phase_train_kernels(torch, device, cfg, batch, seq, seed):
    """The three training kernels and the fused matmul's training switches
    at the training path's shapes of ``cfg``: M = batch * seq tokens, the
    gate projection wg (d x d_ff) and the activations at d_model."""
    from repro_torch.core import blocking as B
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    timer = Timer(torch, device)
    d, f, m = cfg.d_model, cfg.d_ff, batch * seq
    w = (torch.randn((d, f), generator=gen, device=device)
         / math.sqrt(d)).to(torch.bfloat16)
    g = torch.randn((m, f), generator=gen, device=device) * 1e-4
    x = torch.randn((m, d), generator=gen, device=device).to(torch.bfloat16)
    edge = _codec_edge(torch, 128, 256, gen, device)
    rows = {}
    rows["quantize"], w8 = check_quantize(torch, timer, w, (8, 8),
                                          "weight wg", edge)
    _, g8 = check_quantize(torch, timer, g, (8, 8), "grad g", edge)
    _, w64 = check_quantize(torch, timer, w, (64, 1), "weight wg", edge)
    check_quantize(torch, timer, x, (1, 64), "activation x", edge)
    # requantize: w (64,1)->(1,64), written transposed (the 1D dx), and x
    # (1,64)->(64,1) (the 1D dw); each also the other way round
    x64 = B.quantize(x, "mxsf", (1, 64))
    e64 = B.quantize(edge, "mxsf", (64, 1))
    e1 = B.quantize(edge, "mxsf", (1, 64))
    for transpose in (True, False):
        row = check_requantize(torch, timer, *w64, (64, 1), (1, 64),
                               "weight wg", (e64.codes, e64.scale_e8m0),
                               transpose)
        rows.setdefault("requantize", row)
    for transpose in (False, True):
        check_requantize(torch, timer, x64.codes, x64.scale_e8m0, (1, 64),
                         (64, 1), "activation x", (e1.codes, e1.scale_e8m0),
                         transpose)
    check_requantize_shapes(torch, gen, device)
    check_reencode(torch, device)
    # mx_matmul, the 2D backward of wg: dx = g @ w^T, dw = x^T @ g
    x8 = B.quantize(x, "mxsf", (8, 8))
    wT = B.transpose_qt(B.QuantizedTensor(*w8, "mxsf", (8, 8), (d, f),
                                          "bfloat16"))
    xT = B.transpose_qt(x8)
    rows["mx_matmul"] = check_mx_matmul(
        torch, timer, gen, "dx of wg", g8,
        (wT.codes.contiguous(), wT.scale_e8m0.contiguous()))
    check_mx_matmul(torch, timer, gen, "dw of wg",
                    (xT.codes.contiguous(), xT.scale_e8m0.contiguous()), g8)
    check_mx_matmul_edge(torch, gen, device)
    # fused: emit_codes in both layouts, and the raw-g path
    rows["fused_emit_2d"], _ = check_fused_train(
        torch, timer, gen, "forward of wg, (8,8)", x, *w8, (8, 8), (8, 8),
        want_codes=(x8.codes, x8.scale_e8m0))
    check_fused_train(torch, timer, gen, "forward of wg, (1,64)", x, *w64,
                      (1, 64), (64, 1), want_codes=(x64.codes,
                                                    x64.scale_e8m0))
    check_fused_train(torch, timer, gen, "dx of wg, raw g", g,
                      wT.codes.contiguous(), wT.scale_e8m0.contiguous(),
                      (8, 8), (8, 8), quantize_lhs=False)
    for xblk, wblk in (((8, 8), (8, 8)), ((1, 64), (64, 1))):
        check_fused_train_edge(torch, gen, device, xblk, wblk)
    del timer
    return rows


# ---------------------------------------------------------------------------
# training (phase "train") and its teacher-forced slice ("train_slice")
# ---------------------------------------------------------------------------

def train_launch_counts(cfg, policy):
    """Kernel launches of one train step of a dense decoder, from the path:
    7 linears per layer plus the LM head (once: S <= xent_chunk), each one
    raw-weight mx_dot with its backward."""
    n = 7 * cfg.n_layers + 1
    if policy.block_mode == "2d":
        # w and g quantized; the fused forward emits x's codes; dx and dw
        return {"mxsf_quantize": 2 * n, "mxsf_fused_matmul": n,
                "mxsf_matmul": 2 * n, "mxsf_requantize": 0}
    # 1d: w quantized; forward, dx and dw fused; w and x re-blocked
    return {"mxsf_quantize": n, "mxsf_fused_matmul": 3 * n,
            "mxsf_matmul": 0, "mxsf_requantize": 2 * n}


def reset_launches():
    from repro_torch.kernels import mx_matmul as MM
    from repro_torch.kernels import mxsf_attention as MA
    from repro_torch.kernels import mxsf_fused_matmul as FM
    from repro_torch.kernels import mxsf_quant as MQ
    FM.launches = MA.launches = MM.launches = 0
    for k in MQ.launches:
        MQ.launches[k] = 0


def read_launches():
    from repro_torch.kernels import mx_matmul as MM
    from repro_torch.kernels import mxsf_attention as MA
    from repro_torch.kernels import mxsf_fused_matmul as FM
    from repro_torch.kernels import mxsf_quant as MQ
    return {"mxsf_fused_matmul": FM.launches, "mxsf_attention": MA.launches,
            "mxsf_matmul": MM.launches, **MQ.launches}


def make_batches(torch, cfg, seed, steps, batch, seq, device):
    """The steps' batches from the port's ``lm_batch``, built before the
    run (the vocab^2 transition table is freed after each)."""
    from repro_torch.data.pipeline import lm_batch
    out = []
    for i in range(steps):
        toks, labs = lm_batch(seed, i, batch, seq, cfg.vocab, device=device)
        out.append({"tokens": toks, "labels": labs})
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_train(torch, device, cfg, policy, args, steps, batch, seq, label,
                profile=False):
    """``steps`` AdamW steps of ``make_train_step`` from random parameters
    (``init_state`` from ``--seed``): loss, grad norm, lr, step seconds
    (host clock, synchronised), tokens/s, peak memory and each kernel's
    launches, which must equal the path's count on the card; with
    ``profile`` one more step, logged as the others are, runs under the
    profiler (device busy time by kernel; its seconds are the profiled
    wall time).  The step updates the state in place.  Returns the
    state, the batches and the launches summed over the ``steps`` steps
    (the profiled one not among them)."""
    from repro_torch.core.packed_store import tree_leaves
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as T
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = T.init_state(gen, cfg, OptConfig(), device=device)
    profile = profile and on_card
    batches = make_batches(torch, cfg, args.seed, steps + profile, batch,
                           seq, device)
    sync()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    emit("train", layout=label, step="init", seconds=time.perf_counter() - t0,
         n_layers=cfg.n_layers, d_model=cfg.d_model, n_params=n_params,
         batch=batch, seq=seq, policy=str(policy))
    step_fn = T.make_train_step(cfg, policy, OptConfig(), T.TrainConfig())
    expect = train_launch_counts(cfg, policy)
    total = dict.fromkeys(expect, 0)
    losses = []
    _f32_steps("mxsf_matmul")
    _f32_steps("mxsf_fused_matmul")
    for i, b in enumerate(batches):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        sync()
        t0 = time.perf_counter()
        prof = None
        if i == steps:  # the extra, profiled step
            out = []
            prof = device_profile(
                torch, lambda: out.append(step_fn(state, b)))
            state, metrics = out[0]
        else:
            state, metrics = step_fn(state, b)
        sync()
        dt = (time.perf_counter() - t0 if prof is None
              else prof["wall_ms"] / 1e3)  # not the trace's processing
        got = {k: v for k, v in read_launches().items() if k in expect}
        if prof is None:
            for k in total:
                total[k] += got[k]
        loss = float(metrics["loss"])
        losses.append(loss)
        emit("train", layout=label, step=i, profiled=prof is not None,
             loss=loss,
             grad_norm=float(metrics["grad_norm"]), lr=float(metrics["lr"]),
             seconds=dt, tokens_per_s=batch * seq / dt,
             max_memory_allocated=(torch.cuda.max_memory_allocated()
                                   if on_card else None),
             launches=got, expected_launches=expect,
             f32_steps={k: _f32_steps(k) for k in ("mxsf_matmul",
                                                   "mxsf_fused_matmul")},
             **({"profile": prof} if prof else {}))
        if not math.isfinite(loss):
            raise AssertionError(f"train {label} step {i}: loss {loss}")
        if on_card and got != expect:
            raise AssertionError(f"train {label} step {i}: launches {got} "
                                 f"!= path {expect}")
    # random init: logits ~ N(0, ~1), so the first loss is ~ln(vocab) + 0.5
    if abs(losses[0] - math.log(cfg.vocab)) > 1.5:
        raise AssertionError(f"train {label}: step-0 loss {losses[0]} is "
                             f"not near ln(vocab) = {math.log(cfg.vocab)}")
    return state, batches, total


def train_rtol(k: int) -> float:
    """The train slice's matmul tolerance, of sum_k |x_k w_k|: TRAIN_SUM_C
    sqrt(K) u.  Gradient sums run over up to 32768 exact products, often
    of one sign, where two f32 orders (the kernel's and cuBLAS's) drift
    apart like a random walk of K roundings: MATMUL_RTOL is too tight at
    large K, and the worst case 2 (K - 1) u would not discriminate."""
    return TRAIN_SUM_C * math.sqrt(k) * F32_EPS


class checked_kernels:
    """Teacher-forcing hook of phases ``slice`` and ``train_slice`` (the
    package itself has no such switch).  Inside the block each call of the
    five kernel wrappers launches the kernel, whose output the path goes
    on with, and runs the plain version on the same inputs: quantize,
    requantize and emitted codes bit for bit; attention within
    ``attention_against_plain``'s tolerance; a matmul over K terms within
    ``rtol(K)`` * sum|x w| of the plain version (the products are exact:
    the summation order is the kernel's only freedom, which phase
    ``kernels`` pins down on exact-sum operands).  The last fused call
    with ``head_n`` columns keeps its plain output, tolerance and x's
    dtype in ``head``."""

    def __init__(self, torch, rtol, head_n):
        self.torch, self.rtol = torch, rtol
        self.head_n, self.head = head_n, None
        self.calls = {k: [] for k in ("mxsf_fused_matmul", "mxsf_attention",
                                      "mxsf_quantize", "mxsf_requantize",
                                      "mxsf_matmul")}

    def _matmul(self, kind, y, y_ref, xq, wq, keep=False):
        k = xq.shape[1]
        res = held_to_plain(self.torch, y, y_ref, xq, wq, keep,
                            rtol=self.rtol(k))
        res.update(k=k, over_sum=res["err_over_tol"] * self.rtol(k))
        self.calls[kind].append(res)
        return res

    def __enter__(self):
        from repro_torch.kernels import common as C
        from repro_torch.kernels import mx_matmul as MM
        from repro_torch.kernels import mxsf_attention as MA
        from repro_torch.kernels import mxsf_fused_matmul as FM
        from repro_torch.kernels import mxsf_quant as MQ
        torch, calls = self.torch, self.calls
        kq, kr = MQ.mxsf_quantize, MQ.mxsf_requantize
        km, kf, ka = MM.mxsf_matmul, FM.mxsf_fused_matmul, MA.mxsf_attention

        def same(out, want):
            return all(torch.equal(a, b) for a, b in zip(out, want))

        def quantize(x, block):
            out = kq(x, block)
            calls["mxsf_quantize"].append(dict(codes_bitwise=same(
                out, MQ.mxsf_quantize_plain(x, block))))
            return out

        def requantize(codes, scales, fb, tb, transpose=False):
            out = kr(codes, scales, fb, tb, transpose=transpose)
            calls["mxsf_requantize"].append(dict(
                transpose=transpose, codes_bitwise=same(
                    out, MQ.mxsf_requantize_plain(codes, scales, fb, tb,
                                                  transpose))))
            return out

        def matmul(xc, xs, wc, ws, xblk, wblk):
            y = km(xc, xs, wc, ws, xblk, wblk)
            kind = "mxsf_matmul"
            self._matmul(
                kind, y, MM.mxsf_matmul_plain(xc, xs, wc, ws, xblk, wblk),
                C.decode_packed(xc, xs, xblk), C.decode_packed(wc, ws, wblk))
            return y

        def fused(x, codes, scales, xblk=(1, 64), wblk=(64, 1),
                  quantize_lhs=True, emit_codes=False):
            out = kf(x, codes, scales, xblk, wblk, quantize_lhs, emit_codes)
            y = out[0] if emit_codes else out
            kind, n = "mxsf_fused_matmul", codes.shape[1]
            xq, wq = fused_operands(torch, x, codes, scales, xblk, wblk,
                                    quantize_lhs)
            res = self._matmul(
                kind, y, FM.mxsf_fused_matmul_plain(
                    x, codes, scales, xblk, wblk, quantize_lhs), xq, wq,
                keep=True)
            y_ref, tol = res.pop("y_ref"), res.pop("tol")
            if emit_codes:
                res["codes_bitwise"] = same(
                    out[1:], MQ.mxsf_quantize_plain(x, xblk))
            if n == self.head_n:
                self.head = (y_ref, tol, x.dtype)
            return out

        def attention(q, *kv_args, **args):
            out = ka(q, *kv_args, **args)
            err, ratio = attention_against_plain(torch, out, q, kv_args,
                                                 args)
            calls["mxsf_attention"].append(dict(
                max_abs_err=err, err_over_tol=ratio,
                finite=bool(torch.isfinite(out).all())))
            return out

        self.saved = [(MQ, "mxsf_quantize", kq), (MQ, "mxsf_requantize", kr),
                      (MM, "mxsf_matmul", km), (FM, "mxsf_fused_matmul", kf),
                      (MA, "mxsf_attention", ka)]
        MQ.mxsf_quantize, MQ.mxsf_requantize = quantize, requantize
        MM.mxsf_matmul, FM.mxsf_fused_matmul = matmul, fused
        MA.mxsf_attention = attention
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def rows(self, expect):
        """Per kernel: its calls against the path's count ``expect``, the
        worst tolerance ratio with its call's K, for matmuls also the worst
        error over sum|x w| in units of MATMUL_RTOL and of sqrt(K) u, and
        the codes' bitwise results; then the list of faults."""
        rows, faults = {}, []
        for kind, calls in self.calls.items():
            row = dict(calls=len(calls), expected=expect.get(kind, 0))
            if len(calls) != row["expected"]:
                faults.append(f"{kind} call count")
            if calls and "err_over_tol" in calls[0]:
                j = max(range(len(calls)),
                        key=lambda j: calls[j]["err_over_tol"])
                row.update(max_err_over_tol=calls[j]["err_over_tol"],
                           worst_call=dict(
                               i=j, k=calls[j].get("k"),
                               max_abs_err=calls[j]["max_abs_err"]),
                           finite=all(c["finite"] for c in calls))
                if row["max_err_over_tol"] > 1.0 or not row["finite"]:
                    faults.append(f"{kind} tolerance")
            if calls and "over_sum" in calls[0]:
                j = max(range(len(calls)), key=lambda j: calls[j]["over_sum"])
                row["worst_over_matmul_rtol"] = dict(
                    i=j, k=calls[j]["k"],
                    ratio=calls[j]["over_sum"] / MATMUL_RTOL)
                row["max_over_sqrt_k_u"] = max(
                    c["over_sum"] / (math.sqrt(c["k"]) * F32_EPS)
                    for c in calls)
            codes = [c["codes_bitwise"] for c in calls
                     if "codes_bitwise" in c]
            if codes:
                row["codes_bitwise"] = all(codes)
                if not all(codes):
                    faults.append(f"{kind} codes")
            rows[kind] = row
        return rows, faults


def _xent(torch, logits, labels):
    return float(torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long()))


def phase_train_slice(torch, device, cfg, policy, state, batch, label):
    """One train step teacher-forced (``checked_kernels``): every kernel
    call is held against its plain version on the same inputs, every
    matmul within ``train_rtol``; the step's loss must match the loss of
    the plain head's logits within the head's tolerance."""
    from repro_torch.core.blocking import torch_dtype
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as T
    step_fn = T.make_train_step(cfg, policy, OptConfig(), T.TrainConfig())
    t0 = time.perf_counter()
    with checked_kernels(torch, train_rtol, cfg.padded_vocab) as chk:
        _, metrics = step_fn(state, batch)
    seconds = time.perf_counter() - t0
    loss = float(metrics["loss"])
    # the loss of the plain head's logits, cast as the forward casts them
    y_ref, tol, _ = chk.head
    V = cfg.padded_vocab
    cast = torch_dtype(cfg.compute_dtype)  # mx_dot's cast of the head
    logits = y_ref[:, :V].to(cast).float()
    ulp = _bf16_ulp(torch, logits) if cast == torch.bfloat16 else 0.0
    logits = logits.reshape(*batch["labels"].shape, V)[..., :cfg.vocab]
    loss_plain = _xent(torch, logits, batch["labels"])
    # logsumexp and the gold logit each move by at most max|d logit|
    loss_tol = 2.0 * float((tol[:, :V] + ulp).max())
    rows, faults = chk.rows(train_launch_counts(cfg, policy))
    emit("train_slice", layout=label, n_layers=cfg.n_layers, loss=loss,
         loss_plain_head=loss_plain, loss_abs_err=abs(loss - loss_plain),
         loss_tol=loss_tol, seconds=seconds, kernels=rows)
    if abs(loss - loss_plain) > loss_tol:
        faults.append("loss")
    if faults:
        raise AssertionError(f"train_slice {label}: {faults}")
    return rows


def _prompts(cfg, seed, lengths):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=n).tolist() for n in lengths]


def phase_serve(torch, device, cfg, policy, args, slots, chunk, max_len,
                new_tokens, lengths):
    from repro_torch.core.packed_store import store_nbytes
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    store = M.init_packed_params(cfg, policy, gen, device=device)
    sync()
    emit("serve", step="store", seconds=time.perf_counter() - t0,
         n_layers=cfg.n_layers, store_nbytes=store_nbytes(store))
    eng = ServeEngine(cfg, store, policy, slots=slots, max_len=max_len,
                      prefill_chunk=chunk, backend="cuda", device=device)
    prompts = _prompts(cfg, args.seed, lengths)
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _f32_steps("mxsf_fused_matmul")
    t0 = time.perf_counter()
    eng.run()
    sync()
    f32_steps = _f32_steps("mxsf_fused_matmul")
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_launches().items()
                if k in ("mxsf_fused_matmul", "mxsf_attention")}
    st = eng.stats()
    dispatches = st["prefill_dispatches"] + st["decode_dispatches"]
    expect = {"mxsf_fused_matmul": (7 * cfg.n_layers + 1) * dispatches,
              "mxsf_attention": cfg.n_layers * dispatches}
    outs = [r.out for r in reqs]
    for r in reqs:
        if not r.done or len(r.out) != new_tokens or not all(
                0 <= t < cfg.vocab for t in r.out):
            raise AssertionError(f"request {r.uid}: bad output {r.out}")
    decode_tokens = st["tokens_generated"] - len(reqs)
    emit("serve", step="run", tokens=outs, prompt_lengths=lengths,
         stats=st, wall_seconds=wall,
         prefill_tokens_per_s=sum(lengths) / st["prefill_seconds"],
         decode_tokens_per_s=(decode_tokens / st["decode_seconds"]
                              if st["decode_seconds"] else None),
         max_memory_allocated=(torch.cuda.max_memory_allocated()
                               if device.type == "cuda" else None),
         launches=launches, expected_launches=expect,
         fused_f32_steps=f32_steps)
    if device.type == "cuda" and launches != expect:
        raise AssertionError(f"launch counts {launches} != path {expect}")
    if device.type == "cuda":
        profile_decode(torch, eng)
    return eng, prompts, launches


def device_profile(torch, fn):
    """Run ``fn`` once under the profiler: host wall time (synchronised),
    device busy time summed over device kernels, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}  # device kernels only: an aten op's device time is that
    for evt in prof.key_averages():  # of the kernels it launched
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            by_name[evt.key] = (dev_us, evt.count)
    busy_ms = sum(v[0] for v in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    requant = [v for k, v in by_name.items() if "requantize" in k]
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                idle_share=(1.0 - busy_ms / (wall * 1e3)) if wall else None,
                requantize=dict(device_ms=sum(v[0] for v in requant) / 1e3,
                                calls=sum(v[1] for v in requant)),
                top_kernels=[dict(name=k[:80], device_ms=v[0] / 1e3,
                                  calls=v[1]) for k, v in top])


def profile_decode(torch, eng):
    """One more decode dispatch on the final engine state under the
    profiler: device busy time by kernel name against the host wall time
    (after the launch counts were read, so it counts nowhere)."""
    toks = eng._tensor(eng.last_tok)[:, None]
    pos = eng._tensor(eng.pos)
    eng._decode(eng.params, toks, eng.cache, pos)  # warm
    emit("serve", step="profile_decode", **device_profile(
        torch, lambda: eng._decode(eng.params, toks, eng.cache, pos)))


def _cache_fault(torch, start, cache, written):
    """None if the cache changed only at the written (slot, position) rows
    and every written row of every layer holds a nonzero scale byte, else
    what went wrong.  written: (B, W) bool."""
    for name, new in cache.items():
        old = start[name]
        changed = (new != old).flatten(4).any(-1)  # (.., .., B, W)
        if bool((changed & ~written).any()):
            return f"{name} changed outside the written rows"
        if name.endswith("scales") and not bool(
                (new[:, :, written] > 0).all()):
            return f"{name}: a written row has a zero scale"
    return None


def phase_slice(torch, eng, cfg, prompts, chunk):
    """Teacher-force one prefill dispatch and two decode dispatches from
    one engine state: the path runs through the kernels and every kernel
    call is held against its plain version on the same inputs."""
    from repro_torch.core.blocking import torch_dtype
    from repro_torch.models import model as M
    dev = eng.device
    B, W = eng.slots, eng.max_len
    per_layer = 7  # fused matmuls per decoder layer: q k v o gate up down

    expect = {"mxsf_fused_matmul": per_layer * cfg.n_layers + 1,
              "mxsf_attention": cfg.n_layers}

    cache = M.init_cache(cfg, B, W, device=dev)
    toks = torch.zeros((B, chunk), dtype=torch.int64)
    nv = torch.zeros(B, dtype=torch.int64)
    for s, p in enumerate(prompts[:B]):
        n = min(chunk, len(p))
        toks[s, :n] = torch.tensor(p[:n])
        nv[s] = n
    pos = torch.zeros(B, dtype=torch.int64)
    steps = [("prefill", toks.to(dev), pos.to(dev), nv.to(dev))]
    rows = []
    for i in range(3):
        kind, t, p, n = steps[i]
        start = {k: v.clone() for k, v in cache.items()}
        with checked_kernels(torch, lambda k: MATMUL_RTOL,
                             cfg.padded_vocab) as chk:
            if kind == "prefill":
                lk = M.prefill_step(eng.params, t, cache, p, n, cfg,
                                    eng.policy)[0]
            else:
                lk = M.decode_step(eng.params, t, cache, p, cfg,
                                   eng.policy)[0]
        # the logits against the plain LM head's output on the same input,
        # cast as mx_dot's packed forward casts (one ulp more where that
        # cast rounds to bf16)
        y_ref, tol, x_dtype = chk.head
        head = eng.params["head"]
        cast = torch.promote_types(x_dtype, torch_dtype(head.dtype))
        y_ref = y_ref[:, :head.shape[-1]].to(cast).float()
        tol = tol[:, :head.shape[-1]]
        if cast == torch.bfloat16:
            tol = tol + _bf16_ulp(torch, y_ref)
        y_ref, tol = (v.reshape(B, t.shape[1], -1) for v in (y_ref, tol))
        last = (torch.clamp(n - 1, 0, t.shape[1] - 1) if kind == "prefill"
                else torch.zeros(B, dtype=torch.int64, device=dev))
        sel = torch.arange(B, device=dev)
        y_ref, tol = y_ref[sel, last], tol[sel, last]
        live = (n > 0 if kind == "prefill"
                else torch.ones(B, dtype=torch.bool, device=dev))
        real = slice(0, cfg.vocab)
        lk, lp, tol = (v[live][:, real].float() for v in (lk, y_ref, tol))
        logit_ratio = float(((lk - lp).abs() / tol).max())
        top2 = lp.topk(2, dim=-1)
        gap = top2.values[:, 0] - top2.values[:, 1]
        tk, tp = lk.argmax(-1), lp.argmax(-1)
        decided = gap > 2 * tol.max(dim=-1).values
        agree = bool((tk[decided] == tp[decided]).all())
        # the rows this step writes: pos .. pos+n-1 of each slot (ring W)
        span = n if kind == "prefill" else torch.ones_like(p)
        at = torch.arange(W, device=dev)[None, :]
        written = ((at - p[:, None]) % W) < span[:, None]
        kernels, faults = chk.rows(expect)
        row = dict(
            step=i, kind=kind, kernels=kernels,
            logits_max_abs_err=float((lk - lp).abs().max()),
            logits_err_over_tol=logit_ratio,
            max_abs_logit=float(lp.abs().max()),
            tokens_kernel=tk.tolist(), tokens_plain=tp.tolist(),
            decided=decided.tolist(), agree_where_decided=agree,
            cache_fault=_cache_fault(torch, start, cache, written))
        rows.append(row)
        emit("slice", **row)
        faults += [f for f in (logit_ratio > 1.0 and "logits tolerance",
                               not agree and "tokens", row["cache_fault"])
                   if f]
        if faults:
            raise AssertionError(f"slice step {i} ({kind}): {faults}")
        # teacher-force the kernel path's tokens into the next step
        nxt = torch.zeros(B, dtype=torch.int64, device=dev)
        nxt[live] = tk
        p_next = (p + n) if kind == "prefill" else (p + 1)
        steps.append(("decode", nxt[:, None], p_next, None))
    return rows


def kernels_line(rows, attn, train_rows, launches, slots, cfg):
    """One entry per CUDA kernel: its launches on the main paths (serving,
    2D and 1D training, each counted from 0) and the numbers of its row at
    a main-path shape."""
    mm = rows[(slots, cfg.d_model, cfg.d_ff)]
    out = []
    for name, row, src, rep in (
            ("mxsf_fused_matmul", mm, "mxsf_fused_matmul.cu",
             "src/repro/kernels/mxsf_fused_matmul.py:103"),
            ("mxsf_attention", attn[1], "mxsf_attention.cu",
             "src/repro/kernels/mxsf_attention.py:115"),
            ("mxsf_quantize", train_rows["quantize"], "mxsf_quant.cu",
             "src/repro/kernels/mxsf_quant.py:75"),
            ("mxsf_requantize", train_rows["requantize"], "mxsf_quant.cu",
             "src/repro/kernels/mxsf_quant.py:128"),
            ("mxsf_matmul", train_rows["mx_matmul"], "mx_matmul.cu",
             "src/repro/kernels/mx_matmul.py:49")):
        by_path = {path: n[name] for path, n in launches.items()
                   if name in n}
        out.append({"name": name, "route": "cuda",
                    "source": f"src/repro_torch/kernels/csrc/{src}",
                    "replaces": rep, "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"],
                    **{k: row[k] for k in ("device_ms", "bound_share",
                                           "device_bound_share", "instance")
                       if row.get(k) is not None},
                    "shape": {k: row[k] for k in row
                              if k in ("m", "k", "n", "slots", "L", "S",
                                       "block", "from_block", "to_block",
                                       "transpose", "operand")}})
    return {"kernels": out}


def free_device(torch, device):
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    if not args.cpu_rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (use --cpu-rehearsal on the CPU)",
              file=sys.stderr)
        return 2
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import MXSF_INFER, MXSF_TRAIN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rehearsal = args.cpu_rehearsal
    device = torch.device("cpu" if rehearsal else "cuda")
    cfg = get_config("qwen2.5-32b")
    if rehearsal:
        cfg = cfg.reduced()
        torch.set_num_threads(4)
    slots, chunk = 4, 16
    max_len, new_tokens = (512, 16) if not rehearsal else (64, 4)
    lengths = [37, 80, 143, 200] if not rehearsal else [5, 9, 20, 33]
    policy = MXSF_INFER.replace(kv_cache_fmt="mxsf")

    kind = phase_device(torch, rehearsal)
    if not rehearsal:
        phase_build()
    train_cfg = get_config("h2o-danube-1.8b")
    batch, seq = (4, 512) if not rehearsal else (2, 32)
    if rehearsal:
        train_cfg = train_cfg.reduced()
    rows, attn = phase_kernels(torch, device, cfg, slots, chunk, max_len,
                               args.seed)
    train_rows = phase_train_kernels(torch, device, train_cfg, batch, seq,
                                     args.seed)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    eng, prompts, serve_launches = phase_serve(
        torch, device, cfg, policy, args, slots, chunk, max_len, new_tokens,
        lengths)
    phase_slice(torch, eng, cfg, prompts, chunk)
    del eng  # the serving store (~36 GB) makes room for training
    free_device(torch, device)
    launches = {"serve": serve_launches}
    # 2D (MXSF_TRAIN) at full depth, then the 1D layout at cut depth
    pol2 = MXSF_TRAIN.replace(backend="cuda")
    state, batches, launches["train_2d"] = phase_train(
        torch, device, train_cfg, pol2, args, 3, batch, seq, "2d",
        profile=True)
    phase_train_slice(torch, device, train_cfg, pol2, state, batches[0],
                      "2d")
    del state, batches
    free_device(torch, device)
    cfg1 = train_cfg.replace(n_layers=min(4, train_cfg.n_layers))
    pol1 = pol2.replace(block_mode="1d", quantize_bwd=True)
    state, batches, launches["train_1d"] = phase_train(
        torch, device, cfg1, pol1, args, 2, batch, seq, "1d", profile=True)
    phase_train_slice(torch, device, cfg1, pol1, state, batches[0], "1d")
    del state, batches
    line = kernels_line(rows, attn, train_rows, launches, slots, cfg)
    if device.type == "cuda":
        never = [k["name"] for k in line["kernels"] if k["launches"] == 0]
        if never:
            raise AssertionError(f"kernels never launched on a main path: "
                                 f"{never}")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(RESULTS, kernels_line=line),
                                  indent=1, default=str))
    print(json.dumps(line), flush=True)
    if rehearsal:
        print("chip_smoke: CPU rehearsal done (no result line)", flush=True)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
