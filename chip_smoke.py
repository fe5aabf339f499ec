#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100 by design).

    python3 chip_smoke.py            # the card run (needs one CUDA device)
    python3 chip_smoke.py --cpu-rehearsal   # reduced config on the CPU

Phases, each printed as one JSON line:

1. device  -- ``nvidia-smi`` name and power limit, torch's device name/count.
2. build   -- ``nvcc`` for every CUDA source (in parallel) with each
              kernel's registers, shared memory and spills.
3. kernels -- each CUDA kernel against its plain PyTorch version at the
              serving path's shapes of qwen2.5-32b and their shard-local
              shapes at SHARD_TP ranks (bf16 activations, plus
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
              kernel must meet phase 3's tolerance there (a matmul of the
              exact sum of the plain version's products, computed in
              f64), so the logits match the plain head within its
              tolerance and the tokens agree wherever the plain
              top-1/top-2 gap is wider than twice it; the cache changes at
              the written rows only.
6. ckpt_serve -- the packed store of full-width qwen2.5-32b at the depth
              the host's disk and memory allow (16 of 64 layers: no
              checkpoint larger than half of either), ``ckpt.save`` of it
              and ``ServeEngine.from_checkpoint`` on the card: every leaf
              bitwise equal to the store in memory, the same prompts
              giving identical token streams on an engine over each
              store, the launch counts the path's, save and restore
              seconds and GB/s beside the disk's own rates, and the card's
              peak memory while the engine restores within the store's
              and the cache's bytes plus RESTORE_SLACK.  The checkpoint is
              removed when the phase ends.
6b. serve_sharded -- the engine on a mesh, from phase 6's checkpoint
              (removed after this phase): first a world of one rank in this
              process on NCCL, ``ServeEngine.from_checkpoint(mesh=
              make_test_mesh(1, 1))`` giving phase 6's token streams bit for
              bit, its launches and collectives (NCCL) against their
              formulas; then the same engine teacher-forced on those streams
              with every fused matmul on its plain version (a pure f32
              reorder: how far that moves the logits calibrates the next
              step), ``make_compressed_allreduce`` over a gradient-sized tree
              equal to ``blocking.qdq`` of it bit for bit, and a one-stage
              ``pipeline_apply`` against the sequential run.  Then SHARD_TP
              ranks sharing the card on a (1, SHARD_TP) mesh, each a process
              started after the build, over gloo (NCCL refuses two ranks on
              one device; collectives go through host memory): each restores
              only its slices (store bytes equal to ``MeshRules``'
              prediction, restore peak within store + cache +
              RESTORE_SLACK), holds every kernel call of its first dispatch
              against the plain version at its shard-local shape (column-
              parallel N / tp, row-parallel K / tp, 20 / 4 heads), serves the
              prompts teacher-forced on phase 6's streams (each step's logits
              within REORDER_FACTOR times the baseline's largest move,
              which may not pass REORDER_CEILING on the card; the top-1
              equal wherever phase 6's top-1/top-2 gap exceeds twice that),
              launches and collectives against their formulas; rank 0
              profiles one decode dispatch (idle share, collectives' share).
              A rank that fails or outlives SHARD_WAIT_S fails the phase.
7. train   -- full-width h2o-danube-1.8b, all 24 layers, on the card:
              ``init_state`` from ``--seed``, batches from ``lm_batch``
              (4 x 512), ``make_train_step(MXSF_TRAIN, backend="cuda")``
              under the default remat ``"dots"`` for 3 steps, then a
              fourth under the profiler: loss, grad
              norm, lr, step seconds (host clock, synchronised), tokens/s,
              peak memory, each kernel's launches, which must equal the
              path's count, and the K steps the matmul kernels sent down
              their f32 path; after phase 8's 2D slice one more step of
              the same state at remat ``"none"``.  Then the 1D
              layout (``block_mode="1d"``, ``quantize_bwd=True``) at the
              same width with the depth cut to 4 layers, for 2 steps and
              a third under the profiler (with the requantizer's summed
              device time).
8. train_slice -- one more train step of each layout (on the state the
              phase "train" left, with its first batch) teacher-forced:
              every quantize and requantize call (plain or transposed)
              and every set of emitted codes bit for bit against its plain
              version on the same
              inputs, every matmul call within ``train_rtol(K)`` =
              TRAIN_SUM_C sqrt(K) 2^-24 of sum|x w| of the exact sum of
              the plain version's products (the plain f32 version's own
              distance from it printed beside), and the loss within the
              head's tolerance of the loss of the plain head's logits.
9. serve_gemma2 -- gemma2-9b at full width and all 42 layers (softcaps,
              alternating 4096-token SWA: the value-domain cached
              attention): one packed store (~13 GB) shared by two
              ``ServeEngine``s of ``MXSF_INFER`` on the kernel datapath,
              the policy's bf16 value cache and the packed MXSF cache
              (dequantized into the value path), 2 slots x max_len 4352,
              chunk 256, prompts of 4200 (past the window) and 37 tokens,
              16 new tokens each: tokens/s, peak memory, store and cache
              bytes, launches equal to the path's (no attention kernel),
              a profiled decode dispatch; then the value-cache engine's
              first prefill and two decode dispatches teacher-forced as in
              ``slice``.
10. ring_swa -- h2o-danube-1.8b at full width and all 24 layers on the
              all-SWA ring cache: ``init_cache(ring=True)`` at max_len
              8192 holds W = 4096 columns; 17 window-aligned prefill
              chunks of 256 over 2 slots (the last writes ring columns
              0-255 again), then 8 decode steps: finite logits, launches,
              tokens/s, a profiled decode dispatch; the first and last
              dispatch teacher-forced.
11. serve_moe -- qwen2-moe-a2.7b at full width, experts in f32 values,
              at the depth the card's free memory allows (printed):
              ``MXSF_INFER`` with the packed MXSF cache, 4 slots, max_len
              256, prompts of 8-24 tokens, 8 new tokens, token by token;
              tokens/s, peak memory, launches equal to the path's, a
              profiled decode dispatch, and the first dispatch teacher-
              forced with the assignments each MoE layer dropped past
              its capacity.
12. train_resume -- ``fault.train_loop`` on 2 layers of full-width
              h2o-danube-1.8b (2D, 4 x 512): 4 steps checkpointing every
              2, uninterrupted; again with a failure injected at step 3
              (``FailureInjected`` caught, and it must be raised) and
              resumed; params and the whole AdamW state bitwise equal
              between the two runs, the watchdog's step times printed.
13. train_encoder -- full deit-tiny (12 layers, 196 patches + cls, 100
              classes) at batch 64 from ``vision_batch``, in 2D and in the
              1D layout: 3 steps, one more under the profiler (device idle
              share) and one teacher-forced as in ``train_slice``; loss,
              accuracy, step seconds, tokens/s, peak memory, launch
              counts equal to the path's.
14. serve_ssm, serve_hybrid, serve_encdec, serve_vlm -- the other
              families at full width on ``--seed`` weights: mamba2-780m
              (48 SSD layers, 4 x 256-token prompts, 32 decode steps),
              zamba2-7b (81 SSD layers and 13 applications of the shared
              attention block over the packed cache, 2 x 256, 16 steps),
              whisper-medium (24 + 24 layers, 1500 bf16 frames through
              ``prefill``, a 4-token prompt fed by ``decode_step``, 16 new
              tokens) and internvl2-1b (256 patch embeddings and a
              64-token prompt through ``prefill``, 16 steps, then the
              text-only engine on the same store).  Each first holds the
              fused matmul at its widest linear and the attention kernel
              at its head shape against their plain versions, then
              prints store and cache bytes, tokens/s, peak memory, the
              launches (equal to the path's), a profiled decode step, and
              its first prefill and decode step teacher-forced as in
              ``slice``.
15. train_families -- ``MXSF_TRAIN`` (2D, remat ``"dots"``), 2 steps and
              one profiled, of mamba2-780m (4 x 512), whisper-medium (2 x
              448 over 1500 frames), internvl2-1b (4 x 512 behind its
              256-embedding prefix) and zamba2-7b at 12 of its 81 layers
              (printed), with launches equal to the path's; then one
              step of each teacher-forced as in ``train_slice``, and for
              mamba2-780m and whisper-medium two more steps at remat
              ``"none"`` (peak and seconds beside ``"dots"``').
16. dryrun -- ``launch/dryrun.py`` traces, on ``meta`` tensors with the
              kernel datapath, phase 7's training shape (h2o-danube-1.8b,
              4 x 512, 2D, remat ``"dots"``) and the decode cells that may
              fit one card (decode_32k and long_500k of h2o-danube-1.8b
              and mamba2-780m, decode_32k of internvl2-1b, long_500k of
              zamba2-7b; packed MXSF cache), in worker processes started
              after the build, which keep off the card and trace while
              the card phases run.  Each cell the trace says fits then
              runs one real step of the same program on the card from
              ``--seed`` inputs: argument bytes equal to the allocator's
              requested bytes after the inputs are built, exactly; each
              kernel's launches equal to the trace's; measured peak
              memory beside the predicted one with their ratio; step
              seconds no less than the roofline's; finite outputs.
17. examples -- each ``examples/torch_*.py`` once as a subprocess on the
              card at a small size: exit 0 and its key lines printed.
18. the ``kernels`` line (every CUDA kernel, its launches on each path,
   each counted from 0), then the ``{"ok": true, ...}`` line.

Phases 9-11 and 14 run right after phase 6, phase 15 after phase 13,
phases 16-17 last, and a ``done`` line with the whole run's seconds comes
before the ``kernels`` line.

Any failure raises, so the run exits non-zero and prints no ok line.  The
rehearsal runs the same phases on the CPU at the reduced config (the
kernels' plain versions, no build, no launch counts) and prints no ok line.
``--out FILE`` also writes every phase's results to FILE as one JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MATMUL_RTOL = 1e-5      # of sum_k |x_k w_k|: f32 summation order only
TRAIN_SUM_C = 4.0       # train_rtol's multiple of sqrt(K) u: twice the
                        # worst measured on the H100 (1.55, head's dx)
F32_EPS = 2.0 ** -24    # f32 unit roundoff
ATTN_ATOL = 1e-5        # of max|v|: f32 summation order and expf

RESULTS: dict = {}
T_START = time.perf_counter()  # "at" of each printed line: seconds since
# the script started


def emit(phase: str, **fields):
    RESULTS.setdefault(phase, []).append(fields)
    print(json.dumps({"phase": phase, **fields,
                      "at": round(time.perf_counter() - T_START, 1)},
                     default=str), flush=True)


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


def check_matmul(torch, timer, gen, device, m, k, n, edge=False, **fields):
    from repro_torch.launch import cost
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
               **fields, max_abs_err=res["max_abs_err"],
               err_over_tol=res["err_over_tol"], f32_steps=f32_steps)
    if not edge:
        row.update(fused_exact_sum(torch, gen, device, m, k, n))
        w_lib = B.dequantize(B.QuantizedTensor(
            codes, scales, "mxsf", (64, 1), tuple(codes.shape),
            "bfloat16"))[:k]  # K short of a block: the padded rows drop
        row["ms"] = timer(lambda: FM.mxsf_fused_matmul(x, codes, scales), 10)
        row["plain_ms"] = timer(
            lambda: FM.mxsf_fused_matmul_plain(x, codes, scales), 3, 1)
        row["library_ms"] = timer(lambda: torch.matmul(x, w_lib), 10)
        row["bound_ms"], row["bound_by"] = cost.bound_ms(
            cost.fused_matmul_work(m, k, codes.shape[0], n,
                                   x.element_size()))
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
    from repro_torch.launch import cost
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
    row["bound_ms"], row["bound_by"] = cost.bound_ms(cost.attention_work(
        sum(rows_needed), kv, dh, q.numel(), q.element_size(),
        float(vis.sum())))
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
    # phase serve_sharded's shard-local shapes (SHARD_TP ranks on the
    # model axis): column-parallel N / tp, row-parallel K / tp
    for m in (slots, slots * chunk):
        for k, n in shard_local_shapes(cfg):
            if (m, k, n) not in rows:
                rows[(m, k, n)] = check_matmul(torch, timer, gen, device, m,
                                               k, n, shard=f"tp{SHARD_TP}")
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
    from repro_torch.launch import cost
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
    row["bound_ms"], row["bound_by"] = cost.bound_ms(
        cost.quantize_work(m, k, block, x.element_size()))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    emit("kernels", **row)
    return row, got


def check_requantize(torch, timer, codes, scales, fb, tb, name, edge=None,
                     transpose=False):
    """Requantize kernel against its plain version, bit for bit (codes and
    scales, plain or transposed), on the operand and on the edge blocks;
    times at the operand's shape (event ms, device ms)."""
    from repro_torch.launch import cost
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
    row["bound_ms"], row["bound_by"] = cost.bound_ms(
        cost.requantize_work(m, k, fb, tb))
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
    from repro_torch.launch import cost
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
    row["bound_ms"], row["bound_by"] = cost.bound_ms(
        cost.mx_matmul_work(m, k, n, blk, blk))
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
    from repro_torch.launch import cost
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
    row["bound_ms"], row["bound_by"] = cost.bound_ms(cost.fused_matmul_work(
        m, k, codes.shape[0], n, x.element_size(), xblk, wblk, quantize_lhs,
        emit_codes))
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

def stack_linears(cfg):
    """The linears of one pass over the model's layers, from the path, by
    kind: ``ssd`` the in_proj and out_proj of each SSD layer; ``attn`` the
    self-attention sublayers (q, k, v, o each; a hybrid's one shared block
    counted at each application); ``mlp`` the packed MLP linears (3 gated
    or 2 for each dense sublayer, and an MoE sublayer's shared expert:
    routed experts run in values); ``enc`` the encoder's linears of an
    encoder-decoder; ``cross`` its decoder's cross-attention sublayers
    (q, k, v, o in training; q and o against the cached K/V in decoding).
    Training, serving and prefill counts all derive from this."""
    from repro_torch.models.transformer import hybrid_split, is_moe_sublayer
    mlp = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    L = cfg.n_layers
    if cfg.family == "ssm":
        return dict(ssd=2 * L, attn=0, mlp=0, enc=0, cross=0)
    if cfg.family == "hybrid":
        G = hybrid_split(cfg)[0]
        return dict(ssd=2 * L, attn=G, mlp=mlp * G, enc=0, cross=0)
    if cfg.family == "encdec":
        return dict(ssd=0, attn=L, mlp=mlp * L,
                    enc=cfg.n_enc_layers * (4 + mlp), cross=L)
    dense = sum(not is_moe_sublayer(cfg, i % cfg.moe_every)
                or cfg.n_shared_experts > 0 for i in range(L))
    return dict(ssd=0, attn=L, mlp=mlp * dense, enc=0, cross=0)


def layer_matmuls(cfg):
    """Raw-weight ``mx_dot`` calls of one training forward inside the
    layers (each a remat region): every linear of ``stack_linears``, the
    cross-attention's K/V projection among them."""
    n = stack_linears(cfg)
    return n["ssd"] + 4 * n["attn"] + n["mlp"] + n["enc"] + 4 * n["cross"]


def train_launch_counts(cfg, policy, remat="dots"):
    """Kernel launches of one train step, from the path: the layers' raw-
    weight mx_dots (``layer_matmuls``) plus the head (once: the LM head's
    S <= xent_chunk; the encoder's on the cls row), each with its
    backward.  Remat ``"dots"`` recomputes each layer's forward but its
    matmuls: x and w of each layer matmul are quantized again;
    ``"full"`` runs the layers' forward again."""
    nl = layer_matmuls(cfg)
    n = nl + 1
    redo_q, redo_f = {"none": (0, 0), "dots": (2 * nl, 0),
                      "full": (nl, nl)}[remat]
    if policy.block_mode == "2d":
        # w and g quantized; the fused forward emits x's codes; dx and dw
        return {"mxsf_quantize": 2 * n + redo_q,
                "mxsf_fused_matmul": n + redo_f,
                "mxsf_matmul": 2 * n, "mxsf_requantize": 0}
    # 1d: w quantized; forward, dx and dw fused; w and x re-blocked
    return {"mxsf_quantize": n + redo_q, "mxsf_fused_matmul": 3 * n + redo_f,
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


LM_TABLE_MAX = 16 << 30  # bytes of lm_batch's f32 vocab^2 table


def lm_source(cfg):
    """``lm_batch`` where its vocab x vocab f32 transition table fits
    LM_TABLE_MAX (h2o-danube's 32000: 4.1 GB), else uniform tokens from a
    seeded generator (internvl2's 151655 would need 92 GB, in either
    package's pipeline)."""
    return ("lm_batch" if 4 * cfg.vocab ** 2 <= LM_TABLE_MAX
            else "uniform")


def _stub(torch, device, seed, shape, scale):
    """Seeded bf16 N(0, scale^2) values: the stubbed frontends' frames
    and patch embeddings."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=device)
            * scale).to(torch.bfloat16)


def make_batches(torch, cfg, seed, steps, batch, seq, device):
    """The steps' batches from the port's ``lm_batch`` (the vocab^2
    transition table is freed after each) or uniform tokens
    (``lm_source``) -- with seeded bf16 frames for an encoder-decoder and
    patch embeddings (std 0.02, the token embeddings' scale) for a VLM,
    the stubbed frontends' outputs -- or, for the encoder,
    ``vision_batch``, built before the run."""
    from repro_torch.data.pipeline import lm_batch, vision_batch
    out = []
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    for i in range(steps):
        if cfg.family == "encoder":
            x, y = vision_batch(seed, i, batch, cfg.frontend_tokens,
                                cfg.d_model, cfg.n_classes, device=device)
            out.append({"embeds": x, "label": y})
            continue
        if lm_source(cfg) == "lm_batch":
            toks, labs = lm_batch(seed, i, batch, seq, cfg.vocab,
                                  device=device)
        else:
            walk = torch.randint(0, cfg.vocab, (batch, seq + 1),
                                 generator=gen, device=device,
                                 dtype=torch.int32)
            toks, labs = walk[:, :seq], walk[:, 1:]
        out.append({"tokens": toks, "labels": labs})
        if cfg.family == "encdec":
            out[-1]["frames"] = _stub(torch, device, seed + 100 + i,
                                      (batch, cfg.enc_seq, cfg.d_model), 1.0)
        elif cfg.frontend_tokens:
            out[-1]["embeds"] = _stub(
                torch, device, seed + 100 + i,
                (batch, cfg.frontend_tokens, cfg.d_model), 0.02)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def n_out(cfg):
    """The head's real outputs: classes of the encoder, else the vocab."""
    return cfg.n_classes if cfg.family == "encoder" else cfg.vocab


def phase_train(torch, device, cfg, policy, args, steps, batch, seq, label,
                profile=False, phase="train", remat="dots", state=None,
                batches=None):
    """``steps`` AdamW steps of ``make_train_step`` from random parameters
    (``init_state`` from ``--seed``): loss (and the encoder's accuracy),
    grad norm, lr, step seconds (host clock, synchronised), tokens/s
    (``seq`` tokens a sample), peak memory and each kernel's launches,
    which must equal the path's count on the card; with ``profile`` one
    more step, logged as the others are, runs under the profiler (device
    busy time by kernel; its seconds are the profiled wall time).  The
    step updates the state in place; ``state`` and ``batches`` continue an
    earlier run (another remat on the same state).  Returns the state, the
    batches and the launches summed over the ``steps`` steps (the profiled
    one not among them)."""
    from repro_torch.core.packed_store import tree_leaves
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as T
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    profile = profile and on_card
    fresh = state is None
    if fresh:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state = T.init_state(gen, cfg, OptConfig(), device=device)
        batches = make_batches(torch, cfg, args.seed, steps + profile, batch,
                               seq, device)
    sync()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    emit(phase, layout=label, step="init", seconds=time.perf_counter() - t0,
         family=cfg.family, n_layers=cfg.n_layers, d_model=cfg.d_model,
         n_params=n_params, batch=batch, seq=seq, remat=remat,
         data=(None if cfg.family == "encoder" else lm_source(cfg)),
         policy=str(policy))
    step_fn = T.make_train_step(cfg, policy, OptConfig(),
                                T.TrainConfig(remat=remat))
    expect = train_launch_counts(cfg, policy, remat)
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
        emit(phase, layout=label, step=i, profiled=prof is not None,
             remat=remat, loss=loss, **({"acc": float(metrics["acc"])}
                          if "acc" in metrics else {}),
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
    # random init: logits ~ N(0, <= 1), so the first loss is within ~0.5
    # of ln(outputs) (a continued state has trained already)
    if fresh and abs(losses[0] - math.log(n_out(cfg))) > 1.5:
        raise AssertionError(f"train {label}: step-0 loss {losses[0]} is "
                             f"not near ln({n_out(cfg)})")
    return state, batches, total


def train_rtol(k: int) -> float:
    """The train slice's matmul tolerance, of sum_k |x_k w_k|: TRAIN_SUM_C
    sqrt(K) u.  Gradient sums run over up to 32768 exact products, often
    of one sign, where an f32 order drifts from the exact sum like a
    random walk of K roundings: MATMUL_RTOL is too tight at large K, and
    the worst case 2 (K - 1) u would not discriminate."""
    return TRAIN_SUM_C * math.sqrt(k) * F32_EPS


class checked_kernels:
    """Teacher-forcing hook of phases ``slice`` and ``train_slice`` (the
    package itself has no such switch).  Inside the block each call of the
    five kernel wrappers launches the kernel, whose output the path goes
    on with, and runs the plain version on the same inputs: quantize,
    requantize and emitted codes bit for bit; attention within
    ``attention_against_plain``'s tolerance; a matmul over K terms within
    ``rtol(K)`` * sum|x w| of the exact sum of the plain version's
    products (its decoded operands multiplied in f64; the products are
    exact in f32 too, so the summation order is the kernel's only
    freedom, which phase ``kernels`` pins down on exact-sum operands).
    The plain f32 version's own distance from that sum is printed beside
    (``plain_max_err_over_tol``), not gated: cuBLAS's f32 order is no
    better a sum than the kernel's (on whisper-medium's head dw, K = 896,
    one dominant product and ~900 small ones of one sign, it is 2.5x
    ``train_rtol(K)`` from the exact sum where the kernel's two-level sum
    is 0.1x).  The last fused call with ``head_n`` columns keeps the exact
    output, tolerance and x's dtype in ``head``."""

    def __init__(self, torch, rtol, head_n):
        self.torch, self.rtol = torch, rtol
        self.head_n, self.head = head_n, None
        self.calls = {k: [] for k in ("mxsf_fused_matmul", "mxsf_attention",
                                      "mxsf_quantize", "mxsf_requantize",
                                      "mxsf_matmul")}

    def _matmul(self, kind, y, y_plain, xq, wq, keep=False):
        k, torch = xq.shape[1], self.torch
        exact = torch.matmul(xq.double(), wq.double())
        res = held_to_plain(torch, y, exact, xq, wq, keep, rtol=self.rtol(k))
        plain = held_to_plain(torch, y_plain, exact, xq, wq,
                              rtol=self.rtol(k))
        res.update(k=k, over_sum=res["err_over_tol"] * self.rtol(k),
                   plain_err_over_tol=plain["err_over_tol"])
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
            res.update(m=x.shape[0], n=n)
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
            b, kv = kv_args[0].shape[0], kv_args[0].shape[-2]
            calls["mxsf_attention"].append(dict(
                max_abs_err=err, err_over_tol=ratio, heads=q.shape[0] // b,
                kv_heads=kv, finite=bool(torch.isfinite(out).all())))
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
            if calls and "plain_err_over_tol" in calls[0]:
                row["plain_max_err_over_tol"] = max(
                    c["plain_err_over_tol"] for c in calls)
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


def phase_train_slice(torch, device, cfg, policy, state, batch, label,
                      phase="train_slice"):
    """One train step teacher-forced (``checked_kernels``): every kernel
    call is held against its plain version on the same inputs, every
    matmul within ``train_rtol``; the step's loss must match the loss of
    the plain head's logits within the head's tolerance."""
    from repro_torch.core.blocking import torch_dtype
    from repro_torch.models.transformer import head_shape
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as T
    step_fn = T.make_train_step(cfg, policy, OptConfig(), T.TrainConfig())
    from repro_torch.core.packed_store import weight_block
    V = head_shape(cfg)[1]
    wb = weight_block(policy)[1]  # the head's codes are padded to it
    t0 = time.perf_counter()
    with checked_kernels(torch, train_rtol, -(-V // wb) * wb) as chk:
        _, metrics = step_fn(state, batch)
    seconds = time.perf_counter() - t0
    loss = float(metrics["loss"])
    # the loss of the plain head's logits, cast as the forward casts them
    y_ref, tol, _ = chk.head
    cast = torch_dtype(cfg.compute_dtype)  # mx_dot's cast of the head
    logits = y_ref[:, :V].to(cast).float()
    ulp = _bf16_ulp(torch, logits) if cast == torch.bfloat16 else 0.0
    labels = batch["label" if cfg.family == "encoder" else "labels"]
    logits = logits.reshape(*labels.shape, V)[..., :n_out(cfg)]
    loss_plain = _xent(torch, logits, labels)
    # logsumexp and the gold logit each move by at most max|d logit|
    loss_tol = 2.0 * float((tol[:, :V] + ulp).max())
    rows, faults = chk.rows(train_launch_counts(cfg, policy))
    emit(phase, layout=label, n_layers=cfg.n_layers, loss=loss,
         loss_plain_head=loss_plain, loss_abs_err=abs(loss - loss_plain),
         loss_tol=loss_tol, seconds=seconds, kernels=rows)
    if abs(loss - loss_plain) > loss_tol:
        faults.append("loss")
    if faults:
        raise AssertionError(f"{phase} {label}: {faults}")
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
    _, launches = serve_run(torch, eng, cfg, prompts, new_tokens, "serve")
    if device.type == "cuda":
        profile_decode(torch, eng)
    return eng, prompts, launches


def serve_launch_counts(cfg, attn_backend):
    """Fused-matmul and attention launches of one decoder dispatch
    (``family_launch_counts``' decode count without the quantizer)."""
    n = family_launch_counts(cfg, attn_backend)
    return {k: n[k] for k in ("mxsf_fused_matmul", "mxsf_attention")}


def serve_run(torch, eng, cfg, prompts, new_tokens, phase, **fields):
    """Serve ``prompts`` on ``eng`` to the end: tokens, stats, host-clock
    tokens/s, peak memory and the serving kernels' launches, which must
    equal the path's count on the card.  Returns (token streams,
    launches)."""
    on_card = eng.device.type == "cuda"
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _f32_steps("mxsf_fused_matmul")
    t0 = time.perf_counter()
    eng.run()
    if on_card:
        torch.cuda.synchronize()
    f32_steps = _f32_steps("mxsf_fused_matmul")
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_launches().items()
                if k in ("mxsf_fused_matmul", "mxsf_attention")}
    st = eng.stats()
    dispatches = st["prefill_dispatches"] + st["decode_dispatches"]
    expect = {k: v * dispatches for k, v in
              serve_launch_counts(cfg, eng.attn_backend).items()}
    outs = [r.out for r in reqs]
    for r in reqs:
        if not r.done or len(r.out) != new_tokens or not all(
                0 <= t < cfg.vocab for t in r.out):
            raise AssertionError(f"request {r.uid}: bad output {r.out}")
    decode_tokens = st["tokens_generated"] - len(reqs)
    lengths = [len(p) for p in prompts]
    emit(phase, step="run", tokens=outs, prompt_lengths=lengths,
         stats=st, wall_seconds=wall,
         prefill_tokens_per_s=sum(lengths) / st["prefill_seconds"],
         decode_tokens_per_s=(decode_tokens / st["decode_seconds"]
                              if st["decode_seconds"] else None),
         max_memory_allocated=(torch.cuda.max_memory_allocated()
                               if on_card else None),
         launches=launches, expected_launches=expect,
         fused_f32_steps=f32_steps, **fields)
    if on_card and launches != expect:
        raise AssertionError(f"{phase}: launch counts {launches} != path "
                             f"{expect}")
    return outs, launches


def device_profile(torch, fn, ranges=()):
    """Run ``fn`` once under the profiler: host wall time (synchronised),
    device busy time summed over device kernels, and the top kernels.
    ``ranges``: (module, function name) pairs wrapped in a profiler range
    of that name for the run, each reported with the device time of the
    kernels launched inside it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    saved = [(mod, name, getattr(mod, name)) for mod, name in ranges]

    def ranged(name, fn):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    torch.cuda.synchronize()
    try:
        for mod, name, orig in saved:
            setattr(mod, name, ranged(name, orig))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    labels = {name for _, name, _ in saved}
    by_name = {}  # device kernels only: an aten op's device time is that
    for evt in prof.key_averages():  # of the kernels it launched
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        if evt.key in labels:  # a range's span on the device timeline
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            by_name[evt.key] = (dev_us, evt.count)
    busy_ms = sum(v[0] for v in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    requant = [v for k, v in by_name.items() if "requantize" in k]
    in_ranges = {}  # each range's host event: the kernels launched in it
    for evt in prof.events():
        if evt.name in labels and not str(evt.device_type).endswith("CUDA"):
            ms, n = in_ranges.get(evt.name, (0.0, 0))
            in_ranges[evt.name] = (ms + evt.device_time_total / 1e3, n + 1)
    in_ranges = {k: dict(device_ms=ms, calls=n,
                         share_of_busy=ms / busy_ms if busy_ms else None)
                 for k, (ms, n) in in_ranges.items()}
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                ranges=in_ranges,
                idle_share=(1.0 - busy_ms / (wall * 1e3)) if wall else None,
                requantize=dict(device_ms=sum(v[0] for v in requant) / 1e3,
                                calls=sum(v[1] for v in requant)),
                top_kernels=[dict(name=k[:80], device_ms=v[0] / 1e3,
                                  calls=v[1]) for k, v in top])


def profile_decode(torch, eng, phase="serve", **fields):
    """One more decode dispatch on the final engine state under the
    profiler (after the launch counts were read, so it counts nowhere):
    ``profile_dispatch``."""
    toks = eng._tensor(eng.last_tok)[:, None]
    pos = eng._tensor(eng.pos)
    return profile_dispatch(
        torch, lambda: eng._decode(eng.params, toks, eng.cache, pos),
        phase, **fields)


def profile_dispatch(torch, fn, phase, **fields):
    """``fn`` (one dispatch) once to warm, then once under the profiler:
    device busy time by kernel name against the host wall time, and the
    device time of the value path's MX quantize-dequantize (``_qdq``:
    attention operands, routed experts) and of the packed cache's
    dequantize."""
    from repro_torch.core import blocking, mx_dot
    fn()
    prof = device_profile(torch, fn, ranges=((mx_dot, "_qdq"),
                                             (blocking, "dequantize")))
    emit(phase, step="profile_decode", **fields, **prof)
    return prof


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


def logits_against_plain(torch, chk, head, cfg, lk, S, last, live):
    """The kernel path's logits ``lk`` (B, vocab) against the plain LM
    head's output on the same input (``chk.head``: all B x S rows; row
    ``last`` (B,) of each slot is the one returned), cast as mx_dot's
    packed forward casts (one ulp more where that cast rounds to bf16);
    the final softcap is 1-Lipschitz, so it keeps the tolerance.  Only
    the ``live`` slots count.  Returns (fields, faults, kernel tokens of
    the live slots)."""
    from repro_torch.core.blocking import torch_dtype
    B, dev = lk.shape[0], lk.device
    y_ref, tol, x_dtype = chk.head
    cast = torch.promote_types(x_dtype, torch_dtype(head.dtype))
    y_ref = y_ref[:, :head.shape[-1]].to(cast).float()
    tol = tol[:, :head.shape[-1]]
    if cast == torch.bfloat16:
        tol = tol + _bf16_ulp(torch, y_ref)
    if cfg.final_softcap:
        y_ref = cfg.final_softcap * torch.tanh(y_ref / cfg.final_softcap)
    y_ref, tol = (v.reshape(B, S, -1) for v in (y_ref, tol))
    sel = torch.arange(B, device=dev)
    y_ref, tol = y_ref[sel, last], tol[sel, last]
    real = slice(0, cfg.vocab)
    lk, lp, tol = (v[live][:, real].float() for v in (lk, y_ref, tol))
    logit_ratio = float(((lk - lp).abs() / tol).max())
    top2 = lp.topk(2, dim=-1)
    gap = top2.values[:, 0] - top2.values[:, 1]
    tk, tp = lk.argmax(-1), lp.argmax(-1)
    decided = gap > 2 * tol.max(dim=-1).values
    agree = bool((tk[decided] == tp[decided]).all())
    fields = dict(logits_max_abs_err=float((lk - lp).abs().max()),
                  logits_err_over_tol=logit_ratio,
                  max_abs_logit=float(lp.abs().max()),
                  tokens_kernel=tk.tolist(), tokens_plain=tp.tolist(),
                  decided=decided.tolist(), agree_where_decided=agree)
    faults = [f for f in (logit_ratio > 1.0 and "logits tolerance",
                          not agree and "tokens") if f]
    return fields, faults, tk


def checked_dispatch(torch, params, cfg, policy, kind, t, cache, p, n,
                     expect, phase, **fields):
    """One dispatch (``prefill_step`` with ``n`` valid tokens, or
    ``decode_step``) through the kernels with every kernel call teacher-
    forced (``checked_kernels``): each call meets phase 3's tolerance
    against its plain version on its inputs, so the logits match the
    plain head's within its tolerance and the tokens agree wherever the
    plain top-1/top-2 gap is wider than twice it
    (``logits_against_plain``); the cache changes at the written rows
    only; each kernel's calls equal ``expect``.  Updates ``cache`` in
    place; returns (row, kernel tokens)."""
    from repro_torch.models import model as M
    dev = t.device
    B, W = t.shape[0], next(iter(cache.values())).shape[3]
    start = {k: v.clone() for k, v in cache.items()}
    with checked_kernels(torch, lambda k: MATMUL_RTOL,
                         cfg.padded_vocab) as chk:
        if kind == "prefill":
            lk = M.prefill_step(params, t, cache, p, n, cfg, policy)[0]
        else:
            lk = M.decode_step(params, t, cache, p, cfg, policy)[0]
    last = (torch.clamp(n - 1, 0, t.shape[1] - 1) if kind == "prefill"
            else torch.zeros(B, dtype=torch.int64, device=dev))
    live = (n > 0 if kind == "prefill"
            else torch.ones(B, dtype=torch.bool, device=dev))
    logit_fields, faults, tk = logits_against_plain(
        torch, chk, params["head"], cfg, lk, t.shape[1], last, live)
    # the rows this step writes: pos .. pos+n-1 of each slot (ring W)
    span = n if kind == "prefill" else torch.ones_like(p)
    at = torch.arange(W, device=dev)[None, :]
    written = ((at - p[:, None]) % W) < span[:, None]
    kernels, kernel_faults = chk.rows(expect)
    row = dict(kind=kind, **fields, kernels=kernels, **logit_fields,
               cache_fault=_cache_fault(torch, start, cache, written))
    emit(phase, **row)
    faults = kernel_faults + faults + [f for f in (row["cache_fault"],) if f]
    if faults:
        raise AssertionError(f"{phase} {fields} ({kind}): {faults}")
    nxt = torch.zeros(B, dtype=torch.int64, device=dev)
    nxt[live] = tk
    return row, nxt


def phase_slice(torch, eng, cfg, prompts, chunk, phase="slice"):
    """Teacher-force one prefill dispatch and two decode dispatches from
    one engine state (a fresh cache of the engine's kind): the path runs
    through the kernels and every kernel call is held against its plain
    version on the same inputs (``checked_dispatch``)."""
    from repro_torch.core.blocking import torch_dtype
    from repro_torch.models import model as M
    dev = eng.device
    B, W = eng.slots, eng.max_len
    expect = serve_launch_counts(cfg, eng.attn_backend)
    cache = M.init_cache(cfg, B, W, dtype=torch_dtype(cfg.compute_dtype),
                         ring=False, kv_fmt=eng.policy.kv_cache_fmt,
                         device=dev)
    toks = torch.zeros((B, chunk), dtype=torch.int64)
    nv = torch.zeros(B, dtype=torch.int64)
    for s, p in enumerate(prompts[:B]):
        n = min(chunk, len(p))
        toks[s, :n] = torch.tensor(p[:n])
        nv[s] = n
    step = ("prefill", toks.to(dev), torch.zeros(B, dtype=torch.int64,
                                                 device=dev), nv.to(dev))
    rows = []
    for i in range(3):
        kind, t, p, n = step
        row, nxt = checked_dispatch(torch, eng.params, cfg, eng.policy,
                                    kind, t, cache, p, n, expect, phase,
                                    step=i)
        rows.append(row)
        # teacher-force the kernel path's tokens into the next step
        step = ("decode", nxt[:, None], (p + n) if kind == "prefill"
                else (p + 1), None)
    return rows


# ---------------------------------------------------------------------------
# checkpoints: the packed store round trip ("ckpt_serve") and the
# fault-tolerant loop ("train_resume")
# ---------------------------------------------------------------------------

def tap_emits(eng, cfg, teacher=None):
    """This script's hook on an engine (as ``checked_kernels`` is on the
    kernels): each token the engine emits keeps the logits row it was
    sampled from (the real vocab, f32, on the host) and the engine's own
    choice, keyed (request uid, token index).  With ``teacher`` ({uid:
    token stream}) the engine emits those tokens instead of its own
    (teacher forcing), so its later dispatches see the same inputs as the
    run that produced them.  Returns (rows, choices)."""
    rows, choices, last = {}, {}, {}
    sample, emit_token = eng.sampler, eng._emit

    def sampler(logits):
        last["logits"] = logits
        return sample(logits)

    def _emit(s, tok, done):
        req = eng.live[s]
        key = (req.uid, len(req.out))
        rows[key] = last["logits"][s, :cfg.vocab].float().cpu()
        choices[key] = tok
        emit_token(s, tok if teacher is None else teacher[req.uid][key[1]],
                   done)

    eng.sampler, eng._emit = sampler, _emit
    return rows, choices


CKPT_ROOT = ROOT / "build" / "chip_smoke_ckpt"  # removed when a phase ends
RESTORE_SLACK = 256 << 20  # bytes the card may hold past store + cache
                           # while an engine restores (an f32 copy of any
                           # one packed leaf of the store would exceed it)


def tree_mismatches(torch, got, want):
    """Keys of the leaves of two trees (tensors, QuantizedTensors) that are
    not bitwise equal (codes, scales and MX metadata for packed leaves),
    and the number of leaves compared."""
    from repro_torch.ckpt.ckpt import _iter_leaves
    from repro_torch.core.blocking import QuantizedTensor
    got, want = dict(_iter_leaves(got)), dict(_iter_leaves(want))
    bad = sorted("/".join(k) for k in set(got) ^ set(want))
    for key in set(got) & set(want):
        a, b = got[key], want[key]
        if isinstance(b, QuantizedTensor):
            same = (isinstance(a, QuantizedTensor)
                    and (a.fmt, tuple(a.block), tuple(a.shape), a.dtype)
                    == (b.fmt, tuple(b.block), tuple(b.shape), b.dtype)
                    and torch.equal(a.codes, b.codes)
                    and torch.equal(a.scale_e8m0, b.scale_e8m0))
        else:
            same = a.dtype == b.dtype and torch.equal(a, b)
        if not same:
            bad.append("/".join(key))
    return bad, len(want)


def _host_bytes():
    """Free bytes of the disk under CKPT_ROOT and the host's available
    memory (a save holds the whole host copy)."""
    import os
    import shutil
    CKPT_ROOT.mkdir(parents=True, exist_ok=True)
    avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return shutil.disk_usage(CKPT_ROOT).free, avail


def phase_ckpt_serve(torch, device, cfg, policy, args, slots, chunk,
                     max_len, new_tokens, lengths, max_layers=16):
    """Full-width packed store at the depth the disk allows (at most
    ``max_layers``; no checkpoint larger than half the free disk or half
    the host's available memory), ``ckpt.save`` of it, then
    ``ServeEngine.from_checkpoint`` on the card: every leaf bitwise equal
    to the store in memory, the same prompts giving the same token streams
    on an engine over each store, the launch counts the path's, save and
    restore seconds and GB/s, and the card's peak memory while the engine
    restores within the store's bytes plus the cache's plus
    RESTORE_SLACK (no full-precision copy of a packed leaf).  Returns the
    restored engine's launches, its token streams, the config at the
    checkpoint's depth and the checkpoint, which the caller removes (with
    CKPT_ROOT) after phase serve_sharded has read it."""
    import shutil
    from repro_torch.ckpt import ckpt
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.engine import _nbytes as _tree_bytes
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    free_disk, avail_mem = _host_bytes()
    one, two = (_tree_bytes(M.packed_model_specs(cfg.replace(n_layers=n),
                                                 policy)) for n in (1, 2))
    per_layer, fixed = two - one, 2 * one - two
    budget = min(free_disk, avail_mem) // 2 - fixed
    n_layers = min(max_layers, cfg.n_layers, budget // per_layer)
    emit("ckpt_serve", step="plan", free_disk_bytes=free_disk,
         mem_available_bytes=avail_mem, bytes_per_layer=per_layer,
         bytes_fixed=fixed, n_layers=n_layers,
         store_bytes=fixed + n_layers * per_layer)
    if n_layers < 1:
        raise AssertionError("ckpt_serve: no room for one layer's store")
    cfg = cfg.replace(n_layers=n_layers)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    store = M.init_packed_params(cfg, policy, gen, device=device)
    kw = dict(slots=slots, max_len=max_len, prefill_chunk=chunk,
              backend="cuda", device=device)
    prompts = _prompts(cfg, args.seed, lengths)
    ckpt_dir = CKPT_ROOT / "store"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        sync()
        t0 = time.perf_counter()
        ckpt.save(str(ckpt_dir), 1, store)
        save_s = time.perf_counter() - t0
        with open(ckpt_dir / "step_00000001" / "manifest.json") as f:
            saved = json.load(f)["bytes"]
        disk = _disk_rates(CKPT_ROOT)
        outs_mem, _ = serve_run(torch, ServeEngine(cfg, store, policy, **kw),
                                cfg, prompts, new_tokens, "ckpt_serve",
                                store="in memory")
        sync()
        base = torch.cuda.memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ServeEngine.from_checkpoint(cfg, str(ckpt_dir), policy, **kw)
        sync()
        restore_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) if on_card else None
        store_b, cache_b = _tree_bytes(eng.params), _tree_bytes(eng.cache)
        bad, n_leaves = tree_mismatches(torch, eng.params, store)
        emit("ckpt_serve", step="save_restore", checkpoint_bytes=saved,
             save_seconds=save_s, save_gb_per_s=saved / save_s / 1e9,
             restore_seconds=restore_s,
             restore_gb_per_s=saved / restore_s / 1e9, **disk,
             restore_peak_bytes=peak, store_bytes=store_b,
             cache_bytes=cache_b, slack_bytes=RESTORE_SLACK,
             leaves=n_leaves, leaves_not_bitwise=bad)
        if bad:
            raise AssertionError(f"ckpt_serve: leaves differ: {bad[:8]}")
        if on_card and peak > store_b + cache_b + RESTORE_SLACK:
            raise AssertionError(f"ckpt_serve: restore peak {peak} B > "
                                 f"store + cache + slack")
        rows, _ = tap_emits(eng, cfg)
        outs, launches = serve_run(torch, eng, cfg, prompts, new_tokens,
                                   "ckpt_serve", store="from_checkpoint")
        torch.save(rows, CKPT_ROOT / "logits.pt")  # serve_sharded's reference
        if outs != outs_mem:
            raise AssertionError(f"ckpt_serve: token streams differ: {outs} "
                                 f"vs {outs_mem}")
    except BaseException:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
        raise
    emit("ckpt_serve", step="done", n_layers=n_layers, same_tokens=True,
         seconds=time.perf_counter() - t_phase)
    return launches, outs, cfg, ckpt_dir


def _disk_rates(where, nbytes=2 << 30):
    """Sequential write (fsync'd) and read-back rates of one ``nbytes``
    file under ``where``, the yardstick of the checkpoint's rates (the
    read may come from the page cache, as the restore's may)."""
    import os
    path = where / "disk_probe.bin"
    buf = os.urandom(64 << 20)
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for _ in range(nbytes // len(buf)):
            f.write(buf)
        f.flush()
        os.fsync(f.fileno())
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        while f.read(64 << 20):
            pass
    read_s = time.perf_counter() - t0
    path.unlink()
    return dict(disk_write_gb_per_s=nbytes / write_s / 1e9,
                disk_read_gb_per_s=nbytes / read_s / 1e9)


# ---------------------------------------------------------------------------
# sharded serving ("serve_sharded"): the checkpoint of "ckpt_serve" on a
# mesh of one rank (NCCL) and of two ranks sharing the card (gloo)
# ---------------------------------------------------------------------------

SHARD_TP = 2  # the two-rank run's model axis
SHARD_DIR = ROOT / "build" / "chip_smoke_sharded"  # the ranks' results
SHARD_WAIT_S = 480  # the two-rank run's time limit, restore included
REORDER_FACTOR = 2.0  # the two-rank logits' tolerance: this many times the
                      # largest move a pure f32 reorder of the matmuls
                      # caused on one device (``reorder_baseline``)
REORDER_CEILING = 0.318359375 + 2.0 ** -5  # the most that move may be on
# the card: the move recorded on the H100 (0.318359375 in two runs of the
# same deterministic path) plus one bf16 ulp of the largest |logit| (6.9)


def ffn_widths(cfg):
    """The widths of the FFNs that run as fused matmuls: a dense layer's
    d_ff, an MoE layer's shared expert (its routed experts run as
    ``mx_einsum`` in values)."""
    n_moe = cfg.n_layers // cfg.moe_every if cfg.n_experts else 0
    widths = [cfg.d_ff] if cfg.n_layers > n_moe else []
    if n_moe and cfg.n_shared_experts:
        widths.append(cfg.expert_ff * cfg.n_shared_experts)
    return widths


def shard_local_shapes(cfg, tp=SHARD_TP):
    """(K, N) of each fused matmul of a layer and the head at ``tp`` ranks
    on the model axis: column-parallel q, k, v, gate, up and head at N /
    tp, row-parallel o and down at K / tp."""
    d, v = cfg.d_model, cfg.padded_vocab
    hd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv * cfg.head_dim
    ffn = [s for f in ffn_widths(cfg) for s in ((d, f // tp), (f // tp, d))]
    return [(d, hd // tp), (d, kvd // tp), (hd // tp, d), (d, v // tp)] + ffn


def sharded_collectives(cfg, eng, breakdown=False):
    """Collectives of one dispatch of a sharded engine, from the path: an
    f32 all-reduce after each row-parallel linear (o, a dense FFN's down,
    an MoE layer's shared-expert down) and one for the vocab-parallel
    embedding; with more than one rank on the model axis, one all-gather
    of the head's logits, one of each norm weight the store splits (2 a
    layer and the final norm) and one of each MoE layer's expert outputs.
    Checked for the layouts these phases run: every part of the TP plan
    split, one rank on the DP axes.  ``breakdown``: by kind and source."""
    r, plan = eng.rules, eng.tp_plan
    L = cfg.n_layers
    n_moe = L // cfg.moe_every if cfg.n_experts else 0
    split = [plan.heads, plan.vocab] + [plan.mlp] * (L > n_moe) + \
        [plan.shared] * bool(n_moe and cfg.n_shared_experts)
    if r.dp_size != 1 or not all(split):
        raise AssertionError(f"no count formula for dp {r.dp_size}, {plan}")
    norm_split = eng._layout["specs"]["w"][0] != (None,)
    tp = r.tp_size > 1
    parts = {"all_reduce": {
        "o": L, "ffn_down": L - n_moe,
        "shared_down": n_moe * bool(cfg.n_shared_experts), "embedding": 1},
        "all_gather": {"logits": int(tp),
                       "norms": (2 * L + 1) * norm_split * tp,
                       "expert_outputs": n_moe * tp}}
    if breakdown:
        return parts
    return {k: sum(v.values()) for k, v in parts.items()}


def _sharded_engine(torch, cfg, policy, ckpt_dir, mesh, device, slots,
                    chunk, max_len):
    """``ServeEngine.from_checkpoint`` on ``mesh``: (engine, restore
    seconds, the restore's peak bytes on the card above what was there)."""
    from repro_torch.serve.engine import ServeEngine
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    eng = ServeEngine.from_checkpoint(cfg, str(ckpt_dir), policy, mesh=mesh,
                                      backend="cuda", device=device,
                                      slots=slots, max_len=max_len,
                                      prefill_chunk=chunk)
    if on_card:
        torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) if on_card else None
    return eng, time.perf_counter() - t0, peak


def logit_check(torch, rows, choices, want, ref_logits, floor_tol=0.0):
    """Teacher-forced logits (``tap_emits``' rows and choices, fed
    ``want``) against the one-device reference rows: each row's max
    deviation must lie within its tolerance, max(``floor_tol``, one bf16
    ulp of the reference row's largest |logit|).  That implies the
    engine's own top-1 is the reference token wherever the reference's
    top-1/top-2 gap exceeds twice the tolerance (a different choice needs
    a deviation of half the gap); those decided tokens and the
    disagreements are counted."""
    worst, max_dev, disagree, decided = 0.0, 0.0, [], 0
    for key, ls in rows.items():
        lr = ref_logits[key]
        tol = max(floor_tol, float(_bf16_ulp(torch, lr.abs().max())))
        dev = float((ls - lr).abs().max())
        worst, max_dev = max(worst, dev / tol), max(max_dev, dev)
        top2 = lr.topk(2).values
        gap = float(top2[0] - top2[1])
        decided += gap > 2 * tol
        if choices[key] != want[key[0] - 1][key[1]]:
            disagree.append(dict(uid=key[0], i=key[1], gap=gap, tol=tol,
                                 decided=gap > 2 * tol))
    faults = ["logits off the tolerance"] if worst > 1.0 else []
    if any(d["decided"] for d in disagree):
        faults.append("a decided token differs")
    return dict(tokens=len(rows), agree=len(rows) - len(disagree),
                decided=decided, max_dev=max_dev, max_err_over_tol=worst,
                disagree=disagree, free_running_equal=not disagree), faults


def sharded_serve(torch, eng, cfg, prompts, new_tokens, want, phase,
                  ref_logits=None, floor_tol=0.0, **fields):
    """``serve_run`` on a sharded engine (launches checked there), then its
    collectives against ``sharded_collectives``.  Without ``ref_logits``
    the token streams must equal ``want``.  With them (the one-device
    engine's logits row of each token of ``want``) the engine runs
    teacher-forced on ``want`` (``tap_emits``) and its logits are held to
    ``logit_check``.  Returns (token streams, launches, collectives, the
    teacher-forced check)."""
    from repro_torch.core import sharding as shd
    if ref_logits is not None:
        rows, choices = tap_emits(eng, cfg, {i + 1: t
                                             for i, t in enumerate(want)})
    shd.reset_counts()
    outs, launches = serve_run(torch, eng, cfg, prompts, new_tokens, phase,
                               **fields)
    got = {k: v["calls"] for k, v in shd.counts().items()
           if k in ("all_reduce", "all_gather")}
    st = eng.stats()
    n = st["prefill_dispatches"] + st["decode_dispatches"]
    expect = {k: v * n for k, v in sharded_collectives(cfg, eng).items()
              if v}
    check, faults = None, []
    if ref_logits is None:
        if outs != want:
            faults.append(f"token streams {outs} != the reference's {want}")
    else:
        check, faults = logit_check(torch, rows, choices, want, ref_logits,
                                    floor_tol)
    if got != expect:
        faults.append(f"collectives {got} != {expect}")
    emit(phase, step="collectives", **fields, collectives=got,
         expected=expect, collective_seconds={
             k: v["seconds"] for k, v in shd.counts().items()},
         same_tokens=outs == want, teacher_forced=check)
    if faults:
        raise AssertionError(f"{phase} {fields}: {faults}")
    return outs, launches, got, check


def reorder_baseline(torch, eng, cfg, prompts, new_tokens, want,
                     ref_logits):
    """How far the logits move when only the matmuls' f32 summation order
    changes, on one device: ``eng`` (a one-rank engine) serves the prompts
    again teacher-forced on ``want`` with every fused matmul call running
    its plain version (cuBLAS's f32 order over the same exact products;
    this script's hook, as ``checked_kernels`` is).  Returns
    ``logit_check``'s record, its faults not gated: its ``max_dev``
    (capped at REORDER_CEILING on the card by the caller) calibrates the
    two-rank run's tolerance."""
    from repro_torch.kernels import mxsf_fused_matmul as FM
    kernel = FM.mxsf_fused_matmul
    eng._uid = 0  # the requests' uids again 1.., as ref_logits keys them
    rows, choices = tap_emits(eng, cfg, {i + 1: t
                                         for i, t in enumerate(want)})
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    FM.mxsf_fused_matmul = FM.mxsf_fused_matmul_plain
    try:
        eng.run()
    finally:
        FM.mxsf_fused_matmul = kernel
    if not all(r.done for r in reqs):
        raise AssertionError("reorder baseline: requests left unfinished")
    check, _ = logit_check(torch, rows, choices, want, ref_logits)
    return check


@contextlib.contextmanager
def one_rank_world(torch, device):
    """A world of one rank in this process on the production backend
    (nccl on the card, gloo in the rehearsal); yields the backend's
    name."""
    import datetime
    import torch.distributed as dist
    on_card = device.type == "cuda"
    backend = "nccl" if on_card else "gloo"
    if on_card:
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        yield backend
    finally:
        dist.destroy_process_group()


def _world_one(torch, device, cfg, policy, ckpt_dir, slots, chunk, max_len,
               prompts, new_tokens, want, seed):
    """Phase serve_sharded, step 1: a world of one rank in this process
    (``one_rank_world``)."""
    from repro_torch.core import blocking as B
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime.compress import make_compressed_allreduce
    from repro_torch.runtime.pipeline_par import pipeline_apply
    on_card = device.type == "cuda"
    with one_rank_world(torch, device) as backend:
        mesh = mesh_lib.make_test_mesh(1, 1)
        eng, restore_s, _ = _sharded_engine(torch, cfg, policy, ckpt_dir,
                                            mesh, device, slots, chunk,
                                            max_len)
        _, launches, collectives, _ = sharded_serve(
            torch, eng, cfg, prompts, new_tokens, want, "serve_sharded",
            mesh="1x1", backend=backend, restore_seconds=restore_s)
        baseline = reorder_baseline(torch, eng, cfg, prompts, new_tokens,
                                    want, torch.load(CKPT_ROOT / "logits.pt"))
        emit("serve_sharded", step="reorder_baseline",
             ceiling=REORDER_CEILING if on_card else None, **baseline)
        if on_card and baseline["max_dev"] > REORDER_CEILING:
            raise AssertionError(
                f"serve_sharded: the reorder baseline moved the logits by "
                f"{baseline['max_dev']}, past its ceiling {REORDER_CEILING}")
        del eng
        free_device(torch, device)
        # the DP gradient mean over MXSF on the wire: one rank's sum is its
        # own qdq, bit for bit
        gen = torch.Generator(device=device).manual_seed(seed)
        grads = {"wg": torch.randn((2560, 6912), generator=gen,
                                   device=device),
                 "norm": torch.randn((2560,), generator=gen, device=device)}
        out, stats = make_compressed_allreduce(mesh_lib.make_mesh(
            (1,), ("data",)), "data")(grads)
        same = all(torch.equal(out[k], B.qdq(g.reshape(-1), "mxsf", (64,))
                               .reshape(g.shape)) for k, g in grads.items())
        # a one-stage GPipe schedule against the sequential run
        ws = torch.randn((1, 2, 64, 64), generator=gen, device=device) / 8
        xs = torch.randn((8, 4, 64), generator=gen, device=device)

        def layer_fn(stage_w, x):
            for w in stage_w:
                x = torch.tanh(x @ w)
            return x

        y = pipeline_apply(mesh_lib.make_mesh((1,), ("pod",)), "pod",
                           layer_fn, ws, xs)
        pipe_err = float((y - layer_fn(ws[0], xs)).abs().max())
        emit("serve_sharded", step="runtime", backend=backend,
             compressed_allreduce_bitwise=same, **stats,
             pipeline_max_abs_err=pipe_err)
        if not same or pipe_err > 2e-5:
            raise AssertionError("serve_sharded: compressed all-reduce or "
                                 "pipeline off its reference")
    return launches, baseline


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def gloo_rank(rank: str, world: str, port: str, rehearsal: str,
              out_dir: Path):
    """The set-up of one rank of a two-rank run (a process of its own):
    its device (the one card, shared; the CPU in the rehearsal), a gloo
    group over ``port`` (NCCL refuses two ranks on one device, so
    collectives go through host memory), and its results dict, written to
    ``out_dir/rank<r>.json`` however the body ends (an error recorded).
    Yields (torch, device, rank, world, results)."""
    import datetime
    import torch
    import torch.distributed as dist
    rank, world = int(rank), int(world)
    device = torch.device("cpu" if rehearsal == "1" else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.set_device(0)  # the ranks share the one card
    else:
        torch.set_num_threads(2)
    out = {"rank": rank}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        yield torch, device, rank, world, out
    except BaseException as e:
        out["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"rank{rank}.json").write_text(json.dumps(
            out, default=str))
        if dist.is_initialized():
            dist.destroy_process_group()


def sharded_rank(rank: str, world: str, port: str, rehearsal: str,
                 spec_file: str):
    """One rank of phase serve_sharded's two-rank run (started after the
    build, so it loads the built kernels): restore its slices of the
    checkpoint, hold every kernel call of its first dispatch against the
    plain version, serve the prompts, profile one decode dispatch on rank
    0, and write its results to SHARD_DIR."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import MXSF_INFER
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as M
    spec = json.loads(Path(spec_file).read_text())
    with gloo_rank(rank, world, port, rehearsal, SHARD_DIR) as (
            torch, device, rank, world, out):
        cfg = get_config("qwen2.5-32b")
        cfg = (cfg.reduced() if rehearsal == "1" else cfg).replace(
            n_layers=spec["n_layers"])
        policy = MXSF_INFER.replace(kv_cache_fmt="mxsf",
                                    block_1d=spec["block_1d"])
        mesh = mesh_lib.make_test_mesh(1, world)
        eng, restore_s, peak = _sharded_engine(
            torch, cfg, policy, spec["ckpt_dir"], mesh, device,
            spec["slots"], spec["chunk"], spec["max_len"])
        store_b, cache_b = _tree_bytes(eng.params), _tree_bytes(eng.cache)
        predicted = eng.rules.shard_nbytes(
            M.packed_model_specs(cfg, eng.policy), eng._store_sh)
        out.update(restore_seconds=restore_s, restore_peak_bytes=peak,
                   store_bytes=store_b, predicted_store_bytes=predicted,
                   cache_bytes=cache_b, slack_bytes=RESTORE_SLACK,
                   tp_plan=eng.tp_plan._asdict(),
                   attn_backend=eng.attn_backend,
                   shard_fallback=eng.shard_fallback)
        if store_b != predicted:
            raise AssertionError(f"store {store_b} B != MeshRules' "
                                 f"{predicted} B")
        if peak is not None and peak > store_b + cache_b + RESTORE_SLACK:
            raise AssertionError(f"restore peak {peak} B > store + cache + "
                                 "slack")
        out["first_dispatch"] = sharded_first_dispatch(torch, eng, cfg,
                                                       spec["prompts"])
        outs, launches, collectives, check = sharded_serve(
            torch, eng, cfg, spec["prompts"], spec["new_tokens"],
            spec["want"], "serve_sharded",
            ref_logits=torch.load(spec["ref_logits"]),
            floor_tol=spec["floor_tol"], mesh=f"1x{world}", rank=rank,
            backend="gloo")
        out.update(tokens=outs, launches=launches, collectives=collectives,
                   teacher_forced=check, stats=eng.stats())
        out["profile"] = rank_profile(torch, eng, rank, "serve_sharded")


def rank_profile(torch, eng, rank, phase):
    """Rank 0's decode dispatch on the card under the profiler: wall time,
    idle share, and the share of the wall its collectives held (their
    host seconds, by kind); the other ranks run the same two dispatches
    alongside.  None off rank 0 or off the card."""
    from repro_torch.core import sharding as shd
    if rank == 0 and eng.device.type == "cuda":
        shd.reset_counts()
        prof = profile_decode(torch, eng, phase, rank=rank)
        # profile_decode runs the dispatch twice (warm-up, profiled)
        per = {k: dict(calls=v["calls"] / 2, ms=v["seconds"] / 2 * 1e3)
               for k, v in shd.counts().items()}
        coll = sum(v["ms"] for v in per.values())
        return dict(wall_ms=prof["wall_ms"], idle_share=prof["idle_share"],
                    device_busy_ms=prof["device_busy_ms"],
                    collective_share=coll / prof["wall_ms"],
                    collectives_per_dispatch=per)
    toks = eng._tensor(eng.last_tok)[:, None]
    pos = eng._tensor(eng.pos)
    for _ in range(2):
        eng._decode(eng.params, toks, eng.cache, pos)
    return None


def run_rank_processes(phase, target, spec, out_dir, world, rehearsal,
                       wait_s=SHARD_WAIT_S):
    """``world`` ranks in their own processes (started after the build,
    so they load the built kernels), each running ``chip_smoke.<target>
    (rank, world, port, rehearsal, spec file)`` over one gloo group; a
    rank that fails or outlives ``wait_s`` fails the phase, and every
    rank still running is stopped.  Returns each rank's results (its
    ``rank<r>.json``), each emitted."""
    import os
    import shutil
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    spec_file = out_dir / "spec.json"
    spec_file.write_text(json.dumps(spec))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    code = f"import sys, chip_smoke; chip_smoke.{target}(*sys.argv[1:])"
    procs = []
    for r in range(world):
        log = open(out_dir / f"rank{r}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(world), str(port),
             str(int(rehearsal)), str(spec_file)],
            cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    deadline = time.perf_counter() + wait_s
    try:
        while any(p.poll() is None for p in procs):
            if time.perf_counter() > deadline:
                raise AssertionError(f"{phase}: a rank outlived {wait_s} s")
            if any(p.poll() not in (None, 0) for p in procs):
                break  # the others would wait on it
            time.sleep(0.5)
    finally:
        stop_processes(procs)
    ranks = []
    for r, p in enumerate(procs):
        res_file = out_dir / f"rank{r}.json"
        res = json.loads(res_file.read_text()) if res_file.exists() else {}
        ranks.append(res)
        log = (out_dir / f"rank{r}.log").read_text()[-3000:]
        emit(phase, step="rank", exit=p.returncode, backend="gloo",
             **{k: v for k, v in res.items() if k not in ("stats",)})
        if p.returncode != 0 or "error" in res or not res:
            raise AssertionError(f"{phase} rank {r} failed "
                                 f"(exit {p.returncode}): {log}")
    if any(r["teacher_forced"]["disagree"] != ranks[0]["teacher_forced"][
            "disagree"] for r in ranks):
        raise AssertionError(f"{phase}: the ranks chose differently")
    return ranks


def sharded_first_dispatch(torch, eng, cfg, prompts):
    """The first prefill dispatch of a fresh cache through ``eng``'s
    sharded path, every kernel call teacher-forced (``checked_kernels``):
    each call against its plain version at its shard-local shape, the
    calls against the path's count (``serve_launch_counts``), and the
    shapes against ``shard_local_shapes`` and the local heads."""
    from repro_torch.core import sharding as shd
    B, C = eng.slots, eng.prefill_chunk
    toks = torch.zeros((B, C), dtype=torch.int64)
    nv = torch.zeros(B, dtype=torch.int64)
    for s, p in enumerate(prompts[:B]):
        n = min(C, len(p))
        toks[s, :n] = torch.tensor(p[:n])
        nv[s] = n
    cache = {k: torch.zeros_like(v) for k, v in eng.cache.items()}
    dev = eng.device
    with checked_kernels(torch, lambda k: MATMUL_RTOL, None) as chk:
        eng._prefill(eng.params, toks.to(dev), cache,
                     torch.zeros(B, dtype=torch.int64, device=dev),
                     nv.to(dev))
    expect = serve_launch_counts(cfg, eng.attn_backend)
    rows, faults = chk.rows(expect)
    tp = eng.rules.tp_size
    shapes = sorted({(c["k"], c["n"]) for c in chk.calls["mxsf_fused_matmul"]})
    want = sorted({(k, n) for k, n in shard_local_shapes(cfg, tp)})
    heads = sorted({(c["heads"], c["kv_heads"])
                    for c in chk.calls["mxsf_attention"]})
    want_heads = [(cfg.n_heads // tp, cfg.n_kv // tp)]
    if shapes != want:
        faults.append(f"fused shapes {shapes} != {want}")
    if eng.attn_backend == "cuda-packed" and heads != want_heads:
        faults.append(f"attention heads {heads} != {want_heads}")
    if faults:
        raise AssertionError(f"serve_sharded first dispatch: {faults}")
    return dict(kernels=rows, fused_shapes=shapes, attention_heads=heads)


def phase_serve_sharded(torch, device, cfg, policy, args, slots, chunk,
                        max_len, new_tokens, lengths, ckpt_dir, want,
                        rehearsal):
    """Phase serve_sharded (on ckpt_serve's checkpoint and token streams;
    ``cfg`` at the checkpoint's depth).  Step 1: a world of one rank in
    this process on the production backend (``_world_one``).  Step 2:
    SHARD_TP ranks sharing the card on a (1, SHARD_TP) mesh, each in its
    own process (``sharded_rank``) over gloo; a rank that fails or
    outlives SHARD_WAIT_S fails the phase.  Returns the launches of both
    runs (rank 0's for the two-rank run)."""
    t_phase = time.perf_counter()
    prompts = _prompts(cfg, args.seed, lengths)
    launches, baseline = _world_one(
        torch, device, cfg, policy, ckpt_dir, slots, chunk, max_len, prompts,
        new_tokens, want, args.seed)
    free_device(torch, device)
    ranks = run_rank_processes("serve_sharded", "sharded_rank", dict(
        n_layers=cfg.n_layers, block_1d=policy.block_1d,
        ckpt_dir=str(ckpt_dir), ref_logits=str(CKPT_ROOT / "logits.pt"),
        floor_tol=REORDER_FACTOR * baseline["max_dev"], slots=slots,
        chunk=chunk, max_len=max_len, prompts=prompts, new_tokens=new_tokens,
        want=want), SHARD_DIR, SHARD_TP, rehearsal)
    emit("serve_sharded", step="done", seconds=time.perf_counter() - t_phase,
         ranks=SHARD_TP, free_running_equal=ranks[0]["teacher_forced"][
             "free_running_equal"])
    return {"serve_sharded_1x1": launches,
            f"serve_sharded_1x{SHARD_TP}": ranks[0]["launches"]}


def phase_train_resume(torch, device, cfg, policy, args, batch, seq,
                       steps=4, every=2, fail_at=3):
    """``fault.train_loop`` for ``steps`` steps checkpointing every
    ``every`` (async saves, as the training CLI runs it), uninterrupted;
    then again with a failure injected at ``fail_at`` -- the one exception
    caught, and it must be raised -- and resumed from the last checkpoint.
    Params and the whole AdamW state must be bitwise equal between the two
    runs; each run's launches the path's count times its steps.  Returns
    the launches of the three runs together."""
    import shutil
    from repro_torch.ckpt import ckpt
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime import fault
    from repro_torch.train import step as T
    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    ocfg = OptConfig()
    step_fn = T.make_train_step(cfg, policy, ocfg, T.TrainConfig())
    batches = make_batches(torch, cfg, args.seed, steps, batch, seq, device)

    def init_fn():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return T.init_state(gen, cfg, ocfg, device=device)

    per_step = train_launch_counts(cfg, policy)
    total = dict.fromkeys(per_step, 0)

    def run(name, fcfg, n_run):
        reset_launches()
        t0 = time.perf_counter()
        try:
            out = fault.train_loop(fcfg, init_fn, step_fn, batches.__getitem__,
                                   steps)
        except fault.FailureInjected as e:
            # the saves already in flight land before the restart reads
            # the directory, as they would before a real job restarts
            ckpt.wait_pending()
            out, failed = None, str(e)
        else:
            failed = None
        got = {k: v for k, v in read_launches().items() if k in per_step}
        want = {k: v * n_run for k, v in per_step.items()}
        for k in total:
            total[k] += got[k]
        emit("train_resume", run=name, seconds=time.perf_counter() - t0,
             failed=failed, latest_step=ckpt.latest_step(fcfg.ckpt_dir),
             step_seconds=out[1].times if out else None,
             stragglers=out[1].straggler_steps if out else None,
             launches=got, expected_launches=want)
        if on_card and got != want:
            raise AssertionError(f"train_resume {name}: launches {got} != "
                                 f"path {want}")
        return out

    dirs = [CKPT_ROOT / "uninterrupted", CKPT_ROOT / "interrupted"]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    try:
        state_a, _ = run("uninterrupted", fault.FaultConfig(
            ckpt_dir=str(dirs[0]), ckpt_every=every, async_save=True), steps)
        with open(dirs[0] / f"step_{steps:08d}" / "manifest.json") as f:
            ckpt_bytes = json.load(f)["bytes"]
        shutil.rmtree(dirs[0])
        fcfg = fault.FaultConfig(ckpt_dir=str(dirs[1]), ckpt_every=every,
                                 async_save=True, fail_at_step=fail_at)
        if run("interrupted", fcfg, fail_at) is not None:
            raise AssertionError("train_resume: the injected failure was "
                                 "not raised")
        resumed_at = ckpt.latest_step(fcfg.ckpt_dir)
        fcfg.fail_at_step = None
        state_b, _ = run("resumed", fcfg, steps - resumed_at)
    finally:
        ckpt.wait_pending()
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    bad, n_leaves = tree_mismatches(torch, state_b, state_a)
    emit("train_resume", step="compare", resumed_at=resumed_at,
         checkpoint_bytes=ckpt_bytes, leaves=n_leaves,
         leaves_not_bitwise=bad,
         opt_step=int(state_b["opt"]["step"]), n_layers=cfg.n_layers,
         seconds=time.perf_counter() - t_phase)
    if bad:
        raise AssertionError(f"train_resume: resumed state differs from the "
                             f"uninterrupted one at {bad[:8]}")
    return total


# ---------------------------------------------------------------------------
# the other decoder families: value-domain cached attention ("serve_gemma2",
# "ring_swa") and MoE ("serve_moe")
# ---------------------------------------------------------------------------

def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def phase_serve_gemma2(torch, device, args, rehearsal):
    """gemma2-9b at full width and depth (softcaps, alternating 4096-token
    SWA): one packed store shared by two engines of ``MXSF_INFER`` on the
    kernel datapath, A with the policy's bf16 value cache and B with the
    packed MXSF cache (dequantized into the value path, ``kv_prequant``);
    a 4200-token prompt (the local layers' window masks) and a 37-token
    one, 16 new tokens each, chunk 256; a profiled decode dispatch each;
    then engine A's first prefill and two decode dispatches teacher-forced.
    Returns the launches of each engine's run."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.packed_store import store_nbytes
    from repro_torch.core.policy import MXSF_INFER
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.engine import _nbytes as tree_bytes
    cfg = get_config("gemma2-9b")
    slots, chunk, max_len, new_tokens = 2, 256, 4352, 16
    lengths = [4200, 37]
    if rehearsal:
        cfg = cfg.reduced()
        chunk, max_len, new_tokens, lengths = 8, 40, 4, [21, 5]
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    store = M.init_packed_params(cfg, MXSF_INFER, gen, device=device)
    _sync(torch, device)
    emit("serve_gemma2", step="store", seconds=time.perf_counter() - t0,
         n_layers=cfg.n_layers, store_nbytes=store_nbytes(store))
    prompts = _prompts(cfg, args.seed, lengths)
    launches = {}
    packed = MXSF_INFER.replace(kv_cache_fmt="mxsf")
    for label, pol in (("bf16_cache", MXSF_INFER), ("mxsf_cache", packed)):
        eng = ServeEngine(cfg, store, pol, slots=slots, max_len=max_len,
                          prefill_chunk=chunk, backend="cuda", device=device)
        if eng.attn_backend != "torch":
            raise AssertionError(f"serve_gemma2: attn_backend "
                                 f"{eng.attn_backend}")
        _, launches[f"serve_gemma2_{label}"] = serve_run(
            torch, eng, cfg, prompts, new_tokens, "serve_gemma2",
            cache=label, cache_bytes=tree_bytes(eng.cache))
        if device.type == "cuda":
            profile_decode(torch, eng, "serve_gemma2", cache=label)
        if label == "bf16_cache":
            phase_slice(torch, eng, cfg, prompts, chunk, "serve_gemma2")
        del eng
        free_device(torch, device)
    return launches


def phase_ring_swa(torch, device, args, rehearsal):
    """h2o-danube-1.8b at full width and depth (every layer a 4096-token
    window) on the ring cache: ``init_cache(ring=True)`` at max_len 8192
    holds W = 4096 columns; 17 window-aligned ``prefill_step`` chunks of
    256 over two slots (the 17th starts at position 4096 and writes ring
    columns 0-255), then 8 greedy ``decode_step``s; launches the path's,
    logits finite, tokens/s; the last decode dispatch profiled on a copy of
    the cache; then the first and the last dispatch again, teacher-forced,
    on the cache as each found it.  Returns the launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.packed_store import store_nbytes
    from repro_torch.core.policy import MXSF_INFER
    from repro_torch.models import model as M
    cfg = get_config("h2o-danube-1.8b")
    B, chunk, max_len, n_chunks, n_decode = 2, 256, 8192, 17, 8
    if rehearsal:
        cfg = cfg.reduced()
        chunk, max_len, n_chunks, n_decode = 8, 32, 3, 4
    policy = MXSF_INFER.replace(backend="cuda")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    store = M.init_packed_params(cfg, policy, gen, device=device)
    cache = M.init_cache(cfg, B, max_len, ring=True, device=device)
    W = cache["k"].shape[3]
    if W != min(cfg.swa_window, max_len):
        raise AssertionError(f"ring_swa: cache width {W}")
    gen = torch.Generator().manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab, (B, chunk * n_chunks),
                           generator=gen).to(device)
    nv = torch.full((B,), chunk, dtype=torch.int64, device=device)
    steps = [("prefill", prompt[:, c * chunk:(c + 1) * chunk],
              torch.full((B,), c * chunk, dtype=torch.int64, device=device),
              nv) for c in range(n_chunks)]
    starts = {}
    reset_launches()
    t_pre = t_dec = 0.0
    finite = True
    tok = None
    for i in range(n_chunks + n_decode):
        if i >= n_chunks:
            pos = torch.full((B,), n_chunks * chunk + i - n_chunks,
                             dtype=torch.int64, device=device)
            steps.append(("decode", tok[:, None], pos, None))
        kind, t, p, n = steps[i]
        if i in (0, n_chunks + n_decode - 1):
            starts[i] = {k: v.clone() for k, v in cache.items()}
        _sync(torch, device)
        t0 = time.perf_counter()
        if kind == "prefill":
            logits, cache = M.prefill_step(store, t, cache, p, n, cfg, policy)
        else:
            logits, cache = M.decode_step(store, t, cache, p, cfg, policy)
        tok = logits.argmax(-1)
        finite &= bool(torch.isfinite(logits[:, :cfg.vocab]).all())
        dt = time.perf_counter() - t0
        if kind == "prefill":
            t_pre += dt
        else:
            t_dec += dt
    launches = {k: v for k, v in read_launches().items()
                if k in ("mxsf_fused_matmul", "mxsf_attention")}
    per = serve_launch_counts(cfg, M.decode_attn_backend(cfg, policy))
    expect = {k: v * len(steps) for k, v in per.items()}
    emit("ring_swa", step="run", n_layers=cfg.n_layers, cache_width=W,
         max_len=max_len, slots=B, chunks=n_chunks, chunk=chunk,
         decode_steps=n_decode, last_chunk_start=(n_chunks - 1) * chunk,
         last_chunk_ring_columns=[((n_chunks - 1) * chunk) % W,
                                  ((n_chunks - 1) * chunk) % W + chunk - 1],
         store_nbytes=store_nbytes(store),
         cache_bytes=sum(v.numel() * v.element_size()
                         for v in cache.values()),
         prefill_tokens_per_s=B * chunk * n_chunks / t_pre,
         decode_tokens_per_s=B * n_decode / t_dec, finite=finite,
         max_memory_allocated=(torch.cuda.max_memory_allocated()
                               if device.type == "cuda" else None),
         launches=launches, expected_launches=expect)
    if not finite:
        raise AssertionError("ring_swa: non-finite logits")
    if device.type == "cuda" and launches != expect:
        raise AssertionError(f"ring_swa: launch counts {launches} != path "
                             f"{expect}")
    if device.type == "cuda":  # the last decode again, on a copy
        _, t, p, _ = steps[-1]
        probe = {k: v.clone() for k, v in starts[len(steps) - 1].items()}
        profile_dispatch(torch, lambda: M.decode_step(store, t, probe, p, cfg,
                                                      policy), "ring_swa")
        del probe
    for i, start in starts.items():
        kind, t, p, n = steps[i]
        checked_dispatch(torch, store, cfg, policy, kind, t, start, p, n,
                         per, "ring_swa", step=i)
    return launches


MOE_LAYERS = 12  # serve_moe's depth, and so serve_sharded_moe's: at all
# 24 layers the two phases took 77 + 244 s of a 1151 s script on the H100,
# too close to its 1200 s limit


def phase_serve_moe(torch, device, args, rehearsal):
    """qwen2-moe-a2.7b at full width (60 routed experts padded to 64, top
    4, 4 shared), expert stacks in f32 values as in the JAX package's
    store, at MOE_LAYERS of its 24 layers (or fewer, if the card's free
    memory for store + cache + 4 GiB says so); ``MXSF_INFER`` with the
    packed MXSF cache on the kernel
    datapath, 4 slots, max_len 256, prompts of 8-24 tokens, 8 new tokens
    each, token by token (chunk 1, as the JAX engine serves MoE); a
    profiled decode dispatch; then, teacher-forced, the first dispatch
    with the tokens each MoE layer dropped past capacity, and a prefill of
    the whole prompts with a decode after it, over rows of 9-25 keys.
    Returns the launches and phase serve_sharded_moe's reference: the
    store, the token streams, the logits row of each token and the first
    dispatch's MoE layers (``moe_first_dispatch``).  In the rehearsal the
    reduced model's 64-wide layers take 16-element blocks, so they split
    whole blocks over the model axis there."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.packed_store import store_nbytes
    from repro_torch.core.policy import MXSF_INFER
    from repro_torch.models import blocks as TB
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.engine import _nbytes as tree_bytes
    cfg = get_config("qwen2-moe-a2.7b")
    slots, max_len, new_tokens = 4, 256, 8
    lengths = [8, 13, 19, 24]
    policy = MXSF_INFER.replace(kv_cache_fmt="mxsf")
    if rehearsal:
        cfg = cfg.reduced()
        max_len, new_tokens, lengths = 32, 3, [3, 5, 2, 7]
        policy = policy.replace(block_1d=16)
    one, two = (tree_bytes(M.packed_model_specs(cfg.replace(n_layers=n),
                                                policy)) for n in (1, 2))
    per_layer, fixed = two - one, 2 * one - two
    cache_layer = 2 * slots * max_len * cfg.n_kv * (cfg.head_dim + 1)
    free = (torch.cuda.mem_get_info()[0] if device.type == "cuda"
            else 1 << 62)
    budget = free - fixed - (4 << 30)
    n_layers = min(cfg.n_layers, MOE_LAYERS,
                   budget // (per_layer + cache_layer))
    emit("serve_moe", step="plan", free_bytes=free, bytes_per_layer=per_layer,
         bytes_fixed=fixed, cache_bytes_per_layer=cache_layer,
         n_layers=n_layers, of=cfg.n_layers, cap=MOE_LAYERS)
    if n_layers < 1:
        raise AssertionError("serve_moe: no room for one layer")
    cfg = cfg.replace(n_layers=n_layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    store = M.init_packed_params(cfg, policy, gen, device=device)
    _sync(torch, device)
    emit("serve_moe", step="store", seconds=time.perf_counter() - t0,
         n_layers=n_layers, store_nbytes=store_nbytes(store))
    eng = ServeEngine(cfg, store, policy, slots=slots, max_len=max_len,
                      backend="cuda", device=device)
    if eng.prefill_chunk != 1:
        raise AssertionError("serve_moe: MoE engines serve token by token")
    prompts = _prompts(cfg, args.seed, lengths)
    rows, _ = tap_emits(eng, cfg)
    want, launches = serve_run(torch, eng, cfg, prompts, new_tokens,
                               "serve_moe", cache_bytes=tree_bytes(eng.cache))
    if device.type == "cuda":
        profile_decode(torch, eng, "serve_moe")
    first = moe_first_dispatch(torch, eng, prompts)
    # the engine's first dispatch (every slot's first prompt token, routed
    # across the batch), teacher-forced, counting the dropped assignments
    cache = M.init_cache(cfg, slots, max_len, kv_fmt="mxsf", device=device)
    t = torch.tensor([[p[0]] for p in prompts], device=device)
    pos = torch.zeros(slots, dtype=torch.int64, device=device)
    dropped, dispatch = [], TB._row_dispatch

    def counting(*a):
        out = dispatch(*a)
        dropped.append(int((~out[2]).sum()))
        return out

    TB._row_dispatch = counting
    try:
        checked_dispatch(torch, eng.params, cfg, eng.policy, "decode", t,
                         cache, pos, None,
                         serve_launch_counts(cfg, eng.attn_backend),
                         "serve_moe", step=0)
    finally:
        TB._row_dispatch = dispatch
    C = max(1, math.ceil(slots * cfg.top_k * cfg.capacity_factor
                         / cfg.n_experts))
    emit("serve_moe", step="capacity", capacity=C,
         assignments_per_layer=slots * cfg.top_k,
         dropped_per_layer=dropped, dropped_total=sum(dropped))
    # every slot's whole prompt in one prefill dispatch, then a decode over
    # rows of 9-25 keys (the first dispatch's rows hold one key, where
    # softmax gives weight 1 whatever the scores), both teacher-forced
    cache = M.init_cache(cfg, slots, max_len, kv_fmt="mxsf", device=device)
    width = max(lengths)
    t = torch.tensor([p + [0] * (width - len(p)) for p in prompts],
                     device=device)
    n = torch.tensor(lengths, device=device)
    pos = torch.zeros(slots, dtype=torch.int64, device=device)
    expect = serve_launch_counts(cfg, eng.attn_backend)
    _, nxt = checked_dispatch(torch, eng.params, cfg, eng.policy, "prefill",
                              t, cache, pos, n, expect, "serve_moe",
                              step="prefill")
    checked_dispatch(torch, eng.params, cfg, eng.policy, "decode",
                     nxt[:, None], cache, n, None, expect, "serve_moe",
                     step="decode", keys_per_row=[v + 1 for v in lengths])
    ref = dict(cfg=cfg, policy=policy, store=store, slots=slots,
               max_len=max_len, new_tokens=new_tokens, prompts=prompts,
               want=want, logits=rows, first=first, launches=launches)
    del eng, store, cache
    free_device(torch, device)
    return launches, ref


# ---------------------------------------------------------------------------
# expert parallelism ("serve_sharded_moe")
# ---------------------------------------------------------------------------

SHARD_MOE_DIR = ROOT / "build" / "chip_smoke_sharded_moe"  # ranks' results
MOE_REF_DIR = ROOT / "build" / "chip_smoke_moe_ref"  # removed when it ends
MOE_REORDER_CEILING = 0.390625 + 2.0 ** -5  # the most the one-device
# reorder baseline may move qwen2-moe's logits on the card: the move
# recorded on the H100 at MOE_LAYERS (0.390625) plus one bf16 ulp of its
# largest |logit| (4-8)


def moe_taps(torch, fn):
    """``fn()`` with each MoE layer it runs recorded on the host, in layer
    order (this script's hook on ``blocks.moe`` and its parts, as
    ``tap_emits`` is on the engine): the layer's input ``x`` (after the
    decode regroup), its dispatch's ``slot`` and ``valid``, and the
    expert outputs ``ye`` the combine reads.  Returns (fn's result,
    records)."""
    from repro_torch.models import blocks as TB
    rec, parts = [], (TB.moe, TB._row_dispatch, TB._expert_ffn)

    def moe(p, x, *a):
        rec.append({"x": x.cpu()})
        return parts[0](p, x, *a)

    def dispatch(*a):
        out = parts[1](*a)
        rec[-1].update(slot=out[1].cpu(), valid=out[2].cpu())
        return out

    def experts(*a):
        ye = parts[2](*a)
        rec[-1]["ye"] = ye.cpu()
        return ye

    TB.moe, TB._row_dispatch, TB._expert_ffn = moe, dispatch, experts
    try:
        return fn(), rec
    finally:
        TB.moe, TB._row_dispatch, TB._expert_ffn = parts


def moe_first_dispatch(torch, eng, prompts):
    """The engine's first dispatch (every slot's first prompt token on a
    fresh cache, routed across the batch) through its own path, each MoE
    layer recorded (``moe_taps``)."""
    dev = eng.device
    cache = {k: torch.zeros_like(v) for k, v in eng.cache.items()}
    t = torch.tensor([[p[0]] for p in prompts[:eng.slots]], device=dev)
    pos = torch.zeros(eng.slots, dtype=torch.int64, device=dev)
    return moe_taps(torch, lambda: eng._decode(eng.params, t, cache,
                                               pos))[1]


def moe_exact(torch, eng, cfg, prompts, ref):
    """The part of expert parallelism that stays exact, on the first
    dispatch: each MoE layer run on one device's input of that layer
    (``ref``: ``moe_first_dispatch`` on one device) under this rank's
    mesh context routes to one device's ``slot``/``valid`` bit for bit,
    and its gathered expert outputs lie within one bf16 ulp of the
    largest |ye| of one device's (the batched product at E / tp experts
    may pick another summation than at E; whether they are bitwise is
    reported).  This rank's own first dispatch must route as one device's
    wherever its layer input is one device's, bit for bit."""
    from repro_torch.models import blocks as TB
    from repro_torch.models import model as M
    own = moe_first_dispatch(torch, eng, prompts)
    sub, dev = f"sub{cfg.moe_every - 1}", eng.device
    layers, faults = [], []
    for i, r in enumerate(ref):
        ffn = M.decoding.layer_params(eng.params["layers"], i)[sub]["ffn"]
        with eng._hints():
            (got,) = moe_taps(torch, lambda: TB.moe(
                ffn, r["x"].to(dev), cfg, eng.policy))[1]
        routed = (torch.equal(got["slot"], r["slot"])
                  and torch.equal(got["valid"], r["valid"]))
        err = float((got["ye"].float() - r["ye"].float()).abs().max())
        tol = float(_bf16_ulp(torch, r["ye"].abs().max()))
        same_x = torch.equal(own[i]["x"], r["x"])
        own_routed = (torch.equal(own[i]["slot"], r["slot"])
                      and torch.equal(own[i]["valid"], r["valid"]))
        layers.append(dict(layer=i, routed=routed,
                           ye_bitwise=torch.equal(got["ye"], r["ye"]),
                           ye_max_abs_err=err, ye_tol=tol,
                           own_x_equal=same_x, own_routed=own_routed,
                           dropped=int((~r["valid"]).sum())))
        if not routed:
            faults.append(f"layer {i}: routing differs on one device's input")
        if err > tol:
            faults.append(f"layer {i}: ye off by {err} > {tol}")
        if same_x and not own_routed:
            faults.append(f"layer {i}: the same input routed differently")
    rec = dict(layers=len(layers),
               routed=sum(x["routed"] for x in layers),
               ye_bitwise=sum(x["ye_bitwise"] for x in layers),
               ye_max_abs_err=max(x["ye_max_abs_err"] for x in layers),
               ye_worst_over_tol=max(x["ye_max_abs_err"] / x["ye_tol"]
                                     for x in layers),
               own_x_equal=sum(x["own_x_equal"] for x in layers),
               own_routed=sum(x["own_routed"] for x in layers),
               dropped_per_layer=[x["dropped"] for x in layers])
    if faults:
        raise AssertionError(f"serve_sharded_moe exact part: {faults}")
    return rec


def moe_config(rehearsal: bool):
    from repro_torch.configs.base import get_config
    cfg = get_config("qwen2-moe-a2.7b")
    return cfg.reduced() if rehearsal else cfg


def _expert_bytes(tree):
    """Bytes of the routed experts' stacks in a store."""
    return sum(_tree_bytes(sub["ffn"][n]) for sub in tree["layers"].values()
               if "router" in sub["ffn"] for n in ("we_g", "we_u", "we_d"))


def _moe_world_one(torch, device, ref):
    """Phase serve_sharded_moe, step 1: a world of one rank in this
    process (``one_rank_world``) serving over serve_moe's store (the
    (1, 1) slices are the store's own tensors: no copy): the token streams
    bit for bit and the launches as serve_moe's, the collectives as their
    formula; then the reorder baseline on the same engine (every fused
    matmul on its plain version, teacher-forced), capped on the card at
    MOE_REORDER_CEILING.  Returns (launches, the baseline)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve.engine import ServeEngine
    cfg, phase = ref["cfg"], "serve_sharded_moe"
    with one_rank_world(torch, device) as backend:
        eng = ServeEngine(cfg, ref["store"], ref["policy"],
                          mesh=mesh_lib.make_test_mesh(1, 1), backend="cuda",
                          device=device, slots=ref["slots"],
                          max_len=ref["max_len"])
        _, launches, _, _ = sharded_serve(
            torch, eng, cfg, ref["prompts"], ref["new_tokens"], ref["want"],
            phase, mesh="1x1", backend=backend, n_layers=cfg.n_layers)
        if device.type == "cuda" and launches != ref["launches"]:
            raise AssertionError(f"{phase}: (1, 1) launches {launches} != "
                                 f"serve_moe's {ref['launches']}")
        baseline = reorder_baseline(torch, eng, cfg, ref["prompts"],
                                    ref["new_tokens"], ref["want"],
                                    ref["logits"])
        on_card = device.type == "cuda"
        emit(phase, step="reorder_baseline",
             ceiling=MOE_REORDER_CEILING if on_card else None, **baseline)
        if on_card and baseline["max_dev"] > MOE_REORDER_CEILING:
            raise AssertionError(
                f"{phase}: the reorder baseline moved the logits by "
                f"{baseline['max_dev']}, past its ceiling "
                f"{MOE_REORDER_CEILING}")
    return launches, baseline


def sharded_moe_rank(rank: str, world: str, port: str, rehearsal: str,
                     spec_file: str):
    """One rank of phase serve_sharded_moe's two-rank run: draw its slices
    of serve_moe's store (``ServeEngine.from_init`` on serve_moe's seed:
    every leaf drawn as one device draws it, this rank's slice kept) and
    hold its bytes to ``MeshRules``; hold every kernel call of its first
    dispatch against the plain version, and the exact part
    (``moe_exact``); serve serve_moe's prompts teacher-forced on its
    streams, the logits within the tolerance, launches and collectives
    against their formulas; profile one decode dispatch on rank 0; write
    its results to SHARD_MOE_DIR."""
    from repro_torch.core.policy import MXSF_INFER
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    spec = json.loads(Path(spec_file).read_text())
    with gloo_rank(rank, world, port, rehearsal, SHARD_MOE_DIR) as (
            torch, device, rank, world, out):
        cfg = moe_config(rehearsal == "1").replace(n_layers=spec["n_layers"])
        policy = MXSF_INFER.replace(kv_cache_fmt="mxsf",
                                    block_1d=spec["block_1d"])
        _sync(torch, device)
        t0 = time.perf_counter()
        eng = ServeEngine.from_init(
            cfg, policy, torch.Generator(device=device).manual_seed(
                spec["seed"]), mesh=mesh_lib.make_test_mesh(1, world),
            backend="cuda", device=device, slots=spec["slots"],
            max_len=spec["max_len"])
        _sync(torch, device)
        held = _tree_bytes(eng.params)
        stats = eng.stats()["store_nbytes_per_device"]
        counted = next(v for k, v in stats.items()
                       if k.startswith(f"rank{rank}:"))
        predicted = eng.rules.shard_nbytes(
            M.packed_model_specs(cfg, eng.policy), eng._store_sh)
        out.update(n_layers=cfg.n_layers,
                   build_seconds=time.perf_counter() - t0,
                   store_bytes=held, stats_store_bytes=counted,
                   predicted_store_bytes=predicted,
                   expert_bytes=_expert_bytes(eng.params),
                   expert_rows=eng.params["layers"]["sub0"]["ffn"][
                       "we_g"].shape[1],
                   cache_bytes=_tree_bytes(eng.cache),
                   tp_plan=eng.tp_plan._asdict(),
                   attn_backend=eng.attn_backend,
                   peak_bytes=(torch.cuda.max_memory_allocated()
                               if device.type == "cuda" else None))
        if not held == counted == predicted:
            raise AssertionError(f"store {held} B, stats {counted} B, "
                                 f"MeshRules {predicted} B")
        out["first_dispatch"] = sharded_first_dispatch(torch, eng, cfg,
                                                       spec["prompts"])
        out["exact"] = moe_exact(torch, eng, cfg, spec["prompts"],
                                 torch.load(spec["first"]))
        outs, launches, collectives, check = sharded_serve(
            torch, eng, cfg, spec["prompts"], spec["new_tokens"],
            spec["want"], "serve_sharded_moe",
            ref_logits=torch.load(spec["ref_logits"]),
            floor_tol=spec["floor_tol"], mesh=f"1x{world}", rank=rank,
            backend="gloo")
        out.update(tokens=outs, launches=launches, collectives=collectives,
                   collectives_per_dispatch=sharded_collectives(
                       cfg, eng, breakdown=True),
                   teacher_forced=check, stats=eng.stats())
        out["profile"] = rank_profile(torch, eng, rank, "serve_sharded_moe")


def phase_serve_sharded_moe(torch, device, args, ref, rehearsal):
    """Phase serve_sharded_moe: expert parallelism on serve_moe's model,
    store, prompts and streams (``ref``, whose store this phase frees).
    Step 1: a world of one rank in this process (``_moe_world_one``).
    Step 2: SHARD_TP ranks sharing the card on a (1, SHARD_TP) mesh, each
    in its own process (``sharded_moe_rank``), each holding its half of
    the experts.  Returns the launches of both runs (rank 0's for the
    two-rank run)."""
    import shutil
    t_phase = time.perf_counter()
    cfg, phase = ref["cfg"], "serve_sharded_moe"
    emit(phase, step="plan", n_layers=cfg.n_layers, of=moe_config(
        rehearsal).n_layers, experts=cfg.padded_experts, ranks=SHARD_TP)
    try:
        launches, baseline = _moe_world_one(torch, device, ref)
        del ref["store"]  # both ranks' halves do not fit beside it
        free_device(torch, device)
        MOE_REF_DIR.mkdir(parents=True, exist_ok=True)
        torch.save(ref["logits"], MOE_REF_DIR / "logits.pt")
        torch.save(ref["first"], MOE_REF_DIR / "first.pt")
        ranks = run_rank_processes(phase, "sharded_moe_rank", dict(
            n_layers=cfg.n_layers, block_1d=ref["policy"].block_1d,
            seed=args.seed, slots=ref["slots"], max_len=ref["max_len"],
            prompts=ref["prompts"], new_tokens=ref["new_tokens"],
            want=ref["want"], ref_logits=str(MOE_REF_DIR / "logits.pt"),
            first=str(MOE_REF_DIR / "first.pt"),
            floor_tol=REORDER_FACTOR * baseline["max_dev"]),
            SHARD_MOE_DIR, SHARD_TP, rehearsal)
    finally:
        shutil.rmtree(MOE_REF_DIR, ignore_errors=True)
    emit(phase, step="done", seconds=time.perf_counter() - t_phase,
         n_layers=cfg.n_layers, ranks=SHARD_TP,
         free_running_equal=ranks[0]["teacher_forced"]["free_running_equal"])
    return {"serve_sharded_moe_1x1": launches,
            f"serve_sharded_moe_1x{SHARD_TP}": ranks[0]["launches"]}


# ---------------------------------------------------------------------------
# the SSM, hybrid, encoder-decoder and VLM families ("serve_ssm",
# "serve_hybrid", "serve_encdec", "serve_vlm", "train_families")
# ---------------------------------------------------------------------------

def family_launch_counts(cfg, attn_backend, kind="decode"):
    """Kernel launches of one dispatch of the cached path, from the path
    (``stack_linears``): the fused matmul for each packed linear plus the
    head; the attention kernel at each cached causal self-attention where
    its gate is open (``attn_backend`` ``"cuda-packed"``); the quantizer
    for the weights that stay values and are quantized per call (an
    encoder-decoder's cross q and o).  An encoder-decoder's prefill runs
    ``encode`` alone through the kernels (its cross K/V are plain
    matmuls); any other prefill launches what a decode step does."""
    n = stack_linears(cfg)
    if kind == "prefill" and cfg.family == "encdec":
        return {"mxsf_fused_matmul": n["enc"], "mxsf_attention": 0,
                "mxsf_quantize": 0}
    return {"mxsf_fused_matmul": (1 + n["ssd"] + 4 * n["attn"] + n["mlp"]
                                  + 2 * n["cross"]),
            "mxsf_attention": (n["attn"] if attn_backend == "cuda-packed"
                               else 0),
            "mxsf_quantize": 2 * n["cross"]}


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _tree_bytes(tree):
    from repro_torch.serve.engine import _nbytes
    return _nbytes(tree)


def _finite_tree(torch, tree):
    from repro_torch.core.packed_store import tree_leaves
    return all(bool(torch.isfinite(t.float()).all())
               for t in tree_leaves(tree) if t.is_floating_point())


def family_store(torch, device, cfg, policy, args, phase):
    """The packed store drawn leaf by leaf on the card from ``--seed``."""
    from repro_torch.core.packed_store import store_nbytes
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    store = M.init_packed_params(cfg, policy, gen, device=device)
    _sync(torch, device)
    emit(phase, step="store", seconds=time.perf_counter() - t0,
         family=cfg.family, n_layers=cfg.n_layers, d_model=cfg.d_model,
         store_nbytes=store_nbytes(store))
    return store


def serve_family(torch, device, cfg, policy, store, prefill_batch, feed,
                 new_tokens, max_len, phase, **fields):
    """``prefill`` of ``prefill_batch`` into a fresh cache, then greedy
    ``decode_step``s: first the ``feed`` tokens (B, n) (an encoder-
    decoder's prompt; None for none), then ``new_tokens`` generated ones.
    Prints store and cache bytes, peak memory, prefill and decode
    tokens/s (host clock, synchronised), the launches of each kernel
    (which must equal the path's), finiteness of logits and cache; then a
    profiled decode step on a copy of the final cache.  Returns (launches,
    tokens)."""
    from repro_torch.models import model as M
    on_card = device.type == "cuda"
    B = next(iter(prefill_batch.values())).shape[0]
    cache = M.init_cache(cfg, B, max_len, ring=False,
                         kv_fmt=policy.kv_cache_fmt, device=device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _sync(torch, device)
    t0 = time.perf_counter()
    logits, cache = M.prefill(store, prefill_batch, cache, cfg, policy)
    _sync(torch, device)
    t_pre = time.perf_counter() - t0
    pos = 0 if cfg.family == "encdec" else prefill_batch["tokens"].shape[1]
    tok = None if logits is None else logits.argmax(-1)[:, None]
    steps = list(feed.unbind(1)) if feed is not None else []
    finite = logits is None or bool(torch.isfinite(
        logits[:, :cfg.vocab]).all())
    out = [] if tok is None else [tok[:, 0]]
    t_dec = 0.0
    for i in range(len(steps) + new_tokens):
        t = steps[i][:, None] if i < len(steps) else tok
        _sync(torch, device)
        t0 = time.perf_counter()
        logits, cache = M.decode_step(store, t, cache, pos + i, cfg, policy)
        tok = logits.argmax(-1)[:, None]
        finite &= bool(torch.isfinite(logits[:, :cfg.vocab]).all())
        t_dec += time.perf_counter() - t0
        if i >= len(steps) - 1:
            out.append(tok[:, 0])
    launches = {k: v for k, v in read_launches().items()
                if k in ("mxsf_fused_matmul", "mxsf_attention",
                         "mxsf_quantize")}
    backend = M.decode_attn_backend(cfg, policy)
    n_dec = len(steps) + new_tokens
    expect = {k: v + n_dec * family_launch_counts(cfg, backend)[k]
              for k, v in family_launch_counts(cfg, backend,
                                               "prefill").items()}
    tokens = torch.stack(out[:new_tokens], 1).tolist()
    prompt = sum(v.shape[1] for v in prefill_batch.values())
    finite &= _finite_tree(torch, cache)
    emit(phase, step="run", batch=B, prefill_positions=prompt,
         decode_steps=n_dec, max_len=max_len, tokens=tokens,
         store_bytes=_tree_bytes(store), cache_bytes=_tree_bytes(cache),
         prefill_seconds=t_pre, decode_seconds=t_dec,
         prefill_tokens_per_s=B * prompt / t_pre,
         decode_tokens_per_s=B * n_dec / t_dec, finite=finite,
         max_memory_allocated=(torch.cuda.max_memory_allocated()
                               if on_card else None),
         attn_backend=backend, launches=launches, expected_launches=expect,
         **fields)
    if not finite:
        raise AssertionError(f"{phase}: non-finite logits or cache")
    if on_card and launches != expect:
        raise AssertionError(f"{phase}: launch counts {launches} != path "
                             f"{expect}")
    if on_card:  # one more decode step on a copy, profiled
        probe = _clone_tree(cache)
        t = tok.clone()
        profile_dispatch(torch, lambda: M.decode_step(
            store, t, probe, pos + n_dec, cfg, policy), phase)
        del probe
    return launches, tokens


def checked_family(torch, device, cfg, policy, store, prefill_batch, feed,
                   max_len, phase):
    """The first prefill and the first decode step of ``serve_family``'s
    run again on a fresh cache, teacher-forced (``checked_kernels``):
    every kernel call within phase 3's tolerance of its plain version on
    its inputs, the calls the path's count, and the logits within the
    plain head's tolerance (``logits_against_plain``; an encoder-
    decoder's prefill has none).  The decode step feeds the kernel path's
    token (an encoder-decoder's first prompt token)."""
    from repro_torch.models import model as M
    backend = M.decode_attn_backend(cfg, policy)
    B = next(iter(prefill_batch.values())).shape[0]
    cache = M.init_cache(cfg, B, max_len, ring=False,
                         kv_fmt=policy.kv_cache_fmt, device=device)
    every = torch.ones(B, dtype=torch.bool, device=device)
    nxt, pos = None, 0
    for kind in ("prefill", "decode"):
        with checked_kernels(torch, lambda k: MATMUL_RTOL,
                             cfg.padded_vocab) as chk:
            if kind == "prefill":
                lk, cache = M.prefill(store, prefill_batch, cache, cfg,
                                      policy)
            else:
                lk, cache = M.decode_step(store, nxt, cache, pos, cfg,
                                          policy)
        kernels, faults = chk.rows(family_launch_counts(cfg, backend, kind))
        row = dict(kind=kind, kernels=kernels)
        if lk is not None:
            S = (sum(v.shape[1] for k, v in prefill_batch.items())
                 if kind == "prefill" else 1)
            last = torch.full((B,), S - 1, dtype=torch.int64, device=device)
            fields, logit_faults, tk = logits_against_plain(
                torch, chk, store["head"], cfg, lk, S, last, every)
            row.update(fields)
            faults += logit_faults
        emit(phase, step="slice", **row)
        if faults:
            raise AssertionError(f"{phase} slice ({kind}): {faults}")
        if kind == "prefill":
            nxt = feed[:, :1] if feed is not None else tk[:, None]
            pos = 0 if cfg.family == "encdec" else \
                prefill_batch["tokens"].shape[1]


def phase_family_kernels(torch, device, cfg, slots, chunk, L, phase):
    """The fused matmul at the family's widest packed linear (an SSD's
    in_proj, N not a multiple of 64 for mamba2 and zamba2) for a decode
    step's and a prefill's rows, and the attention kernel at its head
    shape (dh, group) for S = 1 and S = chunk over L keys, each against
    its plain version with the rows of phase ``kernels``."""
    gen = torch.Generator(device=device).manual_seed(11)
    timer = Timer(torch, device)
    rows = []
    if cfg.family in ("ssm", "hybrid"):
        from repro_torch.models.ssd import ssd_leaves
        n = dict((p[-1], s) for p, s, _ in ssd_leaves(cfg))["in_proj"][1]
        for m in (slots, slots * chunk):
            rows.append(check_matmul(torch, timer, gen, device, m,
                                     cfg.d_model, n))
    if cfg.family != "ssm":
        for S in (1, chunk):
            rows.append(check_attention(torch, timer, gen, device, cfg,
                                        slots, L, S))
    emit(phase, step="kernels", rows=len(rows))
    del timer
    return rows


def phase_serve_ssm(torch, device, args, rehearsal):
    """mamba2-780m at full width and depth (48 SSD layers, tied head) on
    the packed store (``MXSF_INFER``): batch 4, a 256-token prompt (two
    SSD chunks) through ``prefill``, 32 greedy decode steps."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import MXSF_INFER
    cfg = get_config("mamba2-780m")
    B, prompt, steps = 4, 256, 32
    if rehearsal:
        cfg, prompt, steps = cfg.reduced(), 32, 4
    policy = MXSF_INFER.replace(backend="cuda")
    phase_family_kernels(torch, device, cfg, B, prompt, prompt + steps,
                         "serve_ssm")
    store = family_store(torch, device, cfg, policy, args, "serve_ssm")
    batch = {"tokens": torch.tensor(_prompts(cfg, args.seed, [prompt] * B),
                                    device=device)}
    launches, _ = serve_family(torch, device, cfg, policy, store, batch,
                               None, steps, prompt + steps + 1, "serve_ssm")
    checked_family(torch, device, cfg, policy, store, batch, None,
                   prompt + 2, "serve_ssm")
    del store
    free_device(torch, device)
    return launches


def phase_serve_hybrid(torch, device, args, rehearsal):
    """zamba2-7b at full width and depth (81 SSD layers: 13 groups of 6,
    each followed by the one shared attention block, dh 112, MHA, and a
    tail of 3) on the packed store with the packed MXSF KV cache
    (``MXSF_INFER.replace(kv_cache_fmt="mxsf")``): batch 2, a 256-token
    prompt, max_len 512, 16 greedy decode steps."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import MXSF_INFER
    cfg = get_config("zamba2-7b")
    B, prompt, steps, max_len = 2, 256, 16, 512
    if rehearsal:
        cfg, prompt, steps, max_len = cfg.reduced(), 32, 4, 48
    policy = MXSF_INFER.replace(kv_cache_fmt="mxsf", backend="cuda")
    phase_family_kernels(torch, device, cfg, B, prompt, max_len,
                         "serve_hybrid")
    store = family_store(torch, device, cfg, policy, args, "serve_hybrid")
    batch = {"tokens": torch.tensor(_prompts(cfg, args.seed, [prompt] * B),
                                    device=device)}
    launches, _ = serve_family(torch, device, cfg, policy, store, batch,
                               None, steps, max_len, "serve_hybrid")
    checked_family(torch, device, cfg, policy, store, batch, None, max_len,
                   "serve_hybrid")
    del store
    free_device(torch, device)
    return launches


def phase_serve_encdec(torch, device, args, rehearsal):
    """whisper-medium at full width and depth (24 encoder + 24 decoder
    layers) on the packed store (cross-attention in values, as in the JAX
    package's) with the packed MXSF self cache: batch 2, 1500 seeded bf16
    frames through ``prefill`` (``encode`` and the cross K/V), a 4-token
    prompt fed by ``decode_step``, 16 new tokens, max_len 448."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import MXSF_INFER
    cfg = get_config("whisper-medium")
    B, prompt, steps, max_len = 2, 4, 16, 448
    if rehearsal:
        cfg, steps, max_len = cfg.reduced(), 4, 32
    policy = MXSF_INFER.replace(kv_cache_fmt="mxsf", backend="cuda")
    phase_family_kernels(torch, device, cfg, B, 16, max_len, "serve_encdec")
    store = family_store(torch, device, cfg, policy, args, "serve_encdec")
    frames = {"frames": _stub(torch, device, args.seed + 1,
                              (B, cfg.enc_seq, cfg.d_model), 1.0)}
    feed = torch.tensor(_prompts(cfg, args.seed, [prompt] * B),
                        device=device)
    launches, _ = serve_family(torch, device, cfg, policy, store, frames,
                               feed, steps, max_len, "serve_encdec",
                               frames=cfg.enc_seq, prompt=prompt)
    checked_family(torch, device, cfg, policy, store, frames, feed, max_len,
                   "serve_encdec")
    del store
    free_device(torch, device)
    return launches


def phase_serve_vlm(torch, device, args, rehearsal):
    """internvl2-1b at full width and depth (24 layers, GQA 14/2, dh 64,
    tied head) on the packed store with the packed MXSF cache: batch 2,
    256 seeded bf16 patch embeddings and a 64-token prompt through
    ``prefill``, 16 greedy decode steps; then the text-only
    ``ServeEngine`` on the same store (positions shifted past the prefix,
    whose columns stay unwritten) on the same prompts."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import MXSF_INFER
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("internvl2-1b")
    B, prompt, steps, chunk = 2, 64, 16, 16
    if rehearsal:
        cfg, prompt, steps, chunk = cfg.reduced(), 12, 4, 4
    policy = MXSF_INFER.replace(kv_cache_fmt="mxsf", backend="cuda")
    T = cfg.frontend_tokens
    max_len = prompt + steps + 1
    phase_family_kernels(torch, device, cfg, B, T + prompt, T + max_len,
                         "serve_vlm")
    store = family_store(torch, device, cfg, policy, args, "serve_vlm")
    toks = torch.tensor(_prompts(cfg, args.seed, [prompt] * B),
                        device=device)
    batch = {"tokens": toks,
             "embeds": _stub(torch, device, args.seed + 2,
                             (B, T, cfg.d_model), 0.02)}
    launches = {}
    launches["serve_vlm"], _ = serve_family(
        torch, device, cfg, policy, store, batch, None, steps, max_len,
        "serve_vlm", prefix=T)
    checked_family(torch, device, cfg, policy, store, batch, None, max_len,
                   "serve_vlm")
    eng = ServeEngine(cfg, store, policy, slots=B, max_len=max_len,
                      prefill_chunk=chunk, backend="cuda", device=device)
    _, launches["serve_vlm_text"] = serve_run(
        torch, eng, cfg, toks.tolist(), steps, "serve_vlm",
        engine="text-only", cache_bytes=_tree_bytes(eng.cache))
    unwritten = not bool((eng.cache["k_scales"][:, :, :, :T] > 0).any())
    emit("serve_vlm", step="prefix_columns_unwritten", ok=unwritten)
    if not unwritten:
        raise AssertionError("serve_vlm: the text-only engine wrote a "
                             "prefix column")
    del eng, store
    free_device(torch, device)
    return launches


def phase_train_families(torch, device, args, rehearsal):
    """``MXSF_TRAIN`` (2D) under the default remat ``"dots"``, 2 steps and
    one profiled, at full width: mamba2-780m (48 layers, 4 x 512),
    whisper-medium (24 + 24 layers, 2 x 448 over 1500 frames),
    internvl2-1b (24 layers, 4 x 512 behind the 256-embedding prefix) and
    zamba2-7b cut to 12 of its 81 layers (2 groups of 6: f32 weights and
    AdamW state at full depth exceed the card; printed).  Each step
    prints loss (finite, within 1.5 of ln(vocab) at init), seconds,
    tokens/s, peak memory and launches equal to the path's; then one step
    teacher-forced (``phase_train_slice``: every kernel call against its
    plain version, the calls the path's count).  mamba2 and whisper, whose
    activations are a large share of their peak, take two more steps at
    remat ``"none"`` (the first grows the allocator to the new peak): their
    peak and seconds beside ``"dots"``'."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import MXSF_TRAIN
    policy = MXSF_TRAIN.replace(backend="cuda")
    launches = {}
    runs = (("mamba2-780m", 4, 512, None, True),
            ("whisper-medium", 2, 448, None, True),
            ("internvl2-1b", 4, 512, None, False),
            ("zamba2-7b", 4, 512, 12, False))
    for arch, batch, seq, depth, no_remat in runs:
        cfg = get_config(arch)
        if rehearsal:
            cfg, batch, seq = cfg.reduced(), 2, 32
        elif depth:
            emit("train_families", arch=arch, step="cut",
                 n_layers=depth, of=cfg.n_layers)
            cfg = cfg.replace(n_layers=depth)
        t0 = time.perf_counter()
        state, batches, launches[f"train_{arch}"] = phase_train(
            torch, device, cfg, policy, args, 2, batch, seq, arch,
            profile=True, phase="train_families")
        phase_train_slice(torch, device, cfg, policy, state, batches[0],
                          arch, phase="train_families")
        if no_remat:
            state, _, launches[f"train_{arch}_no_remat"] = phase_train(
                torch, device, cfg, policy, args, 2, batch, seq, arch,
                phase="train_families", remat="none", state=state,
                batches=batches[:2])
        emit("train_families", arch=arch, step="done",
             seconds=time.perf_counter() - t0)
        del state, batches
        free_device(torch, device)
    return launches


# ---------------------------------------------------------------------------
# the dry run held against the card ("dryrun") and the examples ("examples")
# ---------------------------------------------------------------------------

DRYRUN_DIR = ROOT / "build" / "chip_smoke_dryrun"
# the cells traced (the decode cells that may fit one card, and phase
# "train"'s shape), in the workers that trace them
DRYRUN_WORKERS = ((("h2o-danube-1.8b", "smoke_train"),),
                  (("h2o-danube-1.8b", "decode_32k"),
                   ("h2o-danube-1.8b", "long_500k")),
                  (("mamba2-780m", "decode_32k"), ("mamba2-780m", "long_500k"),
                   ("internvl2-1b", "decode_32k"), ("zamba2-7b", "long_500k")))
DRYRUN_WAIT_S = 900  # a worker's time limit
_REHEARSAL_SHAPES = {"decode_32k": "rehearsal_decode",
                     "long_500k": "rehearsal_long"}


def dryrun_shapes(rehearsal: bool) -> dict:
    """The shapes the dry-run cells add to ``SHAPES``: phase "train"'s
    batch x seq; the rehearsal's tiny stand-ins for the rest."""
    from repro_torch.configs.base import ShapeConfig
    if not rehearsal:
        return {"smoke_train": ShapeConfig("smoke_train", 512, 4, "train")}
    return {"smoke_train": ShapeConfig("smoke_train", 32, 2, "train"),
            "rehearsal_decode": ShapeConfig("rehearsal_decode", 64, 2,
                                            "decode"),
            "rehearsal_long": ShapeConfig("rehearsal_long", 128, 1,
                                          "decode")}


def dryrun_cell(arch: str, shape: str, rehearsal: bool):
    return ((arch + "-reduced", _REHEARSAL_SHAPES.get(shape, shape))
            if rehearsal else (arch, shape))


def dryrun_worker(out_dir: str, rehearsal: str, *cells: str):
    """A worker process: ``launch.dryrun`` of each "arch:shape" cell with
    the kernel datapath (``--backend cuda``) and the packed KV cache, on
    ``meta`` tensors, its record written to ``out_dir``."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    SHAPES.update(dryrun_shapes(rehearsal == "1"))
    for cell in cells:
        arch, shape = cell.split(":")
        dryrun.main(["--arch", arch, "--shape", shape, "--backend", "cuda",
                     "--kv-cache", "mxsf", "--out", out_dir])


def start_dryrun(rehearsal: bool):
    """Start the dry-run workers (they need no card, so they trace on the
    host's cores while the card phases run; ``CUDA_VISIBLE_DEVICES`` is
    empty there, so none makes a CUDA context).  Returns the processes."""
    import os
    import shutil
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for i, cells in enumerate(DRYRUN_WORKERS):
        names = [":".join(dryrun_cell(a, s, rehearsal)) for a, s in cells]
        log = open(DRYRUN_DIR / f"worker{i}.log", "w")
        code = ("import sys, chip_smoke; "
                "chip_smoke.dryrun_worker(*sys.argv[1:])")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(DRYRUN_DIR),
             str(int(rehearsal)), *names], cwd=str(ROOT), env=env,
            stdout=log, stderr=subprocess.STDOUT))
        log.close()
    emit("dryrun", step="start", workers=len(procs),
         cells=[list(c) for w in DRYRUN_WORKERS for c in w])
    return procs


def stop_processes(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def _allocator(torch):
    """(bytes requested by live allocations, bytes allocated) on the card:
    the caching allocator's counters (allocated rounds each block up)."""
    stats = torch.cuda.memory_stats()
    return (stats["requested_bytes.all.current"],
            torch.cuda.memory_allocated())


def phase_dryrun(torch, device, args, rehearsal, procs):
    """Wait for the dry-run workers, then hold each traced cell that the
    trace says fits one card against one real step of the same program on
    the card, from ``--seed`` inputs (``dryrun.cell_inputs``): the
    argument bytes equal the allocator's requested bytes after the inputs
    are built (and the bytes of their storages), exactly; each kernel's
    launches equal the trace's; the step's ``max_memory_allocated`` printed
    beside the predicted peak with their ratio (an out-of-memory in a cell
    predicted to fit fails the phase); the step's seconds no less than the
    roofline's (the larger of compute and memory).  The outputs must be
    finite.  Returns the launches of each cell's step."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch import cost, dryrun
    from repro_torch.core.packed_store import tree_leaves
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    for i, proc in enumerate(procs):
        try:
            rc = proc.wait(timeout=max(1.0, DRYRUN_WAIT_S
                                       - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0:
            log = (DRYRUN_DIR / f"worker{i}.log").read_text()[-3000:]
            raise AssertionError(f"dry-run worker {i} exited {rc}:\n{log}")
    emit("dryrun", step="traced", wait_seconds=time.perf_counter() - t0)
    SHAPES.update(dryrun_shapes(rehearsal))
    launches = {}
    for arch, shape_name in (dryrun_cell(a, s, rehearsal)
                             for w in DRYRUN_WORKERS for a, s in w):
        rec = json.loads((DRYRUN_DIR / f"{arch}__{shape_name}__1x1.json")
                         .read_text())
        mem, roof = rec["memory"], rec["roofline"]
        roof_s = max(roof["compute_s"], roof["memory_s"])
        row = dict(arch=arch, shape=shape_name,
                   trace_seconds=rec["trace_seconds"], fits=rec["fits"],
                   predicted=dict(mem, launches=rec["cost"]["launches"],
                                  flops=rec["cost"]["flops_per_device"],
                                  hbm_bytes=rec["cost"]
                                  ["hbm_bytes_per_device"],
                                  aten_ops=rec["cost"]["aten_ops"],
                                  roofline_s=roof_s,
                                  dominant=roof["dominant"]))
        if not rec["fits"]:
            emit("dryrun", step="cell", ran=False, **row)
            continue
        cfg, shape = get_config(arch), SHAPES[shape_name]
        pol = dryrun.cell_policy("mxsf", shape.kind, kv_cache="mxsf",
                                 backend="cuda")
        tcfg, ocfg = dryrun.cell_config(arch.replace("-reduced", ""))
        free_device(torch, device)
        if on_card:
            base = _allocator(torch)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        inputs = dryrun.cell_inputs(cfg, shape, pol, ocfg, device=device,
                                    generator=gen)
        _sync(torch, device)
        row["argument_storage_bytes"] = cost.storage_bytes(inputs)
        if on_card:
            now = _allocator(torch)
            row["argument_requested_bytes"] = now[0] - base[0]
            row["argument_allocated_bytes"] = now[1] - base[1]
        run = dryrun.cell_program(cfg, shape, pol, tcfg, ocfg)
        reset_launches()
        _sync(torch, device)
        if on_card:  # the step's peak, not the inputs' construction's
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out = run(inputs)
        _sync(torch, device)
        row["seconds"] = time.perf_counter() - t1
        got = {k: v for k, v in read_launches().items() if v}
        launches[f"dryrun_{arch}_{shape_name}"] = got
        row["launches"] = got
        row["seconds_over_roofline"] = row["seconds"] / roof_s
        if on_card:
            row["max_memory_allocated"] = (torch.cuda.max_memory_allocated()
                                           - base[1])
            row["peak_over_predicted"] = (row["max_memory_allocated"]
                                          / mem["peak_bytes_per_device"])
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in tree_leaves(out[0] if shape.kind != "train"
                                          else out[1])
                     if isinstance(t, torch.Tensor))
        emit("dryrun", step="cell", ran=True, finite=finite, **row)
        faults = []
        if row["argument_storage_bytes"] != mem["argument_bytes"]:
            faults.append("argument storage bytes")
        if on_card:
            if row["argument_requested_bytes"] != mem["argument_bytes"]:
                faults.append("argument bytes requested on the card")
            if got != rec["cost"]["launches"]:
                faults.append(f"launches {got} != traced "
                              f"{rec['cost']['launches']}")
            if row["seconds"] < roof_s:
                faults.append("a step faster than its roofline")
        if not finite:
            faults.append("non-finite outputs")
        if faults:
            raise AssertionError(f"dryrun {arch} {shape_name}: {faults}")
        del inputs, out, run
        free_device(torch, device)
    return launches


EXAMPLES = (
    ("torch_quickstart.py", [], ("codes      :", "grad finite: True",
                                 "packed bytes:")),
    ("torch_serve_decode.py", ["--requests", "4", "--gen", "8"],
     ("weight store:", "generated 32 tokens", "sample:")),
    ("torch_train_lm.py", ["--small", "--steps", "3"],
     ("step     0", "done in")),
    ("torch_directcast_inference.py", ["--steps", "60"],
     ("BF16 baseline accuracy", "direct-cast mxsf")))


def phase_examples(torch, device, rehearsal):
    """Each of the port's examples once, as a subprocess on the card (on
    the CPU in the rehearsal) at a small size: it must exit 0 and print
    its key lines."""
    import os
    import shutil
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ckpt = ROOT / "build" / "chip_smoke_examples"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        for name, argv, lines in EXAMPLES:
            argv = list(argv)
            if name == "torch_train_lm.py":
                argv += ["--ckpt-dir", str(ckpt)]
            argv += ["--device", "cpu" if rehearsal else "cuda"]
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                                  *argv], capture_output=True, text=True,
                                 env=env, cwd=str(ROOT), timeout=600)
            missing = [ln for ln in lines if ln not in res.stdout]
            emit("examples", example=name, argv=argv,
                 returncode=res.returncode,
                 seconds=time.perf_counter() - t0, missing=missing,
                 tail=res.stdout.strip().splitlines()[-3:])
            if res.returncode != 0 or missing:
                raise AssertionError(f"example {name}: exit "
                                     f"{res.returncode}, missing {missing}"
                                     f"\n{res.stderr[-2000:]}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    free_device(torch, device)


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
    t_start = time.perf_counter()
    args = parse_args(argv)
    import torch
    if not args.cpu_rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (use --cpu-rehearsal on the CPU)",
              file=sys.stderr)
        return 2
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import MXSF_INFER
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
    # the rehearsal's reduced widths (64 = 4 heads x 16) hold whole
    # 16-element blocks per shard of phase serve_sharded's model axis
    policy = MXSF_INFER.replace(kv_cache_fmt="mxsf",
                                block_1d=16 if rehearsal else 64)

    kind = phase_device(torch, rehearsal)
    if not rehearsal:
        phase_build()
    procs = start_dryrun(rehearsal)
    try:
        line = run_phases(torch, device, args, rehearsal, cfg, policy, slots,
                          chunk, max_len, new_tokens, lengths, procs)
    finally:
        stop_processes(procs)
    emit("done", seconds=time.perf_counter() - t_start)
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


def run_phases(torch, device, args, rehearsal, cfg, policy, slots, chunk,
               max_len, new_tokens, lengths, procs):
    """Phases 3-17 in their order; returns the ``kernels`` line."""
    import shutil
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import MXSF_TRAIN
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
    del eng  # the serving store (~36 GB) makes room for the next phases
    free_device(torch, device)
    launches = {"serve": serve_launches}
    try:
        launches["ckpt_serve"], want, ck_cfg, ck_dir = phase_ckpt_serve(
            torch, device, cfg, policy, args, slots, chunk, max_len,
            new_tokens, lengths)
        free_device(torch, device)
        launches.update(phase_serve_sharded(
            torch, device, ck_cfg, policy, args, slots, chunk, max_len,
            new_tokens, lengths, ck_dir, want, rehearsal))
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    free_device(torch, device)
    launches.update(phase_serve_gemma2(torch, device, args, rehearsal))
    free_device(torch, device)
    launches["ring_swa"] = phase_ring_swa(torch, device, args, rehearsal)
    free_device(torch, device)
    launches["serve_moe"], moe_ref = phase_serve_moe(torch, device, args,
                                                     rehearsal)
    launches.update(phase_serve_sharded_moe(torch, device, args, moe_ref,
                                            rehearsal))
    del moe_ref
    free_device(torch, device)
    launches["serve_ssm"] = phase_serve_ssm(torch, device, args, rehearsal)
    launches["serve_hybrid"] = phase_serve_hybrid(torch, device, args,
                                                  rehearsal)
    launches["serve_encdec"] = phase_serve_encdec(torch, device, args,
                                                  rehearsal)
    launches.update(phase_serve_vlm(torch, device, args, rehearsal))
    # 2D (MXSF_TRAIN) at full depth, then the 1D layout at cut depth
    pol2 = MXSF_TRAIN.replace(backend="cuda")
    state, batches, launches["train_2d"] = phase_train(
        torch, device, train_cfg, pol2, args, 3, batch, seq, "2d",
        profile=True)
    phase_train_slice(torch, device, train_cfg, pol2, state, batches[0],
                      "2d")
    # one more step without remat: its peak and seconds beside "dots"
    state, _, launches["train_2d_no_remat"] = phase_train(
        torch, device, train_cfg, pol2, args, 1, batch, seq, "2d",
        remat="none", state=state, batches=batches[:1])
    del state, batches
    free_device(torch, device)
    cfg1 = train_cfg.replace(n_layers=min(4, train_cfg.n_layers))
    pol1 = pol2.replace(block_mode="1d", quantize_bwd=True)
    state, batches, launches["train_1d"] = phase_train(
        torch, device, cfg1, pol1, args, 2, batch, seq, "1d", profile=True)
    phase_train_slice(torch, device, cfg1, pol1, state, batches[0], "1d")
    del state, batches
    free_device(torch, device)
    launches["train_resume"] = phase_train_resume(
        torch, device, train_cfg.replace(n_layers=min(2, train_cfg.n_layers)),
        pol2, args, batch, seq)
    free_device(torch, device)
    # deit-tiny at full size, both layouts, batch 64 (paper Table III)
    enc_cfg = get_config("deit-tiny")
    enc_batch = 64 if not rehearsal else 4
    if rehearsal:
        enc_cfg = enc_cfg.reduced()
    for label, pol in (("2d", pol2), ("1d", pol1)):
        t0 = time.perf_counter()
        state, batches, launches[f"train_encoder_{label}"] = phase_train(
            torch, device, enc_cfg, pol, args, 3, enc_batch,
            enc_cfg.frontend_tokens + 1, label, profile=True,
            phase="train_encoder")
        phase_train_slice(torch, device, enc_cfg, pol, state, batches[0],
                          label, phase="train_encoder")
        emit("train_encoder", layout=label, step="done",
             seconds=time.perf_counter() - t0)
        del state, batches
        free_device(torch, device)
    launches.update(phase_train_families(torch, device, args, rehearsal))
    launches.update(phase_dryrun(torch, device, args, rehearsal, procs))
    phase_examples(torch, device, rehearsal)
    return kernels_line(rows, attn, train_rows, launches, slots, cfg)


if __name__ == "__main__":
    sys.exit(main())
