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
              (removed after this phase).  SHARD_TP ranks sharing the card
              on a (1, SHARD_TP) mesh, each a process started after the
              build, over gloo (NCCL refuses two ranks on one device;
              collectives go through host memory): each restores only its
              slices (store bytes equal to ``MeshRules``' prediction,
              restore peak within store + cache + RESTORE_SLACK), holds
              every kernel call of its first dispatch against the plain
              version at its shard-local shape (column-parallel N / tp,
              row-parallel K / tp, 20 / 4 heads), serves the prompts
              teacher-forced on phase 6's streams keeping each emitted
              logits row, its own choice and a digest of each sublayer's
              output, launches and collectives against their formulas;
              rank 0 profiles one decode dispatch (idle share,
              collectives' share; beside this process's work).  Meanwhile
              this process runs a world of one rank on NCCL,
              ``ServeEngine.from_checkpoint(mesh=make_test_mesh(1, 1))``
              giving phase 6's token streams bit for bit, its launches and
              collectives (NCCL) against their formulas; the same engine
              teacher-forced on those streams with every fused matmul on
              its plain version (the reorder baseline, which may not pass
              REORDER_CEILING on the card; it waits for the ranks to pass
              their checked first dispatch, as both dequantize whole
              weights); ``make_compressed_allreduce``
              over a gradient-sized tree equal to ``blocking.qdq`` of it
              bit for bit and a one-stage ``pipeline_apply`` against the
              sequential run; then, on the store that world restored, the
              emulation of the ranks' plan on one device
              (``emulating``: the plan stated from the config, the ranks'
              kernel calls at their shapes, the row-parallel f32 partials
              summed in rank order).  The exact gate: each rank's plan
              equal to the emulation's field by field, and its first
              dispatch's logits, every teacher-forced logits row and
              choice, and every sublayer digest equal to the emulation's
              bit for bit (``bitwise_rows`` of ``rows``, the first row and
              the first sublayer that differ printed); the emulation with
              a planted misstatement (each row-parallel partial rounded to
              bf16 before the sum) must miss each rank's first dispatch.
              The emulation's rows lie within REORDER_FACTOR times the
              reorder baseline of phase 6's (the one-device top-1 choices
              off the forced stream printed).  A rank that fails or
              outlives SHARD_WAIT_S fails the phase.
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
7b. train_sharded -- (after phase 8's 1D slice) the sharded train step
              of h2o-danube-1.8b at full width and TRAIN_SHARD_LAYERS (2)
              layers, global batch 4 x 512 (phase train's first batch):
              a world of one rank in this process on NCCL (the step on
              (1, 1) gives one device's gradients, loss and updated state
              bit for bit, each layout; its collectives against their
              formula); then two gloo ranks sharing the card
              (``sharded_train_rank``, results in
              ``build/chip_smoke_train_sharded/``) run a 2D step on (2, 1)
              (DP + FSDP) and on (1, 2) (TP) and a 1D step on (1, 2): state
              bytes a rank equal to ``MeshRules.shard_nbytes``, the
              gradient function teacher-forced (every kernel call within
              ``train_rtol`` at the shard-local shapes, the 2D forward's
              fused shapes checked), then one timed step (seconds, the
              collectives' host share, peak memory; launches and
              collectives against ``train_launch_counts`` and
              ``train_collectives``; its clip norm and a fingerprint of each
              updated slice of the params and moments), each rank also
              saving its gradient slices and each token's loss and
              sublayer digest of its rows (a forward through the sharded
              path); meanwhile this process computes each layout's
              one-device gradients and their reorder baseline (every
              matmul on its plain version) and each program's emulation
              on one device (``emulating_training``: the plan stated from
              the config (``emulated_plan``), each rank's sublayers at its
              shapes inside autograd, a column region's input gradients
              and the row-parallel f32 partials added in rank order, each
              DP rank's rows a pass of its own, the clip norm summed as the
              ranks group it, then AdamW) and the emulations of its
              controls (``local_dp_mean`` on (2, 1); ``bf16_partials`` and
              ``bf16_head_entry`` on (1, 2) 2D).  The exact gate: each
              rank's plan field by field, every gradient slice, the loss,
              every per-token loss, the clip norm and every updated state
              slice equal to the emulation's bit for bit (``bitwise_leaves``
              of ``leaves``, ``bitwise_state`` of ``state_slices``, the
              first leaf and sublayer that differ printed), each control
              missing every rank.  The old tolerance holds the emulation:
              its gradients within REORDER_FACTOR times the baseline's
              largest leaf move (capped by TRAIN_REORDER_CEILING), its loss
              within REORDER_FACTOR times the baseline's loss scale
              (``loss_move_scale``, capped by TRAIN_LOSS_CEILING), its
              per-token losses within REORDER_FACTOR times the baseline's
              RMS move of a token's loss (capped by TRAIN_TOKEN_CEILING; a
              gate that must reject the same tokens' losses read from the
              wrong rows or positions); and each rank's step equal to the
              mesh worker's trace of it (launches, collectives by kind,
              axis and bytes, argument bytes).
7c. train_sharded_moe -- (after phase 7b) MoE training's first card
              run and its sharded step: qwen2-moe-a2.7b at full width and
              TRAIN_MOE_LAYERS (2) layers, 4 x 512, 2D.  One device first
              (the state and both ranks do not fit the card at once):
              the gradient function's loss (within 1.5 of ln(vocab)),
              gradients, routing and per-token losses, kept on the host;
              the reorder baseline (every matmul on its plain version,
              capped by the MOE_TRAIN_*_CEILINGs); the EP backward's
              reference (layer EP_LAYER without its shared expert, on its
              captured input and a seeded output gradient); one timed and
              one profiled step (seconds, peak, idle share, launches equal
              to the path's); the emulation of the ranks' program and of
              its ``bf16_partials`` control (as phase 7b's, each rank's
              expert rows at its shapes), from the state drawn anew.  Then
              two gloo ranks on (1, 2) (``train_moe_rank``, results in
              ``build/chip_smoke_train_moe/``), each holding 32 of the 64
              expert rows: state bytes equal to ``MeshRules.
              shard_nbytes``; the gradient function teacher-forced at the
              shard-local shapes; the EP backward teacher-forced, the
              input gradient and the rank's expert rows' gradients bit for
              bit against one device's; phase 7b's exact gate against the
              emulation, every MoE layer's routing included (no token's
              experts differ), and its old tolerance on the emulation (the
              emulation's routing flips against one device printed); one
              timed step (seconds, the collectives' host share, peak) with
              launches and collectives against their formulas, and equal
              to the mesh worker's trace of it.
7d. train_sharded_families -- (after phase 7c) the sharded train step
              of the other families at full width, 2D, the SSD split
              over the model axis: mamba2-780m (2 of 48 layers, 4 x 512),
              zamba2-7b (one group of 6 SSD layers and its shared block,
              4 x 512) and whisper-medium (2 + 2 of 24 + 24 layers, 2 x
              448 over 1500 frames), each cut printed.  One device per
              family first (``reorder_reference``: gradients, loss and
              per-token losses kept on the host, the reorder baseline
              capped by TRAIN_FAM_CEILING), then one pair of gloo ranks
              on (1, 2) (``train_family_rank``, results in
              ``build/chip_smoke_train_families/``) runs the three in
              turn, held to one device (``_tolerance_gates``, no
              emulation yet): state bytes, every kernel call
              at the shard-local shapes (``train_local_shapes``),
              gradients, loss and tokens within REORDER_FACTOR times the
              baseline's moves, launches and collectives against their
              formulas, each rank's step equal to its trace; seconds,
              peak and the collectives' share printed.
8. train_slice -- one more train step of each layout (on the state the
              phase "train" left, with its first batch) teacher-forced:
              every quantize and requantize call (plain or transposed)
              and every set of emitted codes bit for bit against its plain
              version on the same
              inputs, every matmul call within ``train_rtol(K)`` =
              TRAIN_SUM_C sqrt(K) 2^-24 of sum|x w| of the exact sum of
              the plain version's products (the plain f32 version's own
              distance from it printed beside), the head's forward calls
              (one a chunk of the chunked loss) the path's, and the loss
              within the head's tolerance of the loss of the plain head's
              softcapped logits over every head call.
9. serve_gemma2 -- gemma2-9b at full width and 14 of its 42 layers
              (GEMMA2_SERVE_PERIODS; softcaps, alternating 4096-token SWA:
              the value-domain cached attention): one packed store shared
              by two ``ServeEngine``s of ``MXSF_INFER`` on the kernel
              datapath, the policy's bf16 value cache and the packed MXSF cache
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
11b. serve_sharded_moe -- expert parallelism on phase 11's model,
              store, prompts and streams: two gloo ranks sharing the card,
              each holding its half of the experts
              (``ServeEngine.from_init``), its first dispatch
              teacher-forced, routing and the gathered expert outputs
              bitwise on one device's layer inputs, serving teacher-forced
              on phase 11's streams; meanwhile this process runs a world
              of one rank on NCCL (tokens bit for bit), the reorder
              baseline, and the emulation of the ranks' plan on phase
              11's store (each rank's expert rows on its slots, the shared
              expert split as the plan says).  The exact gate and the
              emulation's tolerance as in phase 6b.
11c. dryrun_mesh -- the dry run on a mesh held against what the ranks of
              phases 6b, 11b and 14b ran.  A worker process started with
              phase 16's (no card) traces, on ``meta`` tensors, each rank
              of the programs those phases run on two gloo ranks --
              qwen2.5-32b at 16 layers (4 slots x 512, chunk 16) and
              qwen2-moe at MOE_LAYERS, packed store, MXSF cache, kernel
              datapath -- on a tracing mesh of (1, 2)
              (``dryrun.engine_dispatches``: the ``ServeEngine`` itself on
              this rank's slices, one prefill and one decode dispatch),
              and phase 14b's three families (``dryrun.lockstep_counts``:
              the lockstep prefill and first decode step).  Each rank of
              those phases ran the same two dispatches (counted before
              phase 14b's further decode steps); each rank's trace must
              equal them
              exactly: launches by kernel (on the card), collectives by
              kind and axis with their operand bytes, and argument bytes
              equal to the rank's store plus cache bytes.  The worker also
              traces qwen2.5-32b decode_32k on 16x16 and on 2x16x16 with
              the layer-period trace (``launch/dryrun.py``, packed MXSF
              cache, kernel datapath): per-rank peak, ``fits``, the
              collectives and the three roofline terms printed, and the
              argument bytes equal to ``MeshRules.shard_nbytes`` of the
              inputs.  It also traces each rank of phase 7b's programs
              (``trace_train_sharded``: ``dryrun.mesh_train_cell``, the
              sharded train step on ``meta``) and of phase 7c's, which
              those phases hold each rank's step to.
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
14b. serve_sharded_families -- mamba2-780m (48 layers, 4 x 256-token
              prompts), zamba2-7b (two groups and the tail: 15 layers, 2 x
              256) and whisper-medium (24 + 24, 2 x 1500 frames) on a
              (1, 2) mesh: a pair of gloo ranks a program, the three
              pairs at once sharing the card (their gathers are staged
              through host memory, so they overlap), each rank drawing
              its slices of the ``--seed`` store (bytes equal to
              ``MeshRules``' prediction), running the lockstep prefill
              and first decode step with every kernel call held against
              its plain version at its shard-local shape (launches and
              collectives recorded for phase 11c), then FAMILY_DECODES - 1
              more decode steps fed a seeded stream; each keeps every
              logits row, a digest of every sublayer output and of each
              stored cache slice.  Meanwhile this process draws the whole
              store, computes one device's logits and their reorder
              baseline (capped by FAMILY_REORDER_CEILING), and emulates
              the ranks' plan on one device (``emulating``: the SSD
              mixer once a rank on its heads, the gated norm's f32 sums
              of squares added in rank order, whisper's value-path
              attention on each rank's heads and its cross K/V on each
              rank's columns) over the same dispatches.  The exact gate:
              each rank's plan equal to the emulation's field by field,
              every logits row and its top-1, every sublayer digest and
              every stored cache slice bit for bit (``bitwise_rows`` of
              ``rows``, the first row, sublayer and cache leaf that
              differ printed); the emulation with ``bf16_partials``, and
              on the SSD families with ``local_norm`` (each rank's heads
              normalised by its own half of d_inner), must miss each
              rank's first dispatch.  The emulation's logits lie within
              REORDER_FACTOR times the baseline of one device's (the
              rows whose top-1 differs printed).
15. train_families -- ``MXSF_TRAIN`` (2D, remat ``"dots"``), 2 steps and
              one profiled, of mamba2-780m at 24 of its 48 layers (4 x
              512), whisper-medium at 6 + 6 of 24 + 24 (2 x 448 over 1500
              frames), internvl2-1b (4 x 512 behind its 256-embedding
              prefix) and zamba2-7b at 12 of its 81 layers (each cut
              printed), with launches equal to the path's; then one
              step of each teacher-forced as in ``train_slice``, and for
              mamba2-780m and whisper-medium two more steps at remat
              ``"none"`` (peak and seconds beside ``"dots"``').
15b. train_gemma2 -- gemma2-2b (``MXSF_TRAIN``, remat ``"dots"``, f32
              AdamW, uniform seeded tokens: ``lm_source`` prints that its
              256000^2 table would not fit): run ``full``, all 26 layers
              at full width, 4 x 512, 2D; run ``long``, 6 of 26 layers
              (local with the 4096 window and global in turn), 1 x 8192, 2D
              and 1D, through 8 query chunks of the training attention
              and 8 head chunks of the chunked loss, with both softcaps.
              Each: 2 steps and one profiled as in ``train`` (loss within
              1.5 of ln(vocab), launches equal to the path's, which count
              one head call a loss chunk), then one teacher-forced as in
              ``train_slice``, the loss gate over every head chunk.
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
              card at a small size, all at once: exit 0 and its key lines
              printed.
18. the ``kernels`` line (every CUDA kernel, its launches on each path,
   each counted from 0), then the ``{"ok": true, ...}`` line.

Phases 9-11b, 14, 14b and 11c run right after phase 6, phases 7b and
7c after phase 8's 1D slice, phases 15-15b after phase 13, phases 16-17
last, and a ``done`` line with the whole run's seconds comes before the
``kernels`` line.

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

# the serving engines of phases serve/ckpt_serve/serve_sharded and of
# serve_moe/serve_sharded_moe (by rehearsal: False on the card), which
# phase dryrun_mesh traces too
SERVE_SLOTS, SERVE_CHUNK = 4, 16
SERVE_MAX_LEN = {False: 512, True: 64}
BLOCK_1D = {False: 64, True: 16}  # the rehearsal's 64-wide layers split
# whole 16-element blocks over the model axis
CKPT_LAYERS = 16  # ckpt_serve's depth at most (the disk may allow fewer)
MOE_SLOTS = 4
MOE_MAX_LEN = {False: 256, True: 32}
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


def held_to_plain(torch, y, y_ref, xq, wq, keep=False, rtol=MATMUL_RTOL,
                  sums=None):
    """A matmul kernel's y against the plain version's y_ref on the same
    inputs (xq, wq: the f32 operands both multiply): max error and its
    ratio to rtol * sum_k |x_k w_k| (``sums``, where the caller has it);
    with ``keep`` also the plain output and the tolerance (tensors)."""
    if sums is None:
        sums = torch.matmul(xq.abs(), wq.abs())
    tol = rtol * sums + 1e-30
    err = (y - y_ref).abs()
    out = dict(max_abs_err=float(err.max()),
               err_over_tol=float(err.div_(tol).max()),
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


def train_launch_counts(cfg, policy, remat="dots", seq=None, tcfg=None):
    """Kernel launches of one train step, from the path: the layers' raw-
    weight mx_dots (``layer_matmuls``) plus the head's calls, each with
    its backward.  The LM head runs once a chunk of the chunked loss of
    ``tcfg`` over ``seq`` tokens (``lm_head_calls``); without them, and
    for the encoder's head on the cls row, once.  Remat ``"dots"``
    recomputes each layer's forward but its matmuls: x and w of each
    layer matmul are quantized again; ``"full"`` runs the layers'
    forward again."""
    nl = layer_matmuls(cfg)
    n = nl + (1 if tcfg is None or cfg.family == "encoder"
              else lm_head_calls(cfg, tcfg, seq))
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
                batches=None, tcfg=None):
    """``steps`` AdamW steps of ``make_train_step`` from random parameters
    (``init_state`` from ``--seed``): loss (and the encoder's accuracy),
    grad norm, lr, step seconds (host clock, synchronised), tokens/s
    (``seq`` tokens a sample), peak memory and each kernel's launches,
    which must equal the path's count on the card; with ``profile`` one
    more step, logged as the others are, runs under the profiler (device
    busy time by kernel; its seconds are the profiled wall time).  The
    step updates the state in place; ``state`` and ``batches`` continue an
    earlier run (another remat on the same state); ``tcfg`` is the step's
    ``TrainConfig`` but its remat (the default one without it).  Returns
    the state, the batches and the launches summed over the ``steps``
    steps (the profiled one not among them)."""
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
    tcfg = (tcfg or T.TrainConfig()).replace(remat=remat)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    emit(phase, layout=label, step="init", seconds=time.perf_counter() - t0,
         family=cfg.family, n_layers=cfg.n_layers, d_model=cfg.d_model,
         n_params=n_params, batch=batch, seq=seq, remat=remat,
         data=(None if cfg.family == "encoder" else lm_source(cfg)),
         xent_chunk=tcfg.xent_chunk, policy=str(policy))
    step_fn = T.make_train_step(cfg, policy, OptConfig(), tcfg)
    expect = train_launch_counts(cfg, policy, remat, seq, tcfg)
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
    is 0.1x).  The head's forward calls: with ``on_head``, the fused calls
    made inside the models' head functions (``transformer.lm_head``, once
    a chunk of the chunked loss, and ``encoder_head``), each passed to
    ``on_head(exact output, tolerance, x's dtype)`` and then dropped, so
    no two calls' exact outputs sit side by side; without it, the last
    fused call with ``head_n`` columns keeps them in ``head``."""

    def __init__(self, torch, rtol, head_n=None, on_head=None):
        self.torch, self.rtol = torch, rtol
        self.head_n, self.head, self.on_head = head_n, None, on_head
        self.in_head = 0  # depth of head-function calls being run
        self.calls = {k: [] for k in ("mxsf_fused_matmul", "mxsf_attention",
                                      "mxsf_quantize", "mxsf_requantize",
                                      "mxsf_matmul")}

    def _head_role(self, fn):
        def head(*args, **kw):
            self.in_head += 1
            try:
                return fn(*args, **kw)
            finally:
                self.in_head -= 1
        return head

    def _matmul(self, kind, y, y_plain, xq, wq, keep=False):
        k, torch = xq.shape[1], self.torch
        exact = torch.matmul(xq.double(), wq.double())
        sums = torch.matmul(xq.abs(), wq.abs())
        res = held_to_plain(torch, y, exact, xq, wq, keep, self.rtol(k),
                            sums)
        plain = held_to_plain(torch, y_plain, exact, xq, wq,
                              rtol=self.rtol(k), sums=sums)
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
            if self.on_head is not None:
                if self.in_head:
                    self.on_head(y_ref, tol, x.dtype)
            elif n == self.head_n:
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
        if self.on_head is not None:
            from repro_torch.models import transformer as TF
            for name in ("lm_head", "encoder_head"):
                self.saved.append((TF, name, getattr(TF, name)))
                setattr(TF, name, self._head_role(getattr(TF, name)))
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


def head_sums(torch, cfg, y_ref, tol, labels, cast):
    """One head call's part of the plain loss: the plain head's exact
    output ``y_ref`` (rows x padded columns) cast as mx_dot casts the
    head's output (``cast``) and, in f32, the final softcap as
    ``lm_head`` applies it; (its cross-entropy summed over ``labels``, the
    call's rows; their count; the largest logit tolerance: ``tol`` plus
    one bf16 ulp where the cast rounds to bf16 -- the softcap keeps it,
    |d/dz c tanh(z / c)| <= 1)."""
    from repro_torch.models.transformer import head_shape
    V = head_shape(cfg)[1]
    logits = y_ref[:, :V].to(cast).float()
    tol = tol[:, :V]
    if cast == torch.bfloat16:
        tol = tol + _bf16_ulp(torch, logits)
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    logits = logits.reshape(-1, V)[:, :n_out(cfg)]
    labels = labels.reshape(-1).long()
    nll = torch.nn.functional.cross_entropy(logits, labels, reduction="sum")
    return float(nll), int((labels != -100).sum()), float(tol.max())


def plain_head_loss(heads):
    """The plain head's loss over every head call (``head_sums`` of each:
    the mean over all their labels) and its tolerance: logsumexp and the
    gold logit each move by at most the largest |d logit| of any call."""
    n = sum(h[1] for h in heads)
    return (sum(h[0] for h in heads) / max(n, 1),
            2.0 * max(h[2] for h in heads))


def phase_train_slice(torch, device, cfg, policy, state, batch, label,
                      phase="train_slice", tcfg=None):
    """One train step teacher-forced (``checked_kernels``): every kernel
    call is held against its plain version on the same inputs, every
    matmul within ``train_rtol``; the head's forward calls must be the
    path's (``lm_head_calls``: one a chunk of the chunked loss), and the
    step's loss must match the plain head's loss over all of them
    (``head_sums`` of each call on its chunk's labels as the call runs,
    ``plain_head_loss``) within its tolerance.  ``tcfg``: the step's
    ``TrainConfig`` (the default one without it)."""
    from repro_torch.core.blocking import torch_dtype
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as T
    tcfg = tcfg or T.TrainConfig()
    step_fn = T.make_train_step(cfg, policy, OptConfig(), tcfg)
    labels = batch["label" if cfg.family == "encoder" else "labels"]
    seq = None if cfg.family == "encoder" else labels.shape[1]
    n_heads = 1 if seq is None else lm_head_calls(cfg, tcfg, seq)
    rows = labels.shape[-1] // n_heads  # each call's labels of a row
    cast = torch_dtype(cfg.compute_dtype)  # mx_dot's cast of the head
    heads = []

    def on_head(y_ref, tol, x_dtype):
        i = len(heads)
        if i >= n_heads:  # a call past the path's count: counted only
            heads.append(None)
            return
        lab = labels if seq is None else labels[:, i * rows:(i + 1) * rows]
        heads.append(head_sums(torch, cfg, y_ref, tol, lab, cast))

    t0 = time.perf_counter()
    with checked_kernels(torch, train_rtol, on_head=on_head) as chk:
        _, metrics = step_fn(state, batch)
    seconds = time.perf_counter() - t0
    loss = float(metrics["loss"])
    rows_k, faults = chk.rows(train_launch_counts(cfg, policy, tcfg.remat,
                                                  seq, tcfg))
    if len(heads) != n_heads:
        raise AssertionError(f"{phase} {label}: {len(heads)} head calls, "
                             f"the path makes {n_heads}")
    loss_plain, loss_tol = plain_head_loss(heads)
    emit(phase, layout=label, n_layers=cfg.n_layers, loss=loss,
         loss_plain_head=loss_plain, loss_abs_err=abs(loss - loss_plain),
         loss_tol=loss_tol, head_calls=len(heads), seconds=seconds,
         kernels=rows_k)
    if abs(loss - loss_plain) > loss_tol:
        faults.append("loss")
    if faults:
        raise AssertionError(f"{phase} {label}: {faults}")
    return rows_k


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
    kernels launched inside it.  Host operators are recorded only where
    ranges need them (a range finds its kernels through its host event):
    their trace of a training step took 20-30 s to process."""
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
        with profile(activities=[ProfilerActivity.CUDA] + (
                [ProfilerActivity.CPU] if ranges else [])) as prof:
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
                     max_len, new_tokens, lengths, max_layers=CKPT_LAYERS):
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
RANK_THREADS = 2  # a rank's CPU threads: the rehearsal's plain kernels sum
                  # in an order that may depend on them, so the emulation
                  # of the ranks runs at the same count
PLANTED = "bf16_partials"  # the misstatement of the plan the exact gate
                           # must reject (``emulating``)
REORDER_FACTOR = 2.0  # the emulation's logits' tolerance: this many times
                      # the largest move a pure f32 reorder of the matmuls
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


def lm_head_calls(cfg, tcfg, seq):
    """The LM head's calls a microbatch (``train/step.py``'s chunked
    loss: one a ``xent_chunk`` of the sequence where the chunks divide
    it, else one)."""
    c = tcfg.xent_chunk
    return seq // c if 0 < c < seq and seq % c == 0 else 1


def _leaf_use(specs, sizes, name, split=None, consumer="replicated"):
    """(forward, backward) collectives of one ``blocks.use`` of leaf
    ``name``, ``Counter``s over (kind, axis): a gather of each axis of
    size > 1 its stored spec splits (``split``'s model axis kept), whose
    gradient a DP axis reduce-scatters and the model axis narrows, or
    reduce-scatters where the consumer is split; a split consumer of a leaf
    the spec keeps whole over "model" enters the split (an all-reduce in
    the backward, issued whatever the axis size); the cut to the rank's
    slice of ``split`` (``take_slots``) gathers its gradient."""
    from collections import Counter
    from repro_torch.core import sharding as shd
    spec = specs[name][0]
    fwd, bwd = Counter(), Counter()
    for d, entry in enumerate(spec):
        if d == split and shd.axes_of(entry) == ("model",):
            continue
        for axis in shd.axes_of(entry):
            if sizes[axis] > 1:
                fwd["all-gather", axis] += 1
                if axis != "model" or consumer == "split":
                    bwd["reduce-scatter", axis] += 1
    if consumer == "split" and "model" not in shd.split_axes(spec):
        bwd["all-reduce", "model"] += 1
    if (split is not None and sizes["model"] > 1
            and shd.axes_of(spec[split]) != ("model",)):
        bwd["all-gather", "model"] += 1
    return fwd, bwd


def train_collectives(cfg, policy, tcfg, mesh_shape, seq, step=True):
    """Collectives of one sharded train step of any family (``step``
    False: of its gradient function alone) on a mesh of ``mesh_shape``
    (``{axis: size}``), by kind and axis, ``{kind: {axis: calls}}``, from
    the path, as a program of events -- each a leaf use (``_leaf_use``:
    the norms' weights, every linear, bias, router and expert stack, the
    embedding, the head), a column entry (``enter_split``, before q/k/v
    (and a cross-attention's k/v), gate/up, the SSD's in_proj and each
    head call of a split part: an all-reduce over "model" in the
    backward), a row-parallel sum (after wo, a dense or shared FFN's down
    and the SSD's out_proj, and the vocab-parallel lookup: an all-reduce
    over "model", issued whatever the axis size), the SSD norm's squares
    (a split consumer's sum: an all-reduce forward and backward), an MoE
    layer's experts (with more than one model rank: the take's gradient
    gathered, the outputs gathered) and each LM head call's logits
    (gathered over "model" where the vocab splits) -- in the remat regions
    ``_run_layers`` makes: a decoder's super-layer of ``moe_every``
    sublayers, an SSD layer, a hybrid's group of SSD layers with the
    shared block (whose leaves are gathered and their gradients
    reduce-scattered at every application), an encoder or decoder layer.
    A region's recompute reruns its forward collectives up to the last
    tensor the backward needs: all but a row-parallel sum that ends the
    region (a post-norm after it needs it).  Per microbatch besides: the
    lookup, the head calls (``lm_head_calls``), the encoder's cls,
    positions, final norm and whole head, and the loss sums over each DP
    axis of size > 1; then once a step (per microbatch under
    ``grad_compress``) the all-reduce over each DP axis of every leaf it
    does not split, and the clip norm's, one all-reduce of each group of
    leaves split alike over each axis of size > 1.  Checked for the plans
    these runs take: the context never gathered."""
    import torch
    from collections import Counter
    from repro_torch.core import sharding as shd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import blocks
    from repro_torch.models import transformer as TR
    from repro_torch.train.step import _flatten
    mesh = shd.AbstractMesh(tuple(mesh_shape.values()), tuple(mesh_shape))
    rules = mesh_lib.MeshRules(mesh)
    whole = TR.init_params(cfg, torch.Generator(), "meta")
    sh = rules.param_sharding_tree(whole)
    specs = mesh_lib.specs_by_name(whole, sh)
    plan = blocks.tp_plan(cfg, policy, whole, rules.tp_size, train=True)
    if plan.ctx_gather:
        raise AssertionError(f"no train count formula for {plan}")
    sizes = dict(mesh_shape)
    AR, AG = ("all-reduce", "model"), ("all-gather", "model")
    tp = sizes["model"] > 1

    def use(name, split=None, consumer="replicated"):
        fwd, bwd = _leaf_use(specs, sizes, name, split, consumer)
        return [(fwd, bwd, False)]

    def enter():
        return [(Counter(), Counter({AR: 1}), False)]

    def row_sum():
        return [(Counter({AR: 1}), Counter(), True)]

    def gathered_grad():  # a take's backward
        return [(Counter(), Counter({AG: 1}), False)] if tp else []

    def norm():
        return use("w")

    def cols(names, split: bool, pre=""):
        """Column-parallel linears (and biases: their one dim), or whole."""
        ev = []
        for name in names:
            dim = 0 if name.startswith("b") else 1
            ev += use(pre + name, dim if split else None)
        return ev

    def row(name, split: bool, pre=""):
        return (use(pre + name, 0) + row_sum() if split
                else use(pre + name))

    def attention(pre="", cross=False):
        hs = plan.heads
        bias = cfg.qkv_bias
        ev = (enter() if hs else []) + cols(["wq"] + ["bq"] * bias, hs, pre)
        ev += enter() if hs and cross else []
        ev += cols(["wk", "wv"] + ["bk", "bv"] * bias, hs, pre)
        return ev + row("wo", hs, pre)

    def mlp(split, pre=""):
        gated = cfg.mlp in ("swiglu", "geglu")
        ev = enter() if split else []
        ev += cols((["wg"] if gated else []) + ["wu"], split, pre)
        return ev + row("wd", split, pre)

    def moe():
        ev = use("router")
        for name in ("we_g", "we_u", "we_d"):
            ev += use(name, 0 if plan.experts else None)
        if plan.experts:  # the take's gradient, the outputs gathered
            ev += gathered_grad()
            ev += [(Counter({AG: 1}), Counter(), False)] if tp else []
        if cfg.n_shared_experts:
            ev += mlp(plan.shared, "shared/")
        return ev

    def sublayer(is_moe=False):
        post = norm() if cfg.post_norms else []
        return (norm() + attention() + post + norm()
                + (moe() if is_moe else mlp(plan.mlp)) + post)

    def ssd_layer():
        if not plan.ssm:
            ev = norm()
            for name in ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log",
                         "D", "norm_w", "out_proj"):
                ev += use(name)
            return ev
        ev = norm() + enter()
        for name in ("in_proj", "conv_w", "conv_b"):
            ev += use(name, consumer="split")
        for name in ("dt_bias", "A_log", "D"):
            ev += use(name) + gathered_grad()
        ev += [(Counter({AR: 1}), Counter({AR: 1}), False)]  # the squares
        return ev + use("norm_w", 0) + row("out_proj", True)

    def decoder_layer():
        return (norm() + attention() + norm() + attention("cross/", True)
                + norm() + mlp(plan.mlp))

    outside = []
    if cfg.family == "decoder":
        regions = [sum((sublayer(TR.is_moe_sublayer(cfg, j))
                        for j in range(cfg.moe_every)), [])] * (
            cfg.n_layers // cfg.moe_every)
    elif cfg.family == "ssm":
        regions = [ssd_layer()] * cfg.n_layers
    elif cfg.family == "hybrid":
        G, per, tail = TR.hybrid_split(cfg)
        regions = [ssd_layer() * per + sublayer()] * G + [ssd_layer()] * tail
    elif cfg.family == "encdec":
        regions = ([sublayer()] * cfg.n_enc_layers
                   + [decoder_layer()] * cfg.n_layers)
        outside += norm()  # enc_norm
    elif cfg.family == "encoder":
        regions = [sublayer()] * cfg.n_layers
        outside += use("cls") + use("pos") + norm() + use("head")
    else:
        raise AssertionError(f"no train count formula for {cfg.family}")
    if cfg.family != "encoder":  # the lookup and the LM head calls
        emb_split = shd.axes_of(specs["emb"][0][0]) == ("model",)
        outside += use("emb", 0) + row_sum() if emb_split else use("emb")
        head = ("emb", 0) if cfg.tie_embeddings else ("head", 1)
        call = norm() + (enter() if plan.vocab else []) + use(
            head[0], head[1] if plan.vocab else None)
        call += [(Counter({AG: 1}), Counter(), False)] if (
            plan.vocab and tp) else []
        outside += call * lm_head_calls(cfg, tcfg, seq)
    out = Counter()
    for ev in [e for r in regions for e in r] + outside:
        out.update(ev[0])
        out.update(ev[1])
    if tcfg.remat != "none":
        for r in regions:
            for e in (r[:-1] if r and r[-1][2] else r):
                out.update(e[0])
    n = tcfg.microbatches
    out = Counter({k: v * n for k, v in out.items()})
    for axis in rules.dp:
        if sizes[axis] == 1:
            continue
        out["all-reduce", axis] += n  # the loss sums
        whole_leaves = sum(axis not in shd.split_axes(ns.spec)
                           for _, ns in _flatten(sh))
        out["all-reduce", axis] += whole_leaves * (
            n if tcfg.grad_compress else 1)
    if step:
        groups = {tuple(a for a in mesh.axis_names if a in set(
            shd.split_axes(ns.spec, mesh_shape))) for _, ns in _flatten(sh)}
        for key in groups:
            for axis in key:
                out["all-reduce", axis] += 1
    res: dict = {}
    for (kind, axis), calls in sorted(out.items()):
        if calls:
            res.setdefault(kind, {})[axis] = calls
    return res


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
                  teacher=False, **fields):
    """``serve_run`` on a sharded engine (launches checked there), then its
    collectives against ``sharded_collectives``.  Free-running, the token
    streams must equal ``want``.  With ``teacher`` the engine runs
    teacher-forced on ``want`` and keeps what the exact gate holds to the
    emulation (``exact_gate``): each emitted token's logits row and the
    engine's own choice (``tap_emits``), and a digest of each sublayer's
    output (``layer_taps``).  Returns (token streams, launches,
    collectives, {rows, choices, taps} or None)."""
    from repro_torch.core import sharding as shd
    record = None
    if teacher:
        rows, choices = tap_emits(eng, cfg, {i + 1: t
                                             for i, t in enumerate(want)})
    shd.reset_counts()
    with layer_taps(torch) if teacher else contextlib.nullcontext() as taps:
        outs, launches = serve_run(torch, eng, cfg, prompts, new_tokens,
                                   phase, **fields)
    got = {k: v["calls"] for k, v in shd.counts().items()
           if k in ("all_reduce", "all_gather")}
    st = eng.stats()
    n = st["prefill_dispatches"] + st["decode_dispatches"]
    expect = {k: v * n for k, v in sharded_collectives(cfg, eng).items()
              if v}
    faults = []
    if teacher:
        record = dict(rows=rows, choices=choices, taps=taps)
    elif outs != want:
        faults.append(f"token streams {outs} != the reference's {want}")
    if got != expect:
        faults.append(f"collectives {got} != {expect}")
    emit(phase, step="collectives", **fields, collectives=got,
         expected=expect, collective_seconds={
             k: v["seconds"] for k, v in shd.counts().items()},
         collective_bytes_per_dispatch={
             k: v["bytes"] / n for k, v in shd.counts().items()},
         same_tokens=outs == want, teacher_forced=teacher)
    if faults:
        raise AssertionError(f"{phase} {fields}: {faults}")
    return outs, launches, got, record


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


# ---------------------------------------------------------------------------
# the (1, SHARD_TP) plan emulated on one device: the exact gate of phases
# serve_sharded and serve_sharded_moe
# ---------------------------------------------------------------------------

def emulated_plan(cfg, policy, tp=SHARD_TP, train=False) -> dict:
    """The plan of a store on a (., ``tp``) mesh, stated from the config
    and the policy's blocks alone (not from ``blocks.tp_plan``, which the
    exact gates hold to it field by field): the heads split where the
    family has attention (every family but the SSM), its query and kv
    heads both do and each rank's wq and wk columns hold whole column
    blocks; a row-parallel linear (wo, a dense FFN's wd, the shared
    expert's wd, the SSD's out_proj) splits where its local K holds whole
    row blocks (wo otherwise runs whole on the gathered context:
    ``ctx_gather``); a dense FFN (a decoder's, the hybrid's shared
    block's, the encoder-decoder's) where d_ff does so both ways; the
    vocab where the padded vocab splits and an untied head's local
    columns hold whole column blocks; the experts whenever there are some
    and ``tp`` > 1; the SSD heads where there is one group, d_inner and
    the SSD heads split into whole column blocks, B and C are whole
    weight blocks and out_proj's local rows are whole row blocks.  The
    blocks: a row block is the 1D block or the 2D tile; a column block
    holds whole weight blocks (a packed 2D store's tiles; a packed 1D
    weight's blocks run along K, and a training store's leaves are
    values) and, with ``train``, whole blocks of the output gradient the
    backward quantizes along N (the 2D tile, or the 1D block where the
    backward is quantized).  Keyed as ``TPPlan``'s fields."""
    fam = cfg.family
    n_moe = cfg.n_layers // cfg.moe_every if cfg.n_experts else 0
    shared = cfg.expert_ff * cfg.n_shared_experts if n_moe else 0
    mode = policy.block_mode
    kb = {"2d": policy.tile, "1d": policy.block_1d}.get(mode, 1)
    wb = policy.tile if mode == "2d" and not train else 1
    gb = 1
    if train and (mode == "2d" or mode == "1d" and policy.quantize_bwd):
        gb = kb
    nb = math.lcm(wb, gb)

    def rows(k):
        return k % tp == 0 and (k // tp) % kb == 0

    def cols(n):
        return n % tp == 0 and (n // tp) % nb == 0

    dh = cfg.head_dim if cfg.n_heads else 0
    heads = (fam != "ssm" and cfg.n_heads % tp == 0 and cfg.n_kv % tp == 0
             and cols(cfg.n_heads * dh) and cols(cfg.n_kv * dh))
    ffn = fam != "ssm" and (fam != "decoder" or cfg.n_layers > n_moe)
    gn = cfg.ssm_ngroups * cfg.ssm_state
    ssm = (fam in ("ssm", "hybrid") and cfg.ssm_ngroups == 1
           and cols(cfg.d_inner) and cols(cfg.ssm_heads) and gn % wb == 0
           and rows(cfg.d_inner))
    tied = cfg.tie_embeddings and fam != "encoder"
    return dict(heads=heads, mlp=ffn and rows(cfg.d_ff) and cols(cfg.d_ff),
                vocab=cfg.padded_vocab % tp == 0 and (
                    tied or cols(cfg.padded_vocab)),
                experts=n_moe > 0 and tp > 1,
                shared=shared > 0 and rows(shared) and cols(shared),
                ssm=ssm,
                ctx_gather=heads and not rows(cfg.n_heads * cfg.head_dim))


def emulated_roles(plan: dict) -> dict:
    """Each weight's role under ``plan``, by its name in the store (the
    last two parts of its path): ``"cols"`` (column-parallel), ``"rows"``
    (row-parallel) or ``"segments"`` (the SSD's in_proj: z, x and dt of a
    rank's heads, all of B and C); a leaf not named runs whole.  The
    attention sublayers: a decoder's and the hybrid's shared block's
    ``attn``, the encoder-decoder's encoder ``attn``, decoder ``self`` and
    ``cross`` (values, quantized on every call); the dense FFNs: ``ffn``,
    the encoder-decoder's decoder ``mlp``."""
    roles = {}
    if plan["heads"]:
        for pre in ("attn", "self", "cross"):
            roles.update({f"{pre}/{n}": "cols" for n in ("wq", "wk", "wv")})
            if not plan["ctx_gather"]:
                roles[f"{pre}/wo"] = "rows"
    for part, pres in (("mlp", ("ffn", "mlp")), ("shared", ("shared",))):
        if plan[part]:
            for pre in pres:
                roles.update({f"{pre}/wg": "cols", f"{pre}/wu": "cols",
                              f"{pre}/wd": "rows"})
    if plan["ssm"]:
        roles.update({"ssd/in_proj": "segments", "ssd/out_proj": "rows"})
    if plan["vocab"]:
        roles["head"] = "cols"
    return roles


@contextlib.contextmanager
def emulating(torch, store, plan: dict, tp=SHARD_TP, planted=None):
    """Inside the block a one-device run over ``store`` computes what the
    ``tp`` ranks of ``plan`` compute, through the kernels at the ranks'
    shapes (this script's hook, as ``reorder_baseline``'s kernel swap is).
    A weight's role (``emulated_roles``) comes from the store leaf the
    call reads, never from its shape (wq and wo are both 5120 x 5120 in
    qwen2.5-32b): a packed leaf's by the storage of the codes the fused
    matmul is handed; a value leaf's (whisper's cross wq and wo, quantized
    on every call) by the tensor ``blocks.dense`` is handed, each rank's
    slice quantized by the quantizer as the rank quantizes it (codes the
    emulation makes at a rank's shape run as they are).
    Column-parallel: ``tp`` calls on the column slices, concatenated;
    row-parallel: ``tp`` calls on the K slices, whose f32 partials are
    summed in rank order (with two ranks the all-reduce's ``a + b``) and
    rounded once.  Attention (with ``plan["heads"]``): the packed kernel
    ``tp`` times, each on one rank's query heads and its kv heads' slice
    of the cache; the value path (whisper's encoder and cross-attention)
    as ``blocks._attend`` on each rank's heads, the contexts concatenated
    before wo; whisper's cross
    K/V as one ``enc @ w`` a rank on its columns.  The SSD mixer (with
    ``plan["ssm"]``): ``ssd.ssd_forward`` / ``ssd_decode_step`` once a
    rank on its heads (in_proj's segment columns, its conv channels,
    dt / A / D, the scan or the state update, the conv tail in its
    compute layout), then the gated norm from each rank's f32 sum of
    squares over its d_inner / tp, added in rank order and divided by
    d_inner, and out_proj row-parallel; the state and conv tail stored
    whole (x channels gathered, B and C of rank 0).  The routed experts
    (with ``plan["experts"]``): ``blocks._expert_ffn`` once a rank on its
    expert rows and their slots, concatenated as the ranks' all-gather
    concatenates them.  Norms, the router, rope, the lookup and sampling
    run once, as every rank runs them whole.  ``planted`` misstates the
    plan (the negative control): ``"bf16_partials"`` rounds each
    row-parallel partial to bf16 before the sum, ``"rows_swapped"``
    multiplies each rank's K slice of x by the other rank's rows,
    ``"local_norm"`` normalises each rank's SSD heads by the mean over its
    own d_inner / tp."""
    import types
    import torch.nn.functional as Fn
    from repro_torch.ckpt.ckpt import _iter_leaves
    from repro_torch.core.blocking import QuantizedTensor, torch_dtype
    from repro_torch.core.mx_dot import mx_dot
    from repro_torch.kernels import mxsf_attention as MA
    from repro_torch.kernels import mxsf_fused_matmul as FM
    from repro_torch.kernels import mxsf_quant as MQ
    from repro_torch.models import blocks as TB
    from repro_torch.models import decoding as D
    from repro_torch.models import model as M
    from repro_torch.models import ssd as SSD
    from repro_torch.models import transformer as TF
    if planted not in (None, "bf16_partials", "rows_swapped", "local_norm"):
        raise ValueError(f"no planted misstatement {planted!r}")
    kf, kq, ka, kd = (FM.mxsf_fused_matmul, MQ.mxsf_quantize,
                      MA.mxsf_attention, TB.dense)
    kat, kout, kfwd, kdec, kgate = (TB._attend, TB._attn_out,
                                    SSD.ssd_forward, SSD.ssd_decode_step,
                                    SSD._gate_out)
    roles, names, values = emulated_roles(plan), {}, {}
    fresh = set()  # storage of codes made at a rank's shape: run as is
    for path, leaf in _iter_leaves(store):
        name = "/".join(path[-2:])
        key = (leaf.codes if isinstance(leaf, QuantizedTensor)
               else leaf).untyped_storage().data_ptr()
        if key in names or key in values:
            raise AssertionError(f"{path} shares its storage")
        if isinstance(leaf, QuantizedTensor):
            names[key] = name
        elif name in roles:
            values[key] = name

    def cut(t, dim, r, n):
        return t.narrow(dim, r * n, n).contiguous()

    def owner(r):  # the rank whose rows rank r's K slice meets
        return tp - 1 - r if planted == "rows_swapped" else r

    def summed(parts):  # row-parallel f32 partials, in rank order
        acc = None
        for y in parts:
            if planted == "bf16_partials":
                y = y.to(torch.bfloat16).float()
            acc = y if acc is None else acc + y
        return acc

    def local(leaf, codes, scales):
        fresh.add(codes.untyped_storage().data_ptr())
        return QuantizedTensor(codes, scales, leaf.fmt, leaf.block,
                               tuple(codes.shape), leaf.dtype)

    def fused(x, codes, scales, xblk=(1, 64), wblk=(64, 1),
              quantize_lhs=True, emit_codes=False):
        key = codes.untyped_storage().data_ptr()
        if key in fresh and quantize_lhs and not emit_codes:
            fresh.discard(key)
            return kf(x, codes, scales, xblk, wblk)
        name = names.get(key)
        if name is None or emit_codes or not quantize_lhs:
            raise AssertionError(f"a fused call serving does not make "
                                 f"(weight {name})")
        role = roles.get(name)
        k, n = codes.shape
        if role == "cols":
            return torch.cat([kf(x, cut(codes, 1, r, n // tp),
                                 cut(scales, 1, r, n // tp // wblk[1]),
                                 xblk, wblk) for r in range(tp)], 1)
        if role == "segments":
            raise AssertionError(f"{name} reached the fused matmul whole")
        if role != "rows":
            return kf(x, codes, scales, xblk, wblk)
        if x.shape[1] != k:
            raise AssertionError(f"{name}: K {x.shape[1]} != rows {k}")
        return summed(kf(cut(x, 1, r, k // tp),
                         cut(codes, 0, owner(r), k // tp),
                         cut(scales, 0, owner(r), k // tp // wblk[0]),
                         xblk, wblk) for r in range(tp))

    def quantize(x, block):
        out = kq(x, block)
        fresh.add(out[0].untyped_storage().data_ptr())
        return out

    def dense(x, w, policy):
        name = (None if isinstance(w, QuantizedTensor) else
                values.get(w.untyped_storage().data_ptr()))
        role = roles.get(name)
        if role is None:
            return kd(x, w, policy)
        if role == "cols":
            n = w.shape[-1] // tp
            return torch.cat([kd(x, cut(w, -1, r, n), policy)
                              for r in range(tp)], -1)
        k = w.shape[0] // tp  # rows: blocks._row_parallel of a value leaf
        return summed(mx_dot(cut(x, -1, r, k),
                             cut(w, 0, owner(r), k).to(x.dtype), policy,
                             f32_out=True) for r in range(tp)).to(x.dtype)

    def attention(q, kc, ks, vc, vs, *, causal=True, kv_len=None,
                  q_offset=None, window=None):
        if kc.ndim != 4:
            raise AssertionError("attention off the cache layout")
        BH, S, dh = q.shape
        B, kv = kc.shape[0], kc.shape[2]
        h = BH // B

        def mine(v, r):  # rank r's rows of a per-row (BH,) argument
            if not torch.is_tensor(v):
                return v
            return cut(v.reshape(B, h), 1, r, h // tp).reshape(-1)

        outs = [ka(cut(q.reshape(B, h, S, dh), 1, r, h // tp).reshape(
            -1, S, dh), *(cut(t, 2, r, kv // tp) for t in (kc, ks, vc, vs)),
            causal=causal, kv_len=mine(kv_len, r),
            q_offset=mine(q_offset, r), window=mine(window, r)).reshape(
            B, h // tp, S, dh) for r in range(tp)]
        return torch.cat(outs, 1).reshape(BH, S, dh)

    def attend(q, k, v, qpos, kpos, causal, window, p, x, cfg, policy,
               kv_prequant=False, pre=""):
        h, kv = q.shape[2], k.shape[2]
        TB._attn_out = lambda ctx, *a: ctx  # each rank's context, before wo
        try:
            ctxs = [kat(cut(q, 2, r, h // tp), cut(k, 2, r, kv // tp),
                        cut(v, 2, r, kv // tp), qpos, kpos, causal, window,
                        p, x, cfg, policy, kv_prequant, pre)
                    for r in range(tp)]
        finally:
            TB._attn_out = kout
        return kout(torch.cat(ctxs, -1), p, policy, pre)

    def experts(p, xe, cfg, policy):
        E = xe.shape[1]
        if E % tp:
            raise AssertionError(f"{E} expert rows do not split {tp} ways")
        c = E // tp
        return torch.cat([kx(dict(p, **{n: p[n].narrow(0, r * c, c)
                                        for n in ("we_g", "we_u", "we_d")}),
                             xe.narrow(1, r * c, c), cfg, policy)
                          for r in range(tp)], 1)

    @torch.no_grad()
    def prefill(params, batch, cache, cfg, policy):
        if cfg.family != "encdec":
            return kp(params, batch, cache, cfg, policy)
        enc = TF.encode(params, batch["frames"], cfg, policy)
        kvs = {"wk": [], "wv": []}
        for i in range(cfg.n_layers):
            lp = D.layer_params(params["dec_layers"], i)["cross"]
            for name, out in kvs.items():
                w = lp[name]
                n = w.shape[-1] // tp
                out.append(torch.cat([(enc @ cut(w, 1, r, n).to(
                    enc.dtype)).reshape(*enc.shape[:2], -1, cfg.head_dim).to(
                    torch.bfloat16) for r in range(tp)], 2))
        cache["cross"] = {"k": torch.stack(kvs["wk"]),
                          "v": torch.stack(kvs["wv"])}
        cache["cross_ready"] = torch.ones((), dtype=torch.int32,
                                          device=enc.device)
        return None, cache

    def segments(t, r, cfg, proj, unit=1):
        """Rank r's columns of in_proj (``proj``: z, x, B, C, dt) or of the
        conv channels (x, B, C): 1/tp of each split segment, all of the
        others."""
        dI, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
        widths = ([(dI, True)] if proj else []) + [
            (dI, True), (gn, False), (gn, False)] + (
            [(cfg.ssm_heads, True)] if proj else [])
        parts, start = [], 0
        for w, split in widths:
            n = w // tp if split else w
            lo = start + (r * n if split else 0)
            parts.append(t.narrow(-1, lo // unit, n // unit))
            start += w
        return torch.cat(parts, -1)

    def ssd_rank(fn, p, r, cfg):
        """``fn(weights, dims)`` (the port's SSD forward or decode step)
        on rank r's slice: its weights and dims; the gate it reaches is
        kept for ``gated``.  Returns (the gate's arguments, fn's
        result)."""
        Hl = cfg.ssm_heads // tp
        dims = types.SimpleNamespace(
            d_inner=cfg.d_inner // tp, ssm_heads=Hl, **{
                k: getattr(cfg, k) for k in (
                    "ssm_ngroups", "ssm_state", "ssm_headdim", "ssm_conv",
                    "ssm_chunk")})
        w = p["in_proj"]
        pr = dict({n: p[n].narrow(-1, r * Hl, Hl)
                   for n in ("A_log", "D", "dt_bias")},
                  in_proj=local(w, segments(w.codes, r, cfg, True),
                                segments(w.scale_e8m0, r, cfg, True,
                                         w.block[-1])),
                  **{n: segments(p[n], r, cfg, False)
                     for n in ("conv_w", "conv_b")})
        got = []
        SSD._gate_out = lambda *a: got.append(a)
        try:
            out = fn(pr, dims)
        finally:
            SSD._gate_out = kgate
        return got[0], out

    def gated(p, got, cfg, policy):
        """ssd._gate_out over the ranks' (weights, y, z, x) -- each the
        rank's D skip and gate, its f32 sum of squares, their sum in rank
        order over d_inner (``local_norm``: its own mean), its norm_w
        slice -- then out_proj row-parallel."""
        gs = []
        for pr, y, z, xr, *_ in got:
            y = y + xr * pr["D"].to(y.dtype)[None, None, :, None]
            g = y.reshape(*y.shape[:2], -1) * Fn.silu(z)
            gs.append((g, g.float()))
        sums = [torch.sum(gf * gf, dim=-1, keepdim=True) for _, gf in gs]
        total = sums[0]
        for s in sums[1:]:
            total = total + s
        w = p["out_proj"]
        k = w.codes.shape[0] // tp
        parts = []
        for r, (g, gf) in enumerate(gs):
            var = sums[r] / k if planted == "local_norm" else \
                total / cfg.d_inner
            y = (gf * torch.rsqrt(var + 1e-6)
                 * p["norm_w"].narrow(-1, r * k, k)).to(g.dtype)
            o = owner(r)
            parts.append(mx_dot(y, local(
                w, cut(w.codes, 0, o, k),
                cut(w.scale_e8m0, 0, o, k // w.block[0])), policy,
                f32_out=True))
        return summed(parts).to(torch.promote_types(
            gs[0][0].dtype, torch_dtype(w.dtype)))

    def whole_tail(tails, cfg):
        """The conv tail (..., K-1, C) from the ranks' compute layouts:
        each rank's x channels, then B and C (rank 0's)."""
        dIl = cfg.d_inner // tp
        return torch.cat([t[..., :dIl] for t in tails]
                         + [tails[0][..., dIl:]], -1)

    def ssd_forward(p, u, cfg, policy, *, return_state=False):
        runs = [ssd_rank(lambda pr, dims: kfwd(pr, u, dims, policy,
                                               return_state=True), p, r, cfg)
                for r in range(tp)]
        out = gated(p, [g for g, _ in runs], cfg, policy)
        if not return_state:
            return out
        states = [c for _, (_, c) in runs]
        return out, {"state": torch.cat([c["state"] for c in states], -3),
                     "conv": whole_tail([c["conv"] for c in states], cfg)}

    def ssd_decode_step(p, u, cache, cfg, policy):
        hg = cfg.ssm_heads // tp // cfg.ssm_ngroups
        mine = [{"state": cache["state"].narrow(-3, r * hg, hg).contiguous(),
                 "conv": segments(cache["conv"], r, cfg, False)}
                for r in range(tp)]
        got = [ssd_rank(lambda pr, dims: kdec(pr, u, mine[r], dims, policy),
                        p, r, cfg)[0] for r in range(tp)]
        out = gated(p, got, cfg, policy)
        cache["state"].copy_(torch.cat([c["state"] for c in mine], -3))
        cache["conv"].copy_(whole_tail([c["conv"] for c in mine], cfg))
        return out, cache

    kx, kp = TB._expert_ffn, M.prefill
    swaps = [(FM, "mxsf_fused_matmul", fused), (MQ, "mxsf_quantize",
                                                   quantize),
             (TB, "dense", dense)]
    if plan["heads"]:
        swaps += [(MA, "mxsf_attention", attention), (TB, "_attend", attend)]
        if any(name.startswith("cross/") for name in values.values()):
            swaps += [(M, "prefill", prefill), (D, "prefill", prefill)]
    if plan["experts"]:
        swaps.append((TB, "_expert_ffn", experts))
    if plan["ssm"]:
        swaps += [(SSD, "ssd_forward", ssd_forward),
                  (SSD, "ssd_decode_step", ssd_decode_step)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def digest(torch, t) -> str:
    """A 16-byte digest of a tensor's bytes."""
    import hashlib
    raw = t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.blake2b(raw, digest_size=16).hexdigest()


@contextlib.contextmanager
def layer_taps(torch, named=False):
    """Inside the block, a digest of each sublayer's output, in call order
    (this script's hook, as ``moe_taps`` is): ``blocks.attention``'s
    (after wo; ``"cross"`` where it reads an encoder's keys, else
    ``"attention"``), ``transformer._apply_ffn``'s (``"ffn"``),
    ``blocks.mlp``'s called outside it (``"mlp"``: the encoder-decoder's
    decoder) and the SSD mixer's (``"ssd"``, after out_proj), layer after
    layer, dispatch after dispatch.  A rank's are whole after their
    all-reduce, so a rank and the emulation digest the same tensors.
    Yields the list: of digests, or with ``named`` of (kind, digest)
    pairs."""
    from repro_torch.models import blocks as TB
    from repro_torch.models import ssd as SSD
    from repro_torch.models import transformer as TF
    digests, inside = [], []
    saved = [(TB, "attention"), (TF, "_apply_ffn"), (TB, "mlp"),
             (SSD, "ssd_forward"), (SSD, "ssd_decode_step")]
    attention, ffn, mlp, fwd, dec = (getattr(m, n) for m, n in saved)

    def tap(kind, t):
        digests.append((kind, digest(torch, t)) if named else
                       digest(torch, t))

    def attn(*a, **kw):
        out = attention(*a, **kw)
        cross = kw.get("kv_cached") is not None or \
            kw.get("kv_x") is not None
        tap("cross" if cross else "attention", out[0])
        return out

    def apply_ffn(*a, **kw):
        inside.append(1)
        try:
            out = ffn(*a, **kw)
        finally:
            inside.pop()
        tap("ffn", out)
        return out

    def dense_mlp(*a, **kw):
        out = mlp(*a, **kw)
        if not inside:
            tap("mlp", out)
        return out

    def ssd_forward(*a, **kw):
        out = fwd(*a, **kw)
        tap("ssd", out[0] if kw.get("return_state") else out)
        return out

    def ssd_decode_step(*a, **kw):
        out = dec(*a, **kw)
        tap("ssd", out[0])
        return out

    for (mod, name), fn in zip(saved, (attn, apply_ffn, dense_mlp,
                                       ssd_forward, ssd_decode_step)):
        setattr(mod, name, fn)
    try:
        yield digests
    finally:
        for (mod, name), fn in zip(saved, (attention, ffn, mlp, fwd, dec)):
            setattr(mod, name, fn)


@contextlib.contextmanager
def rank_threads(torch, n=RANK_THREADS):
    """The block at a rank's CPU thread count."""
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def run_first(torch, eng, prompts):
    """``eng``'s first prefill dispatch of ``prompts`` (a chunk of each
    slot's prompt from position 0) on a zeroed copy of its cache: its
    logits (each slot's row at its last valid token, f32) on the host."""
    B, C = eng.slots, eng.prefill_chunk
    toks = torch.zeros((B, C), dtype=torch.int64)
    nv = torch.zeros(B, dtype=torch.int64)
    for s, p in enumerate(prompts[:B]):
        n = min(C, len(p))
        toks[s, :n] = torch.tensor(p[:n])
        nv[s] = n
    dev = eng.device
    cache = {k: torch.zeros_like(v) for k, v in eng.cache.items()}
    return eng._prefill(eng.params, toks.to(dev), cache,
                        torch.zeros(B, dtype=torch.int64, device=dev),
                        nv.to(dev))[0].float().cpu()


def emulate_serving(torch, eng, cfg, prompts, new_tokens, want,
                    planted=PLANTED):
    """The (1, SHARD_TP) ranks' serving emulated on ``eng``, a one-device
    engine over the whole store that has served nothing yet, at the ranks'
    CPU thread count: the first dispatch (``run_first``) under the plan
    and under the plan misstated by ``planted``, then the prompts
    teacher-forced on ``want`` with each emitted row, choice and sublayer
    digest kept, as ``sharded_serve`` keeps them on a rank.  Returns the
    plan, both first dispatches' logits, the rows, choices and digests,
    and the seconds."""
    t0 = time.perf_counter()
    plan = emulated_plan(cfg, eng.policy)
    rows, choices = tap_emits(eng, cfg, {i + 1: t
                                         for i, t in enumerate(want)})
    with rank_threads(torch):
        with emulating(torch, eng.params, plan, planted=planted):
            misstated = run_first(torch, eng, prompts)
        with emulating(torch, eng.params, plan):
            first = run_first(torch, eng, prompts)
            with layer_taps(torch) as taps:
                reqs = [eng.submit(p, new_tokens) for p in prompts]
                eng.run()
    if not all(r.done for r in reqs):
        raise AssertionError("emulation: requests left unfinished")
    return dict(plan=plan, first=first, planted=misstated, rows=rows,
                choices=choices, taps=taps,
                seconds=time.perf_counter() - t0)


def first_tap_difference(got, want, n_layers=None):
    """The first sublayer whose digest differs between two runs of the
    same dispatches (``layer_taps``), or None.  A decoder's unnamed
    digests (``n_layers`` layers, an attention and an ffn digest a
    layer): (dispatch, layer, sublayer) from the index.  Named digests
    (``n_layers`` None; one list of (kind, digest) pairs a dispatch): the
    dispatch, the layer (the taps of its kind before it in that
    dispatch) and its kind.  A run cut short differs where it ends."""
    def first(a, b):
        return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    None if len(a) == len(b) else min(len(a), len(b)))

    if n_layers is not None:
        i = first(got, want)
        if i is None:
            return None
        per = 2 * n_layers
        return dict(dispatch=i // per, layer=i % per // 2,
                    sublayer=("attention", "ffn")[i % 2])
    for d in range(max(len(got), len(want))):
        a, b = (t[d] if d < len(t) else [] for t in (got, want))
        i = first(a, b)
        if i is not None:
            taps = b if i < len(b) else a
            kind = taps[i][0]
            return dict(dispatch=d, sublayer=kind,
                        layer=sum(k == kind for k, _ in taps[:i]))
    return None


def exact_gate(torch, phase, emu, ranks, out_dir, n_layers):
    """Each rank held to the emulation (``emulate_serving``) bit for bit:
    its plan field by field against ``emulated_plan``, its first
    dispatch's logits, every teacher-forced logits row and its own choice
    under ``torch.equal`` (``bitwise_rows`` of ``rows``; the first row
    that differs with its uid, token index and max |delta|), and every
    sublayer's output (the first that differs: dispatch, layer,
    sublayer).  The negative control: the emulation of the misstated plan
    must differ from each rank's first dispatch.  One line a rank;
    returns the faults."""
    faults, keys = [], sorted(emu["rows"])
    for r, res in enumerate(ranks):
        got = torch.load(out_dir / f"rank{r}.pt")
        plan_off = {k: dict(rank=res["tp_plan"].get(k), emulated=v)
                    for k, v in emu["plan"].items()
                    if res["tp_plan"].get(k) != v}
        same = [k for k in keys if k in got["rows"]
                and torch.equal(got["rows"][k], emu["rows"][k])
                and got["choices"][k] == emu["choices"][k]]
        off = next((k for k in keys if k not in same), None)
        if off is not None:
            row = got["rows"].get(off)
            off = dict(uid=off[0], i=off[1], choice=got["choices"].get(off),
                       emulated_choice=emu["choices"][off],
                       max_abs_delta=None if row is None else float(
                           (row - emu["rows"][off]).abs().max()))
        first_same = torch.equal(got["first"], emu["first"])
        rejected = not torch.equal(got["first"], emu["planted"])
        sub = first_tap_difference(got["taps"], emu["taps"], n_layers)
        extra = sorted(set(got["rows"]) - set(keys))
        emit(phase, step="exact", rank=r, plan_fields_off=plan_off,
             bitwise_rows=len(same), rows=len(keys), extra_rows=extra,
             first_row_differs=off, first_dispatch_bitwise=first_same,
             first_dispatch_max_abs_delta=float(
                 (got["first"] - emu["first"]).abs().max()),
             sublayers=len(emu["taps"]), first_sublayer_differs=sub,
             planted=PLANTED, planted_rejected=rejected,
             planted_max_abs_delta=float(
                 (got["first"] - emu["planted"]).abs().max()))
        if plan_off:
            faults.append(f"rank {r}: plan fields {sorted(plan_off)} off "
                          "the emulation's")
        if len(same) != len(keys) or extra:
            faults.append(f"rank {r}: {len(same)} of {len(keys)} rows "
                          f"bitwise (first off: {off}; first sublayer off: "
                          f"{sub})")
        if not first_same or sub is not None:
            faults.append(f"rank {r}: first dispatch bitwise {first_same}, "
                          f"first sublayer off {sub}")
        if not rejected:
            faults.append(f"rank {r}: the planted {PLANTED} went unnoticed")
    return faults


def emulation_check(torch, phase, emu, want, ref_logits, baseline,
                    ceiling):
    """The old tolerance, on the emulation: its teacher-forced rows within
    ``logit_check``'s tolerance of the one-device reference's at
    REORDER_FACTOR times the reorder baseline's move (capped by
    ``ceiling`` on the card by the caller); beside it, how many of its own
    top-1 choices differ from the stream it is forced on.  Returns
    (record, faults)."""
    check, faults = logit_check(torch, emu["rows"], emu["choices"], want,
                                ref_logits,
                                REORDER_FACTOR * baseline["max_dev"])
    emit(phase, step="emulation", seconds=emu["seconds"],
         plan=emu["plan"], floor_tol=REORDER_FACTOR * baseline["max_dev"],
         baseline_ceiling=ceiling,
         top1_off_stream=check["tokens"] - check["agree"], **check)
    return check, faults


# ---------------------------------------------------------------------------
# a (data, model) training program emulated on one device: the exact gate
# of phases train_sharded and train_sharded_moe
# ---------------------------------------------------------------------------

# the misstatements of a training plan the exact gate must reject
TRAIN_PLANTED = ("bf16_partials", "bf16_head_entry", "local_dp_mean")
_PIECES = {}  # the training emulation's autograd functions, made once


def _train_pieces(torch):
    """The training emulation's own autograd pieces (made on first use:
    this script imports torch only when it runs).  ``Entry(x, n, rnd)``:
    a column-parallel region's entry, one view of x a rank, whose
    backward adds the ranks' input gradients in rank order in their dtype
    (each rounded to bf16 first where ``rnd``), as the ranks' all-reduce
    adds them."""
    if not _PIECES:
        class Entry(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, n, rnd):
                ctx.rnd = rnd
                return tuple(x.view_as(x) for _ in range(n))

            @staticmethod
            def backward(ctx, *grads):
                acc = None
                for g in grads:
                    if ctx.rnd:
                        g = g.to(torch.bfloat16).to(g.dtype)
                    acc = g if acc is None else acc + g
                return acc, None, None

        _PIECES["Entry"] = Entry
    return _PIECES["Entry"]


@contextlib.contextmanager
def emulating_training(torch, plan: dict, mesh_shape, planted=None):
    """Inside the block the port's one-device gradient function computes
    what the ranks of a (data, model) = ``mesh_shape`` training program
    under ``plan`` (``emulated_plan(..., train=True)``) compute, through
    the kernels at the ranks' shapes and inside autograd, so the backward
    makes the ranks' calls and sums too (this script's hook, as
    ``emulating`` is for serving; a decoder LM's loss).  DP
    (``train.step.loss_fn``): each DP rank's rows run as a pass of their
    own, the loss is the passes' (nll sum, label count) pairs added in
    rank order and divided once, and each leaf's gradient is the passes'
    gradients added -- the all-reduce's and, with two ranks, the FSDP
    reduce-scatter's ``a + b``; a top-level leaf goes through one use a
    call site that the passes share, so a leaf used twice (a tied
    embedding) adds each use's gradients over the passes first, as each
    use's reduce-scatter does.  TP: a column-parallel region (attention's
    q/k/v, a dense FFN's or the shared expert's gate/up, the LM head)
    enters once a rank (``Entry``): each rank's linears read its own view
    of x, and the ranks' input gradients -- each the rank's own sum of
    its linears' -- are added in rank order in x's dtype (bf16 at bf16
    activations; the head enters in f32 and is rounded once after).  Each
    rank runs the port's own sublayer on its slices -- its heads, its
    columns of wq/wk/wv/wg/wu and biases, its rows of wo/wd, each an
    autograd view of the whole leaf, so the whole gradient assembles from
    disjoint slices exactly -- with its row-parallel linear swapped for
    the f32 partial (``mx_dot(f32_out=True)``); the partials are added in
    rank order and cast once, and the sum's backward hands every partial
    the whole gradient.  The head's columns are concatenated after each
    rank's softcap (the backward narrows); the lookup runs a rank at a
    time on its vocab rows with zero rows elsewhere, summed in rank order;
    each rank's expert rows (``blocks._expert_ffn``) run on its narrowed
    slots, their outputs concatenated.  Norms, the router, the dispatch
    and combine, rope and the loss run once a DP rank, as every model
    rank runs them whole.  The swaps hold in a remat recompute too (the
    pieces are module attributes, and ``Entry``'s forward is views).  A
    plan that gathers the attention context (``ctx_gather``) raises.
    ``planted`` misstates the plan (the negative controls):
    ``"bf16_partials"`` rounds every row-parallel partial to bf16 before
    the sum, ``"bf16_head_entry"`` each rank's head input gradient before
    the f32 sum, ``"local_dp_mean"`` divides the loss by DP rank 0's own
    label count."""
    from repro_torch.core.mx_dot import mx_dot
    from repro_torch.models import blocks as TB
    from repro_torch.models import transformer as TF
    from repro_torch.train import step as TS
    if planted not in (None,) + TRAIN_PLANTED:
        raise ValueError(f"no planted misstatement {planted!r}")
    dp, tp = mesh_shape
    Entry = _train_pieces(torch)
    k_attn, k_mlp, k_experts = TB.attention, TB.mlp, TB._expert_ffn
    k_head, k_loss = TF.lm_head, TS.loss_fn
    k_over_dp, k_rows = TS._over_dp, TB._row_parallel
    sites = {}  # top-level leaf uses shared by the DP passes of one call

    def grad_of(t):
        return torch.is_grad_enabled() and t.requires_grad

    def summed(parts, bf16=False):  # in rank order
        acc = None
        for y in parts:
            if bf16:
                y = y.to(torch.bfloat16).to(y.dtype)
            acc = y if acc is None else acc + y
        return acc

    def entered(x, rnd=False):
        return Entry.apply(x, tp, rnd) if grad_of(x) else (x,) * tp

    def cut(t, dim, r):  # rank r's 1/tp of dim
        n = t.shape[dim] // tp
        return t.narrow(dim, r * n, n)

    def site(key, leaf):
        if not grad_of(leaf):
            return leaf
        if key not in sites:
            sites[key] = leaf.view_as(leaf)
        return sites[key]

    def partial(x, p, name, split, policy, key=None):
        return mx_dot(x, p[name].to(x.dtype), policy, f32_out=True)

    @contextlib.contextmanager
    def rank_run():  # inside: one rank's sublayer, its f32 partial out
        TB._row_parallel = partial
        try:
            yield
        finally:
            TB._row_parallel = k_rows

    def attention(p, x, cfg, policy, **kw):
        if not plan["heads"]:
            return k_attn(p, x, cfg, policy, **kw)
        if plan["ctx_gather"] or any(kw.get(k) is not None for k in (
                "cache", "kv_x", "kv_cached")):
            raise NotImplementedError("the training emulation runs uncached "
                                      "self-attention with wo split")
        xs, outs = entered(x), []
        for r in range(tp):
            pr = dict(p, wo=cut(p["wo"], 0, r),
                      **{n: cut(p[n], -1, r) for n in ("wq", "wk", "wv")},
                      **{n: cut(p[n], 0, r) for n in ("bq", "bk", "bv")
                         if n in p})
            with rank_run():
                outs.append(k_attn(pr, xs[r], cfg, policy, **kw)[0])
        return summed(outs, planted == "bf16_partials").to(x.dtype), None

    def mlp(p, x, cfg, policy, part="mlp"):
        if not plan[part]:
            return k_mlp(p, x, cfg, policy, part)
        xs, outs = entered(x), []
        for r in range(tp):
            pr = {n: cut(p[n], -1, r) for n in ("wg", "wu") if n in p}
            pr["wd"] = cut(p["wd"], 0, r)
            with rank_run():
                outs.append(k_mlp(pr, xs[r], cfg, policy, part))
        return summed(outs, planted == "bf16_partials").to(x.dtype)

    def experts(p, xe, cfg, policy):
        E = xe.shape[1]
        c = -(-E // tp)

        def take(t, dim, r):  # rank r's c slots, zero rows past E
            lo = min(r * c, E)
            part = t.narrow(dim, lo, min(lo + c, E) - lo)
            if part.shape[dim] == c:
                return part
            pad = list(t.shape)
            pad[dim] = c - part.shape[dim]
            return torch.cat([part, t.new_zeros(pad)], dim)

        return torch.cat([k_experts(
            dict(p, **{n: take(p[n], 0, r) for n in ("we_g", "we_u",
                                                     "we_d")}),
            take(xe, 1, r).contiguous(), cfg, policy)
            for r in range(tp)], 1)[:, :E]

    def lookup(params, tokens):
        tok, emb = tokens.long(), site(("lookup", "emb"), params["emb"])
        if emb.shape[0] % tp:  # the stored spec keeps the vocab whole
            return emb[tok]
        n, rows = emb.shape[0] // tp, []
        for r in range(tp):
            idx = tok - r * n
            ok = (idx >= 0) & (idx < n)
            got = emb.narrow(0, r * n, n)[torch.clamp(idx, 0, n - 1)]
            rows.append(torch.where(ok[..., None], got,
                                    torch.zeros_like(got)))
        return summed(rows)

    def lm_head(params, x, cfg, policy):
        if not plan["vocab"]:
            return k_head(params, x, cfg, policy)
        x = TB.rmsnorm(params["final_norm"], x)
        tied = "head" not in params
        name = "emb" if tied else "head"
        w = site(("head", name), params[name])
        grad = grad_of(x)
        xs = entered(x.float(), planted == "bf16_head_entry") if grad \
            else None
        outs = []
        for r in range(tp):
            wr = cut(w, 0 if tied else 1, r)
            wr = wr.T if tied else wr
            y = (TB.dense(xs[r], wr.to(x.dtype), policy).to(x.dtype) if grad
                 else TB.dense(x, wr, policy)).float()
            if cfg.final_softcap:
                y = cfg.final_softcap * torch.tanh(y / cfg.final_softcap)
            outs.append(y)
        return torch.cat(outs, -1)

    def loss_fn(params, batch, cfg, policy, tcfg):
        if cfg.family == "encoder":
            raise NotImplementedError("the training emulation runs LMs")
        sites.clear()
        n = next(iter(batch.values())).shape[0] // dp
        sums = []
        for d in range(dp):
            got = []
            TS._over_dp = lambda *s: got.append(s) or s
            try:
                k_loss(params, {k: v.narrow(0, d * n, n)
                                for k, v in batch.items()}, cfg, policy,
                       tcfg)
            finally:
                TS._over_dp = k_over_dp
            sums.append(torch.stack(got[0]))
        s, m = summed(sums).unbind()
        if planted == "local_dp_mean":
            m = sums[0][1]
        loss = s / torch.clamp(m, min=1.0)
        return loss, {"loss": loss}

    swaps = [(TS, "loss_fn", loss_fn), (TF, "_lookup", lookup),
             (TF, "lm_head", lm_head), (TB, "attention", attention),
             (TB, "mlp", mlp)]
    if plan["experts"]:
        swaps.append((TB, "_expert_ffn", experts))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


MESH_AXES = ("data", "model")  # a training program's mesh axes


def rank_coords(mesh_shape):
    """Every rank of a (data, model) mesh, row-major: ``{axis: index}``."""
    return [dict(zip(MESH_AXES, (d, t))) for d in range(mesh_shape[0])
            for t in range(mesh_shape[1])]


def rank_cut(torch, t, spec, coords, sizes):
    """The slice of whole leaf ``t`` a rank at ``coords`` stores under
    ``spec`` (``sizes``: axis -> size): each split dim in ``c =
    ceil(n / shards)`` rows a shard (the axes of an entry major to
    minor), zero rows past the end (an uneven expert split)."""
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(
            entry, str) else tuple(entry)
        if not axes:
            continue
        shards, i = 1, 0
        for a in axes:
            shards, i = shards * sizes[a], i * sizes[a] + coords[a]
        n = t.shape[d]
        c = -(-n // shards)
        lo = min(i * c, n)
        part = t.narrow(d, lo, min(lo + c, n) - lo)
        if part.shape[d] < c:
            pad = list(t.shape)
            pad[d] = c - part.shape[d]
            part = torch.cat([part, t.new_zeros(pad)], d)
        t = part
    return t


def train_specs(cfg, ocfg, mesh_shape):
    """``{path: stored spec}`` of a train state's params on a (data,
    model) = ``mesh_shape`` mesh (``MeshRules``, as the ranks store them;
    the moments follow them)."""
    from repro_torch.core import sharding as shd
    from repro_torch.train import step as T
    sh = T.state_shardings(cfg, ocfg, shd.AbstractMesh(mesh_shape,
                                                       MESH_AXES))
    return {"/".join(p): tuple(ns.spec)
            for p, ns in T._flatten(sh["params"])}


def emulated_grad_norm(torch, grads, specs, mesh_shape):
    """The clip's grad norm as the ranks of a (data, model) mesh sum it
    (``adamw.global_norm`` with shardings): each rank's sum of squares of
    each of its slices (cut from the whole ``grads`` by ``specs``), added
    by group of split axes of size > 1 in leaf order; each group all-reduced over its axes in turn (the ranks along
    an axis added in rank order); the groups added in order.  Returns
    every rank's norm, row-major."""
    from repro_torch.train import step as T
    sizes = dict(zip(MESH_AXES, mesh_shape))
    ranks = rank_coords(mesh_shape)
    groups = []
    for co in ranks:
        mine = {}
        for path, g in T._flatten(grads):
            key = "/".join(path)
            part = rank_cut(torch, g, specs[key], co, sizes).contiguous()
            sq = torch.sum(torch.square(part.float()))
            split = {a for e in specs[key] if e is not None
                     for a in ((e,) if isinstance(e, str) else e)
                     if sizes[a] > 1}
            axes = tuple(a for a in MESH_AXES if a in split)
            mine[axes] = sq if axes not in mine else mine[axes] + sq
        groups.append(mine)

    def all_reduced(vals, at, dim):  # over the ranks along dim, in order
        acc = None
        for j in range(mesh_shape[dim]):
            v = vals[at[:dim] + (j,) + at[dim + 1:]]
            acc = v if acc is None else acc + v
        return acc

    norms = []
    for co in ranks:
        total = None
        for axes in groups[0]:
            vals = {tuple(c.values()): g[axes] for c, g in zip(ranks,
                                                               groups)}
            for a in axes:
                vals = {k: all_reduced(vals, k, MESH_AXES.index(a))
                        for k in vals}
            v = vals[tuple(co.values())]
            total = v if total is None else total + v
        norms.append(torch.sqrt(total))
    return norms


def fingerprint(torch, t) -> str:
    """A fingerprint of a tensor's bits, computed where it lies (a
    digest of the tens of GB of a state's slices costs seconds on the
    host): two sums of its 32-bit words (16-bit for 2-byte elements) as
    int64, plain and weighted by a multiplicative hash of each word's
    position, wrapping on overflow.  Equal bits give equal fingerprints;
    a change goes unseen only where it cancels in both sums."""
    flat = t.detach().reshape(-1).contiguous()
    words = flat.view(torch.int32 if flat.element_size() == 4
                      else torch.int16).to(torch.int64)
    pos = torch.arange(words.numel(), device=words.device)
    weights = (pos * 2654435761 + 40503) & 0xFFFFFFFF
    return f"{int(words.sum()):x}:{int((words * weights).sum()):x}"


def fingerprints(torch, trees: dict) -> dict:
    """``{tree: {path: fingerprint}}`` of each leaf of each tree."""
    from repro_torch.train import step as T
    return {name: {"/".join(p): fingerprint(torch, t)
                   for p, t in T._flatten(tree)}
            for name, tree in trees.items()}


def emulate_train(torch, cfg, pol, tcfg, ocfg, state, batch, mesh_shape,
                  planted=(), step=True):
    """A (data, model) = ``mesh_shape`` training program emulated on one
    device (``emulating_training``) from the whole ``state`` (updated in
    place with ``step``) on the whole ``batch``, at the caller's thread
    count: the plan (``emulated_plan``), the loss, the whole gradients
    (on the host), each MoE layer's routing (``moe_train_taps``), each DP
    rank's per-token losses and sublayer digests (``layer_taps``) from a
    forward of its rows, each misstatement of ``planted``'s loss and
    whole gradients; with ``step``, each rank's clip norm
    (``emulated_grad_norm``) and AdamW on the whole state with it, each
    rank's slices of the updated params and moments fingerprinted.
    Returns
    the record the exact gate reads, its seconds and the seconds of each
    part."""
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adamw
    from repro_torch.train import step as T
    t0 = time.perf_counter()
    dp, tp = mesh_shape
    plan = emulated_plan(cfg, pol, tp, train=True)
    grad_fn = T.make_grad_fn(cfg, pol, tcfg)
    parts = {}

    def lap(name):  # seconds of each part, on the card synchronised
        if state["opt"]["step"].is_cuda:
            torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    with emulating_training(torch, plan, mesh_shape), \
            moe_train_taps(torch, -1) as routing:
        metrics, grads = grad_fn(state["params"], batch)
    lap("grads")
    n_moe = cfg.n_layers // cfg.moe_every if cfg.n_experts else 0
    specs = train_specs(cfg, ocfg, mesh_shape)
    out = dict(plan=plan, mesh=list(mesh_shape), loss=float(metrics["loss"]),
               topi=routing["topi"][:n_moe], nll=[], taps=[], planted={},
               specs=specs)
    n = batch["tokens"].shape[0] // dp
    for d in range(dp):
        rows = {k: v.narrow(0, d * n, n) for k, v in batch.items()}
        with emulating_training(torch, plan, mesh_shape), torch.no_grad(), \
                layer_taps(torch) as taps:
            logits = TF.forward(state["params"], rows, cfg, pol)
        out["nll"].append(token_nll(torch, logits, rows["labels"],
                                    cfg.vocab).cpu())
        out["taps"].append(taps)
        del logits
    lap("forward")
    for name in planted:
        with emulating_training(torch, plan, mesh_shape, planted=name):
            m_p, g_p = grad_fn(state["params"], batch)
        out["planted"][name] = dict(loss=float(m_p["loss"]), grads={
            "/".join(p): g.detach().cpu() for p, g in T._flatten(g_p)})
        del g_p
    lap("controls")
    if step:
        norms = emulated_grad_norm(torch, grads, specs, mesh_shape)
        out["grad_norm"] = [float(v) for v in norms]
        saved = adamw.global_norm
        adamw.global_norm = lambda tree, shardings=None: norms[0]
        try:
            adamw.apply_updates(state["params"], grads, state["opt"], ocfg)
        finally:
            adamw.global_norm = saved
        lap("step")
        sizes = dict(zip(MESH_AXES, mesh_shape))
        trees = {"params": state["params"], "m": state["opt"]["m"],
                 "v": state["opt"]["v"]}
        out["state"] = [fingerprints(torch, {name: {
            "/".join(p): rank_cut(torch, t, specs["/".join(p)], co, sizes)
            for p, t in T._flatten(tree)} for name, tree in trees.items()})
            for co in rank_coords(mesh_shape)]
        lap("fingerprints")
    out["grads"] = {"/".join(p): g.detach().cpu() for p, g in
                    T._flatten(grads)}
    del grads
    lap("to_host")
    out.update(seconds=time.perf_counter() - t0, parts=parts)
    return out


def emulate_program(torch, device, plan, prog, batch, seed):
    """``emulate_train`` of one program of a sharded training plan (its
    mesh, layout and controls) from the state one device draws from
    ``seed``, at a rank's CPU thread count."""
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as T
    cfg, pol, tcfg = train_sharded_program(dict(plan, **prog),
                                           prog["layout"])
    state = T.init_state(torch.Generator(device=device).manual_seed(seed),
                         cfg, OptConfig(), device=device)
    with rank_threads(torch):
        emu = emulate_train(torch, cfg, pol, tcfg, OptConfig(), state, batch,
                            tuple(prog["mesh"]), prog["controls"])
    del state
    free_device(torch, device)
    return emu


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
    (``one_rank_world``); its reorder baseline waits for the two-rank
    run's ranks to pass their checked first dispatch (``ranks_past``:
    their checks and this baseline each dequantize whole weights, and
    together they have filled the card).  Returns (launches, the reorder
    baseline, the store it restored)."""
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
        ranks_past(SHARD_DIR, "first")
        baseline = reorder_baseline(torch, eng, cfg, prompts, new_tokens,
                                    want, torch.load(CKPT_ROOT / "logits.pt"))
        emit("serve_sharded", step="reorder_baseline",
             ceiling=REORDER_CEILING if on_card else None, **baseline)
        if on_card and baseline["max_dev"] > REORDER_CEILING:
            raise AssertionError(
                f"serve_sharded: the reorder baseline moved the logits by "
                f"{baseline['max_dev']}, past its ceiling {REORDER_CEILING}")
        store = eng.params
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
    return launches, baseline, store


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
    A body that ends well meets its peers at a barrier before the group
    is torn down: no rank destroys its group (rank 0 hosts the group's
    store) while a peer is still in a collective or its teardown.  Yields
    (torch, device, rank, world, results)."""
    import datetime
    import torch
    import torch.distributed as dist
    rank, world = int(rank), int(world)
    device = torch.device("cpu" if rehearsal == "1" else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.set_device(0)  # the ranks share the one card
    else:
        torch.set_num_threads(RANK_THREADS)
    out = {"rank": rank}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    ended = False
    try:
        yield torch, device, rank, world, out
        ended = True
    except BaseException as e:
        out["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"rank{rank}.json").write_text(json.dumps(
            out, default=str))
        if dist.is_initialized():
            if ended:
                dist.barrier()
            dist.destroy_process_group()




def sharded_rank(rank: str, world: str, port: str, rehearsal: str,
                 spec_file: str):
    """One rank of phase serve_sharded's two-rank run (started after the
    build, so it loads the built kernels): restore its slices of the
    checkpoint, hold every kernel call of its first dispatch against the
    plain version, serve the prompts teacher-forced on ckpt_serve's
    streams, write its results to SHARD_DIR (what the exact gate reads in
    ``rank<r>.pt``) and profile one decode dispatch on rank 0."""
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
        out["first_dispatch"], first = sharded_first_dispatch(
            torch, eng, cfg, spec["prompts"])
        free_device(torch, device)  # the checks' buffers back to the card
        (SHARD_DIR / f"first{rank}").touch()
        out["dispatch"] = dispatch_counts(torch, eng)
        outs, launches, collectives, record = sharded_serve(
            torch, eng, cfg, spec["prompts"], spec["new_tokens"],
            spec["want"], "serve_sharded", teacher=True, mesh=f"1x{world}",
            rank=rank, backend="gloo")
        torch.save(dict(record, first=first), SHARD_DIR / f"rank{rank}.pt")
        out.update(tokens=outs, launches=launches, collectives=collectives,
                   stats=eng.stats())
        out["profile"] = rank_profile(torch, eng, rank, "serve_sharded")


def dispatch_counts(torch, eng):
    """The prefill and the decode dispatch of ``engine.probe_dispatches``
    on a sharded engine: the launches by kernel (on the card; the
    rehearsal counts none) and the collectives by kind and axis with
    their operand bytes; and the store and cache bytes this rank holds.
    Phase dryrun_mesh holds the rank's trace to them."""
    from repro_torch.core import sharding as shd
    from repro_torch.launch import cost
    from repro_torch.serve import engine as E
    dev = eng.device
    out = dict(n_layers=eng.cfg.n_layers, store_bytes=_tree_bytes(
        eng.params), cache_bytes=_tree_bytes(eng.cache))
    for kind, _, run in E.probe_dispatches(eng):
        _sync(torch, dev)
        reset_launches()
        shd.reset_counts()
        run()
        _sync(torch, dev)
        out[kind] = dict(
            launches=({k: v for k, v in read_launches().items() if v}
                      if dev.type == "cuda" else None),
            collectives=cost.collectives_by_axis(shd.counts()))
    return out


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
        per = {k: dict(calls=v["calls"] / 2, ms=v["seconds"] / 2 * 1e3,
                       bytes=v["bytes"] / 2)
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


def ranks_past(out_dir, mark, world=SHARD_TP, wait_s=SHARD_WAIT_S):
    """Wait until each of ``world`` ranks has dropped ``mark<rank>`` in
    ``out_dir``, one has ended (its results file is written however it
    ends) or ``wait_s`` has passed."""
    deadline = time.perf_counter() + wait_s
    while time.perf_counter() < deadline and not (
            all((out_dir / f"{mark}{r}").exists() for r in range(world))
            or any((out_dir / f"rank{r}.json").exists()
                   for r in range(world))):
        time.sleep(0.2)


def beside_ranks(phase, target, spec, out_dir, rehearsal, work):
    """SHARD_TP ranks in their own processes (``start_rank_processes``:
    started after the build, so they load the built kernels), each running
    ``chip_smoke.<target>``, while this process runs ``work()``; then each
    rank's results (``finish_rank_processes``: a rank that fails or
    outlives SHARD_WAIT_S fails ``phase``).  A failure of ``work`` stops
    the ranks.  Returns (``work()``, the ranks' results)."""
    started = start_rank_processes(target, spec, out_dir, SHARD_TP,
                                   rehearsal)
    try:
        res = work()
    except BaseException:
        stop_processes(started[0])
        raise
    return res, finish_rank_processes(phase, started, out_dir)


def start_rank_processes(target, spec, out_dir, world, rehearsal):
    """Start ``world`` ranks, each running ``chip_smoke.<target>(rank,
    world, port, rehearsal, spec file)`` over one gloo group; returns
    (processes, the time they started)."""
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
    return procs, time.perf_counter()


def finish_rank_processes(phase, started, out_dir, wait_s=SHARD_WAIT_S):
    """Wait for the ranks ``start_rank_processes`` started (``wait_s``
    from their start), stop any still running, and return each rank's
    results, each emitted; a rank that failed fails ``phase``."""
    procs, t0 = started
    deadline = t0 + wait_s
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
             **{k: v for k, v in res.items()
                if k not in ("stats", "dispatch")})
        if p.returncode != 0 or "error" in res or not res:
            raise AssertionError(f"{phase} rank {r} failed "
                                 f"(exit {p.returncode}): {log}")
    return ranks


def sharded_first_dispatch(torch, eng, cfg, prompts):
    """The first prefill dispatch of a fresh cache through ``eng``'s
    sharded path, every kernel call teacher-forced (``checked_kernels``):
    each call against its plain version at its shard-local shape, the
    calls against the path's count (``serve_launch_counts``), and the
    shapes against ``shard_local_shapes`` and the local heads.  Returns
    (the record, the dispatch's logits on the host: ``run_first``'s, which
    the exact gate holds to the emulation's)."""
    with checked_kernels(torch, lambda k: MATMUL_RTOL, None) as chk:
        logits = run_first(torch, eng, prompts)
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
    return dict(kernels=rows, fused_shapes=shapes,
                attention_heads=heads), logits


def phase_serve_sharded(torch, device, cfg, policy, args, slots, chunk,
                        max_len, new_tokens, lengths, ckpt_dir, want,
                        rehearsal):
    """Phase serve_sharded (on ckpt_serve's checkpoint and token streams;
    ``cfg`` at the checkpoint's depth).  SHARD_TP ranks sharing the card on
    a (1, SHARD_TP) mesh, each in its own process (``sharded_rank``) over
    gloo, while this process runs a world of one rank (``_world_one``) and
    then, on the store that world restored, the emulation of the ranks'
    plan (``emulate_serving``).  Then the ranks are held to the emulation
    bit for bit (``exact_gate``) and the emulation to ckpt_serve's logits
    within REORDER_FACTOR times the reorder baseline
    (``emulation_check``).  Returns the launches of both runs (rank 0's
    for the two-rank run)."""
    from repro_torch.serve.engine import ServeEngine
    t_phase = time.perf_counter()
    prompts = _prompts(cfg, args.seed, lengths)

    def work():
        launches, baseline, store = _world_one(
            torch, device, cfg, policy, ckpt_dir, slots, chunk, max_len,
            prompts, new_tokens, want, args.seed)
        free_device(torch, device)
        eng = ServeEngine(cfg, store, policy, backend="cuda", device=device,
                          slots=slots, max_len=max_len, prefill_chunk=chunk)
        emu = emulate_serving(torch, eng, cfg, prompts, new_tokens, want)
        del eng, store
        free_device(torch, device)
        return launches, baseline, emu, time.perf_counter() - t_phase

    (launches, baseline, emu, main_s), ranks = beside_ranks(
        "serve_sharded", "sharded_rank", dict(
            n_layers=cfg.n_layers, block_1d=policy.block_1d,
            ckpt_dir=str(ckpt_dir), slots=slots, chunk=chunk,
            max_len=max_len, prompts=prompts, new_tokens=new_tokens,
            want=want), SHARD_DIR, rehearsal, work)
    faults = exact_gate(torch, "serve_sharded", emu, ranks, SHARD_DIR,
                        cfg.n_layers)
    check, bad = emulation_check(
        torch, "serve_sharded", emu, want, torch.load(CKPT_ROOT /
                                                      "logits.pt"),
        baseline, REORDER_CEILING if device.type == "cuda" else None)
    emit("serve_sharded", step="done", seconds=time.perf_counter() - t_phase,
         main_seconds=main_s, ranks=SHARD_TP,
         free_running_equal=check["free_running_equal"])
    if faults + bad:
        raise AssertionError(f"serve_sharded: {faults + bad}")
    return {"serve_sharded_1x1": launches,
            f"serve_sharded_1x{SHARD_TP}": ranks[0]["launches"]}


TRAIN_SHARD_DIR = ROOT / "build" / "chip_smoke_train_sharded"  # results,
# the ranks' gradient slices (removed when the phase ends)
TRAIN_SHARD_LAYERS = 2  # the phase's depth of h2o-danube-1.8b: at 4
# (train_1d's) the whole script ran 1203.7 s on a slow card host
TRAIN_SHARD_WAIT_S = 480  # the two-rank run's time limit
# the programs of the two-rank run: (mesh, layout, the misstatements of
# the plan whose emulations the exact gate must tell from the ranks)
TRAIN_SHARD_PROGRAMS = (((2, 1), "2d", ("local_dp_mean",)),
                        ((1, 2), "2d", ("bf16_partials", "bf16_head_entry")),
                        ((1, 2), "1d", ()))
# the most the one-device reorder baseline may move the gradients (the
# largest leaf's relative L2; layers/sub0/attn/wq in both layouts at every
# seed), the loss (``loss_move_scale``) and a token's loss (the RMS of its
# per-token moves) on the card: the largest reading of seeds 0-4 on the
# H100 at TRAIN_SHARD_LAYERS, plus a sixteenth
TRAIN_REORDER_CEILING = {"2d": 0.041955478489398956 * 1.0625,
                         "1d": 0.0421755388379097 * 1.0625}
# tokens in a block of ``loss_move_scale``'s batch means
LOSS_BLOCK = 64
TRAIN_LOSS_CEILING = {"2d": 0.001568137381958805 * 1.0625,
                      "1d": 0.0014469788008795931 * 1.0625}
TRAIN_TOKEN_CEILING = {"2d": 0.01571168934384654 * 1.0625,
                       "1d": 0.015777585372988658 * 1.0625}


def train_sharded_plan(rehearsal: bool) -> dict:
    """The two-rank training run: h2o-danube-1.8b (reduced in the
    rehearsal) at TRAIN_SHARD_LAYERS layers, phase train's batch, and each
    program's name, mesh, layout and controls."""
    return dict(arch="h2o-danube-1.8b" + ("-reduced" if rehearsal else ""),
                n_layers=TRAIN_SHARD_LAYERS,
                batch=2 if rehearsal else 4, seq=32 if rehearsal else 512,
                block_1d=BLOCK_1D[rehearsal],
                programs=[dict(name=f"{m[0]}x{m[1]}_{layout}", mesh=list(m),
                               layout=layout, controls=list(controls))
                          for m, layout, controls in TRAIN_SHARD_PROGRAMS])


def train_sharded_program(plan: dict, layout: str, backend: str = "cuda"):
    """(config, policy, TrainConfig) of one of the plan's layouts: 2D
    MXSF_TRAIN, or the 1D layout at the plan's block; remat "dots".  The
    plan's arch at its ``n_layers`` and the fields of its ``replace``, if
    any."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import MXSF_TRAIN
    from repro_torch.train import step as T
    cfg = get_config(plan["arch"]).replace(n_layers=plan["n_layers"],
                                           **plan.get("replace", {}))
    pol = MXSF_TRAIN.replace(backend=backend)
    if layout == "1d":
        pol = pol.replace(block_mode="1d", quantize_bwd=True,
                          block_1d=plan["block_1d"])
    return cfg, pol, T.TrainConfig()


def trace_train_sharded(plan: dict, prog: dict, rank: int,
                        rehearsal: bool) -> dict:
    """``dryrun.mesh_train_cell`` of one rank of one of the plan's
    programs on ``meta`` (a program's own arch and shape, where it names
    them, in place of the plan's): its launches, collectives by kind and
    axis with their operand bytes, and argument bytes.  The kernels'
    ``meta`` branches take 64-element 1D blocks only, so the rehearsal's
    1D program traces through the torch datapath (it launches nothing)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import cost, dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim.adamw import OptConfig
    t0 = time.perf_counter()
    backend = "torch" if rehearsal and prog["layout"] == "1d" else "cuda"
    plan = dict(plan, **prog)
    cfg, pol, tcfg = train_sharded_program(plan, prog["layout"], backend)
    mesh = mesh_lib.make_tracing_mesh(tuple(prog["mesh"]), rank)
    inputs, run, info = dryrun.mesh_train_cell(
        cfg, ShapeConfig("train_sharded", plan["seq"], plan["batch"],
                         "train"), pol, mesh, tcfg, OptConfig())
    with cost.count(inputs) as counter:
        out = run(inputs)
    summary = counter.summary(out, mesh.shape)
    return dict(launches={k: v for k, v in summary["cost"][
        "launches"].items() if v}, collectives=cost.collectives_by_axis(
            summary["collectives"]),
        argument_bytes=summary["memory"]["argument_bytes"],
        peak_bytes=summary["memory"]["peak_bytes_per_device"],
        tp_plan=info["tp_plan"], trace_seconds=time.perf_counter() - t0)


def _train_traces(plan: dict, rehearsal: bool) -> dict:
    """The mesh worker's traces of each rank of each of the plan's
    programs (``trace_train_sharded``), ``{(program, rank): record}``."""
    return {(prog["name"], r): json.loads(
        (DRYRUN_MESH_DIR / f"train_{prog['name']}__rank{r}.json")
        .read_text()) for prog in plan["programs"]
        for r in range(SHARD_TP)}


def _grad_file(name: str, rank: int) -> Path:
    return TRAIN_SHARD_DIR / f"grads_{name}_rank{rank}.pt"


def _rank_state(torch, device, cfg, prog, batch, seed):
    """A sharded train program's set-up on this rank: its mesh, its slices
    of the state one device draws from ``seed`` (bytes against
    ``MeshRules.shard_nbytes``) and its rows of ``batch``.  Returns (mesh,
    state, rows, results, faults)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as T
    shape = tuple(prog["mesh"])
    mesh = mesh_lib.make_mesh(shape, ("data", "model"))
    ocfg = OptConfig()
    sh = T.state_shardings(cfg, ocfg, mesh)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = T.init_state(gen, cfg, ocfg, device=device, shardings=sh)
    state_b = _tree_bytes(state)
    predicted = mesh_lib.MeshRules(mesh).shard_nbytes(T.init_state(
        torch.Generator(), cfg, ocfg, device="meta"), sh)
    faults = [] if state_b == predicted else [
        f"state {state_b} B != MeshRules' {predicted} B"]
    out = dict(program=prog["name"], mesh=list(shape),
               layout=prog["layout"], state_bytes=state_b,
               predicted_state_bytes=predicted,
               coords={a: mesh.coord(a) for a in mesh.shape})
    return mesh, state, T.batch_rows(batch, mesh), out, faults


def _rank_timed_step(torch, device, plan, cfg, pol, tcfg, mesh, state, rows,
                     out, faults, exact=False):
    """One timed sharded train step on this rank, into ``out``: seconds,
    the collectives' host share, the peak, the launches and collectives
    against their formulas (a mismatch appended to ``faults``), the
    counts the rank's trace is held to, its loss and clip norm, and with
    ``exact`` a fingerprint of each updated slice of the params and
    moments (the exact gate's)."""
    from repro_torch.core import sharding as shd
    from repro_torch.launch import cost
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as T
    on_card = device.type == "cuda"
    step = T.make_train_step(cfg, pol, OptConfig(), tcfg, mesh)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    arg = out["state_bytes"] + sum(t.numel() * t.element_size()
                                   for t in rows.values())
    _sync(torch, device)
    reset_launches()
    shd.reset_counts()
    t0 = time.perf_counter()
    _, metrics = step(state, rows)
    _sync(torch, device)
    seconds = time.perf_counter() - t0
    counts = shd.counts()
    launches = ({k: v for k, v in read_launches().items() if v}
                if on_card else None)
    coll = {k: {a: v[0] for a, v in by.items()}
            for k, by in cost.collectives_by_axis(counts).items()}
    want_coll = train_collectives(cfg, pol, tcfg, mesh.shape, plan["seq"])
    want_launches = {k: v for k, v in train_launch_counts(
        cfg, pol, tcfg.remat).items() if v}
    if coll != want_coll:
        faults.append(f"collectives {coll} != {want_coll}")
    if on_card and launches != want_launches:
        faults.append(f"launches {launches} != {want_launches}")
    host = sum(v["seconds"] for v in counts.values())
    if exact:
        out["state_fingerprints"] = fingerprints(torch, {
            "params": state["params"], "m": state["opt"]["m"],
            "v": state["opt"]["v"]})
    out.update(step_loss=float(metrics["loss"]),
               grad_norm=float(metrics["grad_norm"]), seconds=seconds,
               tokens_per_s=plan["batch"] * plan["seq"] / seconds,
               collective_host_seconds=host,
               collective_share=host / seconds,
               collectives_by_kind={k: dict(calls=v["calls"],
                                            seconds=v["seconds"],
                                            bytes=v["bytes"])
                                    for k, v in counts.items()},
               collectives=coll, expected_collectives=want_coll,
               launches=launches, expected_launches=want_launches,
               max_memory_allocated=(torch.cuda.max_memory_allocated()
                                     if on_card else None),
               dispatch=dict(launches=launches,
                             collectives=cost.collectives_by_axis(counts),
                             argument_bytes=arg),
               faults=faults)


def _train_rank_program(torch, device, plan, prog, rank, batch, seed):
    """One program of the two-rank run on this rank: the state slices
    (bytes against ``MeshRules.shard_nbytes``), the gradient function
    teacher-forced (``checked_kernels`` at the shard-local shapes; the
    gradient slices written for the script's process), each token's loss
    of its rows and each sublayer's digest from a forward through the
    sharded path, then one timed train step (``_rank_timed_step``)."""
    from repro_torch.train import step as T
    cfg, pol, tcfg = train_sharded_program(plan, prog["layout"])
    mesh, state, rows, out, faults = _rank_state(torch, device, cfg, prog,
                                                 batch, seed)
    # the gradients, every kernel call teacher-forced
    grad_fn = T.make_grad_fn(cfg, pol, tcfg, mesh)
    out["tp_plan"] = grad_fn.layout.plan._asdict()
    _sync(torch, device)
    t0 = time.perf_counter()
    with checked_kernels(torch, train_rtol, None) as chk:
        metrics, grads = grad_fn(state["params"], rows)
    out["checked_seconds"] = time.perf_counter() - t0
    rows_k, kfaults = chk.rows(train_launch_counts(cfg, pol))
    faults += kfaults
    if prog["layout"] == "2d":  # the forward's fused calls
        got = sorted({(c["k"], c["n"])
                      for c in chk.calls["mxsf_fused_matmul"]})
        want = sorted(set(shard_local_shapes(cfg, mesh.shape["model"])))
        m = sorted({c["m"] for c in chk.calls["mxsf_fused_matmul"]})
        if got != want or m != [rows["tokens"].numel()]:
            faults.append(f"fused shapes {got} at m {m} != {want}")
        out["fused_shapes"] = dict(kn=got, m=m)
    out.update(loss=float(metrics["loss"]), kernels=rows_k)
    torch.save({"/".join(p): g.detach().float().cpu()
                for p, g in T._flatten(grads)}, _grad_file(prog["name"],
                                                           rank))
    del grads
    # each token's loss of this rank's rows, a forward on the sharded path
    out["taps"] = rank_forward(torch, state, rows, cfg, pol, grad_fn,
                               _nll_file(prog["name"], rank))
    _rank_timed_step(torch, device, plan, cfg, pol, tcfg, mesh, state, rows,
                     out, faults, exact=True)
    del state
    free_device(torch, device)
    return out


def rank_forward(torch, state, rows, cfg, pol, grad_fn, nll_file):
    """A forward of a rank's rows on the sharded path: each token's loss,
    saved to ``nll_file``; returns each sublayer's digest
    (``layer_taps``)."""
    from repro_torch.models import transformer as TR
    with torch.no_grad(), grad_fn.layout.hints(), layer_taps(torch) as taps:
        logits = TR.forward(state["params"], rows, cfg, pol)
    torch.save(token_nll(torch, logits, rows["labels"], cfg.vocab).cpu(),
               nll_file)
    return taps


def sharded_train_rank(rank: str, world: str, port: str, rehearsal: str,
                       spec_file: str):
    """One rank of phase train_sharded's two-rank run (started after the
    build): each program of ``train_sharded_plan`` in turn, on the batch
    the script's process drew; results to TRAIN_SHARD_DIR."""
    spec = json.loads(Path(spec_file).read_text())
    with gloo_rank(rank, world, port, rehearsal, TRAIN_SHARD_DIR) as (
            torch, device, rank, world, out):
        batch = {k: torch.tensor(v, dtype=torch.int32, device=device)
                 for k, v in spec["batch"].items()}
        out["programs"] = []
        for prog in spec["plan"]["programs"]:
            res = _train_rank_program(torch, device, spec["plan"], prog,
                                      rank, batch, spec["seed"])
            out["programs"].append(res)
            if res["faults"]:
                raise AssertionError(f"{prog['name']}: {res['faults']}")


def _grads_rel(torch, got, ref):
    """(the largest leaf's relative L2 distance of ``got`` from ``ref``,
    that leaf's path): ``{path: tensor}`` each, ``got`` moved to ``ref``'s
    device."""
    worst, at = 0.0, None
    for k, r in ref.items():
        g = got[k].to(r.device, torch.float32)
        r = r.float()
        rel = float(torch.linalg.vector_norm(g - r)
                    / torch.linalg.vector_norm(r).clamp_min(1e-30))
        if rel >= worst:
            worst, at = rel, k
    return worst, at


@contextlib.contextmanager
def plain_matmuls():
    """Every matmul kernel wrapper on its plain version inside the block
    (this script's hook, as ``checked_kernels`` is): the same exact
    products, summed in cuBLAS's f32 order."""
    from repro_torch.kernels import mx_matmul as MM
    from repro_torch.kernels import mxsf_fused_matmul as FM
    saved = (FM.mxsf_fused_matmul, MM.mxsf_matmul)
    FM.mxsf_fused_matmul = FM.mxsf_fused_matmul_plain
    MM.mxsf_matmul = MM.mxsf_matmul_plain
    try:
        yield
    finally:
        FM.mxsf_fused_matmul, MM.mxsf_matmul = saved


def _one_device_grads(torch, cfg, pol, tcfg, state, batch, plain=False):
    """The one-device gradient function on the whole state and each
    token's loss from a forward of the same params: (loss, ``{path:
    grad}``, per-token nll); ``plain``: every matmul on its plain version
    (the reorder baseline)."""
    from repro_torch.models import transformer as TR
    from repro_torch.train import step as T
    with plain_matmuls() if plain else contextlib.nullcontext():
        metrics, grads = T.make_grad_fn(cfg, pol, tcfg)(state["params"],
                                                        batch)
        with torch.no_grad():
            logits = TR.forward(state["params"], batch, cfg, pol)
    nll = token_nll(torch, logits, batch["labels"], cfg.vocab)
    return float(metrics["loss"]), {"/".join(p): g for p, g in
                                    T._flatten(grads)}, nll


def loss_move_scale(torch, move, block=LOSS_BLOCK):
    """How far a reorder moves the loss, from its per-token moves ``move``
    (batch, seq): the larger of the mean move (the baseline's own scalar
    move) and four standard errors of that mean, estimated by batch means
    over blocks of ``block`` consecutive tokens of a row (so a move that
    carries along a row counts within its block; at least four blocks a
    row).  Returns (scale, mean, standard error)."""
    m = move.double()
    block = min(block, m.shape[-1] // 4)
    means = m.reshape(-1, block).mean(-1)
    se = float(means.std() / means.numel() ** 0.5)
    mean = float(m.mean())
    return max(abs(mean), 4.0 * se), mean, se


def planted_losses(torch, nll):
    """Losses of plumbing faults, from one device's per-token losses
    (batch, seq): a DP rank's own rows only, each half (a rank that did
    not sum over DP), and every DP rank's first row twice (rows read at
    the wrong offset; where a rank has two rows or more).  Returns
    ``{name: loss}``: recorded beside the loss gate, which they may lie
    inside (at random init every row's mean loss is near every other's:
    what ``planted_tokens`` holds the per-token gate to)."""
    half = nll.shape[0] // 2
    rows = nll.double().mean(-1)
    out = {"rows_of_dp_rank_0": float(rows[:half].mean()),
           "rows_of_dp_rank_1": float(rows[half:].mean())}
    if half > 1:
        out["first_row_twice"] = float(rows[::half].mean())
    return out


def token_nll(torch, logits, labels, vocab):
    """Each token's loss (batch, seq) in f32 from (padded) logits."""
    logits = logits[..., :vocab].float()
    labels = labels.long()
    return torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels[..., None])[..., 0]


def _rms(torch, t):
    return float(t.double().pow(2).mean().sqrt())


def planted_tokens(torch, nll, rows_of):
    """The per-token losses a rank holding the wrong tokens would report,
    from one device's ``nll`` (batch, seq) and ``rows_of`` (the rank's
    rows of a (batch, seq) tensor): the batch's rows rolled by one (rows
    read at the wrong offset) and each row's tokens rolled by one (labels
    one position off).  Returns ``{name: (rank rows, seq)}``."""
    return {"rows_rolled": rows_of(torch.roll(nll, 1, 0)),
            "positions_rolled": rows_of(torch.roll(nll, 1, 1))}


def _nll_file(name: str, rank: int) -> Path:
    return TRAIN_SHARD_DIR / f"nll_{name}_rank{rank}.pt"


def _tolerance_gates(torch, ref, loss, rel, rel_at, nll, rows_of, on_card,
                     who):
    """The reorder tolerance of a sharded train program's emulation
    (``emulate_train``) against one device's ``ref`` (loss and its
    tolerance, per-token losses and their tolerance, the reorder
    baseline's gradient move): its whole gradients' largest leaf move
    ``rel`` (at ``rel_at``) within REORDER_FACTOR times the baseline's
    (on the card: the rehearsal's baseline is 0), its ``loss``, and its
    per-token losses ``nll`` of the rows ``rows_of`` picks out of one
    device's (a gate that must reject ``planted_tokens``).  Returns (the
    fields to print, the faults, each naming ``who``)."""
    tol = REORDER_FACTOR * ref["baseline"]
    dloss = abs(loss - ref["loss"])
    want = rows_of(ref["nll"])
    token_err = _rms(torch, nll.to(want.device) - want)
    planted = {k: _rms(torch, v - want) for k, v in
               planted_tokens(torch, ref["nll"], rows_of).items()}
    fields = dict(loss=loss, ref_loss=ref["loss"], loss_abs_err=dloss,
                  loss_tol=ref["loss_tol"], token_rms_err=token_err,
                  token_tol=ref["token_tol"], planted_token_rms=planted,
                  max_leaf_rel_l2=rel, leaf=rel_at, tol=tol)
    faults = []
    if on_card and rel > tol:
        faults.append(f"{who} gradients {rel} > {tol}")
    if dloss > ref["loss_tol"]:
        faults.append(f"{who} loss off by {dloss} > {ref['loss_tol']}")
    if on_card and token_err > ref["token_tol"]:
        faults.append(f"{who} token losses off by {token_err} (RMS) > "
                      f"{ref['token_tol']}")
    blind = {k: v for k, v in planted.items() if v <= ref["token_tol"]}
    if blind:
        faults.append(f"{who}: the token gate {ref['token_tol']} cannot "
                      f"see {blind}")
    return fields, faults


def emulation_tolerance(torch, phase, prog, emu, ref, on_card):
    """The old tolerance, on the emulation of a sharded train program:
    ``_tolerance_gates`` of its whole gradients, loss and per-token
    losses (every DP rank's rows, in order) against one device's; with
    routing, each MoE layer's tokens whose experts differ from one
    device's printed.  One ``emulation`` line; returns the faults."""
    rel, at = _grads_rel(torch, emu["grads"], ref["grads"])
    fields, faults = _tolerance_gates(
        torch, ref, emu["loss"], rel, at, torch.cat(emu["nll"], 0),
        lambda t: t, on_card, f"{prog['name']} emulation")
    flips = (moe_flips(torch, emu["topi"], ref["topi"]) if "topi" in ref
             else None)
    emit(phase, step="emulation", program=prog["name"], plan=emu["plan"],
         seconds=emu["seconds"], parts=emu["parts"], routing_flips=flips,
         **fields)
    return faults


def train_exact_gate(torch, phase, prog, emu, ranks, load, n_layers,
                     ref_grads):
    """Each rank of a sharded train program held to the program's
    emulation (``emulate_train``) bit for bit: its plan field by field,
    every gradient leaf's slice (cut from the emulation's whole gradient
    by the rank's stored spec, ``rank_cut``: uneven expert rows
    included), the loss (the gradient function's and the timed step's),
    every per-token loss of its rows, the clip norm, every updated slice
    of the params and moments (by ``fingerprint``), each MoE layer's
    routing (no token's experts may differ) and every sublayer of its
    forward (the first that differs printed, for diagnosis).  Each of the program's
    ``controls`` -- the emulation of a misstated plan -- must miss every
    rank: its loss or a gradient slice differs.  ``load(r)``: rank r's
    (gradient slices by path, routing or None, per-token losses).  Beside
    it, the largest leaf move of the rank's slices from its slices of one
    device's gradients ``ref_grads`` (the reading the reorder tolerance
    held the ranks to before).  One ``exact`` line a rank; returns the
    faults."""
    faults, mesh_shape = [], tuple(prog["mesh"])
    sizes = dict(zip(MESH_AXES, mesh_shape))
    specs = emu["specs"]

    def cut(t, key, co):
        return rank_cut(torch, t, specs[key], co, sizes)

    for r, res in enumerate(ranks):
        co = res["coords"]
        i = co["data"] * mesh_shape[1] + co["model"]
        grads, topi, nll = load(r)
        plan_off = {k: dict(rank=res["tp_plan"].get(k), emulated=v)
                    for k, v in emu["plan"].items()
                    if res["tp_plan"].get(k) != v}
        same, first = 0, None
        for key, whole in emu["grads"].items():
            want, g = cut(whole, key, co), grads.get(key)
            if g is not None and g.shape == want.shape and \
                    torch.equal(g, want):
                same += 1
            elif first is None:
                first = dict(leaf=key, max_abs_delta=None if g is None or
                             g.shape != want.shape else float(
                                 (g.float() - want.float()).abs().max()))
        losses = (res["loss"], res["step_loss"])
        loss_same = losses == (emu["loss"],) * 2
        tokens_same = torch.equal(nll, emu["nll"][co["data"]])
        norm_same = res["grad_norm"] == emu["grad_norm"][i]
        n_state = sum(len(t) for t in emu["state"][i].values())
        state_same = sum(res["state_fingerprints"][t].get(k) == d
                         for t, by in emu["state"][i].items()
                         for k, d in by.items())
        sub = first_tap_difference(res["taps"], emu["taps"][co["data"]],
                                   n_layers)
        flips = None if topi is None else moe_flips(torch, topi,
                                                    emu["topi"])
        rel, rel_at = _grads_rel(torch, grads, {
            k: cut(g, k, co) for k, g in ref_grads.items()})
        rejected = {name: emu["planted"][name]["loss"] != res["loss"] or any(
            not torch.equal(grads[k], cut(g, k, co))
            for k, g in emu["planted"][name]["grads"].items())
            for name in prog["controls"]}
        emit(phase, step="exact", program=prog["name"], rank=r,
             plan_fields_off=plan_off, bitwise_leaves=same,
             leaves=len(emu["grads"]), first_leaf_differs=first,
             loss=losses, emulated_loss=emu["loss"], loss_bitwise=loss_same,
             tokens_bitwise=tokens_same, tokens=nll.numel(),
             grad_norm=res["grad_norm"], emulated_grad_norm=emu[
                 "grad_norm"][i], grad_norm_bitwise=norm_same,
             bitwise_state=state_same, state_slices=n_state,
             first_sublayer_differs=sub, routing_flips=flips,
             planted_rejected=rejected, one_device_max_leaf_rel_l2=rel,
             one_device_leaf=rel_at)
        who = f"{prog['name']} rank {r}"
        if plan_off:
            faults.append(f"{who}: plan fields {sorted(plan_off)} off the "
                          "emulation's")
        if same != len(emu["grads"]):
            faults.append(f"{who}: {same} of {len(emu['grads'])} gradient "
                          f"leaves bitwise (first off: {first}; first "
                          f"sublayer off: {sub})")
        if not (loss_same and tokens_same and norm_same):
            faults.append(f"{who}: loss {losses} / {emu['loss']}, tokens "
                          f"bitwise {tokens_same}, grad norm "
                          f"{res['grad_norm']} / {emu['grad_norm'][i]}")
        if state_same != n_state or sub is not None:
            faults.append(f"{who}: {state_same} of {n_state} state slices "
                          f"bitwise, first sublayer off {sub}")
        if flips is not None and any(flips):
            faults.append(f"{who}: routing flips {flips} against the "
                          "emulation")
        blind = sorted(k for k, v in rejected.items() if not v)
        if blind:
            faults.append(f"{who}: the planted {blind} went unnoticed")
    return faults


def _trace_gate(got, traced, who):
    """A rank's timed step against the mesh worker's trace of it: the
    fields to print and the faults."""
    ran = got["dispatch"]
    same = (traced["collectives"] == ran["collectives"]
            and traced["argument_bytes"] == ran["argument_bytes"]
            and (ran["launches"] is None or
                 traced["launches"] == ran["launches"]))
    fields = dict(trace_equal=same, traced_peak_bytes=traced["peak_bytes"],
                  trace_seconds=traced["trace_seconds"])
    return fields, [] if same else [f"{who}: traced {traced} != ran {ran}"]


def _train_world_one(torch, device, plan, batch, seed):
    """A world of one rank in this process (``one_rank_world``: NCCL on
    the card): the sharded step on (1, 1) against the one-device step from
    the same state, gradients and updated state bit for bit, each layout;
    its collectives against ``train_collectives``."""
    from repro_torch.core import sharding as shd
    from repro_torch.launch import cost
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as T
    out = {}
    with one_rank_world(torch, device) as backend:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
        for layout in ("2d", "1d"):
            cfg, pol, tcfg = train_sharded_program(plan, layout)
            ocfg = OptConfig()
            states = []
            for sh in (None, T.state_shardings(cfg, ocfg, mesh)):
                gen = torch.Generator(device=device).manual_seed(seed)
                states.append(T.init_state(gen, cfg, ocfg, device=device,
                                           shardings=sh))
            m1, g1 = T.make_grad_fn(cfg, pol, tcfg)(states[0]["params"],
                                                    batch)
            shd.reset_counts()
            m2, g2 = T.make_grad_fn(cfg, pol, tcfg, mesh)(
                states[1]["params"], batch)
            coll = {k: {a: v[0] for a, v in by.items()} for k, by in
                    cost.collectives_by_axis(shd.counts()).items()}
            same_grads = all(torch.equal(a, b) for (_, a), (_, b) in zip(
                T._flatten(g1), T._flatten(g2)))
            del g1, g2
            T.make_train_step(cfg, pol, ocfg, tcfg)(states[0], batch)
            T.make_train_step(cfg, pol, ocfg, tcfg, mesh)(states[1], batch)
            same_state = all(torch.equal(a, b) for (_, a), (_, b) in zip(
                T._flatten(states[0]), T._flatten(states[1])))
            want = train_collectives(cfg, pol, tcfg, {"data": 1,
                                                      "model": 1},
                                     plan["seq"], step=False)
            out[layout] = dict(backend=backend, same_loss=float(
                m1["loss"]) == float(m2["loss"]), same_grads=same_grads,
                same_state=same_state, collectives=coll,
                expected_collectives=want)
            emit("train_sharded", step="world_one", layout=layout,
                 **out[layout])
            if not (out[layout]["same_loss"] and same_grads and same_state
                    and coll == want):
                raise AssertionError(f"train_sharded (1, 1) {layout}: "
                                     f"{out[layout]}")
            del states
            free_device(torch, device)
    return out


def phase_train_sharded(torch, device, args, rehearsal):
    """Phase train_sharded: the sharded train step of h2o-danube-1.8b at
    full width and TRAIN_SHARD_LAYERS layers, global batch 4 x 512 (phase
    train's first batch).  Two gloo ranks sharing the card
    (``sharded_train_rank``) run the programs of ``train_sharded_plan``
    -- a 2D step on (2, 1) and on (1, 2), a 1D step on (1, 2) -- while
    this process runs a world of one rank on NCCL (``_train_world_one``:
    bit for bit against one device), each layout's one-device gradients
    and their reorder baseline (the same gradients with every matmul on
    its plain version), and each program's emulation on one device
    (``emulate_program``: the ranks' plan, their calls at their shapes
    and their sums, with the program's controls).  Then the exact gate
    (``train_exact_gate``): each rank's plan, gradient slices, loss,
    per-token losses, clip norm and updated state equal to the
    emulation's bit for bit, each control rejected.  The old tolerance
    holds the emulation (``emulation_tolerance``): its gradients' largest
    leaf relative L2 from one device's within REORDER_FACTOR times the
    baseline's (which may not pass TRAIN_REORDER_CEILING on the card; in
    the rehearsal the plain versions are the kernels' own, so that gate is
    the card's alone), its loss within REORDER_FACTOR times the
    baseline's ``loss_move_scale`` (which may not pass TRAIN_LOSS_CEILING
    on the card; at least 4 f32 ulps), and its per-token losses within
    REORDER_FACTOR times the RMS of the baseline's per-token moves (which
    may not pass TRAIN_TOKEN_CEILING on the card), a gate that must reject
    every one of ``planted_tokens`` (else it could not see a loss of the
    wrong tokens).  Each rank's step against the mesh worker's trace of
    it.  Returns rank 0's launches of each program's timed step."""
    import shutil
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as T
    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    plan = train_sharded_plan(rehearsal)
    cfg, _, _ = train_sharded_program(plan, "2d")
    batch = make_batches(torch, cfg, args.seed, 1, plan["batch"],
                         plan["seq"], device)[0]
    from repro_torch.configs.base import get_config
    emit("train_sharded", step="plan", **{k: v for k, v in plan.items()
                                          if k != "programs"},
         d_model=cfg.d_model, of_layers=get_config(plan["arch"]).n_layers,
         programs=[p["name"] for p in plan["programs"]])
    try:
        started = start_rank_processes(
            "sharded_train_rank", dict(plan=plan, seed=args.seed, batch={
                k: v.tolist() for k, v in batch.items()}),
            TRAIN_SHARD_DIR, SHARD_TP, rehearsal)
        ranks = None
        try:
            world_one = _train_world_one(torch, device, plan, batch,
                                         args.seed)
            refs = {}
            for layout in ("2d", "1d"):
                cfg, pol, tcfg = train_sharded_program(plan, layout)
                gen = torch.Generator(device=device).manual_seed(args.seed)
                state = T.init_state(gen, cfg, OptConfig(), device=device)
                loss, grads, nll = _one_device_grads(torch, cfg, pol, tcfg,
                                                     state, batch)
                loss_p, plain, nll_p = _one_device_grads(
                    torch, cfg, pol, tcfg, state, batch, plain=True)
                base, base_at = _grads_rel(torch, plain, grads)
                scale, move, move_se = loss_move_scale(torch, nll_p - nll)
                loss_tol = REORDER_FACTOR * max(scale,
                                                4 * abs(loss) * F32_EPS)
                token_rms = _rms(torch, nll_p - nll)
                full = float(nll.double().mean())
                planted = {k: abs(v - full) for k, v in
                           planted_losses(torch, nll).items()}
                del plain, state, nll_p
                refs[layout] = dict(loss=loss, grads=grads, baseline=base,
                                    loss_tol=loss_tol, nll=nll,
                                    token_tol=REORDER_FACTOR * token_rms)
                ceiling = TRAIN_REORDER_CEILING[layout]
                loss_ceiling = TRAIN_LOSS_CEILING[layout]
                token_ceiling = TRAIN_TOKEN_CEILING[layout]
                emit("train_sharded", step="reorder_baseline",
                     layout=layout, loss=loss, loss_plain=loss_p,
                     mean_token_nll_move=move, token_move_se=move_se,
                     loss_scale=scale, loss_ceiling=loss_ceiling,
                     loss_tol=loss_tol, planted_loss_moves=planted,
                     token_rms_move=token_rms, token_ceiling=token_ceiling,
                     max_leaf_rel_l2=base, leaf=base_at, ceiling=ceiling)
                if on_card and ceiling is not None and base > ceiling:
                    raise AssertionError(
                        f"train_sharded {layout}: the reorder baseline "
                        f"moved the gradients by {base}, past its ceiling "
                        f"{ceiling}")
                if (on_card and loss_ceiling is not None
                        and scale > loss_ceiling):
                    raise AssertionError(
                        f"train_sharded {layout}: the reorder baseline's "
                        f"loss scale {scale} is past its ceiling "
                        f"{loss_ceiling}")
                if (on_card and token_ceiling is not None
                        and token_rms > token_ceiling):
                    raise AssertionError(
                        f"train_sharded {layout}: the reorder baseline "
                        f"moved a token's loss by {token_rms} (RMS), past "
                        f"its ceiling {token_ceiling}")
                free_device(torch, device)
            emus = {prog["name"]: emulate_program(torch, device, plan, prog,
                                                  batch, args.seed)
                    for prog in plan["programs"]}
        finally:
            ranks = finish_rank_processes("train_sharded", started,
                                          TRAIN_SHARD_DIR,
                                          TRAIN_SHARD_WAIT_S)
        faults = []
        mesh_traces = _train_traces(plan, rehearsal)
        for i, prog in enumerate(plan["programs"]):
            name, emu = prog["name"], emus.pop(prog["name"])
            faults += emulation_tolerance(torch, "train_sharded", prog, emu,
                                          refs[prog["layout"]], on_card)
            got = [res["programs"][i] for res in ranks]
            faults += train_exact_gate(
                torch, "train_sharded", prog, emu, got, lambda r: (
                    torch.load(_grad_file(name, r), mmap=True), None,
                    torch.load(_nll_file(name, r))), plan["n_layers"],
                refs[prog["layout"]]["grads"])
            del emu
            for rank, res in enumerate(got):
                fields, bad = _trace_gate(res, mesh_traces[name, rank],
                                          f"{name} rank {rank}")
                emit("train_sharded", step="check", program=name, rank=rank,
                     seconds=res["seconds"],
                     collective_share=res["collective_share"], **fields)
                faults += bad
        if faults:
            raise AssertionError(f"train_sharded: {faults}")
    finally:
        shutil.rmtree(TRAIN_SHARD_DIR, ignore_errors=True)
    emit("train_sharded", step="done", seconds=time.perf_counter() - t_phase,
         world_one={k: v["same_state"] for k, v in world_one.items()})
    return {f"train_sharded_{p['name']}": r["launches"] or {}
            for p, r in zip(plan["programs"], ranks[0]["programs"])}


# ---------------------------------------------------------------------------
# training the MoE configs on a mesh ("train_sharded_moe")
# ---------------------------------------------------------------------------

TRAIN_MOE_DIR = ROOT / "build" / "chip_smoke_train_moe"  # results and
# the ranks' gradient slices (removed when the phase ends)
TRAIN_MOE_REF_DIR = ROOT / "build" / "chip_smoke_train_moe_ref"  # the EP
# backward's references, one file a rank (removed when the phase ends)
TRAIN_MOE_LAYERS = 2  # qwen2-moe-a2.7b's depth in phase train_sharded_moe:
# one MoE layer's input gradient feeds the other's routing and experts
TRAIN_MOE_WAIT_S = 480  # the two-rank run's time limit
EP_LAYER = 1  # the layer whose MoE backward the ranks teacher-force
# the most the one-device reorder baseline may move the gradients (the
# largest leaf's relative L2; layers/sub0/attn/bk at every seed), the loss
# (``loss_move_scale``) and a token's loss (RMS) on the card: the largest
# reading of seeds 0-4 on the H100 (seed 0's each time), plus a sixteenth
MOE_TRAIN_REORDER_CEILING = 0.053678471595048904 * 1.0625
MOE_TRAIN_LOSS_CEILING = 0.0016078283998470142 * 1.0625
MOE_TRAIN_TOKEN_CEILING = 0.019434751136773468 * 1.0625


def train_moe_plan(rehearsal: bool) -> dict:
    """Phase train_sharded_moe's run: qwen2-moe-a2.7b (reduced in the
    rehearsal) at TRAIN_MOE_LAYERS layers, phase train's batch, one 2D
    program on (1, SHARD_TP)."""
    return dict(arch="qwen2-moe-a2.7b" + ("-reduced" if rehearsal else ""),
                n_layers=TRAIN_MOE_LAYERS,
                batch=2 if rehearsal else 4, seq=32 if rehearsal else 512,
                block_1d=BLOCK_1D[rehearsal],
                programs=[dict(name=f"moe_1x{SHARD_TP}_2d",
                               mesh=[1, SHARD_TP], layout="2d",
                               controls=["bf16_partials"])])


@contextlib.contextmanager
def moe_train_taps(torch, ep_layer):
    """Inside the block: each ``blocks._top_k`` call's expert indices (the
    forward's MoE layers, then a recompute's) and the input of the
    ``ep_layer``-th call of ``blocks.moe`` (detached), in the dict it
    yields (``topi``: a list; ``x``)."""
    from repro_torch.models import blocks
    got = {"topi": [], "x": None}
    top_k, moe = blocks._top_k, blocks.moe
    calls = [0]

    def record(probs, k):
        vals, idx = top_k(probs, k)
        got["topi"].append(idx.detach().cpu())
        return vals, idx

    def tapped(p, x, cfg, policy):
        if calls[0] == ep_layer:
            got["x"] = x.detach().clone()
        calls[0] += 1
        return moe(p, x, cfg, policy)

    blocks._top_k, blocks.moe = record, tapped
    try:
        yield got
    finally:
        blocks._top_k, blocks.moe = top_k, moe


def ep_backward(torch, params, cfg, policy, x, dy, ep_layer):
    """The MoE layer ``ep_layer`` of ``params`` without its shared expert
    (routing, dispatch, the experts, the combine: no kernel runs) on ``x``
    with output gradient ``dy``: ``{"dx", "router", "we_g", "we_u",
    "we_d"}`` gradients, under whatever mesh context is active (a rank's
    expert slices, gathered outputs, the take's gathered input
    gradient)."""
    from repro_torch.models import blocks
    ffn = params["layers"][f"sub{cfg.moe_every - 1}"]["ffn"]
    names = ("router", "we_g", "we_u", "we_d")
    p = {n: ffn[n][ep_layer].detach().requires_grad_() for n in names}
    x = x.detach().requires_grad_()
    y = blocks.moe(p, x, cfg, policy)
    grads = torch.autograd.grad(y, [x] + [p[n] for n in names], dy)
    return dict(zip(("dx",) + names, grads))


def _moe_file(name: str, rank: int) -> Path:
    return (TRAIN_MOE_REF_DIR if name == "ep_ref" else TRAIN_MOE_DIR) / \
        f"{name}_rank{rank}.pt"


def moe_flips(torch, got, want):
    """Per MoE layer, the tokens whose expert choice differs (as sets):
    ``got`` a rank's forward top-k indices, ``want`` one device's on the
    same rows."""
    return [int((torch.sort(g, -1).values != torch.sort(w, -1).values)
                .any(-1).sum()) for g, w in zip(got, want)]


def reorder_reference(torch, device, cfg, pol, tcfg, state, batch, phase,
                      ceilings, **fields):
    """One device's references for a sharded train program's gates, from
    ``state`` on ``batch``: the gradient function's loss (finite, within
    1.5 of ln(outputs) at init), gradients and each token's loss, then
    the reorder baseline -- the same with every matmul on its plain
    version (``plain_matmuls``) -- and the tolerances it sets: the
    gradients' largest leaf move, the loss's ``loss_move_scale`` and the
    RMS of a token's loss move, each of which may not pass its
    ``ceilings`` entry (``grads``, ``loss``, ``token``; None: ungated) on
    the card.  Prints both.  Returns ``dict(loss, baseline, loss_tol,
    token_tol, nll, grads)``, the tensors on the host (the ranks that
    follow need the card)."""
    on_card = device.type == "cuda"
    loss, grads, nll = _one_device_grads(torch, cfg, pol, tcfg, state,
                                         batch)
    ln_v = math.log(n_out(cfg))
    emit(phase, step="one_device", loss=loss, ln_vocab=ln_v,
         n_layers=cfg.n_layers, d_model=cfg.d_model, **fields)
    if not math.isfinite(loss) or abs(loss - ln_v) > 1.5:
        raise AssertionError(f"{phase}: loss {loss} is not near "
                             f"ln({n_out(cfg)})")
    loss_p, plain, nll_p = _one_device_grads(torch, cfg, pol, tcfg, state,
                                             batch, plain=True)
    base, base_at = _grads_rel(torch, plain, grads)
    del plain
    scale, move, move_se = loss_move_scale(torch, nll_p - nll)
    token_rms = _rms(torch, nll_p - nll)
    ref = dict(loss=loss, baseline=base,
               loss_tol=REORDER_FACTOR * max(scale, 4 * abs(loss) * F32_EPS),
               token_tol=REORDER_FACTOR * token_rms, nll=nll.cpu(),
               grads={k: g.float().cpu() for k, g in grads.items()})
    del grads, nll, nll_p
    emit(phase, step="reorder_baseline", loss=loss, loss_plain=loss_p,
         mean_token_nll_move=move, token_move_se=move_se, loss_scale=scale,
         token_rms_move=token_rms, max_leaf_rel_l2=base, leaf=base_at,
         loss_tol=ref["loss_tol"], token_tol=ref["token_tol"],
         ceilings=ceilings, max_memory_allocated=(
             torch.cuda.max_memory_allocated() if on_card else None),
         **fields)
    for name, value in (("grads", base), ("loss", scale),
                        ("token", token_rms)):
        if on_card and ceilings[name] is not None and value > ceilings[name]:
            raise AssertionError(
                f"{phase}: the reorder baseline's {name} move {value} is "
                f"past its ceiling {ceilings[name]}")
    return ref


def _moe_one_device(torch, device, plan, batch, args):
    """The one-device references of phase train_sharded_moe, on the card
    before the ranks start (both do not fit it at once): the gradient
    function's loss, gradients (to the host), each token's loss and each
    MoE layer's routing; the reorder baseline (every matmul on its plain
    version) and the gates it sets; the EP backward of layer EP_LAYER on
    its captured input and a seeded output gradient, each rank's expert
    rows saved for it; then the step timed and profiled (seconds, peak,
    idle share, launches); then the emulation of the ranks' program
    (``emulate_program``, on the state drawn anew).  Returns the
    references for the ranks' gates, the step's launches and the
    emulation."""
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as T
    on_card = device.type == "cuda"
    cfg, pol, tcfg = train_sharded_program(plan, "2d")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = T.init_state(gen, cfg, OptConfig(), device=device)
    n_moe = cfg.n_layers // cfg.moe_every
    with moe_train_taps(torch, EP_LAYER) as taps:
        ref = reorder_reference(
            torch, device, cfg, pol, tcfg, state, batch,
            "train_sharded_moe", dict(grads=MOE_TRAIN_REORDER_CEILING,
                                      loss=MOE_TRAIN_LOSS_CEILING,
                                      token=MOE_TRAIN_TOKEN_CEILING),
            experts=cfg.padded_experts, top_k=cfg.top_k)
    ref["topi"], x_ep = taps["topi"][:n_moe], taps["x"]
    # the EP backward on one device, each rank's expert rows saved for it
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    dy = torch.randn(x_ep.shape, generator=gen, device=device).to(
        x_ep.dtype)
    ep = ep_backward(torch, state["params"], cfg, pol, x_ep, dy, EP_LAYER)
    c = -(-cfg.padded_experts // SHARD_TP)
    for r in range(SHARD_TP):
        torch.save({"x": x_ep.cpu(), "dy": dy.cpu(),
                    **{k: (v[r * c:(r + 1) * c] if k.startswith("we_")
                           else v).cpu() for k, v in ep.items()}},
                   _moe_file("ep_ref", r))
    del ep, x_ep, dy
    free_device(torch, device)
    # the step, timed and profiled, on the same state
    _, _, launches = phase_train(torch, device, cfg, pol, args, 1,
                                 plan["batch"], plan["seq"], "one_device",
                                 profile=True, phase="train_sharded_moe",
                                 state=state,
                                 batches=[batch] * (1 + on_card))
    del state
    free_device(torch, device)
    emu = emulate_program(torch, device, plan, plan["programs"][0], batch,
                          args.seed)
    return ref, launches, emu


def _moe_rank_program(torch, device, plan, prog, rank, batch, seed):
    """The (1, SHARD_TP) program of phase train_sharded_moe on this rank:
    the state slices (bytes against ``MeshRules.shard_nbytes``), the
    gradient function teacher-forced (``checked_kernels`` at the
    shard-local shapes; the gradient slices and the forward's routing
    saved for the script's process), the EP backward teacher-forced on
    one device's layer input and output gradient (against one device's
    input gradient and this rank's expert rows, bit for bit), each
    token's loss of its rows and each sublayer's digest, then one timed
    step (``_rank_timed_step``)."""
    from repro_torch.train import step as T
    cfg, pol, tcfg = train_sharded_program(plan, prog["layout"])
    mesh, state, rows, out, faults = _rank_state(torch, device, cfg, prog,
                                                 batch, seed)
    out["expert_rows"] = int(state["params"]["layers"]["sub0"]["ffn"][
        "we_g"].shape[1])
    grad_fn = T.make_grad_fn(cfg, pol, tcfg, mesh)
    out["tp_plan"] = grad_fn.layout.plan._asdict()
    _sync(torch, device)
    t0 = time.perf_counter()
    with checked_kernels(torch, train_rtol, None) as chk, \
            moe_train_taps(torch, -1) as taps:
        metrics, grads = grad_fn(state["params"], rows)
    out["checked_seconds"] = time.perf_counter() - t0
    rows_k, kfaults = chk.rows(train_launch_counts(cfg, pol))
    faults += kfaults
    got = sorted({(c["k"], c["n"]) for c in chk.calls["mxsf_fused_matmul"]})
    want = sorted(set(shard_local_shapes(cfg, mesh.shape["model"])))
    if got != want:
        faults.append(f"fused shapes {got} != {want}")
    out.update(loss=float(metrics["loss"]), kernels=rows_k, fused_kn=got)
    torch.save({"grads": {"/".join(p): g.detach().float().cpu()
                          for p, g in T._flatten(grads)},
                "topi": taps["topi"][:cfg.n_layers // cfg.moe_every]},
               _moe_file("grads", rank))
    del grads
    # the EP backward, teacher-forced on one device's input and gradient
    ref = torch.load(_moe_file("ep_ref", rank), mmap=True)
    with grad_fn.layout.hints():
        ep = ep_backward(torch, state["params"], cfg, pol,
                         ref["x"].to(device), ref["dy"].to(device), EP_LAYER)
    out["ep"] = {k: dict(bitwise=bool(torch.equal(v.cpu(), ref[k])),
                         max_abs_err=float((v.float().cpu()
                                            - ref[k].float()).abs().max()))
                 for k, v in ep.items()}
    del ep, ref
    # each token's loss of this rank's rows, a forward on the sharded path
    out["taps"] = rank_forward(torch, state, rows, cfg, pol, grad_fn,
                               _moe_file("nll", rank))
    out["checked_peak"] = (torch.cuda.max_memory_allocated()
                           if device.type == "cuda" else None)
    _rank_timed_step(torch, device, plan, cfg, pol, tcfg, mesh, state, rows,
                     out, faults, exact=True)
    del state
    free_device(torch, device)
    return out


def train_moe_rank(rank: str, world: str, port: str, rehearsal: str,
                   spec_file: str):
    """One rank of phase train_sharded_moe's two-rank run: the plan's
    program on the batch the script's process drew; results to
    TRAIN_MOE_DIR."""
    spec = json.loads(Path(spec_file).read_text())
    with gloo_rank(rank, world, port, rehearsal, TRAIN_MOE_DIR) as (
            torch, device, rank, world, out):
        batch = {k: torch.tensor(v, dtype=torch.int32, device=device)
                 for k, v in spec["batch"].items()}
        out["programs"] = []
        for prog in spec["plan"]["programs"]:
            res = _moe_rank_program(torch, device, spec["plan"], prog, rank,
                                    batch, spec["seed"])
            out["programs"].append(res)
            if res["faults"]:
                raise AssertionError(f"{prog['name']}: {res['faults']}")


def phase_train_sharded_moe(torch, device, args, rehearsal):
    """Phase train_sharded_moe: the sharded train step of qwen2-moe-a2.7b
    (expert parallelism in the backward) at full width and
    TRAIN_MOE_LAYERS layers, global batch 4 x 512 (phase train's first
    batch), 2D.  First one device (``_moe_one_device``: MoE training's
    step on the card, its gradients, routing and each token's loss, the
    reorder baseline, the EP backward's reference), then two gloo ranks
    sharing the card on (1, SHARD_TP) (``train_moe_rank``), each holding
    half the experts.  Gates: state bytes a rank equal to
    ``MeshRules.shard_nbytes``; every kernel call within ``train_rtol`` at
    the shard-local shapes; the EP backward of layer EP_LAYER on one
    device's input and output gradient -- its input gradient and the
    rank's expert rows' gradients -- bit for bit against one device's
    (phase serve_sharded_moe's gathered expert outputs are); the exact
    gate (``train_exact_gate``) against the emulation of the ranks'
    program, run on one device before them (``_moe_one_device``): plan,
    gradient slices, loss, per-token losses, clip norm, updated state and
    every MoE layer's routing bit for bit, its control rejected; the old
    tolerance on the emulation (``emulation_tolerance``: gradients, loss
    and each token's loss within REORDER_FACTOR times the baseline's
    moves, the token gate rejecting ``planted_tokens``, its routing flips
    against one device printed); launches and collectives a step against
    their formulas; each rank's step equal to the mesh worker's trace of
    it.  Returns the launches of the one-device step and of rank 0's
    timed step."""
    import shutil
    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    plan = train_moe_plan(rehearsal)
    cfg, _, _ = train_sharded_program(plan, "2d")
    batch = make_batches(torch, cfg, args.seed, 1, plan["batch"],
                         plan["seq"], device)[0]
    from repro_torch.configs.base import get_config
    emit("train_sharded_moe", step="plan", **{k: v for k, v in plan.items()
                                              if k != "programs"},
         d_model=cfg.d_model, of_layers=get_config(plan["arch"]).n_layers,
         programs=[p["name"] for p in plan["programs"]])
    shutil.rmtree(TRAIN_MOE_REF_DIR, ignore_errors=True)
    TRAIN_MOE_REF_DIR.mkdir(parents=True)
    try:
        ref, one_launches, emu = _moe_one_device(torch, device, plan, batch,
                                                 args)
        ranks = finish_rank_processes(
            "train_sharded_moe", start_rank_processes(
                "train_moe_rank", dict(plan=plan, seed=args.seed, batch={
                    k: v.tolist() for k, v in batch.items()}),
                TRAIN_MOE_DIR, SHARD_TP, rehearsal),
            TRAIN_MOE_DIR, TRAIN_MOE_WAIT_S)
        prog = plan["programs"][0]
        faults = emulation_tolerance(torch, "train_sharded_moe", prog, emu,
                                     ref, on_card)

        def load(r):
            saved = torch.load(_moe_file("grads", r), mmap=True)
            return (saved["grads"], saved["topi"],
                    torch.load(_moe_file("nll", r)))

        got = [res["programs"][0] for res in ranks]
        faults += train_exact_gate(torch, "train_sharded_moe", prog, emu,
                                   got, load, plan["n_layers"], ref["grads"])
        del emu
        traces = _train_traces(plan, rehearsal)
        for rank, res in enumerate(got):
            fields, bad = _trace_gate(res, traces[prog["name"], rank],
                                      f"rank {rank}")
            ep_bitwise = all(v["bitwise"] for v in res["ep"].values())
            emit("train_sharded_moe", step="check", program=prog["name"],
                 rank=rank, ep=res["ep"], ep_bitwise=ep_bitwise,
                 seconds=res["seconds"],
                 collective_share=res["collective_share"], **fields)
            faults += bad
            if not ep_bitwise:
                faults.append(f"rank {rank}: EP backward {res['ep']}")
        if faults:
            raise AssertionError(f"train_sharded_moe: {faults}")
    finally:
        for d in (TRAIN_MOE_DIR, TRAIN_MOE_REF_DIR):
            shutil.rmtree(d, ignore_errors=True)
    emit("train_sharded_moe", step="done",
         seconds=time.perf_counter() - t_phase)
    return {"train_sharded_moe_one_device": one_launches,
            **{f"train_sharded_{p['name']}": r["launches"] or {}
               for p, r in zip(plan["programs"], ranks[0]["programs"])}}


# ---------------------------------------------------------------------------
# training the SSM, hybrid and encoder-decoder families on a mesh
# ("train_sharded_families")
# ---------------------------------------------------------------------------

TRAIN_FAM_DIR = ROOT / "build" / "chip_smoke_train_families"  # results
# and the ranks' gradient slices (removed when the phase ends)
TRAIN_FAM_BATCH_DIR = ROOT / "build" / "chip_smoke_train_families_batch"
# each program's batch, saved for the ranks (removed when the phase ends)
TRAIN_FAM_WAIT_S = 480  # the two-rank run's time limit
# each family's cut in phase train_sharded_families -- (layers, encoder
# layers, batch, seq) -- at phase train_families' batch shapes: mamba2 2
# of 48 layers, zamba2 one group of 6 SSD layers and its shared block (6
# of 81), whisper 2 + 2 of 24 + 24 over 1500 frames
TRAIN_FAM_RUNS = {"mamba2-780m": (2, 0, 4, 512), "zamba2-7b": (6, 0, 4, 512),
                  "whisper-medium": (2, 2, 2, 448)}
# the most the one-device reorder baseline may move each family's
# gradients (the largest leaf's relative L2), loss (``loss_move_scale``)
# and a token's loss (RMS) on the card: the largest reading of seeds 0-4
# on the H100 at TRAIN_FAM_RUNS' depths, plus a sixteenth
TRAIN_FAM_CEILING = {
    arch: {k: v * 1.0625 for k, v in zip(("grads", "loss", "token"), m)}
    for arch, m in (
        ("mamba2-780m", (0.009379420429468155, 8.249252346959368e-05,
                         0.000989145724039573)),
        ("zamba2-7b", (0.06495145708322525, 0.0032358466392943095,
                       0.031234403184233532)),
        ("whisper-medium", (0.03465651348233223, 0.002239376328369632,
                            0.010136894649202135)))}


def train_families_plan(rehearsal: bool) -> dict:
    """Phase train_sharded_families' programs: each of TRAIN_FAM_RUNS,
    2D on (1, SHARD_TP), at full width (the rehearsal: the reduced
    configs at batch 2 x 32, the SSM ones at ``d_model`` 128 so that
    their SSD splits, zamba2 at one group)."""
    from repro_torch.configs.base import get_config
    progs = []
    for arch, (layers, enc, batch, seq) in TRAIN_FAM_RUNS.items():
        cfg = get_config(arch)
        replace = {"n_enc_layers": enc} if enc else {}
        if rehearsal:
            arch, batch, seq = arch + "-reduced", 2, 32
            cfg = cfg.reduced()
            if cfg.ssm_state:
                replace["d_model"] = 128
        if cfg.family == "hybrid":
            layers = cfg.hybrid_attn_every  # one group, its shared block
        progs.append(dict(name=f"{cfg.name}_1x{SHARD_TP}_2d", arch=arch,
                          n_layers=layers, replace=replace, batch=batch,
                          seq=seq, of_layers=cfg.n_layers,
                          of_enc_layers=cfg.n_enc_layers,
                          mesh=[1, SHARD_TP], layout="2d"))
    return dict(block_1d=BLOCK_1D[rehearsal], programs=progs)


def train_local_shapes(cfg, tp=SHARD_TP):
    """(K, N) of each fused matmul of a train step's forward at ``tp``
    ranks on the model axis, every part split: the SSD's
    (``ssd_local_shapes``), the attention's and the FFNs'
    (``shard_local_shapes``, a cross-attention's alike) and the LM
    head's."""
    out = {(cfg.d_model, cfg.padded_vocab // tp)}
    if cfg.ssm_state:
        out |= set(ssd_local_shapes(cfg, tp))
    if cfg.family != "ssm":
        out |= set(shard_local_shapes(cfg, tp))
    return sorted(out)


def _fam_file(name: str, rank=None) -> Path:
    if rank is None:
        return TRAIN_FAM_BATCH_DIR / f"{name}.pt"
    return TRAIN_FAM_DIR / f"{name}_rank{rank}.pt"


def _family_rank_program(torch, device, plan, prog, rank, seed):
    """One family's (1, SHARD_TP) program of phase train_sharded_families
    on this rank: the state slices (bytes against ``MeshRules.
    shard_nbytes``), the gradient function teacher-forced
    (``checked_kernels`` at the shard-local shapes; the gradient slices
    saved), each token's loss of its rows from a forward through the
    sharded path, then one timed step: seconds, the collectives' host
    share, the peak, launches and collectives against their formulas, and
    the counts the rank's trace is held to."""
    from repro_torch.models import transformer as TR
    from repro_torch.train import step as T
    prog_plan = dict(plan, **prog)
    cfg, pol, tcfg = train_sharded_program(prog_plan, prog["layout"])
    batch = {k: v.to(device) for k, v in torch.load(
        _fam_file(f"batch_{prog['name']}")).items()}
    mesh, state, rows, out, faults = _rank_state(torch, device, cfg, prog,
                                                 batch, seed)
    grad_fn = T.make_grad_fn(cfg, pol, tcfg, mesh)
    out["tp_plan"] = grad_fn.layout.plan._asdict()
    _sync(torch, device)
    t0 = time.perf_counter()
    with checked_kernels(torch, train_rtol, None) as chk:
        metrics, grads = grad_fn(state["params"], rows)
    out["checked_seconds"] = time.perf_counter() - t0
    rows_k, kfaults = chk.rows(train_launch_counts(cfg, pol))
    faults += kfaults
    got = sorted({(c["k"], c["n"]) for c in chk.calls["mxsf_fused_matmul"]})
    want = train_local_shapes(cfg, mesh.shape["model"])
    if got != want:
        faults.append(f"fused shapes {got} != {want}")
    out.update(loss=float(metrics["loss"]), kernels=rows_k, fused_kn=got,
               fused_m=sorted({c["m"] for c in
                               chk.calls["mxsf_fused_matmul"]}))
    torch.save({"/".join(p): g.detach().float().cpu()
                for p, g in T._flatten(grads)},
               _fam_file(f"grads_{prog['name']}", rank))
    del grads
    with torch.no_grad(), grad_fn.layout.hints():
        logits = TR.forward(state["params"], rows, cfg, pol)
    torch.save(token_nll(torch, logits, rows["labels"], cfg.vocab).cpu(),
               _fam_file(f"nll_{prog['name']}", rank))
    del logits
    out["checked_peak"] = (torch.cuda.max_memory_allocated()
                           if device.type == "cuda" else None)
    _rank_timed_step(torch, device, prog_plan, cfg, pol, tcfg, mesh, state,
                     rows, out, faults)
    del state
    free_device(torch, device)
    return out


def train_family_rank(rank: str, world: str, port: str, rehearsal: str,
                      spec_file: str):
    """One rank of phase train_sharded_families' two-rank run: each
    family's program in turn (one process start for the three), on the
    batches the script's process saved; results to TRAIN_FAM_DIR."""
    spec = json.loads(Path(spec_file).read_text())
    with gloo_rank(rank, world, port, rehearsal, TRAIN_FAM_DIR) as (
            torch, device, rank, world, out):
        out["programs"] = []
        for prog in spec["plan"]["programs"]:
            res = _family_rank_program(torch, device, spec["plan"], prog,
                                       rank, spec["seed"])
            out["programs"].append(res)
            if res["faults"]:
                raise AssertionError(f"{prog['name']}: {res['faults']}")


def phase_train_sharded_families(torch, device, args, rehearsal):
    """Phase train_sharded_families: the sharded train step of mamba2-780m
    (SSM), zamba2-7b (hybrid) and whisper-medium (encoder-decoder) at full
    width, cut in depth (TRAIN_FAM_RUNS, each cut printed), 2D, remat
    "dots", the SSD heads split over the model axis.  First one device,
    family by family (``reorder_reference``: the gradients, the loss and
    each token's loss, the reorder baseline and the tolerances it sets,
    kept on the host; the batch saved for the ranks), then two gloo ranks
    sharing the card on (1, SHARD_TP) (``train_family_rank``: one pair of
    processes for the three families).  Gates, per family and rank: state
    bytes equal to ``MeshRules.shard_nbytes``; every kernel call within
    ``train_rtol`` at the shard-local shapes (``train_local_shapes``);
    launches and collectives a step against ``train_launch_counts`` and
    ``train_collectives``; the gradient slices, the loss and each token's
    loss of the rank's rows within REORDER_FACTOR times the baseline's
    moves (capped by TRAIN_FAM_CEILING on the card; the token gate
    rejecting ``planted_tokens``); each rank's step equal to the mesh
    worker's trace of it.  Prints each rank's step seconds, peak and the
    collectives' share.  Returns rank 0's launches of each timed step."""
    import shutil
    from repro_torch.core import sharding as shd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as T
    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    plan = train_families_plan(rehearsal)
    shutil.rmtree(TRAIN_FAM_BATCH_DIR, ignore_errors=True)
    TRAIN_FAM_BATCH_DIR.mkdir(parents=True)
    refs = {}
    try:
        for prog in plan["programs"]:
            cfg, pol, tcfg = train_sharded_program(dict(plan, **prog),
                                                   prog["layout"])
            emit("train_sharded_families", step="cut", program=prog["name"],
                 n_layers=cfg.n_layers, of=prog["of_layers"],
                 n_enc_layers=cfg.n_enc_layers,
                 of_enc_layers=prog["of_enc_layers"], batch=prog["batch"],
                 seq=prog["seq"], d_model=cfg.d_model, mesh=prog["mesh"])
            batch = make_batches(torch, cfg, args.seed, 1, prog["batch"],
                                 prog["seq"], device)[0]
            torch.save({k: v.cpu() for k, v in batch.items()},
                       _fam_file(f"batch_{prog['name']}"))
            gen = torch.Generator(device=device).manual_seed(args.seed)
            state = T.init_state(gen, cfg, OptConfig(), device=device)
            refs[prog["name"]] = reorder_reference(
                torch, device, cfg, pol, tcfg, state, batch,
                "train_sharded_families",
                TRAIN_FAM_CEILING[cfg.name.removesuffix("-reduced")],
                program=prog["name"])
            del state, batch
            free_device(torch, device)
        ranks = finish_rank_processes(
            "train_sharded_families", start_rank_processes(
                "train_family_rank", dict(plan=plan, seed=args.seed),
                TRAIN_FAM_DIR, SHARD_TP, rehearsal),
            TRAIN_FAM_DIR, TRAIN_FAM_WAIT_S)
        faults = []
        traces = _train_traces(plan, rehearsal)
        for rank, res in enumerate(ranks):
            for prog, got in zip(plan["programs"], res["programs"]):
                cfg, _, _ = train_sharded_program(dict(plan, **prog),
                                                  prog["layout"])
                ref = refs[prog["name"]]
                sh = T.state_shardings(cfg, OptConfig(), shd.AbstractMesh(
                    tuple(prog["mesh"]), ("data", "model")))["params"]
                mesh = mesh_lib.make_tracing_mesh(tuple(prog["mesh"]), rank)
                mine = {"/".join(p): ref["grads"]["/".join(p)][
                    shd.shard_slices(ref["grads"]["/".join(p)].shape,
                                     ns.spec, mesh)]
                        for p, ns in T._flatten(sh)}
                rel, rel_at = _grads_rel(torch, torch.load(_fam_file(
                    f"grads_{prog['name']}", rank), mmap=True), mine)
                del mine
                who = f"{prog['name']} rank {rank}"
                fields, bad = _tolerance_gates(
                    torch, ref, got["loss"], rel, rel_at, torch.load(
                        _fam_file(f"nll_{prog['name']}", rank)),
                    lambda t: T.batch_rows({"nll": t}, mesh)["nll"],
                    on_card, who)
                more, worse = _trace_gate(got, traces[prog["name"], rank],
                                          who)
                fields.update(more)
                bad += worse
                emit("train_sharded_families", step="check",
                     program=prog["name"], rank=rank,
                     tp_plan=got["tp_plan"], state_bytes=got["state_bytes"],
                     seconds=got["seconds"],
                     collective_share=got["collective_share"],
                     max_memory_allocated=got["max_memory_allocated"],
                     **fields)
                faults += bad
        if faults:
            raise AssertionError(f"train_sharded_families: {faults}")
    finally:
        for d in (TRAIN_FAM_DIR, TRAIN_FAM_BATCH_DIR):
            shutil.rmtree(d, ignore_errors=True)
    emit("train_sharded_families", step="done",
         seconds=time.perf_counter() - t_phase)
    return {f"train_sharded_{p['name']}": r["launches"] or {}
            for p, r in zip(plan["programs"], ranks[0]["programs"])}


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


GEMMA2_SERVE_PERIODS = 7  # serve_gemma2's depth: 14 of gemma2-9b's 42
# layers (each period a local and a global layer)


def phase_serve_gemma2(torch, device, args, rehearsal):
    """gemma2-9b at full width, cut to GEMMA2_SERVE_PERIODS periods of its
    alternating 4096-token SWA (softcaps; the cut printed): one packed
    store shared by two engines of ``MXSF_INFER`` on the
    kernel datapath, A with the policy's bf16 value cache and B with the
    packed MXSF cache (dequantized into the value path, ``kv_prequant``);
    a 4200-token prompt (the local layers' window masks) and a 37-token
    one, 16 new tokens each, chunk 256; a profiled decode dispatch each;
    then engine A's first prefill and two decode dispatches teacher-forced.
    Returns the launches of each engine's run."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.packed_store import store_nbytes
    from repro_torch.core.policy import MXSF_INFER
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.engine import _nbytes as tree_bytes
    cfg = get_config("gemma2-9b")
    slots, chunk, max_len, new_tokens = 2, 256, 4352, 16
    lengths = [4200, 37]
    if rehearsal:
        cfg = cfg.reduced()
        chunk, max_len, new_tokens, lengths = 8, 40, 4, [21, 5]
    full = cfg.n_layers
    cfg = dryrun.at_depth(cfg, min(GEMMA2_SERVE_PERIODS,
                                   dryrun.layer_period(cfg)[1]))
    if cfg.n_layers < full:
        emit("serve_gemma2", step="cut", n_layers=cfg.n_layers, of=full)
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


MOE_LAYERS = 4  # serve_moe's depth, and so serve_sharded_moe's: at all
# 24 layers the two phases took 77 + 244 s of a 1151 s script on the H100,
# too close to its 1200 s limit; at 12, 40 + 132 s of a script that took
# 1046.7-1213.5 s once phase serve_sharded_families joined it; at 8, 26 +
# 101 s, given back to phase train_sharded_moe


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
    slots, max_len, new_tokens = MOE_SLOTS, MOE_MAX_LEN[rehearsal], 8
    lengths = [8, 13, 19, 24]
    policy = MXSF_INFER.replace(kv_cache_fmt="mxsf",
                                block_1d=BLOCK_1D[rehearsal])
    if rehearsal:
        cfg = cfg.reduced()
        new_tokens, lengths = 3, [3, 5, 2, 7]
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
# recorded on the H100 at 12 layers (0.390625), kept as the cap at
# MOE_LAYERS, plus one bf16 ulp of its largest |logit| (4-8)


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
    streams, launches and collectives against their formulas; write its
    results to SHARD_MOE_DIR (what the exact gate reads in ``rank<r>.pt``)
    and profile one decode dispatch on rank 0."""
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
        out["first_dispatch"], first = sharded_first_dispatch(
            torch, eng, cfg, spec["prompts"])
        out["exact"] = moe_exact(torch, eng, cfg, spec["prompts"],
                                 torch.load(spec["first"]))
        out["dispatch"] = dispatch_counts(torch, eng)
        outs, launches, collectives, record = sharded_serve(
            torch, eng, cfg, spec["prompts"], spec["new_tokens"],
            spec["want"], "serve_sharded_moe", teacher=True,
            mesh=f"1x{world}", rank=rank, backend="gloo")
        torch.save(dict(record, first=first),
                   SHARD_MOE_DIR / f"rank{rank}.pt")
        out.update(tokens=outs, launches=launches, collectives=collectives,
                   collectives_per_dispatch=sharded_collectives(
                       cfg, eng, breakdown=True), stats=eng.stats())
        out["profile"] = rank_profile(torch, eng, rank, "serve_sharded_moe")


def phase_serve_sharded_moe(torch, device, args, ref, rehearsal):
    """Phase serve_sharded_moe: expert parallelism on serve_moe's model,
    store, prompts and streams (``ref``, whose store this phase frees).
    SHARD_TP ranks sharing the card on a (1, SHARD_TP) mesh, each in its
    own process (``sharded_moe_rank``), each holding its half of the
    experts, while this process runs a world of one rank
    (``_moe_world_one``) and then, on serve_moe's store, the emulation of
    the ranks' plan (``emulate_serving``); the store, the ranks' halves and
    their caches fit the card together at MOE_LAYERS.  Then the ranks are
    held to the emulation bit for bit (``exact_gate``) and the emulation
    to serve_moe's logits within REORDER_FACTOR times the reorder
    baseline (``emulation_check``).  Returns the launches of both runs
    (rank 0's for the two-rank run)."""
    import shutil
    from repro_torch.serve.engine import ServeEngine
    t_phase = time.perf_counter()
    cfg, phase = ref["cfg"], "serve_sharded_moe"
    emit(phase, step="plan", n_layers=cfg.n_layers, of=moe_config(
        rehearsal).n_layers, experts=cfg.padded_experts, ranks=SHARD_TP)

    def work():
        launches, baseline = _moe_world_one(torch, device, ref)
        eng = ServeEngine(cfg, ref["store"], ref["policy"], backend="cuda",
                          device=device, slots=ref["slots"],
                          max_len=ref["max_len"])
        emu = emulate_serving(torch, eng, cfg, ref["prompts"],
                              ref["new_tokens"], ref["want"])
        del eng, ref["store"]
        free_device(torch, device)
        return launches, baseline, emu, time.perf_counter() - t_phase

    try:
        MOE_REF_DIR.mkdir(parents=True, exist_ok=True)
        torch.save(ref["first"], MOE_REF_DIR / "first.pt")
        (launches, baseline, emu, main_s), ranks = beside_ranks(
            phase, "sharded_moe_rank", dict(
                n_layers=cfg.n_layers, block_1d=ref["policy"].block_1d,
                seed=args.seed, slots=ref["slots"], max_len=ref["max_len"],
                prompts=ref["prompts"], new_tokens=ref["new_tokens"],
                want=ref["want"], first=str(MOE_REF_DIR / "first.pt")),
            SHARD_MOE_DIR, rehearsal, work)
    finally:
        shutil.rmtree(MOE_REF_DIR, ignore_errors=True)
    faults = exact_gate(torch, phase, emu, ranks, SHARD_MOE_DIR,
                        cfg.n_layers)
    check, bad = emulation_check(
        torch, phase, emu, ref["want"], ref["logits"], baseline,
        MOE_REORDER_CEILING if device.type == "cuda" else None)
    emit(phase, step="done", seconds=time.perf_counter() - t_phase,
         main_seconds=main_s, n_layers=cfg.n_layers, ranks=SHARD_TP,
         free_running_equal=check["free_running_equal"])
    if faults + bad:
        raise AssertionError(f"{phase}: {faults + bad}")
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
    one profiled, at full width: mamba2-780m cut to 24 of its 48 layers
    (4 x 512; at 48, 33.6 s the arch on the H100, given back to phase
    train_sharded_families),
    whisper-medium cut to 6 + 6 of its 24 + 24 layers (2 x 448 over
    1500 frames; at full depth its profiled step alone took 65 s, which
    the script's time budget no longer holds beside phase
    serve_sharded_families; at 12 + 12, 41 s the arch, given back to
    phase train_sharded_moe), internvl2-1b (24 layers, 4 x 512 behind the
    256-embedding prefix) and zamba2-7b cut to 12 of its 81 layers (2
    groups of 6: f32 weights and AdamW state at full depth exceed the
    card); each cut printed.  Each step
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
    runs = (("mamba2-780m", 4, 512, 24, True),
            ("whisper-medium", 2, 448, 6, True),
            ("internvl2-1b", 4, 512, None, False),
            ("zamba2-7b", 4, 512, 12, False))
    for arch, batch, seq, depth, no_remat in runs:
        cfg = get_config(arch)
        if rehearsal:
            cfg, batch, seq = cfg.reduced(), 2, 32
        elif depth:
            emit("train_families", arch=arch, step="cut",
                 n_layers=depth, of=cfg.n_layers)
            cfg = cfg.replace(n_layers=depth, n_enc_layers=(
                depth if cfg.n_enc_layers else 0))
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


# phase train_gemma2's runs: (name, layers (None: all), batch, seq,
# layouts); the rehearsal's at reduced gemma2-2b (window 16), where the
# query chunk and the loss chunk are GEMMA2_REHEARSAL_CHUNK (8 of each at
# seq 64, as 8 of 1024 at 8192 on the card).  ``long`` keeps 6 layers:
# with the tied head a shallow model at init predicts its input token
# (x ~ sqrt(d) emb[t] dominates the final norm: at 2 layers the loss read
# 17.47, not ln(256000) = 12.45; at all 26, 12.85)
GEMMA2_TRAIN_RUNS = (("full", None, 4, 512, ("2d",)),
                     ("long", 6, 1, 8192, ("2d", "1d")))
GEMMA2_REHEARSAL_RUNS = (("full", None, 2, 32, ("2d",)),
                         ("long", 2, 1, 64, ("2d", "1d")))
GEMMA2_REHEARSAL_CHUNK = 8


def check_head_kernels(torch, device, cfg, rows, seed):
    """The 2D training kernels at the tied head's shape, d x V: the
    quantizer on the bf16 head weight ((8,8): a step quantizes it once a
    loss chunk) bit for bit and timed, and the fused forward emitting x's
    codes at each M of ``rows`` (a whole batch; one loss chunk), as
    ``phase_train_kernels`` checks wg's."""
    from repro_torch.core import blocking as B
    from repro_torch.models.transformer import head_shape
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    timer = Timer(torch, device)
    d, V = head_shape(cfg)
    w = (torch.randn((d, V), generator=gen, device=device)
         * 0.02).to(torch.bfloat16)
    _, w8 = check_quantize(torch, timer, w, (8, 8), "head w",
                           _codec_edge(torch, 128, 256, gen, device))
    del w
    for m in rows:
        x = torch.randn((m, d), generator=gen, device=device).to(
            torch.bfloat16)
        x8 = B.quantize(x, "mxsf", (8, 8))
        check_fused_train(torch, timer, gen, f"head forward, M {m}", x, *w8,
                          (8, 8), (8, 8), want_codes=(x8.codes,
                                                      x8.scale_e8m0))
    del timer


def phase_train_gemma2(torch, device, args, rehearsal):
    """gemma2-2b training: ``MXSF_TRAIN`` on the kernel datapath, remat
    ``"dots"``, f32 AdamW, seeded weights and uniform seeded tokens
    (``lm_source``: its 256000^2 f32 table would take 262 GB; printed).
    Run ``full``: all 26 layers at full width, 4 x 512, 2D.  Run
    ``long``: 6 of the 26 layers (the even ones local with the 4096
    window, the odd ones global), 1 x 8192, 2D and 1D: 8 query chunks of
    ``blocks.ATTN_CHUNK`` (chunks 4-7 lose keys on the local layers) and
    8 head chunks of ``xent_chunk`` rows, both softcaps.  First the
    head's kernels at its shape (``check_head_kernels``); then each run
    and layout: ``phase_train`` (2 steps and one profiled: the loss
    within 1.5 of ln(vocab), launches equal to the path's), then
    ``phase_train_slice`` (every kernel call against its plain version,
    the head's calls the path's, the loss over every head chunk with the
    final softcap).  Each depth cut printed."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import MXSF_TRAIN
    from repro_torch.models import blocks
    from repro_torch.models.transformer import layer_windows
    from repro_torch.train.step import TrainConfig
    pol2 = MXSF_TRAIN.replace(backend="cuda")
    layouts = {"2d": pol2,
               "1d": pol2.replace(block_mode="1d", quantize_bwd=True)}
    base, runs = get_config("gemma2-2b"), GEMMA2_TRAIN_RUNS
    tcfg, attn_chunk = TrainConfig(), blocks.ATTN_CHUNK
    if rehearsal:
        base, runs = base.reduced(), GEMMA2_REHEARSAL_RUNS
        tcfg = tcfg.replace(xent_chunk=GEMMA2_REHEARSAL_CHUNK)
        attn_chunk = GEMMA2_REHEARSAL_CHUNK
    emit("train_gemma2", step="data", data=lm_source(base),
         lm_table_bytes=4 * base.vocab ** 2, lm_table_max=LM_TABLE_MAX)
    # the rows of each run's head calls: the batch's, or a loss chunk's
    check_head_kernels(torch, device, base, sorted({
        b * (s if lm_head_calls(base, tcfg, s) == 1 else tcfg.xent_chunk)
        for _, _, b, s, _ in runs}, reverse=True), args.seed)
    free_device(torch, device)
    launches = {}
    saved, blocks.ATTN_CHUNK = blocks.ATTN_CHUNK, attn_chunk
    try:
        for run, depth, batch, seq, labels in runs:
            cfg = base
            if depth and depth < base.n_layers:
                emit("train_gemma2", run=run, step="cut", n_layers=depth,
                     of=base.n_layers)
                cfg = base.replace(n_layers=depth)
            emit("train_gemma2", run=run, step="plan", batch=batch, seq=seq,
                 windows=layer_windows(cfg, cfg.n_layers),
                 query_chunks=seq // blocks._pick_chunk(seq),
                 head_calls=lm_head_calls(cfg, tcfg, seq),
                 attn_softcap=cfg.attn_softcap,
                 final_softcap=cfg.final_softcap)
            for label in labels:
                t0 = time.perf_counter()
                name = f"{run}_{label}"
                state, batches, launches[f"train_gemma2_{name}"] = \
                    phase_train(torch, device, cfg, layouts[label], args, 2,
                                batch, seq, name, profile=True,
                                phase="train_gemma2", tcfg=tcfg)
                phase_train_slice(torch, device, cfg, layouts[label], state,
                                  batches[0], name, phase="train_gemma2",
                                  tcfg=tcfg)
                emit("train_gemma2", layout=name, step="done",
                     seconds=time.perf_counter() - t0)
                del state, batches
                free_device(torch, device)
    finally:
        blocks.ATTN_CHUNK = saved
    return launches


# ---------------------------------------------------------------------------
# the dry run held against the card ("dryrun") and the examples ("examples")
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the SSM, hybrid and encoder-decoder families on a mesh
# ("serve_sharded_families")
# ---------------------------------------------------------------------------

SHARD_FAM_DIR = ROOT / "build" / "chip_smoke_sharded_families"  # results,
# a folder a program
# the most the one-device reorder baseline (``family_reference``) may move
# each family's logits on the card: the move recorded on the H100 (the
# same bits in two runs of this deterministic path and its seeded
# inputs) plus one bf16 ulp of a logit in [4, 8)
FAMILY_REORDER_CEILING = {"mamba2-780m": 0.4140625 + 2.0 ** -5,
                          "zamba2-7b": 0.27734375 + 2.0 ** -5,
                          "whisper-medium": 0.091796875 + 2.0 ** -5}
FAMILY_DECODES = 8  # decode steps a program runs, filling families_plan's
# max_len past the prompt
# the negative controls of the exact gate, by family: the emulation with
# each row-parallel partial rounded to bf16 before the sum, and with each
# rank's SSD heads normalised by the mean over its own d_inner / tp
FAMILY_PLANTED = {"ssm": ("bf16_partials", "local_norm"),
                  "hybrid": ("bf16_partials", "local_norm"),
                  "encdec": ("bf16_partials",)}


def families_plan(rehearsal: bool) -> dict:
    """The programs of phase serve_sharded_families, with the one-card
    family phases' shapes: ``{arch: dict(n_layers, n_enc_layers, batch,
    prompt, max_len)}`` -- mamba2 at all 48 layers (batch 4, a 256-token
    prompt), zamba2 at two groups and its tail (15 of 81 layers; batch 2,
    a 256-token prompt, the packed MXSF cache), whisper at 24 + 24 layers
    (batch 2, 1500 seeded frames, the packed MXSF self cache)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    out = {}
    for arch, batch, prompt in (("mamba2-780m", 4, 256),
                                ("zamba2-7b", 2, 256),
                                ("whisper-medium", 2, 0)):
        cfg = get_config(arch)
        if rehearsal:
            cfg, prompt = cfg.reduced(), (32 if prompt else 0)
        if cfg.family == "hybrid":
            cfg = dryrun.at_depth(cfg, 2)
        out[arch] = dict(n_layers=cfg.n_layers,
                         n_enc_layers=cfg.n_enc_layers, batch=batch,
                         prompt=prompt,
                         max_len=max(prompt, 8) + FAMILY_DECODES)
    return out


def family_program(arch: str, prog: dict, rehearsal: bool):
    """(config, policy) of one program of ``families_plan``."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import MXSF_INFER
    cfg = get_config(arch)
    cfg = (cfg.reduced() if rehearsal else cfg).replace(
        n_layers=prog["n_layers"], n_enc_layers=prog["n_enc_layers"])
    return cfg, MXSF_INFER.replace(kv_cache_fmt="mxsf", backend="cuda")


def family_batch(torch, device, cfg, prog, seed):
    """The whole prefill batch of a program (seeded prompts, or whisper's
    seeded bf16 frames) and the FAMILY_DECODES tokens (B, FAMILY_DECODES)
    its decode steps are fed in turn (the first: whisper's first prompt
    token, a seeded token for the others; then a seeded stream): the
    same in every process that draws them."""
    B = prog["batch"]
    feed = torch.tensor([a + b for a, b in zip(
        _prompts(cfg, seed + 2, [1] * B),
        _prompts(cfg, seed + 3, [FAMILY_DECODES - 1] * B))], device=device)
    if cfg.family == "encdec":
        return {"frames": _stub(torch, device, seed + 1,
                                (B, cfg.enc_seq, cfg.d_model), 1.0)}, feed
    return {"tokens": torch.tensor(_prompts(cfg, seed, [prog["prompt"]] * B),
                                   device=device)}, feed


def family_logits(torch, cfg, policy, prog, store, batch, token, device):
    """One device's lockstep prefill and decode step of a program, the
    decode fed ``token``: ``{"prefill": logits or None, "decode":
    logits}`` over the real vocab, f32."""
    from repro_torch.models import model as M
    cache = M.init_cache(cfg, prog["batch"], prog["max_len"], ring=False,
                         kv_fmt="mxsf", device=device)
    lp, cache = M.prefill(store, batch, cache, cfg, policy)
    S = 0 if cfg.family == "encdec" else prog["prompt"]
    ld, _ = M.decode_step(store, token, cache, S, cfg, policy)
    return {"prefill": None if lp is None else lp[:, :cfg.vocab].float(),
            "decode": ld[:, :cfg.vocab].float()}


def family_reference(torch, device, arch, cfg, policy, prog, store, batch,
                     feed):
    """One device's logits of a program's prefill and first decode step
    (``family_logits``) over ``store`` (drawn from ``--seed``) on the
    kernel datapath, then again with every fused matmul on its plain
    version (cuBLAS's f32 order over the same exact products): (the
    reference logits, the reorder baseline -- the largest logit move
    between the two, capped on the card by FAMILY_REORDER_CEILING)."""
    from repro_torch.kernels import mxsf_fused_matmul as FM
    phase = "serve_sharded_families"
    token = feed[:, :1]
    ref = family_logits(torch, cfg, policy, prog, store, batch, token,
                        device)
    kernel = FM.mxsf_fused_matmul
    FM.mxsf_fused_matmul = FM.mxsf_fused_matmul_plain
    try:
        plain = family_logits(torch, cfg, policy, prog, store, batch, token,
                              device)
    finally:
        FM.mxsf_fused_matmul = kernel
    kinds = [k for k in ref if ref[k] is not None]
    dev = max(float((plain[k] - ref[k]).abs().max()) for k in kinds)
    ceiling = FAMILY_REORDER_CEILING[arch] if device.type == "cuda" else None
    emit(phase, step="reorder_baseline", arch=arch, n_layers=cfg.n_layers,
         max_dev=dev, ceiling=ceiling, argmax_equal=all(
             bool((plain[k].argmax(-1) == ref[k].argmax(-1)).all())
             for k in kinds))
    if ceiling is not None and dev > ceiling:
        raise AssertionError(f"{phase} {arch}: the reorder baseline moved "
                             f"the logits by {dev}, past its ceiling "
                             f"{ceiling}")
    return {k: None if v is None else v.cpu() for k, v in ref.items()}, dev


def ssd_local_shapes(cfg, tp=SHARD_TP):
    """(K, N) of an SSD layer's fused matmuls at ``tp`` ranks on the model
    axis: in_proj column-parallel by segment (z, x and dt of H / tp heads,
    all of B and C) and out_proj row-parallel (K = d_inner / tp)."""
    gn = 2 * cfg.ssm_ngroups * cfg.ssm_state
    n = (2 * cfg.d_inner + cfg.ssm_heads) // tp + gn
    return [(cfg.d_model, n), (cfg.d_inner // tp, cfg.d_model)]


def cache_leaves(cache, pre=()):
    """A (nested) cache dict's tensors by path."""
    out = {}
    for k, v in sorted(cache.items()):
        if isinstance(v, dict):
            out.update(cache_leaves(v, pre + (k,)))
        else:
            out[pre + (k,)] = v
    return out


def stored_slice(t, path, rank, tp, layout, heads):
    """A rank's stored slice of the whole cache leaf ``t`` at ``path``, as
    its layout keeps it: the SSD state's heads and the conv tail's
    channels where ``ssd_cache`` splits them; an attention cache's kv
    heads where the plan splits the heads (``heads``) or the cache does
    (``cache_heads`` / ``cross_cache``), its positions where the cache
    does (``cache_sp``, ``cross_cache``)."""
    def part(dim, split):
        n = t.shape[dim] // split[2]
        return t.narrow(dim, split[1], n)

    name = path[-1]
    if name in ("state", "conv"):
        if layout["ssd_cache"][name]:
            dim = -3 if name == "state" else -1
            n = t.shape[dim] // tp
            t = t.narrow(dim, rank * n, n)
        return t
    if name not in ("k", "v", "k_codes", "k_scales", "v_codes", "v_scales"):
        return t
    sp, ch = (layout.get("cross_cache") or (None, None)) \
        if path[0] == "cross" else (layout.get("cache_sp"),
                                    layout.get("cache_heads"))
    if heads:
        n = t.shape[-2] // tp
        t = t.narrow(-2, rank * n, n)
    elif ch is not None:
        t = part(-2, ch)
    return t if sp is None else part(-3, sp)


def family_dispatches(torch, cfg, policy, prog, params, cache, batch, feed,
                      run, n=None):
    """A program's dispatches after the lockstep pair (or, with ``run``
    None, all of them on one device): each of the FAMILY_DECODES decode
    steps past the first fed its column of ``feed`` at its position,
    each inside ``layer_taps``; ``run(step)`` issues a dispatch (a rank's
    ``place.run``).  Yields (logits rows, named taps) a dispatch; ``n``
    dispatches at most."""
    from repro_torch.models import model as M
    S = 0 if cfg.family == "encdec" else prog["prompt"]
    first = 0 if run is None else 2
    run = run or (lambda step: step())
    for d in range(first, min(FAMILY_DECODES + 1, n or FAMILY_DECODES + 1)):
        with layer_taps(torch, named=True) as taps:
            if d == 0:
                lk, _ = run(lambda: M.prefill(params, batch, cache, cfg,
                                              policy))
            else:
                lk, _ = run(lambda: M.decode_step(
                    params, feed[:, d - 1:d], cache, S + d - 1, cfg, policy))
        yield (None if lk is None else lk[:, :cfg.vocab].float().cpu(),
               list(taps))


def emulate_family(torch, device, cfg, policy, prog, store, batch, feed,
                   planted=None, n=None):
    """The (1, SHARD_TP) ranks of a program emulated on one device over
    the whole store (``emulating`` the plan ``emulated_plan`` states, at
    the ranks' CPU thread count): its dispatches (``n`` at most) as the
    ranks run them, each one's logits rows and sublayer digests, and the
    whole cache after the last (on the host)."""
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    plan = emulated_plan(cfg, policy)
    cache = M.init_cache(cfg, prog["batch"], prog["max_len"], ring=False,
                         kv_fmt="mxsf", device=device)
    with rank_threads(torch), emulating(torch, store, plan,
                                        planted=planted):
        runs = list(family_dispatches(torch, cfg, policy, prog, store, cache,
                                      batch, feed, None, n))
    return dict(plan=plan, rows=[r for r, _ in runs],
                taps=[t for _, t in runs],
                cache={k: v.cpu() for k, v in cache_leaves(cache).items()},
                seconds=time.perf_counter() - t0)


def family_main(torch, device, arch, prog, args, rehearsal):
    """This process's part of a program, beside the ranks: the whole
    store drawn from ``--seed``, one device's reference and reorder
    baseline (``family_reference``), the emulation of the ranks' plan
    over all of its dispatches (``emulate_family``) and, on the first
    dispatch, each negative control of FAMILY_PLANTED."""
    from repro_torch.models import model as M
    cfg, policy = family_program(arch, prog, rehearsal)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    store = M.init_packed_params(cfg, policy, gen, device=device)
    batch, feed = family_batch(torch, device, cfg, prog, args.seed)
    ref, baseline = family_reference(torch, device, arch, cfg, policy, prog,
                                     store, batch, feed)
    emu = emulate_family(torch, device, cfg, policy, prog, store, batch,
                         feed)
    controls = {p: emulate_family(torch, device, cfg, policy, prog, store,
                                  batch, feed, p, 1)
                for p in FAMILY_PLANTED[cfg.family]}
    del store
    free_device(torch, device)
    return dict(ref=ref, baseline=baseline, emu=emu, controls=controls)


def sharded_family_rank(rank: str, world: str, port: str, rehearsal: str,
                        spec_file: str):
    """One rank of phase serve_sharded_families' two-rank run: for each
    program of ``families_plan``, draw this rank's slices of the store
    from the seed (``engine.draw_store``) and place a cache, hold both
    bytes to ``MeshRules.shard_nbytes``; run the lockstep prefill and
    decode of ``engine.lockstep_dispatches`` (the decode fed the first of
    ``family_batch``'s tokens) with every kernel call teacher-forced
    (``checked_kernels``) at its shard-local shape, counting launches and
    collectives (the ``dispatch`` record phase dryrun_mesh holds the
    trace to; the checks' plain versions launch nothing and send
    nothing), then the program's other decode steps
    (``family_dispatches``).  Saves for the exact gate every dispatch's
    logits rows and sublayer digests, a digest of each of its stored
    cache slices after the last, and its layout.  Results to the spec
    file's folder."""
    from repro_torch.core import sharding as shd
    from repro_torch.launch import cost
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E
    spec = json.loads(Path(spec_file).read_text())
    out_dir = Path(spec_file).parent
    with gloo_rank(rank, world, port, rehearsal, out_dir) as (
            torch, device, rank, world, out):
        mesh = mesh_lib.make_test_mesh(1, world)
        rules = mesh_lib.MeshRules(mesh)
        out.update(dispatch={}, launches={}, families={})
        for arch, prog in spec["programs"].items():
            t0 = time.perf_counter()
            cfg, policy = family_program(arch, prog, rehearsal == "1")
            B = prog["batch"]
            gen = torch.Generator(device=device).manual_seed(spec["seed"])
            store, specs, sh = E.draw_store(cfg, policy, gen, mesh, device)
            cache, cache_sh, pol, fallback = E.cache_placement(
                cfg, policy, rules, B, prog["max_len"], device, ring=False,
                kv_fmt="mxsf")
            place = E.placement(cfg, pol, rules, specs, sh, cache_sh, cache)
            shapes = M.init_cache(cfg, B, prog["max_len"], ring=False,
                                  kv_fmt="mxsf", device="meta")
            row = dict(arch=arch, n_layers=cfg.n_layers,
                       store_bytes=_tree_bytes(store),
                       predicted_store_bytes=rules.shard_nbytes(specs, sh),
                       cache_bytes=_tree_bytes(cache),
                       predicted_cache_bytes=rules.shard_nbytes(
                           shapes, cache_sh),
                       tp_plan=place.layout["plan"]._asdict(),
                       attn_backend=M.decode_attn_backend(cfg, pol,
                                                          cache_sh),
                       shard_fallback=fallback,
                       draw_seconds=time.perf_counter() - t0)
            if (row["store_bytes"], row["cache_bytes"]) != (
                    row["predicted_store_bytes"],
                    row["predicted_cache_bytes"]):
                raise AssertionError(f"{arch}: store / cache bytes "
                                     f"{row['store_bytes']} / "
                                     f"{row['cache_bytes']} != MeshRules' "
                                     f"{row['predicted_store_bytes']} / "
                                     f"{row['predicted_cache_bytes']}")
            batch, feed = family_batch(torch, device, cfg, prog,
                                       spec["seed"])
            disp = dict(n_layers=cfg.n_layers, store_bytes=row["store_bytes"],
                        cache_bytes=row["cache_bytes"])
            rows, taps = [], []
            with checked_kernels(torch, lambda k: MATMUL_RTOL, None) as chk:
                for kind, run in E.lockstep_dispatches(
                        cfg, pol, place, store, cache, batch, feed[:, :1]):
                    _sync(torch, device)
                    reset_launches()
                    shd.reset_counts()
                    t1 = time.perf_counter()
                    with layer_taps(torch, named=True) as t:
                        lk, cache = run()
                    _sync(torch, device)
                    disp[kind] = dict(
                        launches=({k: v for k, v in read_launches().items()
                                   if v} if device.type == "cuda" else None),
                        collectives=cost.collectives_by_axis(shd.counts()))
                    row[f"{kind}_seconds"] = time.perf_counter() - t1
                    rows.append(None if lk is None else
                                lk[:, :cfg.vocab].float().cpu())
                    taps.append(list(t))
            t1 = time.perf_counter()
            for lk, t in family_dispatches(torch, cfg, pol, prog, store,
                                           cache, batch,
                                           place.rows_of(feed)[0], place.run):
                rows.append(lk)
                taps.append(t)
            _sync(torch, device)
            row["decodes_seconds"] = time.perf_counter() - t1
            torch.save(dict(rows=rows, taps=taps, layout={
                k: place.layout.get(k) for k in (
                    "ssd_cache", "cache_sp", "cache_heads", "cross_cache")},
                cache={"/".join(k): (tuple(v.shape), digest(torch, v))
                       for k, v in cache_leaves(cache).items()}),
                out_dir / f"exact_{arch}_rank{rank}.pt")
            backend = row["attn_backend"]
            expect = {k: family_launch_counts(cfg, backend, "prefill")[k]
                      + family_launch_counts(cfg, backend)[k]
                      for k in ("mxsf_fused_matmul", "mxsf_attention",
                                "mxsf_quantize")}
            kernels, faults = chk.rows(expect)
            fused = sorted({(c["k"], c["n"])
                            for c in chk.calls["mxsf_fused_matmul"]})
            heads = sorted({(c["heads"], c["kv_heads"])
                            for c in chk.calls["mxsf_attention"]})
            tp = rules.tp_size
            if cfg.family != "encdec":
                missing = set(ssd_local_shapes(cfg, tp)) - set(fused)
                if missing:
                    faults.append(f"SSD shapes {sorted(missing)} not run")
            if cfg.family != "ssm" and row["tp_plan"]["heads"] and \
                    heads != [(cfg.n_heads // tp, cfg.n_kv // tp)]:
                faults.append(f"attention heads {heads}")
            row.update(kernels=kernels, fused_shapes=fused,
                       attention_heads=heads,
                       seconds=time.perf_counter() - t0)
            if faults:
                raise AssertionError(f"{arch} checked dispatches: {faults}")
            out["families"][arch] = row
            out["dispatch"][arch] = disp
            for kind in ("prefill", "decode"):
                for k, v in (disp[kind]["launches"] or {}).items():
                    out["launches"][k] = out["launches"].get(k, 0) + v
            del store, cache, place
            free_device(torch, device)


def family_exact_gate(torch, phase, arch, main, ranks):
    """Each rank of a program held to the emulation (``family_main``) bit
    for bit: its plan field by field against ``emulated_plan``, every
    logits row and its top-1 under ``torch.equal`` (``bitwise_rows`` of
    ``rows``; the first row that differs: dispatch kind, step, row, max
    |delta|), every sublayer digest (the first that differs: dispatch,
    layer, kind) and every stored cache slice (the emulation's whole
    cache cut as the rank's layout stores it, ``stored_slice``; the first
    leaf that differs).  The negative controls: each planted
    misstatement's first dispatch must differ from the rank's.  One line
    a rank; returns the faults."""
    emu, faults = main["emu"], []
    keys = [(d, i) for d, rows in enumerate(emu["rows"]) if rows is not None
            for i in range(rows.shape[0])]
    for r, res in enumerate(ranks):
        got = torch.load(SHARD_FAM_DIR / arch / f"exact_{arch}_rank{r}.pt")
        plan = res["families"][arch]["tp_plan"]
        plan_off = {k: dict(rank=plan.get(k), emulated=v)
                    for k, v in emu["plan"].items() if plan.get(k) != v}

        def same(d, i, want):
            row = got["rows"][d] if d < len(got["rows"]) else None
            return (row is not None and torch.equal(row[i], want[d][i])
                    and int(row[i].argmax()) == int(want[d][i].argmax()))

        off = next((k for k in keys if not same(*k, emu["rows"])), None)
        if off is not None:
            d, i = off
            row = got["rows"][d] if d < len(got["rows"]) else None
            off = dict(kind="decode" if d else "prefill", step=d, row=i,
                       max_abs_delta=None if row is None else float(
                           (row[i] - emu["rows"][d][i]).abs().max()))
        bitwise = sum(same(*k, emu["rows"]) for k in keys)
        sub = first_tap_difference(got["taps"], emu["taps"])
        want = {"/".join(k): (tuple(v.shape), digest(torch, v)) for k, v in (
            (k, stored_slice(v, k, r, SHARD_TP, got["layout"],
                             emu["plan"]["heads"]))
            for k, v in emu["cache"].items())}
        cache_off = next((k for k in sorted(set(want) | set(got["cache"]))
                          if got["cache"].get(k) != want.get(k)), None)
        planted = {}
        for name, ctl in main["controls"].items():
            row, crow = got["rows"][0], ctl["rows"][0]
            planted[name] = dict(
                rejected=got["taps"][0] != ctl["taps"][0] or (
                    row is not None and not torch.equal(row, crow)),
                first_sublayer_differs=first_tap_difference(
                    got["taps"][:1], ctl["taps"]),
                max_abs_delta=None if row is None else float(
                    (row - crow).abs().max()))
        emit(phase, step="exact", arch=arch, rank=r, plan_fields_off=plan_off,
             bitwise_rows=bitwise, rows=len(keys), first_row_differs=off,
             sublayers=sum(len(t) for t in emu["taps"]),
             first_sublayer_differs=sub, cache_leaves=len(want),
             first_cache_leaf_differs=cache_off, planted=planted)
        if plan_off:
            faults.append(f"{arch} rank {r}: plan fields {sorted(plan_off)} "
                          "off the emulation's")
        if bitwise != len(keys) or len(got["rows"]) != len(emu["rows"]):
            faults.append(f"{arch} rank {r}: {bitwise} of {len(keys)} rows "
                          f"bitwise (first off: {off}; first sublayer off: "
                          f"{sub})")
        if sub is not None or cache_off is not None:
            faults.append(f"{arch} rank {r}: first sublayer off {sub}, "
                          f"first cache leaf off {cache_off}")
        faults += [f"{arch} rank {r}: the planted {name} went unnoticed"
                   for name, c in planted.items() if not c["rejected"]]
    return faults


def family_logit_check(torch, arch, ref, baseline, emu):
    """The emulation's logits of a program's prefill and first decode
    step against one device's ``ref``: within REORDER_FACTOR times the
    reorder baseline, or one bf16 ulp of the largest |logit| where that
    is more; the rows whose top-1 differs from one device's are listed
    (``disagree``)."""
    row = dict(arch=arch, baseline=baseline, tol=REORDER_FACTOR * baseline,
               max_dev=0.0, disagree=[])
    for d, kind in enumerate(("prefill", "decode")):
        want, got = ref[kind], emu["rows"][d]
        if want is None:
            continue
        row["tol"] = max(row["tol"], float(_bf16_ulp(torch,
                                                     want.abs().max())))
        row["max_dev"] = max(row["max_dev"],
                             float((got - want).abs().max()))
        row["disagree"] += [[kind, i] for i, same in enumerate(
            (got.argmax(-1) == want.argmax(-1)).tolist()) if not same]
    return row


def phase_serve_sharded_families(torch, device, args, rehearsal):
    """Phase serve_sharded_families: mamba2, zamba2 and whisper sharded
    over a (1, SHARD_TP) mesh.  A pair of SHARD_TP ranks a program, the
    three pairs at once sharing the card, each rank in its own process
    (``sharded_family_rank``) over gloo, while this process computes each
    program's one-device reference and reorder baseline, the emulation
    of the ranks' plan and its negative controls (``family_main``); then
    each rank is held to the emulation bit for bit
    (``family_exact_gate``) and the emulation to the reference within
    REORDER_FACTOR times the baseline (``family_logit_check``).  Returns
    the launches of each program's rank 0 (its counted prefill and
    decode), summed."""
    import shutil
    t_phase = time.perf_counter()
    phase = "serve_sharded_families"
    plan = families_plan(rehearsal)
    emit(phase, step="plan", ranks=SHARD_TP, programs=plan)
    shutil.rmtree(SHARD_FAM_DIR, ignore_errors=True)
    pairs = {}
    try:  # each pair's gathers go through host memory: the pairs overlap
        for arch, prog in plan.items():
            pairs[arch] = start_rank_processes(
                "sharded_family_rank", dict(programs={arch: prog},
                                            seed=args.seed),
                SHARD_FAM_DIR / arch, SHARD_TP, rehearsal)
        mains = {arch: family_main(torch, device, arch, prog, args,
                                   rehearsal)
                 for arch, prog in plan.items()}
        t_main = time.perf_counter() - t_phase
        ranks = {arch: finish_rank_processes(phase, started,
                                             SHARD_FAM_DIR / arch)
                 for arch, started in pairs.items()}
    finally:
        for procs, _ in pairs.values():
            stop_processes(procs)
    faults, launches = [], {}
    for arch, main in mains.items():
        faults += family_exact_gate(torch, phase, arch, main, ranks[arch])
        row = family_logit_check(torch, arch, main["ref"], main["baseline"],
                                 main["emu"])
        emit(phase, step="emulation", seconds=main["emu"]["seconds"],
             plan=main["emu"]["plan"], **row)
        if row["max_dev"] > row["tol"]:
            faults.append(f"{arch}: the emulation's logits {row['max_dev']} "
                          f"off one device's, past {row['tol']}")
        for k, v in ranks[arch][0]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    emit(phase, step="done", seconds=time.perf_counter() - t_phase,
         main_seconds=t_main, ranks=SHARD_TP)
    if faults:
        raise AssertionError(f"{phase}: {faults}")
    return {f"serve_sharded_families_1x{SHARD_TP}": launches}


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
DRYRUN_MESH_DIR = ROOT / "build" / "chip_smoke_dryrun_mesh"
# the cells phase dryrun_mesh traces on the production meshes (the
# rehearsal: a shape whose cache splits 512 ways)
MESH_CELLS = (("qwen2.5-32b", "decode_32k"), ("mamba2-780m", "decode_32k"))
MESH_CELL_MESHES = ("16x16", "2x16x16")


def dryrun_shapes(rehearsal: bool) -> dict:
    """The shapes the dry-run cells add to ``SHAPES``: phase "train"'s
    batch x seq; the rehearsal's tiny stand-ins for the rest."""
    from repro_torch.configs.base import ShapeConfig
    if not rehearsal:
        return {"smoke_train": ShapeConfig("smoke_train", 512, 4, "train")}
    return {"smoke_train": ShapeConfig("smoke_train", 32, 2, "train"),
            "rehearsal_mesh_decode": ShapeConfig("rehearsal_mesh_decode",
                                                 512, 32, "decode"),
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
                     "--kv-cache", "mxsf", "--mesh", "1x1", "--out",
                     out_dir])


def sharded_engines(rehearsal: bool) -> dict:
    """The programs phases serve_sharded and serve_sharded_moe run on two
    ranks, at the depth they run when the disk and the card allow it
    (phase dryrun_mesh traces another depth again itself): ``{phase:
    dict(arch, n_layers, slots, max_len, chunk, block_1d, backend)}``.
    The kernels' ``meta`` branches take 64-element blocks only, so the
    rehearsal's 16-element ones trace through the torch datapath (its
    collectives and bytes are the kernel datapath's; it launches
    nothing)."""
    from repro_torch.configs.base import get_config
    sfx = "-reduced" if rehearsal else ""
    dense, moe = "qwen2.5-32b" + sfx, "qwen2-moe-a2.7b" + sfx
    backend = "torch" if rehearsal else "cuda"
    return {"serve_sharded": dict(
        arch=dense, n_layers=min(CKPT_LAYERS, get_config(dense).n_layers),
        slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN[rehearsal],
        chunk=SERVE_CHUNK, block_1d=BLOCK_1D[rehearsal], backend=backend),
        "serve_sharded_moe": dict(
            arch=moe, n_layers=min(MOE_LAYERS, get_config(moe).n_layers),
            slots=MOE_SLOTS, max_len=MOE_MAX_LEN[rehearsal], chunk=1,
            block_1d=BLOCK_1D[rehearsal], backend=backend)}


def trace_sharded_engine(engine: dict, n_layers: int, rank: int) -> dict:
    """``dryrun.engine_dispatches`` of one rank of a (1, SHARD_TP) mesh
    for one of ``sharded_engines``' programs at ``n_layers``."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import MXSF_INFER
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    cfg = get_config(engine["arch"]).replace(n_layers=n_layers)
    pol = MXSF_INFER.replace(kv_cache_fmt="mxsf",
                             block_1d=engine["block_1d"])
    mesh = mesh_lib.make_tracing_mesh((1, SHARD_TP), rank)
    rec = dryrun.engine_dispatches(cfg, pol, mesh, engine["slots"],
                                   engine["max_len"], engine["chunk"],
                                   engine["backend"])
    return dict(rec, n_layers=n_layers,
                trace_seconds=time.perf_counter() - t0)


def trace_family(arch: str, prog: dict, rank: int, rehearsal: bool) -> dict:
    """``dryrun.lockstep_counts`` of one rank of a (1, SHARD_TP) mesh for
    one program of ``families_plan``, on its batch's shapes."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    cfg, policy = family_program(arch, prog, rehearsal)
    B = prog["batch"]
    batch = ({"frames": torch.empty((B, cfg.enc_seq, cfg.d_model),
                                    dtype=torch.bfloat16, device="meta")}
             if cfg.family == "encdec" else
             {"tokens": torch.empty((B, prog["prompt"]), dtype=torch.int64,
                                    device="meta")})
    rec = dryrun.lockstep_counts(cfg, policy, mesh_lib.make_tracing_mesh(
        (1, SHARD_TP), rank), batch, prog["max_len"])
    return dict(rec, n_layers=cfg.n_layers,
                trace_seconds=time.perf_counter() - t0)


def dryrun_mesh_worker(out_dir: str, rehearsal: str):
    """The mesh worker: each rank of ``train_sharded_plan``'s,
    ``train_moe_plan``'s and ``train_families_plan``'s programs on its
    tracing mesh (``trace_train_sharded``: the sharded train step),
    of ``sharded_engines``' programs and of ``families_plan``'s on a
    tracing mesh of (1, SHARD_TP) (``trace_sharded_engine``,
    ``trace_family``), then ``launch.dryrun``
    of each of MESH_CELLS on each of MESH_CELL_MESHES (the layer-period
    trace, kernel datapath, packed MXSF cache), written to ``out_dir``."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    rehearsal = rehearsal == "1"
    for plan in (train_sharded_plan(rehearsal), train_moe_plan(rehearsal),
                 train_families_plan(rehearsal)):
        for prog in plan["programs"]:
            for rank in range(SHARD_TP):
                rec = trace_train_sharded(plan, prog, rank, rehearsal)
                (Path(out_dir) / f"train_{prog['name']}__rank{rank}.json"
                 ).write_text(json.dumps(rec))
    for name, engine in sharded_engines(rehearsal).items():
        for rank in range(SHARD_TP):
            rec = trace_sharded_engine(engine, engine["n_layers"], rank)
            (Path(out_dir) / f"{name}__rank{rank}.json").write_text(
                json.dumps(rec))
    for arch, prog in families_plan(rehearsal).items():
        for rank in range(SHARD_TP):
            rec = trace_family(arch, prog, rank, rehearsal)
            (Path(out_dir) / f"families_{arch}__rank{rank}.json"
             ).write_text(json.dumps(rec))
    SHAPES.update(dryrun_shapes(rehearsal))
    for arch, shape in mesh_cells(rehearsal):
        for mesh in MESH_CELL_MESHES:
            dryrun.main(["--arch", arch, "--shape", shape, "--backend",
                         "cuda", "--kv-cache", "mxsf", "--mesh", mesh,
                         "--out", out_dir])


def mesh_cells(rehearsal: bool):
    return [(arch + "-reduced", "rehearsal_mesh_decode") if rehearsal
            else (arch, shape) for arch, shape in MESH_CELLS]


def start_dryrun(rehearsal: bool):
    """Start the dry-run workers (they need no card, so they trace on the
    host's cores while the card phases run; ``CUDA_VISIBLE_DEVICES`` is
    empty there, so none makes a CUDA context): one per DRYRUN_WORKERS
    entry, and last the mesh worker (``dryrun_mesh_worker``).  Returns the
    processes."""
    import os
    import shutil
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    jobs = [(DRYRUN_DIR, f"worker{i}", "dryrun_worker",
             [":".join(dryrun_cell(a, s, rehearsal)) for a, s in cells])
            for i, cells in enumerate(DRYRUN_WORKERS)]
    jobs.append((DRYRUN_MESH_DIR, "worker", "dryrun_mesh_worker", []))
    for d in (DRYRUN_DIR, DRYRUN_MESH_DIR):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    for out_dir, log_name, target, names in jobs:
        log = open(out_dir / f"{log_name}.log", "w")
        code = (f"import sys, chip_smoke; "
                f"chip_smoke.{target}(*sys.argv[1:])")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(out_dir),
             str(int(rehearsal)), *names], cwd=str(ROOT), env=env,
            stdout=log, stderr=subprocess.STDOUT))
        log.close()
    emit("dryrun", step="start", workers=len(procs),
         cells=[list(c) for w in DRYRUN_WORKERS for c in w],
         mesh_cells=[[*c, m] for c in mesh_cells(rehearsal)
                     for m in MESH_CELL_MESHES],
         engines=sharded_engines(rehearsal),
         families=families_plan(rehearsal))
    return procs


def wait_worker(proc, log: Path, t0: float, phase: str):
    """Wait for a dry-run worker until DRYRUN_WAIT_S after ``t0``; a worker
    that fails or outlives it fails ``phase``."""
    try:
        rc = proc.wait(timeout=max(1.0, DRYRUN_WAIT_S
                                   - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        rc = None
    if rc != 0:
        raise AssertionError(f"{phase}: dry-run worker exited {rc}:\n"
                             f"{log.read_text()[-3000:]}")


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
        wait_worker(proc, DRYRUN_DIR / f"worker{i}.log", t0, "dryrun")
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


def _traced_counts(summary, on_card: bool) -> dict:
    """A traced dispatch as ``dispatch_counts`` holds a real one."""
    from repro_torch.launch import cost
    return dict(
        launches=({k: v for k, v in summary["cost"]["launches"].items() if v}
                  if on_card else None),
        collectives=cost.collectives_by_axis(summary["collectives"]))


def mesh_cell_argument_bytes(arch: str, shape_name: str, mesh_name: str):
    """``MeshRules.shard_nbytes`` of a decode cell's inputs on one rank of
    a mesh: the f32 parameters, the cache (``decode_specs``, packed MXSF),
    this rank's token rows and the scalar position."""
    import torch
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as M
    cfg, shape = get_config(arch), SHAPES[shape_name]
    rules = mesh_lib.MeshRules(dryrun.mesh_of(mesh_name))
    d = M.decode_specs(cfg, shape, kv_fmt="mxsf")
    tok = {"tokens": d["tokens"]}
    return (rules.shard_nbytes(M.init_params(cfg, torch.Generator(), "meta"))
            + rules.shard_nbytes(d["cache"], mesh_lib.cache_shardings(
                rules, d["cache"], shape.global_batch))
            + rules.shard_nbytes(tok, mesh_lib.batch_shardings(rules, tok))
            + d["pos"].element_size())


def _rank_row(faults, name, r, traced, real, on_card):
    """One rank's trace of a program held against what it ran: launches
    (on the card), collectives and the prefill's argument bytes."""
    row = dict(program=name, rank=r, mesh=f"1x{SHARD_TP}",
               n_layers=real["n_layers"],
               trace_seconds=traced["trace_seconds"],
               attn_backend=traced["attn_backend"],
               tp_plan=traced["tp_plan"], store_bytes=real["store_bytes"],
               cache_bytes=real["cache_bytes"])
    for kind in ("prefill", "decode"):
        got = _traced_counts(traced[kind], on_card)
        arg = traced[kind]["memory"]["argument_bytes"]
        want = {k: real[kind][k] for k in ("launches", "collectives")}
        row[kind] = dict(traced=got, ran=want, argument_bytes=arg,
                         equal=got == want)
        if got != want:
            faults.append(f"{name} rank {r} {kind}: traced {got} "
                          f"!= ran {want}")
    # a lockstep decode finds the cache the prefill wrote (an SSM's conv
    # tail in the projection's dtype): the prefill's arguments are the
    # store and the placed cache
    if row["prefill"]["argument_bytes"] != real["store_bytes"] + \
            real["cache_bytes"]:
        faults.append(f"{name} rank {r}: argument bytes != store + cache")
    emit("dryrun_mesh", step="rank", **row)


def phase_dryrun_mesh(torch, device, rehearsal, proc):
    """Phase dryrun_mesh (after serve_sharded, serve_sharded_moe and
    serve_sharded_families): wait for the mesh worker, then hold each
    rank's trace of each program against what that rank ran
    (``dispatch_counts`` in its results, or its family programs'
    ``dispatch``), one prefill and one decode dispatch each: launches by
    kernel (on the card), collectives by kind and axis with their operand
    bytes, and the argument bytes against the rank's store plus cache
    bytes, all exactly.  A rank that ran at another depth than the worker
    traced is traced again here at its depth.  Then each of MESH_CELLS on
    each of MESH_CELL_MESHES: the per-rank peak, ``fits``, the
    collectives and the three terms printed, the argument bytes against
    ``MeshRules``'."""
    t0 = time.perf_counter()
    wait_worker(proc, DRYRUN_MESH_DIR / "worker.log", t0, "dryrun_mesh")
    emit("dryrun_mesh", step="traced", wait_seconds=time.perf_counter() - t0)
    on_card = device.type == "cuda"
    faults = []
    for name, rank_dir in (("serve_sharded", SHARD_DIR),
                           ("serve_sharded_moe", SHARD_MOE_DIR)):
        engine = sharded_engines(rehearsal)[name]
        for r in range(SHARD_TP):
            real = json.loads((rank_dir / f"rank{r}.json").read_text())[
                "dispatch"]
            traced = json.loads((DRYRUN_MESH_DIR / f"{name}__rank{r}.json")
                                .read_text())
            if traced["n_layers"] != real["n_layers"]:
                traced = trace_sharded_engine(engine, real["n_layers"], r)
            arg = traced["decode"]["memory"]["argument_bytes"]
            if arg != real["store_bytes"] + real["cache_bytes"]:
                faults.append(f"{name} rank {r} decode: argument bytes "
                              f"{arg} != store + cache")
            _rank_row(faults, name, r, traced, real, on_card)
    for arch in families_plan(rehearsal):
        for r in range(SHARD_TP):
            real = json.loads((SHARD_FAM_DIR / arch / f"rank{r}.json")
                              .read_text())["dispatch"][arch]
            traced = json.loads((DRYRUN_MESH_DIR /
                                 f"families_{arch}__rank{r}.json").read_text())
            _rank_row(faults, arch, r, traced, real, on_card)
    from repro_torch.configs.base import SHAPES
    SHAPES.update(dryrun_shapes(rehearsal))
    for (arch, shape), mesh in [(c, m) for c in mesh_cells(rehearsal)
                                for m in MESH_CELL_MESHES]:
        rec = json.loads((DRYRUN_MESH_DIR / f"{arch}__{shape}__{mesh}.json")
                         .read_text())
        want = mesh_cell_argument_bytes(arch, shape, mesh)
        mem, roof = rec["memory"], rec["roofline"]
        emit("dryrun_mesh", step="cell", arch=arch, shape=shape, mesh=mesh,
             n_devices=rec["n_devices"], trace=rec["trace"],
             peak_bytes_per_device=mem["peak_bytes_per_device"],
             argument_bytes=mem["argument_bytes"], shard_nbytes=want,
             fits=rec["fits"], roofline=roof,
             collectives={k: {"count": c["count"], "bytes": c["bytes"]}
                          for k, c in rec["collectives"].items()
                          if c["count"]},
             collective_axes=rec["collective_axes"],
             attn_backend=rec["attn_backend"],
             shard_fallback=rec["shard_fallback"])
        if mem["argument_bytes"] != want:
            faults.append(f"{arch} {shape} {mesh}: argument bytes "
                          f"{mem['argument_bytes']} != {want}")
    if faults:
        raise AssertionError(f"dryrun_mesh: {faults}")


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
    the CPU in the rehearsal) at a small size, all at once (each is mostly
    its own start-up), sharing the host's cores: each must exit 0 within
    600 s and print its key lines."""
    import os
    import shutil
    wait_s = 600
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS=str(
        max(1, (os.cpu_count() or 1) // len(EXAMPLES))))
    out_dir = ROOT / "build" / "chip_smoke_examples"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    runs, ended, t0 = [], {}, time.perf_counter()
    try:
        for name, argv, lines in EXAMPLES:
            argv = list(argv)
            if name == "torch_train_lm.py":
                argv += ["--ckpt-dir", str(out_dir / "ckpt")]
            argv += ["--device", "cpu" if rehearsal else "cuda"]
            with open(out_dir / f"{name}.out", "w") as out, \
                    open(out_dir / f"{name}.err", "w") as err:
                runs.append((name, argv, lines, subprocess.Popen(
                    [sys.executable, str(ROOT / "examples" / name), *argv],
                    stdout=out, stderr=err, env=env, cwd=str(ROOT))))
        while len(ended) < len(runs):
            for name, _, _, proc in runs:
                if name not in ended and proc.poll() is not None:
                    ended[name] = time.perf_counter() - t0
            if time.perf_counter() - t0 > wait_s:
                left = [r[0] for r in runs if r[0] not in ended]
                raise AssertionError(f"examples {left} outlived {wait_s} s")
            time.sleep(0.2)
        for name, argv, lines, proc in runs:
            stdout = (out_dir / f"{name}.out").read_text()
            missing = [ln for ln in lines if ln not in stdout]
            emit("examples", example=name, argv=argv,
                 returncode=proc.returncode, seconds=ended[name],
                 missing=missing, tail=stdout.strip().splitlines()[-3:])
            if proc.returncode != 0 or missing:
                err = (out_dir / f"{name}.err").read_text()[-2000:]
                raise AssertionError(f"example {name}: exit "
                                     f"{proc.returncode}, missing {missing}"
                                     f"\n{err}")
    finally:
        stop_processes([r[3] for r in runs])
        shutil.rmtree(out_dir, ignore_errors=True)
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
    slots, chunk = SERVE_SLOTS, SERVE_CHUNK
    max_len, new_tokens = SERVE_MAX_LEN[rehearsal], 16 if not rehearsal else 4
    lengths = [37, 80, 143, 200] if not rehearsal else [5, 9, 20, 33]
    # the rehearsal's reduced widths (64 = 4 heads x 16) hold whole
    # 16-element blocks per shard of phase serve_sharded's model axis
    policy = MXSF_INFER.replace(kv_cache_fmt="mxsf",
                                block_1d=BLOCK_1D[rehearsal])

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
    launches.update(phase_serve_sharded_families(torch, device, args,
                                                 rehearsal))
    free_device(torch, device)
    phase_dryrun_mesh(torch, device, rehearsal, procs[-1])
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
    launches.update(phase_train_sharded(torch, device, args, rehearsal))
    free_device(torch, device)
    launches.update(phase_train_sharded_moe(torch, device, args, rehearsal))
    free_device(torch, device)
    launches.update(phase_train_sharded_families(torch, device, args,
                                                 rehearsal))
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
    free_device(torch, device)
    launches.update(phase_train_gemma2(torch, device, args, rehearsal))
    launches.update(phase_dryrun(torch, device, args, rehearsal,
                                 procs[:-1]))
    phase_examples(torch, device, rehearsal)
    return kernels_line(rows, attn, train_rows, launches, slots, cfg)


if __name__ == "__main__":
    sys.exit(main())
