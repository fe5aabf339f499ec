"""End-to-end training entry point (the port of the JAX package's
``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch h2o-danube-1.8b --steps 20 --batch 4 --seq 512 \
        --ckpt-dir /tmp/run1

Decoder configs train on ``lm_batch``, the encoder (``deit-tiny``) on
``vision_batch``; append ``-reduced`` to an arch id for the CPU-scale
variant.  Runs on the CUDA device unless ``--device cpu`` is given, through
the kernel datapath (``backend="cuda"``: on CPU tensors the kernels' plain
versions run).  The flags keep the JAX CLI's names.  Fault tolerance is on
by default: the run checkpoints every ``--ckpt-every`` steps and
auto-resumes from the latest checkpoint in ``--ckpt-dir``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs.base import get_config
from ..core.policy import QuantPolicy
from ..data.pipeline import lm_batch, vision_batch
from ..optim.adamw import OptConfig
from ..runtime import fault
from ..train import step as T


def build_policy(name: str, block_mode: str, tile: int = 8,
                 block_1d: int = 64) -> QuantPolicy:
    if name == "bf16":
        return QuantPolicy(block_mode="none", backend="cuda")
    return QuantPolicy(fwd_fmt=name, bwd_fmt=name, block_mode=block_mode,
                       tile=tile, block_1d=block_1d, backend="cuda")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--policy", default="mxsf")
    ap.add_argument("--block-mode", default="2d", choices=["1d", "2d", "none"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--grad-compress", default=None)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_batch_fn(cfg, args, device):
    """``batch_fn(step)`` of the config's family."""
    if cfg.family == "encdec":
        raise NotImplementedError("encoder-decoder training is not ported "
                                  "yet; see ROADMAP.md, Queue 1 item 4d")
    if cfg.family == "decoder" and cfg.frontend_tokens:
        raise NotImplementedError("VLM prefix tokens are not ported yet; "
                                  "see ROADMAP.md, Queue 1 item 4c")

    def batch_fn(i):
        if cfg.family == "encoder":
            x, y = vision_batch(args.seed, i, args.batch, cfg.frontend_tokens,
                                cfg.d_model, cfg.n_classes, device=device)
            return {"embeds": x, "label": y}
        toks, labs = lm_batch(args.seed, i, args.batch, args.seq, cfg.vocab,
                              device=device)
        return {"tokens": toks, "labels": labs}

    return batch_fn


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on "
                           "the CPU")
    cfg = get_config(args.arch)
    policy = build_policy(args.policy, args.block_mode)
    ocfg = OptConfig(lr=args.lr, total_steps=args.steps,
                     warmup_steps=max(1, min(100, args.steps // 10)))
    tcfg = T.TrainConfig(remat=args.remat, microbatches=args.microbatches,
                         grad_compress=args.grad_compress,
                         xent_chunk=min(1024, args.seq))
    step_fn = T.make_train_step(cfg, policy, ocfg, tcfg)
    batch_fn = make_batch_fn(cfg, args, device)

    def init_fn():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return T.init_state(gen, cfg, ocfg, device=device)

    log = []
    t0 = time.time()

    def on_metrics(step, metrics):
        if step % args.log_every == 0 or step == args.steps - 1:
            row = dict(metrics)
            row["step"] = step
            row["wall_s"] = round(time.time() - t0, 1)
            log.append(row)
            print(f"step {step:5d} " +
                  " ".join(f"{k}={v:.4g}" for k, v in row.items()
                           if k != "step"), flush=True)

    fcfg = fault.FaultConfig(ckpt_dir=args.ckpt_dir,
                             ckpt_every=args.ckpt_every, async_save=True)
    state, dog = fault.train_loop(fcfg, init_fn, step_fn, batch_fn,
                                  args.steps, metrics_cb=on_metrics)
    print(f"done in {time.time() - t0:.1f}s; "
          f"stragglers at {dog.straggler_steps}", flush=True)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(log, f, indent=1)
    return state


if __name__ == "__main__":
    main()
