"""Training entry point for decoder configs (the port of the JAX package's
``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch h2o-danube-1.8b --steps 20 --batch 4 --seq 512

Runs on the CUDA device unless ``--device cpu`` is given, through the
kernel datapath (``backend="cuda"``: on CPU tensors the kernels' plain
versions run).  The flags keep the JAX CLI's names.  Checkpointing and auto-resume
(``--ckpt-dir``, ``--ckpt-every``) need ``ckpt/`` and ``runtime/fault.py``,
which are not ported: either flag raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs.base import get_config
from ..core.policy import QuantPolicy
from ..data.pipeline import lm_batch
from ..optim.adamw import OptConfig
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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.ckpt_dir is not None or args.ckpt_every is not None:
        raise NotImplementedError(
            "--ckpt-dir/--ckpt-every need checkpoints and runtime/fault.py, "
            "not ported yet; see ROADMAP.md, Queue 1 item 7")
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
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = T.init_state(gen, cfg, ocfg, device=device)
    log = []
    t0 = time.time()
    for i in range(args.steps):
        toks, labs = lm_batch(args.seed, i, args.batch, args.seq, cfg.vocab,
                              device=device)
        state, metrics = step_fn(state, {"tokens": toks, "labels": labs})
        if i % args.log_every == 0 or i == args.steps - 1:
            row = {k: float(v) for k, v in metrics.items()}
            row["step"] = i
            row["wall_s"] = round(time.time() - t0, 1)
            log.append(row)
            print(f"step {i:5d} " +
                  " ".join(f"{k}={v:.4g}" for k, v in row.items()
                           if k != "step"), flush=True)
    print(f"done in {time.time() - t0:.1f}s", flush=True)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(log, f, indent=1)
    return state


if __name__ == "__main__":
    main()
