"""Direct-cast inference on the PyTorch/CUDA port (paper Table II
workflow): train BF16, cast to MX.

    PYTHONPATH=src python examples/torch_directcast_inference.py
    PYTHONPATH=src python examples/torch_directcast_inference.py --device cpu

The port's counterpart of ``examples/directcast_inference.py``, with its
own small reference trainer (the JAX example borrows one from the
benchmark folder, which is not ported): a 4-layer, 64-wide deit-tiny
trained in BF16 on the synthetic vision task, then evaluated with every
weight cast once into each MX format.  The cast is the pack-once weight
store: ``pack_model_params`` quantizes the weight tree a single time and
evaluation serves from the resident codes -- the deployment shape of the
paper's direct-cast numbers.
"""
import argparse

import torch

from repro_torch.configs.base import get_config
from repro_torch.core import packed_store
from repro_torch.core.policy import BF16, QuantPolicy
from repro_torch.data.pipeline import vision_batch
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import step as T

FORMATS = ["mxint8", "mxfp8_e4m3", "mxfp8_e2m5", "mxsf"]


def train_reference_model(device, steps: int = 150, lr: float = 1e-3,
                          seed: int = 0):
    """A small deit-tiny trained in BF16 on ``vision_batch``.  Returns
    (cfg, params, eval_acc(params, policy) -> accuracy)."""
    cfg = get_config("deit-tiny").replace(
        n_layers=4, d_model=64, n_heads=4, n_kv=4, d_head=16, d_ff=128,
        frontend_tokens=16, n_classes=16)
    ocfg = OptConfig(lr=lr, warmup_steps=20, total_steps=steps,
                     weight_decay=0.0)
    tcfg = T.TrainConfig(remat="none", xent_chunk=0)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = T.init_state(gen, cfg, ocfg, device=device)
    step_fn = T.make_train_step(cfg, BF16, ocfg, tcfg)

    def batch_at(i):
        x, y = vision_batch(seed, i, 64, cfg.frontend_tokens, cfg.d_model,
                            cfg.n_classes, device=device)
        return {"embeds": x, "label": y}

    for i in range(steps):
        state, _ = step_fn(state, batch_at(i))

    @torch.no_grad()
    def eval_acc(params, pol, n_batches: int = 8):
        correct = total = 0
        for i in range(1000, 1000 + n_batches):
            b = batch_at(i)
            logits = M.forward(params, b, cfg, pol)
            correct += int((torch.argmax(logits, -1) == b["label"]).sum())
            total += b["label"].numel()
        return correct / total

    return cfg, state["params"], eval_acc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="'cpu', or the card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("training a small reference model in BF16 ...")
    cfg, params, eval_acc = train_reference_model(device, args.steps)
    base = eval_acc(params, BF16)
    print(f"BF16 baseline accuracy      : {base:.4f}")
    for fmt in FORMATS:
        pol = QuantPolicy(fwd_fmt=fmt, block_mode="1d", block_1d=64,
                          quantize_bwd=False)
        # direct cast = pack once; eval consumes the resident codes
        packed = M.pack_model_params(cfg, params, pol)
        nb = packed_store.store_nbytes(packed)
        acc = eval_acc(packed, pol)
        print(f"direct-cast {fmt:12s} acc : {acc:.4f}  "
              f"(drop {base - acc:+.4f}, packed store "
              f"{nb['packed'] / 1e3:.0f} kB vs {nb['value_f32'] / 1e3:.0f} "
              "kB f32)")


if __name__ == "__main__":
    main()
