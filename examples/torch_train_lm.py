"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-param LM for a
few hundred steps in MXSF.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--small]
    PYTHONPATH=src python examples/torch_train_lm.py --small --device cpu

The port's counterpart of ``examples/train_lm.py``: the h2o-danube family
scaled to ~100M params (12L x 512d), the MXSF 2D training policy on the
kernel datapath, remat, checkpointing with auto-resume, through the port's
training CLI (``repro_torch.launch.train``).  ``--small`` drops to the
smoke-size config for a fast run.  A run resumes from the latest
checkpoint in ``--ckpt-dir``: pass a fresh directory for a fresh run.
"""
import argparse

from repro_torch.configs.base import get_config, register
from repro_torch.launch import train as train_cli


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--policy", default="mxsf")
    ap.add_argument("--ckpt-dir", default="build/train_lm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.small:
        arch = "h2o-danube-1.8b-reduced"
    else:
        base = get_config("h2o-danube-1.8b")
        register(base.replace(name="danube-100m", n_layers=12, d_model=512,
                              n_heads=8, n_kv=4, d_head=64, d_ff=1408,
                              vocab=32000, swa_window=256))
        arch = "danube-100m"

    train_cli.main([
        "--arch", arch,
        "--steps", str(args.steps),
        "--batch", "8" if not args.small else "4",
        "--seq", "256" if not args.small else "64",
        "--policy", args.policy,
        "--block-mode", "2d",
        "--remat", "dots",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "100",
        "--metrics-out", f"{args.ckpt_dir}/metrics.json",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
