"""Quickstart on the PyTorch/CUDA port: the MXSF format in five minutes.

    PYTHONPATH=src python examples/torch_quickstart.py               # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The port's counterpart of ``examples/quickstart.py``.  The matmuls take
the kernel datapath (``backend="cuda"``): the hand-written CUDA kernels on
the card, their plain PyTorch versions on CPU tensors.
"""
import argparse

import torch

from repro_torch.core import blocking as B
from repro_torch.core.mx_dot import mx_dot
from repro_torch.core.policy import MXSF_INFER, MXSF_TRAIN
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu', or the card (the default)")
    device = resolve_device(ap.parse_args(argv).device)

    # --- 1. the format itself: one byte, two regimes ---------------------
    x = torch.tensor([1.5, 0.8, 0.02, 0.0003], device=device)  # one block
    qt = B.quantize(x[None, :], "mxsf", (4,))
    print("codes      :", [f"{c:08b}" for c in qt.codes[0].tolist()])
    print("shared exp :", int(qt.scale_e8m0[0, 0]) - 127)
    print("decoded    :", B.dequantize(qt)[0].tolist())
    # 1.5, 0.8 use the E2M5 regime (gap < 3); 0.02, 0.0003 fall into the
    # repurposed-subnormal E3M2 regime and survive where plain E2M5
    # underflows:
    print("plain E2M5 :", B.qdq(x[None, :], "mxfp8_e2m5", (4,))[0].tolist())

    # --- 2. a quantized matmul with the training policy ------------------
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((128, 256), generator=gen, device=device)
    w = torch.randn((256, 64), generator=gen, device=device)
    train = MXSF_TRAIN.replace(backend="cuda")   # 8x8 tiles
    infer = MXSF_INFER.replace(backend="cuda")   # 1x64 row blocks
    ref = a @ w
    for name, pol in (("train tiles", train), ("inference rows", infer)):
        err = (mx_dot(a, w, pol) - ref).abs().max() / ref.abs().max()
        print(f"matmul rel err ({name}):", float(err))

    # --- 3. gradients flow through the quantized graph -------------------
    wg = w.clone().requires_grad_()
    (g,) = torch.autograd.grad((mx_dot(a, wg, train) ** 2).sum(), wg)
    print("grad finite:", bool(torch.isfinite(g).all()), "| shape",
          tuple(g.shape))

    # --- 4. storage: packed MXSF is ~3.9x smaller than f32 ---------------
    qt = B.quantize(a, "mxsf", (8, 8))
    print("packed bytes:", qt.nbytes_packed(), "vs f32:", a.numel() * 4)


if __name__ == "__main__":
    main()
