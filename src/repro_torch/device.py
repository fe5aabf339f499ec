"""Where the port's entry points run: the card unless the caller asks for
the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; raises when CUDA is absent (no CPU fallback)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run on "
                               "the CPU")
        device = "cuda"
    return torch.device(device)
