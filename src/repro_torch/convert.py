"""Carry weights from the JAX package across, through numpy.

``params_from_numpy(tree, cfg, device)`` takes a JAX parameter tree whose
leaves were turned into numpy arrays (``jax.tree.map(np.asarray, params)``,
done by the caller; this module imports nothing of JAX).  The tree keeps the
JAX layout -- each stack of ``models.transformer.stacks`` on its leading
axes (a decoder's ``(n_super, ...)`` with ``sub{j}`` keys, a hybrid's
``(groups, per, ...)`` SSM layers, ...) -- which is the port's layout too,
so leaves map one to one.  A packed
leaf (any object with ``codes``, ``scale_e8m0``, ``fmt``, ``block``,
``shape`` and ``dtype``) goes through ``qt_from_numpy``.  After conversion
both packages compute the same function; MoE routers and expert stacks
(``router``, ``we_*``) stay values and a shared expert's MLP (``shared``)
maps like any other.  ``train_state_from_numpy`` carries a JAX train state
(``{"params", "opt": {"m", "v", "step"}}``, and ``"master"`` where the JAX
state has it) across the same way, and ``cache_from_numpy`` a cache of
any family (KV values or packed codes and scales, SSM states, cross K/V).
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.blocking import QuantizedTensor
from .core.packed_store import tree_leaves
from .models.transformer import stacks

__all__ = ["tensor_from_numpy", "qt_from_numpy", "params_from_numpy",
           "train_state_from_numpy", "cache_from_numpy"]


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """numpy array (bfloat16 included, via float32) -> torch tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def qt_from_numpy(codes, scales, fmt: str, block, shape, dtype,
                  device="cpu") -> QuantizedTensor:
    """A packed ``QuantizedTensor`` from numpy codes and E8M0 scales."""
    return QuantizedTensor(tensor_from_numpy(codes, device),
                           tensor_from_numpy(scales, device), str(fmt),
                           tuple(int(b) for b in block),
                           tuple(int(d) for d in shape), str(dtype))


def _is_packed(leaf) -> bool:
    return all(hasattr(leaf, a) for a in ("codes", "scale_e8m0", "fmt",
                                          "block", "shape", "dtype"))


def params_from_numpy(tree, cfg: ModelConfig, device="cpu"):
    """The JAX parameter tree (numpy leaves) as the port's tree."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if _is_packed(node):
            return qt_from_numpy(node.codes, node.scale_e8m0, node.fmt,
                                 node.block, node.shape, node.dtype, device)
        return tensor_from_numpy(node, device)

    out = walk(tree)
    for name, lead, _ in stacks(cfg):
        for leaf in tree_leaves(out.get(name, {})):
            got = tuple((leaf.codes if isinstance(leaf, QuantizedTensor)
                         else leaf).shape[:len(lead)])
            if got != lead:
                fmt = lambda dims: ", ".join(map(str, dims))
                raise ValueError(f"{name} leaf has leading dim {fmt(got)}, "
                                 f"expected {fmt(lead)} for {cfg.name}")
    return out


def train_state_from_numpy(state, cfg: ModelConfig, device="cpu"):
    """The JAX package's train state (numpy leaves) as the port's: params
    and AdamW ``m``, ``v`` (and ``master``) in the parameter layout,
    ``step`` a 0-d int32 tensor."""
    opt = {k: params_from_numpy(state["opt"][k], cfg, device)
           for k in ("m", "v", "master") if k in state["opt"]}
    opt["step"] = torch.as_tensor(np.asarray(state["opt"]["step"]),
                                  dtype=torch.int32, device=device)
    return {"params": params_from_numpy(state["params"], cfg, device),
            "opt": opt}


def cache_from_numpy(cache, device="cpu"):
    """The JAX package's cache of any family (numpy leaves, nested dicts;
    bf16 values included) as the port's: the same keys, shapes and
    dtypes."""
    if isinstance(cache, dict):
        return {k: cache_from_numpy(v, device) for k, v in cache.items()}
    return tensor_from_numpy(cache, device)
