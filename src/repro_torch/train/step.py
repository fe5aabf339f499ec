"""Loss + train-step factory: remat, microbatch gradient accumulation,
AdamW, optional MXSF gradient compression (beyond-paper).

PyTorch counterpart of the JAX package's ``train/step.py``, every family
(a VLM's loss runs over its text positions only).  ``make_train_step`` returns ``train_step(state, batch)
-> (state, metrics)``; the state is updated in place (``optim/adamw.py``).
Gradients come from ``torch.autograd.grad`` over detached copies of the
parameter leaves, so the state itself never carries ``.grad`` buffers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..core import blocking as B
from ..core.packed_store import tree_map
from ..core.policy import QuantPolicy
from ..device import resolve_device
from ..models import model as M
from ..models import transformer as T
from ..optim import adamw

__all__ = ["TrainConfig", "loss_fn", "make_train_step", "make_serve_step",
           "init_state"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    remat: str = "dots"            # 'none' | 'dots' | 'full'
    microbatches: int = 1          # gradient accumulation
    grad_compress: Optional[str] = None  # e.g. 'mxsf' -- quantize grads
    grad_compress_block: int = 64
    xent_chunk: int = 1024         # sequence-chunked loss: never materialize
                                   # full (B, S, V) logits; 0 disables

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _xent_sums(logits, labels, vocab: int, ignore=-100):
    """(sum nll, sum mask) in f32.  Padded-vocab columns are masked out."""
    logits = logits.float()
    if logits.shape[-1] != vocab:
        dead = torch.arange(logits.shape[-1], device=logits.device) >= vocab
        logits = logits + torch.where(dead, -1e30, 0.0)
    logz = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = logz - gold
    mask = (labels != ignore).float()
    return torch.sum(nll * mask), torch.sum(mask)


def _xent(logits, labels, vocab: int, ignore=-100):
    s, n = _xent_sums(logits, labels, vocab, ignore)
    return s / torch.clamp(n, min=1.0)


def _chunked_lm_loss(params, hidden, labels, cfg: ModelConfig,
                     policy: QuantPolicy, chunk: int):
    """Head matmul + xent over sequence chunks -- the full (B, S, V) logits
    tensor never exists at once."""
    S = hidden.shape[1]
    if chunk <= 0 or S <= chunk or S % chunk:
        return _xent(T.lm_head(params, hidden, cfg, policy), labels,
                     cfg.vocab)
    s = m = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        sc, mc = _xent_sums(T.lm_head(params, hidden[:, c0:c0 + chunk], cfg,
                                      policy), labels[:, c0:c0 + chunk],
                            cfg.vocab)
        s, m = s + sc, m + mc
    return s / torch.clamp(m, min=1.0)


def loss_fn(params, batch, cfg: ModelConfig, policy: QuantPolicy,
            tcfg: TrainConfig):
    """(loss, metrics): the encoder's softmax cross-entropy over its
    classes with ``acc``, else the LM loss (a VLM's over its text
    positions, after the ``embeds`` prefix)."""
    if cfg.family == "encoder":
        logits = T.forward(params, batch, cfg, policy, remat=tcfg.remat)
        label = batch["label"].long()
        onehot = torch.nn.functional.one_hot(label, cfg.n_classes)
        loss = -torch.mean(torch.sum(
            torch.log_softmax(logits, dim=-1) * onehot, dim=-1))
        acc = torch.mean((torch.argmax(logits, dim=-1) == label).float())
        return loss, {"loss": loss, "acc": acc}
    hidden = T.forward_hidden(params, batch, cfg, policy, remat=tcfg.remat)
    if cfg.frontend_tokens and "embeds" in batch:
        hidden = hidden[:, cfg.frontend_tokens:]  # loss over text positions
    loss = _chunked_lm_loss(params, hidden, batch["labels"], cfg, policy,
                            tcfg.xent_chunk)
    return loss, {"loss": loss}


def _compress_grads(grads, tcfg: TrainConfig):
    """Quantize gradients to an MX format (emulates an 8-bit data-parallel
    all-reduce wire format)."""
    if not tcfg.grad_compress:
        return grads
    blk = (tcfg.grad_compress_block,)

    def q(g):
        if g.ndim == 0 or g.shape[-1] < 2:
            return g
        return B.qdq(g, tcfg.grad_compress, blk)

    return tree_map(q, grads)


def init_state(generator: torch.Generator, cfg: ModelConfig,
               ocfg: adamw.OptConfig, param_dtype: str = "float32",
               device=None):
    """Parameters from ``generator`` (``models.transformer.init_params``)
    and the AdamW state, on ``device``: ``None`` means the card and raises
    when CUDA is absent; the generator must live on the same device."""
    params = T.init_params(cfg, generator, resolve_device(device))
    if param_dtype != "float32":
        # bf16 stored params; f32 masters live in the opt state
        opt = adamw.init_opt_state(params, ocfg.replace(master_weights=True))
        dt = getattr(torch, param_dtype)
        return {"params": tree_map(lambda p: p.to(dt), params),
                "opt": opt}
    return {"params": params, "opt": adamw.init_opt_state(params, ocfg)}


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def _unflatten(pairs):
    out: dict = {}
    for path, leaf in pairs:
        T.set_path(out, path, leaf)
    return out


def make_train_step(cfg: ModelConfig, policy: QuantPolicy,
                    ocfg: adamw.OptConfig, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  The step
    updates ``state``'s tensors in place and returns the same dicts."""

    def grads_of(params, batch):
        pairs = _flatten(params)
        leaves = [leaf.detach().requires_grad_() for _, leaf in pairs]
        tree = _unflatten((p, leaf) for (p, _), leaf in zip(pairs, leaves))
        loss, aux = loss_fn(tree, batch, cfg, policy, tcfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(leaf) if g is None else g
                 for leaf, g in zip(leaves, grads)]
        aux = {k: v.detach() for k, v in aux.items()}
        return loss.detach(), aux, _unflatten(
            (p, g) for (p, _), g in zip(pairs, grads))

    def train_step(state, batch):
        params = state["params"]
        if tcfg.microbatches > 1:
            n = tcfg.microbatches
            grads = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            loss_sum = 0.0
            for i in range(n):
                mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, _, g = grads_of(params, mb)
                g = _compress_grads(g, tcfg)
                loss_sum = loss_sum + loss
                grads = tree_map(torch.add, grads, g)
                del g
            grads = tree_map(lambda g: g / n, grads)
            metrics = {"loss": loss_sum / n}
        else:
            _, metrics, grads = grads_of(params, batch)
            grads = _compress_grads(grads, tcfg)
        _, opt, opt_metrics = adamw.apply_updates(params, grads, state["opt"],
                                                  ocfg)
        del grads
        return {"params": params, "opt": opt}, dict(metrics, **opt_metrics)

    return train_step


def make_serve_step(cfg: ModelConfig, policy: QuantPolicy):
    """Returns serve_step(params, tokens, cache, pos) -> (logits, cache)."""

    def serve_step(params, tokens, cache, pos):
        return M.decode_step(params, tokens, cache, pos, cfg, policy)

    return serve_step
