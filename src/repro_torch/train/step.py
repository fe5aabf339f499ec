"""Loss + train-step factory: remat, microbatch gradient accumulation,
AdamW, optional MXSF gradient compression (beyond-paper).

PyTorch counterpart of the JAX package's ``train/step.py``, every family
(a VLM's loss runs over its text positions only).  ``make_train_step``
returns ``train_step(state, batch) -> (state, metrics)``; the state is
updated in place (``optim/adamw.py``).  Gradients come from
``torch.autograd.grad`` over detached copies of the parameter leaves, so
the state itself never carries ``.grad`` buffers.

On a mesh (``mesh=``, one process per device on ``torch.distributed``)
the step computes what the JAX package's step jitted under
``state_shardings`` / ``batch_shardings`` computes with GSPMD, for every
family -- the decoders, dense and MoE, the SSM, the hybrid, the
encoder-decoder and the encoder: each rank holds its slices of the state
under the JAX rules (``init_state(shardings=)``; an uneven expert split's
padded rows are zeros, and stay zeros), takes its rows of the batch
(``batch_rows``), gathers each FSDP leaf at use and reduce-scatters its
gradient, splits heads, FFN, vocab and the SSD heads over the model axis
by the serving path's ``blocks.TPPlan`` (built for training) and runs its
own experts (routing and dispatch replicated, the experts' outputs
gathered, the gradient of their inputs gathered back), sums the loss
over the DP axes (the global batch's mean), all-reduces over the DP axes
the gradients of the leaves the DP axes do not split, and runs AdamW on
its slices, the clip's norm summed over the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..core import blocking as B
from ..core.packed_store import tree_map
from ..core import sharding as shd
from ..core.policy import QuantPolicy
from ..device import resolve_device
from ..launch import mesh as mesh_lib
from ..models import blocks as blk
from ..models import model as M
from ..models import transformer as T
from ..optim import adamw

__all__ = ["TrainConfig", "loss_fn", "make_grad_fn", "make_train_step",
           "make_serve_step", "init_state", "state_shardings", "batch_rows"]


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


def _over_dp(*sums):
    """Scalar sums (nll, labels, ...) over the DP axes of the active mesh
    context: one all-reduce of them all per DP axis of size > 1, whose
    consumer (the loss) is replicated, so each rank's addend takes the
    loss's gradient as it is.  Outside a context, or on one DP rank, the
    sums themselves."""
    ctx = shd.active()
    axes = () if ctx is None else tuple(
        a for a in ctx["dp"] if ctx["mesh"].shape[a] > 1)
    if not axes:
        return sums
    both = torch.stack(sums)
    for axis in axes:
        both = shd.all_reduce(both, axis, adjoint="identity")
    return tuple(both.unbind())


def _chunked_lm_loss(params, hidden, labels, cfg: ModelConfig,
                     policy: QuantPolicy, chunk: int):
    """Head matmul + xent over sequence chunks -- the full (B, S, V) logits
    tensor never exists at once.  On a mesh the sums run over the DP
    axes: the global batch's mean."""
    S = hidden.shape[1]
    if chunk <= 0 or S <= chunk or S % chunk:
        s, m = _xent_sums(T.lm_head(params, hidden, cfg, policy), labels,
                          cfg.vocab)
    else:
        s = m = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c0 in range(0, S, chunk):
            sc, mc = _xent_sums(T.lm_head(params, hidden[:, c0:c0 + chunk],
                                          cfg, policy),
                                labels[:, c0:c0 + chunk], cfg.vocab)
            s, m = s + sc, m + mc
    s, m = _over_dp(s, m)
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
        gold = torch.sum(torch.log_softmax(logits, dim=-1) * onehot, dim=-1)
        hit = (torch.argmax(logits, dim=-1) == label).float()
        # the global batch's means (on a mesh each DP rank holds its rows)
        s, h, n = _over_dp(-gold.sum(), hit.sum(),
                           gold.new_tensor(float(gold.shape[0])))
        loss = s / n
        return loss, {"loss": loss, "acc": h / n}
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
               device=None, shardings=None):
    """Parameters from ``generator`` (``models.transformer.init_params``)
    and the AdamW state, on ``device``: ``None`` means the card and raises
    when CUDA is absent; the generator must live on the same device.
    ``shardings`` (``state_shardings``): this rank's slices of the state
    one device would draw -- each parameter drawn whole and sliced, the
    moments, master weights and bf16 parameters made from the slices."""
    params = T.init_params(cfg, generator, resolve_device(device),
                           None if shardings is None
                           else shardings["params"])
    if param_dtype != "float32":
        # bf16 stored params; f32 masters live in the opt state
        opt = adamw.init_opt_state(params, ocfg.replace(master_weights=True))
        dt = getattr(torch, param_dtype)
        return {"params": tree_map(lambda p: p.to(dt), params),
                "opt": opt}
    return {"params": params, "opt": adamw.init_opt_state(params, ocfg)}


def state_shardings(cfg: ModelConfig, ocfg: adamw.OptConfig, mesh,
                    param_dtype: str = "float32"):
    """The train state's NamedSharding tree on ``mesh`` under the JAX
    rules (``launch/mesh.state_shardings``: the moments and master
    weights follow the parameters)."""
    meta = init_state(torch.Generator(), cfg, ocfg, param_dtype,
                      device="meta")
    return mesh_lib.state_shardings(mesh_lib.MeshRules(mesh), meta)


def batch_rows(batch, mesh):
    """This rank's rows of a global batch on ``mesh`` under
    ``launch/mesh.batch_shardings`` (dim 0 over the DP axes where it
    divides): what the sharded step takes, as views."""
    sh = mesh_lib.batch_shardings(mesh_lib.MeshRules(mesh), batch)
    return {k: v[shd.shard_slices(v.shape, sh[k].spec, mesh)]
            for k, v in batch.items()}


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


class _MeshLayout:
    """What a sharded step needs of its mesh: the rules, the parameters'
    shardings (whole shapes from ``meta``), each leaf's stored spec by name
    and the training TP plan (the ``mesh_context`` the model code reads),
    and the DP axes of size > 1."""

    def __init__(self, cfg: ModelConfig, policy: QuantPolicy, mesh):
        self.mesh, self.rules = mesh, mesh_lib.MeshRules(mesh)
        whole = T.init_params(cfg, torch.Generator(), "meta")
        self.param_sh = self.rules.param_sharding_tree(whole)
        self.specs = mesh_lib.specs_by_name(whole, self.param_sh)
        self.plan = blk.tp_plan(cfg, policy, whole, self.rules.tp_size,
                                train=True)
        self.dp = tuple(a for a in self.rules.dp if mesh.shape[a] > 1)

    def hints(self):
        return shd.mesh_context(self.mesh, self.rules.dp, self.rules.tp,
                                specs=self.specs, plan=self.plan)

    def reduce(self, grads):
        """All-reduce over each DP axis of size > 1 the gradient of every
        leaf whose spec does not split that axis (an FSDP leaf's was
        reduce-scattered by its gather's adjoint)."""

        def one(g, ns):
            for axis in self.dp:
                if axis not in shd.split_axes(ns.spec):
                    g = shd.all_reduce(g, axis, self.mesh)
            return g

        return tree_map(one, grads, self.param_sh)


def make_grad_fn(cfg: ModelConfig, policy: QuantPolicy, tcfg: TrainConfig,
                 mesh=None):
    """Returns ``grad_fn(params, batch) -> (metrics, grads)``: the loss
    metrics and the gradients AdamW takes (the microbatches' mean, each
    compressed where ``grad_compress`` asks).

    On ``mesh`` the params are this rank's slices and the batch its rows
    (``batch_rows``); the loss is the global batch's and each rank's
    gradients are its slices of one device's.  Microbatch i on a rank is
    its rows of the step's i-th share (its own rows split into
    ``microbatches`` parts): the union over the ranks is another partition
    of the batch than the JAX package's i-th share of the global rows, and
    gives its loss and gradients wherever every microbatch holds the same
    number of labels, which ``lm_batch`` guarantees (every label valid).
    The leaves the DP axes do not split are all-reduced over them once a
    step, after the microbatches, or per microbatch under
    ``grad_compress``, which quantizes each microbatch's reduced
    gradients as the JAX package does."""
    layout = None if mesh is None else _MeshLayout(cfg, policy, mesh)

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

    def reduced(g, last: bool):
        if layout is not None and (tcfg.grad_compress or last):
            g = layout.reduce(g)
        return _compress_grads(g, tcfg)

    def grad_fn(params, batch):
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
                g = reduced(g, last=False)
                loss_sum = loss_sum + loss
                grads = tree_map(torch.add, grads, g)
                del g
            if layout is not None and not tcfg.grad_compress:
                grads = layout.reduce(grads)
            grads = tree_map(lambda g: g / n, grads)
            return {"loss": loss_sum / n}, grads
        _, metrics, grads = grads_of(params, batch)
        return metrics, reduced(grads, last=True)

    if layout is None:
        return grad_fn

    def sharded(params, batch):
        with layout.hints():
            return grad_fn(params, batch)

    sharded.layout = layout
    return sharded


def make_train_step(cfg: ModelConfig, policy: QuantPolicy,
                    ocfg: adamw.OptConfig, tcfg: TrainConfig, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  The step
    updates ``state``'s tensors in place and returns the same dicts.  On
    ``mesh`` (a mesh over a process group, or a tracing mesh on ``meta``
    tensors): the state holds this rank's slices (``init_state(
    shardings=state_shardings(...))``) and the batch is this rank's rows
    (``batch_rows``); see ``make_grad_fn``."""
    grad_fn = make_grad_fn(cfg, policy, tcfg, mesh)
    param_sh = None if mesh is None else grad_fn.layout.param_sh

    def train_step(state, batch):
        params = state["params"]
        metrics, grads = grad_fn(params, batch)
        _, opt, opt_metrics = adamw.apply_updates(params, grads, state["opt"],
                                                  ocfg, param_sh)
        del grads
        return {"params": params, "opt": opt}, dict(metrics, **opt_metrics)

    if mesh is not None:
        train_step.layout = grad_fn.layout
    return train_step


def make_serve_step(cfg: ModelConfig, policy: QuantPolicy):
    """Returns serve_step(params, tokens, cache, pos) -> (logits, cache)."""

    def serve_step(params, tokens, cache, pos):
        return M.decode_step(params, tokens, cache, pos, cfg, policy)

    return serve_step
