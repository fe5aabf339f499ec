"""What each gloo rank runs in ``test_torch_families_train_sharded.py`` (a
module of its own, without JAX: every rank imports it).

The reduced SSM, hybrid, encoder-decoder and encoder configs in float32
at small depth, widened where the SSD must split: mamba2-780m (2 layers)
and zamba2-7b (2 groups of 2 SSD layers with the shared block, and a
tail layer) at ``d_model`` 128, so d_inner is 256 and the 16 SSD heads
split into 8 a rank -- whole 8x8 tiles, which the 2D training plan needs
(``blocks.tp_plan``) -- where ``reduced()``'s 8 heads would not;
whisper-medium at 2 + 2 layers over 32 frames; deit-tiny at 2 layers.
Each case builds the train state one device would draw (or converts the
one it is handed), keeps this rank's slices, takes its batch rows and
runs the sharded gradient function or train step, optionally with one of
the plumbing faults a negative control plants (``FAULTS``); it returns
plain data (``torch_train_ranks.case``'s, plus the TP plan).
"""
import contextlib
import sys

import numpy as np
import torch

import torch_train_ranks as TR
from repro_torch.configs.base import get_config
from repro_torch.core import sharding as shd
from repro_torch.core.policy import BF16, MXSF_TRAIN
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import blocks, ssd
from repro_torch.models import transformer as TM
from repro_torch.train import step as T

MAMBA, ZAMBA, WHISPER, DEIT = ("mamba2-780m", "zamba2-7b", "whisper-medium",
                               "deit-tiny")
ARCHS = (MAMBA, ZAMBA, WHISPER, DEIT)
ARCH_KW = {MAMBA: dict(n_layers=2, d_model=128),
           ZAMBA: dict(n_layers=5, hybrid_attn_every=2, d_model=128),
           WHISPER: dict(n_layers=2, n_enc_layers=2),
           DEIT: dict(n_layers=2)}
SEQ, BATCH = TR.SEQ, TR.BATCH
# the unquantized policy (the exact plumbing check), 2D MXSF_TRAIN, and
# the 1D layout at 64-element blocks, whose gradient blocks along N do not
# fit 8 local heads: the SSD stays replicated over the model axis
POLICIES = {"f32": BF16,
            "2d": MXSF_TRAIN.replace(backend="cuda"),
            "1d": MXSF_TRAIN.replace(backend="cuda", block_mode="1d",
                                     block_1d=64, quantize_bwd=True)}
OCFG = TR.OCFG


def config(arch, **kw):
    return get_config(arch).reduced().replace(
        compute_dtype="float32", **dict(ARCH_KW[arch], **kw))


def batch_of(cfg, seed=0, batch=BATCH):
    """A global batch of ``cfg``'s family from a seeded numpy generator:
    tokens and labels (and whisper's frames), or deit's patch embeddings
    and class labels -- the same arrays for both packages."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encoder":
        out = {"embeds": rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32),
               "label": rng.integers(0, cfg.n_classes, batch,
                                     dtype=np.int32)}
    else:
        out = {k: rng.integers(0, cfg.vocab, (batch, SEQ), dtype=np.int32)
               for k in ("tokens", "labels")}
        if cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def torch_batch(cfg, seed=0):
    return {k: torch.from_numpy(v) for k, v in batch_of(cfg, seed).items()}


# ---------------------------------------------------------------------------
# the plumbing faults a negative control plants (each the code before the
# split SSD and the encoder's head learned their adjoints)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _norm_identity():
    """The gated norm's all-reduce of squares with the identity adjoint
    (a replicated consumer's)."""
    all_reduce = shd.all_reduce

    def faulty(x, axis=None, mesh=None, adjoint=None):
        return all_reduce(x, axis, mesh,
                          "identity" if adjoint == "all_reduce" else adjoint)

    return _patched(shd, "all_reduce", faulty)


def _segments_narrow():
    """in_proj, conv_w and conv_b gathered with the narrowing adjoint (a
    replicated consumer's)."""
    use = blocks.use

    def faulty(p, name, split=None, key=None, consumer="replicated"):
        return use(p, name, split, key)

    return _patched(blocks, "use", faulty)


def _heads_narrowed():
    """A_log, D and dt_bias narrowed to the rank's heads (no gather of
    their gradient slices)."""

    def faulty(p, name):
        t = blocks.use(p, name)
        tp = ssd._tp()
        if tp is None:
            return t
        n = t.shape[-1] // tp[2]
        return t.narrow(-1, tp[1] * n, n)

    return _patched(ssd, "_use_heads", faulty)


def _no_ssd_entry():
    """The SSD's input fed to the column-parallel in_proj without entering
    the split."""
    entered = blocks.entered_dense

    def faulty(x, w, policy):
        if sys._getframe(1).f_code is ssd.ssd_forward.__code__:
            return blocks.dense(x, w, policy)
        return entered(x, w, policy)

    return _patched(blocks, "entered_dense", faulty)


def _head_raw():
    """The encoder's head read as the rank stores it (its slice of the
    classes), not brought to its compute layout."""
    use = blocks.use

    def faulty(p, name, *args, **kw):
        return p[name] if name == "head" else use(p, name, *args, **kw)

    return _patched(blocks, "use", faulty)


FAULTS = {"norm_identity": _norm_identity, "segments_narrow":
          _segments_narrow, "heads_narrowed": _heads_narrowed,
          "no_ssd_entry": _no_ssd_entry, "head_raw": _head_raw}


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def case(rank, kind, shape, arch, policy="f32", ocfg=None, np_state=None,
         batch=None, step=False, fault=None, **kw):
    """One case on a ``shape`` mesh: the gradient function (``step``
    False) or one train step, ``fault`` planted (``FAULTS``; then the
    rank's forward logits too).  Returns the loss, gradient or updated
    state slices (moments too), the grad norm, the collectives, the
    state's bytes and ``MeshRules.shard_nbytes`` of it, the TP plan and
    this rank's coordinates."""
    cfg = config(arch, **kw)
    mesh = TR._mesh(shape)
    ocfg = ocfg or OCFG
    pol = POLICIES[policy]
    state, sh = TR._state(cfg, ocfg, mesh, np_state=np_state)
    rows = T.batch_rows(batch if batch is not None else torch_batch(cfg),
                        mesh)
    shd.reset_counts()
    out = dict(kind=kind, coords={a: mesh.coord(a) for a in mesh.shape})
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        if step:
            fn = T.make_train_step(cfg, pol, ocfg, T.TrainConfig(), mesh)
            state, metrics = fn(state, rows)
            out.update(state=TR.numpy_tree(state["params"]),
                       m=TR.numpy_tree(state["opt"]["m"]),
                       v=TR.numpy_tree(state["opt"]["v"]),
                       grad_norm=float(metrics["grad_norm"]))
        elif fault == "head_raw":  # the rank's logits (the step raises)
            fn = T.make_grad_fn(cfg, pol, T.TrainConfig(), mesh)
            with torch.no_grad(), fn.layout.hints():
                out["logits"] = TM.forward(state["params"], rows, cfg,
                                           pol).numpy()
            metrics = {"loss": float("nan")}
        else:
            fn = T.make_grad_fn(cfg, pol, T.TrainConfig(), mesh)
            metrics, grads = fn(state["params"], rows)
            out["grads"] = TR.numpy_tree(grads)
    out.update(loss=float(metrics["loss"]), collectives=TR.collectives(),
               plan=fn.layout.plan._asdict(),
               state_bytes=sum(t.numel() * t.element_size()
                               for _, t in T._flatten(state)),
               shard_nbytes=mesh_lib.MeshRules(mesh).shard_nbytes(
                   T.init_state(torch.Generator(), cfg, ocfg,
                                device="meta"), sh))
    return out


def run(rank, todo):
    """Each ``(function name, args, kwargs)`` of ``todo`` in order (every
    rank runs every item); their results."""
    return [{"case": case}[name](rank, *args, **kw)
            for name, args, kw in todo]
