"""What each gloo rank runs in ``test_torch_train_sharded.py`` (a module of
its own, without JAX: every rank imports it).

Each case builds the train state one device would draw (or converts the
one it is handed, numpy leaves), keeps this rank's slices under the JAX
rules (``train.step.state_shardings``), takes its rows of the batch and
runs the sharded gradient function or train step on a mesh of the world's
ranks; it returns plain data: the loss, the gradient or state slices
(numpy, by path), the collectives by kind and axis, the bytes held.
"""
import contextlib

import torch

from repro_torch import convert
from repro_torch.ckpt import ckpt
from repro_torch.configs.base import get_config
from repro_torch.core import sharding as shd
from repro_torch.core.policy import BF16, MXSF_TRAIN
from repro_torch.launch import cost
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import step as T

SEQ, BATCH, LAYERS = 32, 4, 2
ARCHS = ("h2o-danube-1.8b", "gemma2-2b")
# the policies: unquantized f32 (the exact plumbing check) and the two
# MX layouts at 16-element 1D blocks, so the reduced widths split
POLICIES = {"f32": BF16,
            "2d": MXSF_TRAIN.replace(backend="cuda"),
            "1d": MXSF_TRAIN.replace(backend="cuda", block_mode="1d",
                                     block_1d=16, quantize_bwd=True)}
OCFG = OptConfig(warmup_steps=2, total_steps=10)


def config(arch, dtype="float32", **kw):
    return get_config(arch).reduced().replace(
        n_layers=LAYERS, compute_dtype=dtype, **kw)


def batch_of(arch, seed=0, batch=BATCH):
    """A global batch from the port's ``lm_batch`` on the CPU."""
    from repro_torch.data.pipeline import lm_batch
    toks, labs = lm_batch(seed, 0, batch, SEQ, config(arch).vocab,
                          device="cpu")
    return {"tokens": toks, "labels": labs}


def numpy_tree(tree):
    """A tree's leaves as ``{path: float32 numpy}``."""
    return {"/".join(p): v.detach().float().numpy()
            for p, v in T._flatten(tree)}


def collectives(counts=None):
    """``sharding.counts()`` by kind and axis: ``{kind: {axis: calls}}``."""
    return {kind: {a: v[0] for a, v in by.items()}
            for kind, by in cost.collectives_by_axis(
                counts or shd.counts()).items()}


def _mesh(shape):
    return mesh_lib.make_mesh(shape, ("data", "model"))


def _state(cfg, ocfg, mesh, param_dtype="float32", np_state=None):
    """(state slices, shardings): drawn from seed 0 as one device draws
    them, or this rank's slices of ``np_state`` (numpy leaves)."""
    sh = T.state_shardings(cfg, ocfg, mesh, param_dtype)
    if np_state is None:
        gen = torch.Generator().manual_seed(0)
        return T.init_state(gen, cfg, ocfg, param_dtype, device="cpu",
                            shardings=sh), sh
    whole = convert.train_state_from_numpy(np_state, cfg)
    from repro_torch.serve.engine import place_store
    return place_store(whole, sh, mesh, "cpu"), sh


@contextlib.contextmanager
def kept_grads():
    """Inside the block, the gradients a train step hands AdamW (this
    rank's slices, numpy by path) land in the dict it yields."""
    got, apply = {}, adamw.apply_updates

    def keep(params, grads, *args, **kw):
        got.update(numpy_tree(grads))
        return apply(params, grads, *args, **kw)

    adamw.apply_updates = keep
    try:
        yield got
    finally:
        adamw.apply_updates = apply


def case(rank, kind, shape, arch="h2o-danube-1.8b", policy="f32",
         tk=None, ocfg=None, param_dtype="float32", np_state=None,
         batch=None, step=False, dtype="float32"):
    """One case on a ``shape`` mesh (activations in ``dtype``): the
    gradient function (``step`` False) or one train step.  Returns loss,
    gradient slices (a step's: those it hands AdamW), with ``step`` the
    updated state slices and grad norm, the collectives of the call, the
    state's bytes and ``MeshRules.shard_nbytes`` of it, and this rank's
    coordinates."""
    cfg = config(arch, dtype)
    mesh = _mesh(shape)
    ocfg = ocfg or OCFG
    tcfg = T.TrainConfig(**(tk or {}))
    pol = POLICIES[policy]
    state, sh = _state(cfg, ocfg, mesh, param_dtype, np_state)
    batch = batch if batch is not None else batch_of(arch)
    rows = T.batch_rows(batch, mesh)
    shd.reset_counts()
    out = dict(kind=kind, coords={a: mesh.coord(a) for a in mesh.shape})
    if step:
        fn = T.make_train_step(cfg, pol, ocfg, tcfg, mesh)
        out["tp_plan"] = fn.layout.plan._asdict()
        with kept_grads() as grads:
            state, metrics = fn(state, rows)
        out.update(grads=grads, state=numpy_tree(state["params"]),
                   m=numpy_tree(state["opt"]["m"]),
                   v=numpy_tree(state["opt"]["v"]),
                   master=(numpy_tree(state["opt"]["master"])
                           if "master" in state["opt"] else None),
                   step_count=int(state["opt"]["step"]),
                   grad_norm=float(metrics["grad_norm"]))
    else:
        fn = T.make_grad_fn(cfg, pol, tcfg, mesh)
        out["tp_plan"] = fn.layout.plan._asdict()
        metrics, grads = fn(state["params"], rows)
        out["grads"] = numpy_tree(grads)
    out.update(loss=float(metrics["loss"]), collectives=collectives(),
               state_bytes=sum(t.numel() * t.element_size()
                               for _, t in T._flatten(state)),
               shard_nbytes=mesh_lib.MeshRules(mesh).shard_nbytes(
                   T.init_state(torch.Generator(), cfg, ocfg, param_dtype,
                                device="meta"), sh))
    return out


def save_on(rank, shape, ckpt_dir, arch="h2o-danube-1.8b"):
    """A train state drawn on ``shape`` (after one step), saved gathered
    by ``ckpt.save(shardings=)``; returns the state's leaves (numpy,
    this rank's slices) for the restore to be held to."""
    cfg = config(arch)
    mesh = _mesh(shape)
    state, sh = _state(cfg, OCFG, mesh)
    fn = T.make_train_step(cfg, POLICIES["f32"], OCFG, T.TrainConfig(),
                           mesh)
    state, _ = fn(state, T.batch_rows(batch_of(arch), mesh))
    ckpt.save(ckpt_dir, 1, state, shardings=sh)
    ckpt.wait_pending()
    return numpy_tree(state)


def restore_on(rank, shape, ckpt_dir, arch="h2o-danube-1.8b"):
    """The checkpoint restored onto ``shape`` by ``ckpt.restore(
    shardings=)``: this rank's slices (numpy, by path), the step and this
    rank's coordinates."""
    cfg = config(arch)
    mesh = _mesh(shape)
    sh = T.state_shardings(cfg, OCFG, mesh)
    target = T.init_state(torch.Generator(), cfg, OCFG, device="meta")
    got, step = ckpt.restore(ckpt_dir, target, device="cpu", shardings=sh)
    return dict(state=numpy_tree(got), step=step,
                coords={a: mesh.coord(a) for a in mesh.shape},
                dtypes=sorted({str(t.dtype) for _, t in T._flatten(got)}))


def emulated(shape, arch="h2o-danube-1.8b", policy="f32", np_state=None,
             batch=None, step=False, dtype="float32", planted=()):
    """``case``'s program emulated on one device (``chip_smoke.
    emulate_train``: the ranks' calls at their shapes and their sums) at
    the test ranks' one thread, from the same state and batch: (the
    emulation's record, the whole state it updated with ``step``)."""
    import chip_smoke as CS
    cfg = config(arch, dtype)
    if np_state is None:
        state = T.init_state(torch.Generator().manual_seed(0), cfg, OCFG,
                             device="cpu")
    else:
        state = convert.train_state_from_numpy(np_state, cfg)
    with CS.rank_threads(torch, 1):
        emu = CS.emulate_train(
            torch, cfg, POLICIES[policy], T.TrainConfig(), OCFG, state,
            batch if batch is not None else batch_of(arch), shape, planted,
            step)
    return emu, state


def rank_slices(whole: dict, specs: dict, shape, coords) -> dict:
    """The slices of whole leaves (tensors by path) a rank at ``coords``
    of a ``shape`` mesh stores under ``specs`` (``chip_smoke.rank_cut``),
    as numpy."""
    import chip_smoke as CS
    sizes = dict(zip(CS.MESH_AXES, shape))
    return {k: CS.rank_cut(torch, v, specs[k], coords, sizes).numpy()
            for k, v in whole.items()}


def slices(whole: dict, shape, coords, sh_by_path) -> dict:
    """The slices of one-device leaves (numpy, by path) a rank at
    ``coords`` of a ``shape`` mesh holds under ``sh_by_path``."""
    mesh = shd.Mesh(dict(zip(("data", "model"), shape)), coords=coords)
    return {k: v[shd.shard_slices(v.shape, sh_by_path[k], mesh)]
            for k, v in whole.items()}


def specs_by_path(cfg, ocfg=None, shape=(1, 1), tree="params"):
    """``{path: spec}`` of the state's shardings on an abstract mesh of
    ``shape`` (``tree``: "params", "opt/m" ..., or None: the whole
    state)."""
    mesh = shd.AbstractMesh(shape, ("data", "model"))
    sh = T.state_shardings(cfg, ocfg or OCFG, mesh)
    for key in tree.split("/") if tree else ():
        sh = sh[key]
    return {"/".join(p): ns.spec for p, ns in T._flatten(sh)}


def ckpt_round(rank, ckpt_dir):
    """A world of two: the state saved on (2, 1) after one step, then
    restored onto (1, 2): (this rank's saved slices, what it restored)."""
    import torch.distributed as dist
    saved = save_on(rank, (2, 1), ckpt_dir)
    dist.barrier()
    return saved, restore_on(rank, (1, 2), ckpt_dir)


def train_counts(rank, shape, arch, policy, seq, batch):
    """One sharded train step of the dry run's program on a ``shape``
    mesh (``dryrun.cell_config``'s remat), from seeded inputs: each kernel
    wrapper's calls (on CPU tensors they run their plain versions; a call
    is where the card launches), the collectives by kind and axis with
    their operand bytes, and the bytes of the state slices and batch rows
    (the step's arguments)."""
    from repro_torch.launch import dryrun
    from torch_sharded_ranks import kernel_calls
    cfg = get_config(arch).reduced().replace(n_layers=LAYERS)
    mesh = _mesh(shape)
    tcfg, ocfg = dryrun.cell_config(arch)
    state, _ = _state(cfg, ocfg, mesh)
    from repro_torch.data.pipeline import lm_batch
    toks, labs = lm_batch(0, 0, batch, seq, cfg.vocab, device="cpu")
    rows = T.batch_rows({"tokens": toks, "labels": labs}, mesh)
    step = T.make_train_step(cfg, POLICIES[policy], ocfg, tcfg, mesh)
    arg = sum(t.numel() * t.element_size() for _, t in T._flatten(state))
    arg += sum(t.numel() * t.element_size() for t in rows.values())
    shd.reset_counts()
    with kernel_calls() as calls:
        step(state, rows)
    return dict(launches=dict(calls), argument_bytes=arg,
                collectives=cost.collectives_by_axis(shd.counts()))


def run(rank, todo):
    """Each ``(function name, args, kwargs)`` of ``todo`` in order (every
    rank runs every item); their results."""
    fns = {"case": case, "ckpt_round": ckpt_round,
           "train_counts": train_counts}
    return [fns[name](rank, *args, **kw) for name, args, kw in todo]
