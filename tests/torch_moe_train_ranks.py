"""What each gloo rank runs in ``test_torch_moe_train_sharded.py`` (a module
of its own, without JAX: every rank imports it).

The reduced MoE configs in float32 at small depth: qwen2-moe-a2.7b with
12 live experts padded to 16 rows (top-2, one shared expert, MoE every
layer) and 4 kv heads, 2 layers; llama4-maverick (4 live experts of 16,
top-1, a shared expert, MoE every 2nd layer), 4 layers (two dense + MoE
pairs) under its ``ARCH_TRAIN_OVERRIDES`` (remat "full", bf16 moments;
microbatches 2 here, where the batch of 4 splits over two data ranks).
Each case builds the train state one device would draw (or converts the
one it is handed), keeps this rank's slices, takes its batch rows and
runs the sharded gradient function or train step; it returns plain data
(``torch_train_ranks.case``'s, plus the routing of every MoE layer).
"""
import torch

import chip_smoke as CS
import torch_train_ranks as TR
from repro_torch.configs.base import get_config
from repro_torch.core import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.train import step as T

QWEN, LLAMA = "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"
ARCH_KW = {QWEN: dict(n_experts=12, n_kv=4), LLAMA: {}}
LAYERS = {QWEN: 2, LLAMA: 4}
# llama4's train overrides (``dryrun.ARCH_TRAIN_OVERRIDES``), microbatches
# at 2: the global batch of 4 on two data ranks
TCFG = {QWEN: T.TrainConfig(),
        LLAMA: T.TrainConfig(remat="full", microbatches=2)}
OCFG = {QWEN: TR.OCFG, LLAMA: TR.OCFG.replace(moment_dtype="bfloat16")}
POLICIES = TR.POLICIES


def config(arch, layers=None, dtype="float32"):
    return get_config(arch).reduced().replace(
        n_layers=layers or LAYERS[arch], compute_dtype=dtype,
        **ARCH_KW[arch])


def batch_of(arch, seed=0):
    from repro_torch.data.pipeline import lm_batch
    toks, labs = lm_batch(seed, 0, TR.BATCH, TR.SEQ, config(arch).vocab,
                          device="cpu")
    return {"tokens": toks, "labels": labs}


def _indices(taps):
    """Every MoE layer's top-k expert indices ``chip_smoke.
    moe_train_taps`` recorded (the forward's layers, then a recompute's),
    as numpy."""
    return [t.numpy() for t in taps["topi"]]


def _state(cfg, ocfg, mesh, np_state=None, param_dtype="float32"):
    """(state slices, shardings), as ``torch_train_ranks._state`` draws
    or converts them."""
    sh = T.state_shardings(cfg, ocfg, mesh, param_dtype)
    if np_state is None:
        return T.init_state(torch.Generator().manual_seed(0), cfg, ocfg,
                            param_dtype, device="cpu", shardings=sh), sh
    from repro_torch import convert
    from repro_torch.serve.engine import place_store
    whole = convert.train_state_from_numpy(np_state, cfg)
    return place_store(whole, sh, mesh, "cpu"), sh


def case(rank, kind, shape, arch=QWEN, policy="f32", layers=None,
         ocfg=None, tcfg=None, np_state=None, batch=None, step=False,
         param_dtype="float32"):
    """One case on a ``shape`` mesh: the gradient function (``step``
    False) or one train step.  Returns the loss, gradient or updated
    state slices (moments too), the grad norm, the routing of each MoE
    layer, the collectives, the state's bytes and ``MeshRules.
    shard_nbytes`` of it, this rank's coordinates and, for the gradient
    function, its TP plan."""
    cfg = config(arch, layers)
    mesh = TR._mesh(shape)
    ocfg = ocfg or OCFG[arch]
    tcfg = tcfg or TCFG[arch]
    pol = POLICIES[policy]
    state, sh = _state(cfg, ocfg, mesh, np_state, param_dtype)
    rows = T.batch_rows(batch if batch is not None else batch_of(arch),
                        mesh)
    shd.reset_counts()
    out = dict(kind=kind, coords={a: mesh.coord(a) for a in mesh.shape})
    with CS.moe_train_taps(torch, -1) as taps:
        if step:
            state, metrics = T.make_train_step(cfg, pol, ocfg, tcfg,
                                               mesh)(state, rows)
            out.update(state=TR.numpy_tree(state["params"]),
                       m=TR.numpy_tree(state["opt"]["m"]),
                       v=TR.numpy_tree(state["opt"]["v"]),
                       master=(TR.numpy_tree(state["opt"]["master"])
                               if "master" in state["opt"] else None),
                       grad_norm=float(metrics["grad_norm"]))
        else:
            fn = T.make_grad_fn(cfg, pol, tcfg, mesh)
            out["tp_plan"] = fn.layout.plan._asdict()
            metrics, grads = fn(state["params"], rows)
            out["grads"] = TR.numpy_tree(grads)
    out.update(loss=float(metrics["loss"]), topi=_indices(taps),
               collectives=TR.collectives(),
               state_bytes=sum(t.numel() * t.element_size()
                               for _, t in T._flatten(state)),
               shard_nbytes=mesh_lib.MeshRules(mesh).shard_nbytes(
                   T.init_state(torch.Generator(), cfg, ocfg, param_dtype,
                                device="meta"), sh))
    return out


def one_device(arch=QWEN, policy="f32", layers=None, ocfg=None, tcfg=None,
               np_state=None, batch=None, step=False):
    """The port's one-device gradient function or step on the same state
    and batch as ``case``: the same keys, whole leaves."""
    cfg = config(arch, layers)
    ocfg = ocfg or OCFG[arch]
    tcfg = tcfg or TCFG[arch]
    if np_state is None:
        state = T.init_state(torch.Generator().manual_seed(0), cfg, ocfg,
                             device="cpu")
    else:
        from repro_torch import convert
        state = convert.train_state_from_numpy(np_state, cfg)
    batch = batch if batch is not None else batch_of(arch)
    out = {}
    with CS.moe_train_taps(torch, -1) as taps:
        if step:
            state, metrics = T.make_train_step(
                cfg, POLICIES[policy], ocfg, tcfg)(state, batch)
            out.update(state=TR.numpy_tree(state["params"]),
                       m=TR.numpy_tree(state["opt"]["m"]),
                       v=TR.numpy_tree(state["opt"]["v"]),
                       grad_norm=float(metrics["grad_norm"]))
        else:
            metrics, grads = T.make_grad_fn(cfg, POLICIES[policy], tcfg)(
                state["params"], batch)
            out["grads"] = TR.numpy_tree(grads)
    out.update(loss=float(metrics["loss"]), topi=_indices(taps))
    return out


def ckpt_save(rank, ckpt_dir):
    """A world of two: the state after one step on (1, 2), saved by
    ``ckpt.save(shardings=)``; this rank's slices (numpy, by path) and
    coordinates."""
    from repro_torch.ckpt import ckpt
    cfg = config(QWEN)
    mesh = TR._mesh((1, 2))
    state, sh = _state(cfg, OCFG[QWEN], mesh)
    state, _ = T.make_train_step(cfg, POLICIES["f32"], OCFG[QWEN],
                                 TCFG[QWEN], mesh)(
        state, T.batch_rows(batch_of(QWEN), mesh))
    ckpt.save(ckpt_dir, 1, state, shardings=sh)
    ckpt.wait_pending()
    return dict(state=TR.numpy_tree(state),
                coords={a: mesh.coord(a) for a in mesh.shape})


def ckpt_restore(rank, ckpt_dir):
    """A world of three: the checkpoint restored onto (1, 3), the uneven
    expert split, by ``ckpt.restore(shardings=)``: this rank's slices."""
    from repro_torch.ckpt import ckpt
    cfg = config(QWEN)
    mesh = TR._mesh((1, 3))
    sh = T.state_shardings(cfg, OCFG[QWEN], mesh)
    target = T.init_state(torch.Generator(), cfg, OCFG[QWEN], device="meta")
    got, step = ckpt.restore(ckpt_dir, target, device="cpu", shardings=sh)
    return dict(state=TR.numpy_tree(got), step=step,
                coords={a: mesh.coord(a) for a in mesh.shape})


def train_counts(rank, shape, policy="2d", seq=16, batch=4):
    """``torch_train_ranks.train_counts`` of the reduced qwen2-moe (the
    dry run's program on a ``shape`` mesh)."""
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.launch import cost, dryrun
    from torch_sharded_ranks import kernel_calls
    cfg = get_config(QWEN).reduced().replace(n_layers=LAYERS[QWEN],
                                              **ARCH_KW[QWEN])
    mesh = TR._mesh(shape)
    tcfg, ocfg = dryrun.cell_config(QWEN)
    state, _ = _state(cfg, ocfg, mesh)
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
    fns = {"case": case, "ckpt_save": ckpt_save,
           "ckpt_restore": ckpt_restore, "train_counts": train_counts}
    return [fns[name](rank, *args, **kw) for name, args, kw in todo]


def specs_by_path(cfg, ocfg, shape, tree="params"):
    """``{path: NamedSharding}`` of the state's shardings on an abstract
    mesh of ``shape`` (``tree``: "params", "opt/m" ..., or None: the
    whole state); the expert stacks' may split unevenly."""
    sh = T.state_shardings(cfg, ocfg, shd.AbstractMesh(shape,
                                                       ("data", "model")))
    for key in tree.split("/") if tree else ():
        sh = sh[key]
    return {"/".join(p): ns for p, ns in T._flatten(sh)}


def slices(whole: dict, shape, coords, sh_by_path) -> dict:
    """The slices of one-device leaves (numpy, by path) a rank at
    ``coords`` of a ``shape`` mesh holds, the zero rows an uneven split
    pads included."""
    from repro_torch.core import packed_store
    mesh = shd.Mesh(dict(zip(("data", "model"), shape)), coords=coords)
    return {k: packed_store.shard_leaf(
        torch.from_numpy(v), sh_by_path[k].spec, mesh,
        shd.uneven_dims(sh_by_path[k])).numpy() for k, v in whole.items()}
