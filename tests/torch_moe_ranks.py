"""What each gloo rank runs in ``test_torch_moe_sharded.py`` (a module of
its own, without JAX: every rank imports it).

The reduced MoE configs in float32 from the JAX package's weights
(numpy): qwen2-moe-a2.7b with 12 live experts padded to 16 (top-2, one
shared expert, MoE every layer) and 4 kv heads, multi-head as the full
config is (so a model axis of 4 splits the kv heads and attention stays
on the kernel), and llama4-maverick (4 live of 16, top-1, one shared
expert, MoE every 2nd layer).  Each function returns plain
data: token streams, logits (numpy), byte counts, the leaves that differ.
"""
import numpy as np
import torch

import torch_sharded_ranks as R
from repro_torch import convert
from repro_torch.configs.base import get_config as torch_config
from repro_torch.core import packed_store
from repro_torch.core import sharding as shd
from repro_torch.core.blocking import QuantizedTensor
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import blocks
from repro_torch.models import model as M
from repro_torch.models import transformer
from repro_torch.serve.engine import ServeEngine

POL = R.POL
# 20 cache columns: the JAX engine's attention kernel traces at other
# shapes than the dense serving tests' (16), whose trace counts assume
# their own compiles
KW = dict(R.KW, max_len=20)  # 20 % 3: (1, 3) keeps the cache whole
QWEN, LLAMA = "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"
ARCH_KW = {QWEN: dict(n_experts=12, n_kv=4), LLAMA: {}}
CAPACITY_SLOTS = 8  # decode rows of the data-axis routing check


def config(arch):
    return torch_config(arch).reduced().replace(compute_dtype="float32",
                                                **ARCH_KW[arch])


def parity(arch, np_params, prompts, shape):
    """The packed engine on a ``shape`` mesh: tokens, first logits, bytes
    held and predicted, the plan, the expert rows held."""
    cfg = config(arch)
    params = convert.params_from_numpy(np_params, cfg)
    eng, toks, first = R.serve(cfg, params, POL, prompts,
                               mesh_lib.make_test_mesh(*shape),
                               max_len=KW["max_len"])
    stats = eng.stats()
    rank = torch.distributed.get_rank()
    sub = f"sub{cfg.moe_every - 1}"
    return dict(tokens=toks, first=first.numpy(), plan=tuple(eng.tp_plan),
                attn_backend=eng.attn_backend,
                held=stats["store_nbytes_per_device"][f"rank{rank}:cpu"],
                predicted=eng.rules.shard_nbytes(
                    M.packed_model_specs(cfg, POL), eng._store_sh),
                expert_rows=eng.params["layers"][sub]["ffn"]["we_g"]
                .shape[1])


def _bad_leaves(got_tree, want_tree):
    """Paths of the leaves of ``got_tree`` that differ from ``want_tree``
    (codes, scales, logical shape or values)."""
    bad = []
    for (path, got), want in zip(_leaves(got_tree),
                                 packed_store.tree_leaves(want_tree)):
        if isinstance(got, QuantizedTensor):
            ok = (torch.equal(got.codes, want.codes)
                  and torch.equal(got.scale_e8m0, want.scale_e8m0)
                  and tuple(got.shape) == tuple(want.shape))
        else:
            ok = got.dtype == want.dtype and torch.equal(got, want)
        if not ok:
            bad.append("/".join(path))
    return bad


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _slices(store, shardings, mesh):
    """This rank's slices of a one-device store under ``shardings``."""
    return packed_store.tree_map(
        lambda leaf, ns: packed_store.shard_leaf(
            leaf, (ns.codes if isinstance(ns, QuantizedTensor) else ns).spec,
            mesh, shd.uneven_dims(ns)), store, shardings)


def placement(arch, np_params, prompts, shape, ckpt_dir):
    """On a ``shape`` mesh: a packed checkpoint of the one-device store
    restored per shard, and ``ServeEngine.from_init``'s slices, each
    against the one-device store's slices bit for bit; the restored
    engine's tokens and its bytes."""
    cfg = config(arch)
    mesh = mesh_lib.make_test_mesh(*shape)
    kw = dict(KW, backend="cuda", mesh=mesh)
    one = ServeEngine(cfg, convert.params_from_numpy(np_params, cfg), POL,
                      backend="cuda", **KW)
    eng = ServeEngine.from_checkpoint(cfg, ckpt_dir, POL, **kw)
    restored = _bad_leaves(eng.params, _slices(one.params, eng._store_sh,
                                               mesh))
    reqs = [eng.submit(p, R.MAX_NEW) for p in prompts]
    eng.run()
    drawn = ServeEngine.from_init(cfg, POL, torch.Generator().manual_seed(3),
                                  **kw)
    whole = M.init_packed_params(cfg, POL, torch.Generator().manual_seed(3))
    rank = torch.distributed.get_rank()
    return dict(restore_bad_leaves=restored, restore_tokens=[r.out
                                                             for r in reqs],
                init_bad_leaves=_bad_leaves(
                    drawn.params, _slices(whole, drawn._store_sh, mesh)),
                init_held=drawn.stats()["store_nbytes_per_device"][
                    f"rank{rank}:cpu"],
                init_predicted=drawn.rules.shard_nbytes(
                    M.packed_model_specs(cfg, POL), drawn._store_sh))


def capacity(np_params):
    """A decode step's MoE layer on (2, 1) with CAPACITY_SLOTS rows: this
    rank's rows of the engine's ``_apply_ffn`` under its mesh context, of
    one device's on the whole batch, and of one device's on this rank's
    rows alone (what routing the local batch would give)."""
    cfg = config(QWEN)
    params = convert.params_from_numpy(np_params, cfg)
    eng = ServeEngine(cfg, params, POL, mesh=mesh_lib.make_test_mesh(2, 1),
                      backend="cuda", **dict(KW, slots=CAPACITY_SLOTS))
    store = M.pack_model_params(cfg, params, eng.policy)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (CAPACITY_SLOTS, 1, cfg.d_model)).astype(np.float32))
    rows = eng._rows
    ffn = M.decoding.layer_params(store["layers"], 0)["sub0"]["ffn"]
    local = M.decoding.layer_params(eng.params["layers"], 0)["sub0"]["ffn"]
    with eng._hints():
        got = transformer._apply_ffn(local, x[rows], cfg, eng.policy, True)
    whole = transformer._apply_ffn(ffn, x, cfg, eng.policy, True)[rows]
    alone = blocks.moe(ffn, x[rows].transpose(0, 1), cfg,
                       eng.policy).transpose(0, 1)
    return dict(got=got.numpy(), whole=whole.numpy(), alone=alone.numpy(),
                local_rows=rows.stop - rows.start)


def world_1(rank, np_q, prompts):
    return {(1, 1): parity(QWEN, np_q, prompts, (1, 1))}


def world_2(rank, np_q, np_l, prompts, prompts_l, ckpt_dir):
    out = {shape: parity(QWEN, np_q, prompts, shape)
           for shape in ((2, 1), (1, 2))}
    out["llama4"] = parity(LLAMA, np_l, prompts_l, (1, 2))
    out["capacity"] = capacity(np_q)
    out["placement"] = placement(QWEN, np_q, prompts, (1, 2), ckpt_dir)
    return out


def world_3(rank, np_q, prompts, ckpt_dir):
    """(1, 3): 16 expert rows split 6 / 6 / 4 + 2 zero rows."""
    return {(1, 3): parity(QWEN, np_q, prompts, (1, 3)),
            "placement": placement(QWEN, np_q, prompts, (1, 3), ckpt_dir)}


def world_4(rank, np_q, prompts):
    """(2, 2) and (1, 4): at model 4 the last rank holds dead experts
    only (12-15)."""
    return {shape: parity(QWEN, np_q, prompts, shape)
            for shape in ((2, 2), (1, 4))}
