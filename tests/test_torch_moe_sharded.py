"""Expert parallelism: the port's sharded engine serves MoE configs on
gloo CPU ranks, each rank running its own experts.

The reduced qwen2-moe-a2.7b with 12 live experts padded to 16 (top-2, one
shared expert, 4 kv heads as in the full config's multi-head attention):
at model 2 every rank holds live experts, at model 4 the
last rank holds only dead ones (12-15), at model 3 the 16 rows split
6 / 6 / 4 and the last rank pads 2 zero rows, as GSPMD pads an uneven
split.  The reduced llama4-maverick (MoE every 2nd layer, top-1, shared
expert) on (1, 2).  ``MXSF_INFER.replace(block_1d=16,
kv_cache_fmt="mxsf")`` on the kernel datapath (the kernels' plain
versions on CPU tensors), 2 slots, max_len 20, token by token (MoE).

References and tolerances:

* token streams: the JAX package's one-device engine on its Pallas
  backend, equal on every mesh;
* the first dispatch's logits: within ``LOGIT_RTOL`` (1e-5) of the
  largest logit of the port's one-device engine.  Routing, dispatch, the
  expert outputs (gathered whole) and the combine are exact; the
  row-parallel o and shared-expert down sum their K slices' f32 partials
  in another order;
* the data-axis routing check (2, 1), checkpoint restores and the
  per-rank draw of a store: bitwise.
"""
import math
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core.policy import MXSF_INFER as JAX_INFER
from repro.models import model as JM
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.ckpt import ckpt
from repro_torch.core import packed_store
from repro_torch.core import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M

import torch_moe_ranks as MR
import torch_sharded_ranks as R
from torch_dist import run_ranks

LOGIT_RTOL = R.LOGIT_RTOL
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4), (1, 3)]


def _jax_cfg(arch):
    return jax_config(arch).reduced().replace(compute_dtype="float32",
                                              **MR.ARCH_KW[arch])


def _reference(arch, seed):
    """The JAX weights (numpy), prompts, the JAX engine's tokens and the
    port's one-device engine."""
    cfg_j, cfg_t = _jax_cfg(arch), MR.config(arch)
    pj = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    np_params = jax.tree.map(np.asarray, pj)
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(0, cfg_t.vocab, size=n)]
               for n in (3, 5)]
    jeng = JaxEngine(cfg_j, pj, JAX_INFER.replace(block_1d=16,
                                                  kv_cache_fmt="mxsf"),
                     slots=2, max_len=MR.KW["max_len"], prefill_chunk=4,
                     backend="pallas")
    reqs = [jeng.submit(p, R.MAX_NEW) for p in prompts]
    jeng.run()
    base, toks, first = R.serve(cfg_t, convert.params_from_numpy(
        np_params, cfg_t), MR.POL, prompts, max_len=MR.KW["max_len"])
    return dict(np_params=np_params, prompts=prompts, base=base,
                tokens=toks, first=first.numpy(),
                jax=[r.out for r in reqs], cfg=cfg_t)


@pytest.fixture(scope="module")
def ref():
    out = {"qwen": _reference(MR.QWEN, 0), "llama4": _reference(MR.LLAMA, 1)}
    out["ckpt_dir"] = tempfile.mkdtemp(prefix="moe_ckpt_")
    ckpt.save(out["ckpt_dir"], 0, out["qwen"]["base"].params)
    return out


@pytest.fixture(scope="module")
def worlds():
    return {}


def _world(ref, worlds, size):
    q = ref["qwen"]
    if size not in worlds:
        if size == 1:
            worlds[1] = run_ranks(MR.world_1, 1, q["np_params"],
                                  q["prompts"])
        elif size == 2:
            worlds[2] = run_ranks(MR.world_2, 2, q["np_params"],
                                  ref["llama4"]["np_params"], q["prompts"],
                                  ref["llama4"]["prompts"], ref["ckpt_dir"])
        elif size == 3:
            worlds[3] = run_ranks(MR.world_3, 3, q["np_params"],
                                  q["prompts"], ref["ckpt_dir"])
        else:
            worlds[4] = run_ranks(MR.world_4, 4, q["np_params"],
                                  q["prompts"])
    return worlds[size]


def _held_to_reference(res, r):
    assert res["tokens"] == r["tokens"] == r["jax"]
    np.testing.assert_allclose(res["first"], r["first"], rtol=0,
                               atol=LOGIT_RTOL * np.abs(r["first"]).max())
    assert res["held"] == res["predicted"]


def test_single_device_port_matches_jax(ref):
    for r in (ref["qwen"], ref["llama4"]):
        assert r["tokens"] == r["jax"]
        assert r["base"].prefill_chunk == 1


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_token_parity_across_meshes(ref, worlds, shape):
    """Every rank's tokens are the JAX engine's; each rank holds the bytes
    ``MeshRules`` predicts, ceil(16 / model) expert rows."""
    for res in _world(ref, worlds, shape[0] * shape[1]):
        res = res[shape]
        _held_to_reference(res, ref["qwen"])
        assert res["attn_backend"] == "cuda-packed"
        assert res["expert_rows"] == -(-16 // shape[1])
        assert res["plan"][3] == (shape[1] > 1)  # experts split


def test_llama4_interleaved_moe_on_1x2(ref, worlds):
    """Dense and MoE sublayers alternate: the dense FFN and the shared
    expert are planned apart (d_ff 128 and 64), both split."""
    for out in _world(ref, worlds, 2):
        res = out["llama4"]
        _held_to_reference(res, ref["llama4"])
        assert res["plan"] == (True, True, True, True, True)


def test_decode_routes_the_whole_batch_under_a_data_axis(ref, worlds):
    """On (2, 1) each data rank holds 4 of 8 decode rows.  The MoE layer
    routes all 8 as one row, as one device does: capacity 2, where 4 rows
    alone would give 1.  Its output rows equal one device's bit for bit,
    and routing the local rows alone would not."""
    cfg = ref["qwen"]["cfg"]
    cap = lambda s: math.ceil(s * cfg.top_k * cfg.capacity_factor
                              / cfg.n_experts)
    for out in _world(ref, worlds, 2):
        res = out["capacity"]
        assert (cap(MR.CAPACITY_SLOTS), cap(res["local_rows"])) == (2, 1)
        np.testing.assert_array_equal(res["got"], res["whole"])
        assert not np.array_equal(res["alone"], res["whole"])


@pytest.mark.parametrize("size", [2, 3], ids=["1x2", "1x3"])
def test_moe_checkpoint_restores_per_rank_bitwise(ref, worlds, size):
    """A checkpoint of the one-device store restores onto (1, 2) and onto
    the uneven (1, 3) split: every leaf equals the one-device store's
    slice, zero rows included, and the engine serves the same tokens."""
    for out in _world(ref, worlds, size):
        res = out["placement"]
        assert res["restore_bad_leaves"] == []
        assert res["restore_tokens"] == ref["qwen"]["tokens"]


@pytest.mark.parametrize("size", [2, 3], ids=["1x2", "1x3"])
def test_ranks_draw_their_slices_of_the_one_device_store(ref, worlds,
                                                         size):
    """``ServeEngine.from_init`` draws every leaf as one device does and
    keeps its slice: bit for bit the one-device store's slice, at the
    bytes ``MeshRules`` predicts."""
    for out in _world(ref, worlds, size):
        res = out["placement"]
        assert res["init_bad_leaves"] == []
        assert res["init_held"] == res["init_predicted"]


class _Coords:
    """A rank's coordinates on a mesh without a process group."""

    def __init__(self, coords):
        self.coords = coords

    def get_local_rank(self, axis):
        return self.coords[axis]


@pytest.mark.parametrize("model", [3, 5, 7])
def test_uneven_expert_split_places_as_gspmd(model):
    """16 expert rows over a model axis that does not divide them: rank i
    holds rows [i c, min((i + 1) c, 16)), c = ceil(16 / model), zero rows
    past the end (at 7, c = 3 and the last rank holds none), the ranks'
    rows concatenate to the whole stack, and ``shard_nbytes`` counts c
    rows on every rank.  Other dims still refuse an uneven split."""
    cfg = MR.config(MR.QWEN)
    specs = M.packed_model_specs(cfg, MR.POL)
    rules = mesh_lib.MeshRules(mesh_lib.AbstractMesh((1, model),
                                                     ("data", "model")))
    sh = rules.param_sharding_tree(specs)
    ns = sh["layers"]["sub0"]["ffn"]["we_g"]
    assert ns.uneven == ((1, 16),)
    full = torch.randn(specs["layers"]["sub0"]["ffn"]["we_g"].shape,
                       generator=torch.Generator().manual_seed(0))
    c = -(-16 // model)
    parts = []
    for i in range(model):
        mesh = shd.Mesh({"data": 1, "model": model},
                        _Coords({"data": 0, "model": i}))
        local = packed_store.shard_leaf(full, ns.spec, mesh, (1,))
        assert local.shape[1] == c
        live = max(0, min(16 - i * c, c))
        assert torch.equal(local[:, :live], full[:, i * c:i * c + live])
        assert not local[:, live:].any()
        parts.append(local)
    assert torch.equal(torch.cat(parts, 1)[:, :16], full)
    # nothing else of the reduced model splits 3, 5 or 7 ways: the bytes
    # differ from one device's by the expert rows alone (3 f32 stacks)
    one = mesh_lib.MeshRules(mesh_lib.AbstractMesh((1, 1),
                                                   ("data", "model")))
    assert rules.shard_nbytes(specs) - one.shard_nbytes(specs) == \
        3 * 4 * (full[:, :c].numel() - full.numel())
    with pytest.raises(ValueError, match="does not split"):
        shd.shard_slices((16, 6), ("model", None), mesh)
