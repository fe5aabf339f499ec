"""The port's sharded serving engine on gloo CPU ranks: the twins of the JAX
package's ``tests/test_sharded_serving.py``.

The reduced qwen2.5-32b config in float32, the JAX package's weights,
``MXSF_INFER.replace(block_1d=16, kv_cache_fmt="mxsf")`` on the kernel
datapath (the kernels' plain versions on CPU tensors), 2 slots, max_len
16, chunk 4.  Each mesh is a world of gloo ranks (``torch_dist``), one
engine per rank, all ranks serving the same prompts; the single-device
port engine and the single-device JAX engine run here.

Tolerance: the first dispatch's logits of every sharded engine lie within
1e-5 of the largest logit of the single-device port engine's, and the
token streams are equal.  The row-parallel linears sum their K slices
and then all-reduce the f32 partials, a different order of the same
exact products (as GSPMD's partitioned sum is in the JAX package).
"""
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core.policy import BF16 as JAX_BF16
from repro.core.policy import MXSF_INFER as JAX_INFER
from repro.models import model as JM
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.ckpt import ckpt
from repro_torch.core import packed_store
from repro_torch.core import sharding as shd
from repro_torch.core.blocking import QuantizedTensor
from repro_torch.core.policy import BF16
from repro_torch.launch import mesh as mesh_lib
from repro_torch.serve.engine import ServeEngine

import torch_sharded_ranks as R
from torch_dist import run_ranks

POL, KW, LOGIT_RTOL = R.POL, R.KW, R.LOGIT_RTOL



def _cfgs(**kw):
    return (jax_config("qwen2.5-32b").reduced().replace(
        compute_dtype="float32", **kw), R.config(**kw))


def _numpy_params(cfg_j):
    return jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   cfg_j))


# ---------------------------------------------------------------------------
# fixtures: the references here, one world per mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    cfg_j, cfg_t = _cfgs()
    np_params = _numpy_params(cfg_j)
    params = convert.params_from_numpy(np_params, cfg_t)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg_t.vocab, size=n)]
               for n in (3, 5)]
    base, toks, first = R.serve(cfg_t, params, POL, prompts)
    _, bf16_toks, bf16_first = R.serve(cfg_t, params, BF16, prompts,
                                       backend=None)
    jout = {}
    for name, pol, backend in (("packed", JAX_INFER.replace(
            block_1d=16, kv_cache_fmt="mxsf"), "pallas"),
                               ("bf16", JAX_BF16, None)):
        jeng = JaxEngine(cfg_j, JM.init_params(jax.random.PRNGKey(0),
                                                cfg_j), pol, slots=2,
                         max_len=16, prefill_chunk=4, backend=backend)
        reqs = [jeng.submit(p, R.MAX_NEW) for p in prompts]
        jeng.run()
        jout[name] = [r.out for r in reqs]
    ckpt_dir = tempfile.mkdtemp(prefix="sharded_ckpt_")
    ckpt.save(ckpt_dir, 0, base.params)
    return dict(np_params=np_params, prompts=prompts, tokens=toks,
                first=first.numpy(), base=base, bf16_tokens=bf16_toks,
                bf16_first=bf16_first.numpy(), jax=jout, ckpt_dir=ckpt_dir,
                cfg=cfg_t)


@pytest.fixture(scope="module")
def worlds(ref):
    """Each world's rank results by key, run once: a world of 1 rank
    ((1, 1)), of 2 ((2, 1), (1, 2), n_kv = 1) and of 4 ((2, 2) and the
    rest)."""
    return {}


def _world(ref, worlds, size):
    if size not in worlds:
        if size == 1:
            worlds[1] = run_ranks(R.world_1, 1, ref["np_params"],
                                  ref["prompts"])
        elif size == 2:
            np_kv1 = _numpy_params(_cfgs(n_kv=1)[0])
            worlds[2] = run_ranks(R.world_2, 2, ref["np_params"], np_kv1,
                                  ref["prompts"])
        else:
            worlds[4] = run_ranks(R.world_4, 4, ref["np_params"],
                                  ref["prompts"], ref["ckpt_dir"])
    return worlds[size]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_single_device_port_matches_jax(ref):
    assert ref["tokens"] == ref["jax"]["packed"]
    assert ref["bf16_tokens"] == ref["jax"]["bf16"]
    assert ref["base"].attn_backend == "cuda-packed"


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_engine_token_parity_across_meshes(ref, worlds, shape):
    scale = np.abs(ref["first"]).max()
    for out in _world(ref, worlds, shape[0] * shape[1]):
        res = out[shape]
        assert res["tokens"] == ref["tokens"] == ref["jax"]["packed"]
        assert res["attn_backend"] == "cuda-packed"
        assert res["shard_fallback"] is None
        np.testing.assert_allclose(res["first"], ref["first"], rtol=0,
                                   atol=LOGIT_RTOL * scale)
        assert res["stats"]["mesh"] == {"data": shape[0], "model": shape[1]}


def test_row_parallel_input_codes_equal_one_device_codes():
    """The row-parallel input (ctx, or gate * up) is quantized along K in
    (1, 16) blocks; its shard boundaries fall on multiples of d_head (or
    of d_ff / tp), so each shard's codes are the one-device codes' slice."""
    from repro_torch.core import blocking as B
    _, cfg = _cfgs()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (6, cfg.n_heads * cfg.head_dim)).astype(np.float32))
    full = B.quantize(x, "mxsf", (1, POL.block_1d))
    for tp in (2, 4):
        k = x.shape[1] // tp
        assert k % cfg.head_dim == 0 and k % POL.block_1d == 0
        for r in range(tp):
            part = B.quantize(x[:, r * k:(r + 1) * k], "mxsf",
                              (1, POL.block_1d))
            nb = k // POL.block_1d
            assert torch.equal(part.codes, full.codes[:, r * k:(r + 1) * k])
            assert torch.equal(part.scale_e8m0,
                               full.scale_e8m0[:, r * nb:(r + 1) * nb])


def test_layout_on_2x2(ref, worlds):
    base_bytes = ref["base"].stats()["store_nbytes_per_device"]
    (one,) = base_bytes.values()
    for out in _world(ref, worlds, 4):
        res = out[(2, 2)]
        spec = res["cache_spec"]
        assert spec[-3] == "data"       # slot batch over the data axis
        assert spec[-1] == "model"      # kv heads over the model axis
        assert spec[2] == "data" and spec[3] is None  # positions whole
        assert res["cache_local"][-4:] == (1, 16, 1, 16)
        assert any(any(s for s in c) for c, _, _ in res["packed_specs"])
        for codes, scales, dtype in res["packed_specs"]:
            assert codes == scales and dtype == torch.uint8
        per = res["stats"]["store_nbytes_per_device"]
        assert len(per) == 4 and max(per.values()) < one


def test_stats_accounting_on_2x2(ref, worlds):
    """Each rank holds the bytes MeshRules predicts, and the ranks' bytes
    sum to the replicated total: every leaf counted once per rank that
    holds a copy of each of its shards."""
    from repro_torch.models import model as M
    world = [out[(2, 2)] for out in _world(ref, worlds, 4)]
    cfg = ref["cfg"]
    rules = mesh_lib.MeshRules(mesh_lib.AbstractMesh((2, 2),
                                                     ("data", "model")))
    specs = M.packed_model_specs(cfg, POL)
    shardings = rules.param_sharding_tree(specs)
    replicated = 0
    for leaf, ns in zip(packed_store.tree_leaves(specs),
                        packed_store.tree_leaves(shardings)):
        for t, n in (((leaf.codes, ns.codes), (leaf.scale_e8m0,
                                               ns.scale_e8m0))
                     if isinstance(leaf, QuantizedTensor) else ((leaf, ns),)):
            shards = 1
            for e in n.spec:
                shards *= shd.axis_size(e, rules.mesh.shape)
            replicated += t.numel() * t.element_size() * 4 // shards
    per = world[0]["stats"]["store_nbytes_per_device"]
    assert sum(per.values()) == replicated
    for r, res in enumerate(world):
        assert per[f"rank{r}:cpu"] == res["predicted"]
        assert res["stats"]["store_nbytes"] == \
            ref["base"].stats()["store_nbytes"]
        assert res["stats"]["tokens_generated"] == \
            ref["base"].stats()["tokens_generated"]
        cache = res["stats"]["cache_nbytes_per_device"]
        (one,) = ref["base"].stats()["cache_nbytes_per_device"].values()
        assert sum(cache.values()) == one  # batch x kv heads: 4 shards


def test_bf16_value_cache_on_2x2(ref, worlds):
    scale = np.abs(ref["bf16_first"]).max()
    for res in _world(ref, worlds, 4):
        assert res["bf16_tokens"] == ref["bf16_tokens"] == ref["jax"]["bf16"]
        assert res["bf16_cache_spec"][2] == "data"
        assert res["bf16_local_k"][-4:] == (1, 16, 1, 16)
        np.testing.assert_allclose(res["bf16_first"], ref["bf16_first"],
                                   rtol=0, atol=LOGIT_RTOL * scale)


def test_static_gate_not_misattributed_to_mesh(ref, worlds):
    for res in _world(ref, worlds, 4):
        assert res["swa"] == ("torch", None)


def test_packed_ckpt_restores_sharded_bitwise(ref, worlds):
    for res in _world(ref, worlds, 4):
        assert res["ckpt_bad_leaves"] == []
        assert res["ckpt_tokens"] == ref["tokens"]


def test_uneven_kv_heads_sequence_parallel_fallback(ref, worlds):
    """kv = 1 cannot split a 2-way model axis: the cache shards its
    position axis, the kernel cannot read that shard-local, and the engine
    records the fallback and matches the single-device torch-attention
    engine token for token."""
    cfg_j, cfg = _cfgs(n_kv=1)
    params = convert.params_from_numpy(_numpy_params(cfg_j), cfg)
    base, want, _ = R.serve(cfg, params, POL.replace(attention_kernel=False),
                            ref["prompts"])
    assert base.attn_backend == "torch"
    for out in _world(ref, worlds, 2):
        res = out["kv1"]
        assert res["attn_backend"] == "torch"
        assert "position axis" in res["shard_fallback"]
        assert res["cache_spec"][3] == "model"
        assert res["tokens"] == want


def test_replicated_attention_over_a_split_cache(ref, worlds):
    """Under 64-element blocks the reduced model's attention cannot split
    over a 2-way model axis (half a block per query head), the MLP can;
    the cache still splits its kv heads, which each rank writes and
    gathers at use: tokens equal the one-device engine's, kernel path."""
    params = convert.params_from_numpy(ref["np_params"], ref["cfg"])
    _, want, _ = R.serve(ref["cfg"], params, R.BLOCK64, ref["prompts"])
    for out in _world(ref, worlds, 2):
        res = out["blk64"]
        assert res["plan"] == (False, True, True, False, False)
        assert res["attn_backend"] == "cuda-packed"
        assert res["shard_fallback"] is None
        assert res["tokens"] == want


@pytest.mark.parametrize("case", list(R.ROW_CASES))
def test_row_parallel_rounds_once_at_bf16(worlds, case):
    """A row-parallel linear at bf16 compute sums its K halves' f32
    partials and rounds once, as one device rounds its matmul, on every
    datapath.  The operands are integers whose halves cancel: every sum
    is exact in f32, so the result equals one device's ``dense`` exactly;
    partials rounded to bf16 before the all-reduce would miss it by up
    to 8 per half."""
    from repro_torch.core import blocking as mxblk
    from repro_torch.models import blocks
    pol, packed = R.ROW_CASES[case]
    x, w = R.row_parallel_operands()
    assert torch.equal(mxblk.qdq(w.float(), "mxsf", (16, 1)), w.float())
    assert torch.equal(mxblk.qdq(x.float(), "mxsf", (16,)), x.float())
    leaf = packed_store.pack_leaf(w, pol) if packed else w
    want = blocks.dense(x, leaf, pol)
    exact = x.double() @ w.double()
    assert torch.equal(want.double(), exact)
    assert exact.abs().max() < 256 and (exact != 0).any()
    if "rows" not in worlds:
        worlds["rows"] = run_ranks(R.row_parallel, 2)
    for out in worlds["rows"]:
        dtype, got = out[case]
        assert dtype == want.dtype
        np.testing.assert_array_equal(got, want.float().numpy())


def test_engine_refuses_a_store_spec_that_tears_blocks():
    """The matmul kernels' per-shard gate: ``MeshRules`` never tears an MX
    block (``packed_spec`` replicates uneven scale grids), so a spec that
    does is refused rather than served."""
    from repro_torch.serve import engine as E
    leaf = packed_store.pack_leaf(torch.randn(64, 64), POL)  # 4 block rows
    ns = shd.NamedSharding(mesh_lib.AbstractMesh((1, 8), ("data", "model")),
                           ("model", None))
    sh = QuantizedTensor(ns, ns, leaf.fmt, leaf.block, leaf.shape,
                         leaf.dtype)
    E._check_blocks_aligned({"w": leaf}, {"w": sh}, {"data": 1, "model": 2})
    with pytest.raises(ValueError, match="tears MX blocks"):
        E._check_blocks_aligned({"w": leaf}, {"w": sh},
                                {"data": 1, "model": 8})


def test_engine_refuses_an_abstract_mesh():
    """A sharded engine needs a mesh over a process group: an abstract one
    (axis sizes only, no collectives) is refused."""
    _, cfg = _cfgs()
    mesh = mesh_lib.AbstractMesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="abstract"):
        ServeEngine(cfg, {}, POL, mesh=mesh, **KW)
