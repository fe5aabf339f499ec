"""The port's mesh rules against the JAX package's, in one process, no
process group.

For every reduced arch config and the meshes (1,1), (2,1), (1,2), (2,2)
("data", "model") and (2,2,2) ("pod", "data", "model"), the port's
``MeshRules`` on an ``AbstractMesh`` and the JAX package's on
``jax.sharding.AbstractMesh`` give the same specs, compared normalised
(``("data",)`` is ``"data"``, trailing ``None`` dims drop, as JAX 0.9
normalises them), for the f32 parameter tree, the packed store, the
train state, a batch and the caches, plus ``data_spec`` and ``spec_for``.
The trees come from each package's own builders where both have one
(``packed_model_specs``, ``init_cache``, ``train_specs``); the f32 tree
from the JAX package's shapes on ``meta`` tensors.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import get_config as jax_config
from repro.core import packed_store as JPS
from repro.core import sharding as JSH
from repro.core.blocking import QuantizedTensor as JQT
from repro.core.policy import MXSF_INFER as JAX_INFER
from repro.launch import mesh as JML
from repro.models import model as JM
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.base import get_config as torch_config
from repro_torch.core import packed_store
from repro_torch.core import sharding as shd
from repro_torch.core.blocking import QuantizedTensor
from repro_torch.core.policy import MXSF_INFER
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M

ARCHS = ["deit-tiny", "gemma2-2b", "gemma2-9b", "h2o-danube-1.8b",
         "internvl2-1b", "llama4-maverick-400b-a17b", "mamba2-780m",
         "qwen2-moe-a2.7b", "qwen2.5-32b", "whisper-medium", "zamba2-7b"]
MESHES = [((1, 1), ("data", "model")), ((2, 1), ("data", "model")),
          ((1, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
MESH_IDS = ["1x1", "2x1", "1x2", "2x2", "2x2x2"]


def _rules(sizes, names):
    return (mesh_lib.MeshRules(mesh_lib.AbstractMesh(sizes, names)),
            JML.MeshRules(JaxAbstractMesh(sizes, names)))


def _jax_flat(tree):
    """{path: normalised spec} of a JAX sharding tree (a packed leaf's
    codes and scales under ``/codes``, ``/scales``)."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JQT))[0]
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        if isinstance(leaf, JQT):
            out[key + "/codes"] = shd.normalize(tuple(leaf.codes.spec))
            out[key + "/scales"] = shd.normalize(tuple(leaf.scale_e8m0.spec))
        else:
            out[key] = shd.normalize(tuple(leaf.spec))
    return out


def _port_flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_flat(v, f"{prefix}{k}/"))
        return out
    key = prefix[:-1]
    if isinstance(tree, QuantizedTensor):
        out[key + "/codes"] = shd.normalize(tree.codes.spec)
        out[key + "/scales"] = shd.normalize(tree.scale_e8m0.spec)
    else:
        out[key] = shd.normalize(tree.spec)
    return out


def _meta_like(tree):
    """A JAX shape tree as the port's: ``meta`` tensors."""
    return jax.tree.map(lambda s: torch.empty(tuple(s.shape),
                                              device="meta"), tree)


@pytest.fixture(scope="module")
def trees():
    """Per arch: the JAX and port trees the rules run on."""
    out = {}
    for name in ARCHS:
        cj, ct = jax_config(name).reduced(), torch_config(name).reduced()
        f32 = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                    cj))
        entry = dict(cj=cj, ct=ct, f32_j=f32, f32_t=_meta_like(f32))
        if ct.family != "encoder":
            entry["packed_j"] = JM.packed_model_specs(cj, JAX_INFER)
            entry["packed_t"] = M.packed_model_specs(ct, MXSF_INFER)
            for b in (1, 4):
                entry[f"cache_j{b}"] = jax.eval_shape(
                    lambda b=b: JM.init_cache(cj, b, 32, kv_fmt="mxsf"))
                entry[f"cache_t{b}"] = M.init_cache(ct, b, 32, kv_fmt="mxsf",
                                                    device="meta")
        shape = ("t", 32, 4, "train")
        entry["batch_j"] = JM.train_specs(cj, JShape(*shape))
        entry["batch_t"] = M.train_specs(ct, ShapeConfig(*shape))
        out[name] = entry
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_match_jax(trees, arch, mesh):
    t = trees[arch]
    rt, rj = _rules(*mesh)
    want = _jax_flat(rj.param_sharding_tree(t["f32_j"]))
    assert _port_flat(rt.param_sharding_tree(t["f32_t"])) == want
    state_j = {"params": t["f32_j"], "opt": {"m": t["f32_j"],
                                             "v": t["f32_j"],
                                             "step": None}}
    state_t = {"params": t["f32_t"], "opt": {"m": t["f32_t"],
                                             "v": t["f32_t"],
                                             "step": None}}
    got = _port_flat(mesh_lib.state_shardings(rt, state_t))
    assert got == _jax_flat(JML.state_shardings(rj, state_j))
    assert _port_flat(mesh_lib.batch_shardings(rt, t["batch_t"])) == \
        _jax_flat(JML.batch_shardings(rj, t["batch_j"]))


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "deit-tiny"])
def test_packed_store_and_cache_specs_match_jax(trees, arch, mesh):
    t = trees[arch]
    rt, rj = _rules(*mesh)
    got = _port_flat(rt.param_sharding_tree(t["packed_t"]))
    want = _jax_flat(rj.param_sharding_tree(t["packed_j"]))
    assert got == want
    assert any(k.endswith("/codes") for k in got)
    for k in got:  # codes and scales split together
        if k.endswith("/codes"):
            assert got[k] == got[k[:-len("codes")] + "scales"]
    for b in (1, 4):
        got = _port_flat(mesh_lib.cache_shardings(rt, t[f"cache_t{b}"], b))
        want = _jax_flat(JML.cache_shardings(rj, t[f"cache_j{b}"], b))
        assert got == want, (b, got, want)
        assert M.cache_position_axis_sharded(
            mesh_lib.cache_shardings(rt, t[f"cache_t{b}"], b)) == \
            JM.cache_position_axis_sharded(
                JML.cache_shardings(rj, t[f"cache_j{b}"], b))


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_data_spec_and_spec_for_match_jax(mesh):
    rt, rj = _rules(*mesh)
    shapes = [(4,), (3,), (4, 8), (2, 6, 16), (8, 1024), (6, 7)]
    for shape in shapes:
        for axis in range(len(shape)):
            assert shd.normalize(rt.data_spec(shape, axis)) == \
                shd.normalize(tuple(rj.data_spec(shape, axis)))
    roles = [("batch", None), ("batch", "heads"), (None, "seq"),
             ("batch", "kv", "hidden"), ("experts", None),
             ("batch", "ff"), ("vocab", "batch")]
    ctx = dict(mesh=None, dp=rt.dp, tp=rt.tp, dp_size=rt.dp_size,
               tp_size=rt.tp_size)
    tok = JSH._CTX.set(ctx)
    try:
        with shd.mesh_context(rt.mesh, rt.dp, rt.tp):
            for r in roles:
                for shape in [(4, 6, 8)[:len(r)], (3, 5, 7)[:len(r)],
                              (2, 2, 2)[:len(r)]]:
                    assert shd.normalize(shd.spec_for(shape, r)) == \
                        shd.normalize(tuple(JSH.spec_for(shape, r))), (r,
                                                                      shape)
    finally:
        JSH._CTX.reset(tok)
    assert shd.spec_for((4,), ("batch",)) is None  # no context


def test_packed_spec_grid_divisibility_fallback():
    """The twin of the JAX package's test: a (64, 64) weight under 24-row
    blocks (grid 3) replicates on a 2-way axis although 64 % 2 == 0;
    under 16-row blocks (grid 4) it shards.  Specs compared normalised."""
    w = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    axis = {"data": 2, "model": 1}
    base = (("data",), None)
    for block, split in ((24, False), (16, True)):
        qt = packed_store.pack_leaf(torch.from_numpy(w),
                                    MXSF_INFER.replace(block_1d=block))
        qj = JPS.pack_leaf(jax.numpy.asarray(w),
                           JAX_INFER.replace(block_1d=block))
        assert qt.scale_e8m0.shape[0] == (3 if block == 24 else 4)
        spec = packed_store.packed_spec(qt, base, axis)
        assert shd.normalize(spec) == shd.normalize(tuple(JPS.packed_spec(
            qj, jax.sharding.PartitionSpec(*base), axis)))
        assert shd.normalize(spec) == (("data",) if split else ())
        assert packed_store.shard_block_aligned(qt, base, axis) == split


@pytest.mark.parametrize("data,model,n,want", [
    (2, 2, 4, (2, 2)), (1, 2, 1, (1, 1)), (16, 16, 4, (1, 4)),
    (1000, 3, 8, (2, 3)), (2, 2, 1, (1, 1)), (1, 1, 8, (1, 1))])
def test_make_test_mesh_clamps_both_axes(data, model, n, want):
    got = mesh_lib.clamp_test_mesh(data, model, n)
    assert got == want and got[0] * got[1] <= n


def test_mesh_makers_need_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    for make in (lambda: mesh_lib.make_test_mesh(1, 1),
                 lambda: mesh_lib.make_production_mesh(),
                 lambda: mesh_lib.make_production_mesh(multi_pod=True)):
        with pytest.raises(RuntimeError, match="init_process_group"):
            make()


def test_cache_position_axis_sharded_for_one_kv_head():
    """n_kv = 1 on (1, 2): the kv heads cannot split, the position axis
    does, and the attention gate sends the engine to the value path."""
    cfg = torch_config("qwen2.5-32b").reduced().replace(n_kv=1)
    rt, _ = _rules((1, 2), ("data", "model"))
    cache = M.init_cache(cfg, 2, 16, kv_fmt="mxsf", device="meta")
    sh = mesh_lib.cache_shardings(rt, cache, 2)
    assert M.cache_position_axis_sharded(sh)
    pol = MXSF_INFER.replace(kv_cache_fmt="mxsf", backend="cuda")
    assert M.decode_attn_backend(cfg, pol) == "cuda-packed"
    assert M.decode_attn_backend(cfg, pol, sh) == "torch"
    two = torch_config("qwen2.5-32b").reduced()
    sh2 = mesh_lib.cache_shardings(rt, M.init_cache(
        two, 2, 16, kv_fmt="mxsf", device="meta"), 2)
    assert not M.cache_position_axis_sharded(sh2)
    assert M.decode_attn_backend(two, pol, sh2) == "cuda-packed"


def test_shard_leaf_and_bytes_follow_the_spec():
    """A rank's slice of a packed leaf holds whole blocks of codes and
    scales (wq's 64 rows are one 64-row block, so they stay whole on a
    2-way data axis; its columns split over the model axis);
    ``MeshRules.shard_nbytes`` is the bytes each rank holds."""
    cfg = torch_config("qwen2.5-32b").reduced()
    specs = M.packed_model_specs(cfg, MXSF_INFER)
    rt, _ = _rules((2, 2), ("data", "model"))
    sh = rt.param_sharding_tree(specs)
    wq, ns = specs["layers"]["sub0"]["attn"]["wq"], \
        sh["layers"]["sub0"]["attn"]["wq"]
    local = packed_store.shard_leaf(wq, ns.codes.spec, rt.mesh)
    assert tuple(local.codes.shape) == (4, 64, 32)
    assert tuple(local.scale_e8m0.shape) == (4, 1, 32)
    assert tuple(local.shape) == (4, 64, 32)
    total = sum(t.numel() * t.element_size()
                for leaf in packed_store.tree_leaves(specs)
                for t in ((leaf.codes, leaf.scale_e8m0)
                          if isinstance(leaf, QuantizedTensor) else (leaf,)))
    assert total // 4 <= rt.shard_nbytes(specs, sh) < total
