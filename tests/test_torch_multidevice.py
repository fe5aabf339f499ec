"""Multi-rank behaviours of the port on gloo CPU ranks: the twins of the JAX
package's ``tests/test_multidevice.py`` (elastic restore, the
MXSF-compressed all-reduce, the GPipe pipeline).

Each test spawns its world through ``torch_dist.run_ranks`` (its own time
limit; gloo collectives time out after 60 s).  This module imports JAX
only inside the test that needs it, so the ranks, which import it, start
without JAX.
"""
import tempfile

import numpy as np
import torch

from repro_torch.ckpt import ckpt
from repro_torch.core import packed_store
from repro_torch.core.blocking import QuantizedTensor
from repro_torch.core.policy import MXSF_INFER
from repro_torch.core.sharding import NamedSharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime.compress import make_compressed_allreduce, wire_bytes
from repro_torch.runtime.pipeline_par import pipeline_apply

from torch_dist import run_ranks

# compressed mean: each rank's qdq is exact and equal to the JAX package's
# (bitwise codec); the sum of 4 f32 values over gloo's order and the JAX
# package's mean differ by a few ulps of the largest row value
COMPRESS_ATOL = 4 * 2.0 ** -23
PIPE_TOL = 2e-5  # the JAX test's own


def _state():
    """A (8, 8) f32 leaf, an int32 step and a packed (64, 8) weight under
    (16, 1) blocks (scale grid 4 rows: splits 2 and 4 ways)."""
    w = torch.arange(64.0).reshape(8, 8)
    g = torch.Generator().manual_seed(0)
    packed = packed_store.pack_leaf(torch.randn(64, 8, generator=g),
                                    MXSF_INFER.replace(block_1d=16))
    return {"w": w, "step": torch.tensor(3, dtype=torch.int32),
            "packed": packed}


def _shardings(mesh):
    ns = NamedSharding(mesh, ("data",))
    qt = _state()["packed"]
    return {"w": ns, "step": NamedSharding(mesh, ()),
            "packed": QuantizedTensor(ns, ns, qt.fmt, qt.block, qt.shape,
                                      qt.dtype)}


def _save_on_2(rank, ckpt_dir):
    mesh = mesh_lib.make_mesh((2,), ("data",))
    sh = _shardings(mesh)
    local = packed_store.tree_map(
        lambda leaf, ns: packed_store.shard_leaf(
            leaf, (ns.codes if isinstance(ns, QuantizedTensor) else ns).spec,
            mesh), _state(), sh)
    ckpt.save(ckpt_dir, 3, local, shardings=sh)
    return tuple(local["w"].shape)


def _restore_on_4(rank, ckpt_dir):
    mesh = mesh_lib.make_mesh((4,), ("data",))
    target = packed_store.tree_map(
        lambda t: QuantizedTensor(t.codes.to("meta"),
                                  t.scale_e8m0.to("meta"), t.fmt, t.block,
                                  t.shape, t.dtype)
        if isinstance(t, QuantizedTensor) else t.to("meta"), _state())
    got, step = ckpt.restore(ckpt_dir, target, device="cpu",
                             shardings=_shardings(mesh))
    want = _state()
    q, wq = got["packed"], want["packed"]
    return dict(step=step, w=got["w"].numpy(),
                w_want=want["w"][rank * 2:(rank + 1) * 2].numpy(),
                step_leaf=int(got["step"]),
                codes=torch.equal(q.codes,
                                  wq.codes[rank * 16:(rank + 1) * 16]),
                scales=torch.equal(q.scale_e8m0,
                                   wq.scale_e8m0[rank:rank + 1]),
                dtypes=(q.codes.dtype, q.scale_e8m0.dtype),
                shape=tuple(q.shape))


def test_elastic_reshard_restore():
    """Checkpoint on a (2,) data mesh (gathered, rank 0 writes), restore
    onto (4,): every rank's slice bitwise, packed leaves uint8."""
    with tempfile.TemporaryDirectory() as td:
        assert run_ranks(_save_on_2, 2, td) == [(4, 8), (4, 8)]
        for rank, res in enumerate(run_ranks(_restore_on_4, 4, td)):
            assert res["step"] == 3 and res["step_leaf"] == 3
            np.testing.assert_array_equal(res["w"], res["w_want"])
            assert res["codes"] and res["scales"]
            assert res["dtypes"] == (torch.uint8, torch.uint8)
            assert res["shape"] == (16, 8)


def _compress(rank, rows):
    mesh = mesh_lib.make_mesh((4,), ("data",))
    reduce_tree = make_compressed_allreduce(mesh, "data")
    out, stats = reduce_tree({"g": torch.from_numpy(rows[rank])})
    return out["g"].numpy(), stats


def test_compressed_allreduce_numerics_and_wire():
    """Rank r's gradient is row r of a seeded (4, 256) array; every rank
    gets the mean of the rows' MXSF qdq (blocks of 64), the JAX package's
    semantics, and the wire model is exact."""
    import jax.numpy as jnp
    from repro.core import blocking as JB
    rows = np.random.default_rng(0).standard_normal((4, 256)).astype(
        np.float32)
    expect = np.asarray(JB.qdq(jnp.asarray(rows), "mxsf", (64,))).mean(0)
    for got, stats in run_ranks(_compress, 4, rows):
        np.testing.assert_allclose(got, expect, rtol=0,
                                   atol=COMPRESS_ATOL * np.abs(rows).max())
        assert stats["wire_bytes_compressed"] == 256 + 4
        assert stats["wire_bytes_f32"] == 4 * 256
        assert stats["wire_bytes_compressed"] * 3.5 < stats["wire_bytes_f32"]
    g = torch.zeros(1000)
    assert wire_bytes(g) == 1000 + 16 and wire_bytes(g, "none") == 4000


def _layer_fn(stage_w, x):
    for w in stage_w:
        x = torch.tanh(x @ w)
    return x


def _pipeline(rank, ws, xs):
    mesh = mesh_lib.make_mesh((4,), ("pod",))
    y = pipeline_apply(mesh, "pod", _layer_fn, torch.from_numpy(ws),
                       torch.from_numpy(xs))
    return y.numpy()


def test_pipeline_parallel_matches_sequential():
    """4 stages of 2 tanh(x @ W) layers, 8 microbatches: every rank gets
    the sequential run's outputs within the JAX test's 2e-5."""
    S, per, M, mb, dim = 4, 2, 8, 4, 16
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((S, per, dim, dim)) / 4).astype(np.float32)
    xs = rng.standard_normal((M, mb, dim)).astype(np.float32)
    ref = torch.from_numpy(xs)
    for s in range(S):
        ref = _layer_fn(torch.from_numpy(ws[s]), ref)
    for y in run_ranks(_pipeline, 4, ws, xs):
        np.testing.assert_allclose(y, ref.numpy(), rtol=PIPE_TOL,
                                   atol=PIPE_TOL)
