"""The dry run on a mesh: one rank of a mesh traced in one process on
``meta`` tensors (``sharding.TracingMesh``, no process group), and the
layer-period trace, against the JAX package and against real ranks.

* The per-rank argument bytes of the prefill and decode cells of reduced
  qwen2.5-32b, qwen2-moe, gemma2-2b and internvl2 on (2, 2) and (2, 2, 2)
  equal the bytes of the same leaves -- f32 parameters, cache, tokens (and
  a VLM's patch embeddings), position -- under the JAX package's specs
  (``MeshRules``, ``cache_shardings``, ``data_spec`` on
  ``jax.sharding.AbstractMesh``), exactly; the model FLOPs and parameter
  counts equal the JAX dry run's ``_analytic_model_flops`` (in a
  subprocess: at import it asks XLA for 512 host devices).
* The tracing mesh's collectives (kind, axis, calls, operand bytes) and
  kernel launches of one prefill and one decode dispatch of the serving
  engine equal a real gloo rank's (its kernel wrappers' calls: on CPU
  tensors they run their plain versions), rank by rank, at (1, 2) and
  (2, 2), under the kernels' 64-element blocks: the reduced qwen2.5-32b
  at 32-wide heads (so heads, FFN and vocab split over the model axis)
  and the reduced qwen2-moe with 12 live experts of 16 (the heads split
  with their context gathered before a whole wo, the shared expert
  replicated, the experts split); every rank counts
  what rank 0 counts, and the argument bytes are the rank's store and
  cache bytes.
* The layer-period trace (two and three periods, scaled to the depth)
  gives a whole trace's counts exactly on reduced gemma2-2b (alternating
  SWA), llama4 (MoE every 2nd layer) and h2o-danube, on one card and on
  (2, 2), peak included for serving cells; a train step's peak is a lower
  bound within 10% here (its position moves with depth).
* A train cell of a dense decoder on a mesh traces the sharded train
  step: a tracing-mesh rank's step of reduced h2o-danube (2D MXSF, the
  kernel datapath, remat "dots") counts what a real gloo rank's step runs
  -- kernel launches, collectives by kind, axis and operand bytes (the
  backward's reduce-scatters and column-entry all-reduces among them) and
  argument bytes -- on (2, 1), (1, 2) and (2, 2); a reduced train cell's
  16x16 record has the JAX keys, a non-empty "reduce-scatter" and the
  argument bytes of the JAX package's ``state_shardings`` and
  ``batch_shardings``.  The same for the MoE decoders: reduced
  qwen2-moe's traced step equals the real ranks' on (1, 2) and on the
  uneven (1, 3), and its 16x16 record's model-axis all-gathers are the
  experts' output gathers and the takes' gradient gathers.  A train cell
  of the other families on a mesh raises, naming its ROADMAP item, and
  the CLI writes it as a failure; a mamba2 serving cell on a mesh writes
  its record.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import get_config as jax_config
from repro.launch import mesh as JML
from repro.models import model as JM
from repro_torch.configs.base import SHAPES, ShapeConfig, get_config
from repro_torch.core import sharding as shd
from repro_torch.launch import cost, dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import blocks
from repro_torch.models import model as M
from repro_torch.serve import engine as E
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import step as T

import chip_smoke as CS
import torch_moe_ranks as MR
import torch_moe_train_ranks as MTR
import torch_sharded_ranks as R
import torch_train_ranks as TR
from repro.optim import adamw as JA
from repro.train import step as JT
from torch_dist import run_ranks

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = {"mesh_decode": ShapeConfig("mesh_decode", 64, 8, "decode"),
         "mesh_prefill": ShapeConfig("mesh_prefill", 32, 8, "prefill")}
ARCHS = ["qwen2.5-32b", "qwen2-moe-a2.7b", "gemma2-2b", "internvl2-1b"]
KV = {"qwen2.5-32b": "mxsf", "qwen2-moe-a2.7b": "mxsf", "gemma2-2b": "",
      "internvl2-1b": "mxsf"}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def shapes():
    SHAPES.update(CELLS)
    yield
    for k in CELLS:
        del SHAPES[k]


LAYERS = 2  # the reduced configs' depth here (both packages)


def _record(arch, shape, mesh, trace="whole"):
    pol = dryrun.cell_policy("mxsf", CELLS[shape].kind, kv_cache=KV[arch],
                             backend="cuda")
    tcfg, ocfg = dryrun.cell_config(arch)
    cfg = get_config(arch).reduced().replace(n_layers=LAYERS)
    return dryrun.lower_cell(arch + "-reduced", shape, pol, tcfg, ocfg,
                             mesh=dryrun.mesh_of(mesh), trace=trace, cfg=cfg)


@pytest.fixture(scope="module")
def records():
    return {(a, s, m): _record(a, s, m) for a in ARCHS for s in CELLS
            for m in MESHES}


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _jax_bytes(tree, shardings, sizes):
    """Bytes one device holds of a JAX shape tree under its shardings: each
    leaf's per-device shape (a dim split over axes of n devices holds
    ceil(dim / n) rows, as GSPMD pads)."""
    total = 0
    for leaf, ns in zip(jax.tree.leaves(tree), jax.tree.leaves(shardings)):
        local = shd.shard_shape(tuple(leaf.shape), tuple(ns.spec), sizes,
                                tuple(range(len(leaf.shape))))
        total += math.prod(local) * leaf.dtype.itemsize
    return total


def _jax_argument_bytes(arch, shape_name, mesh):
    sizes, names = MESHES[mesh]
    rules = JML.MeshRules(JaxAbstractMesh(sizes, names))
    cfg = jax_config(arch).reduced().replace(n_layers=LAYERS)
    c = CELLS[shape_name]
    shape = JShape(c.name, c.seq_len, c.global_batch, c.kind)
    params = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    ax = dict(zip(names, sizes))
    total = _jax_bytes(params, rules.param_sharding_tree(params), ax)
    B = shape.global_batch
    if shape.kind == "decode":
        d = JM.decode_specs(cfg, shape, kv_fmt=KV[arch])
        total += _jax_bytes(d["cache"], JML.cache_shardings(
            rules, d["cache"], B), ax)
        total += _jax_bytes(d["tokens"], rules.named(rules.data_spec(
            d["tokens"].shape)), ax)
        return total + 4  # the scalar position, replicated
    batch = JM.train_specs(cfg, shape)
    cache = jax.eval_shape(lambda: JM.init_cache(cfg, B, shape.seq_len,
                                                 ring=False))
    total += _jax_bytes(batch, JML.batch_shardings(rules, batch), ax)
    return total + _jax_bytes(cache, JML.cache_shardings(rules, cache, B),
                              ax)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(CELLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_jax_specs(records, arch, shape, mesh):
    rec = records[(arch, shape, mesh)]
    assert rec["memory"]["argument_bytes"] == \
        _jax_argument_bytes(arch, shape, mesh)
    assert rec["mesh"] == mesh and rec["n_devices"] == \
        math.prod(MESHES[mesh][0])
    assert rec["fits"] and rec["cost"]["launches"]["mxsf_fused_matmul"]
    assert rec["collectives"]["all-gather"]["count"] > 0
    assert set(rec["collectives"]) == set(cost.COLLECTIVES)
    for kind, c in rec["collectives"].items():
        assert c["count"] == sum(v["count"] for v in c["by_axis"].values())
    assert set(rec["collective_axes"]) == set(MESHES[mesh][1])
    r = rec["roofline"]
    terms = {"compute": r["compute_s"], "memory": r["memory_s"],
             "collective": r["collective_s"]}
    assert r["dominant"] == max(terms, key=terms.get)
    assert r["collective_s"] > 0
    assert rec["attn_backend"] in ("torch", "cuda-packed")


def test_model_flops_and_params_equal_the_jax_dry_run(records):
    code = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, %r)
import jax
from repro.configs.base import ShapeConfig, get_config
from repro.launch import dryrun as D
from repro.models import model as M
out = {}
for a in %r:
    cfg = get_config(a).reduced().replace(n_layers=%d)
    spec = jax.eval_shape(lambda: M.init_params(jax.random.PRNGKey(0), cfg))
    for s, (n, seq, b, kind) in %r.items():
        out[a + "/" + s] = D._analytic_model_flops(
            cfg, ShapeConfig(n, seq, b, kind), spec)
print(json.dumps(out))
""" % (str(ROOT / "src"), ARCHS, LAYERS, {k: tuple(v.__dict__.values())
                                 for k, v in CELLS.items()})
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    for (arch, shape, mesh), rec in records.items():
        flops, total, active = want[f"{arch}/{shape}"]
        assert rec["model_flops_global"] == flops
        assert rec["model_flops_per_device"] == flops / rec["n_devices"]
        assert (rec["params_total"], rec["params_active"]) == (total,
                                                               active)
        assert rec["useful_flops_fraction"] == \
            flops / rec["n_devices"] / rec["cost"]["flops_per_device"]


# ---------------------------------------------------------------------------
# against real ranks
# ---------------------------------------------------------------------------

COUNT_CASES = {"dense": (R.config(d_head=32, n_layers=LAYERS), R.BLOCK64),
               "moe": (MR.config(MR.QWEN).replace(n_layers=LAYERS),
                       R.BLOCK64)}


def _traced(name, shape, rank):
    cfg, pol = COUNT_CASES[name]
    mesh = mesh_lib.make_tracing_mesh(shape, rank)
    return dryrun.engine_dispatches(cfg, pol, mesh, R.KW["slots"],
                                    R.KW["max_len"], R.KW["prefill_chunk"])


def _as_ranks_count(summary):
    """A summary's launches and collectives as ``engine_counts`` holds
    them."""
    return {"launches": {k: v for k, v in summary["cost"]["launches"].items()
                         if v},
            "collectives": cost.collectives_by_axis(summary["collectives"])}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_traced_dispatches_equal_the_real_ranks(shape):
    real = run_ranks(R.dispatch_counts, math.prod(shape), shape,
                     COUNT_CASES)
    plans = {"dense": (True, True, True, False, False, False, False),
             "moe": (True, False, True, True, False, False, True)}
    for name in COUNT_CASES:
        first = None
        for rank, got in enumerate(real):
            got = got[name]
            traced = _traced(name, shape, rank)
            assert tuple(traced["tp_plan"].values()) == plans[name]
            for kind in ("prefill", "decode"):
                want = _as_ranks_count(traced[kind])
                assert got[kind] == want, (name, rank, kind)
                assert traced[kind]["memory"]["argument_bytes"] == \
                    got["store_bytes"] + got["cache_bytes"]
            assert (traced["store_bytes"], traced["cache_bytes"]) == \
                (got["store_bytes"], got["cache_bytes"])
            # SPMD: every rank counts what rank 0 counts
            first = first or got
            assert {k: got[k] for k in ("prefill", "decode")} == \
                {k: first[k] for k in ("prefill", "decode")}
        assert "mxsf_attention" in got["decode"]["launches"]
        assert "all-reduce" in got["decode"]["collectives"]


def test_uneven_expert_split_counts_alike_on_every_rank():
    """16 expert rows on a model axis of 3 split 6 / 6 / 4 and two zero
    rows: each rank holds, runs and gathers six rows, so every rank of
    (1, 3) traces rank 0's launches, collectives and argument bytes; only
    the last rank's aten ops and temporaries differ, by the zero rows it
    pads its dispatch with (the production meshes split the experts
    evenly: 64 or 128 over 16)."""
    runs = [_traced("moe", (1, 3), r) for r in range(3)]
    for rank, run in enumerate(runs):
        for kind in ("prefill", "decode"):
            got, want = run[kind], runs[0][kind]
            assert got["collectives"] == want["collectives"]
            assert got["cost"]["launches"] == want["cost"]["launches"]
            assert got["memory"]["argument_bytes"] == \
                want["memory"]["argument_bytes"]
            pad = got["cost"]["aten_ops"] - want["cost"]["aten_ops"]
            assert pad == 0 if rank < 2 else pad > 0
    assert runs[0]["decode"]["collectives"]["all-gather"]["by_axis"][
        "model"]["count"] > 0


# ---------------------------------------------------------------------------
# the layer-period trace
# ---------------------------------------------------------------------------

PERIOD_CELLS = {"decode": ShapeConfig("d", 16, 4, "decode"),
                "prefill": ShapeConfig("p", 8, 4, "prefill"),
                "train": ShapeConfig("t", 8, 2, "train")}


@pytest.mark.parametrize("arch,layers,kind,mesh", [
    ("gemma2-2b", 8, "decode", None), ("gemma2-2b", 8, "prefill", "2x2"),
    ("llama4-maverick-400b-a17b", 8, "decode", "2x2"),
    ("llama4-maverick-400b-a17b", 8, "prefill", None),
    ("h2o-danube-1.8b", 4, "decode", "2x2"),
    ("h2o-danube-1.8b", 4, "prefill", None),
    ("h2o-danube-1.8b", 4, "train", None)])
def test_layer_period_trace_equals_a_whole_trace(arch, layers, kind, mesh):
    cfg = get_config(arch).reduced().replace(n_layers=layers)
    shape = PERIOD_CELLS[kind]
    pol = dryrun.cell_policy("mxsf", kind, kv_cache="mxsf", backend="cuda")
    args = (cfg, shape, pol, T.TrainConfig(), OptConfig())
    m = None if mesh is None else dryrun.mesh_of(mesh)
    whole, _, w = dryrun.trace_cell(*args, mesh=m, trace="whole")
    period, _, p = dryrun.trace_cell(*args, mesh=m, trace="period")
    assert w["mode"] == "whole" and p["mode"] == "period"
    assert p["periods"] * p["period_layers"] == layers
    if kind == "train":  # the peak: a lower bound within 10%
        assert 0.9 * whole["peak_bytes"] <= period["peak_bytes"] \
            <= whole["peak_bytes"]
        period["peak_bytes"] = whole["peak_bytes"]
    assert period == whole


def test_layer_period_of_each_pattern():
    assert dryrun.layer_period(get_config("gemma2-9b")) == (2, 21, 0)
    assert dryrun.layer_period(get_config(
        "llama4-maverick-400b-a17b")) == (2, 24, 0)
    assert dryrun.layer_period(get_config("qwen2.5-32b")) == (1, 64, 0)
    assert dryrun.layer_period(get_config("zamba2-7b")) == (6, 13, 3)
    assert dryrun.at_depth(get_config("zamba2-7b"), 2).n_layers == 15
    assert dryrun.layer_period(get_config("whisper-medium")) == (1, 24, 0)
    assert dryrun.at_depth(get_config("whisper-medium"), 3).n_enc_layers \
        == 3


# ---------------------------------------------------------------------------
# what a mesh does not run yet; the tracing mesh itself
# ---------------------------------------------------------------------------

def test_train_and_other_families_on_a_mesh_raise(tmp_path):
    """Every family's train cell on a mesh writes its record now: the
    SSM's, the hybrid's and the encoder-decoder's (the JAX dry run's grid)
    and a dense decoder's, each with its gradients reduce-scattered over
    "data"; the SSD's split consumers reduce-scatter over "model" too.  A
    mamba2 serving cell on a mesh writes its record, with the JAX record's
    keys and its collectives."""
    SHAPES["mesh_train"] = ShapeConfig("mesh_train", 16, 4, "train")
    try:
        shape = "mesh_train"
        for arch in ("mamba2-780m-reduced", "zamba2-7b-reduced",
                     "whisper-medium-reduced", "qwen2.5-32b-reduced"):
            dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "2x2",
                         "--out", str(tmp_path)])
            rec = json.loads((tmp_path / f"{arch}__{shape}__2x2.json"
                              ).read_text())
            rs = rec["collectives"]["reduce-scatter"]["by_axis"]
            assert rec["train"] and rs["data"]["count"] > 0, arch
            if rec["tp_plan"]["ssm"]:
                assert rs["model"]["count"] > 0, arch
        arch = "mamba2-780m-reduced"
        dryrun.main(["--arch", arch, "--shape", "mesh_decode", "--mesh",
                     "2x2", "--backend", "cuda", "--out", str(tmp_path)])
        rec = json.loads((tmp_path / f"{arch}__mesh_decode__2x2.json"
                          ).read_text())
        for key in ("mesh", "n_devices", "memory", "cost", "collectives",
                    "roofline", "fits", "model_flops_global",
                    "params_total", "attn_backend", "shard_fallback"):
            assert key in rec, key
        assert rec["mesh"] == "2x2" and rec["tp_plan"]["ssm"]
        assert sum(c["count"] for c in rec["collectives"].values()) > 0
        assert rec["collectives"]["all-gather"]["by_axis"]["model"][
            "count"] > 0
    finally:
        del SHAPES["mesh_train"]


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH = "h2o-danube-1.8b", 16, 4


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)],
                         ids=["2x1", "1x2", "2x2"])
def test_traced_train_step_equals_the_real_ranks(shape):
    """Each rank of a tracing mesh traces the sharded train step of
    reduced h2o-danube (2D MXSF on the kernel datapath, remat "dots") on
    ``meta`` (``dryrun.mesh_train_cell``), and counts what the same rank
    of a gloo world runs: each kernel's launches, the collectives by kind
    and axis with their operand bytes, the argument bytes (state slices
    and batch rows)."""
    real = run_ranks(TR.run, math.prod(shape), [(
        "train_counts", (shape, TRAIN_ARCH, "2d", TRAIN_SEQ, TRAIN_BATCH),
        {})])
    cfg = get_config(TRAIN_ARCH).reduced().replace(n_layers=TR.LAYERS)
    tcfg, ocfg = dryrun.cell_config(TRAIN_ARCH)
    cell = ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH, "train")
    for rank, (got,) in enumerate(real):
        mesh = mesh_lib.make_tracing_mesh(shape, rank)
        inputs, run, info = dryrun.mesh_train_cell(
            cfg, cell, TR.POLICIES["2d"], mesh, tcfg, ocfg)
        with cost.count(inputs) as counter:
            out = run(inputs)
        traced = counter.summary(out, mesh.shape)
        assert _as_ranks_count(traced) == {
            "launches": got["launches"], "collectives": got["collectives"]}
        assert traced["memory"]["argument_bytes"] == got["argument_bytes"]
        assert tuple(info["tp_plan"].values())[:3] == (True, True, True)
    kinds = set(got["collectives"])
    assert ("reduce-scatter" in kinds) == (shape[0] > 1)
    assert got["collectives"]["all-reduce"]["model"][0] > 0


@pytest.mark.parametrize("shape", [(1, 2), (1, 3)], ids=["1x2", "1x3"])
def test_traced_moe_train_step_equals_the_real_ranks(shape):
    """The sharded train step of reduced qwen2-moe (12 live experts of 16
    rows; on (1, 3) split 6 / 6 / 4 and 2 zero rows): each rank of a
    tracing mesh counts what the same rank of a gloo world runs --
    launches, collectives by kind, axis and operand bytes (the experts'
    output gathers and the takes' gradient gathers among them, as many as
    ``chip_smoke.train_collectives`` counts) and argument bytes."""
    real = run_ranks(MTR.run, math.prod(shape), [(
        "train_counts", (shape, "2d", TRAIN_SEQ, TRAIN_BATCH), {})])
    cfg = MTR.config(MTR.QWEN).replace(compute_dtype=get_config(
        MTR.QWEN).compute_dtype)
    tcfg, ocfg = dryrun.cell_config(MTR.QWEN)
    cell = ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH, "train")
    for rank, (got,) in enumerate(real):
        mesh = mesh_lib.make_tracing_mesh(shape, rank)
        inputs, run, info = dryrun.mesh_train_cell(
            cfg, cell, TR.POLICIES["2d"], mesh, tcfg, ocfg)
        with cost.count(inputs) as counter:
            out = run(inputs)
        traced = counter.summary(out, mesh.shape)
        assert _as_ranks_count(traced) == {
            "launches": got["launches"], "collectives": got["collectives"]}
        assert traced["memory"]["argument_bytes"] == got["argument_bytes"]
        assert info["tp_plan"]["experts"]
    want = CS.train_collectives(cfg, TR.POLICIES["2d"], tcfg,
                                dict(zip(("data", "model"), shape)),
                                TRAIN_SEQ)
    assert {k: {a: v[0] for a, v in by.items()}
            for k, by in got["collectives"].items()} == want


def _jax_train_argument_bytes(arch, cell, sizes, names):
    """Per-device bytes of a JAX train cell's inputs under its rules: the
    state under ``state_shardings``, the batch under ``batch_shardings``."""
    rules = JML.MeshRules(JaxAbstractMesh(sizes, names))
    cfg = jax_config(arch).reduced().replace(n_layers=LAYERS)
    state = jax.eval_shape(lambda: JT.init_state(
        jax.random.PRNGKey(0), cfg, JA.OptConfig()))
    batch = JM.train_specs(cfg, JShape(cell.name, cell.seq_len,
                                       cell.global_batch, cell.kind))
    ax = dict(zip(names, sizes))
    return (_jax_bytes(state, JML.state_shardings(rules, state), ax)
            + _jax_bytes(batch, JML.batch_shardings(rules, batch), ax))


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma2-2b"])
def test_train_cell_record_on_the_production_mesh(arch):
    """A reduced dense decoder's train cell on 16x16: the JAX record's
    keys, the backward's reduce-scatters over the data axis, and the
    argument bytes of the JAX package's train-state and batch specs."""
    cell = ShapeConfig("mesh_train16", 16, 32, "train")
    SHAPES[cell.name] = cell
    try:
        pol = dryrun.cell_policy("mxsf", "train", backend="cuda")
        tcfg, ocfg = dryrun.cell_config(arch)
        rec = dryrun.lower_cell(
            arch + "-reduced", cell.name, pol, tcfg, ocfg,
            mesh=dryrun.mesh_of("16x16"), trace="whole",
            cfg=get_config(arch).reduced().replace(n_layers=LAYERS))
    finally:
        del SHAPES[cell.name]
    for key in ("mesh", "n_devices", "memory", "cost", "collectives",
                "collective_axes", "roofline", "fits", "model_flops_global",
                "model_flops_per_device", "useful_flops_fraction",
                "params_total", "params_active", "policy", "train",
                "tp_plan", "batch_rows"):
        assert key in rec, key
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert set(rec["collectives"]) == set(cost.COLLECTIVES)
    rs = rec["collectives"]["reduce-scatter"]
    assert rs["count"] > 0 and rs["by_axis"]["data"]["count"] == rs["count"]
    assert rec["batch_rows"] == [0, 2]
    assert rec["memory"]["argument_bytes"] == _jax_train_argument_bytes(
        arch, cell, (16, 16), ("data", "model"))


def test_moe_train_cell_record_on_the_production_mesh():
    """Reduced qwen2-moe's train cell on 16x16 (its 16 expert rows one a
    model rank): the JAX record's keys, the argument bytes of the JAX
    package's train-state and batch specs, and the model axis's
    all-gathers: each MoE layer's gather of its experts' outputs (run
    again in the remat's recompute) and the take's gather of their input
    gradient, as ``chip_smoke.train_collectives`` counts them."""
    arch = "qwen2-moe-a2.7b"
    cell = ShapeConfig("mesh_train16", 16, 32, "train")
    cfg = get_config(arch).reduced().replace(n_layers=LAYERS)
    pol = dryrun.cell_policy("mxsf", "train", backend="cuda")
    tcfg, ocfg = dryrun.cell_config(arch)
    SHAPES[cell.name] = cell
    try:
        rec = dryrun.lower_cell(arch + "-reduced", cell.name, pol, tcfg,
                                ocfg, mesh=dryrun.mesh_of("16x16"),
                                trace="whole", cfg=cfg)
    finally:
        del SHAPES[cell.name]
    for key in ("mesh", "n_devices", "memory", "cost", "collectives",
                "collective_axes", "roofline", "fits", "model_flops_global",
                "params_total", "params_active", "policy", "train",
                "tp_plan", "batch_rows"):
        assert key in rec, key
    assert rec["tp_plan"]["experts"] and rec["n_devices"] == 256
    assert rec["memory"]["argument_bytes"] == _jax_train_argument_bytes(
        arch, cell, (16, 16), ("data", "model"))
    want = CS.train_collectives(cfg, pol, tcfg, {"data": 16, "model": 16},
                                cell.seq_len)
    gathers = rec["collectives"]["all-gather"]["by_axis"]["model"]["count"]
    assert gathers == want["all-gather"]["model"] >= 3 * LAYERS
    assert rec["collectives"]["reduce-scatter"]["by_axis"]["data"][
        "count"] == want["reduce-scatter"]["data"]


def test_tracing_mesh_collectives_have_real_shapes():
    mesh = shd.TracingMesh((2, 4), ("data", "model"), rank=6)
    assert mesh.tracing and mesh.rank == 6
    assert (mesh.coord("data"), mesh.coord("model")) == (1, 2)
    x = torch.empty((3, 5), dtype=torch.bfloat16, device="meta")
    shd.reset_counts()
    y = shd.all_gather(x, ("data", "model"), 1, mesh=mesh)
    z = shd.all_reduce(x.float(), "model", mesh=mesh)
    assert tuple(y.shape) == (3, 40) and y.is_meta
    assert tuple(z.shape) == (3, 5)
    got = shd.counts()
    assert got["all_gather"]["axes"] == {
        "model": {"calls": 1, "bytes": 30, "size": 4},
        "data": {"calls": 1, "bytes": 120, "size": 2}}
    assert got["all_reduce"]["bytes"] == 60
    assert shd.per_device_nbytes({"x": x}, "meta", mesh) == {
        "rank6:meta": 30}
    links = cost.axis_links(mesh.shape)
    assert links["model"]["link"] == links["data"]["link"] == "nvlink"
    big = cost.axis_links({"data": 16, "model": 16})
    assert big["model"]["bytes_per_s"] == big["data"]["bytes_per_s"] \
        == cost.NIC_BYTES_PER_S


def test_tracing_mesh_reduce_scatter_has_real_shapes():
    """A reduce-scatter over several axes runs major axis first, each
    call handed what the one before kept, recorded as the JAX kind
    "reduce-scatter" with its operand bytes; only ``meta`` tensors."""
    mesh = shd.TracingMesh((2, 4), ("data", "model"), rank=6)
    x = torch.empty((8, 6), dtype=torch.float32, device="meta")
    shd.reset_counts()
    y = shd.reduce_scatter(x, ("data", "model"), 0, mesh=mesh)
    assert tuple(y.shape) == (1, 6) and y.is_meta
    assert shd.counts()["reduce_scatter"]["axes"] == {
        "data": {"calls": 1, "bytes": 192, "size": 2},
        "model": {"calls": 1, "bytes": 96, "size": 4}}
    assert cost.collectives_by_axis(shd.counts()) == {
        "reduce-scatter": {"data": [1, 192], "model": [1, 96]}}
    with pytest.raises(RuntimeError, match="only meta tensors"):
        shd.reduce_scatter(torch.ones((8, 6)), "data", 0, mesh=mesh)


def test_tracing_mesh_takes_only_meta_tensors():
    """A tracing mesh sends nothing, so a real tensor on it would come
    back unsummed or gathered from empty parts: its collectives and an
    engine on it refuse anything but ``meta``; the production meshes and
    ``mesh_of`` build it from one table of axis names."""
    mesh = dryrun.mesh_of("2x2")
    x = torch.ones((2, 4))
    for call in (lambda: shd.all_reduce(x, "model", mesh=mesh),
                 lambda: shd.all_gather(x, "model", 1, mesh=mesh),
                 lambda: shd.broadcast(x, "data", 0, mesh=mesh)):
        with pytest.raises(RuntimeError, match="only meta tensors"):
            call()
    cfg = R.config(d_head=32, n_layers=2)
    with pytest.raises(ValueError, match="only on meta tensors"):
        E.ServeEngine(cfg, M.init_params(cfg, torch.Generator(), "meta"),
                      R.BLOCK64, mesh=mesh, device="cpu", slots=2,
                      max_len=8)
    for name, pod in (("16x16", False), ("2x16x16", True)):
        prod = mesh_lib.make_production_mesh(multi_pod=pod, trace_rank=0)
        got = dryrun.mesh_of(name)
        assert prod.tracing and prod.shape == got.shape
        assert prod.coords == got.coords
    assert tuple(prod.shape) == mesh_lib.MESH_AXES[3]


def test_whole_prompt_write_into_a_position_sharded_cache():
    """A prompt wider than the columns a rank holds lands on each rank's
    columns as one device writes them (the prefill cell on a mesh whose
    cache splits its position axis)."""
    g = torch.Generator().manual_seed(0)
    W, S, n = 16, 12, 4
    upd = torch.randn((2, S, 3), generator=g)
    for slot, wl in ((torch.tensor([0, 2]), None),
                     (torch.tensor([0, 3]), torch.tensor([12, 9]))):
        whole = torch.zeros((2, W, 3))
        blocks._write_cache(whole, upd, slot, wl)
        for r in range(n):
            buf = torch.zeros((2, W // n, 3))
            blocks._write_owned(buf, upd, slot, wl, W, r * W // n)
            assert torch.equal(buf, whole[:, r * W // n:(r + 1) * W // n])
