"""The SSM, hybrid and encoder-decoder families on a mesh: reduced mamba2,
zamba2 and whisper (float32) on gloo CPU ranks (``torch_dist``) against
the JAX package on one device, and the dry run's tracing mesh against
the ranks.

* Greedy tokens: the lockstep ``prefill`` and ``decode_step``s of
  ``engine.lockstep_dispatches`` (the first decode fed a seeded token) on
  (1, 2), (2, 1) and (2, 2), over the packed store (``MXSF_INFER`` with
  16-element blocks, the packed MXSF cache, the kernels' plain versions
  on CPU tensors).  On the value path (cached attention over the
  dequantized cache) they equal the JAX package's ``M.prefill`` /
  ``M.decode_step`` on the same weights (``convert``) and inputs, jitted;
  on the kernel path (the attention kernel keeps f32 probabilities where
  the value path quantizes them, so a near-tie may fall the other way;
  ``test_torch_hybrid.py`` holds those calls against the JAX kernel)
  they equal the port's one-device run.  The first logits (the
  prefill's, whisper's first decode step's) of the unquantized path
  (``BF16``, an f32 value cache) lie within ``LOGIT_RTOL`` of the largest
  logit of one device's: the row-parallel linears and the SSD's gated
  norm sum their f32 partials over the model axis, a different order of
  the same products.  On an MX path that reorder may flip a code of the
  next quantized operand (one row of reduced zamba2 on (1, 2) moves by
  2.5e-4 of its scale after the first SSD layer where the other moves
  by 3.5e-8), so its logits are not held to ``LOGIT_RTOL``.
* Bytes: each rank's store and cache bytes equal the bytes one device
  holds of the same leaves under the JAX package's specs (``MeshRules``,
  ``cache_shardings`` on ``jax.sharding.AbstractMesh``), exactly.
* The per-segment take of in_proj (``ssd._use_segments``) gives the
  one-device codes and scales of the rank's columns, bit for bit.
* The exact gate: on (1, 2) each rank's greedy tokens and first logits
  on the kernel path equal, bit for bit, one device running the ranks'
  plan at a rank's thread count (``chip_smoke.emulating``: the kernels'
  plain versions at the ranks' shapes, the SSD mixer once a rank on its
  heads with the gated norm's f32 sums of squares added in rank order,
  whisper's value-path attention on each rank's heads and its cross K/V
  on each rank's columns); a misstated plan (the row-parallel partials
  rounded to bf16 before their sum, each rank's SSD heads normalised by
  its own half of d_inner) does not; ``chip_smoke.emulated_plan`` states
  ``blocks.tp_plan`` of the three families.
* The tracing mesh (``dryrun.lockstep_counts``, on ``meta``) counts what
  a gloo rank runs in one prefill and one decode (kernel calls by
  kernel, collectives by kind and axis with their operand bytes), and
  every rank counts what rank 0 counts; the layer-period trace of each
  family's prefill and decode cells on (2, 2) equals a whole trace.
"""
import concurrent.futures
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs.base import get_config as jax_config
from repro.core.policy import MXSF_INFER as JAX_INFER
from repro.launch import mesh as JML
from repro.models import model as JM
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.base import get_config as torch_config
from repro_torch.core import sharding as shd
from repro_torch.launch import cost, dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import blocks
from repro_torch.models import model as M
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import step as T

import chip_smoke as CS
import torch_family_ranks as F
from torch_dist import run_ranks
from torch_sharded_ranks import LOGIT_RTOL

torch.set_num_threads(2)

ARCHS = list(F.ARCHS)
SHAPES = [(1, 2), (2, 1), (2, 2)]
SHAPE_IDS = ["1x2", "2x1", "2x2"]
JPOL = JAX_INFER.replace(block_1d=16, kv_cache_fmt="mxsf")  # value path
JAX_PACK = jax.jit(JM.pack_model_params, static_argnums=(0, 2))
JAX_PREFILL = jax.jit(JM.prefill, static_argnums=(3, 4))
JAX_DECODE = jax.jit(JM.decode_step, static_argnums=(4, 5))


def _jcfg(arch):
    return jax_config(arch).reduced().replace(compute_dtype="float32")


def _inputs(cfg, seed):
    """Seeded inputs: the prompt tokens (whisper: frames) and the token
    the first decode step is fed."""
    rng = np.random.default_rng(seed)
    feed = rng.integers(0, cfg.vocab, (F.BATCH, 1)).astype(np.int32)
    if cfg.family == "encdec":
        return {"frames": (rng.standard_normal(
            (F.BATCH, cfg.enc_seq, cfg.d_model)) * 0.5).astype(np.float32),
            "feed": feed}
    return {"tokens": rng.integers(0, cfg.vocab, (F.BATCH, F.PROMPT)
                                   ).astype(np.int32), "feed": feed}


def _jax_greedy(cj, packed, inp):
    """The JAX package's greedy tokens and first logits, as
    ``torch_family_ranks.greedy`` runs the port."""
    cache = JM.init_cache(cj, F.BATCH, F.MAX_LEN, ring=False, kv_fmt="mxsf")
    key = "frames" if cj.family == "encdec" else "tokens"
    logits, cache = JAX_PREFILL(packed, {key: inp[key]}, cache, cj, JPOL)
    first = None if logits is None else np.asarray(logits)
    out = [] if logits is None else [first.argmax(-1)]
    tok, pos = inp["feed"], 0 if cj.family == "encdec" else F.PROMPT
    while len(out) < F.NEW:
        logits, cache = JAX_DECODE(packed, tok, cache, pos, cj, JPOL)
        first = np.asarray(logits) if first is None else first
        tok = np.asarray(logits).argmax(-1)[:, None].astype(np.int32)
        out.append(tok[:, 0])
        pos += 1
    return np.stack(out, 1).tolist(), first


def _jax_bytes(tree, shardings, sizes):
    """Bytes one device holds of a JAX tree under its shardings (a dim
    split over axes of n devices holds ceil(dim / n) rows)."""
    total = 0
    for leaf, ns in zip(jax.tree.leaves(tree), jax.tree.leaves(shardings)):
        local = shd.shard_shape(tuple(leaf.shape), tuple(ns.spec), sizes,
                                tuple(range(len(leaf.shape))))
        total += math.prod(local) * leaf.dtype.itemsize
    return total


def _jax_rank_bytes(cj, packed, shape):
    names = ("data", "model")
    rules = JML.MeshRules(JaxAbstractMesh(shape, names))
    sizes = dict(zip(names, shape))
    cache = jax.eval_shape(lambda: JM.init_cache(
        cj, F.BATCH, F.MAX_LEN, ring=False, kv_fmt="mxsf"))
    return (_jax_bytes(packed, rules.param_sharding_tree(packed), sizes),
            _jax_bytes(cache, JML.cache_shardings(rules, cache, F.BATCH),
                       sizes))


@pytest.fixture(scope="module")
def ref():
    out = {"np_params": {}, "inputs": {}, "count_inputs": {}}
    for arch in ARCHS:
        cj = _jcfg(arch)
        params = JM.init_params(jax.random.PRNGKey(0), cj)
        packed = JAX_PACK(cj, params, JPOL)
        inp = _inputs(cj, 0)
        out["np_params"][arch] = jax.tree.map(np.asarray, params)
        out["inputs"][arch] = inp
        out["count_inputs"][arch] = _inputs(F.count_config(arch), 1)
        out[arch] = dict(zip(("tokens", "first"),
                             _jax_greedy(cj, packed, inp)))
        npp = out["np_params"][arch]
        out[arch]["port"] = F.one_device(arch, npp, inp)[0]
        out[arch]["port_value"] = F.one_device(arch, npp, inp, F.VALUE)[0]
        out[arch]["port_f32"] = F.one_device(
            arch, npp, inp, F.F32["pol"], F.F32["kv_fmt"], F.F32["dtype"])[1]
        out[arch]["bytes"] = {s: _jax_rank_bytes(cj, packed, s)
                              for s in SHAPES}
    return out


@pytest.fixture(scope="module")
def worlds(ref):
    """Every rank's results by (arch, mesh): a world of two ranks runs
    (1, 2) and (2, 1), one of four (2, 2), both at once."""
    args = (ref["np_params"], ref["inputs"], ref["count_inputs"])
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(run_ranks, F.world, world, shapes, *args)
                for world, shapes in ((2, [(1, 2), (2, 1)]), (4, [(2, 2)]))]
        results = [r.result() for r in runs]
    ranks = {}
    for world in results:
        for rank, res in enumerate(world):
            for key, val in res.items():
                ranks.setdefault(key, {})[rank] = val
    return ranks


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_family_tokens_equal_jax(ref, worlds, arch, shape):
    want = ref[arch]
    assert want["port_value"] == want["tokens"]
    scale = float(np.abs(want["port_f32"]).max())
    for rank, got in worlds[(arch, shape)].items():
        assert got["tokens_value"] == want["tokens"], (arch, shape, rank)
        assert got["tokens"] == want["port"], (arch, shape, rank)
        np.testing.assert_allclose(got["first"], want["port_f32"], rtol=0,
                                   atol=LOGIT_RTOL * scale)
    plan = got["plan"]
    assert plan["ssm"] == (arch != "whisper-medium")
    assert plan["heads"] == (arch != "mamba2-780m") and plan["vocab"]
    assert got["shard_fallback"] is None
    assert got["attn_backend"] == "cuda-packed"


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_family_bytes_equal_the_jax_specs(ref, worlds, arch,
                                                  shape):
    store, cache = ref[arch]["bytes"][shape]
    for rank, got in worlds[(arch, shape)].items():
        assert (got["store_bytes"], got["cache_bytes"]) == (store, cache), \
            (arch, shape, rank)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_in_proj_segment_take_is_exact(worlds, arch, shape):
    cfg = F.config(arch)
    n = (2 * cfg.d_inner + cfg.ssm_heads) // shape[1] + \
        2 * cfg.ssm_ngroups * cfg.ssm_state
    for rank, got in worlds[(arch, shape)].items():
        codes, scales, local = got["take"]
        assert codes and scales, (arch, shape, rank)
        assert tuple(local) == (cfg.d_model, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_families_1x2_ranks_equal_their_emulated_plan_bitwise(ref, worlds,
                                                              arch):
    """The (1, 2) ranks' greedy tokens and first logits on the kernel path
    equal, bit for bit, one device running the same plan at the ranks'
    thread count (``chip_smoke.emulating``), and their plan is
    ``chip_smoke.emulated_plan``'s."""
    toks, first = F.emulated(arch, ref["np_params"][arch],
                             ref["inputs"][arch])
    plan = CS.emulated_plan(F.config(arch), F.POL, 2)
    for rank, got in worlds[(arch, (1, 2))].items():
        assert got["plan"] == plan, rank
        np.testing.assert_array_equal(got["first_mx"], first)
        assert got["tokens"] == toks, rank


@pytest.mark.parametrize("arch,planted", [
    (arch, "bf16_partials") for arch in ARCHS] + [
    (arch, "local_norm") for arch in ("mamba2-780m", "zamba2-7b")])
def test_families_misstated_plan_fails_the_exact_gate(ref, worlds, arch,
                                                      planted):
    """The negative controls of the families' exact gate: the emulation
    with the row-parallel partials (out_proj's too) rounded to bf16
    before their sum, or each rank's SSD heads normalised by the mean
    over its own half of d_inner, gives other first logits than the
    (1, 2) ranks'."""
    _, first = F.emulated(arch, ref["np_params"][arch], ref["inputs"][arch],
                          planted)
    for rank, got in worlds[(arch, (1, 2))].items():
        assert not np.array_equal(got["first_mx"], first), rank


@pytest.mark.parametrize("arch", ARCHS)
def test_emulated_plan_states_the_families_plan(arch):
    """``chip_smoke.emulated_plan`` (from the config and the block size
    alone) equals ``blocks.tp_plan`` (from the store's leaves) field by
    field for the SSM, hybrid and encoder-decoder at full and reduced
    width, 16- and 64-element blocks, on 2 and 4 model ranks."""
    for cfg in (torch_config(arch), torch_config(arch).reduced()):
        for block in (16, 64):
            pol = F.POL.replace(block_1d=block)
            for tp in (2, 4):
                want = blocks.tp_plan(cfg, pol, M.packed_model_specs(
                    cfg, pol), tp)._asdict()
                assert CS.emulated_plan(cfg, pol, tp) == want, \
                    (cfg.name, block, tp)


def _traced(arch, shape, rank):
    cfg = F.count_config(arch)
    batch = F.inputs(cfg, _inputs(cfg, 1))[0]
    return dryrun.lockstep_counts(cfg, F.BLOCK64,
                                  mesh_lib.make_tracing_mesh(shape, rank),
                                  batch, F.MAX_LEN)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_traced_lockstep_dispatches_equal_the_ranks(worlds, arch, shape):
    ranks = worlds[(arch, shape, "counts")]
    traced = _traced(arch, shape, 0)
    assert traced["tp_plan"]["heads"] == (arch != "mamba2-780m")
    for rank, got in ranks.items():
        for kind in ("prefill", "decode"):
            summ = traced[kind]
            want = {"launches": {k: v for k, v in
                                 summ["cost"]["launches"].items() if v},
                    "collectives": cost.collectives_by_axis(
                        summ["collectives"])}
            assert got[kind] == want, (arch, shape, rank, kind)
        assert (got["store_bytes"], got["cache_bytes"]) == \
            (traced["store_bytes"], traced["cache_bytes"])
    assert traced["prefill"]["memory"]["argument_bytes"] == \
        traced["store_bytes"] + traced["cache_bytes"]
    assert "mxsf_fused_matmul" in want["launches"]
    assert "all-reduce" in want["collectives"]
    if arch != "mamba2-780m":
        assert "mxsf_attention" in want["launches"]


PERIOD_CELLS = {"decode": ShapeConfig("d", 16, 4, "decode"),
                "prefill": ShapeConfig("p", 16, 4, "prefill")}
PERIOD_CFGS = {"mamba2-780m": {}, "zamba2-7b": {"n_layers": 13},
               "whisper-medium": {"n_enc_layers": 4}}


@pytest.mark.parametrize("kind", list(PERIOD_CELLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_family_layer_period_trace_equals_a_whole_trace(arch, kind):
    cfg = F.config(arch, **PERIOD_CFGS[arch]).replace(
        compute_dtype="bfloat16")
    shape = PERIOD_CELLS[kind]
    pol = dryrun.cell_policy("mxsf", kind, kv_cache="mxsf", backend="cuda")
    args = (cfg, shape, pol, T.TrainConfig(), OptConfig())
    mesh = dryrun.mesh_of("2x2")
    whole, _, w = dryrun.trace_cell(*args, mesh=mesh, trace="whole")
    period, info, p = dryrun.trace_cell(*args, mesh=mesh, trace="period")
    assert w["mode"] == "whole" and p["mode"] == "period"
    assert p["periods"] == 4 and p["other_layers"] == (
        1 if arch == "zamba2-7b" else 0)
    assert period == whole
    assert info["tp_plan"]["ssm"] == (arch != "whisper-medium")
