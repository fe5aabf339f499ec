"""The sharded train step (DP, FSDP, TP on ``torch.distributed``) against
the port's one-device step and against the JAX package's, on gloo worlds.

Reduced h2o-danube-1.8b and reduced gemma2-2b (softcaps, alternating SWA,
post-norms, a tied head) at 2 layers, seq 32, global batch 4, on meshes
(1, 1), (2, 1), (1, 2) and (2, 2) of ("data", "model"); each rank runs
``tests/torch_train_ranks.py`` (JAX-free).  The MX layouts use 16-element
1D blocks, so the reduced widths split over the model axis.

Tolerances, and why:

* The exact plumbing check: the unquantized policy in f32.  The sharded
  gradient function's loss and every rank's gradient slice equal the
  one-device step's within 1e-5 relative (the loss; each leaf's largest
  deviation over its largest |value|): only f32 summation order differs
  (the DP sums of the loss and of each weight's gradient, the TP sums of
  the row-parallel partials and of the column entries' input gradients),
  ~1e-6 here.  A dropped column-entry all-reduce or a doubled DP
  reduction moves them by O(1).  On (1, 1) they are equal bit for bit.
* Leaves replicated over the model axis get bit-equal gradients on every
  model rank (their inputs' gradients come out of all-reduces, whose
  result every rank of the group holds alike).
* ``MXSF_TRAIN`` in 2D and in the 1D layout on (2, 2), one train step
  from the JAX package's state (converted from numpy) on its
  ``lm_batch``, against its one-device jitted ``make_train_step``: the
  tolerances of ``test_torch_train.py``'s teacher-forced MXSF steps
  (ROADMAP.md, "Chaos under MX": one f32 ulp on an MX rounding midpoint
  flips a code): loss rtol 1e-5, grad norm rtol 1e-3, moments within 5e-2
  and the update within 2e-1 relative L2, whole leaves assembled from the
  ranks' slices.
* One AdamW step on the unquantized policy against the one-device step
  (clipping active, bf16 moments, bf16 parameters with f32 masters):
  loss and grad norm rtol 1e-5; the update within 1e-3 and the moments
  within 1e-4 relative L2 (``test_torch_train.py``'s bounds: the first
  update is +-lr for any |g| >> eps); bf16 moments within 2^-8 (one bf16
  rounding).  The gradients of bf16 parameters are bf16, and a mesh
  rounds each partial sum it reduces where one device rounds the whole
  sum once (~3e-3 relative L2 apart here): their grad norm within 2^-8
  relative, the moments within 2^-6 (v squares the gradient, doubling
  its relative error), the stored bf16 parameters within one bf16 ulp
  of the leaf's largest value, and the masters' update within 5e-2 -- a
  few elements a leaf round to a zero gradient on one side only, and
  AdamW's first update moves those by lr (~2.5% relative L2 here).
* Everything the JAX package compares bitwise stays bitwise: the state
  saved on (2, 1) and restored onto (1, 2), every slice.
* The exact gate, bit for bit: each rank against the one-device
  emulation of its plan (``chip_smoke.emulate_train`` at the ranks' one
  thread; ``torch_train_ranks.emulated``) -- the plan, loss, every
  gradient slice and, after a step, the clip norm and every params /
  moments slice -- on the f32 gradient cases of (2, 1), (1, 2) and
  (2, 2), three MXSF steps at bf16 activations (the card's dtype, so a
  bf16 column entry differs from an f32 one) and the (2, 2) steps from
  the JAX package's state.  Each misstatement of the plan must miss
  every rank.
"""
import math

import jax
import numpy as np
import pytest
import torch

import chip_smoke as CS
import torch_train_ranks as R
from repro.configs.base import get_config as jax_config
from repro.core.policy import MXSF_TRAIN as JAX_TRAIN
from repro.data.pipeline import lm_batch as jax_lm_batch
from repro.optim import adamw as JA
from repro.train import step as JT
from repro_torch.configs.base import get_config
from repro_torch.core import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import step as T
from torch_dist import run_ranks

torch.set_num_threads(2)

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
IDS = ["1x1", "2x1", "1x2", "2x2"]
ARCH = "h2o-danube-1.8b"
CLIP = OptConfig(warmup_steps=2, total_steps=10, clip_norm=0.05)
STEP_CASES = {  # one AdamW step on (2, 2) against the one-device step
    "clip": dict(ocfg=CLIP),
    "bf16_moments": dict(ocfg=R.OCFG.replace(moment_dtype="bfloat16")),
    "bf16_params": dict(param_dtype="bfloat16")}
# (update, moments) relative L2 of each: see the module docstring
STEP_TOLS = {"clip": (1e-3, 1e-4), "bf16_moments": (1e-3, 2.0 ** -8),
             "bf16_params": (5e-2, 2.0 ** -6)}
JAX_LAYOUTS = {"2d": JAX_TRAIN,
               "1d": JAX_TRAIN.replace(block_mode="1d", block_1d=16,
                                       quantize_bwd=True)}
# the MXSF steps of the world of two at bf16 activations (the card's), each
# held bit for bit to the emulation of its plan: (kind, mesh) -> layout
MX_CASES = {("mx_2d", (1, 2)): "2d", ("mx_1d", (1, 2)): "1d",
            ("mx_2d", (2, 1)): "2d"}
# the exact gate's cases: every grads case on a mesh of two ranks or
# more, the MXSF steps and the (2, 2) steps from the JAX package's state
EXACT_CASES = ([("grads", s, a) for s in MESHES[1:] for a in R.ARCHS]
               + [(k, s, ARCH) for k, s in MX_CASES]
               + [(f"jax_{n}", (2, 2), ARCH) for n in JAX_LAYOUTS])
# each misstatement of the plan and the case whose ranks it must miss
CONTROLS = {"bf16_partials": ("mx_2d", (1, 2)),
            "bf16_head_entry": ("mx_2d", (1, 2)),
            "local_dp_mean": ("mx_2d", (2, 1))}


def _jax_state_and_batch():
    cfg = jax_config(ARCH).reduced().replace(n_layers=R.LAYERS,
                                             compute_dtype="float32")
    state = JT.init_state(jax.random.PRNGKey(0), cfg, JA.OptConfig(
        warmup_steps=2, total_steps=10))
    toks, labs = jax_lm_batch(0, 0, R.BATCH, R.SEQ, cfg.vocab)
    return cfg, state, {"tokens": toks, "labels": labs}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's state and batch (numpy) and its one-device jitted
    step of each layout from them: (numpy state, numpy batch, {layout:
    (metrics, new state)})."""
    cfg, state, batch = _jax_state_and_batch()
    np_state = jax.tree.map(np.asarray, state)
    out = {}
    for name, pol in JAX_LAYOUTS.items():
        fn = jax.jit(JT.make_train_step(cfg, pol, JA.OptConfig(
            warmup_steps=2, total_steps=10), JT.TrainConfig()))
        new, metrics = fn(state, batch)
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     jax.tree.map(lambda a: np.asarray(a, np.float32), new))
    return np_state, {k: np.asarray(v) for k, v in batch.items()}, out


def _todo(world, np_state, np_batch, ckpt_dir):
    """What every rank of a world of ``world`` runs."""
    todo = [("case", ("grads", s), dict(arch=a)) for s in MESHES
            if math.prod(s) == world for a in R.ARCHS]
    todo += [("case", ("step", s), dict(step=True)) for s in MESHES
             if math.prod(s) == world]
    if world == 2:
        todo += [("case", ("micro", (2, 1)),
                  dict(tk=dict(microbatches=2))),
                 ("ckpt_round", (ckpt_dir,), {})]
        todo += [("case", key, dict(policy=layout, step=True,
                                    dtype="bfloat16"))
                 for key, layout in MX_CASES.items()]
    if world == 4:
        batch = {k: torch.tensor(v) for k, v in np_batch.items()}
        todo += [("case", (f"jax_{name}", (2, 2)), dict(
            policy=name, np_state=np_state, batch=batch, step=True))
            for name in JAX_LAYOUTS]
        todo += [("case", (name, (2, 2)), dict(step=True, **kw))
                 for name, kw in STEP_CASES.items()]
    return todo


@pytest.fixture(scope="module")
def runs(jax_side, tmp_path_factory):
    """Every world's results, ``{(kind, shape, arch): [rank results]}``,
    and the checkpoint round's per rank."""
    np_state, np_batch, _ = jax_side
    ckpt_dir = str(tmp_path_factory.mktemp("train_ckpt"))
    out, ckpt = {}, None
    for world in (1, 2, 4):
        todo = _todo(world, np_state, np_batch, ckpt_dir)
        res = run_ranks(R.run, world, todo)
        for i, (name, args, kw) in enumerate(todo):
            per_rank = [r[i] for r in res]
            if name == "ckpt_round":
                ckpt = per_rank
            else:
                out[args[0], args[1], kw.get("arch", ARCH)] = per_rank
    return out, ckpt


def _one_device(arch=ARCH, tk=None, ocfg=None, param_dtype="float32",
                step=False):
    """The port's one-device gradient function or train step on the same
    seed-0 state and batch: (metrics, numpy trees)."""
    cfg = R.config(arch)
    ocfg = ocfg or R.OCFG
    state = T.init_state(torch.Generator().manual_seed(0), cfg, ocfg,
                         param_dtype, device="cpu")
    tcfg = T.TrainConfig(**(tk or {}))
    if not step:
        metrics, grads = T.make_grad_fn(cfg, R.POLICIES["f32"], tcfg)(
            state["params"], R.batch_of(arch))
        return {k: float(v) for k, v in metrics.items()}, R.numpy_tree(grads)
    state, metrics = T.make_train_step(cfg, R.POLICIES["f32"], ocfg, tcfg)(
        state, R.batch_of(arch))
    trees = {k: R.numpy_tree(state["opt"][k]) for k in ("m", "v")}
    trees["state"] = R.numpy_tree(state["params"])
    if "master" in state["opt"]:
        trees["master"] = R.numpy_tree(state["opt"]["master"])
    return {k: float(v) for k, v in metrics.items()}, trees


def _worst(got: dict, want: dict) -> float:
    """The largest leaf deviation over the leaf's largest |value|."""
    return max(float(np.abs(got[k] - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-30)) for k in want)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assembled(per_rank, key, shape, specs):
    """Whole leaves from the ranks' slices of ``key`` (replicated slices
    overlap, alike)."""
    out = {}
    for r in per_rank:
        mesh = shd.Mesh(dict(zip(("data", "model"), shape)),
                        coords=r["coords"])
        for k, v in r[key].items():
            if k not in out:
                full = tuple(n * shd.axis_size(e, mesh.shape) for n, e in
                             zip(v.shape, tuple(specs[k]) + (None,) * 8))
                out[k] = np.zeros(full, np.float32)
            out[k][shd.shard_slices(out[k].shape, specs[k], mesh)] = v
    return out


# ---------------------------------------------------------------------------
# the exact plumbing check
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=IDS)
@pytest.mark.parametrize("arch", R.ARCHS)
def test_grads_match_one_device(runs, arch, shape):
    metrics, want = _one_device(arch)
    specs = R.specs_by_path(R.config(arch), shape=shape)
    for r in runs[0]["grads", shape, arch]:
        np.testing.assert_allclose(r["loss"], metrics["loss"], rtol=1e-5)
        got = r["grads"]
        assert sorted(got) == sorted(want)
        mine = R.slices(want, shape, r["coords"], specs)
        if shape == (1, 1):  # one rank: one device's bits
            for k in mine:
                np.testing.assert_array_equal(got[k], mine[k], err_msg=k)
            assert r["loss"] == metrics["loss"]
        assert _worst(got, mine) <= 1e-5, (r["coords"], _worst(got, mine))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("arch", R.ARCHS)
def test_tp_replicated_grads_equal_on_every_tp_rank(runs, arch, shape):
    specs = R.specs_by_path(R.config(arch), shape=shape)
    whole = [k for k, spec in specs.items()
             if "model" not in shd.split_axes(spec)]
    assert whole  # the norms at least
    ranks = runs[0]["grads", shape, arch]
    for r in ranks:
        for q in ranks:
            if q["coords"]["data"] == r["coords"]["data"]:
                for k in whole:
                    np.testing.assert_array_equal(r["grads"][k],
                                                  q["grads"][k], err_msg=k)


@pytest.mark.parametrize("kind", ["grads", "step", "micro", "jax_2d",
                                  "bf16_moments", "bf16_params"])
def test_state_bytes_equal_shard_nbytes(runs, kind):
    got = [v for (k, _, _), v in runs[0].items() if k == kind]
    assert got
    for per_rank in got:
        for r in per_rank:
            assert r["state_bytes"] == r["shard_nbytes"] > 0


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
@pytest.mark.parametrize("arch", R.ARCHS)
def test_collectives_equal_their_formula(runs, arch, shape):
    mesh = dict(zip(("data", "model"), shape))
    want = CS.train_collectives(R.config(arch), R.POLICIES["f32"],
                                T.TrainConfig(), mesh, R.SEQ, step=False)
    for r in runs[0]["grads", shape, arch]:
        assert r["collectives"] == want
    if arch == ARCH:  # the whole step: the clip norm's sums too
        want = CS.train_collectives(R.config(arch), R.POLICIES["f32"],
                                    T.TrainConfig(), mesh, R.SEQ)
        for r in runs[0]["step", shape, arch]:
            assert r["collectives"] == want
    if shape[1] > 1:
        assert want["all-reduce"]["model"] > 0
    if shape[0] > 1:
        assert want["reduce-scatter"]["data"] > 0


def test_microbatches_on_the_data_axis(runs):
    """Two microbatches on (2, 1): each rank's own rows split in two,
    another partition of the batch than one device's, with the same loss
    and gradients (every microbatch holds as many labels); the DP sums
    once a step, the loss's once a microbatch."""
    metrics, want = _one_device(tk=dict(microbatches=2))
    specs = R.specs_by_path(R.config(ARCH), shape=(2, 1))
    for r in runs[0]["micro", (2, 1), ARCH]:
        np.testing.assert_allclose(r["loss"], metrics["loss"], rtol=1e-5)
        assert _worst(r["grads"], R.slices(want, (2, 1), r["coords"],
                                           specs)) <= 1e-5
        assert r["collectives"] == CS.train_collectives(
            R.config(ARCH), R.POLICIES["f32"],
            T.TrainConfig(microbatches=2), {"data": 2, "model": 1}, R.SEQ,
            step=False)


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STEP_CASES))
def test_step_matches_one_device(runs, name):
    kw = STEP_CASES[name]
    metrics, want = _one_device(step=True, **kw)
    cfg = R.config(ARCH)
    ranks = runs[0][name, (2, 2), ARCH]
    specs = R.specs_by_path(cfg, kw.get("ocfg"), (2, 2))
    # a bf16 leaf's gradient is bf16: one device rounds each sum once, a
    # mesh each partial sum it reduces
    norm_tol = 2.0 ** -8 if name == "bf16_params" else 1e-5
    for r in ranks:
        np.testing.assert_allclose(r["loss"], metrics["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], metrics["grad_norm"],
                                   rtol=norm_tol)
        assert r["step_count"] == 1
    if name == "clip":  # the clip scale is below one
        assert metrics["grad_norm"] > CLIP.clip_norm
    p0 = R.numpy_tree(T.init_state(torch.Generator().manual_seed(0), cfg,
                                   R.OCFG, device="cpu")["params"])
    upd_tol, mom_tol = STEP_TOLS[name]
    keys = ["state", "m", "v"] + (["master"] if "master" in want else [])
    got = {k: _assembled(ranks, k, (2, 2), specs) for k in keys}
    for leaf, w in want["state"].items():
        if name == "bf16_params":  # the stored params: one bf16 ulp
            assert np.abs(got["state"][leaf] - w).max() <= \
                2.0 ** -7 * np.abs(w).max(), leaf
            base = want["master"][leaf]
            assert _rel(got["master"][leaf] - p0[leaf], base - p0[leaf]) \
                <= upd_tol, leaf
        else:
            assert _rel(got["state"][leaf] - p0[leaf], w - p0[leaf]) \
                <= upd_tol, leaf
        for m in ("m", "v"):
            assert _rel(got[m][leaf], want[m][leaf]) <= mom_tol, (m, leaf)


@pytest.mark.parametrize("layout", list(JAX_LAYOUTS))
def test_step_matches_jax(runs, jax_side, layout):
    """MXSF_TRAIN on (2, 2) from the JAX package's state and batch,
    against its one-device jitted step."""
    np_state, _, jax_steps = jax_side
    jm, jstate = jax_steps[layout]
    ranks = runs[0][f"jax_{layout}", (2, 2), ARCH]
    cfg = R.config(ARCH)
    specs = R.specs_by_path(cfg, shape=(2, 2))
    flat = lambda tree: {"/".join(p): np.asarray(v, np.float32)
                         for p, v in T._flatten(tree)}
    p0 = flat(np_state["params"])
    want = {"state": flat(jstate["params"]), "m": flat(jstate["opt"]["m"]),
            "v": flat(jstate["opt"]["v"])}
    got = {k: _assembled(ranks, k, (2, 2), specs) for k in want}
    for r in ranks:
        np.testing.assert_allclose(r["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], jm["grad_norm"],
                                   rtol=1e-3)
    for leaf, w in want["state"].items():
        assert _rel(got["state"][leaf] - p0[leaf], w - p0[leaf]) <= 2e-1, \
            leaf
        for m in ("m", "v"):
            assert _rel(got[m][leaf], want[m][leaf]) <= 5e-2, (m, leaf)


def test_checkpoint_saved_on_2x1_restores_on_1x2_bitwise(runs):
    """``ckpt.save(shardings=)`` on (2, 1) after one step, then
    ``ckpt.restore(shardings=)`` on (1, 2): every rank's slice of every
    leaf bitwise (the JAX package's ``test_elastic_reshard_restore``)."""
    rounds = runs[1]
    cfg = R.config(ARCH)
    saved_specs = R.specs_by_path(cfg, shape=(2, 1), tree=None)
    whole = {}
    for saved, _ in rounds:
        for k, v in saved.items():
            whole.setdefault(k, []).append(v)
    # the state on (2, 1): each leaf from its two slices (or replicated)
    full = {}
    for k, parts in whole.items():
        spec = saved_specs[k]
        split = [d for d, e in enumerate(spec) if "data" in
                 shd.axes_of(e)]
        full[k] = (np.concatenate(parts, axis=split[0]) if split
                   else parts[0])
    restore_specs = R.specs_by_path(cfg, shape=(1, 2), tree=None)
    for _, got in rounds:
        assert got["step"] == 1 and got["dtypes"] == ["torch.float32",
                                                      "torch.int32"]
        want = R.slices(full, (1, 2), got["coords"], restore_specs)
        for k, v in want.items():
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)


# ---------------------------------------------------------------------------
# the exact gate: each rank bit for bit against the emulation of its plan
# ---------------------------------------------------------------------------

def _emulation(kind, shape, arch, jax_side, planted=()):
    """The emulation of a case's program (``torch_train_ranks.emulated``)
    from the case's state and batch."""
    if kind.startswith("jax_"):
        np_state, np_batch, _ = jax_side
        return R.emulated(shape, arch, kind[4:], np_state=np_state, batch={
            k: torch.tensor(v) for k, v in np_batch.items()}, step=True,
            planted=planted)
    if kind == "grads":
        return R.emulated(shape, arch, planted=planted)
    return R.emulated(shape, arch, MX_CASES[kind, shape], step=True,
                      dtype="bfloat16", planted=planted)


@pytest.mark.parametrize("kind,shape,arch", EXACT_CASES,
                         ids=[f"{k}-{s[0]}x{s[1]}-{a.split('-')[0]}"
                              for k, s, a in EXACT_CASES])
def test_train_ranks_equal_their_emulated_plan_bitwise(runs, jax_side, kind,
                                                       shape, arch):
    """Each rank of a sharded gradient function or train step equals the
    one-device emulation of its plan (``chip_smoke.emulate_train``, at
    the ranks' one thread) bit for bit: its plan field by field, its
    loss, every gradient slice, and after a step the clip norm and every
    slice of the params and moments -- f32 gradients on (2, 1), (1, 2) and
    (2, 2), MXSF steps at bf16 activations in 2D and 1D, and the (2, 2)
    steps from the JAX package's state."""
    emu, state = _emulation(kind, shape, arch, jax_side)
    ranks = runs[0][kind, shape, arch]
    specs = CS.train_specs(R.config(arch), R.OCFG, shape)
    for r in ranks:
        co = r["coords"]
        assert r["tp_plan"] == emu["plan"]
        assert r["loss"] == emu["loss"], co
        want = R.rank_slices(emu["grads"], specs, shape, co)
        assert sorted(want) == sorted(r["grads"])
        for k, v in want.items():
            np.testing.assert_array_equal(r["grads"][k], v, err_msg=k)
        if not kind.startswith("grads"):
            assert r["grad_norm"] == emu["grad_norm"][
                co["data"] * shape[1] + co["model"]], co
            for name, tree in (("state", state["params"]),
                               ("m", state["opt"]["m"]),
                               ("v", state["opt"]["v"])):
                want = R.rank_slices({"/".join(p): t for p, t in
                                      T._flatten(tree)}, specs, shape, co)
                for k, v in want.items():
                    np.testing.assert_array_equal(r[name][k], v,
                                                  err_msg=(name, k))


@pytest.mark.parametrize("planted", list(CONTROLS))
def test_train_misstated_plan_fails_the_exact_gate(runs, jax_side, planted):
    """The negative controls: the emulation of a misstated plan misses
    every rank -- its loss or a gradient slice differs.  Every
    row-parallel partial rounded to bf16 before the sum; the head's input
    gradient partials rounded to bf16 before theirs (a bf16 entry: it
    moves no forward value); each DP rank's loss divided by its own label
    count."""
    kind, shape = CONTROLS[planted]
    emu, _ = _emulation(kind, shape, ARCH, jax_side, planted=(planted,))
    mis = emu["planted"][planted]
    specs = CS.train_specs(R.config(ARCH), R.OCFG, shape)
    for r in runs[0][kind, shape, ARCH]:
        want = R.rank_slices(mis["grads"], specs, shape, r["coords"])
        assert mis["loss"] != r["loss"] or any(
            not np.array_equal(r["grads"][k], v) for k, v in want.items())
    if planted == "bf16_head_entry":  # the forward is the plan's
        assert mis["loss"] == emu["loss"]


@pytest.mark.parametrize("arch", R.ARCHS)
def test_emulated_plan_states_the_training_plan(arch):
    """``chip_smoke.emulated_plan(train=True)`` (from the config and the
    policy alone) equals ``blocks.tp_plan(train=True)`` (from the state's
    leaves) field by field, at full and reduced width, 2D and 1D (16- and
    64-element blocks), on 2 and 4 model ranks."""
    from repro_torch.models import blocks
    from repro_torch.models import transformer as TF
    pols = [R.POLICIES["2d"], R.POLICIES["1d"],
            R.POLICIES["1d"].replace(block_1d=64)]
    for cfg in (get_config(arch), get_config(arch).reduced()):
        whole = TF.init_params(cfg, torch.Generator(), "meta")
        for pol in pols:
            for tp in (2, 4):
                want = blocks.tp_plan(cfg, pol, whole, tp,
                                      train=True)._asdict()
                assert CS.emulated_plan(cfg, pol, tp, train=True) == want, \
                    (cfg.name, pol.block_mode, pol.block_1d, tp)


# ---------------------------------------------------------------------------
# every family trains on a mesh
# ---------------------------------------------------------------------------

def _train_cell_builds(cfg):
    """The dry run's train_4k cell of ``cfg`` builds on rank 0 of a 2x2
    tracing mesh (the rank's state slices and batch rows on ``meta``, the
    sharded step); returns its TP plan."""
    tcfg, ocfg = dryrun.cell_config(cfg.name)
    _, run, info = dryrun.mesh_train_cell(
        cfg, dryrun.SHAPES["train_4k"], R.POLICIES["2d"],
        dryrun.mesh_of("2x2"), tcfg, ocfg)
    assert callable(run)
    return info["tp_plan"]


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b",
                                  "whisper-medium", "deit-tiny"])
def test_other_families_refuse_to_train_on_a_mesh(arch):
    """The SSM, hybrid, encoder-decoder and encoder families train on a
    mesh now (``test_torch_families_train_sharded.py`` holds their sharded
    step): each family's step builds on a 2x2 tracing mesh, and its
    dry-run train cell builds too."""
    cfg = get_config(arch).reduced()
    step = T.make_train_step(cfg, R.POLICIES["2d"], R.OCFG,
                             T.TrainConfig(), dryrun.mesh_of("2x2"))
    plan = _train_cell_builds(cfg)
    assert plan == step.layout.plan._asdict()
    assert not hasattr(T, "mesh_train_supported")


def test_a_moe_config_trains_on_a_mesh():
    """qwen2-moe trains on a mesh (``test_torch_moe_train_sharded.py``
    holds its sharded step): its train step builds on a 2x2 tracing mesh
    with the experts split, and its dry-run train cell builds."""
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    step = T.make_train_step(cfg, R.POLICIES["2d"], R.OCFG,
                             T.TrainConfig(), dryrun.mesh_of("2x2"))
    assert step.layout.plan.experts and _train_cell_builds(cfg)["experts"]


def test_a_collective_on_the_gradient_path_states_its_adjoint():
    """A collective whose input needs a gradient raises unless its call
    site states its adjoint; with one, its backward runs the adjoint's
    collective (a tracing mesh records it on ``meta``): an FSDP gather's
    gradient is reduce-scattered over the DP axis, a column entry's
    all-reduced over the model axis."""
    mesh = shd.TracingMesh((2, 2), ("data", "model"))
    x = torch.zeros((4, 2), device="meta", requires_grad=True)
    for call in (lambda: shd.all_reduce(x, "model", mesh=mesh),
                 lambda: shd.all_gather(x, "data", 0, mesh=mesh)):
        with pytest.raises(ValueError, match="adjoint"):
            call()
    shd.reset_counts()
    y = shd.all_gather(x, "data", 0, mesh=mesh, adjoint="reduce_scatter")
    with shd.mesh_context(mesh, ("data",), "model"):
        z = shd.enter_split(y)
    assert tuple(z.shape) == (8, 2)
    (grad,) = torch.autograd.grad(z.sum(), x)
    assert tuple(grad.shape) == (4, 2)
    got = {k: v["axes"] for k, v in shd.counts().items()}
    assert got == {"all_gather": {"data": {"calls": 1, "bytes": 32,
                                           "size": 2}},
                   "all_reduce": {"model": {"calls": 1, "bytes": 64,
                                            "size": 2}},
                   "reduce_scatter": {"data": {"calls": 1, "bytes": 64,
                                               "size": 2}}}


def test_a_split_consumer_states_its_adjoint():
    """The split-consumer adjoints, recorded on a tracing mesh: an
    all-reduce whose ranks each read the sum for their own part (the SSD
    norm's squares) all-reduces its gradient over the same axis; a gather
    over the model axis whose consumer is split (the SSD's segments of
    in_proj) reduce-scatters it into the stored slice, and a leaf stored
    whole over the model axis enters the split instead (an all-reduce)."""
    mesh = shd.TracingMesh((2, 2), ("data", "model"))
    x = torch.zeros((4, 2), device="meta", requires_grad=True)
    shd.reset_counts()
    y = shd.all_reduce(x, "model", mesh=mesh, adjoint="all_reduce")
    (g,) = torch.autograd.grad(y.sum(), x)
    assert tuple(g.shape) == (4, 2)
    assert {k: v["axes"] for k, v in shd.counts().items()} == {
        "all_reduce": {"model": {"calls": 2, "bytes": 64, "size": 2}}}
    with shd.mesh_context(mesh, ("data",), "model"):
        for spec, kinds in (((None, "model"), {"all_gather", "reduce_scatter"}),
                            ((None, None), {"all_reduce"})):
            shd.reset_counts()
            w = shd.to_compute(x, spec, (4, 4 if spec[1] else 2), None,
                               consumer="split")
            (g,) = torch.autograd.grad(w.sum(), x)
            assert tuple(g.shape) == (4, 2)
            got = {k: v["axes"] for k, v in shd.counts().items()}
            assert set(got) == kinds and all(
                set(a) == {"model"} for a in got.values())
            if spec[1]:
                assert tuple(w.shape) == (4, 4)
                assert got["reduce_scatter"]["model"]["bytes"] == 64
        with pytest.raises(ValueError, match="consumer"):
            shd.to_compute(x, (None, None), (4, 2), None, consumer="all")
