"""The sharded train step of the MoE decoders (expert parallelism in the
backward, on ``torch.distributed``) against the port's one-device step
and against the JAX package's, on gloo worlds.

Reduced qwen2-moe-a2.7b (12 live experts padded to 16 rows, top-2, one
shared expert, 4 kv heads; 2 layers, so one MoE layer's input gradient
feeds another layer's routing and experts) on meshes (1, 1), (2, 1),
(1, 2), (2, 2) and (1, 3) of ("data", "model") -- the last the uneven
split of the 16 expert rows, 6 / 6 / 4 and 2 zero rows -- and reduced
llama4-maverick (``moe_every=2``, top-1, a shared expert; 4 layers) on
(1, 2) under its train overrides (remat "full", bf16 moments,
microbatches 2).  Seq 32, global batch 4; each rank runs
``tests/torch_moe_train_ranks.py`` (JAX-free); the worlds run at once,
beside the JAX package's compiles.

Tolerances, and why:

* The exact plumbing check: the unquantized policy in f32.  The sharded
  gradient function's loss and every rank's gradient slice equal the
  one-device step's within 1e-5 relative (the loss; each leaf's largest
  deviation over its largest |value|): only f32 summation order differs.
  A plain slice in place of ``sharding.take_slots`` leaves each rank's
  input gradient with its own experts' share only, an all-reduce in
  front of the router adds the router's input gradient once per model
  rank: each moves them by O(1).  The routing (every MoE layer's top-k
  indices) equals one device's on the rank's rows.  At top-1 (llama4)
  the normalized weight is p / p = 1, so the router's gradient is zero in
  exact arithmetic and both sides return rounding noise: a leaf whose
  one-device gradient is below 1e-6 of the largest leaf's largest |value|
  must be that small on the mesh too (``test_torch_moe_train.py``'s
  rule), and after a step its first moment too (AdamW's first update of
  a noise gradient is +-lr, whatever its size).
* Leaves replicated over the model axis (the router among them) get
  bit-equal gradients on every model rank.
* The rows an uneven split pads are zeros: their gradients, and after a
  step their parameters and moments, are exactly zero.
* One AdamW step against the one-device step (the clip active): loss and
  grad norm rtol 1e-5, the update within 1e-3 and the moments within
  1e-4 relative L2 (``test_torch_train_sharded.py``'s bounds; bf16
  moments within 2^-8, one bf16 rounding).
* ``MXSF_TRAIN`` in 2D and in the 1D layout (16-element blocks) on
  (2, 2), one super-layer (one layer of qwen2-moe: ROADMAP.md, "Chaos
  under MX"), one train step from the JAX package's state (converted from
  numpy) on its ``lm_batch``, against its one-device jitted
  ``make_train_step``: ``test_torch_train_sharded.py``'s tolerances --
  loss rtol 1e-5, grad norm rtol 1e-3, moments within 5e-2 and the
  update within 2e-1 relative L2, whole leaves assembled from the ranks'
  slices.
* Everything the JAX package compares bitwise stays bitwise: the state
  saved on (1, 2) and restored onto (1, 3), every slice.
* The exact gate, bit for bit: each (1, 2) rank of qwen2-moe against the
  one-device emulation of its plan (``chip_smoke.emulate_train``): the
  plan, loss, every gradient slice and each MoE layer's top-k indices.
"""
import concurrent.futures

import jax
import numpy as np
import pytest
import torch

import chip_smoke as CS
import torch_moe_train_ranks as MR
import torch_train_ranks as TR
from repro.configs.base import get_config as jax_config
from repro.core.policy import MXSF_TRAIN as JAX_TRAIN
from repro.data.pipeline import lm_batch as jax_lm_batch
from repro.optim import adamw as JA
from repro.train import step as JT
from repro_torch.core import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.train import step as T
from torch_dist import run_ranks

torch.set_num_threads(2)

QWEN, LLAMA = MR.QWEN, MR.LLAMA
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 3)]
GRAD_CASES = [(QWEN, s) for s in MESHES] + [(LLAMA, (1, 2))]
CLIP = TR.OCFG.replace(clip_norm=0.05)
STEP_CASES = {  # one AdamW step against the one-device step, clip active
    "clip_1x3": dict(arch=QWEN, shape=(1, 3), ocfg=CLIP),
    "llama4_1x2": dict(arch=LLAMA, shape=(1, 2),
                       ocfg=CLIP.replace(moment_dtype="bfloat16"))}
# one step on the uneven split with bf16 parameters and f32 masters: the
# padded rows of all four trees stay zero
MASTER_CASE = dict(arch=QWEN, shape=(1, 3), ocfg=TR.OCFG,
                   param_dtype="bfloat16")
JAX_LAYOUTS = {"2d": JAX_TRAIN,
               "1d": JAX_TRAIN.replace(block_mode="1d", block_1d=16,
                                       quantize_bwd=True)}
JAX_LAYERS = 1  # one super-layer of qwen2-moe


def _jax_cfg():
    return jax_config(QWEN).reduced().replace(
        n_layers=JAX_LAYERS, compute_dtype="float32", **MR.ARCH_KW[QWEN])


@pytest.fixture(scope="module")
def jax_state():
    """The JAX package's state and batch, as numpy."""
    cfg = _jax_cfg()
    state = JT.init_state(jax.random.PRNGKey(0), cfg, JA.OptConfig(
        warmup_steps=2, total_steps=10))
    toks, labs = jax_lm_batch(0, 0, TR.BATCH, TR.SEQ, cfg.vocab)
    return (jax.tree.map(np.asarray, state),
            {"tokens": np.asarray(toks), "labels": np.asarray(labs)})


def _jax_step(np_state, np_batch, layout):
    """The JAX package's one-device jitted step of ``layout``: (metrics,
    new state as numpy)."""
    fn = jax.jit(JT.make_train_step(_jax_cfg(), JAX_LAYOUTS[layout],
                                    JA.OptConfig(warmup_steps=2,
                                                 total_steps=10),
                                    JT.TrainConfig()))
    state = jax.tree.map(jax.numpy.asarray, np_state)
    new, metrics = fn(state, np_batch)
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree.map(lambda a: np.asarray(a, np.float32), new))


def _todo(world, np_state, np_batch, ckpt_dir):
    """What every rank of a world of ``world`` runs."""
    todo = [("case", ("grads", s), dict(arch=a)) for a, s in GRAD_CASES
            if s[0] * s[1] == world]
    todo += [("case", (name, c["shape"]), dict(
        arch=c["arch"], ocfg=c["ocfg"], step=True))
        for name, c in STEP_CASES.items()
        if c["shape"][0] * c["shape"][1] == world]
    if world == 2:
        todo.append(("ckpt_save", (ckpt_dir,), {}))
    if world == 3:
        todo.append(("case", ("bf16_params_1x3", (1, 3)), dict(
            ocfg=MASTER_CASE["ocfg"], param_dtype="bfloat16", step=True)))
        todo.append(("ckpt_restore", (ckpt_dir,), {}))
    if world == 4:
        batch = {k: torch.tensor(v) for k, v in np_batch.items()}
        todo += [("case", (f"jax_{name}", (2, 2)), dict(
            policy=name, layers=JAX_LAYERS, np_state=np_state, batch=batch,
            step=True)) for name in JAX_LAYOUTS]
    return todo


@pytest.fixture(scope="module")
def runs(jax_state, tmp_path_factory):
    """Every world's results, ``{(kind, shape, arch): [rank results]}``,
    the checkpoint's saved and restored slices per rank, and the JAX
    package's steps ``{layout: (metrics, state)}``.  The worlds of two and
    three ranks run one after the other (the restore reads what the save
    wrote); the others and the JAX compiles run beside them."""
    np_state, np_batch = jax_state
    ckpt_dir = str(tmp_path_factory.mktemp("moe_train_ckpt"))
    todos = {w: _todo(w, np_state, np_batch, ckpt_dir) for w in (1, 2, 3, 4)}

    def worlds(*sizes):
        return {w: run_ranks(MR.run, w, todos[w]) for w in sizes}

    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        futs = [pool.submit(worlds, 1), pool.submit(worlds, 2, 3),
                pool.submit(worlds, 4)]
        jax_futs = {name: pool.submit(_jax_step, np_state, np_batch, name)
                    for name in JAX_LAYOUTS}
        res = {}
        for f in futs:
            res.update(f.result())
        jax_steps = {k: f.result() for k, f in jax_futs.items()}
    out, ckpt = {}, {}
    for world, todo in todos.items():
        for i, (name, args, kw) in enumerate(todo):
            per_rank = [r[i] for r in res[world]]
            if name.startswith("ckpt"):
                ckpt[name] = per_rank
            else:
                out[args[0], args[1], kw.get("arch", QWEN)] = per_rank
    return out, ckpt, jax_steps


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _own_rows(topi, coords, n_rows):
    lo = coords["data"] * n_rows
    return [t[lo:lo + n_rows] for t in topi]


def _assembled(per_rank, key, shape, specs):
    """Whole leaves from the ranks' slices of ``key`` (replicated slices
    overlap, alike; an uneven split's zero rows trimmed)."""
    out = {}
    for r in per_rank:
        mesh = shd.Mesh(dict(zip(("data", "model"), shape)),
                        coords=r["coords"])
        for k, v in r[key].items():
            ns = specs[k]
            uneven = dict(ns.uneven)
            full = tuple(uneven.get(d, n * shd.axis_size(e, mesh.shape))
                         for d, (n, e) in enumerate(zip(
                             v.shape, tuple(ns.spec) + (None,) * 8)))
            out.setdefault(k, np.zeros(full, np.float32))
            sl = shd.shard_slices(full, ns.spec, mesh, tuple(uneven))
            out[k][sl] = v[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


# ---------------------------------------------------------------------------
# the exact plumbing check
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", GRAD_CASES,
                         ids=[f"{a.split('-')[0]}-{s[0]}x{s[1]}"
                              for a, s in GRAD_CASES])
def test_grads_and_routing_match_one_device(runs, arch, shape):
    want = MR.one_device(arch)
    cfg = MR.config(arch)
    specs = MR.specs_by_path(cfg, MR.OCFG[arch], shape)
    floor = 1e-6 * max(np.abs(g).max() for g in want["grads"].values())
    for r in runs[0]["grads", shape, arch]:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        got = r["grads"]
        assert sorted(got) == sorted(want["grads"])
        mine = MR.slices(want["grads"], shape, r["coords"], specs)
        if shape == (1, 1):  # one rank: one device's bits
            for k in mine:
                np.testing.assert_array_equal(got[k], mine[k], err_msg=k)
            assert r["loss"] == want["loss"]
        # each leaf's largest deviation over the whole leaf's largest
        # |value| (a rank may hold only dead experts' zero gradients)
        scale = {k: max(np.abs(want["grads"][k]).max(), floor)
                 for k in mine}
        noise = {k for k in mine if np.abs(want["grads"][k]).max() < floor}
        assert noise <= {k for k in mine if k.endswith("router")}
        assert not noise or arch == LLAMA  # top-1: rounding noise
        dev = {k: float(np.abs(got[k] - mine[k]).max() / scale[k])
               for k in mine}
        bad = {k: v for k, v in dev.items() if v > (1.0 if k in noise
                                                    else 1e-5)}
        assert not bad, (r["coords"], bad)
        n = r["topi"][0].shape[0]
        assert len(r["topi"]) == len(want["topi"])
        for i, (g, w) in enumerate(zip(r["topi"], _own_rows(
                want["topi"], r["coords"], n))):
            np.testing.assert_array_equal(g, w, err_msg=f"top-k call {i}")


def test_moe_1x2_ranks_equal_their_emulated_plan_bitwise(runs):
    """Each (1, 2) rank of qwen2-moe's gradient function equals the
    one-device emulation of its plan (``chip_smoke.emulate_train``: each
    rank's expert rows and shared-expert columns at its shapes, the
    entries' and partials' sums in rank order, at the ranks' one thread)
    bit for bit: its plan, loss and every gradient slice, and each MoE
    layer's top-k indices (the forward's)."""
    cfg = MR.config(QWEN)
    state = T.init_state(torch.Generator().manual_seed(0), cfg,
                         MR.OCFG[QWEN], device="cpu")
    with CS.rank_threads(torch, 1):
        emu = CS.emulate_train(torch, cfg, MR.POLICIES["f32"], MR.TCFG[QWEN],
                               MR.OCFG[QWEN], state, MR.batch_of(QWEN),
                               (1, 2), step=False)
    specs = CS.train_specs(cfg, MR.OCFG[QWEN], (1, 2))
    n_moe = cfg.n_layers // cfg.moe_every
    assert emu["plan"]["experts"] and len(emu["topi"]) == n_moe
    for r in runs[0]["grads", (1, 2), QWEN]:
        assert r["tp_plan"] == emu["plan"]
        assert r["loss"] == emu["loss"]
        want = TR.rank_slices(emu["grads"], specs, (1, 2), r["coords"])
        assert sorted(want) == sorted(r["grads"])
        for k, v in want.items():
            np.testing.assert_array_equal(r["grads"][k], v, err_msg=k)
        for i, (g, w) in enumerate(zip(r["topi"][:n_moe], emu["topi"])):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=i)


@pytest.mark.parametrize("arch,shape", [(QWEN, (1, 2)), (QWEN, (2, 2)),
                                        (QWEN, (1, 3)), (LLAMA, (1, 2))],
                         ids=["qwen-1x2", "qwen-2x2", "qwen-1x3",
                              "llama4-1x2"])
def test_tp_replicated_grads_equal_on_every_tp_rank(runs, arch, shape):
    specs = MR.specs_by_path(MR.config(arch), MR.OCFG[arch], shape)
    whole = [k for k, ns in specs.items()
             if "model" not in shd.split_axes(ns.spec)]
    assert any(k.endswith("router") for k in whole)
    ranks = runs[0]["grads", shape, arch]
    for r in ranks:
        for q in ranks:
            if q["coords"]["data"] == r["coords"]["data"]:
                for k in whole:
                    np.testing.assert_array_equal(r["grads"][k],
                                                  q["grads"][k], err_msg=k)


def _padded(r, shape, specs):
    """The zero rows an uneven expert split pads on this rank, by path:
    (leaf, index of the first padded row along the expert dim)."""
    mesh = shd.Mesh(dict(zip(("data", "model"), shape)), coords=r["coords"])
    out = {}
    for k, ns in specs.items():
        for d, n in ns.uneven:
            live = shd.shard_slices((n,), (ns.spec[d],), mesh, (0,))[0]
            out[k] = (d, live.stop - live.start)
    return out


@pytest.mark.parametrize("kind", ["grads", "clip_1x3", "bf16_params_1x3"])
def test_padded_expert_rows_are_exactly_zero(runs, kind):
    """(1, 3): the last rank's expert stacks hold experts 12-15 (dead,
    drawn) and 2 zero rows, whose gradients, and after a step whose
    parameters, moments and (bf16 parameters) f32 masters, are exactly
    zero."""
    cfg = MR.config(QWEN)
    specs = MR.specs_by_path(cfg, MR.OCFG[QWEN], (1, 3))
    keys = {"grads": ["grads"], "clip_1x3": ["state", "m", "v"],
            "bf16_params_1x3": ["state", "m", "v", "master"]}[kind]
    seen = 0
    for r in runs[0][kind, (1, 3), QWEN]:
        for k, (d, live) in _padded(r, (1, 3), specs).items():
            for key in keys:
                tail = np.take(r[key][k], range(live, r[key][k].shape[d]),
                               axis=d)
                assert not np.any(tail), (key, k, r["coords"])
                seen += tail.size
    assert seen > 0


@pytest.mark.parametrize("kind", ["grads", "clip_1x3", "llama4_1x2",
                                  "bf16_params_1x3", "jax_2d"])
def test_state_bytes_equal_shard_nbytes(runs, kind):
    got = [v for (k, _, _), v in runs[0].items() if k == kind]
    assert got
    for per_rank in got:
        for r in per_rank:
            assert r["state_bytes"] == r["shard_nbytes"] > 0


@pytest.mark.parametrize("arch,shape", GRAD_CASES,
                         ids=[f"{a.split('-')[0]}-{s[0]}x{s[1]}"
                              for a, s in GRAD_CASES])
def test_collectives_equal_their_formula(runs, arch, shape):
    mesh = dict(zip(("data", "model"), shape))
    cfg = MR.config(arch)
    want = CS.train_collectives(cfg, MR.POLICIES["f32"], MR.TCFG[arch],
                                mesh, TR.SEQ, step=False)
    for r in runs[0]["grads", shape, arch]:
        assert r["collectives"] == want
    if shape[1] > 1:  # the experts' outputs and the take's adjoint
        assert want["all-gather"]["model"] >= 3 * cfg.n_layers // \
            cfg.moe_every
    for name, c in STEP_CASES.items():
        if (c["arch"], c["shape"]) == (arch, shape):
            want = CS.train_collectives(cfg, MR.POLICIES["f32"],
                                        MR.TCFG[arch], mesh, TR.SEQ)
            for r in runs[0][name, shape, arch]:
                assert r["collectives"] == want


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STEP_CASES))
def test_step_matches_one_device(runs, name):
    c = STEP_CASES[name]
    arch, shape, ocfg = c["arch"], c["shape"], c["ocfg"]
    want = MR.one_device(arch, ocfg=ocfg, step=True)
    cfg = MR.config(arch)
    ranks = runs[0][name, shape, arch]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
    assert want["grad_norm"] > ocfg.clip_norm  # the clip scale is below 1
    start = TR.numpy_tree(T.init_state(torch.Generator().manual_seed(0),
                                       cfg, ocfg, device="cpu")["params"])
    specs = MR.specs_by_path(cfg, ocfg, shape)
    mom_tol = 2.0 ** -8 if ocfg.moment_dtype == "bfloat16" else 1e-4
    got = {k: _assembled(ranks, k, shape, specs) for k in ("state", "m",
                                                           "v")}
    # at top-1 the router's gradient is rounding noise (see the module
    # docstring), and AdamW's first update of it is +-lr whatever its size:
    # its first moment must stay noise on both sides instead
    floor = 1e-6 * max(np.abs(m).max() for m in want["m"].values())
    for leaf, w in want["state"].items():
        if cfg.top_k == 1 and leaf.endswith("router"):
            assert np.abs(got["m"][leaf]).max() < floor, leaf
            assert np.abs(want["m"][leaf]).max() < floor, leaf
            continue
        assert _rel(got["state"][leaf] - start[leaf], w - start[leaf]) \
            <= 1e-3, leaf
        for m in ("m", "v"):
            assert _rel(got[m][leaf], want[m][leaf]) <= mom_tol, (m, leaf)


@pytest.mark.parametrize("layout", list(JAX_LAYOUTS))
def test_step_matches_jax(runs, jax_state, layout):
    """MXSF_TRAIN on (2, 2) from the JAX package's state and batch,
    against its one-device jitted step."""
    np_state, _ = jax_state
    jm, jstate = runs[2][layout]
    ranks = runs[0][f"jax_{layout}", (2, 2), QWEN]
    cfg = MR.config(QWEN, JAX_LAYERS)
    specs = MR.specs_by_path(cfg, MR.OCFG[QWEN], (2, 2))
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
    assert any("we_g" in k for k in want["state"])
    for leaf, w in want["state"].items():
        assert _rel(got["state"][leaf] - p0[leaf], w - p0[leaf]) <= 2e-1, \
            leaf
        for m in ("m", "v"):
            assert _rel(got[m][leaf], want[m][leaf]) <= 5e-2, (m, leaf)


def test_checkpoint_saved_on_1x2_restores_on_1x3_bitwise(runs):
    """``ckpt.save(shardings=)`` on (1, 2) after one step, then
    ``ckpt.restore(shardings=)`` on (1, 3), the uneven expert split:
    every rank's slice of every leaf bitwise, its zero rows included."""
    ckpt = runs[1]
    cfg = MR.config(QWEN)
    saved = _assembled(ckpt["ckpt_save"], "state", (1, 2), MR.specs_by_path(
        cfg, MR.OCFG[QWEN], (1, 2), tree=None))
    specs = MR.specs_by_path(cfg, MR.OCFG[QWEN], (1, 3), tree=None)
    for got in ckpt["ckpt_restore"]:
        assert got["step"] == 1
        want = MR.slices(saved, (1, 3), got["coords"], specs)
        assert sorted(want) == sorted(got["state"])
        for k, v in want.items():
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)


# ---------------------------------------------------------------------------
# the take and what a mesh trains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks,rank,lo,live", [(3, 0, 0, 6), (3, 2, 12, 4),
                                                (2, 1, 8, 8)])
def test_take_slots_and_its_adjoint(ranks, rank, lo, live):
    """``take_slots`` of a 16-row dim on a model axis of ``ranks``: this
    rank's ``ceil(16 / ranks)`` rows, zero past the end; its backward
    gathers the ranks' gradient slices over the axis, recorded as one
    all-gather of the slice's bytes, and trims them to 16 rows (on a
    tracing mesh, shapes only)."""
    c = -(-16 // ranks)
    x = torch.arange(16 * 2, dtype=torch.float32).reshape(2, 16)
    mesh = shd.TracingMesh((1, ranks), ("data", "model"), rank)
    y = shd.take_slots(x, 1, "model", mesh)
    assert y.shape == (2, c)
    torch.testing.assert_close(y[:, :live], x[:, lo:lo + live],
                               rtol=0, atol=0)
    assert not y[:, live:].any()
    xm = torch.empty((2, 16), device="meta", requires_grad=True)
    shd.reset_counts()
    ym = shd.take_slots(xm, 1, "model", mesh)
    (g,) = torch.autograd.grad(ym.sum(), xm)
    assert tuple(g.shape) == (2, 16)
    assert {k: v["axes"] for k, v in shd.counts().items()} == {
        "all_gather": {"model": {"calls": 1, "bytes": 2 * c * 4,
                                 "size": ranks}}}


@pytest.mark.parametrize("arch", [QWEN, LLAMA])
def test_moe_configs_train_on_a_mesh(arch):
    """The MoE configs build a sharded step whose plan splits the experts,
    and their dry-run train cell on the same mesh."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch).reduced()
    step = T.make_train_step(cfg, TR.POLICIES["2d"], TR.OCFG,
                             T.TrainConfig(), dryrun.mesh_of("2x2"))
    assert step.layout.plan.experts
    tcfg, ocfg = dryrun.cell_config(cfg.name)
    _, _, info = dryrun.mesh_train_cell(
        cfg, dryrun.SHAPES["train_4k"], TR.POLICIES["2d"],
        dryrun.mesh_of("2x2"), tcfg, ocfg)
    assert info["tp_plan"]["experts"]
