"""The sharded train step of the SSM, hybrid, encoder-decoder and encoder
families (DP, FSDP, TP, the SSD heads split over the model axis) against
the port's one-device step and against the JAX package's, on gloo worlds.

Reduced mamba2-780m, zamba2-7b, whisper-medium and deit-tiny (float32;
``tests/torch_family_train_ranks.py``, JAX-free, says how each is cut and
why the SSM configs are widened to ``d_model`` 128: so that the 2D
training plan splits the SSD) at seq 32, global batch 4, on meshes
(1, 1), (2, 1), (1, 2) and (2, 2) of ("data", "model"); the worlds run at
once, beside the JAX package's compile.

Tolerances, and why:

* The exact plumbing check: the unquantized policy in f32.  The sharded
  gradient function's loss and every rank's gradient slice equal the
  one-device step's within 1e-5 relative (the loss; each leaf's largest
  deviation over its largest |value|): only f32 summation order differs
  (the DP sums, the row-parallel partials, the column entries' and the
  split SSD's reduce-scattered and all-reduced partial gradients), ~1e-6
  here.  The same within 1e-5 for mamba2 in the 1D layout at 64-element
  blocks on (1, 2), where the SSD stays replicated (``TPPlan.ssm``
  False): its codes are one device's, so only the vocab split's f32 sums
  differ.
* Leaves replicated over the model axis get bit-equal gradients on every
  model rank.
* The negative controls: each plumbing fault the split SSD and the
  encoder's head had before their adjoints (``FAULTS``: the norm's
  all-reduce with the identity adjoint, in_proj / conv_w / conv_b
  gathered with the narrowing adjoint, the per-head leaves narrowed, no
  entry into the split, deit's head read as stored) moves some gradient
  leaf by more than 1e-2 of its largest |value| (1000x the tolerance), or
  leaves the encoder's logits with half its classes.
* One AdamW step of zamba2 on (2, 2) against the one-device step (the
  clip active): loss and grad norm rtol 1e-5, the update within 1e-3 and
  the moments within 1e-4 relative L2 (``test_torch_train_sharded.py``'s
  bounds: the first update is +-lr for any |g| >> eps).
* ``MXSF_TRAIN`` (2D) of mamba2 at one layer on (2, 2), the SSD split,
  one train step from the JAX package's state (converted from numpy)
  against its one-device jitted ``make_train_step``:
  ``test_torch_train_sharded.py``'s tolerances (ROADMAP.md, "Chaos under
  MX") -- loss rtol 1e-5, grad norm rtol 1e-3, moments within 5e-2 and
  the update within 2e-1 relative L2, whole leaves assembled from the
  ranks' slices.  The other families' one-device steps are held to the
  JAX package's by ``test_torch_hybrid.py``, ``test_torch_encdec.py`` and
  ``test_torch_encoder.py``.
"""
import concurrent.futures
import math

import jax
import numpy as np
import pytest
import torch

import chip_smoke as CS
import torch_family_train_ranks as FR
import torch_train_ranks as TR
from repro.configs.base import get_config as jax_config
from repro.core.policy import MXSF_TRAIN as JAX_TRAIN
from repro.optim import adamw as JA
from repro.train import step as JT
from repro_torch.core import sharding as shd
from repro_torch.models import blocks
from repro_torch.models import transformer as TM
from repro_torch.train import step as T
from torch_dist import run_ranks

torch.set_num_threads(2)

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
IDS = ["1x1", "2x1", "1x2", "2x2"]
MAMBA, ZAMBA, DEIT = FR.MAMBA, FR.ZAMBA, FR.DEIT
CLIP = FR.OCFG.replace(clip_norm=0.05)
STEP_ARCH = ZAMBA
JAX_KW = dict(n_layers=1)  # one layer of mamba2 (ROADMAP "Chaos under MX")
# the negative controls on (1, 2): (fault, arch)
CONTROLS = {"norm_identity": MAMBA, "segments_narrow": MAMBA,
            "heads_narrowed": MAMBA, "no_ssd_entry": MAMBA,
            "head_raw": DEIT}
FAULT_FLOOR = 1e-2


def _jax_cfg():
    return jax_config(MAMBA).reduced().replace(
        compute_dtype="float32", **dict(FR.ARCH_KW[MAMBA], **JAX_KW))


def _jax_step():
    """The JAX package's state and batch (numpy) and its one-device jitted
    2D step: (numpy state, numpy batch, metrics, new state as numpy)."""
    cfg = _jax_cfg()
    ocfg = JA.OptConfig(warmup_steps=2, total_steps=10)
    state = JT.init_state(jax.random.PRNGKey(0), cfg, ocfg)
    batch = FR.batch_of(cfg, seed=1)
    fn = jax.jit(JT.make_train_step(cfg, JAX_TRAIN, ocfg, JT.TrainConfig()))
    new, metrics = fn(state, batch)
    return (jax.tree.map(np.asarray, state), batch,
            {k: float(v) for k, v in metrics.items()},
            jax.tree.map(lambda a: np.asarray(a, np.float32), new))


def _todo(world, np_state, np_batch):
    """What every rank of a world of ``world`` ranks runs."""
    todo = [("case", ("grads", s, a), {}) for s in MESHES
            if math.prod(s) == world for a in FR.ARCHS]
    if world == 2:
        todo.append(("case", ("1d", (1, 2), MAMBA), dict(policy="1d")))
        todo += [("case", (f"fault_{f}", (1, 2), a), dict(fault=f))
                 for f, a in CONTROLS.items()]
    if world == 4:
        todo.append(("case", ("step", (2, 2), STEP_ARCH),
                     dict(ocfg=CLIP, step=True)))
        if np_state is not None:
            batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
            todo.append(("case", ("jax_2d", (2, 2), MAMBA), dict(
                policy="2d", np_state=np_state, batch=batch, step=True,
                **JAX_KW)))
    return todo


@pytest.fixture(scope="module")
def runs():
    """Every world's results, ``{(kind, shape, arch): [rank results]}``,
    and the JAX package's step (numpy state, metrics, new state).  The
    worlds of one and two ranks run beside the JAX compile; the world of
    four, which needs the JAX package's state, after it."""
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jax_fut = pool.submit(_jax_step)
        futs = {w: pool.submit(run_ranks, FR.run, w, _todo(w, None, None))
                for w in (1, 2)}
        np_state, np_batch, jm, jstate = jax_fut.result()
        todos = {w: _todo(w, np_state, np_batch) for w in (1, 2, 4)}
        res = {4: run_ranks(FR.run, 4, todos[4])}
        res.update({w: f.result() for w, f in futs.items()})
    out = {}
    for world, todo in todos.items():
        for i, (_, args, _) in enumerate(todo):
            out[args] = [r[i] for r in res[world]]
    return out, (np_state, jm, jstate)


_ONE_DEVICE = {}


def _one_device(arch, policy="f32", ocfg=None, step=False):
    """The port's one-device gradient function or train step on the same
    seed-0 state and batch: (metrics, numpy trees); cached."""
    key = (arch, policy, step)
    if key not in _ONE_DEVICE:
        cfg = FR.config(arch)
        ocfg = ocfg or FR.OCFG
        state = T.init_state(torch.Generator().manual_seed(0), cfg, ocfg,
                             device="cpu")
        pol, tcfg = FR.POLICIES[policy], T.TrainConfig()
        batch = FR.torch_batch(cfg)
        if step:
            state, metrics = T.make_train_step(cfg, pol, ocfg, tcfg)(state,
                                                                   batch)
            trees = {k: TR.numpy_tree(state["opt"][k]) for k in ("m", "v")}
            trees["state"] = TR.numpy_tree(state["params"])
        else:
            metrics, grads = T.make_grad_fn(cfg, pol, tcfg)(state["params"],
                                                            batch)
            trees = TR.numpy_tree(grads)
        _ONE_DEVICE[key] = ({k: float(v) for k, v in metrics.items()},
                            trees)
    return _ONE_DEVICE[key]


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


def _held(runs, kind, shape, arch, policy="f32"):
    """Each rank's loss and gradient slices against one device's; returns
    the largest deviation."""
    metrics, want = _one_device(arch, policy)
    specs = TR.specs_by_path(FR.config(arch), shape=shape)
    worst = 0.0
    for r in runs[0][kind, shape, arch]:
        np.testing.assert_allclose(r["loss"], metrics["loss"], rtol=1e-5)
        assert sorted(r["grads"]) == sorted(want)
        mine = TR.slices(want, shape, r["coords"], specs)
        worst = max(worst, _worst(r["grads"], mine))
    return worst


# ---------------------------------------------------------------------------
# the exact plumbing check
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=IDS)
@pytest.mark.parametrize("arch", FR.ARCHS)
def test_grads_match_one_device(runs, arch, shape):
    worst = _held(runs, "grads", shape, arch)
    assert worst <= 1e-5, worst


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_the_ssd_splits(runs, arch):
    """The widened SSM configs split the SSD over the model axis in the
    2D training plan (and in f32, where these runs took it); the reduced
    widths would not (8 heads, 4 a rank: no whole 8x8 tile)."""
    cfg = FR.config(arch)
    whole = TM.init_params(cfg, torch.Generator(), "meta")
    assert blocks.tp_plan(cfg, FR.POLICIES["2d"], whole, 2, train=True).ssm
    narrow = cfg.replace(d_model=64)
    assert not blocks.tp_plan(narrow, FR.POLICIES["2d"], TM.init_params(
        narrow, torch.Generator(), "meta"), 2, train=True).ssm
    for shape in ((1, 2), (2, 2)):
        assert all(r["plan"]["ssm"] for r in runs[0]["grads", shape, arch])


def test_replicated_ssd_matches_one_device(runs):
    """The 1D layout at 64-element blocks keeps mamba2's SSD replicated
    over the model axis (its in_proj and conv leaves gathered whole with
    the narrowing adjoint) while the vocab splits."""
    for r in runs[0]["1d", (1, 2), MAMBA]:
        assert not r["plan"]["ssm"] and r["plan"]["vocab"]
    worst = _held(runs, "1d", (1, 2), MAMBA, "1d")
    assert worst <= 1e-5, worst


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("arch", FR.ARCHS)
def test_tp_replicated_grads_equal_on_every_tp_rank(runs, arch, shape):
    specs = TR.specs_by_path(FR.config(arch), shape=shape)
    whole = [k for k, spec in specs.items()
             if "model" not in shd.split_axes(spec)]
    assert whole
    ranks = runs[0]["grads", shape, arch]
    for r in ranks:
        for q in ranks:
            if q["coords"]["data"] == r["coords"]["data"]:
                for k in whole:
                    np.testing.assert_array_equal(r["grads"][k],
                                                  q["grads"][k], err_msg=k)


@pytest.mark.parametrize("arch", FR.ARCHS)
def test_state_bytes_equal_shard_nbytes(runs, arch):
    cases = [v for (_, _, a), v in runs[0].items() if a == arch]
    assert cases
    for per_rank in cases:
        for r in per_rank:
            assert r["state_bytes"] == r["shard_nbytes"] > 0


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
@pytest.mark.parametrize("arch", FR.ARCHS)
def test_collectives_equal_their_formula(runs, arch, shape):
    mesh = dict(zip(("data", "model"), shape))
    want = CS.train_collectives(FR.config(arch), FR.POLICIES["f32"],
                                T.TrainConfig(), mesh, FR.SEQ, step=False)
    for r in runs[0]["grads", shape, arch]:
        assert r["collectives"] == want
    if shape[1] > 1 and arch != DEIT:
        assert want["reduce-scatter" if arch in (MAMBA, ZAMBA)
                    else "all-gather"]["model"] > 0
    if shape[0] > 1:
        assert want["reduce-scatter"]["data"] > 0


@pytest.mark.parametrize("fault", list(CONTROLS))
def test_negative_controls(runs, fault):
    """Each planted fault moves the gradients (or deit's logits) by O(1)
    on (1, 2)."""
    arch = CONTROLS[fault]
    ranks = runs[0][f"fault_{fault}", (1, 2), arch]
    if fault == "head_raw":
        cfg = FR.config(arch)
        for r in ranks:  # the rank's 50 of the 100 classes
            assert r["logits"].shape == (FR.BATCH, cfg.n_classes // 2)
        return
    _, want = _one_device(arch)
    specs = TR.specs_by_path(FR.config(arch), shape=(1, 2))
    worst = max(_worst(r["grads"], TR.slices(want, (1, 2), r["coords"],
                                             specs)) for r in ranks)
    assert worst > FAULT_FLOOR, (fault, worst)


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

def test_step_matches_one_device(runs):
    metrics, want = _one_device(STEP_ARCH, ocfg=CLIP, step=True)
    cfg = FR.config(STEP_ARCH)
    ranks = runs[0]["step", (2, 2), STEP_ARCH]
    specs = TR.specs_by_path(cfg, CLIP, (2, 2))
    assert metrics["grad_norm"] > CLIP.clip_norm  # the clip scale is < 1
    mesh = dict(data=2, model=2)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], metrics["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], metrics["grad_norm"],
                                   rtol=1e-5)
        assert r["collectives"] == CS.train_collectives(
            cfg, FR.POLICIES["f32"], T.TrainConfig(), mesh, FR.SEQ)
    p0 = TR.numpy_tree(T.init_state(torch.Generator().manual_seed(0), cfg,
                                    CLIP, device="cpu")["params"])
    got = {k: _assembled(ranks, k, (2, 2), specs) for k in ("state", "m",
                                                            "v")}
    for leaf, w in want["state"].items():
        assert _rel(got["state"][leaf] - p0[leaf], w - p0[leaf]) <= 1e-3, \
            leaf
        for m in ("m", "v"):
            assert _rel(got[m][leaf], want[m][leaf]) <= 1e-4, (m, leaf)


def test_step_matches_jax(runs):
    """MXSF_TRAIN (2D) of mamba2 on (2, 2), the SSD split, from the JAX
    package's state and batch, against its one-device jitted step."""
    np_state, jm, jstate = runs[1]
    ranks = runs[0]["jax_2d", (2, 2), MAMBA]
    assert all(r["plan"]["ssm"] for r in ranks)
    specs = TR.specs_by_path(FR.config(MAMBA, **JAX_KW), shape=(2, 2))
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
