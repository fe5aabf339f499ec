"""The port's checkpoints, fault-tolerant loop, ``from_checkpoint`` and
training CLI, on the CPU at reduced configs; twins of
``tests/test_fault_ckpt.py``, ``test_packed_store.py::
test_packed_ckpt_restore_decode_identical`` and ``test_system.py::
test_train_cli_end_to_end``, plus the on-disk format against the JAX
package's ``repro.ckpt`` both ways.

Every comparison here is bitwise: a checkpoint stores the bytes, and a
resumed run on the CPU repeats the same deterministic ops on the same
state.  bf16 leaves stay out of the cross-package round trip because the
JAX package's ``restore`` cannot read its own bf16 leaves (ROADMAP.md
Queue 3); a port-only round trip covers them, and the raw npy members are
compared byte for byte with what the JAX package writes.
"""
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import ckpt as jax_ckpt
from repro.configs.base import get_config as jax_config
from repro.core.policy import MXSF_INFER as JAX_INFER
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.train import step as JT
from repro_torch import convert
from repro_torch.ckpt import ckpt
from repro_torch.configs.base import get_config as torch_config
from repro_torch.core.blocking import QuantizedTensor
from repro_torch.core.policy import BF16, MXSF_INFER, MXSF_TRAIN
from repro_torch.data.pipeline import lm_batch, vision_batch
from repro_torch.launch import train as cli
from repro_torch.models import model as M
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime import fault
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as T

torch.set_num_threads(2)

SERVE_ARCH = "qwen2.5-32b-reduced"
INFER = MXSF_INFER.replace(kv_cache_fmt="mxsf")


def _flat(tree):
    """{key: numpy array} of a port tree, packed leaves as codes/scales."""
    out = {}
    for path, leaf in ckpt._iter_leaves(tree):
        key = "/".join(path)
        if isinstance(leaf, QuantizedTensor):
            out[key + "/codes"] = leaf.codes.numpy().copy()
            out[key + "/scale_e8m0"] = leaf.scale_e8m0.numpy().copy()
        else:
            out[key] = leaf.detach().numpy().copy()
    return out


def _jflat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(jax_ckpt._key_str(p) for p in path): np.asarray(leaf)
            for path, leaf in flat}


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# twins of tests/test_fault_ckpt.py
# ---------------------------------------------------------------------------

def _setup(path, arch, policy, steps, every, fail_at=None):
    cfg = torch_config(arch)
    if cfg.family == "decoder":
        cfg = cfg.replace(swa_window=16)
    ocfg = OptConfig(lr=1e-3, total_steps=steps)
    step_fn = T.make_train_step(cfg, policy, ocfg,
                                T.TrainConfig(xent_chunk=0))

    def init_fn():
        return T.init_state(torch.Generator().manual_seed(0), cfg, ocfg,
                            device="cpu")

    def batch_fn(i):
        if cfg.family == "encoder":
            x, y = vision_batch(0, i, 4, cfg.frontend_tokens, cfg.d_model,
                                cfg.n_classes, device="cpu")
            return {"embeds": x, "label": y}
        toks, labs = lm_batch(0, i, 4, 32, cfg.vocab, device="cpu")
        return {"tokens": toks, "labels": labs}

    fcfg = fault.FaultConfig(ckpt_dir=str(path), ckpt_every=every,
                             fail_at_step=fail_at)
    return fcfg, init_fn, step_fn, batch_fn


@pytest.mark.parametrize("arch,policy,steps,every,fail_at", [
    ("h2o-danube-1.8b-reduced", BF16, 12, 5, 7),
    ("h2o-danube-1.8b-reduced", MXSF_TRAIN.replace(backend="cuda"), 6, 2, 3),
    ("deit-tiny-reduced", MXSF_TRAIN.replace(backend="cuda"), 6, 2, 3)],
    ids=["decoder-bf16", "decoder-mxsf", "encoder-mxsf"])
def test_restart_is_bitwise_identical(tmp_path, arch, policy, steps, every,
                                      fail_at):
    fcfg, *fns = _setup(tmp_path / "a", arch, policy, steps, every)
    ref_state, _ = fault.train_loop(fcfg, *fns, steps)

    # interrupted after a checkpoint, then resumed
    fcfg2, *fns = _setup(tmp_path / "b", arch, policy, steps, every,
                         fail_at=fail_at)
    with pytest.raises(fault.FailureInjected):
        fault.train_loop(fcfg2, *fns, steps)
    assert ckpt.latest_step(str(tmp_path / "b")) == fail_at // every * every
    fcfg2.fail_at_step = None
    rec_state, _ = fault.train_loop(fcfg2, *fns, steps)
    # params and the whole AdamW state, step counter included
    _assert_same(_flat(rec_state), _flat(ref_state))
    assert int(rec_state["opt"]["step"]) == steps


def test_ckpt_gc_and_latest(tmp_path):
    state = {"w": torch.arange(8.0)}
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, state, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), state)


def test_async_save(tmp_path):
    state = {"w": torch.arange(128.0), "n": {"m": torch.ones((4, 4))}}
    want = _flat(state)
    ckpt.save(str(tmp_path), 7, state, blocking=False)
    # the host copy was taken at the call: an in-place update after it (as
    # the train step makes) does not reach the checkpoint
    state["w"].add_(1.0)
    ckpt.wait_pending()
    restored, step = ckpt.restore(str(tmp_path), state)
    assert step == 7
    _assert_same(_flat(restored), want)


def test_async_save_error_surfaces_in_wait_pending(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.ones(2)}, blocking=False)
    ckpt.wait_pending()
    os.makedirs(tmp_path / ".tmp-step_00000002" / "arrays.npz")
    ckpt.save(str(tmp_path), 2, {"w": torch.ones(2)}, blocking=False)
    with pytest.raises(OSError):
        ckpt.wait_pending()
    ckpt.wait_pending()  # the error was handed over once
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_straggler_watchdog():
    dog = fault.StragglerWatchdog(threshold=2.0)
    for i in range(20):
        dog.observe(i, 0.01)
    dog.observe(20, 0.5)
    assert dog.straggler_steps == [20]


def test_restore_checks_shapes_and_sharding(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"w": torch.ones(5)})
    with pytest.raises(KeyError, match="'v'"):
        ckpt.restore(str(tmp_path), {"v": torch.ones(4)})
    with pytest.raises(NotImplementedError, match="item 5"):
        ckpt.restore(str(tmp_path), {"w": torch.ones(4)}, shardings={})


# ---------------------------------------------------------------------------
# packed store: restore -> decode identical, and the metadata guards
# ---------------------------------------------------------------------------

def _serve_cfg():
    return torch_config(SERVE_ARCH).replace(compute_dtype="float32")


def test_packed_ckpt_restore_decode_identical(tmp_path):
    cfg = _serve_cfg()
    packed = M.pack_model_params(
        cfg, M.init_params(cfg, torch.Generator().manual_seed(0)), INFER)
    ckpt.save(str(tmp_path), 7, packed)

    # the restore target is meta tensors: no weight is drawn
    specs = M.packed_model_specs(cfg, INFER)
    restored, step = ckpt.restore(str(tmp_path), specs, device="cpu")
    assert step == 7
    _assert_same(_flat(restored), _flat(packed))

    pol = INFER.replace(backend="cuda")
    cache = M.init_cache(cfg, 1, 8, dtype=torch.float32, ring=False,
                          kv_fmt="mxsf", device="cpu")
    toks = torch.zeros((1, 1), dtype=torch.int64)
    pos = torch.zeros(1, dtype=torch.int64)
    l_pack = M.decode_step(packed, toks, cache, pos, cfg, pol)[0]
    cache = M.init_cache(cfg, 1, 8, dtype=torch.float32, ring=False,
                          kv_fmt="mxsf", device="cpu")
    l_rest = M.decode_step(restored, toks, cache, pos, cfg, pol)[0]
    assert torch.equal(l_pack, l_rest)

    # metadata guard: restoring under a different block layout is refused
    with pytest.raises(ValueError, match="metadata mismatch"):
        ckpt.restore(str(tmp_path), M.packed_model_specs(
            cfg, INFER.replace(block_1d=32)), device="cpu")
    # ... and so is a target that treats saved packed leaves as unpacked
    with pytest.raises(ValueError, match="treats as unpacked"):
        ckpt.restore(str(tmp_path), M.init_params(
            cfg, torch.Generator().manual_seed(0)))


def test_engine_from_checkpoint_serves_the_same_tokens(tmp_path):
    cfg = _serve_cfg()
    store = M.init_packed_params(cfg, INFER, torch.Generator().manual_seed(1),
                                 device="cpu")
    ckpt.save(str(tmp_path), 3, store)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (3, 9)]
    kw = dict(slots=2, max_len=24, backend="cuda", device="cpu")
    outs = []
    for eng in (ServeEngine(cfg, store, INFER, **kw),
                ServeEngine.from_checkpoint(cfg, str(tmp_path), INFER,
                                            **kw)):
        reqs = [eng.submit(p, 4) for p in prompts]
        eng.run()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1] and all(len(o) == 4 for o in outs[0])
    with pytest.raises(NotImplementedError, match="item 5"):
        ServeEngine.from_checkpoint(cfg, str(tmp_path), INFER, mesh=object(),
                                    **kw)


def test_meta_targets_restore_to_the_card(tmp_path, monkeypatch):
    """A ``meta`` target leaf (and ``from_checkpoint``'s ``device=None``)
    means the card: without CUDA the restore raises instead of quietly
    landing on the CPU."""
    cfg = _serve_cfg()
    store = M.init_packed_params(cfg, INFER, torch.Generator().manual_seed(1),
                                 device="cpu")
    ckpt.save(str(tmp_path), 1, store)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore(str(tmp_path), M.packed_model_specs(cfg, INFER))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine.from_checkpoint(cfg, str(tmp_path), INFER, slots=2,
                                    max_len=24)


@pytest.mark.parametrize("arch,tied,policy", [
    ("qwen2.5-32b-reduced", False, MXSF_INFER),
    ("qwen2.5-32b-reduced", True, MXSF_INFER),
    ("gemma2-2b-reduced", True, MXSF_TRAIN),
    ("deit-tiny-reduced", False, MXSF_TRAIN),
    ("qwen2.5-32b-reduced", True, BF16),
    ("mamba2-780m-reduced", True, MXSF_INFER),
    ("zamba2-7b-reduced", False, MXSF_INFER),
    ("whisper-medium-reduced", False, MXSF_INFER),
    ("internvl2-1b-reduced", True, MXSF_TRAIN)],
    ids=["untied", "tied", "gemma2-tied-2d", "encoder-2d", "unpacked",
         "ssm", "hybrid", "encdec", "vlm-2d"])
def test_packed_model_specs_match_pack_model_params(arch, tied, policy):
    cfg = torch_config(arch).replace(tie_embeddings=tied)
    real = M.pack_model_params(
        cfg, M.init_params(cfg, torch.Generator().manual_seed(0)), policy)
    specs = M.packed_model_specs(cfg, policy)
    got = dict(ckpt._iter_leaves(specs))
    want = dict(ckpt._iter_leaves(real))
    assert sorted(got) == sorted(want)
    # a tied store gets the injected packed head; no pack, no head
    assert (("head",) in want) == (not tied or policy is not BF16)
    for path, leaf in want.items():
        spec = got[path]
        assert type(spec) is type(leaf), path
        if isinstance(leaf, QuantizedTensor):
            assert ckpt._qt_meta(spec) == ckpt._qt_meta(leaf), path
            pairs = ((spec.codes, leaf.codes),
                     (spec.scale_e8m0, leaf.scale_e8m0))
        else:
            pairs = ((spec, leaf),)
        for s, r in pairs:
            assert s.device.type == "meta", path
            assert (s.shape, s.dtype) == (r.shape, r.dtype), path


# ---------------------------------------------------------------------------
# across packages: the JAX package's files in the port and back
# ---------------------------------------------------------------------------

def _cfgs(arch):
    return jax_config(arch), torch_config(arch)


def test_port_restores_what_the_jax_package_saved(tmp_path):
    cj, ct = _cfgs("h2o-danube-1.8b-reduced")
    state = jax.jit(JT.init_state, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), cj, JA.OptConfig())
    jax_ckpt.save(str(tmp_path / "state"), 5, state)
    target = T.init_state(torch.Generator().manual_seed(1), ct, OptConfig(),
                          device="cpu")
    restored, step = ckpt.restore(str(tmp_path / "state"), target)
    assert step == 5
    _assert_same(_flat(restored), _jflat(state))  # f32 and the int32 step

    sj, st = _cfgs(SERVE_ARCH)
    packed = jax.jit(lambda k: JM.pack_model_params(
        sj, JM.init_params(k, sj), JAX_INFER))(jax.random.PRNGKey(0))
    jax_ckpt.save(str(tmp_path / "store"), 2, packed)
    restored, _ = ckpt.restore(str(tmp_path / "store"),
                               M.packed_model_specs(st, MXSF_INFER),
                               device="cpu")
    _assert_same(_flat(restored), _jflat(packed))  # uint8 codes and scales


def test_jax_package_restores_what_the_port_saved(tmp_path):
    cj, ct = _cfgs("h2o-danube-1.8b-reduced")
    state = T.init_state(torch.Generator().manual_seed(0), ct, OptConfig(),
                         device="cpu")
    state["opt"]["step"].fill_(9)
    ckpt.save(str(tmp_path / "state"), 9, state)
    target = jax.eval_shape(lambda: JT.init_state(jax.random.PRNGKey(0), cj,
                                                  JA.OptConfig()))
    restored, step = jax_ckpt.restore(str(tmp_path / "state"), target)
    assert step == 9
    _assert_same(_jflat(restored), _flat(state))

    sj, st = _cfgs(SERVE_ARCH)
    store = M.init_packed_params(st, MXSF_INFER,
                                 torch.Generator().manual_seed(0),
                                 device="cpu")
    ckpt.save(str(tmp_path / "store"), 4, store)
    restored, _ = jax_ckpt.restore(str(tmp_path / "store"),
                                   JM.packed_model_specs(sj, JAX_INFER))
    _assert_same(_jflat(restored), _flat(store))


@pytest.mark.parametrize("arch", ["zamba2-7b-reduced",
                                  "whisper-medium-reduced"])
def test_family_stores_round_trip_across_packages(tmp_path, arch):
    """A packed store of the hybrid (nested group stacks, tail, the one
    shared sublayer) and of the encoder-decoder (cross-attention in f32
    values): the JAX package's file restores in the port bitwise, and the
    port's in the JAX package."""
    sj, st = _cfgs(arch)
    packed = jax.jit(lambda k: JM.pack_model_params(
        sj, JM.init_params(k, sj), JAX_INFER))(jax.random.PRNGKey(0))
    jax_ckpt.save(str(tmp_path / "jax"), 3, packed)
    restored, _ = ckpt.restore(str(tmp_path / "jax"),
                               M.packed_model_specs(st, MXSF_INFER),
                               device="cpu")
    _assert_same(_flat(restored), _jflat(packed))
    store = M.init_packed_params(st, MXSF_INFER,
                                 torch.Generator().manual_seed(0),
                                 device="cpu")
    ckpt.save(str(tmp_path / "port"), 4, store)
    restored, _ = jax_ckpt.restore(str(tmp_path / "port"),
                                   JM.packed_model_specs(sj, JAX_INFER))
    _assert_same(_jflat(restored), _flat(store))


def test_npy_members_are_the_jax_packages_bytes(tmp_path):
    """The same tree saved by both packages: every ``.npy`` member of the
    archive holds the same bytes (header included: bf16 as ``<V2``), the
    members come in the same order, and the manifests agree but for the
    time."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    u8 = rng.integers(0, 256, (4, 6)).astype(np.uint8)
    tree_t = {"b": {"w": torch.from_numpy(f32).to(torch.bfloat16)},
              "a": torch.from_numpy(f32), "n": torch.tensor(7, dtype=torch.int32),
              "c": torch.from_numpy(u8)}
    tree_j = {"b": {"w": jnp.asarray(f32).astype(jnp.bfloat16)},
              "a": jnp.asarray(f32), "n": jnp.int32(7), "c": jnp.asarray(u8)}
    ckpt.save(str(tmp_path / "t"), 1, tree_t, extra={"k": 1})
    jax_ckpt.save(str(tmp_path / "j"), 1, tree_j, extra={"k": 1})
    members = []
    for side in ("t", "j"):
        d = tmp_path / side / "step_00000001"
        with zipfile.ZipFile(d / "arrays.npz") as zf:
            members.append([(n, zf.read(n)) for n in zf.namelist()])
        man = json.loads((d / "manifest.json").read_text())
        man.pop("time")
        members.append(man)
    assert members[0] == members[2] and members[1] == members[3]
    assert b"'descr': '<V2'" in dict(members[0])["b/w.npy"]


def test_bf16_leaves_round_trip_in_the_port(tmp_path):
    cfg = torch_config("h2o-danube-1.8b-reduced")
    state = T.init_state(torch.Generator().manual_seed(0), cfg, OptConfig(),
                         param_dtype="bfloat16", device="cpu")
    ckpt.save(str(tmp_path), 1, state)
    target = T.init_state(torch.Generator().manual_seed(1), cfg, OptConfig(),
                          param_dtype="bfloat16", device="cpu")
    restored, _ = ckpt.restore(str(tmp_path), target)
    for (path, a), (_, b) in zip(ckpt._iter_leaves(restored),
                                 ckpt._iter_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert restored["params"]["emb"].dtype == torch.bfloat16
    # raw 2-byte leaves restore only into bf16
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.restore(str(tmp_path), dict(target, params=T.init_state(
            torch.Generator().manual_seed(1), cfg, OptConfig(),
            device="cpu")["params"]))


# ---------------------------------------------------------------------------
# the training CLI: checkpoints and resume (twin of test_system.py's)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["h2o-danube-1.8b-reduced",
                                  "deit-tiny-reduced"])
def test_train_cli_end_to_end(tmp_path, arch):
    metrics_path = tmp_path / "metrics.json"
    common = ["--arch", arch, "--batch", "8", "--seq", "32",
              "--lr", "5e-3", "--ckpt-dir", str(tmp_path / "ckpt"),
              "--metrics-out", str(metrics_path), "--log-every", "2",
              "--device", "cpu"]
    cli.main(common + ["--steps", "16", "--ckpt-every", "5"])
    rows = json.loads(metrics_path.read_text())
    assert rows[0]["step"] == 0 and rows[-1]["step"] == 15
    assert all(np.isfinite(r["loss"]) for r in rows)
    if arch.startswith("deit"):
        # class prototypes are learnable in a few steps (the decoder's
        # Markov task needs tens of steps more)
        assert min(r["loss"] for r in rows) < rows[0]["loss"] - 0.05
    steps = sorted(os.listdir(tmp_path / "ckpt"))
    assert steps[-1] == "step_00000016" and len(steps) == 3  # keep=3
    cli.main(common + ["--steps", "20"])
    rows2 = json.loads(metrics_path.read_text())
    assert rows2[0]["step"] >= 16  # resumed, not restarted
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 20


def test_train_cli_raises_for_unported_families(tmp_path):
    """No family is left unported: the encoder-decoder trains on zero
    frames and the VLM on zero patch embeddings, as in the JAX CLI."""
    for arch in ("whisper-medium-reduced", "internvl2-1b-reduced"):
        out = tmp_path / arch
        cli.main(["--arch", arch, "--steps", "1", "--batch", "2", "--seq",
                  "16", "--device", "cpu", "--log-every", "1",
                  "--ckpt-dir", str(out / "ckpt"), "--metrics-out",
                  str(out / "m.json")])
        rows = json.loads((out / "m.json").read_text())
        assert np.isfinite(rows[0]["loss"])
