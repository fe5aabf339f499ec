"""The port's serving engine against the JAX package's, on the reduced
qwen2.5-32b config in float32, with the JAX package's weights.

Both engines run the kernel datapath: the JAX one with ``backend="pallas"``
(Pallas in interpret mode), the port with ``backend="cuda"`` on
``device="cpu"`` (the kernels' plain versions).  Greedy token streams must
be equal token for token, and the dispatch counts equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core.policy import MXSF_INFER as JAX_INFER
from repro.models import model as JM
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs.base import get_config as torch_config
from repro_torch.core.policy import MXSF_INFER as TORCH_INFER
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(2)

# max_len 24, not tests/test_serve_engine.py's 16: that test counts the
# attention-kernel compiles of its own engine, and JAX caches compiles per
# process, so an engine of the same shapes run earlier on the same worker
# would leave it nothing to compile
MAX_NEW, MAX_LEN = 3, 24


@pytest.fixture(scope="module")
def ref():
    cfg_j = jax_config("qwen2.5-32b").reduced().replace(
        compute_dtype="float32")
    cfg_t = torch_config("qwen2.5-32b").reduced().replace(
        compute_dtype="float32")
    params_j = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = convert.params_from_numpy(
        jax.tree.map(np.asarray, params_j), cfg_t)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg_j.vocab, size=n)) for n in (3, 5, 2)]
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j,
                params_t=params_t, prompts=prompts,
                pol=TORCH_INFER.replace(kv_cache_fmt="mxsf"), jax_runs={})


def _torch_engine(ref, **kw):
    kw = dict(dict(slots=2, max_len=MAX_LEN, backend="cuda", device="cpu"),
              **kw)
    return ServeEngine(ref["cfg_t"], ref["params_t"], ref["pol"], **kw)


def _jax_run(ref, chunk):
    """The JAX engine's run at this chunk (once per module).  The engines
    share one jitted decode entry point -- same config and policy -- so
    the interpret-mode kernels compile once."""
    runs = ref["jax_runs"]
    if chunk not in runs:
        eng = JaxEngine(ref["cfg_j"], ref["params_j"],
                        JAX_INFER.replace(kv_cache_fmt="mxsf"), slots=2,
                        max_len=MAX_LEN, backend="pallas",
                        prefill_chunk=chunk)
        if "decode" in ref:
            eng._decode = ref["decode"]
        ref["decode"] = eng._decode
        reqs = [eng.submit(p, MAX_NEW) for p in ref["prompts"]]
        eng.run()
        runs[chunk] = (eng, [r.out for r in reqs])
    return runs[chunk]


@pytest.mark.parametrize("chunk", [1, 7, 16])
def test_token_streams_and_dispatches_match_jax(ref, chunk):
    jeng, jout = _jax_run(ref, chunk)
    eng = _torch_engine(ref, prefill_chunk=chunk)
    assert eng.attn_backend == "cuda-packed"
    reqs = [eng.submit(p, MAX_NEW) for p in ref["prompts"]]
    fin = eng.run()
    assert len(fin) == len(reqs) and all(r.done for r in reqs)
    assert [r.out for r in reqs] == jout
    assert eng.prefill_dispatches == jeng.prefill_dispatches
    assert eng.decode_dispatches == jeng.decode_dispatches
    assert eng.prefill_chunk == jeng.prefill_chunk


def test_stats_keys(ref):
    jeng, _ = _jax_run(ref, 7)
    eng = _torch_engine(ref, prefill_chunk=7)
    eng.submit(ref["prompts"][0], MAX_NEW)
    eng.run()
    st, jst = eng.stats(), jeng.stats()
    assert set(st) - set(jst) == {"prefill_seconds", "decode_seconds"}
    assert set(jst) <= set(st)
    for key in ("prefill_chunk", "mesh", "shard_fallback", "store_nbytes"):
        assert st[key] == jst[key], key
    for key in ("store_nbytes_per_device", "cache_nbytes_per_device"):
        assert list(st[key].values()) == list(jst[key].values()), key


@pytest.mark.parametrize("chunk", [1, 4])
def test_eos_stops_generation(ref, chunk):
    """The cut is the first generated token not seen earlier in the free
    stream, so the EOS can only match where the cut is."""
    prompt = ref["prompts"][1]
    free_eng = _torch_engine(ref, prefill_chunk=chunk)
    free = free_eng.submit(prompt, 8)
    free_eng.run()
    cut = next(i for i in range(1, len(free.out))
               if free.out[i] not in free.out[:i])
    eng = _torch_engine(ref, prefill_chunk=chunk, eos_id=free.out[cut])
    req = eng.submit(prompt, 8)
    eng.run()
    assert req.done and req.out == free.out[:cut + 1]
    # a per-request eos_id overrides the engine's; EOS on the first token
    # retires the request straight out of the prefill phase
    eng = _torch_engine(ref, prefill_chunk=chunk, eos_id=free.out[cut])
    req = eng.submit(prompt, 8, eos_id=free.out[0])
    eng.run()
    assert req.out == free.out[:1]
    if chunk > 1:
        assert eng.decode_dispatches == 0


def test_long_prompt_rejected_or_truncated(ref):
    eng = _torch_engine(ref, max_len=8)
    long_prompt = list(range(11))
    with pytest.raises(ValueError):
        eng.submit(long_prompt, max_new=4)
    req = eng.submit(long_prompt, max_new=4, truncate=True)
    assert len(req.prompt) == 8
    req2 = eng.submit(list(range(8)), max_new=4)
    fin = eng.run(max_ticks=32)
    assert {r.uid for r in fin} == {req.uid, req2.uid}
    assert len(req.out) == 1 and len(req2.out) == 1  # capped by the cache
    assert int(eng.pos.max()) <= 8


def test_engine_without_device_needs_cuda(ref, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(ref["cfg_t"], ref["params_t"], ref["pol"],
                    backend="cuda")


def test_torch_backend_is_not_ported(ref):
    eng = ServeEngine(ref["cfg_t"], ref["params_t"], ref["pol"],
                      device="cpu")  # default backend: "torch"
    eng.submit(ref["prompts"][0], 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.run()


def test_moe_configs_pin_token_by_token():
    """Expert capacity is sized per dispatch, so MoE engines take chunk=1
    (as the JAX engine does); MoE layers themselves are not ported yet."""
    cfg = torch_config("qwen2-moe-a2.7b").reduced()
    eng = ServeEngine(cfg, {}, TORCH_INFER.replace(kv_cache_fmt="mxsf"),
                      backend="cuda", slots=2, max_len=16, prefill_chunk=16,
                      device="cpu")
    assert eng.prefill_chunk == 1
