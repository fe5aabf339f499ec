"""What each gloo rank runs in ``test_torch_sharded_serving.py`` (a module
of its own, without JAX: every rank imports it).

Each function builds the reduced qwen2.5-32b engines of one world from
the JAX package's weights (numpy) and returns plain data: token streams,
the first dispatch's logits (numpy), specs, bytes.
"""
import torch

from repro_torch import convert
from repro_torch.ckpt import ckpt
from repro_torch.configs.base import get_config as torch_config
from repro_torch.core import packed_store
from repro_torch.core import sharding as shd
from repro_torch.core.blocking import QuantizedTensor
from repro_torch.core.policy import BF16, MXSF_INFER
from repro_torch.launch import cost
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import blocks
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeEngine, _nbytes, probe_dispatches

POL = MXSF_INFER.replace(block_1d=16, kv_cache_fmt="mxsf")
BLOCK64 = MXSF_INFER.replace(kv_cache_fmt="mxsf")
# max_len 24, not tests/test_serve_engine.py's 16: that test counts the
# attention-kernel compiles of its own JAX engine, and JAX caches compiles
# per process, so the reference engine here at its shapes, run earlier on
# the same worker, would leave it nothing to compile
KW = dict(slots=2, max_len=24, prefill_chunk=4, device="cpu")
MAX_NEW = 3
LOGIT_RTOL = 1e-5


def config(**kw):
    return torch_config("qwen2.5-32b").reduced().replace(
        compute_dtype="float32", **kw)


def serve(cfg, params, pol, prompts, mesh=None, backend="cuda", **kw):
    """Serve ``prompts``: (engine, token streams, first dispatch logits)."""
    first = []

    def sampler(logits):
        if not first:
            first.append(logits.detach().clone())
        return torch.argmax(logits, -1)

    eng = ServeEngine(cfg, params, pol, mesh=mesh, backend=backend,
                      sampler=sampler, **dict(KW, **kw))
    reqs = [eng.submit(p, MAX_NEW) for p in prompts]
    eng.run()
    assert all(r.done for r in reqs)
    return eng, [r.out for r in reqs], first[0]


def emulated(cfg, params, prompts, pol=POL, planted=None, **kw):
    """The (1, 2) ranks' plan (``chip_smoke.emulated_plan``) served on one
    device through ``chip_smoke.emulating`` at a rank's one CPU thread
    (``torch_dist``), ``planted`` misstating it: (tokens, the first
    dispatch's logits)."""
    import chip_smoke as CS
    store = M.pack_model_params(cfg, params, pol)
    plan = CS.emulated_plan(cfg, pol, 2)
    with CS.rank_threads(torch, 1), CS.emulating(torch, store, plan, 2,
                                                  planted):
        _, toks, first = serve(cfg, store, pol, prompts, **kw)
    return toks, first.numpy()


def spec_of(ns):
    return shd.normalize(ns.codes.spec if isinstance(ns, QuantizedTensor)
                         else ns.spec)


def parity(shape, params, prompts):
    """The packed engine on a ``shape`` mesh: tokens, first logits,
    layout, bytes."""
    cfg = config()
    mesh = mesh_lib.make_test_mesh(*shape)
    eng, toks, first = serve(cfg, params, POL, prompts, mesh)
    qts = [(shd.normalize(ns.codes.spec), shd.normalize(ns.scale_e8m0.spec),
            leaf.codes.dtype)
           for leaf, ns in zip(packed_store.tree_leaves(eng.params),
                               packed_store.tree_leaves(eng._store_sh))
           if isinstance(leaf, QuantizedTensor)]
    return dict(tokens=toks, first=first.numpy(), stats=eng.stats(),
                plan=tuple(eng.tp_plan), attn_backend=eng.attn_backend,
                shard_fallback=eng.shard_fallback,
                cache_spec=spec_of(eng._cache_sh["k_codes"]),
                packed_specs=qts,
                predicted=eng.rules.shard_nbytes(
                    M.packed_model_specs(cfg, POL), eng._store_sh),
                cache_local=tuple(eng.cache["k_codes"].shape))


def world_1(rank, np_params, prompts):
    params = convert.params_from_numpy(np_params, config())
    return {(1, 1): parity((1, 1), params, prompts)}


def world_2(rank, np_params, np_params_kv1, prompts):
    """(2, 1) and (1, 2); then n_kv = 1 on (1, 2): the kv heads cannot
    split two ways, so the cache's position axis does (sequence
    parallelism)."""
    params = convert.params_from_numpy(np_params, config())
    out = {shape: parity(shape, params, prompts)
           for shape in ((2, 1), (1, 2))}
    cfg = config(n_kv=1)
    eng, toks, _ = serve(cfg, convert.params_from_numpy(np_params_kv1, cfg),
                         POL, prompts, mesh_lib.make_test_mesh(1, 2))
    out["kv1"] = dict(tokens=toks, attn_backend=eng.attn_backend,
                      shard_fallback=eng.shard_fallback,
                      cache_spec=spec_of(eng._cache_sh["k_codes"]))
    # 64-element blocks: a rank's 2 query heads of 16 are half a block of
    # wo's rows, so the heads split and their context is gathered before
    # a whole wo (``TPPlan.ctx_gather``); the cache splits its kv heads
    eng, toks, first = serve(config(), params, BLOCK64, prompts,
                             mesh_lib.make_test_mesh(1, 2))
    out["blk64"] = dict(tokens=toks, first=first.numpy(),
                        attn_backend=eng.attn_backend,
                        shard_fallback=eng.shard_fallback,
                        plan=tuple(eng.tp_plan))
    return out


def world_4(rank, np_params, prompts, ckpt_dir):
    """(2, 2): the packed engine, the bf16 value cache, SWA's static gate,
    and a packed checkpoint restored per shard."""
    cfg = config()
    params = convert.params_from_numpy(np_params, cfg)
    out = {(2, 2): parity((2, 2), params, prompts)}
    mesh = mesh_lib.make_test_mesh(2, 2)
    eng, out["bf16_tokens"], first = serve(cfg, params, BF16, prompts, mesh,
                                           backend=None)
    out["bf16_first"] = first.numpy()
    out["bf16_cache_spec"] = spec_of(eng._cache_sh["k"])
    out["bf16_local_k"] = tuple(eng.cache["k"].shape)
    swa = config(swa_pattern="all", swa_window=8)
    eng = ServeEngine(swa, params, POL, mesh=mesh, backend="cuda", **KW)
    out["swa"] = (eng.attn_backend, eng.shard_fallback)
    eng = ServeEngine.from_checkpoint(cfg, ckpt_dir, POL, mesh=mesh,
                                      backend="cuda", **KW)
    want = packed_store.tree_map(
        lambda leaf, ns: packed_store.shard_leaf(
            leaf, ns.codes.spec if isinstance(ns, QuantizedTensor)
            else ns.spec, mesh),
        ServeEngine(cfg, params, POL, backend="cuda", **KW).params,
        eng._store_sh)
    bad = []
    for (path, got), w in zip(ckpt._iter_leaves(eng.params),
                              packed_store.tree_leaves(want)):
        if isinstance(got, QuantizedTensor):
            ok = (got.codes.dtype == torch.uint8
                  and got.scale_e8m0.dtype == torch.uint8
                  and torch.equal(got.codes, w.codes)
                  and torch.equal(got.scale_e8m0, w.scale_e8m0)
                  and tuple(got.shape) == tuple(w.shape))
        else:
            ok = torch.equal(got, w)
        if not ok:
            bad.append("/".join(path))
    out["ckpt_bad_leaves"] = bad
    reqs = [eng.submit(p, MAX_NEW) for p in prompts]
    eng.run()
    out["ckpt_tokens"] = [r.out for r in reqs]
    return out


# ``blocks._row_parallel`` at bf16 on (1, 2): every datapath of a
# row-parallel linear, by (policy, packed weight)
ROW_CASES = {
    "bf16-raw": (BF16, False),
    "value-raw": (MXSF_INFER.replace(block_1d=16), False),
    "kernel-raw": (MXSF_INFER.replace(block_1d=16, backend="cuda"), False),
    "value-packed": (MXSF_INFER.replace(block_1d=16), True),
    "kernel-packed": (MXSF_INFER.replace(block_1d=16, backend="cuda"), True),
}


def row_parallel_operands(k=512, n=64):
    """bf16 x (4, K) and a weight (K, N) of small integers, exact in bf16
    and in MXSF, whose two K halves sum to large opposite column sums:
    each half's f32 sum is an integer of ~11 bits (rounded if cast to
    bf16), the whole sum one below 256 (exact in bf16)."""
    g = torch.Generator().manual_seed(0)
    h = k // 2
    top = torch.randint(1, 4, (h, n), generator=g).float()
    bottom = -top.flip(0) + (torch.rand((h, n), generator=g) < 0.05)
    x = torch.full((4, k), 3.0).to(torch.bfloat16)
    return x, torch.cat([top, bottom]).to(torch.bfloat16)


def row_parallel(rank):
    """Each case's ``_row_parallel`` output on this rank: its half of x's
    columns against its half of the weight's rows, all-reduced."""
    mesh = mesh_lib.make_test_mesh(1, 2)
    x, w = row_parallel_operands()
    k = x.shape[1] // 2
    out = {}
    for name, (pol, packed) in ROW_CASES.items():
        leaf = packed_store.pack_leaf(w, pol) if packed else w
        with shd.mesh_context(mesh, ("data",), "model",
                              specs={"w": ((None, None), tuple(w.shape))}):
            y = blocks._row_parallel(x[:, rank * k:(rank + 1) * k],
                                     {"w": leaf}, "w", True, pol)
        out[name] = (y.dtype, y.float().numpy())
    return out


# ---------------------------------------------------------------------------
# one dispatch's counts on a real rank (``test_torch_dryrun_mesh.py``)
# ---------------------------------------------------------------------------

KERNELS = ("mxsf_fused_matmul", "mxsf_attention", "mxsf_quantize",
           "mxsf_requantize", "mxsf_matmul")


class kernel_calls:
    """Count each kernel wrapper's calls inside the block (on CPU tensors
    the wrappers run their plain versions; a call is where the card
    launches): ``{name: calls}`` of the wrappers called."""

    def __init__(self):
        from repro_torch.kernels import mx_matmul as MM
        from repro_torch.kernels import mxsf_attention as MA
        from repro_torch.kernels import mxsf_fused_matmul as FM
        from repro_torch.kernels import mxsf_quant as MQ
        self.mods = {"mxsf_fused_matmul": FM, "mxsf_attention": MA,
                     "mxsf_quantize": MQ, "mxsf_requantize": MQ,
                     "mxsf_matmul": MM}
        self.calls = {}

    def __enter__(self):
        self.saved = {k: getattr(m, k) for k, m in self.mods.items()}
        for name, fn in self.saved.items():
            def counted(*a, _name=name, _fn=fn, **kw):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _fn(*a, **kw)
            setattr(self.mods[name], name, counted)
        return self.calls

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mods[name], name, fn)


def engine_counts(eng):
    """The prefill and the decode dispatch of ``probe_dispatches`` on
    ``eng``: each one's kernel calls and collectives (``sharding.counts()``
    without the host seconds), and the bytes of the engine's store and
    cache."""
    out = {"store_bytes": _nbytes(eng.params),
           "cache_bytes": _nbytes(eng.cache)}
    for kind, _, run in probe_dispatches(eng):
        shd.reset_counts()
        with kernel_calls() as calls:
            run()
        out[kind] = {"launches": dict(calls), "collectives":
                     cost.collectives_by_axis(shd.counts())}
    return out


def dispatch_counts(rank, shape, cases):
    """On a ``shape`` mesh: ``engine_counts`` of an engine over a packed
    store of seeded weights for each ``{name: (config, policy)}`` of
    ``cases``."""
    mesh = mesh_lib.make_test_mesh(*shape)
    out = {}
    for name, (cfg, pol) in cases.items():
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        eng = ServeEngine(cfg, params, pol, mesh=mesh, backend="cuda", **KW)
        out[name] = engine_counts(eng)
    return out
