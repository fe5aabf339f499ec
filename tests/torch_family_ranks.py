"""What each gloo rank runs in ``test_torch_families_sharded.py`` (a module
of its own, without JAX: every rank imports it).

The reduced mamba2, zamba2 and whisper configs in float32 on the JAX
package's weights (numpy), packed once per rank as one device packs them
and placed by ``MeshRules``; the lockstep ``prefill`` and greedy
``decode_step``s of ``engine.lockstep_dispatches`` on each mesh of a world.
Each function returns plain data: tokens, first logits (numpy), bytes,
the per-segment take of in_proj, and one dispatch's counts.
"""
import torch

from repro_torch import convert
from repro_torch.configs.base import get_config as torch_config
from repro_torch.core import sharding as shd
from repro_torch.core.policy import BF16, MXSF_INFER
from repro_torch.launch import cost
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.models import ssd
from repro_torch.serve import engine as E

import torch_sharded_ranks as R

ARCHS = ("mamba2-780m", "zamba2-7b", "whisper-medium")
POL = MXSF_INFER.replace(block_1d=16, kv_cache_fmt="mxsf", backend="cuda")
# the JAX package's value path over the packed cache (it dequantizes the
# cache and quantizes the probabilities, where the attention kernel keeps
# them f32): the datapath its greedy tokens are compared on
VALUE = POL.replace(attention_kernel=False)
# the unquantized path, with an f32 value cache: only the order of the
# f32 sums differs on a mesh (on an MX path an ulp on a rounding midpoint
# flips a code of the next quantized operand)
F32 = dict(pol=BF16, kv_fmt="", dtype=torch.float32)
# the kernels' meta branches take 64-element blocks only: the dispatch
# counts run at those, with 32-wide heads so attention splits its heads
BLOCK64 = MXSF_INFER.replace(kv_cache_fmt="mxsf", backend="cuda")
BATCH, PROMPT, MAX_LEN, NEW = 2, 16, 24, 3


def config(arch: str, **kw):
    """The reduced config of ``arch`` in float32 (the port's)."""
    return torch_config(arch).reduced().replace(compute_dtype="float32",
                                                **kw)


def count_config(arch: str):
    return config(arch, **({} if arch == "mamba2-780m" else
                           {"d_head": 32}))


def inputs(cfg, np_inputs):
    """The whole batch of a family's prefill (tokens, or whisper's frames)
    and the token (B, 1) its first decode step is fed."""
    feed = torch.from_numpy(np_inputs["feed"]).long()
    if cfg.family == "encdec":
        return {"frames": torch.from_numpy(np_inputs["frames"])}, feed
    return {"tokens": torch.from_numpy(np_inputs["tokens"]).long()}, feed


def placed(cfg, pol, mesh, store, kv_fmt="mxsf", dtype=torch.bfloat16):
    """This rank's slices of ``store`` (the whole tree) and of a zeroed
    cache, and the placement of its dispatches."""
    rules = mesh_lib.MeshRules(mesh)
    sh = rules.param_sharding_tree(store)
    local = E.place_store(store, sh, mesh, "cpu")
    cache, cache_sh, pol, fallback = E.cache_placement(
        cfg, pol, rules, BATCH, MAX_LEN, "cpu", ring=False, kv_fmt=kv_fmt,
        dtype=dtype)
    place = E.placement(cfg, pol, rules, store, sh, cache_sh, cache)
    return local, cache, cache_sh, pol, fallback, place


def greedy(cfg, pol, place, local, cache, batch, feed):
    """The lockstep prefill and decode dispatches of
    ``lockstep_dispatches`` (the decode fed ``feed``), then greedy
    ``decode_step``s: (the top-1 token of each dispatch's logits,
    (B, NEW), and the first logits)."""
    out, first = [], None
    for _, run in E.lockstep_dispatches(cfg, pol, place, local, cache,
                                        batch, feed):
        logits, cache = run()
        if logits is not None:
            first = logits.clone() if first is None else first
            out.append(logits.argmax(-1))
    pos = 0 if cfg.family == "encdec" else PROMPT
    while len(out) < NEW:
        pos += 1
        t, = place.rows_of(out[-1][:, None])
        logits, cache = place.run(lambda: M.decode_step(
            local, t, cache, pos, cfg, pol))
        out.append(logits.argmax(-1))
    return torch.stack(out, 1).tolist(), first.numpy()


def one_device(arch, np_params, np_inputs, pol=POL, kv_fmt="mxsf",
               dtype=torch.bfloat16):
    """The greedy tokens and first logits of one device (no mesh), as
    ``greedy`` runs a rank."""
    cfg = config(arch)
    store = M.pack_model_params(cfg, convert.params_from_numpy(
        np_params, cfg), pol)
    return _greedy_one(cfg, pol, store, np_inputs, kv_fmt, dtype)


def emulated(arch, np_params, np_inputs, planted=None):
    """The (1, 2) ranks' plan (``chip_smoke.emulated_plan``) run on one
    device through ``chip_smoke.emulating`` at a rank's one CPU thread
    (``torch_dist``), ``planted`` misstating it: the greedy tokens and
    first logits of ``one_device`` on the kernel path."""
    import chip_smoke as CS
    cfg = config(arch)
    store = M.pack_model_params(cfg, convert.params_from_numpy(
        np_params, cfg), POL)
    with CS.rank_threads(torch, 1), CS.emulating(
            torch, store, CS.emulated_plan(cfg, POL, 2), 2, planted):
        return _greedy_one(cfg, POL, store, np_inputs)


def _greedy_one(cfg, pol, store, np_inputs, kv_fmt="mxsf",
                dtype=torch.bfloat16):
    cache = M.init_cache(cfg, BATCH, MAX_LEN, ring=False, kv_fmt=kv_fmt,
                         dtype=dtype, device="cpu")
    batch, tok = inputs(cfg, np_inputs)
    logits, cache = M.prefill(store, batch, cache, cfg, pol)
    first, out = logits, [] if logits is None else [logits.argmax(-1)]
    pos = 0 if cfg.family == "encdec" else PROMPT
    while len(out) < NEW:
        logits, cache = M.decode_step(store, tok, cache, pos, cfg, pol)
        first = logits if first is None else first
        tok = logits.argmax(-1)[:, None]
        out.append(tok[:, 0])
        pos += 1
    return torch.stack(out, 1).tolist(), first.numpy()


def segment_take(cfg, mesh, store, local, place):
    """in_proj of the first SSD layer in this rank's compute layout
    (``ssd._use_segments``) against the one-device codes and scales of
    its columns: (codes equal, scales equal, local logical shape)."""
    whole = store["layers"]["ssd"]["in_proj"]
    lead = len(whole.codes.shape) - 2
    lp = local["layers"]
    for _ in range(lead):
        lp = M.decoding.layer_params(lp, 0)
    with place.hints():
        got = ssd._use_segments(lp["ssd"], "in_proj", cfg, True)
    tp, i = mesh.shape["model"], mesh.coord("model")
    dI, GN, H = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_heads
    cols = []
    for start, width, split in ((0, dI, True), (dI, dI, True),
                                (2 * dI, GN, False), (2 * dI + GN, GN, False),
                                (2 * dI + 2 * GN, H, True)):
        w = width // tp if split else width
        lo = start + (i * w if split else 0)
        cols += range(lo, lo + w)
    idx = torch.tensor(cols)
    at0 = (0,) * lead
    return (torch.equal(got.codes, whole.codes[at0][:, idx]),
            torch.equal(got.scale_e8m0, whole.scale_e8m0[at0][:, idx]),
            tuple(got.shape))


def parity(cfg, mesh, params, np_inputs):
    """One family on ``mesh``: greedy tokens on the kernel datapath and on
    the value path (``tokens_value``), the first logits of the unquantized
    path (``first``) and of the kernel path (``first_mx``), bytes, plan,
    attention path and (SSD families) the per-segment take."""
    batch, feed = inputs(cfg, np_inputs)
    local, cache, _, pol, _, place = placed(cfg, F32["pol"], mesh, params,
                                            F32["kv_fmt"], F32["dtype"])
    _, first = greedy(cfg, pol, place, local, cache, batch, feed)
    store = M.pack_model_params(cfg, params, POL)
    local, cache, _, _, _, place = placed(cfg, VALUE, mesh, store)
    tokens_value, _ = greedy(cfg, VALUE, place, local, cache, batch, feed)
    local, cache, _, pol, fallback, place = placed(cfg, POL, mesh, store)
    out = dict(store_bytes=E._nbytes(local), cache_bytes=E._nbytes(cache),
               plan=place.layout["plan"]._asdict(),
               attn_backend=M.decode_attn_backend(cfg, pol),
               shard_fallback=fallback, tokens_value=tokens_value,
               first=first)
    if cfg.family in ("ssm", "hybrid"):
        out["take"] = segment_take(cfg, mesh, store, local, place)
    out["tokens"], out["first_mx"] = greedy(cfg, pol, place, local, cache,
                                            batch, feed)
    return out


def dispatch_counts(cfg, pol, mesh, np_inputs):
    """One lockstep prefill and one decode dispatch on this rank, over a
    packed store of seeded weights: each one's kernel calls and
    collectives, and the rank's store and cache bytes."""
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    store = M.pack_model_params(cfg, params, pol)
    local, cache, _, pol, _, place = placed(cfg, pol, mesh, store)
    out = {"store_bytes": E._nbytes(local), "cache_bytes": E._nbytes(cache)}
    batch, tok = inputs(cfg, np_inputs)
    for kind, run in E.lockstep_dispatches(cfg, pol, place, local, cache,
                                           batch, tok):
        shd.reset_counts()
        with R.kernel_calls() as calls:
            run()
        out[kind] = {"launches": dict(calls), "collectives":
                     cost.collectives_by_axis(shd.counts())}
    return out


def world(rank, shapes, np_params, np_inputs, count_inputs):
    """Every family on each mesh of ``shapes`` (a world of their rank
    count): ``{(arch, shape): parity}`` and ``{(arch, shape, "counts"):
    dispatch_counts}``."""
    out = {}
    for shape in shapes:
        mesh = mesh_lib.make_test_mesh(*shape)
        for arch in ARCHS:
            cfg = config(arch)
            params = convert.params_from_numpy(np_params[arch], cfg)
            out[(arch, shape)] = parity(cfg, mesh, params, np_inputs[arch])
            out[(arch, shape, "counts")] = dispatch_counts(
                count_config(arch), BLOCK64, mesh, count_inputs[arch])
    return out
