"""Dry run: trace every (arch x shape) cell on ``meta`` tensors and count
what its program would run on one H100 of a mesh, or on one card.

Counterpart of the JAX package's ``launch/dryrun.py`` (``lower_cell`` and
``main``).  There each cell is lowered and compiled for the production
TPU mesh -- 16x16 ("data", "model"), and 2x16x16 ("pod", "data",
"model") under ``--multi-pod`` -- and XLA's memory analysis and the HLO
walk (``hlo_cost``) say whether it fits and what bounds it.  Here one
rank's program runs once on ``meta`` tensors (shapes only: nothing is
computed or allocated, so no card is needed) under ``launch/cost.count``,
which counts every aten op, every kernel launch (the kernel wrappers'
``meta`` branches, with ``--backend cuda``), every collective and the
bytes alive at once.  On a mesh the rank is rank 0 of a tracing mesh
(``sharding.TracingMesh``: coordinates, no process group; SPMD gives
every rank the same counts) and its program is the serving engine's:
the f32 parameters placed by ``MeshRules`` (``engine.place_store``), the
cache by ``cache_shardings`` with the engine's per-shard attention gate
(``engine.cache_placement``), and the engine's dispatch (``engine.
placement``: its stored specs, TP plan, the cache's position or kv-head
split and its slot rows, the logits gathered over the batch axes) around
``M.decode_step`` for decode shapes -- the JAX cell's logits leave
replicated -- and ``M.prefill`` of the whole prompt for prefill shapes.
``--mesh 1x1`` is the one-card trace: ``make_train_step`` for train
shapes, ``M.prefill`` and ``M.decode_step`` (``make_serve_step``) alone.

Each cell's record has the JAX record's keys:

  * ``mesh``, ``n_devices``;
  * ``memory``    -- argument, output and temp bytes per device and
                     ``peak_bytes_per_device`` (argument + temp), and
                     ``fits``: the peak against the card's 80 GB;
  * ``cost``      -- FLOPs (bf16 tensor-core and f32 shares), HBM bytes,
                     aten ops and kernel launches by kernel, per device;
  * ``collectives`` -- the JAX package's five kinds, each ``{"count",
                     "bytes", "by_axis"}`` (operand bytes), and
                     ``collective_axes``: each axis's link and rate;
  * ``roofline``  -- ``compute_s``, ``memory_s``, ``collective_s`` and
                     ``dominant`` (``launch/cost.summarize``);
  * ``model_flops_global``, ``model_flops_per_device``,
    ``useful_flops_fraction``, ``params_total``, ``params_active``,
    ``policy``; a serving cell on a mesh also its attention path
    (``attn_backend``, ``shard_fallback``).

A meta trace is slow (PyTorch's meta functions are Python decompositions,
~0.4 ms an aten op), and the port's layers are a Python loop, where the
JAX package's are a ``lax.scan`` whose body ``hlo_cost`` multiplies by
its trip count.  The counterpart here is the layer-period trace
(``--trace period``, the default on a mesh): the cell traced at two and
at three periods of its layer pattern (``layer_period``: the SWA
alternation, ``moe_every``, a hybrid's group) and every count scaled
linearly to the config's depth (``cost.extrapolate``).  Not at one and
two: the counts grow by the same amount from the first period on, but a
prefill's peak does not -- at one period its temporaries have not reached
their steady size yet, so the step from one period to two overstates the
step a further period adds.

On a mesh the port covers the serving cells of every family the JAX dry
run lowers there: decoders, the SSM, the hybrid and the encoder-decoder,
each through ``M.prefill`` and ``M.decode_step`` (the SSD's TP plan in
``models/ssd.py``; a hybrid period is one group of SSD layers with the
shared block, the tail outside; an encoder-decoder period one encoder and
one decoder layer); and the train cells of every family: the rank's
slices of the train state (``state_shardings``; an uneven expert split's
zero rows included), its batch rows and the sharded ``make_train_step``
(DP, FSDP, TP, the SSD heads and the experts split over the model axis
where the training plan splits them, the collectives of its backward
among the counts), with the per-arch ``ARCH_TRAIN_OVERRIDES``
(llama4-maverick: microbatches 4, bf16 moments, remat "full").  As in
the JAX dry run, deit-tiny stays out of the grid.  Results land in
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape decode_32k --backend cuda
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k --mesh 1x1
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from ..configs.base import SHAPES, ModelConfig, ShapeConfig, get_config, \
    list_configs
from ..core import sharding as shd
from ..core.policy import MXSF_TRAIN, QuantPolicy
from ..models import model as M
from ..models.transformer import hybrid_split
from ..optim.adamw import OptConfig
from ..serve import engine as E
from ..train import step as T
from . import cost
from . import mesh as mesh_lib

__all__ = ["ARCH_TRAIN_OVERRIDES", "cell_policy", "cell_config",
           "cell_inputs", "cell_program", "mesh_cell", "mesh_train_cell",
           "mesh_of",
           "layer_period", "at_depth", "trace_cell", "engine_dispatches",
           "lockstep_counts", "lower_cell", "main"]

# per-arch train-step defaults (config choices, the JAX package's): the
# 400B MoE needs gradient accumulation + bf16 moments to fit
ARCH_TRAIN_OVERRIDES = {
    "llama4-maverick-400b-a17b": dict(microbatches=4, moment_dtype="bfloat16",
                                      remat="full"),
    "qwen2.5-32b": dict(microbatches=4),
    "zamba2-7b": dict(microbatches=4),
    "gemma2-9b": dict(microbatches=2),
}

ONE_CARD = "1x1"


def mesh_of(name: str):
    """The tracing mesh of rank 0 on a mesh named like the JAX record's
    ``mesh`` ("16x16", "2x16x16", any "AxB" or "AxBxC"; axis names by
    ``mesh_lib.mesh_axes``); None for the one card ("1x1")."""
    if name == ONE_CARD:
        return None
    return mesh_lib.make_tracing_mesh(tuple(int(n) for n in name.split("x")))


def _mesh_name(mesh) -> str:
    return ONE_CARD if mesh is None else "x".join(
        str(n) for n in mesh.shape.values())


def _analytic_model_flops(cfg: ModelConfig, shape: ShapeConfig, params):
    """6 (train) or 2 x active params x tokens, as the JAX dry run counts
    them (padded experts: only the real inactive ones are left out)."""
    n_total = M.param_count(params)
    if cfg.n_experts:
        expert_p = 3 * cfg.d_model * cfg.expert_ff
        n_moe = cfg.n_layers // cfg.moe_every
        n_active = n_total - n_moe * (cfg.padded_experts - cfg.top_k) * expert_p
    else:
        n_active = n_total
    if shape.kind == "decode":
        tokens = shape.global_batch
    elif cfg.family == "encdec" and shape.kind == "prefill":
        tokens = shape.global_batch * cfg.enc_seq  # prefill = encoder pass
    else:
        tokens = shape.global_batch * shape.seq_len
    mult = 6 if shape.kind == "train" else 2
    return mult * n_active * tokens, n_total, n_active


def cell_policy(name: str = "mxsf", kind: str = "train",
                block_mode=None, kv_cache: str = "", save_packed: bool = True,
                attn_quant: bool = True,
                backend: str = "torch") -> QuantPolicy:
    """The policy of one cell, as the JAX dry run builds it: MXSF_TRAIN (or
    the named format; ``bf16``: no quantization), the 1D inference layout
    for serving cells, the packed KV cache for decode cells."""
    if name == "bf16":
        policy = QuantPolicy(block_mode="none")
    else:
        policy = MXSF_TRAIN.replace(fwd_fmt=name, bwd_fmt=name)
    if block_mode:
        policy = policy.replace(block_mode=block_mode)
    if policy.enabled and kind != "train":
        policy = policy.replace(block_mode="1d", quantize_bwd=False)
    if kv_cache and kind == "decode":
        policy = policy.replace(kv_cache_fmt=kv_cache)
    if not save_packed:
        policy = policy.replace(save_packed=False)
    if not attn_quant and policy.enabled:
        policy = policy.replace(attn_matmuls=False)
    return policy.replace(backend=backend)


def cell_config(arch: str, remat: str = "dots", microbatches: int = 1):
    """(TrainConfig, OptConfig) of an arch's train cells: the flags, with
    ``ARCH_TRAIN_OVERRIDES`` where the flag keeps its default."""
    over = ARCH_TRAIN_OVERRIDES.get(arch, {})
    mb = microbatches if microbatches > 1 else over.get("microbatches", 1)
    tcfg = T.TrainConfig(remat=over.get("remat", remat), microbatches=mb)
    ocfg = OptConfig()
    if "moment_dtype" in over:
        ocfg = ocfg.replace(moment_dtype=over["moment_dtype"])
    return tcfg, ocfg


def _draw(spec: torch.Tensor, cfg: ModelConfig, name: str, gen, device):
    """A real batch tensor of a spec's shape and dtype: uniform tokens
    (labels: classes of the encoder), N(0, 1) bf16 frames and patch
    embeddings."""
    if spec.dtype == torch.int32:
        hi = cfg.n_classes if name == "label" else cfg.vocab
        return torch.randint(0, hi, tuple(spec.shape), generator=gen,
                             device=device, dtype=torch.int32)
    return torch.randn(tuple(spec.shape), generator=gen, device=device,
                       dtype=torch.float32).to(spec.dtype)


def cell_inputs(cfg: ModelConfig, shape: ShapeConfig, policy: QuantPolicy,
                ocfg: OptConfig, param_dtype: str = "float32",
                device="meta", generator=None) -> dict:
    """The cell's inputs on ``device``: the train state (``init_state``:
    params, AdamW moments under ``moment_dtype``, step) and the batch of
    ``train_specs``; or the f32 params, the batch and a cache from
    ``init_cache`` (``ring=False``) for a prefill; or the params and
    ``decode_specs``' token, cache (``kv_cache_fmt``) and position (the
    cache's last) for a decode.  ``meta``: shapes only; elsewhere drawn
    from ``generator`` (the cache zeroed)."""
    meta = torch.device(device).type == "meta"
    gen = torch.Generator() if generator is None else generator

    def batch_of(specs):
        return specs if meta else {k: _draw(v, cfg, k, gen, device)
                                   for k, v in specs.items()}

    if shape.kind == "train":
        state = T.init_state(gen, cfg, ocfg, param_dtype=param_dtype,
                             device=device)
        return {"state": state, "batch": batch_of(M.train_specs(cfg, shape))}
    params = M.init_params(cfg, gen, device)
    if shape.kind == "prefill":
        return {"params": params,
                "batch": batch_of(M.train_specs(cfg, shape)),
                "cache": M.init_cache(cfg, shape.global_batch,
                                      shape.seq_len, ring=False,
                                      device=device)}
    B = shape.global_batch
    tokens = M.train_specs(cfg, ShapeConfig("", 1, B, "decode"))["tokens"]
    return {"params": params, "tokens": batch_of({"tokens": tokens})["tokens"],
            "cache": M.init_cache(cfg, B, shape.seq_len,
                                  kv_fmt=policy.kv_cache_fmt, device=device),
            "pos": (torch.empty((), dtype=torch.int32, device=device) if meta
                    else torch.tensor(shape.seq_len - 1, dtype=torch.int32,
                                      device=device))}


def cell_program(cfg: ModelConfig, shape: ShapeConfig, policy: QuantPolicy,
                 tcfg: T.TrainConfig, ocfg: OptConfig):
    """``run(inputs) -> outputs``: the cell's one step through the port's
    entry points."""
    if shape.kind == "train":
        step = T.make_train_step(cfg, policy, ocfg, tcfg)
        return lambda a: step(a["state"], a["batch"])
    if shape.kind == "prefill":
        return lambda a: M.prefill(a["params"], a["batch"], a["cache"], cfg,
                                   policy)
    serve = T.make_serve_step(cfg, policy)
    return lambda a: serve(a["params"], a["tokens"], a["cache"], a["pos"])


def _own(t: torch.Tensor) -> torch.Tensor:
    """A ``meta`` tensor of ``t``'s shape with a storage of its own (a
    rank's rows as the per-device argument the JAX cell counts)."""
    return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")


def mesh_train_cell(cfg: ModelConfig, shape: ShapeConfig,
                    policy: QuantPolicy, mesh, tcfg: T.TrainConfig,
                    ocfg: OptConfig, param_dtype: str = "float32"):
    """One rank's train cell on ``mesh`` (a tracing mesh), on ``meta``:
    (inputs, run, info).  The inputs are the rank's slices of the train
    state (``train.step.state_shardings``, each of its own storage) and
    its rows of the batch (``batch_rows``); ``run`` is the sharded
    ``make_train_step``; ``info`` the TP plan and the batch rows."""
    whole = T.init_state(torch.Generator(), cfg, ocfg, param_dtype,
                         device="meta")
    state = E.place_store(whole, T.state_shardings(cfg, ocfg, mesh,
                                                   param_dtype),
                          mesh, "meta")
    specs = M.train_specs(cfg, shape)
    rows = T.batch_rows(specs, mesh)
    step = T.make_train_step(cfg, policy, ocfg, tcfg, mesh)
    first = next(iter(specs))  # every batch leaf splits its rows alike
    n = rows[first].shape[0]
    lo = n * shd.shard_index(mesh_lib.MeshRules(mesh).data_spec(
        tuple(specs[first].shape))[0], mesh)
    info = {"tp_plan": step.layout.plan._asdict(), "batch_rows": [lo, lo + n]}
    inputs = {"state": state, "batch": {k: _own(v) for k, v in rows.items()}}
    return inputs, lambda a: step(a["state"], a["batch"]), info


def mesh_cell(cfg: ModelConfig, shape: ShapeConfig, policy: QuantPolicy,
              mesh):
    """One rank's serving cell on ``mesh`` (a tracing mesh), on ``meta``:
    (inputs, run, info).  The inputs are the rank's f32 parameter slices
    (``MeshRules``), its cache slices -- the JAX cell's cache, ring for a
    decode (``decode_specs``), whole for a prefill -- and its slot rows of
    the batch (a decode's position is the JAX cell's scalar); ``run`` is
    the engine's dispatch around ``M.decode_step`` or ``M.prefill``;
    ``info`` the attention path, the TP plan, the slot rows and the spec of
    the attention cache (of the SSD state where there is none)."""
    rules = mesh_lib.MeshRules(mesh)
    whole = M.init_params(cfg, torch.Generator(), "meta")
    store_sh = rules.param_sharding_tree(whole)
    params = E.place_store(whole, store_sh, mesh, "meta")
    B = shape.global_batch
    decode = shape.kind == "decode"
    cache, cache_sh, pol, fallback = E.cache_placement(
        cfg, policy, rules, B, shape.seq_len, "meta", ring=decode,
        kv_fmt=policy.kv_cache_fmt if decode else "")
    place = E.placement(cfg, pol, rules, whole, store_sh, cache_sh, cache)
    parts = E.cache_parts(cfg, cache_sh)
    lead = (E.kv_leaf(parts["self"]) if parts["self"] is not None
            else parts["ssd"]["state"])
    info = {"attn_backend": M.decode_attn_backend(cfg, pol, cache_sh),
            "shard_fallback": fallback,
            "tp_plan": place.layout["plan"]._asdict(),
            "slot_rows": [place.rows.start, place.rows.stop],
            "cache_spec": [list(e) if isinstance(e, tuple) else e
                           for e in lead.spec]}
    if decode:
        tokens = M.train_specs(cfg, ShapeConfig("", 1, B, "decode"))[
            "tokens"]
        inputs = {"params": params, "cache": cache,
                  "tokens": _own(*place.rows_of(tokens)),
                  "pos": torch.empty((), dtype=torch.int32, device="meta")}

        def run(a):
            return place.run(lambda: M.decode_step(
                a["params"], a["tokens"], a["cache"], a["pos"], cfg, pol))
    else:
        batch = M.train_specs(cfg, shape)
        inputs = {"params": params, "cache": cache,
                  "batch": {k: _own(*place.rows_of(v))
                            for k, v in batch.items()}}

        def run(a):
            return place.run(lambda: M.prefill(a["params"], a["batch"],
                                               a["cache"], cfg, pol))
    return inputs, run, info


def layer_period(cfg: ModelConfig):
    """(layers in one period of the config's layer pattern, periods, layers
    outside them): a decoder's ``moe_every`` super-layer, twice over where
    SWA alternates; a hybrid's group of SSD layers with its shared block
    (the tail outside); one layer of an SSM, or of an encoder-decoder
    whose encoder is as deep as its decoder (both scale).  None where the
    depth is no whole number of periods."""
    if cfg.family == "hybrid":
        G, per, tail = hybrid_split(cfg)
        return per, G, tail
    if cfg.family == "encdec":
        return (1, cfg.n_layers, 0) if cfg.n_layers == cfg.n_enc_layers \
            else None
    p = cfg.moe_every
    if cfg.swa_pattern == "alternate":
        p = math.lcm(p, 2)
    if cfg.n_layers % p:
        return None
    return p, cfg.n_layers // p, 0


def at_depth(cfg: ModelConfig, k: int) -> ModelConfig:
    """The config cut to ``k`` periods (``layer_period``), the layers
    outside them kept."""
    p, _, rest = layer_period(cfg)
    kw = dict(n_layers=k * p + rest)
    if cfg.family == "encdec":
        kw["n_enc_layers"] = k
    return cfg.replace(**kw)


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, policy: QuantPolicy,
               tcfg: T.TrainConfig, ocfg: OptConfig,
               param_dtype: str = "float32", mesh=None,
               trace: str = "whole"):
    """The tally (``cost.count.tally``) of one cell and its trace: the
    whole program, or (``trace="period"``, at four periods or more) the
    program at two and at three periods of the layer pattern, every count
    scaled linearly to the depth.  The counts are exact where each period
    adds the same (as the layers of a Python loop do); the peak is too
    where the bytes a period adds stay alive to the end (a serving cell's
    cache and parameters: its temporaries reach their steady size by two
    periods), and a lower bound where the peak's position moves with depth
    (a train step's saved activations outgrowing its fixed temporaries).
    Returns (tally, info, trace record)."""
    period = layer_period(cfg) if trace == "period" else None

    def one(c):
        if mesh is None:
            inputs = cell_inputs(c, shape, policy, ocfg, param_dtype)
            run, info = cell_program(c, shape, policy, tcfg, ocfg), {}
        elif shape.kind == "train":
            inputs, run, info = mesh_train_cell(c, shape, policy, mesh,
                                                tcfg, ocfg, param_dtype)
        else:
            inputs, run, info = mesh_cell(c, shape, policy, mesh)
        with cost.count(inputs) as counter:
            out = run(inputs)
        return counter.tally(out), info

    t0 = time.time()
    if period is None or period[1] < 4:
        tally, info = one(cfg)
        rec = {"mode": "whole", "layers": cfg.n_layers}
    else:
        p, k, rest = period
        t2, info = one(at_depth(cfg, 2))
        t3, _ = one(at_depth(cfg, 3))
        tally = cost.extrapolate(t2, t3, k - 1)
        rec = {"mode": "period", "period_layers": p, "periods": k,
               "other_layers": rest,
               "traced_layers": [2 * p + rest, 3 * p + rest],
               "peak": ("a lower bound: the peak moves with depth"
                        if shape.kind == "train" else "extrapolated")}
    rec["seconds"] = round(time.time() - t0, 1)
    return tally, info, rec


def engine_dispatches(cfg: ModelConfig, policy: QuantPolicy, mesh,
                      slots: int, max_len: int, chunk: int,
                      backend: str = "cuda") -> dict:
    """One rank of a serving engine over a packed store on ``mesh`` (a
    tracing mesh), on ``meta``: the ``ServeEngine`` itself, built on this
    rank's slices of ``packed_model_specs``, and the prefill and the
    decode dispatch of ``engine.probe_dispatches``, each counted from its
    arguments -- the engine's store and cache.  Returns
    ``{"prefill": summary, "decode": summary, "attn_backend",
    "shard_fallback", "tp_plan", "store_bytes", "cache_bytes"}``."""
    pol = policy.replace(backend=backend)
    specs = M.packed_model_specs(cfg, pol)
    sh = mesh_lib.MeshRules(mesh).param_sharding_tree(specs)
    eng = E.ServeEngine(cfg, E.place_store(specs, sh, mesh, "meta"), policy,
                        mesh=mesh, backend=backend, device="meta",
                        slots=slots, max_len=max_len, prefill_chunk=chunk,
                        _placed=specs)
    out = {"attn_backend": eng.attn_backend,
           "shard_fallback": eng.shard_fallback,
           "tp_plan": eng.tp_plan._asdict(),
           "store_bytes": E._nbytes(eng.params),
           "cache_bytes": E._nbytes(eng.cache)}
    for kind, cache, run in E.probe_dispatches(eng):
        with cost.count((eng.params, cache)) as counter:
            res = run()
        out[kind] = counter.summary(res, mesh.shape)
    return out


def lockstep_counts(cfg: ModelConfig, policy: QuantPolicy, mesh,
                    batch: dict, max_len: int, backend: str = "cuda") -> dict:
    """One rank of a lockstep placement of any family over a packed store
    on ``mesh`` (a tracing mesh), on ``meta``: this rank's slices of
    ``packed_model_specs`` and of the cache (``engine.cache_placement``,
    ``ring=False``, the policy's KV format), and the prefill of ``batch``
    (tensors on any device: the whole batch) and the decode dispatch of
    ``engine.lockstep_dispatches``, each counted from its arguments -- the
    rank's store and the cache as the dispatch finds it.  Returns
    ``{"prefill": summary, "decode": summary, "attn_backend",
    "shard_fallback", "tp_plan", "store_bytes", "cache_bytes"}``."""
    pol = policy.replace(backend=backend)
    rules = mesh_lib.MeshRules(mesh)
    specs = M.packed_model_specs(cfg, pol)
    sh = rules.param_sharding_tree(specs)
    params = E.place_store(specs, sh, mesh, "meta")
    meta = {k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")
            for k, v in batch.items()}
    B = next(iter(meta.values())).shape[0]
    cache, cache_sh, pol, fallback = E.cache_placement(
        cfg, pol, rules, B, max_len, "meta", ring=False,
        kv_fmt=pol.kv_cache_fmt)
    place = E.placement(cfg, pol, rules, specs, sh, cache_sh, cache)
    out = {"attn_backend": M.decode_attn_backend(cfg, pol, cache_sh),
           "shard_fallback": fallback,
           "tp_plan": place.layout["plan"]._asdict(),
           "store_bytes": E._nbytes(params), "cache_bytes": E._nbytes(cache)}
    for kind, run in E.lockstep_dispatches(cfg, pol, place, params, cache,
                                           meta):
        with cost.count((params, cache)) as counter:
            res = run()
        out[kind] = counter.summary(res, mesh.shape)
    return out


def lower_cell(arch: str, shape_name: str, policy: QuantPolicy,
               tcfg: T.TrainConfig, ocfg: OptConfig,
               param_dtype: str = "float32", mesh=None,
               trace: str = "auto", cfg: ModelConfig = None) -> dict:
    """Trace one cell on ``meta`` under the counter, on one rank of
    ``mesh`` (a tracing mesh; None: one card); returns its record.
    ``trace``: "whole", "period" (``trace_cell``), or "auto" -- the
    layer-period trace on a mesh, the whole program on one card.  ``cfg``:
    the config to trace in place of ``get_config(arch)``."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = M.cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    if trace == "auto":
        trace = "whole" if mesh is None else "period"
    tally, info, trace_rec = trace_cell(cfg, shape, policy, tcfg, ocfg,
                                        param_dtype, mesh, trace)
    rec = cost.summarize(tally, None if mesh is None else mesh.shape)
    params = M.init_params(cfg, torch.Generator(), "meta")
    model_flops, n_total, n_active = _analytic_model_flops(cfg, shape,
                                                           params)
    n_dev = 1 if mesh is None else mesh.size
    flops = rec["cost"]["flops_per_device"]
    per_device = model_flops / n_dev
    return {
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(mesh),
        "n_devices": n_dev,
        "device": "NVIDIA H100 80GB HBM3 (published peaks; meta trace)",
        "trace_seconds": trace_rec["seconds"], "trace": trace_rec,
        **rec,
        "fits": rec["memory"]["peak_bytes_per_device"] <= cost.HBM_BYTES,
        **info,
        "model_flops_global": model_flops,
        "model_flops_per_device": per_device,
        "useful_flops_fraction": per_device / flops if flops else None,
        "params_total": n_total, "params_active": n_active,
        "policy": {"fwd": policy.fwd_fmt, "block_mode": policy.block_mode,
                   "kv_cache": policy.kv_cache_fmt,
                   "param_dtype": param_dtype,
                   "save_packed": policy.save_packed,
                   "backend": policy.backend},
        "train": ({"remat": tcfg.remat, "microbatches": tcfg.microbatches,
                   "moment_dtype": ocfg.moment_dtype}
                  if shape.kind == "train" else None),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="also run the 2x16x16 multi-pod mesh")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="trace this mesh alone: 1x1 (one card), or AxB / "
                    "AxBxC; default: the production meshes")
    ap.add_argument("--trace", default="auto",
                    choices=["auto", "whole", "period"],
                    help="whole program, or the layer-period trace scaled "
                    "to the depth (auto: period on a mesh)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--policy", default="mxsf",
                    choices=["mxsf", "bf16", "mxfp8_e4m3", "mxfp8_e2m5",
                             "mxint8"])
    ap.add_argument("--block-mode", default=None, choices=["1d", "2d", "none"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="dots", choices=["none", "dots", "full"])
    ap.add_argument("--param-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--kv-cache", default="",
                    help="packed KV cache format for decode cells, e.g. mxsf")
    ap.add_argument("--save-packed", type=int, default=1)
    ap.add_argument("--attn-quant", type=int, default=1,
                    help="0: keep QK^T/AV operands unquantized (ablation)")
    ap.add_argument("--backend", default="torch", choices=["torch", "cuda"],
                    help="mx_dot datapath: torch ops, or the CUDA kernels "
                    "(traced through their meta branches)")
    return ap.parse_args(argv)


def _meshes(args):
    """The meshes to trace: ``--mesh`` alone (None: one card), else the
    JAX dry run's production meshes, rank 0 of each (16x16, plus 2x16x16
    under ``--multi-pod``, only that under ``--multi-pod-only``)."""
    if args.mesh:
        return [mesh_of(args.mesh)]
    pods = [] if args.multi_pod_only else [False]
    if args.multi_pod or args.multi_pod_only:
        pods.append(True)
    return [mesh_lib.make_production_mesh(multi_pod=m, trace_rank=0)
            for m in pods]


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    archs = ([a for a in list_configs() if a != "deit-tiny"]
             if args.arch is None else [args.arch])
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    n_ok = n_skip = n_fail = 0
    for mesh in _meshes(args):
        mesh_name = _mesh_name(mesh)
        for arch in archs:
            tcfg, ocfg = cell_config(arch, args.remat, args.microbatches)
            for shape_name in shapes:
                tag = f"{arch}__{shape_name}__{mesh_name}"
                out_path = os.path.join(args.out, tag + ".json")
                try:
                    pol = cell_policy(args.policy, SHAPES[shape_name].kind,
                                      args.block_mode, args.kv_cache,
                                      bool(args.save_packed),
                                      bool(args.attn_quant), args.backend)
                    rec = lower_cell(arch, shape_name, pol, tcfg, ocfg,
                                     param_dtype=args.param_dtype,
                                     mesh=mesh, trace=args.trace)
                    if "skipped" in rec:
                        n_skip += 1
                        print(f"[skip] {tag}: {rec['skipped']}")
                    else:
                        n_ok += 1
                        r, mem = rec["roofline"], rec["memory"]
                        print(f"[ ok ] {tag}: trace={rec['trace_seconds']}s"
                              f" ({rec['trace']['mode']})"
                              f" peak={mem['peak_bytes_per_device'] / 1e9:.2f}GB"
                              f" fits={rec['fits']}"
                              f" compute={r['compute_s'] * 1e3:.2f}ms"
                              f" mem={r['memory_s'] * 1e3:.2f}ms"
                              f" coll={r['collective_s'] * 1e3:.2f}ms"
                              f" dom={r['dominant']}", flush=True)
                    with open(out_path, "w") as f:
                        json.dump(rec, f, indent=1)
                except Exception as e:  # noqa: BLE001 -- one cell's fault
                    n_fail += 1
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    with open(out_path + ".err", "w") as f:
                        f.write(traceback.format_exc())
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
