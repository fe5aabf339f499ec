"""One-card dry run: trace every (arch x shape) cell on ``meta`` tensors and
count what its program would run on one H100.

Counterpart of the JAX package's ``launch/dryrun.py`` (``lower_cell`` and
``main``).  There each cell is lowered and compiled for a TPU mesh, and
XLA's memory analysis and the HLO walk (``hlo_cost``) say whether it fits
and what bounds it.  Here the cell's real program -- ``make_train_step``
for train shapes, ``M.prefill`` for prefill shapes, ``M.decode_step``
(``make_serve_step``) for decode shapes -- runs once on ``meta`` tensors
(shapes only: nothing is computed or allocated, so no card is needed)
under ``launch/cost.count``, which counts every aten op and every kernel
launch (the kernel wrappers' ``meta`` branches, with ``--backend cuda``)
and the bytes alive at once.  Each cell's record has the JAX record's keys
where they mean something on one card:

  * ``memory``    -- argument, output and temp bytes and
                     ``peak_bytes_per_device`` (argument + temp), and
                     ``fits``: the peak against the card's 80 GB;
  * ``cost``      -- FLOPs (bf16 tensor-core and f32 shares), HBM bytes,
                     aten ops and kernel launches by kernel;
  * ``roofline``  -- ``compute_s`` (each op's FLOPs over its rate),
                     ``memory_s`` (bytes over 3.35 TB/s) and ``dominant``;
                     one card: ``collectives`` {}, ``collective_s`` 0,
                     ``mesh`` "1x1";
  * ``model_flops_global``, ``useful_flops_fraction``, ``params_total``,
    ``params_active``, ``policy``.

A meta trace is slow (PyTorch's meta functions are Python decompositions,
~0.4 ms an aten op), so a full-width cell on the value-domain attention
path takes tens of seconds.  The dry run on a mesh (``--multi-pod``, a
per-rank trace, the collectives) is not ported yet (ROADMAP.md, "The dry
run on a mesh"); the engine's sharding is (``launch/mesh.py``).  Results
land in ``experiments/dryrun_torch/<arch>__<shape>__1x1.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--backend cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs.base import SHAPES, ModelConfig, ShapeConfig, get_config, \
    list_configs
from ..core.policy import MXSF_TRAIN, QuantPolicy
from ..models import model as M
from ..optim.adamw import OptConfig
from ..train import step as T
from . import cost

__all__ = ["ARCH_TRAIN_OVERRIDES", "cell_policy", "cell_config",
           "cell_inputs", "cell_program", "lower_cell", "main"]

# per-arch train-step defaults (config choices, the JAX package's): the
# 400B MoE needs gradient accumulation + bf16 moments to fit
ARCH_TRAIN_OVERRIDES = {
    "llama4-maverick-400b-a17b": dict(microbatches=4, moment_dtype="bfloat16",
                                      remat="full"),
    "qwen2.5-32b": dict(microbatches=4),
    "zamba2-7b": dict(microbatches=4),
    "gemma2-9b": dict(microbatches=2),
}

MESH = "1x1"


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


def lower_cell(arch: str, shape_name: str, policy: QuantPolicy,
               tcfg: T.TrainConfig, ocfg: OptConfig,
               param_dtype: str = "float32") -> dict:
    """Trace one cell on ``meta`` under the counter; returns its record."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = M.cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    t0 = time.time()
    inputs = cell_inputs(cfg, shape, policy, ocfg, param_dtype)
    run = cell_program(cfg, shape, policy, tcfg, ocfg)
    with cost.count(inputs) as counter:
        out = run(inputs)
    rec = counter.summary(out)
    del out
    params = (inputs["state"]["params"] if shape.kind == "train"
              else inputs["params"])
    model_flops, n_total, n_active = _analytic_model_flops(cfg, shape,
                                                           params)
    flops = rec["cost"]["flops_per_device"]
    return {
        "arch": arch, "shape": shape_name, "mesh": MESH, "n_devices": 1,
        "device": "NVIDIA H100 80GB HBM3 (published peaks; meta trace)",
        "trace_seconds": round(time.time() - t0, 1),
        **rec,
        "fits": rec["memory"]["peak_bytes_per_device"] <= cost.HBM_BYTES,
        "collectives": {},
        "model_flops_global": model_flops,
        "model_flops_per_device": model_flops,
        "useful_flops_fraction": model_flops / flops if flops else None,
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
                    help="also run the multi-pod mesh (not ported: one card)")
    ap.add_argument("--multi-pod-only", action="store_true")
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


def main(argv=None):
    args = parse_args(argv)
    if args.multi_pod or args.multi_pod_only:
        raise NotImplementedError("the dry run on a mesh is not ported "
                                  "yet; it covers one card (ROADMAP.md, "
                                  "\"The dry run on a mesh\")")
    os.makedirs(args.out, exist_ok=True)
    archs = ([a for a in list_configs() if a != "deit-tiny"]
             if args.arch is None else [args.arch])
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    n_ok = n_skip = n_fail = 0
    for arch in archs:
        tcfg, ocfg = cell_config(arch, args.remat, args.microbatches)
        for shape_name in shapes:
            tag = f"{arch}__{shape_name}__{MESH}"
            out_path = os.path.join(args.out, tag + ".json")
            try:
                pol = cell_policy(args.policy, SHAPES[shape_name].kind,
                                  args.block_mode, args.kv_cache,
                                  bool(args.save_packed),
                                  bool(args.attn_quant), args.backend)
                rec = lower_cell(arch, shape_name, pol, tcfg, ocfg,
                                 param_dtype=args.param_dtype)
                if "skipped" in rec:
                    n_skip += 1
                    print(f"[skip] {tag}: {rec['skipped']}")
                else:
                    n_ok += 1
                    r, mem = rec["roofline"], rec["memory"]
                    print(f"[ ok ] {tag}: trace={rec['trace_seconds']}s"
                          f" peak={mem['peak_bytes_per_device'] / 1e9:.2f}GB"
                          f" fits={rec['fits']}"
                          f" compute={r['compute_s'] * 1e3:.2f}ms"
                          f" mem={r['memory_s'] * 1e3:.2f}ms"
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
