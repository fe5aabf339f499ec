#!/usr/bin/env python3
"""Time this checkout's kernels against another checkout's, in turns, on
one CUDA device.

    python3 scripts/compare_kernels.py --old DIR [--out FILE]

DIR is another checkout of this repository (e.g. ``git archive`` of an
earlier commit unpacked into a directory that ``.gitignore`` lists).  Both
packages are imported side by side (the other one as ``repro_torch_old``)
and each builds its own kernels.  At every shape of the kernel table --
the fused matmul at the serving shapes of qwen2.5-32b (M = 4 and 64 rows,
bf16 x) and at the training shapes of h2o-danube-1.8b (M = 2048: (8,8) and
(1,64) x with emit_codes, raw f32 g), mx_matmul's dx and dw of the gate
projection, the packed-KV attention at the serving shapes of
``chip_smoke.py`` (qwen2.5-32b heads, 4 slots of 512 keys, S = 1 and 16)
and the quantizer at its four training shapes ((8,8) on the bf16 gate
weight and on an f32 gradient, (64,1) on the weight, (1,64) on the
activations) and the requantizer at the 1D backward's two shapes (the
weight's (64,1)->(1,64) and the activations' (1,64)->(64,1), each written
transposed -- the other tree's call followed by ``.T.contiguous()`` where
it has no ``transpose`` -- and plain) -- each kernel is timed old, new,
new, old (CUDA events, L2 flushed before every launch, mean of 10 launches
each), and the two outputs are compared (codes and scales bit for bit).  One JSON line per
shape, the card's name and power limit before them; ``--out`` also writes
them to FILE.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def load_old(root: Path):
    """The other checkout's package, imported as ``repro_torch_old``."""
    pkg = root / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "repro_torch_old", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["repro_torch_old"] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    load_old(args.old.resolve())
    import importlib
    names = ("mx_matmul", "mxsf_fused_matmul", "mxsf_attention",
             "mxsf_quant")
    new = {n: importlib.import_module(f"repro_torch.kernels.{n}")
           for n in names}
    old = {n: importlib.import_module(f"repro_torch_old.kernels.{n}")
           for n in names}
    from repro_torch.core import blocking as B
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def timeit(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters

    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def packed(shape, blk):
        qt = B.quantize(torch.randn(shape, generator=gen, device=dev),
                        "mxsf", blk)
        return qt.codes, qt.scale_e8m0

    cases = []
    for m in (4, 64):
        for k, n in ((5120, 5120), (5120, 1024), (5120, 27648),
                     (27648, 5120), (5120, 153600)):
            cases.append(("fused serving", m, k, n, (1, 64), (64, 1), True,
                          False))
    cases += [("fused (8,8) emit", 2048, 2560, 6912, (8, 8), (8, 8), True,
               True),
              ("fused (1,64) emit", 2048, 2560, 6912, (1, 64), (64, 1), True,
               True),
              ("fused raw g", 2048, 6912, 2560, (8, 8), (8, 8), False,
               False)]
    rows = []
    for name, m, k, n, xblk, wblk, qlhs, emit in cases:
        x = torch.randn((m, k), generator=gen, device=dev)
        if qlhs:
            x = x.to(torch.bfloat16)
        w = packed((k, n), wblk)
        calls = {v: (lambda mod=mods["mxsf_fused_matmul"]: mod.mxsf_fused_matmul(
            x, *w, xblk, wblk, qlhs, emit)) for v, mods in (("old", old),
                                                          ("new", new))}
        rows.append(run(torch, timeit, name, (m, k, n), calls, emit))
        del x, w
    for name, m, k, n in (("mx_matmul dx", 2048, 6912, 2560),
                          ("mx_matmul dw", 2560, 2048, 6912)):
        a, b = packed((m, k), (8, 8)), packed((k, n), (8, 8))
        calls = {v: (lambda mod=mods["mx_matmul"]: mod.mxsf_matmul(
            *a, *b, (8, 8), (8, 8))) for v, mods in (("old", old),
                                                     ("new", new))}
        rows.append(run(torch, timeit, name, (m, k, n), calls, False))
    # attention: qwen2.5-32b's heads over 4 slots of 512 keys
    slots, L, h, kv, dh = 4, 512, 40, 8, 128
    cache = []
    for _ in range(2):
        qt = B.quantize(torch.randn((slots, L, kv, dh), generator=gen,
                                    device=dev), "mxsf", (dh,))
        cache += [qt.codes, qt.scale_e8m0]
    kvl = torch.tensor([0, 170, 507, 512],
                       dtype=torch.int32).repeat_interleave(h)
    win = torch.full_like(kvl, 1 << 30)
    win[h:2 * h] = 64
    for S in (1, 16):
        q = torch.randn((slots * h, S, dh), generator=gen,
                        device=dev).to(torch.bfloat16)
        kw = dict(causal=True, kv_len=kvl.to(dev),
                  q_offset=torch.clamp(kvl - S, min=0).to(dev),
                  window=win.to(dev))
        calls = {v: (lambda mod=mods["mxsf_attention"]: mod.mxsf_attention(
            q, *cache, **kw)) for v, mods in (("old", old), ("new", new))}
        rows.append(run(torch, timeit, f"attention S={S}",
                        (slots * h, S, L), calls, False))
    # the quantizer at the training shapes of h2o-danube-1.8b
    w = (torch.randn((2560, 6912), generator=gen, device=dev)
         / 50.6).to(torch.bfloat16)
    g = torch.randn((2048, 6912), generator=gen, device=dev) * 1e-4
    x = torch.randn((2048, 2560), generator=gen, device=dev).to(
        torch.bfloat16)
    for name, t, blk in (("quantize (8,8) wg", w, (8, 8)),
                         ("quantize (8,8) g", g, (8, 8)),
                         ("quantize (64,1) wg", w, (64, 1)),
                         ("quantize (1,64) x", x, (1, 64))):
        calls = {v: (lambda mod=mods["mxsf_quant"]: mod.mxsf_quantize(
            t, blk)) for v, mods in (("old", old), ("new", new))}
        row = run(torch, timeit, name, (*t.shape, 0), calls, False,
                  codes=True)
        nbytes = t.numel() * t.element_size() + t.numel() * (
            1 + 1 / (blk[0] * blk[1]))
        row["bound_ms"] = nbytes / 3.35e12 * 1e3  # HBM at 3.35 TB/s
        row["new_bound_share"] = row["bound_ms"] / row["new_ms"]
        print(json.dumps({"bound": name, "bound_ms": row["bound_ms"],
                          "new_bound_share": row["new_bound_share"]}),
              flush=True)
        rows.append(row)
    # the requantizer at the 1D backward's shapes: w (64,1)->(1,64) and x
    # (1,64)->(64,1), each written transposed (the old tree's call followed
    # by .T.contiguous() of codes and scales) and plain
    w64 = B.quantize(w, "mxsf", (64, 1))
    x64 = B.quantize(x, "mxsf", (1, 64))
    for name, qt, fb, tb in (("requantize wg", w64, (64, 1), (1, 64)),
                             ("requantize x", x64, (1, 64), (64, 1))):
        c, sc = qt.codes, qt.scale_e8m0
        for transpose in (True, False):
            if transpose:
                calls = {"old": lambda mq=old["mxsf_quant"]: tuple(
                             t.T.contiguous() for t in mq.mxsf_requantize(
                                 c, sc, fb, tb)),
                         "new": lambda mq=new["mxsf_quant"]: mq.mxsf_requantize(
                             c, sc, fb, tb, transpose=True)}
            else:
                calls = {v: (lambda mq=mods["mxsf_quant"]: mq.mxsf_requantize(
                    c, sc, fb, tb)) for v, mods in (("old", old),
                                                    ("new", new))}
            label = f"{name} {fb}->{tb}{' transposed' if transpose else ''}"
            row = run(torch, timeit, label, (*c.shape, 0), calls, False,
                      codes=True)
            nbytes = 2 * (c.numel() + sc.numel())
            row["bound_ms"] = nbytes / 3.35e12 * 1e3  # HBM at 3.35 TB/s
            row["new_bound_share"] = row["bound_ms"] / row["new_ms"]
            print(json.dumps({"bound": label, "bound_ms": row["bound_ms"],
                              "new_bound_share": row["new_bound_share"]}),
                  flush=True)
            rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"nvidia_smi": smi, "rows": rows}, indent=1))
    return 0


def run(torch, timeit, name, shape, calls, emit, codes=False):
    """old, new, new, old; the outputs' largest difference relative to the
    largest output (both take the same inputs), or with ``codes`` whether
    the (codes, scales) pairs are equal bit for bit."""
    y_old, y_new = calls["old"](), calls["new"]()
    if codes:
        diff = 0.0 if all(torch.equal(a, b) for a, b in zip(y_old, y_new)) \
            else float("nan")
        if diff != 0.0:
            raise AssertionError(f"{name}: old and new codes differ")
    else:
        if emit:
            y_old, y_new = y_old[0], y_new[0]
        y_old, y_new = y_old.float(), y_new.float()
        diff = float((y_old - y_new).abs().max()
                     / y_old.abs().max().clamp_min(1e-30))
    t = [timeit(calls[v]) for v in ("old", "new", "new", "old")]
    row = dict(kernel=name, m=shape[0], k=shape[1], n=shape[2],
               old_ms=(t[0] + t[3]) / 2, new_ms=(t[1] + t[2]) / 2,
               turns_ms=t, rel_diff=diff)
    row["speedup"] = row["old_ms"] / row["new_ms"]
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    sys.exit(main())
