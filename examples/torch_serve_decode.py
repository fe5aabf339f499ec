"""Serving demo on the PyTorch/CUDA port: continuous batching through
``ServeEngine`` with the MXSF inference policy (1x64 blocks), a packed KV
cache and the pack-once weight store (weights quantized ONCE to resident
MXSF codes).

    PYTHONPATH=src python examples/torch_serve_decode.py [--arch h2o-danube-1.8b-reduced]
    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu

The port's counterpart of ``examples/serve_decode.py``.  ``--backend cuda``
(the default) runs the hand-written kernels on the card and their plain
versions on the CPU.  Sharded serving (``--mesh``) is not ported yet
(ROADMAP.md, Queue 1 item 5).  ``--prefill-chunk auto`` is the port's
``auto_prefill_chunk``: the engine-shape heuristic, without the JAX
package's measured floor (no kernel benchmark is ported).
"""
import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.policy import MXSF_INFER
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b-reduced")
    ap.add_argument("--batch", type=int, default=4, help="engine slots")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prefill-chunk", default="auto",
                    help="int or 'auto' (from max_len and slots)")
    ap.add_argument("--mesh", default=None,
                    help="DxM device mesh (not ported yet)")
    ap.add_argument("--backend", default="cuda", choices=("torch", "cuda"),
                    help="mx_dot datapath; cuda also engages the packed-KV "
                    "flash-attention kernel where eligible")
    ap.add_argument("--no-pack", action="store_true",
                    help="keep full-precision weights (re-quantize per call)")
    ap.add_argument("--device", default=None,
                    help="'cpu', or the card (the default)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError("sharded serving is not ported yet; see "
                                  "ROADMAP.md, Queue 1 item 5")
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    # the CUDA kernels take the paper's 1x64 inference rows
    policy = MXSF_INFER.replace(kv_cache_fmt="mxsf")
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    chunk = (args.prefill_chunk if args.prefill_chunk == "auto"
             else int(args.prefill_chunk))
    max_len = args.prompt_len + args.gen
    eng = ServeEngine(cfg, params, policy, slots=args.batch, max_len=max_len,
                      pack_weights=not args.no_pack, prefill_chunk=chunk,
                      backend=args.backend, device=device)
    nb = eng.store_nbytes
    print(f"weight store: {nb['packed'] / 1e6:.2f} MB packed "
          f"(+{nb['value'] / 1e6:.2f} MB value leaves) vs "
          f"{nb['value_f32'] / 1e6:.2f} MB f32 "
          f"({nb['value_f32'] / max(nb['packed'], 1):.1f}x smaller); "
          f"attn={eng.attn_backend} prefill_chunk={eng.prefill_chunk}")

    gen = torch.Generator().manual_seed(1)
    for _ in range(args.requests):
        prompt = torch.randint(0, cfg.vocab, (args.prompt_len,),
                               generator=gen).tolist()
        eng.submit(prompt, args.gen)
    print(f"serving {args.requests} x ({args.prompt_len} prompt + "
          f"{args.gen} gen) on {args.batch} slots ...")
    t0 = time.time()
    finished = eng.run()
    dt = time.time() - t0

    st = eng.stats()
    tps = st["tokens_generated"] / dt
    print(f"generated {st['tokens_generated']} tokens in {dt:.2f}s "
          f"({tps:.1f} tok/s on {device}) -- "
          f"{st['prefill_dispatches']} prefill + "
          f"{st['decode_dispatches']} decode dispatches over "
          f"{st['ticks']} ticks, occupancy {st['occupancy']:.2f}")
    for dev, nbytes in sorted(st["store_nbytes_per_device"].items()):
        cache_b = st["cache_nbytes_per_device"].get(dev, 0)
        print(f"  {dev}: store {nbytes / 1e6:.2f} MB, "
              f"cache {cache_b / 1e6:.2f} MB")
    print("sample:", finished[0].out[:16])


if __name__ == "__main__":
    main()
