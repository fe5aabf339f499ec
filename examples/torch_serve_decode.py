"""Serving demo on the PyTorch/CUDA port: continuous batching through
``ServeEngine`` with the MXSF inference policy (1x64 blocks), a packed KV
cache and the pack-once weight store (weights quantized ONCE to resident
MXSF codes).

    PYTHONPATH=src python examples/torch_serve_decode.py [--arch h2o-danube-1.8b-reduced]
    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu

The port's counterpart of ``examples/serve_decode.py``.  ``--backend cuda``
(the default) runs the hand-written kernels on the card and their plain
versions on the CPU.  ``--mesh DxM`` serves sharded over a data x model
mesh, one process per rank, started by ``torchrun`` (which sets the
process group's address, rank and world size); nccl when every rank has
a card of its own, else gloo:

    PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_serve_decode.py --device cpu --mesh 2x2

An MoE config serves the same way, each rank running its own experts
(expert parallelism over the model axis):

    PYTHONPATH=src torchrun --nproc-per-node 2 examples/torch_serve_decode.py --device cpu --mesh 1x2 --arch qwen2-moe-a2.7b-reduced

``--prefill-chunk auto`` is the port's ``auto_prefill_chunk``: the
engine-shape heuristic, floored by a measured chunk where a
``BENCH_kernel.json`` (or ``$BENCH_KERNEL_JSON``) has one, as in the JAX
package.
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
                    help="DxM mesh (axes data x model) over the ranks "
                    "torchrun starts")
    ap.add_argument("--backend", default="cuda", choices=("torch", "cuda"),
                    help="mx_dot datapath; cuda also engages the packed-KV "
                    "flash-attention kernel where eligible")
    ap.add_argument("--no-pack", action="store_true",
                    help="keep full-precision weights (re-quantize per call)")
    ap.add_argument("--device", default=None,
                    help="'cpu', or the card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh, rank = None, 0
    if args.mesh:
        import os
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_test_mesh
        if "RANK" not in os.environ:
            raise SystemExit("--mesh: start the ranks with torchrun "
                             "--nproc-per-node D*M")
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        own_card = (device.type == "cuda"
                    and world <= torch.cuda.device_count())
        if device.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group("nccl" if own_card else "gloo")
        d, m = (int(v) for v in args.mesh.lower().split("x"))
        mesh = make_test_mesh(d, m)
        if rank == 0:
            print(f"mesh: {mesh.shape} over {world} ranks "
                  f"({dist.get_backend()})")

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
                      backend=args.backend, device=device, mesh=mesh)
    say = print if rank == 0 else (lambda *a, **k: None)
    nb = eng.store_nbytes
    say(f"weight store: {nb['packed'] / 1e6:.2f} MB packed "
          f"(+{nb['value'] / 1e6:.2f} MB value leaves) vs "
          f"{nb['value_f32'] / 1e6:.2f} MB f32 "
          f"({nb['value_f32'] / max(nb['packed'], 1):.1f}x smaller); "
          f"attn={eng.attn_backend} prefill_chunk={eng.prefill_chunk}")

    gen = torch.Generator().manual_seed(1)
    for _ in range(args.requests):
        prompt = torch.randint(0, cfg.vocab, (args.prompt_len,),
                               generator=gen).tolist()
        eng.submit(prompt, args.gen)
    say(f"serving {args.requests} x ({args.prompt_len} prompt + "
          f"{args.gen} gen) on {args.batch} slots ...")
    t0 = time.time()
    finished = eng.run()
    dt = time.time() - t0

    st = eng.stats()  # a collective under a mesh: every rank calls it
    tps = st["tokens_generated"] / dt
    say(f"generated {st['tokens_generated']} tokens in {dt:.2f}s "
          f"({tps:.1f} tok/s on {device}) -- "
          f"{st['prefill_dispatches']} prefill + "
          f"{st['decode_dispatches']} decode dispatches over "
          f"{st['ticks']} ticks, occupancy {st['occupancy']:.2f}")
    for dev, nbytes in sorted(st["store_nbytes_per_device"].items()):
        cache_b = st["cache_nbytes_per_device"].get(dev, 0)
        say(f"  {dev}: store {nbytes / 1e6:.2f} MB, "
              f"cache {cache_b / 1e6:.2f} MB")
    say("sample:", finished[0].out[:16])
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
