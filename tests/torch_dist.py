"""Multi-process worlds for the port's sharding tests: gloo ranks on the
CPU, standing in for the JAX package's forced host devices.

``run_ranks(fn, world, *args)`` spawns ``world`` processes on a free
localhost port, each with one thread and a gloo process group whose
collectives time out after 60 s, calls ``fn(rank, *args)`` in each and
returns the results by rank.  The whole world has a time limit: a rank
that fails, dies or outlives it fails the call, and every rank still
running is killed, so a hung collective fails one test instead of the
suite.
"""
import os
import queue
import socket
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD_TIMEOUT_S = 240  # one world, start-up and every engine included


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, out, args):
    """One rank: ``fn``'s result (or its traceback) to the parent.  A rank
    whose ``fn`` returned meets its peers at a barrier before the group is
    torn down, so no rank destroys its group (rank 0 hosts the group's
    store) while a peer is still in a collective or its teardown."""
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    ended = False
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=timedelta(seconds=60))
        out.put((rank, True, fn(rank, *args)))
        ended = True
    except BaseException:  # reported to the parent, which fails the test
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            if ended:
                dist.barrier()
            dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = WORLD_TIMEOUT_S):
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each in its own
    gloo rank; raises if a rank fails or the world outlives ``timeout``."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, out, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results, failed = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(failed) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"world of {world} ranks outlived "
                                   f"{timeout} s; got ranks {sorted(results)}")
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank died (exit {dead[0]}) "
                                       "without reporting")
                continue
            if ok:
                results[rank] = payload
            else:
                failed.append(f"rank {rank}:\n{payload}")
                break  # the others may wait forever on the failed rank
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        raise AssertionError("\n".join(failed))
    return [results[r] for r in range(world)]
