"""Fault-tolerant training loop: auto-resume, failure injection, stragglers.

PyTorch counterpart of the JAX package's ``runtime/fault.py``.  The data
side is a pure function of (seed, step) (``data/pipeline.py``), so a
restart replays from the last checkpoint and, where every op of the step
is deterministic, ends bit for bit where an uninterrupted run ends
(``tests/test_torch_ckpt.py`` on the CPU; ``chip_smoke.py`` phase
``train_resume`` on the card).

  * node failure  -> every worker calls ``resume_or_init`` and rejoins at
    the last durable step; saves are async and renamed into place.
  * stragglers    -> ``StragglerWatchdog`` keeps each step's wall time and
    counts the steps slower than ``threshold`` x the recent median.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from ..ckpt import ckpt

__all__ = ["FaultConfig", "StragglerWatchdog", "train_loop",
           "FailureInjected", "resume_or_init"]


class FailureInjected(RuntimeError):
    pass


@dataclasses.dataclass
class FaultConfig:
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 20
    keep: int = 3
    async_save: bool = False
    fail_at_step: Optional[int] = None    # failure injection (tests)
    straggler_threshold: float = 3.0


class StragglerWatchdog:
    def __init__(self, threshold: float = 3.0,
                 on_straggler: Optional[Callable] = None):
        self.threshold = threshold
        self.times = []
        self.straggler_steps = []
        self.on_straggler = on_straggler

    def observe(self, step: int, dt: float):
        self.times.append(dt)
        hist = sorted(self.times[-50:])
        med = hist[len(hist) // 2]
        if len(self.times) > 5 and dt > self.threshold * med:
            self.straggler_steps.append(step)
            if self.on_straggler:
                self.on_straggler(step, dt, med)


def resume_or_init(fcfg: FaultConfig, init_fn):
    """Restore the latest checkpoint if one exists, else initialize.  The
    restore target is ``init_fn()``'s tree: the restored leaves take its
    shapes, dtypes and devices."""
    state = init_fn()
    latest = ckpt.latest_step(fcfg.ckpt_dir)
    if latest is None:
        return state, 0
    return ckpt.restore(fcfg.ckpt_dir, state, step=latest)


def train_loop(fcfg: FaultConfig, init_fn, step_fn, batch_fn, n_steps: int,
               metrics_cb: Optional[Callable] = None):
    """Run to ``n_steps`` with periodic checkpoints and auto-resume.

    ``step_fn(state, batch) -> (state, metrics)``; ``batch_fn(step)`` must be
    deterministic in ``step`` (restart reproducibility).  The metrics are
    read to the host after each step, which waits for the device, so the
    watchdog times what the device did; ``metrics_cb(step, metrics)`` gets
    them as floats.  Returns (state, watchdog).
    """
    state, start = resume_or_init(fcfg, init_fn)
    dog = StragglerWatchdog(fcfg.straggler_threshold)
    for step in range(start, n_steps):
        if fcfg.fail_at_step is not None and step == fcfg.fail_at_step:
            raise FailureInjected(f"injected failure at step {step}")
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch_fn(step))
        metrics = {k: float(v) for k, v in metrics.items()}
        dog.observe(step, time.perf_counter() - t0)
        if metrics_cb:
            metrics_cb(step, metrics)
        if (step + 1) % fcfg.ckpt_every == 0 or step + 1 == n_steps:
            ckpt.save(fcfg.ckpt_dir, step + 1, state, keep=fcfg.keep,
                      blocking=not fcfg.async_save)
    ckpt.wait_pending()
    return state, dog
