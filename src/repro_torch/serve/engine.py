"""Continuous-batching serving engine (single device).

PyTorch counterpart of the JAX package's ``serve/engine.py``.  A fixed pool
of batch slots shares two entry points -- ``decode_step`` (one token per
slot) and ``prefill_step`` (one C-token prompt chunk per slot) -- and each
slot carries its own position and phase:

  * **prefill phase** -- queued prompt tokens drain C at a time, so a
    P-token prompt costs ceil(P/C) prefill dispatches;
  * **decode phase** -- the slot feeds back its last sampled token.

Each tick issues (up to) one decode dispatch for the decode-phase slots,
then one prefill dispatch for the prefill-phase slots; both carry the full
slot batch and mask the other phase's slots (``n_valid=0`` in the prefill
dispatch; a discarded token in the decode dispatch, whose stale column the
prefill dispatch of the same tick overwrites before anything reads it).
``prefill_chunk=1`` is the token-by-token schedule (prompt tokens ride the
decode dispatch); MoE configs always take it, as in the JAX package.

Generation stops at ``max_new`` tokens, a full cache, or the request's
``eos_id`` (kept in ``Request.out``).

Decoder families only, as in the JAX package (an SSM or hybrid state
advances per token; an encoder-decoder prefills its frames first): serve
those through ``models.prefill`` + ``decode_step``.  A VLM serves text
only: its positions shift past the ``frontend_tokens`` prefix columns,
which stay unwritten.

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do): ``device=None`` means ``"cuda"`` and
raises when CUDA is absent.  ``backend="cuda"`` selects the kernel datapath;
on CPU tensors the kernels' plain versions run.  ``from_checkpoint`` builds
an engine straight from a packed checkpoint; sharded serving (``mesh``) is
not ported yet (ROADMAP.md, Queue 1 item 5).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, List, Optional, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import packed_store
from ..core.blocking import QuantizedTensor, torch_dtype
from ..core.policy import QuantPolicy
from ..device import resolve_device
from ..models import model as M

__all__ = ["Request", "ServeEngine", "auto_prefill_chunk", "resolve_device"]


def auto_prefill_chunk(max_len: int, slots: int) -> int:
    """Resolve ``prefill_chunk="auto"`` from the engine shape: the chunk
    that fills one 256-row M tile across the slot batch, so a full-length
    prompt still drains in >= 4 chunks, rounded down to a power of two.
    (The JAX package also floors C by a measured ``BENCH_kernel.json`` row;
    the port has no such measurement yet.)"""
    c = max(1, min(max_len // 4, 256 // max(slots, 1)))
    c = 1 << (c.bit_length() - 1)
    return max(1, min(c, max_len))


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new: int
    eos_id: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _nbytes(tree) -> int:
    """Bytes the tensors of a tree occupy (packed leaves: codes + scales,
    block padding included)."""
    total = 0
    for leaf in packed_store.tree_leaves(tree):
        for t in ((leaf.codes, leaf.scale_e8m0)
                  if isinstance(leaf, QuantizedTensor) else (leaf,)):
            total += t.numel() * t.element_size()
    return total


def _to_device(tree, device):
    return packed_store.tree_map(lambda leaf: leaf.to(device), tree)


class ServeEngine:
    """Fixed-slot continuous batching over prefill_step + decode_step."""

    def __init__(self, cfg: ModelConfig, params, policy: QuantPolicy,
                 slots: int = 4, max_len: int = 256,
                 sampler: Optional[Callable] = None,
                 backend: Optional[str] = None,
                 pack_weights: Optional[bool] = None,
                 prefill_chunk: Union[int, str] = 16,
                 eos_id: Optional[int] = None,
                 device=None):
        if cfg.family != "decoder":
            raise NotImplementedError(
                "continuous batching needs per-slot recurrent-state "
                "checkpointing for SSM/hybrid families")
        self.device = resolve_device(device)
        if backend is not None:
            policy = policy.replace(backend=backend)
            _ = policy.use_kernels  # validate at construction
        self.cfg = cfg
        # the cache's precision follows the compute dtype, as in the JAX
        # engine: a bf16 cache under an f32 config would round K/V
        self.cache = M.init_cache(cfg, slots, max_len,
                                  dtype=torch_dtype(cfg.compute_dtype),
                                  ring=False, kv_fmt=policy.kv_cache_fmt,
                                  device=self.device)
        can_pack = packed_store.packable_policy(policy)
        if pack_weights and not can_pack:
            raise ValueError(
                "pack_weights=True needs a quantizing policy with a real "
                f"element format; got block_mode={policy.block_mode!r}, "
                f"fwd_fmt={policy.fwd_fmt!r}")
        self.packed = can_pack and (pack_weights is None or pack_weights)
        params = _to_device(params, self.device)
        if self.packed:
            params = M.pack_model_params(cfg, params, policy)
        self.params = params
        self.store_nbytes = packed_store.store_nbytes(params)
        self.attn_backend = M.decode_attn_backend(cfg, policy)
        self.policy = policy
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.sampler = sampler or (lambda logits: torch.argmax(logits, -1))
        self.pos = np.zeros(slots, np.int32)
        self.live: List[Optional[Request]] = [None] * slots
        self.pending_prompt: List[Deque[int]] = [deque() for _ in range(slots)]
        self.queue: Deque[Request] = deque()
        self.last_tok = np.zeros(slots, np.int32)
        if prefill_chunk == "auto":
            chunk = auto_prefill_chunk(max_len, slots)
        elif isinstance(prefill_chunk, str):
            raise ValueError(f"prefill_chunk={prefill_chunk!r}: expected an "
                             "int or 'auto'")
        else:
            chunk = max(1, min(int(prefill_chunk), max_len))
        if cfg.n_experts > 0:
            chunk = 1  # expert capacity is sized per dispatch
        self.prefill_chunk = chunk
        self.prefill_dispatches = 0
        self.decode_dispatches = 0
        self.tokens_generated = 0
        # host-clock seconds per phase, each dispatch timed through the
        # copy of its sampled tokens to the host (which waits for the card)
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self._live_slot_ticks = 0
        self._uid = 0
        self.ticks = 0

    def _decode(self, params, tokens, cache, pos):
        return M.decode_step(params, tokens, cache, pos, self.cfg,
                             self.policy)

    def _prefill(self, params, tokens, cache, pos, n_valid):
        return M.prefill_step(params, tokens, cache, pos, n_valid, self.cfg,
                              self.policy)

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), device=self.device)

    def _sample(self, logits) -> np.ndarray:
        return self.sampler(logits).cpu().numpy()

    @classmethod
    def from_checkpoint(cls, cfg: ModelConfig, ckpt_dir: str,
                        policy: QuantPolicy, *, mesh=None,
                        step: Optional[int] = None,
                        backend: Optional[str] = None, device=None,
                        **engine_kw):
        """Build a serving engine straight from a packed checkpoint.

        The restore target is ``models/model.packed_model_specs`` (``meta``
        tensors: no weight is drawn), and every leaf goes to ``device``
        (``None``: the card) in its stored dtype, so the uint8 codes and
        scales are never widened on the host or the card."""
        if mesh is not None:
            raise NotImplementedError("sharded serving is not ported yet; "
                                      "see ROADMAP.md, Queue 1 item 5")
        from ..ckpt import ckpt as ckpt_lib
        pol = policy if backend is None else policy.replace(backend=backend)
        params, _ = ckpt_lib.restore(ckpt_dir, M.packed_model_specs(cfg, pol),
                                     step=step, device=resolve_device(device))
        return cls(cfg, params, policy, backend=backend, device=device,
                   **engine_kw)

    def stats(self) -> dict:
        """Cumulative counters plus memory placement (the JAX engine's keys,
        with ``mesh``/``shard_fallback`` None on one device, plus the
        per-phase host seconds)."""
        denom = self.ticks * self.slots
        dev = str(self.device)
        return {
            "tokens_generated": self.tokens_generated,
            "prefill_dispatches": self.prefill_dispatches,
            "decode_dispatches": self.decode_dispatches,
            "ticks": self.ticks,
            "occupancy": (self._live_slot_ticks / denom) if denom else 0.0,
            "live": sum(1 for r in self.live if r is not None),
            "queued": len(self.queue),
            "prefill_chunk": self.prefill_chunk,
            "attn_backend": self.attn_backend,
            "shard_fallback": None,
            "mesh": None,
            "store_nbytes": dict(self.store_nbytes),
            "store_nbytes_per_device": {dev: _nbytes(self.params)},
            "cache_nbytes_per_device": {dev: _nbytes(self.cache)},
            "prefill_seconds": self.prefill_seconds,
            "decode_seconds": self.decode_seconds,
        }

    def submit(self, prompt: List[int], max_new: int,
               truncate: bool = False,
               eos_id: Optional[int] = None) -> Request:
        """Queue a prompt.  A prompt longer than the cache rejects (or, with
        ``truncate=True``, keeps the first ``max_len`` tokens).  ``eos_id``
        (default: the engine's) ends generation early when sampled."""
        prompt = [int(t) for t in prompt]
        if len(prompt) > self.max_len:
            if not truncate:
                raise ValueError(
                    f"prompt length {len(prompt)} exceeds the engine cache "
                    f"(max_len={self.max_len}); pass truncate=True or size "
                    "the engine for the workload")
            prompt = prompt[: self.max_len]
        self._uid += 1
        req = Request(self._uid, prompt, max_new,
                      eos_id=self.eos_id if eos_id is None else eos_id)
        self.queue.append(req)
        return req

    def run(self, max_ticks: int = 100_000) -> List[Request]:
        finished: List[Request] = []
        while self.queue or any(self.live):
            self._admit()
            finished.extend(self._tick())
            self.ticks += 1
            if self.ticks >= max_ticks:
                break
        return finished

    # -- internals --------------------------------------------------------
    def _admit(self):
        for s in range(self.slots):
            if self.live[s] is None and self.queue:
                req = self.queue.popleft()
                self.live[s] = req
                self.pos[s] = 0
                self.pending_prompt[s] = deque(req.prompt)

    def _emit(self, s: int, tok: int, done: List[Request]):
        req = self.live[s]
        req.out.append(tok)
        self.tokens_generated += 1
        self.last_tok[s] = tok
        if (len(req.out) >= req.max_new
                or self.pos[s] >= self.max_len
                or (req.eos_id is not None and tok == req.eos_id)):
            req.done = True
            done.append(req)
            self.live[s] = None

    def _tick(self) -> List[Request]:
        self._live_slot_ticks += sum(1 for r in self.live if r is not None)
        if self.prefill_chunk == 1:
            return self._tick_merged()
        done: List[Request] = []
        prefill_slots = [s for s in range(self.slots)
                         if self.live[s] is not None
                         and self.pending_prompt[s]]
        decode_slots = [s for s in range(self.slots)
                        if self.live[s] is not None
                        and not self.pending_prompt[s]]

        # decode dispatch first: a prefill-phase slot rides along masked and
        # writes one stale column at its position, which the prefill
        # dispatch below overwrites with its chunk's first token
        if decode_slots:
            t0 = time.perf_counter()
            logits, self.cache = self._decode(
                self.params, self._tensor(self.last_tok)[:, None],
                self.cache, self._tensor(self.pos))
            nxt = self._sample(logits)
            self.decode_seconds += time.perf_counter() - t0
            self.decode_dispatches += 1
            for s in decode_slots:
                self.pos[s] = min(self.pos[s] + 1, self.max_len)
                self._emit(s, int(nxt[s]), done)

        # prefill dispatch: up to C prompt tokens per prefilling slot;
        # decode/idle slots are masked by n_valid=0
        if prefill_slots:
            C = self.prefill_chunk
            toks = np.zeros((self.slots, C), np.int32)
            nv = np.zeros(self.slots, np.int32)
            for s in prefill_slots:
                q = self.pending_prompt[s]
                n = min(C, len(q))
                for j in range(n):
                    toks[s, j] = q.popleft()
                nv[s] = n
            t0 = time.perf_counter()
            logits, self.cache = self._prefill(
                self.params, self._tensor(toks), self.cache,
                self._tensor(self.pos), self._tensor(nv))
            nxt = self._sample(logits)
            self.prefill_seconds += time.perf_counter() - t0
            self.prefill_dispatches += 1
            for s in prefill_slots:
                self.pos[s] = min(self.pos[s] + int(nv[s]), self.max_len)
                if not self.pending_prompt[s]:
                    self._emit(s, int(nxt[s]), done)
        return done

    def _tick_merged(self) -> List[Request]:
        """Token-by-token schedule (prefill_chunk=1): every slot consumes
        its next prompt token or its last sampled token in ONE decode
        dispatch."""
        toks = np.array(self.last_tok)
        prefilling = np.zeros(self.slots, bool)
        for s in range(self.slots):
            if self.live[s] is not None and self.pending_prompt[s]:
                toks[s] = self.pending_prompt[s].popleft()
                prefilling[s] = True
        t0 = time.perf_counter()
        logits, self.cache = self._decode(
            self.params, self._tensor(toks)[:, None], self.cache,
            self._tensor(self.pos))
        nxt = self._sample(logits)
        if prefilling.any():
            self.prefill_dispatches += 1
            self.prefill_seconds += time.perf_counter() - t0
        else:
            self.decode_dispatches += 1
            self.decode_seconds += time.perf_counter() - t0

        done: List[Request] = []
        for s in range(self.slots):
            req = self.live[s]
            if req is None:
                continue
            self.pos[s] = min(self.pos[s] + 1, self.max_len)
            if prefilling[s] and self.pending_prompt[s]:
                continue
            self._emit(s, int(nxt[s]), done)
        return done
