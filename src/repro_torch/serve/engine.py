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
an engine straight from a packed checkpoint.

**Sharded serving** (``mesh=``, a ``launch/mesh`` mesh over a
``torch.distributed`` process group; one engine per rank, every rank
running the same host loop with the same requests).  Placement follows the
JAX package's rules: the pack-once store by ``MeshRules`` (codes and
scales split together, uneven scale grids replicated), the cache by
``cache_shardings`` (slot batch over the DP axes, kv heads over the model
axis), and each rank holds only its slices.  Compute follows one
tensor-parallel scheme (``models/blocks.py``): column-parallel q/k/v,
gate/up and head, row-parallel o and down with one f32 all-reduce each, a
vocab-parallel embedding, anything else gathered at use.  Each rank runs
its slot rows; the logits are gathered over the DP axes, so every rank
samples the same tokens.  The per-shard kernel gates keep the JAX
package's wording: a sharded cache position axis (sequence parallelism)
sends attention to the value path and says so in ``shard_fallback``; a
packed leaf whose shards would tear MX blocks, which ``MeshRules`` never
produces, raises.  Attention whose heads cannot split runs replicated on
the kernel.
``stats()`` is then a collective (every rank calls it).  MoE configs
shard their experts over the model axis (``MeshRules``: unevenly too,
zero rows past the end): every rank routes the whole slot batch, runs its
own experts and gathers their outputs (``blocks.moe``).  ``from_init``
draws a random store as one device would and keeps only this rank's
slices, so no rank ever holds the whole store.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Callable, Deque, List, Optional, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import packed_store
from ..core import sharding as shd
from ..core.blocking import QuantizedTensor, torch_dtype
from ..core.policy import QuantPolicy
from ..device import resolve_device
from ..launch import mesh as mesh_lib
from ..models import blocks
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


def _spec(ns) -> tuple:
    """The spec of a leaf's sharding (a packed leaf's codes and scales
    share one)."""
    return ns.codes.spec if isinstance(ns, QuantizedTensor) else ns.spec


def _check_blocks_aligned(store, shardings, axis_sizes):
    """The matmul kernels' per-shard gate: every sharded packed leaf keeps
    whole MX blocks per shard (``packed_store.shard_block_aligned``).
    ``MeshRules`` specs satisfy it by construction (``packed_spec``
    replicates uneven scale grids), so this only guards the rules: a torn
    block cannot be sliced with its scale, and no path serves it."""
    for leaf, ns in zip(packed_store.tree_leaves(store),
                        packed_store.tree_leaves(shardings)):
        if isinstance(leaf, QuantizedTensor) and not \
                packed_store.shard_block_aligned(leaf, _spec(ns), axis_sizes):
            raise ValueError(
                f"packed store sharding tears MX blocks per shard: spec "
                f"{_spec(ns)} on a leaf of shape {tuple(leaf.shape)} under "
                f"blocks {leaf.block}")


def _specs_by_name(store, shardings, path=()) -> dict:
    """``{leaf name: (stored spec, logical shape)}`` of each leaf's base
    dims (the stacked-layer dims are never split): what ``blocks.use``
    reads.  An MoE shared expert's leaves are filed as ``shared/<name>``,
    apart from a dense FFN's of the same names; every leaf of a name must
    share them."""
    out = {}
    if isinstance(store, dict):
        for k in store:
            for name, got in _specs_by_name(store[k], shardings[k],
                                            path + (k,)).items():
                if out.setdefault(name, got) != got:
                    raise NotImplementedError(
                        f"leaves named {name!r} differ in shape or spec: "
                        f"{out[name]} vs {got}")
        return out
    r = mesh_lib._base_rank(path[-1])
    if r == 0:
        return out
    spec = tuple(_spec(shardings))
    spec += (None,) * (len(store.shape) - len(spec))
    name = path[-1] if path[-2:-1] != ("shared",) else f"shared/{path[-1]}"
    return {name: (spec[-r:], tuple(store.shape[-r:]))}


class ServeEngine:
    """Fixed-slot continuous batching over prefill_step + decode_step."""

    def __init__(self, cfg: ModelConfig, params, policy: QuantPolicy,
                 slots: int = 4, max_len: int = 256,
                 sampler: Optional[Callable] = None,
                 backend: Optional[str] = None,
                 pack_weights: Optional[bool] = None,
                 prefill_chunk: Union[int, str] = 16,
                 eos_id: Optional[int] = None,
                 device=None, mesh=None, _placed=None):
        if cfg.family != "decoder":
            raise NotImplementedError(
                "continuous batching needs per-slot recurrent-state "
                "checkpointing for SSM/hybrid families")
        self.device = resolve_device(device)
        if backend is not None:
            policy = policy.replace(backend=backend)
            _ = policy.use_kernels  # validate at construction
        self.cfg = cfg
        self.mesh = mesh
        self.rules = None if mesh is None else mesh_lib.MeshRules(mesh)
        if mesh is not None and mesh.device_mesh is None:
            raise ValueError(f"{mesh} is abstract: a sharded engine needs "
                             "a mesh over a process group (launch/mesh)")
        # the cache's precision follows the compute dtype, as in the JAX
        # engine: a bf16 cache under an f32 config would round K/V
        cache_kw = dict(dtype=torch_dtype(cfg.compute_dtype), ring=False,
                        kv_fmt=policy.kv_cache_fmt)
        self.shard_fallback: Optional[str] = None
        self._cache_sh = None
        if self.rules is None:
            self.cache = M.init_cache(cfg, slots, max_len, device=self.device,
                                      **cache_kw)
        else:
            shapes = M.init_cache(cfg, slots, max_len, device="meta",
                                  **cache_kw)
            self._cache_sh = mesh_lib.cache_shardings(self.rules, shapes,
                                                      slots)
            self.cache = packed_store.tree_map(
                lambda t, ns: torch.zeros(
                    t[shd.shard_slices(t.shape, ns.spec, mesh)].shape,
                    dtype=t.dtype, device=self.device),
                shapes, self._cache_sh)
            # the per-shard half of the attention kernel's gate (the JAX
            # package's wording): a sharded position axis is sequence
            # parallelism, which the kernel cannot run shard-local
            if M.decode_attn_backend(cfg, policy) == "cuda-packed" and \
                    M.cache_position_axis_sharded(self._cache_sh):
                policy = policy.replace(attention_kernel=False)
                self.shard_fallback = (
                    "cache position axis sharded (sequence-parallel "
                    "fallback layout): packed-attention kernel cannot run "
                    "shard-local, using the torch cached-attention path")
        can_pack = packed_store.packable_policy(policy)
        if pack_weights and not can_pack:
            raise ValueError(
                "pack_weights=True needs a quantizing policy with a real "
                f"element format; got block_mode={policy.block_mode!r}, "
                f"fwd_fmt={policy.fwd_fmt!r}")
        self.packed = can_pack and (pack_weights is None or pack_weights)
        if _placed is None and mesh is None:
            params = _to_device(params, self.device)
        if self.packed:
            params = M.pack_model_params(cfg, params, policy)
        store = params if _placed is None else _placed  # the whole store
        self.store_nbytes = packed_store.store_nbytes(store)
        self._layout, self.tp_plan = {}, None
        if self.rules is not None:
            params = self._place(store, params, policy, _placed)
        self.params = params
        self.attn_backend = M.decode_attn_backend(cfg, policy,
                                                  self._cache_sh)
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

    def _place(self, store, params, policy, placed):
        """Sharded placement: the store's shardings, the matmul kernels'
        per-shard gate, this rank's slices (unless ``placed``: restored
        as slices already), and the layout the model code reads (each
        leaf's stored spec by name, the TP plan, the cache's position
        split, this rank's slot rows)."""
        mesh, cfg = self.mesh, self.cfg
        self._store_sh = self.rules.param_sharding_tree(store)
        _check_blocks_aligned(store, self._store_sh, mesh.shape)
        if placed is None:
            params = packed_store.tree_map(
                lambda leaf, ns: shd.map_parts(
                    packed_store.shard_leaf(leaf, _spec(ns), mesh,
                                            shd.uneven_dims(ns)),
                    lambda t: t.contiguous().to(self.device)),
                params, self._store_sh)
        layer = M.decoding.layer_params(store["layers"], 0)
        plan = blocks.tp_plan(cfg, policy, layer, store, self.rules.tp_size)
        kv = self._cache_sh["k_codes" if "k_codes" in self._cache_sh
                            else "k"].spec
        w_entry, b_entry, h_entry = kv[-3], kv[-4], kv[-2]
        local = self.cache["k_codes" if "k_codes" in self.cache
                           else "k"].shape
        sp = heads = None  # the cache splits what the layers do not
        if w_entry is not None:
            sp = (w_entry, shd.shard_index(w_entry, mesh) * local[-3],
                  shd.axis_size(w_entry, mesh.shape))
        if h_entry is not None and not plan.heads:
            heads = (h_entry, shd.shard_index(h_entry, mesh) * local[-2],
                     shd.axis_size(h_entry, mesh.shape))
        self._batch_axes = b_entry
        i_b = shd.shard_index(b_entry, mesh)
        self._rows = slice(i_b * local[-4], (i_b + 1) * local[-4])
        rows = None if b_entry is None else (b_entry, self._rows.start)
        self._layout = dict(specs=_specs_by_name(store, self._store_sh),
                            plan=plan, cache_sp=sp, cache_heads=heads,
                            batch_rows=rows)
        self.tp_plan = plan
        return params

    def _hints(self):
        """The mesh context of a dispatch (a no-op context without a
        mesh)."""
        if self.rules is None:
            return contextlib.nullcontext()
        return shd.mesh_context(self.mesh, self.rules.dp, self.rules.tp,
                                **self._layout)

    def _decode(self, params, tokens, cache, pos):
        """One decode dispatch over the whole slot batch; under a mesh this
        rank runs its slot rows and the logits rows are gathered."""
        if self.rules is None:
            return M.decode_step(params, tokens, cache, pos, self.cfg,
                                 self.policy)
        with self._hints():
            logits, cache = M.decode_step(params, tokens[self._rows], cache,
                                          pos[self._rows], self.cfg,
                                          self.policy)
            return shd.all_gather(logits, self._batch_axes, 0), cache

    def _prefill(self, params, tokens, cache, pos, n_valid):
        if self.rules is None:
            return M.prefill_step(params, tokens, cache, pos, n_valid,
                                  self.cfg, self.policy)
        r = self._rows
        with self._hints():
            logits, cache = M.prefill_step(params, tokens[r], cache, pos[r],
                                           n_valid[r], self.cfg,
                                           self.policy)
            return shd.all_gather(logits, self._batch_axes, 0), cache

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
        scales are never widened on the host or the card.  Under a
        ``mesh`` each rank moves only its slices of the uint8 leaves
        (``MeshRules.param_sharding_tree``)."""
        from ..ckpt import ckpt as ckpt_lib
        pol = policy if backend is None else policy.replace(backend=backend)
        specs = M.packed_model_specs(cfg, pol)
        shardings = (None if mesh is None else
                     mesh_lib.MeshRules(mesh).param_sharding_tree(specs))
        params, _ = ckpt_lib.restore(ckpt_dir, specs, step=step,
                                     device=resolve_device(device),
                                     shardings=shardings)
        return cls(cfg, params, policy, backend=backend, device=device,
                   mesh=mesh, _placed=None if mesh is None else specs,
                   **engine_kw)

    @classmethod
    def from_init(cls, cfg: ModelConfig, policy: QuantPolicy,
                  generator: torch.Generator, *, mesh=None,
                  backend: Optional[str] = None, device=None, **engine_kw):
        """Build a serving engine over a freshly drawn packed store
        (``models/model.init_packed_params``: the values one device draws
        from ``generator``).  Under a ``mesh`` each leaf is drawn whole
        and only this rank's slice of it is kept, one leaf at a time."""
        pol = policy if backend is None else policy.replace(backend=backend)
        specs = M.packed_model_specs(cfg, pol)
        shardings = (None if mesh is None else
                     mesh_lib.MeshRules(mesh).param_sharding_tree(specs))
        store = M.init_packed_params(cfg, pol, generator,
                                     device=resolve_device(device),
                                     shardings=shardings)
        return cls(cfg, store, policy, backend=backend, device=device,
                   mesh=mesh, _placed=None if mesh is None else specs,
                   **engine_kw)

    def stats(self) -> dict:
        """Cumulative counters plus memory placement (the JAX engine's keys
        plus the per-phase host seconds).  Under a mesh the per-device
        bytes of every rank are gathered, keyed ``rank<r>:<device>``: a
        collective, so every rank calls it."""
        denom = self.ticks * self.slots
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
            "shard_fallback": self.shard_fallback,
            "mesh": None if self.mesh is None else dict(self.mesh.shape),
            "store_nbytes": dict(self.store_nbytes),
            "store_nbytes_per_device": shd.per_device_nbytes(
                self.params, self.device, self.mesh),
            "cache_nbytes_per_device": shd.per_device_nbytes(
                self.cache, self.device, self.mesh),
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
