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
slices, so no rank ever holds the whole store.  The placement and the
dispatch are module functions (``cache_placement``, ``place_store``,
``placement`` and its ``Placement.run``), which the dry run on a mesh
(``launch/dryrun.py``) traces on a tracing mesh as the engine runs them;
``probe_dispatches`` drives one prefill and one decode dispatch, which a
rank counts and the dry run traces alike.

The SSM, hybrid and encoder-decoder families serve on a mesh through the
same placement, without an engine (as in the JAX package, whose engine
refuses them too): ``cache_placement`` and ``placement`` read every cache
``init_cache`` makes (``state``/``conv``, ``groups``/``tail``/``attn``,
``self``/``cross``/``cross_ready``), and ``lockstep_dispatches`` drives one
lockstep ``prefill`` and one ``decode_step`` of such a placement, which a
rank counts and the dry run traces alike.  ``draw_store`` draws a rank's
slices of a seeded store, as ``ServeEngine.from_init`` does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import time
from collections import deque
from typing import Callable, Deque, List, NamedTuple, Optional, Union

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

__all__ = ["Request", "ServeEngine", "auto_prefill_chunk", "resolve_device",
           "Placement", "placement", "cache_placement", "place_store",
           "probe_dispatches", "lockstep_dispatches", "draw_store",
           "cache_parts", "kv_leaf"]


def _bench_chunk(path: Optional[str]) -> int:
    """The chunk a kernel bench measured to beat token-by-token prefill
    (``BENCH_kernel.json``'s ``kernel_prefill_chunked_dispatches`` row,
    its ``derived`` field's ``C=``): the file at ``path``, else at
    ``$BENCH_KERNEL_JSON``, else ``BENCH_kernel.json`` in the working
    directory; 1 where there is no such file or row, or the file is not
    JSON."""
    path = path or os.environ.get("BENCH_KERNEL_JSON", "BENCH_kernel.json")
    try:
        with open(path) as f:
            rows = json.load(f).get("rows", [])
    except (OSError, ValueError):
        return 1
    for row in rows:
        if row.get("name") == "kernel_prefill_chunked_dispatches":
            m = re.search(r"C=(\d+)", row.get("derived", ""))
            if m:
                return max(1, int(m.group(1)))
    return 1


def auto_prefill_chunk(max_len: int, slots: int,
                       bench_path: Optional[str] = None) -> int:
    """Resolve ``prefill_chunk="auto"`` from the engine shape: the chunk
    that fills one 256-row M tile across the slot batch, so a full-length
    prompt still drains in >= 4 chunks, rounded down to a power of two;
    floored by a measured chunk (``_bench_chunk`` of ``bench_path``) and
    capped by ``max_len``, as the JAX package resolves it."""
    c = max(1, min(max_len // 4, 256 // max(slots, 1)))
    c = 1 << (c.bit_length() - 1)
    c = max(c, _bench_chunk(bench_path))
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


def cache_parts(cfg: ModelConfig, tree) -> dict:
    """The caches of a cache tree (or of its shardings) by role: ``self``
    the attention cache the layers write (a decoder's, a hybrid's ``attn``,
    an encoder-decoder's ``self``), ``cross`` an encoder-decoder's cross
    K/V, ``ssd`` an SSD cache (an SSM's, a hybrid's groups; its tail is
    placed alike); None where the family has none."""
    fam = cfg.family
    return {"self": (tree if fam == "decoder" else tree["attn"]
                     if fam == "hybrid" else tree["self"]
                     if fam == "encdec" else None),
            "cross": tree["cross"] if fam == "encdec" else None,
            "ssd": (tree if fam == "ssm" else tree["groups"]
                    if fam == "hybrid" else None)}


def kv_leaf(tree):
    """The K entry of an attention cache dict (values or codes)."""
    return tree["k_codes" if "k_codes" in tree else "k"]


def cache_placement(cfg: ModelConfig, policy: QuantPolicy, rules, slots: int,
                    max_len: int, device, **cache_kw):
    """A sharded cache: this rank's zeroed slices of ``init_cache(cfg,
    slots, max_len, **cache_kw)`` on ``device``, their shardings
    (``cache_shardings``), and the per-shard half of the attention
    kernel's gate in the JAX package's wording: a sharded position axis
    is sequence parallelism, which the kernel cannot run shard-local.
    Returns (cache, shardings, policy -- the kernel off where the gate
    shuts --, shard_fallback -- why, or None)."""
    shapes = M.init_cache(cfg, slots, max_len, device="meta", **cache_kw)
    sh = mesh_lib.cache_shardings(rules, shapes, slots)
    cache = packed_store.tree_map(
        lambda t, ns: torch.zeros(
            shd.shard_shape(t.shape, ns.spec, rules.mesh.shape),
            dtype=t.dtype, device=device), shapes, sh)
    fallback = None
    if M.decode_attn_backend(cfg, policy) == "cuda-packed" and \
            M.cache_position_axis_sharded(sh):
        policy = policy.replace(attention_kernel=False)
        fallback = ("cache position axis sharded (sequence-parallel "
                    "fallback layout): packed-attention kernel cannot run "
                    "shard-local, using the torch cached-attention path")
    return cache, sh, policy, fallback


def place_store(params, shardings, mesh, device):
    """This rank's slices of a whole tree (a packed store or f32 leaves)
    under ``shardings``, on ``device``.  On ``meta`` each slice is a
    tensor of its own: a view would carry the whole leaf's storage."""
    meta = torch.device(device).type == "meta"

    def own(t):
        if meta:
            return torch.empty(t.shape, dtype=t.dtype, device="meta")
        return t.contiguous().to(device)

    return packed_store.tree_map(
        lambda leaf, ns: shd.map_parts(
            packed_store.shard_leaf(leaf, _spec(ns), mesh,
                                    shd.uneven_dims(ns)), own),
        params, shardings)


class Placement(NamedTuple):
    """Where one rank's sharded dispatches run: its mesh's rules, the
    layout the model code reads (``mesh_context``'s keywords: each leaf's
    stored spec by name, the TP plan, the cache's position or kv-head
    split, this rank's first slot row), its slot rows and the axes the
    slot batch splits over (None: every rank runs every row)."""
    rules: object
    layout: dict
    rows: slice
    batch_axes: object

    def hints(self):
        return shd.mesh_context(self.rules.mesh, self.rules.dp,
                                self.rules.tp, **self.layout)

    def rows_of(self, *arrays):
        """This rank's slot rows of each array (dim 0 the slot batch)."""
        return tuple(a[self.rows] for a in arrays)

    def run(self, step):
        """``step()`` -- a dispatch on this rank's rows, returning (logits,
        cache) -- under the mesh context; the logits rows are gathered
        over the batch axes, so every rank holds every slot's (the JAX
        cells' replicated logits)."""
        with self.hints():
            logits, cache = step()
            if logits is not None:  # an encoder-decoder's prefill has none
                logits = shd.all_gather(logits, self.batch_axes, 0)
            return logits, cache


def _kv_split(spec, local, mesh, heads_split: bool):
    """(position split, kv-head split) of an attention cache of ``spec``
    and local shape ``local`` (..., B, W, kv, dh) where the layers do not
    compute it split: each (axes, this rank's first column or head, shard
    count), or None."""
    w_entry, h_entry = spec[-3], spec[-2]
    sp = heads = None
    if w_entry is not None:
        sp = (w_entry, shd.shard_index(w_entry, mesh) * local[-3],
              shd.axis_size(w_entry, mesh.shape))
    if h_entry is not None and not heads_split:
        heads = (h_entry, shd.shard_index(h_entry, mesh) * local[-2],
                 shd.axis_size(h_entry, mesh.shape))
    return sp, heads


def placement(cfg: ModelConfig, policy: QuantPolicy, rules, store,
              store_sh, cache_sh, cache) -> Placement:
    """The ``Placement`` of a model's dispatches: ``store`` the whole
    tree (shapes suffice: ``meta`` tensors, a packed store or f32 leaves)
    placed by ``store_sh``, ``cache`` this rank's slices of a cache placed
    by ``cache_sh`` (any family's, ``cache_parts``).  An attention cache
    splits what the layers do not: its position axis (sequence
    parallelism) and, where attention runs replicated, its kv heads (the
    cross cache likewise: ``cross_cache``); an SSD cache may store its
    state's heads and its tail's channels split (``ssd_cache``); the slot
    rows follow the batch dim."""
    mesh = rules.mesh
    plan = blocks.tp_plan(cfg, policy, store, rules.tp_size)
    sh, loc = cache_parts(cfg, cache_sh), cache_parts(cfg, cache)
    layout = dict(specs=mesh_lib.specs_by_name(store, store_sh),
                  plan=plan)
    if sh["self"] is not None:
        spec, local = kv_leaf(sh["self"]).spec, kv_leaf(loc["self"]).shape
        layout["cache_sp"], layout["cache_heads"] = _kv_split(
            spec, local, mesh, plan.heads)
        b_entry, n_b = spec[-4], local[-4]
    if sh["cross"] is not None:
        layout["cross_cache"] = _kv_split(sh["cross"]["k"].spec,
                                          loc["cross"]["k"].shape, mesh,
                                          plan.heads)
    if sh["ssd"] is not None:
        st, cv = sh["ssd"]["state"].spec, sh["ssd"]["conv"].spec
        layout["ssd_cache"] = {"state": st[-3] is not None,
                               "conv": cv[-1] is not None}
        if sh["self"] is None:
            b_entry, n_b = st[-5], loc["ssd"]["state"].shape[-5]
    i_b = shd.shard_index(b_entry, mesh)
    rows = slice(i_b * n_b, (i_b + 1) * n_b)
    layout["batch_rows"] = None if b_entry is None else (b_entry,
                                                         rows.start)
    return Placement(rules, layout, rows, b_entry)


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
        if mesh is not None and mesh.device_mesh is None and \
                not mesh.tracing:
            raise ValueError(f"{mesh} is abstract: a sharded engine needs "
                             "a mesh over a process group (launch/mesh), "
                             "or a tracing mesh on meta tensors")
        if mesh is not None and mesh.tracing and self.device.type != "meta":
            raise ValueError(f"{mesh} sends nothing: it serves only on "
                             f"meta tensors, not on {self.device}")
        # the cache's precision follows the compute dtype, as in the JAX
        # engine: a bf16 cache under an f32 config would round K/V
        cache_kw = dict(dtype=torch_dtype(cfg.compute_dtype), ring=False,
                        kv_fmt=policy.kv_cache_fmt)
        self.shard_fallback: Optional[str] = None
        self._cache_sh = self.placement = None
        if self.rules is None:
            self.cache = M.init_cache(cfg, slots, max_len, device=self.device,
                                      **cache_kw)
        else:
            self.cache, self._cache_sh, policy, self.shard_fallback = \
                cache_placement(cfg, policy, self.rules, slots, max_len,
                                self.device, **cache_kw)
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
        as slices already), and the ``Placement`` of its dispatches."""
        mesh = self.mesh
        self._store_sh = self.rules.param_sharding_tree(store)
        _check_blocks_aligned(store, self._store_sh, mesh.shape)
        if placed is None:
            params = place_store(params, self._store_sh, mesh, self.device)
        self.placement = placement(self.cfg, policy, self.rules, store,
                                   self._store_sh, self._cache_sh,
                                   self.cache)
        self._layout = self.placement.layout
        self.tp_plan = self._layout["plan"]
        self._rows = self.placement.rows
        return params

    def _hints(self):
        """The mesh context of a dispatch (a no-op context without a
        mesh)."""
        if self.placement is None:
            return contextlib.nullcontext()
        return self.placement.hints()

    def _decode(self, params, tokens, cache, pos):
        """One decode dispatch over the whole slot batch; under a mesh this
        rank runs its slot rows and the logits rows are gathered."""
        if self.placement is None:
            return M.decode_step(params, tokens, cache, pos, self.cfg,
                                 self.policy)
        t, p = self.placement.rows_of(tokens, pos)
        return self.placement.run(lambda: M.decode_step(
            params, t, cache, p, self.cfg, self.policy))

    def _prefill(self, params, tokens, cache, pos, n_valid):
        if self.placement is None:
            return M.prefill_step(params, tokens, cache, pos, n_valid,
                                  self.cfg, self.policy)
        t, p, n = self.placement.rows_of(tokens, pos, n_valid)
        return self.placement.run(lambda: M.prefill_step(
            params, t, cache, p, n, self.cfg, self.policy))

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
        store, specs, _ = draw_store(cfg, pol, generator, mesh,
                                     resolve_device(device))
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


def draw_store(cfg: ModelConfig, policy: QuantPolicy,
               generator: torch.Generator, mesh, device):
    """This rank's slices of the packed store one device draws from
    ``generator`` (``models/model.init_packed_params``: each leaf drawn
    whole and only the rank's slice kept, one leaf at a time; the whole
    store without a ``mesh``).  Returns (store, ``packed_model_specs``,
    their shardings -- None without a mesh)."""
    specs = M.packed_model_specs(cfg, policy)
    shardings = (None if mesh is None else
                 mesh_lib.MeshRules(mesh).param_sharding_tree(specs))
    store = M.init_packed_params(cfg, policy, generator, device=device,
                                 shardings=shardings)
    return store, specs, shardings


def lockstep_dispatches(cfg: ModelConfig, policy: QuantPolicy,
                        place: Placement, params, cache, batch: dict,
                        token=None):
    """Yield ``(kind, run)`` for one lockstep ``prefill`` of ``batch`` (the
    whole batch: ``tokens`` (B, S), an encoder-decoder's ``frames``) into
    ``cache`` (this rank's slices, zeroed; filled in place) and then one
    ``decode_step`` of ``token`` (B, 1; default token 0 on every row) at
    the prompt's end (an encoder-decoder: position 0), each on this rank's
    rows of ``place``.  ``run()`` issues the dispatch and returns (logits
    gathered over the batch axes -- None for an encoder-decoder's prefill
    --, cache).  The JAX dry run's entry points for these families; a rank
    and a trace of it count the same dispatches from here."""
    rows = {k: place.rows_of(v)[0] for k, v in batch.items()}
    first = next(iter(batch.values()))
    S = 0 if cfg.family == "encdec" else batch["tokens"].shape[1]
    if token is None:
        token = torch.zeros((first.shape[0], 1), dtype=torch.int64,
                            device=first.device)
    tok, = place.rows_of(token)
    yield "prefill", lambda: place.run(lambda: M.prefill(
        params, rows, cache, cfg, policy))
    yield "decode", lambda: place.run(lambda: M.decode_step(
        params, tok, cache, S, cfg, policy))


def probe_dispatches(eng: ServeEngine):
    """Yield ``(kind, cache, run)`` for one prefill dispatch of ``eng``
    (a chunk of token 0 on every slot from position 0) and then one decode
    dispatch (token 0 on every slot at position 0), each on a zeroed copy
    ``cache`` of the engine's cache; ``run()`` issues the dispatch through
    ``_prefill`` or ``_decode`` with the inputs the engine's own tick
    builds, and returns (logits, cache).  A rank and a trace of it count
    the same dispatches from here, each with its own counters."""
    B, C = eng.slots, eng.prefill_chunk
    for kind in ("prefill", "decode"):
        cache = {k: torch.zeros_like(v) for k, v in eng.cache.items()}
        pos = eng._tensor([0] * B)
        if kind == "prefill":
            toks = eng._tensor(np.zeros((B, C), np.int32))
            n_valid = eng._tensor(np.full(B, C, np.int32))

            def run(toks=toks, cache=cache, pos=pos, n_valid=n_valid):
                return eng._prefill(eng.params, toks, cache, pos, n_valid)
        else:
            toks = eng._tensor([0] * B)[:, None]

            def run(toks=toks, cache=cache, pos=pos):
                return eng._decode(eng.params, toks, cache, pos)
        yield kind, cache, run
        del cache, run
