"""Checkpoints with atomic writes, async saves and packed-store metadata.

PyTorch counterpart of the JAX package's ``ckpt/ckpt.py``, on the same
on-disk format, so either package restores what the other saved:

  * ``<dir>/step_%08d/arrays.npz`` + ``manifest.json`` (``step``, ``time``,
    ``n_arrays``, ``bytes``, ``packed``, ``extra``); written to
    ``.tmp-step_%08d`` and renamed, so a crash mid-save never leaves a
    half-written latest checkpoint; the oldest steps past ``keep`` are
    removed after each save.
  * Leaf keys are the ``/``-joined dict keys (list and tuple indices as
    numbers); a packed leaf (``QuantizedTensor``) contributes ``.../codes``
    and ``.../scale_e8m0``, and the manifest's ``packed`` records its
    ``{fmt, block, shape, dtype}``, which ``restore`` checks against the
    target.
  * numpy has no bfloat16: a bf16 leaf is written as the JAX package's file
    holds one, its 2-byte bit patterns under the header type ``<V2``, and
    ``restore`` takes the dtype from the target and reinterprets the bytes.
  * ``save(..., blocking=False)`` takes the host copy at call time (the
    train step updates the state in place afterwards) and writes on a
    thread; ``wait_pending`` joins the writers and re-raises their errors.

``restore`` reads one leaf at a time from the archive and sends it to the
device in its stored dtype: a packed store's uint8 codes and scales go to
the card as they are, with no full-precision copy on the host or the card.

Sharded trees (``shardings=``, a tree of ``sharding.NamedSharding`` from
``launch/mesh.MeshRules``, QuantizedTensors of two for packed leaves):
``restore`` reads each member on the host, as the JAX package's
``_place_sharded`` does, and moves only this rank's slice to the device;
``save`` gathers every leaf to the full tensor and rank 0 writes it in the
same format, so a tree saved on one mesh restores onto another.  An uneven
expert split (``NamedSharding.uneven``) restores zero-padded to the rows
every rank holds, and saves cut back to its extent.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from ..core import sharding as shd
from ..core.blocking import QuantizedTensor
from ..core.packed_store import shard_leaf
from ..device import resolve_device

__all__ = ["save", "restore", "latest_step", "wait_pending"]

# the npy header type of a bf16 leaf, as the JAX package writes it
_BF16_DESCR = "<V2"
_WRITE_CHUNK = 1 << 26  # bytes per write of one member's data

_PENDING: list = []      # (thread, errors) of non-blocking saves
_PENDING_LOCK = threading.Lock()


def _iter_leaves(tree, prefix=()):
    """(path, leaf) pairs in the JAX package's flattening order: dict keys
    sorted, list and tuple items in order; tensors and QuantizedTensors are
    leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter_leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_leaves(v, prefix + (str(i),))
    elif isinstance(tree, (torch.Tensor, QuantizedTensor)):
        yield prefix, tree
    else:
        raise TypeError(f"checkpoint leaf {'/'.join(prefix)!r} is a "
                        f"{type(tree).__name__}, not a tensor")


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that later in-place updates of ``t`` do not
    reach; bf16 as its raw 2-byte patterns."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _flatten(tree) -> dict:
    out = {}
    for path, leaf in _iter_leaves(tree):
        key = "/".join(path)
        if isinstance(leaf, QuantizedTensor):
            out[key + "/codes"] = _host(leaf.codes)
            out[key + "/scale_e8m0"] = _host(leaf.scale_e8m0)
        else:
            out[key] = _host(leaf)
    return out


def _qt_meta(qt: QuantizedTensor) -> dict:
    return {"fmt": qt.fmt, "block": list(qt.block), "shape": list(qt.shape),
            "dtype": str(qt.dtype)}


def _packed_meta(tree) -> dict:
    return {"/".join(path): _qt_meta(leaf)
            for path, leaf in _iter_leaves(tree)
            if isinstance(leaf, QuantizedTensor)}


def _write_npz(path: str, arrays: dict):
    """``np.savez``'s archive (stored, zip64 members ``<key>.npy``, npy
    format 1.0), with bf16 leaves under the header type ``<V2``."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            descr = (_BF16_DESCR if arr.dtype == np.dtype("V2")
                     else np.lib.format.dtype_to_descr(arr.dtype))
            flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array_header_1_0(fid, {
                    "descr": descr, "fortran_order": False,
                    "shape": arr.shape})
                for i in range(0, flat.size, _WRITE_CHUNK):
                    fid.write(flat[i:i + _WRITE_CHUNK].data)


def _gathered(state, shardings):
    """Each rank's slices of a sharded tree gathered to the full leaves
    (on every rank: a collective)."""
    if isinstance(state, dict):
        return {k: _gathered(v, shardings[k]) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_gathered(v, s) for v, s in zip(state,
                                                            shardings))
    ns = shardings.codes if isinstance(state, QuantizedTensor) else shardings
    full = state
    for d, entry in enumerate(ns.spec):
        full = shd.map_parts(full, lambda t: shd.all_gather(t, entry, d,
                                                         mesh=ns.mesh))
    for d, n in ns.uneven:  # the zero rows past an uneven split's end
        full = full.narrow(d, 0, n)
    if isinstance(state, QuantizedTensor):
        full = QuantizedTensor(full.codes, full.scale_e8m0, state.fmt,
                               tuple(state.block), tuple(shardings.shape),
                               state.dtype)
    return full


def save(ckpt_dir: str, step: int, state: Any, *, keep: int = 3,
         blocking: bool = True, extra: Optional[dict] = None,
         shardings: Any = None):
    """Write ``state`` (a tree of tensors and QuantizedTensors) as step
    ``step``; with ``blocking=False`` the write runs on a thread.  With
    ``shardings`` (this rank's slices of a sharded tree; every rank calls)
    the leaves are gathered and rank 0 writes; a blocking save returns on
    every rank once the step is on disk."""
    if shardings is not None:
        import torch.distributed as dist
        state = _gathered(state, shardings)
        if dist.get_rank() != 0:
            if blocking:
                dist.barrier()
            return
        save(ckpt_dir, step, state, keep=keep, blocking=blocking,
             extra=extra)
        if blocking:
            dist.barrier()
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = _flatten(state)  # host copy happens now; write may be async
    packed_meta = _packed_meta(state)

    def _write():
        tmp = os.path.join(ckpt_dir, f".tmp-step_{step:08d}")
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        _write_npz(os.path.join(tmp, "arrays.npz"), arrays)
        manifest = {
            "step": step,
            "time": time.time(),
            "n_arrays": len(arrays),
            "bytes": int(sum(a.nbytes for a in arrays.values())),
            "packed": packed_meta,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    if blocking:
        _write()
        return
    errors: list = []

    def _run():
        try:
            _write()
        except Exception as e:  # handed to wait_pending, which raises it
            errors.append(e)

    t = threading.Thread(target=_run, daemon=True)
    with _PENDING_LOCK:
        _PENDING.append((t, errors))
    t.start()


def wait_pending():
    """Join every non-blocking save; raise the first error one of them
    met."""
    with _PENDING_LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    failed = []
    for t, errors in pending:
        t.join()
        failed += errors
    if failed:
        raise failed[0]


def _gc(ckpt_dir, keep):
    steps = sorted(_all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _all_steps(ckpt_dir):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(ckpt_dir) -> Optional[int]:
    steps = _all_steps(ckpt_dir)
    return max(steps) if steps else None


def _read(data, key: str, like: torch.Tensor) -> torch.Tensor:
    """One array of the archive, on the host, shaped and typed like
    ``like``."""
    if key not in data.files:
        raise KeyError(f"checkpoint has no array {key!r}")
    arr = data[key]
    if arr.dtype.kind == "V":  # a bf16 leaf's raw 2-byte patterns
        if like.dtype != torch.bfloat16 or arr.dtype.itemsize != 2:
            raise ValueError(f"{key!r}: raw {arr.dtype} bytes restore only "
                             f"into bfloat16, not {like.dtype}")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{key!r}: checkpoint shape {tuple(t.shape)} vs "
                         f"target {tuple(like.shape)}")
    return t


def _place(t: torch.Tensor, like: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device`` (``None``: ``like``'s device; the card
    for ``meta``) in ``like``'s dtype."""
    if device is None:
        device = (resolve_device(None) if like.device.type == "meta"
                  else like.device)
    return t.to(device).to(like.dtype)


def _restore_tree(node, data, device, prefix=(), sh=None):
    """``node``'s structure from the archive; with ``sh`` (the matching
    shardings) only this rank's slice of each leaf leaves the host."""
    key = "/".join(prefix)
    if isinstance(node, dict):
        return {k: _restore_tree(v, data, device, prefix + (str(k),),
                                 None if sh is None else sh[k])
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_restore_tree(
            v, data, device, prefix + (str(i),), None if sh is None
            else sh[i]) for i, v in enumerate(node))
    if isinstance(node, QuantizedTensor):
        leaf = QuantizedTensor(
            _read(data, key + "/codes", node.codes),
            _read(data, key + "/scale_e8m0", node.scale_e8m0),
            node.fmt, tuple(node.block), tuple(node.shape), node.dtype)
        if sh is not None:  # a copy of the slice only leaves the host
            leaf = shd.map_parts(
                shard_leaf(leaf, sh.codes.spec, sh.codes.mesh), torch.clone)
        return QuantizedTensor(
            _place(leaf.codes, node.codes, device),
            _place(leaf.scale_e8m0, node.scale_e8m0, device),
            node.fmt, tuple(node.block), tuple(leaf.shape), node.dtype)
    if isinstance(node, torch.Tensor):
        t = _read(data, key, node)
        if sh is not None:
            t = shard_leaf(t, sh.spec, sh.mesh, shd.uneven_dims(sh)).clone()
        return _place(t, node, device)
    raise TypeError(f"restore target leaf {key!r} is a "
                    f"{type(node).__name__}, not a tensor")


def restore(ckpt_dir: str, target: Any, step: Optional[int] = None,
            device=None, shardings: Any = None):
    """Restore into the structure of ``target``: a tree of tensors (real or
    on the ``meta`` device) and QuantizedTensors, e.g.
    ``models/model.packed_model_specs`` for a packed store.  Each leaf goes
    to ``device`` (``None``: the target leaf's device, the card for a
    ``meta`` leaf).  ``shardings``: the matching tree of NamedShardings
    (``target`` holds the full shapes); each leaf is read on the host and
    only this rank's slice goes to the device, so the restored tree holds
    the slices, of any mesh.  Returns (tree, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    _check_packed_meta(step_dir, target)
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        return _restore_tree(target, data, device, sh=shardings), step


def _check_packed_meta(step_dir: str, target):
    """Validate the target's packed-leaf static metadata against what the
    checkpoint recorded: restoring codes under the wrong format/block would
    silently decode garbage."""
    mpath = os.path.join(step_dir, "manifest.json")
    if not os.path.exists(mpath):
        return
    with open(mpath) as f:
        recorded = json.load(f).get("packed")
    if not recorded:
        return
    have_all = _packed_meta(target)
    for key, have in have_all.items():
        want = recorded.get(key)
        if want is None:
            raise ValueError(f"target has packed leaf {key!r} but the "
                             "checkpoint saved it unpacked (or not at all)")
        if want != have:
            raise ValueError(f"packed leaf {key!r} metadata mismatch: "
                             f"checkpoint {want} vs target {have}")
    missing = sorted(set(recorded) - set(have_all))
    if missing:
        # e.g. a tied-head store saved with the injected packed "head" but
        # restored into a target that would silently project through raw
        # emb.T -- different numerics, no shape error to catch it
        raise ValueError(f"checkpoint saved packed leaves {missing} that "
                         "the restore target treats as unpacked; rebuild "
                         "the target with the same pack (see "
                         "models/model.packed_model_specs)")
