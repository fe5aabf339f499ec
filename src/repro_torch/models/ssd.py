"""Mamba2 / SSD (state-space duality) block.

PyTorch counterpart of the JAX package's ``models/ssd.py``: the chunked
SSD algorithm (Dao & Gu 2024) -- an intra-chunk quadratic term plus an
inter-chunk recurrent state carried chunk by chunk (the JAX package's
``lax.scan``, here a Python loop).  All recurrence math is f32.  The MX
technique applies to ``in_proj``/``out_proj`` only, which go through
``blocks.dense`` -> ``mx_dot`` (the fused-matmul kernel when packed); the
recurrence is plain torch, as the reference's is plain jnp.

``ssd_leaves`` lists one block's weights for the port's own init (the JAX
package's ``ssd_init`` distributions: in/out projections normal *
1/sqrt(rows), conv weights normal * 0.2, ``A_log`` = log(linspace(1, 16,
H)), ``dt_bias`` = log(expm1(0.01))).  The decode step updates the cache
dict in place; ``ssd_forward(return_state=True)`` returns a new one whose
``conv`` tail keeps the projection's dtype, as in the JAX package.

Tensor parallelism (inside a mesh context whose ``blocks.TPPlan`` splits
``ssm``): each rank runs H/tp of the heads.  ``in_proj`` is
column-parallel by segment: ``MeshRules`` stores its columns split
contiguously over the model axis, which does not fall on the
``[z | x | B | C | dt]`` boundaries, so ``use`` gathers the leaf and each
segment is cut to this rank's columns -- z, x and dt of its heads, all of
B and C (one group) -- codes and scales together: the local codes are the
one-device codes of those columns.  ``conv_w``, ``conv_b`` and the conv
tail take the same cut of their ``[x | B | C]`` channels.  The ``state``
cache splits its heads as ``cache_shardings`` places it, so the
recurrence runs on local heads with no collective; ``A_log``, ``D`` and
``dt_bias`` (replicated) are cut to them.  The gated RMSNorm over all of
d_inner sums each rank's f32 squares and all-reduces that sum over the
model axis (one (B, L, 1) f32 all-reduce; gathering y would move d_inner /
tp times more); ``norm_w``'s stored split falls on head boundaries.
``out_proj`` is row-parallel (``blocks._row_parallel``).  In training the
input enters the split (``blocks.entered_dense``), the gathers of
in_proj, ``conv_w`` and ``conv_b`` reduce-scatter the ranks' partial
gradients into the stored slices (their consumer is split: B and C serve
every rank's heads; a leaf stored whole all-reduces them), ``A_log``,
``D`` and ``dt_bias`` gather their heads' gradients back
(``sharding.take_slots``), and the norm's all-reduce sums its gradient
over the model axis.  The conv tail is
stored split contiguously over its channels: a decode step gathers it,
cuts its compute channels, gathers the new column's x channels and writes
back only the slice the rank stores, in place; a prefill returns the tail
as the stored slice, in the projection's dtype.  Where the plan keeps the
SSD replicated, the same gathers give the whole caches and each rank
writes back its stored slices (``ssd_cache`` of the context: whether the
state's heads and the tail's channels are stored split).
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn

from ..configs.base import ModelConfig
from ..core import sharding as shd
from ..core.blocking import QuantizedTensor
from ..core.policy import QuantPolicy
from . import blocks as blk
from .blocks import dense


def _dims(cfg: ModelConfig):
    dI = cfg.d_inner
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    H = cfg.ssm_heads
    P = cfg.ssm_headdim
    return dI, G, N, H, P


def ssd_leaves(cfg: ModelConfig):
    """(path, shape, init kind) of each weight of one SSD block."""
    d = cfg.d_model
    dI, G, N, H, P = _dims(cfg)
    d_in = 2 * dI + 2 * G * N + H  # z, x, B, C, dt
    conv_ch = dI + 2 * G * N
    yield ("in_proj",), (d, d_in), "dense"
    yield ("conv_w",), (cfg.ssm_conv, conv_ch), "conv"
    yield ("conv_b",), (conv_ch,), "zeros"
    yield ("A_log",), (H,), "a_log"
    yield ("D",), (H,), "ones"
    yield ("dt_bias",), (H,), "dt_bias"
    yield ("norm_w",), (dI,), "ones"
    yield ("out_proj",), (dI, d), "dense"


def _softplus(x):
    """``jax.nn.softplus`` (logaddexp(x, 0)), not torch's thresholded
    form."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x, w, b):
    """Depthwise causal conv over time.  x: (B, L, C), w: (K, C); the K
    shifted products summed one at a time from zero, as the JAX package's
    Python ``sum``."""
    K, L = w.shape[0], x.shape[1]
    xp = Fn.pad(x, (0, 0, K - 1, 0))
    y = 0
    for i in range(K):
        y = y + xp[:, i:i + L, :] * w[i]
    return y + b


# ---------------------------------------------------------------------------
# tensor parallelism: compute and stored layouts
# ---------------------------------------------------------------------------

def _tp():
    """(model axis, this rank's index on it, ranks) where the active plan
    splits the SSD heads; None otherwise (one device, or replicated)."""
    if not blk._split("ssm"):
        return None
    ctx = shd.active()
    return ctx["tp"], ctx["mesh"].coord(ctx["tp"]), ctx["tp_size"]


def _local_dims(cfg: ModelConfig):
    """``_dims`` with d_inner and the heads this rank computes."""
    dI, G, N, H, P = _dims(cfg)
    tp = _tp()
    return (dI, G, N, H, P) if tp is None else (dI // tp[2], G, N,
                                                H // tp[2], P)


def _segments(cfg: ModelConfig, proj: bool):
    """(start, width, split by heads) of each segment of in_proj's
    columns (``proj``: z, x, B, C, dt) or of the conv channels (x, B,
    C)."""
    dI, G, N, H, P = _dims(cfg)
    widths = ([(dI, True)] if proj else []) + [(dI, True), (G * N, False),
                                               (G * N, False)]
    widths += [(H, True)] if proj else []
    out, start = [], 0
    for w, split in widths:
        out.append((start, w, split))
        start += w
    return out


def _take(t: torch.Tensor, dim: int, segments, unit: int = 1):
    """This rank's compute layout of a whole ``dim``: each segment's
    1/tp of a split one (its heads), all of another, concatenated
    (``unit``: elements per index along ``dim``, a packed leaf's column
    block for its scales)."""
    _, i, n = _tp()
    parts = []
    for start, width, split in segments:
        w = width // n if split else width
        lo = start + (i * w if split else 0)
        parts.append(t.narrow(dim, lo // unit, w // unit))
    return torch.cat(parts, dim)


def _use_segments(p, name: str, cfg: ModelConfig, proj: bool):
    """Leaf ``p[name]`` whose last dim is in_proj's columns (``proj``) or
    the conv channels, gathered whole and cut to this rank's segments
    where the plan splits the heads (codes and scales together).  Its
    consumer is split then: each rank reads its heads' columns and all of
    B and C, so the gather's adjoint reduce-scatters the ranks' partial
    gradients into the stored slice."""
    if _tp() is None:
        return blk.use(p, name)
    leaf = blk.use(p, name, consumer="split")
    seg = _segments(cfg, proj)
    if not isinstance(leaf, QuantizedTensor):
        return _take(leaf, -1, seg)
    b = leaf.block[-1]
    local = sum(w // _tp()[2] if s else w for _, w, s in seg)
    return QuantizedTensor(_take(leaf.codes, -1, seg),
                           _take(leaf.scale_e8m0, -1, seg, b), leaf.fmt,
                           leaf.block, tuple(leaf.shape[:-1]) + (local,),
                           leaf.dtype)


def _use_heads(p, name: str):
    """A per-head leaf (A_log, D, dt_bias; replicated), cut to this rank's
    heads (``sharding.take_slots``: in the backward the ranks' disjoint
    slices of its gradient are gathered)."""
    t = blk.use(p, name)
    if _tp() is None:
        return t
    return shd.take_slots(t, -1)


def _stored_split(entry: str) -> bool:
    """Whether the active context stores ``entry`` of the cache (the
    state's heads, the conv tail's channels) split over the model axis."""
    ctx = shd.active()
    return ctx is not None and ctx.get("ssd_cache", {}).get(entry, False)


def _relayout(t: torch.Tensor, dim: int, split_from: bool, split_to: bool):
    """A tensor split contiguously over the model axis along ``dim`` or
    whole, to the other: gathered, or cut to this rank's slice."""
    if split_from == split_to:
        return t
    ctx = shd.active()
    if split_from:
        return shd.all_gather(t, ctx["tp"], dim)
    n = t.shape[dim] // ctx["tp_size"]
    return t.narrow(dim, ctx["mesh"].coord(ctx["tp"]) * n, n)


def _whole_channels(t: torch.Tensor, cfg: ModelConfig):
    """Conv channels (..., C) from the compute layout to whole: the x
    channels gathered over the model axis (B and C are whole)."""
    tp = _tp()
    if tp is None:
        return t
    dIl = cfg.d_inner // tp[2]
    return torch.cat([shd.all_gather(t[..., :dIl], tp[0], -1),
                      t[..., dIl:]], -1)


def _split_proj(zxbcdt, cfg: ModelConfig):
    dI, G, N, H, P = _local_dims(cfg)
    return (zxbcdt[..., :dI], zxbcdt[..., dI:2 * dI + 2 * G * N],
            zxbcdt[..., 2 * dI + 2 * G * N:])


def _gate_out(p, y, z, x_resid, cfg: ModelConfig, policy: QuantPolicy):
    """D skip, the gated RMSNorm over all of d_inner (split: each rank's
    f32 sum of squares, all-reduced) and out_proj."""
    y = y + x_resid * _use_heads(p, "D").to(y.dtype)[None, None, :, None]
    B, L = y.shape[:2]
    tp = _tp()
    g = y.reshape(B, L, -1) * Fn.silu(z)
    gf = g.float()
    if tp is None:
        var = torch.mean(gf * gf, dim=-1, keepdim=True)
    else:
        # each rank's heads read the sum: a split consumer
        var = shd.all_reduce(torch.sum(gf * gf, dim=-1, keepdim=True),
                             tp[0], adjoint="all_reduce") / cfg.d_inner
    w = blk.use(p, "norm_w", None if tp is None else 0)
    y = (gf * torch.rsqrt(var + 1e-6) * w).to(g.dtype)
    return blk._row_parallel(y, p, "out_proj", tp is not None, policy)


def ssd_forward(p, u, cfg: ModelConfig, policy: QuantPolicy, *,
                return_state: bool = False):
    """u: (B, L, d_model) -> (B, L, d_model) [+ the cache {state, conv}].
    L must be a multiple of ``min(ssm_chunk, L)``."""
    Bsz, L, _ = u.shape
    dI, G, N, H, P = _local_dims(cfg)
    Hg = H // G
    Q = min(cfg.ssm_chunk, L)
    if L % Q:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"SSD chunk {Q}")
    nc = L // Q
    f32 = torch.float32

    # the column-parallel region's entry, where the heads split
    zxbcdt = (blk.entered_dense if _tp() else dense)(
        u, _use_segments(p, "in_proj", cfg, True), policy)
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    xBC_conv = Fn.silu(_causal_conv(xBC, _use_segments(p, "conv_w", cfg,
                                                       False),
                                    _use_segments(p, "conv_b", cfg, False)))
    x = xBC_conv[..., :dI].reshape(Bsz, L, G, Hg, P).to(f32)
    Bm = xBC_conv[..., dI:dI + G * N].reshape(Bsz, L, G, N).to(f32)
    Cm = xBC_conv[..., dI + G * N:].reshape(Bsz, L, G, N).to(f32)

    dt = _softplus(dt.to(f32) + _use_heads(p, "dt_bias"))     # (B, L, H)
    A = -torch.exp(_use_heads(p, "A_log").to(f32))              # (H,)
    dA = (dt * A).reshape(Bsz, nc, Q, G, Hg)
    dt_c = dt.reshape(Bsz, nc, Q, G, Hg)
    x_c = x.reshape(Bsz, nc, Q, G, Hg, P)
    B_c = Bm.reshape(Bsz, nc, Q, G, N)
    C_c = Cm.reshape(Bsz, nc, Q, G, N)

    cs = torch.cumsum(dA, dim=2)                                # (B,c,Q,g,h)
    # ---- intra-chunk quadratic term --------------------------------------
    CB = torch.einsum("bcigm,bcjgm->bcgij", C_c, B_c)           # (B,c,g,Q,Q)
    seg = cs[:, :, :, None] - cs[:, :, None, :]                 # i, j axes
    seg = seg.permute(0, 1, 4, 5, 2, 3)                         # (B,c,g,h,i,j)
    ii = torch.arange(Q, device=u.device)
    causal = ii[:, None] >= ii[None, :]
    decay = torch.where(causal, torch.exp(torch.clamp(seg, max=0.0)),
                        torch.zeros((), dtype=f32, device=u.device))
    M = (CB[:, :, :, None] * decay
         * dt_c.permute(0, 1, 3, 4, 2)[:, :, :, :, None, :])
    y_intra = torch.einsum("bcghij,bcjghp->bcighp", M, x_c)

    # ---- chunk states + inter-chunk recurrence ----------------------------
    w_state = torch.exp(cs[:, :, -1:, :, :] - cs) * dt_c        # (B,c,Q,g,h)
    states = torch.einsum("bcjgh,bcjgm,bcjghp->bcghpm", w_state, B_c, x_c)
    chunk_decay = torch.exp(torch.sum(dA, dim=2))               # (B,c,g,h)
    S = torch.zeros((Bsz, G, Hg, P, N), dtype=f32, device=u.device)
    y_inter = []
    for c in range(nc):
        y_int = torch.einsum("bigm,bghpm->bighp", C_c[:, c], S)
        y_inter.append(y_int * torch.exp(cs[:, c])[..., None])
        S = chunk_decay[:, c][..., None, None] * S + states[:, c]
    y_inter = torch.stack(y_inter, dim=1)                       # (B,c,i,g,h,p)

    y = (y_intra + y_inter).reshape(Bsz, L, H, P)
    x_resid = x.reshape(Bsz, L, H, P)
    out = _gate_out(p, y.to(u.dtype), z, x_resid.to(u.dtype), cfg, policy)
    if return_state:
        tail = _whole_channels(xBC[:, -(cfg.ssm_conv - 1):, :], cfg)
        return out, {"state": _relayout(S, -3, _tp() is not None,
                                        _stored_split("state")),
                     "conv": _relayout(tail, -1, False,
                                       _stored_split("conv"))}
    return out


def ssd_init_cache(cfg: ModelConfig, batch: int, lead=(), device=None):
    """Zeroed decode cache of ``lead`` stacked SSD blocks: the f32 state
    (..., B, G, H/G, P, N) and the f32 conv tail (..., B, K-1, C)."""
    dI, G, N, H, P = _dims(cfg)
    z = lambda *s: torch.zeros((*lead, batch, *s), dtype=torch.float32,
                               device=device)
    return {"state": z(G, H // G, P, N),
            "conv": z(cfg.ssm_conv - 1, dI + 2 * G * N)}


def ssd_decode_step(p, u, cache, cfg: ModelConfig, policy: QuantPolicy):
    """One-token recurrent update.  u: (B, 1, d_model); ``cache`` (one
    block's ``state`` and ``conv``) is updated in place, in its own
    dtypes.  Returns (out, cache)."""
    Bsz = u.shape[0]
    dI, G, N, H, P = _local_dims(cfg)
    Hg = H // G
    f32 = torch.float32
    split = _tp() is not None
    state_split, conv_split = _stored_split("state"), _stored_split("conv")

    zxbcdt = dense(u, _use_segments(p, "in_proj", cfg, True), policy)
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    # conv over (tail ++ current), the tail in the compute layout
    tail = _relayout(cache["conv"], -1, conv_split, False)
    new = xBC.to(tail.dtype)
    hist = torch.cat([_take(tail, -1, _segments(cfg, False)) if split
                      else tail, new], dim=1)
    xc = (hist * _use_segments(p, "conv_w", cfg, False)[None, :, :]).sum(
        dim=1) + _use_segments(p, "conv_b", cfg, False)
    xc = Fn.silu(xc)                                            # (B, C)
    x = xc[:, :dI].reshape(Bsz, G, Hg, P).to(f32)
    Bm = xc[:, dI:dI + G * N].reshape(Bsz, G, N).to(f32)
    Cm = xc[:, dI + G * N:].reshape(Bsz, G, N).to(f32)

    dt = _softplus(dt[:, 0].to(f32) + _use_heads(p, "dt_bias"))  # (B, H)
    A = -torch.exp(_use_heads(p, "A_log").to(f32))
    dA = torch.exp(dt * A).reshape(Bsz, G, Hg)

    S_prev = _relayout(cache["state"], -3, state_split, split)
    S_new = dA[..., None, None] * S_prev + torch.einsum(
        "bgh,bgm,bghp->bghpm", dt.reshape(Bsz, G, Hg), Bm, x)
    y = torch.einsum("bgm,bghpm->bghp", Cm, S_new).reshape(Bsz, 1, H, P)
    x_resid = x.reshape(Bsz, 1, H, P)
    out = _gate_out(p, y.to(u.dtype), z, x_resid.to(u.dtype), cfg, policy)
    cache["state"].copy_(_relayout(S_new, -3, split, state_split))
    tail = torch.cat([tail[:, 1:], _whole_channels(new, cfg)], dim=1)
    cache["conv"].copy_(_relayout(tail, -1, False, conv_split))
    return out, cache
