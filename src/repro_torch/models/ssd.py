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
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn

from ..configs.base import ModelConfig
from ..core.policy import QuantPolicy
from .blocks import dense, rmsnorm


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


def _split_proj(zxbcdt, cfg: ModelConfig):
    dI, G, N, H, P = _dims(cfg)
    return (zxbcdt[..., :dI], zxbcdt[..., dI:2 * dI + 2 * G * N],
            zxbcdt[..., 2 * dI + 2 * G * N:])


def _gate_out(p, y, z, x_resid, cfg: ModelConfig, policy: QuantPolicy):
    y = y + x_resid * p["D"].to(y.dtype)[None, None, :, None]  # D skip
    B, L = y.shape[:2]
    y = y.reshape(B, L, cfg.d_inner)
    y = rmsnorm({"w": p["norm_w"]}, y * Fn.silu(z))
    return dense(y, p["out_proj"], policy)


def ssd_forward(p, u, cfg: ModelConfig, policy: QuantPolicy, *,
                return_state: bool = False):
    """u: (B, L, d_model) -> (B, L, d_model) [+ the cache {state, conv}].
    L must be a multiple of ``min(ssm_chunk, L)``."""
    Bsz, L, _ = u.shape
    dI, G, N, H, P = _dims(cfg)
    Hg = H // G
    Q = min(cfg.ssm_chunk, L)
    if L % Q:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"SSD chunk {Q}")
    nc = L // Q
    f32 = torch.float32

    zxbcdt = dense(u, p["in_proj"], policy)
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    xBC_conv = Fn.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
    x = xBC_conv[..., :dI].reshape(Bsz, L, G, Hg, P).to(f32)
    Bm = xBC_conv[..., dI:dI + G * N].reshape(Bsz, L, G, N).to(f32)
    Cm = xBC_conv[..., dI + G * N:].reshape(Bsz, L, G, N).to(f32)

    dt = _softplus(dt.to(f32) + p["dt_bias"])                 # (B, L, H)
    A = -torch.exp(p["A_log"].to(f32))                          # (H,)
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
        return out, {"state": S, "conv": xBC[:, -(cfg.ssm_conv - 1):, :]}
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
    dI, G, N, H, P = _dims(cfg)
    Hg = H // G
    f32 = torch.float32

    zxbcdt = dense(u, p["in_proj"], policy)
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    # conv over (tail ++ current)
    hist = torch.cat([cache["conv"], xBC.to(cache["conv"].dtype)], dim=1)
    xc = (hist * p["conv_w"][None, :, :]).sum(dim=1) + p["conv_b"]
    xc = Fn.silu(xc)                                            # (B, C)
    x = xc[:, :dI].reshape(Bsz, G, Hg, P).to(f32)
    Bm = xc[:, dI:dI + G * N].reshape(Bsz, G, N).to(f32)
    Cm = xc[:, dI + G * N:].reshape(Bsz, G, N).to(f32)

    dt = _softplus(dt[:, 0].to(f32) + p["dt_bias"])             # (B, H)
    A = -torch.exp(p["A_log"].to(f32))
    dA = torch.exp(dt * A).reshape(Bsz, G, Hg)

    S_new = dA[..., None, None] * cache["state"] + torch.einsum(
        "bgh,bgm,bghp->bghpm", dt.reshape(Bsz, G, Hg), Bm, x)
    y = torch.einsum("bgm,bghpm->bghp", Cm, S_new).reshape(Bsz, 1, H, P)
    x_resid = x.reshape(Bsz, 1, H, P)
    out = _gate_out(p, y.to(u.dtype), z, x_resid.to(u.dtype), cfg, policy)
    cache["state"].copy_(S_new)
    cache["conv"].copy_(hist[:, 1:])
    return out, cache
