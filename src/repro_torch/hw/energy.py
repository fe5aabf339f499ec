"""Analytic accelerator energy model (paper §VI-D, Fig. 7 / Table IV).

A copy of the JAX package's ``hw/energy.py``, so the port imports nothing
of it.  BitMoD-style accounting: energy = off-chip traffic + on-chip
traffic + core, from per-access energies and the tensor-traffic counts of
one training step (``training_step_counts``).  These are analytic figures
of a modelled accelerator, not measurements of any card: the paper's
relative claim -- MXSF cuts total training energy ~25% vs BF16, dominated
by off-chip access (83.9% of total) -- is reproducible from first
principles.

Per-access energies (45nm-normalized, BitMoD/Horowitz-style constants):
  DRAM   : 20.0 pJ/bit
  SRAM   : 0.62 pJ/bit  (large on-chip buffers)
  MAC    : per-format multiplier+adder energy (synth-style estimates)
"""
from __future__ import annotations

import dataclasses
from typing import Dict

DRAM_PJ_PER_BIT = 20.0
SRAM_PJ_PER_BIT = 0.62

# multiply-accumulate energy per op (pJ): multiplier scales ~quadratically
# with mantissa width; adder with accumulator width.
MAC_PJ = {
    "bf16": 1.20,          # bf16 mul + fp32 add
    "mxsf": 0.45,          # E4M5-covering mul + FP12_E4M7 adder (paper SV-B)
    "mxfp8_e4m3": 0.42,
    "mxfp8_e2m5": 0.47,
    "mxint8": 0.30,
    "mxfp4_e2m1": 0.22,
}

BITS_PER_ELEM = {
    "bf16": 16.0,
    # 8-bit codes + one E8M0 scale per block
    "mxsf": 8.0, "mxfp8_e4m3": 8.0, "mxfp8_e2m5": 8.0, "mxint8": 8.0,
    "mxfp4_e2m1": 4.0,
}


def block_bits(fmt: str, block_elems: int) -> float:
    b = BITS_PER_ELEM[fmt]
    if fmt == "bf16":
        return b
    return b + 8.0 / block_elems


@dataclasses.dataclass
class StepCounts:
    """Tensor-traffic counts for one training step (elements, not bytes)."""
    weight_elems: int
    act_elems: int
    grad_elems: int
    macs: int
    opt_elems: int = 0         # optimizer state traffic — format-INdependent
    attn_bf16_elems: int = 0   # operands kept in BF16 (MXFP4 baseline's QK/AV)
    attn_bf16_macs: int = 0


def training_step_counts(cfg, batch: int, seq: int) -> StepCounts:
    """DeiT-style encoder counts: fwd + bwd traffic per step."""
    d, f, L, H = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.n_heads
    dh = cfg.head_dim
    toks = batch * seq
    w_per_layer = 4 * d * H * dh + (2 if cfg.mlp == "gelu" else 3) * d * f
    acts_per_layer = toks * (6 * d + 2 * f)
    attn_elems = 2 * batch * H * seq * seq
    macs_lin = toks * w_per_layer
    macs_attn = 2 * batch * H * seq * seq * dh
    return StepCounts(
        # weights read fwd + bwd(reuse) + grads written
        weight_elems=3 * L * w_per_layer,
        act_elems=2 * L * (acts_per_layer + attn_elems),
        grad_elems=L * (acts_per_layer + attn_elems),
        macs=3 * L * (macs_lin + macs_attn),
        # AdamW: read m, v, master + write m, v, master (bf16 on-device
        # states) — this traffic does NOT shrink with the compute format,
        # which is why total savings cap well below the raw 16->8.25 ratio.
        opt_elems=6 * L * w_per_layer,
    )


def step_energy(counts: StepCounts, fmt: str, block_elems: int = 64,
                attn_in_bf16: bool = False) -> Dict[str, float]:
    """Joules per training step under one format."""
    bits = block_bits(fmt, block_elems)
    traffic = (counts.weight_elems + counts.act_elems + counts.grad_elems)
    attn_traffic = counts.attn_bf16_elems
    offchip = traffic * bits + attn_traffic * 16.0 + counts.opt_elems * 16.0
    onchip = 3.0 * offchip  # each operand re-read ~3x from on-chip buffers
    mac_e = counts.macs * MAC_PJ[fmt] + counts.attn_bf16_macs * MAC_PJ["bf16"]
    res = {
        "offchip_J": offchip * DRAM_PJ_PER_BIT * 1e-12,
        "onchip_J": onchip * SRAM_PJ_PER_BIT * 1e-12,
        "core_J": mac_e * 1e-12,
    }
    res["total_J"] = sum(res.values())
    return res
