"""Deterministic synthetic LM and vision data (no corpora available
offline).

PyTorch counterpart of the JAX package's ``data/pipeline.py``:
``lm_batch`` walks a Markov chain over a fixed random bigram transition
table -- learnable structure, so training runs can separate numeric
formats; ``vision_batch`` draws patch embeddings as a class prototype plus
noise.  Same construction and distributions as the JAX package, drawn
from ``torch.Generator``s seeded by ``seed`` (the table, the prototypes)
and by (seed, step) (the walk, the labels and noise), so a batch is a pure
function of (seed, step, device).  ``device=None`` means the card and
raises when CUDA is absent; pass ``device="cpu"`` to build batches on the
CPU.  The bits differ from the JAX package's; parity tests feed the JAX
package's batches through numpy instead.
"""
from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["make_transition", "lm_batch", "vision_batch"]


def make_transition(seed: int, vocab: int, device=None) -> torch.Tensor:
    """Fixed sparsely-peaked bigram transition logits (vocab, vocab): a
    normal * 0.5 base plus 4.0 on four favourite successors per token
    (repeats add up).  Built in place: at vocab 32000 the table is 4.1 GB."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    trans = torch.randn((vocab, vocab), generator=gen, device=device)
    trans.mul_(0.5)
    fav = torch.randint(0, vocab, (vocab, 4), generator=gen, device=device)
    rows = torch.arange(vocab, device=device)[:, None].expand(vocab, 4)
    trans.index_put_((rows, fav), torch.full((vocab, 4), 4.0, device=device),
                     accumulate=True)
    return trans


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             device=None):
    """(tokens, labels) each (batch, seq) int32; labels = next token."""
    device = resolve_device(device)
    trans = make_transition(seed, vocab, device)
    gen = torch.Generator(device=device).manual_seed(
        (seed + 7919) * 1_000_003 + step)
    tok = torch.randint(0, vocab, (batch,), generator=gen, device=device)
    toks = [tok]
    for _ in range(seq):
        probs = torch.softmax(trans[tok], dim=-1)
        tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
        toks.append(tok)
    del trans
    toks = torch.stack(toks, dim=1).to(torch.int32)  # (batch, seq + 1)
    return toks[:, :seq].contiguous(), toks[:, 1:seq + 1].contiguous()


def vision_batch(seed: int, step: int, batch: int, tokens: int, dim: int,
                 classes: int, device=None):
    """(patch_embeds (batch, tokens, dim) bf16, labels (batch,) int32): a
    fixed N(0, 1) prototype per class plus N(0, 1.5^2) noise per step."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    protos = torch.randn((classes, tokens, dim), generator=gen,
                         device=device)
    gen = torch.Generator(device=device).manual_seed(
        (seed + 131) * 1_000_003 + step)
    labels = torch.randint(0, classes, (batch,), generator=gen,
                           device=device)
    noise = torch.randn((batch, tokens, dim), generator=gen, device=device)
    x = protos[labels] + noise * 1.5
    return x.to(torch.bfloat16), labels.to(torch.int32)
