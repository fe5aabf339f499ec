"""Remat ``"dots"``: the port's counterpart of the JAX package's
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``, now the
default of ``TrainConfig`` in both packages.

What the JAX package's policy keeps across one layer (found with
``jax.ad_checkpoint.print_saved_residuals`` on one reduced h2o-danube
sublayer under ``MXSF_TRAIN``): with the value-domain backend (``"jnp"``,
the default) the layer's inputs and the output of each ``mx_dot``'s
matmul whose value a later saved residual depends on -- q, k, v, o, the
gate and the up projection, (M, N) in f32; not the down projection's,
which feeds only the residual add -- and nothing else: the MX codes of x
and w, rmsnorm, rope, the attention scores and probabilities are
recomputed (the attention einsums have batch dims, so the policy never
keeps them).  With the kernel backend (``"pallas"``) the matmul is a
``pallas_call``, not a ``dot_general``, and the policy keeps only the
inputs.  The port keeps every raw-weight ``mx_dot`` output of the layer
(the down projection's too: it cannot see that nothing downstream needs
it) on both of its backends, and its recompute quantizes the operands
again but runs no matmul.  On the CPU the recompute is bitwise, so
``"dots"``, ``"full"`` and ``"none"`` give the same gradients bit for bit.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.ad_checkpoint import print_saved_residuals

from repro.core.policy import MXSF_TRAIN as JAX_TRAIN
from repro.models import transformer as JTR
from repro.train import step as JT
from repro_torch.configs.base import get_config
from repro_torch.core import mx_dot as MXD
from repro_torch.core.policy import MXSF_TRAIN
from repro_torch.kernels import mx_matmul as MM
from repro_torch.kernels import mxsf_fused_matmul as FM
from repro_torch.kernels import mxsf_quant as MQ
from repro_torch.models import transformer as TT
from repro_torch.train import step as TS
from torch_families import cfgs

torch.set_num_threads(2)

ARCHS = ["h2o-danube-1.8b-reduced", "mamba2-780m-reduced",
         "zamba2-7b-reduced", "whisper-medium-reduced",
         "internvl2-1b-reduced", "deit-tiny-reduced"]


def test_train_config_defaults_to_dots_in_both_packages():
    assert TS.TrainConfig().remat == JT.TrainConfig().remat == "dots"


def _batch(cfg, B=2, S=16):
    g = torch.Generator().manual_seed(1)
    if cfg.family == "encoder":
        return {"embeds": torch.randn(B, cfg.frontend_tokens, cfg.d_model,
                                      generator=g),
                "label": torch.randint(0, cfg.n_classes, (B,), generator=g)}
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(B, cfg.enc_seq, cfg.d_model,
                                      generator=g)
    if cfg.frontend_tokens and cfg.family != "encoder":
        batch["embeds"] = torch.randn(B, cfg.frontend_tokens, cfg.d_model,
                                      generator=g)
    return batch


def _grads(cfg, policy, remat):
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    pairs = TS._flatten(params)
    leaves = [leaf.requires_grad_() for _, leaf in pairs]
    tree = TS._unflatten((p, leaf) for (p, _), leaf in zip(pairs, leaves))
    loss, _ = TS.loss_fn(tree, _batch(cfg), cfg, policy,
                         TS.TrainConfig(remat=remat))
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dots_gradients_equal_none_bitwise(arch, backend):
    cfg = get_config(arch).replace(compute_dtype="float32")
    policy = MXSF_TRAIN.replace(backend=backend)
    l0, g0 = _grads(cfg, policy, "none")
    for remat in ("dots", "full"):
        l1, g1 = _grads(cfg, policy, remat)
        assert torch.equal(l0, l1)
        for a, b in zip(g0, g1):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)


def _jax_saved(capsys, cj):
    """Shapes of the non-argument residuals the JAX package's "dots"
    policy keeps across one sublayer."""
    params = JTR.init_params(jax.random.PRNGKey(0), cj)
    lp = jax.tree.map(lambda a: a[0], params["layers"])["sub0"]
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 16, cj.d_model))
    pos = jnp.broadcast_to(jnp.arange(16)[None], (2, 16))

    def f(lp, x):
        return JTR._apply_sublayer(lp, x, cj, JAX_TRAIN, positions=pos,
                                   window=JTR.NO_WINDOW,
                                   is_moe=False)[0].sum()

    capsys.readouterr()
    print_saved_residuals(jax.checkpoint(
        f, policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable),
        lp, x)
    rows = [r for r in capsys.readouterr().out.splitlines()
            if r.strip() and "from the argument" not in r
            and "from a constant" not in r]
    assert all("mx_dot" in r for r in rows), rows
    return sorted(tuple(int(d) for d in r.split("[")[1].split("]")[0]
                        .split(",")) for r in rows)


def test_dots_keeps_the_matmul_outputs_and_recomputes_no_matmul(capsys):
    """One sublayer under "dots": the port keeps exactly the outputs of
    its raw-weight ``mx_dot`` calls -- the JAX package's kept residuals
    plus the down projection's -- and its recompute quantizes x and w of
    each call again (two quantizer calls) without any matmul."""
    cj, ct = cfgs("h2o-danube-1.8b-reduced", n_layers=1,
                  swa_pattern="none")
    want = _jax_saved(capsys, cj)
    kept = []
    save_dots = MXD.save_dots

    def spy():
        fwd, rec = save_dots()
        kept.append(fwd.saved)
        return fwd, rec

    calls = {"quantize": 0, "fused": 0, "matmul": 0}
    wrapped = [(MQ, "mxsf_quantize", "quantize"),
               (FM, "mxsf_fused_matmul", "fused"),
               (MM, "mxsf_matmul", "matmul")]
    saved = [(m, n, getattr(m, n)) for m, n, _ in wrapped]

    def counting(fn, key):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    policy = MXSF_TRAIN.replace(backend="cuda")
    params = TT.init_params(ct, torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, ct.d_model, requires_grad=True)
    TT.save_dots, counts = spy, []
    try:
        for m, n, key in wrapped:
            setattr(m, n, counting(getattr(m, n), key))
        for remat in ("dots", "full"):
            for k in calls:
                calls[k] = 0
            y = TT._run_layers(params["layers"], 1, lambda x, lp, i: (
                TT._apply_sublayer(lp["sub0"], x, ct, policy,
                                   positions=torch.arange(16)[None],
                                   window=TT.NO_WINDOW)), x, remat)
            fwd = dict(calls)
            y.sum().backward()
            counts.append((fwd, {k: calls[k] - fwd[k] for k in calls}))
    finally:
        TT.save_dots = save_dots
        for m, n, fn in saved:
            setattr(m, n, fn)
    got = sorted(tuple(t.shape) for t in kept[0])
    down = (32, ct.d_model)  # (B*S, d): the down projection's output
    assert got == sorted(want + [down])
    # forward: w quantized, fused matmul, 7 times; backward: "dots"
    # quantizes x and w of each matmul again but runs no fused matmul,
    # "full" runs the forward again; both quantize g once and run dx, dw
    assert counts[0] == ({"quantize": 7, "fused": 7, "matmul": 0},
                         {"quantize": 7 * 3, "fused": 0, "matmul": 14})
    assert counts[1] == ({"quantize": 7, "fused": 7, "matmul": 0},
                         {"quantize": 7 * 2, "fused": 7, "matmul": 14})
