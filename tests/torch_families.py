"""Shared pieces of the port's family parity tests (``test_torch_ssm.py``,
``test_torch_hybrid.py``, ``test_torch_encdec.py``, ``test_torch_vlm.py``):
the same reduced config in both packages, the JAX package's weights carried
across through numpy, jitted JAX entry points, the step-0 loss and gradients
of both packages, and the comparisons with their tolerances.

Tolerances, and why (float32 throughout unless a test says otherwise):

* logits, SSD outputs, states: rtol 1e-5 with atol 1e-5 of the largest
  magnitude -- the packages sum the same exact products in different
  orders and evaluate exp/rsqrt/softplus/sin/cos with their own f32
  routines (measured: ~1e-6 at most);
* step-0 loss rtol 1e-5, every gradient leaf within 1e-4 relative L2
  (``test_torch_train.py``'s): the MXSF codes of both packages agree at
  step 0 of these inputs, so only the f32 order remains.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jax_config
from repro.kernels import ops as JOPS
from repro.models import model as JM
from repro.train import step as JT
from repro_torch import convert
from repro_torch.configs.base import get_config as torch_config
from repro_torch.kernels import mxsf_attention as MA
from repro_torch.train import step as TT

torch.set_num_threads(2)

JAX_FORWARD = jax.jit(JM.forward, static_argnums=(2, 3))
JAX_PREFILL = jax.jit(JM.prefill, static_argnums=(3, 4))
JAX_DECODE = jax.jit(JM.decode_step, static_argnums=(4, 5))
JAX_PACK = jax.jit(JM.pack_model_params, static_argnums=(0, 2))


def cfgs(arch: str, dtype: str = "float32", **kw):
    """The reduced config of ``arch`` in both packages."""
    return (jax_config(arch).replace(compute_dtype=dtype, **kw),
            torch_config(arch).replace(compute_dtype=dtype, **kw))


def jax_params(cj, seed: int = 0):
    return JM.init_params(jax.random.PRNGKey(seed), cj)


def to_port(tree, ct):
    """A JAX parameter tree (values or packed) as the port's."""
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree), ct)


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def close(got, want, rtol=1e-5):
    """Within rtol elementwise plus rtol of the largest magnitude."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def flat(tree, prefix=()):
    """{path: numpy leaf} of a tree of either package (bf16 as f32)."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(flat(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return {prefix: (t.float() if t.dtype == torch.bfloat16
                         else t).numpy()}
    a = np.asarray(tree)
    return {prefix: a.astype(np.float32) if a.dtype.name == "bfloat16"
            else a}


def dtypes(tree, prefix=()):
    """{path: dtype name} of a cache of either package."""
    return {p: str(v.dtype).replace("torch.", "")
            for p, v in _leaves(tree, prefix)}


def _leaves(tree, prefix):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def step0_both(params_j, cj, ct, batch, jpol, tpol, remat="none"):
    """Loss and gradients of one train step's loss in both packages on the
    same parameters and batch: ((loss_j, grads_j), (loss_t, grads_t)), the
    gradients as {path: numpy}."""
    tk = JT.TrainConfig(remat="none")
    (lj, _), gj = jax.jit(jax.value_and_grad(JT.loss_fn, has_aux=True),
                          static_argnums=(2, 3, 4))(params_j, batch, cj, jpol,
                                                    tk)
    pairs = TT._flatten(to_port(params_j, ct))
    leaves = [leaf.detach().requires_grad_() for _, leaf in pairs]
    tree = TT._unflatten((p, leaf) for (p, _), leaf in zip(pairs, leaves))
    lt, _ = TT.loss_fn(tree, to_torch(batch), ct, tpol,
                       TT.TrainConfig(remat=remat))
    gt = torch.autograd.grad(lt, leaves, allow_unused=True)
    gt = {p: (np.zeros(leaf.shape, np.float32) if g is None
              else g.float().numpy())
          for (p, leaf), g in zip(pairs, gt)}
    return (float(lj), flat(gj)), (float(lt), gt)


def assert_step0(both, loss_rtol=1e-5, grad_rtol=1e-4):
    (lj, gj), (lt, gt) = both
    np.testing.assert_allclose(lt, lj, rtol=loss_rtol)
    assert sorted(gt) == sorted(gj)
    for path in gj:
        assert rel_l2(gt[path], gj[path]) <= grad_rtol, path


def attention_calls(fn):
    """Run ``fn()`` recording every call of the port's attention kernel
    wrapper: [(inputs, keyword arguments, output)]."""
    calls, kernel = [], MA.mxsf_attention

    def recording(q, *kv, **kw):
        out = kernel(q, *kv, **kw)
        calls.append(([t.clone() for t in (q,) + kv], kw, out))
        return out

    MA.mxsf_attention = recording
    try:
        fn()
    finally:
        MA.mxsf_attention = kernel
    return calls


def assert_attention_calls_match_jax(calls):
    """Each recorded kernel call against the JAX package's kernel (Pallas
    in interpret mode) on the same inputs: the teacher-forced comparison
    of the kernel datapath, whose free run is chaotic under MX rounding
    (an ulp of f32 order on a rounding midpoint flips a code)."""
    assert calls
    for args, kw, out in calls:
        want = JOPS.mxsf_attention(
            *(jnp.asarray(t.numpy()) for t in args), causal=kw["causal"],
            **{k: None if kw[k] is None else jnp.asarray(kw[k].numpy())
               for k in ("kv_len", "q_offset", "window")})
        close(out, want)
