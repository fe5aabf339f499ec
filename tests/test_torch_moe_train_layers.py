"""The port's quantized (``MXSF_TRAIN``) MoE decoder layers against the
JAX package's at the whole reduced depth of qwen2-moe-a2.7b and
llama4-maverick, in float32, with the weights and batch of
``test_torch_moe_train.py``.

Each sublayer is fed the JAX package's own input to it, and the JAX side
runs op by op, not jitted: XLA's fusions round f32 differently, and at the
second qwen2-moe layer that ~1e-7 lands on an MX rounding midpoint and
flips a code, so the jitted JAX package leaves its own op-by-op run there
by as much as it leaves the port.  The tolerance against the op-by-op run
is two f32 ulps of the largest output element.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.policy import MXSF_TRAIN as JAX_TRAIN
from repro.models import transformer as JTr
from repro_torch.core.policy import MXSF_TRAIN as TORCH_TRAIN
from repro_torch.models import transformer as TTr
from test_torch_moe_train import _batch, _cfgs, _params


def check_layers(arch):
    """Every sublayer of the reduced config at its whole depth, fed the
    JAX package's input to it: the port's output against the JAX
    package's op-by-op sublayer within the module docstring's tolerance."""
    cj, ct = _cfgs(arch, "none", "float32")  # the whole reduced depth
    pj, pt = _params(arch, "none")
    n = cj.n_layers // cj.moe_every
    x = JTr._embed_tokens(pj, {"tokens": _batch(cj.vocab)["tokens"]}, cj)
    B, S, _ = x.shape
    pos_j = jax.numpy.broadcast_to(jax.numpy.arange(S)[None], (B, S))
    pos_t = torch.arange(S)[None].expand(B, S)
    wj, wt = (JTr._layer_windows(cj, cj.n_layers),
              TTr.layer_windows(ct, ct.n_layers))
    layers = TTr._unstack(pt["layers"], n)
    checked = 0
    for i in range(n):
        lpj = jax.tree.map(lambda a: a[i], pj["layers"])
        for j in range(cj.moe_every):
            w = i * cj.moe_every + j
            is_moe = TTr.is_moe_sublayer(ct, j)
            y, _ = JTr._apply_sublayer(lpj[f"sub{j}"], x, cj, JAX_TRAIN,
                                       positions=pos_j, window=wj[w],
                                       is_moe=is_moe)
            with torch.no_grad():
                got = TTr._apply_sublayer(
                    layers[i][f"sub{j}"], torch.from_numpy(np.array(x)),
                    ct, TORCH_TRAIN, positions=pos_t, window=wt[w],
                    is_moe=is_moe).numpy()
            want = np.asarray(y)
            tol = 2 * np.spacing(np.abs(want).max())
            assert np.abs(got - want).max() <= tol, (i, j)
            checked += is_moe
            x = y
    assert checked == n


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b",
                                  "llama4-maverick-400b-a17b"])
def test_quantized_sublayers_match_jax_at_full_depth(arch):
    check_layers(arch)
