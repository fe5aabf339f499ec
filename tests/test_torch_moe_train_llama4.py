"""The port's MoE training forward and its step-0 gradients against the
JAX package's on reduced llama4-maverick (``moe_every=2``: a dense and an
MoE sublayer per super-layer; ``top_k=1``), with the cases, inputs and
tolerances of ``test_torch_moe_train.py``."""
import pytest

from test_torch_moe_train import cases, check_step0


@pytest.mark.parametrize("arch,pol,dtype",
                         cases("llama4-maverick-400b-a17b"))
def test_step0_loss_and_grads_match_jax(arch, pol, dtype):
    check_step0(arch, pol, dtype)
