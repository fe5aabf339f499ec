"""The port's value-domain cached attention over the packed MXSF cache
against the JAX package's: reduced gemma2-9b on the kernel datapath
(``backend="cuda"``, the kernels' plain versions on CPU tensors; the JAX
side ``"pallas"`` in interpret mode), the path of the card's engine B --
the flash kernel's gate stays closed (softcaps, SWA), so the cache is
dequantized into the value path (``kv_prequant``).  Then the whole-prompt
``prefill`` of reduced h2o-danube-1.8b over a full-length cache (it writes
the prompt in one piece, as in the JAX package).  Runner, calls and
tolerances are ``test_torch_value_cache.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import MXSF_INFER as JAX_INFER
from repro.models import model as JM
from repro_torch.core.policy import MXSF_INFER as TORCH_INFER
from repro_torch.models import model as TM
from test_torch_value_cache import (B, CALLS, cfgs, check_cache,
                                    check_logits, close, params)


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_step_logits_match_jax(dtype, call):
    check_logits("gemma2-9b", "mxsf", dtype, "cuda", call)


def test_packed_cache_bytes_match_jax():
    check_cache("gemma2-9b", "mxsf", "cuda")


@pytest.mark.parametrize("kv_fmt", ["", "mxsf"])
def test_whole_prompt_prefill_matches_jax(kv_fmt):
    """Twin of ``test_serving_features.py::
    test_quantized_kv_cache_prefill_then_decode``: ``prefill`` of a
    20-token prompt (past the window) from position 0, then one decode
    step, at f32."""
    cj, ct = cfgs("h2o-danube-1.8b", "float32")
    pj, pt = params("h2o-danube-1.8b")
    pol_j = JAX_INFER.replace(kv_cache_fmt=kv_fmt)
    pol_t = TORCH_INFER.replace(kv_cache_fmt=kv_fmt)
    toks = np.random.default_rng(5).integers(0, 256, size=(B, 20))
    toks = toks.astype(np.int32)
    cache_j = JM.init_cache(cj, B, 24, dtype=jnp.float32, ring=False,
                            kv_fmt=kv_fmt)
    cache_t = TM.init_cache(ct, B, 24, dtype=torch.float32, ring=False,
                            kv_fmt=kv_fmt, device="cpu")
    lj, cache_j = jax.jit(JM.prefill, static_argnums=(3, 4))(
        pj, {"tokens": jnp.asarray(toks)}, cache_j, cj, pol_j)
    lt, cache_t = TM.prefill(pt, {"tokens": torch.from_numpy(toks)}, cache_t,
                             ct, pol_t)
    close(lt.numpy(), lj)
    for k in cache_t:
        if kv_fmt:
            np.testing.assert_array_equal(cache_t[k].numpy(), cache_j[k])
        else:
            close(cache_t[k].numpy(), cache_j[k])
    nxt = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    lj, _ = jax.jit(JM.decode_step, static_argnums=(4, 5))(
        pj, jnp.asarray(nxt), cache_j, jnp.int32(20), cj, pol_j)
    lt, _ = TM.decode_step(pt, torch.from_numpy(nxt), cache_t, 20, ct, pol_t)
    close(lt.numpy(), lj)
