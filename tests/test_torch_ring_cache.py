"""The port's all-SWA ring cache against the JAX package's, on reduced
h2o-danube-1.8b (``swa_pattern="all"``, window 16): ``init_cache(ring=True)``
shrinks the cache to W = 16 columns, so the runner of
``test_torch_value_cache.py`` (``run_steps``: four 8-token window-aligned
``prefill_step`` chunks, then four ``decode_step``s) wraps the ring in both
entry points -- chunk 3 writes columns 0-7 again, and the decode steps
from position 29/32 go round once more.  Tolerances are that module's.
"""
import pytest

from repro.models import model as JM
from repro_torch.models import model as TM
from test_torch_value_cache import (B, CALLS, MAX_LEN, calls, cfgs,
                                    check_cache, check_kpos, check_logits)

ARCH, W = "h2o-danube-1.8b", 16


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_fmt", ["", "mxsf"])
def test_ring_step_logits_match_jax(kv_fmt, dtype, call):
    check_logits(ARCH, kv_fmt, dtype, "torch", call)


@pytest.mark.parametrize("kv_fmt", ["", "mxsf"])
def test_ring_cache_contents_match_jax(kv_fmt):
    check_cache(ARCH, kv_fmt)


@pytest.mark.parametrize("call", CALLS)
def test_ring_kpos_bitwise(call):
    """Each ring column's absolute position: the last W written, negative
    where a column was never written."""
    kpos = check_kpos(ARCH, "", call)
    assert kpos.shape == (B, W)
    kind, _, pos, nv = calls()[call]
    end = pos + (nv if kind == "prefill" else 1) - 1
    for b in range(B):
        held = sorted(int(p) for p in kpos[b] if p >= 0)
        assert held == list(range(max(0, end[b] - W + 1), end[b] + 1))


def test_ring_shrinks_to_the_window():
    cj, ct = cfgs(ARCH, "float32")
    for ring, width in ((True, W), (False, MAX_LEN)):
        for kv_fmt in ("", "mxsf"):
            cache = TM.init_cache(ct, B, MAX_LEN, ring=ring, kv_fmt=kv_fmt,
                                  device="cpu")
            want = JM.init_cache(cj, B, MAX_LEN, ring=ring, kv_fmt=kv_fmt)
            assert {k: tuple(v.shape) for k, v in cache.items()} == \
                {k: tuple(v.shape) for k, v in want.items()}
            assert next(iter(cache.values())).shape[3] == width
