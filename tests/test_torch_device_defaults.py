"""Where the port's constructors put their tensors when the caller names no
device: ``init_params`` and ``init_packed_params`` follow the generator's
device, ``init_cache`` takes the card and raises without CUDA (no CPU
fallback), as the other entry points do (``device.resolve_device``)."""
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.policy import MXSF_INFER
from repro_torch.core.packed_store import tree_leaves
from repro_torch.models import model as TM


@pytest.fixture(scope="module")
def cfg():
    return get_config("qwen2.5-32b").reduced().replace(n_layers=1)


def test_init_params_follow_the_generators_device(cfg):
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    assert {t.device.type for t in tree_leaves(params)} == {"cpu"}
    again = TM.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(again)))


def test_init_packed_params_follow_the_generators_device(cfg):
    store = TM.init_packed_params(cfg, MXSF_INFER,
                                  torch.Generator().manual_seed(0))
    assert {getattr(t, "codes", t).device.type
            for t in tree_leaves(store)} == {"cpu"}


@pytest.mark.parametrize("kv_fmt", ["mxsf", ""])
def test_init_cache_without_a_device_takes_the_card(cfg, monkeypatch, kv_fmt):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_cache(cfg, 1, 8, kv_fmt=kv_fmt)
    cache = TM.init_cache(cfg, 1, 8, kv_fmt=kv_fmt, device="cpu")
    assert {t.device.type for t in cache.values()} == {"cpu"}
