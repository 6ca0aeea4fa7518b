"""PyTorch port, device defaults: every public function that allocates runs
on the card unless the caller asks for the CPU, and without a card it
raises instead of falling back (engine/device.resolve_device), as
engine/distributed.launch does (tests/test_torch_tp.py). On a card these
skip: tests/test_torch_cuda.py holds the card's side."""

import pytest
import torch

from theroundtaible_tpu_torch.engine import kvcache, paging, sampling
from theroundtaible_tpu_torch.engine import serving_loop, weights
from theroundtaible_tpu_torch.engine.models import common
from theroundtaible_tpu_torch.engine.models.registry import get_model_config


def _tiny():
    return get_model_config("tiny-llama")


def _kv_cache(**kw):
    return kvcache.KVCache(_tiny(), 2, 64, torch.float32, **kw)


def _paged_cache(**kw):
    return paging.PagedKVCache(_tiny(), 2, 64, torch.float32, page_size=32,
                               **kw)


def _sampling(**kw):
    return sampling.sampling_arrays([sampling.SamplingParams()] * 2, **kw)


def _row_budget(**kw):
    return serving_loop.row_budget_fn([None, None], None, 8, **kw)


def _init(**kw):
    return common.init_params(_tiny(), torch.Generator().manual_seed(0),
                              torch.float32, **kw)


def _from_numpy(**kw):
    cfg = _tiny()
    tree = common.init_params(cfg, torch.Generator().manual_seed(0),
                              torch.float32, device="cpu")
    as_np = {"embedding": tree["embedding"].numpy(),
             "final_norm": tree["final_norm"].numpy(),
             "layers": [{k: v.numpy() for k, v in layer.items()}
                        for layer in tree["layers"]]}
    if "lm_head" in tree:
        as_np["lm_head"] = tree["lm_head"].numpy()
    return weights.params_from_numpy(as_np, cfg, torch.float32, **kw)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if callable(x):
        return _tensors(x(4))
    if isinstance(x, (kvcache.KVCache, paging.PagedKVCache)):
        return _tensors(getattr(x, "layers", None) or x.pools)
    return []


ALLOCATORS = {"KVCache": _kv_cache, "PagedKVCache": _paged_cache,
              "sampling_arrays": _sampling, "row_budget_fn": _row_budget,
              "init_params": _init, "params_from_numpy": _from_numpy}


@pytest.mark.parametrize("name", sorted(ALLOCATORS))
def test_allocators_default_to_the_card(name):
    """Without device= each asks for the card and, with none, raises the
    resolve_device error before allocating; device="cpu" gives CPU
    tensors."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the "
                    "default there")
    make = ALLOCATORS[name]
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        make()
    made = _tensors(make(device="cpu"))
    assert made and all(t.device.type == "cpu" for t in made)
