"""PyTorch port, adapter: 3 knights x 2 rounds through execute_round on the
JAX package's tpu-llm adapter and the port's torch-llm adapter, from the
same adapter config, with the JAX engine's weights bridged into the port's
engine. Greedy transcripts and per-knight slot records must be identical,
and round 2 must reuse every knight's slot."""

import jax
import pytest
import torch

from theroundtaible_tpu import engine as jax_engine_mod
from theroundtaible_tpu.adapters.base import KnightTurn as JaxTurn
from theroundtaible_tpu.adapters.tpu_llm import TpuLlmAdapter
from theroundtaible_tpu_torch import engine as torch_engine_mod
from theroundtaible_tpu_torch.adapters.base import KnightTurn
from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
from theroundtaible_tpu_torch.core.errors import AdapterError
from theroundtaible_tpu_torch.engine.weights import params_from_numpy

CONFIG = {
    "model": "tiny-llama", "max_seq_len": 512, "num_slots": 4,
    "mesh": {"data": 1, "model": 1}, "dtype": "float32",
    "kv_layout": "paged", "page_size": 32, "num_pages": 48, "seed": 3,
    "sampling": {"temperature": 0.0, "max_new_tokens": 8},
    "prefix_cache": False, "kv_offload": False, "ragged_attn": False,
    "spec_decode": False,
}
KNIGHTS = ("lancelot", "gawain", "percival")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def adapters():
    jax_engine_mod.reset_engines()
    torch_engine_mod.reset_engines()
    jad = TpuLlmAdapter.from_config("tpu-llm", dict(CONFIG))
    tad = TorchLlmAdapter.from_config("torch-llm", dict(CONFIG),
                                      device="cpu")
    jeng = jad._get_engine()
    teng = tad._get_engine()
    teng.params = params_from_numpy(jax.device_get(jeng.params), teng.cfg,
                                    torch.float32, "cpu")
    yield jad, tad
    jax_engine_mod.reset_engines()
    torch_engine_mod.reset_engines()


def test_two_rounds_match_jax(adapters):
    jad, tad = adapters
    context = ("The round table reviews the session store design: a "
               "write-ahead journal, snapshots every hundred turns. ")
    prompts = {k: context + f"Knight {k}, give your verdict."
               for k in KNIGHTS}
    transcripts = {"jax": [], "torch": []}
    stats = {"jax": [], "torch": []}
    for rnd in range(2):
        for tag, ad, turn in (("jax", jad, JaxTurn), ("torch", tad,
                                                      KnightTurn)):
            turns = [turn(knight_name=k, prompt=prompts[k])
                     for k in KNIGHTS]
            transcripts[tag].append(ad.execute_round(turns,
                                                     timeout_ms=120_000))
            stats[tag].append(ad.last_stats())
        prompts = {k: prompts[k] + transcripts["jax"][-1][i]
                   + f" Round two: {k}, answer the critique."
                   for i, k in enumerate(KNIGHTS)}
    assert transcripts["jax"] == transcripts["torch"]
    jeng, teng = jad._get_engine(), tad._get_engine()
    for k in KNIGHTS:
        assert jeng.kv._slots[k].tokens == teng.kv._slots[k].tokens
    for key in ("prefill_tokens", "reused_tokens", "decode_tokens"):
        assert [s[key] for s in stats["jax"]] == \
            [s[key] for s in stats["torch"]], key
    # round 2 reuses each knight's own slot: at least every round-1
    # prompt's tokens come back from the cache
    round1 = sum(len(teng.tokenizer.encode(context + f"Knight {k}, give "
                                            "your verdict."))
                 for k in KNIGHTS)
    assert stats["torch"][1]["reused_tokens"] >= round1
    assert tad.last_degradation is None


def test_breaker_opens_on_construction_failure():
    torch_engine_mod.reset_engines()
    bad = dict(CONFIG, spec_decode=True)
    ad = TorchLlmAdapter.from_config("torch-llm", bad, device="cpu")
    assert not ad.is_available()
    assert "not ported" in ad.unavailable_reason()
    with pytest.raises(AdapterError):
        ad.execute_round([KnightTurn("a", "hi")])
    torch_engine_mod.reset_engines()
