"""PyTorch port, engine: the port's InferenceEngine against the JAX
package's on tiny-llama, paged pool (page_size 32), f32, with the JAX
engine's weights bridged into the port. The JAX engine serves
pool-direct through its Pallas kernels in interpret mode, with the
features the port has not ported switched off. Greedy tokens (the token
records each slot commits) and reused-token counts must be identical."""

import jax
import jax.numpy as jnp
import pytest
import torch

from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
from theroundtaible_tpu.engine.models.registry import \
    get_model_config as jax_config
from theroundtaible_tpu.engine.sampling import SamplingParams as JaxSampling
from theroundtaible_tpu_torch.engine import serving_loop
from theroundtaible_tpu_torch.engine.engine import InferenceEngine
from theroundtaible_tpu_torch.engine.models.registry import \
    get_model_config as torch_config
from theroundtaible_tpu_torch.engine.sampling import SamplingParams
from theroundtaible_tpu_torch.engine.weights import params_from_numpy

OFF = dict(prefix_cache=False, kv_offload=False, ragged_attn=False,
           spec_decode=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine(jax_config("tiny-llama", max_seq_len=256),
                     mesh_shape={"data": 1, "model": 1}, num_slots=4,
                     kv_layout="paged", page_size=32, dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0,
                                          max_new_tokens=8), **OFF)
    assert jeng.paged_direct
    cfg = torch_config("tiny-llama", max_seq_len=256)
    teng = InferenceEngine(
        cfg, num_slots=4, kv_layout="paged", page_size=32,
        dtype=torch.float32,
        sampling=SamplingParams(temperature=0.0, max_new_tokens=8),
        params=params_from_numpy(jax.device_get(jeng.params), cfg,
                                 torch.float32, "cpu"),
        device="cpu")
    return jeng, teng


def _records(eng, names):
    return {n: list(eng.kv._slots[n].tokens) for n in names}


def test_generate_parity(engines):
    jeng, teng = engines
    p = "the knights debate the session store design at length"
    outs = [e.generate(p, slot_name="a", max_new_tokens=8)
            for e in (jeng, teng)]
    assert outs[0] == outs[1]
    assert _records(jeng, ["a"]) == _records(teng, ["a"])
    # the record holds the prompt plus every fed generated token
    assert len(teng.kv._slots["a"].tokens) > len(p)


def test_multiturn_delta_prefill_parity(engines):
    jeng, teng = engines
    base = "round one establishes the shared context for everyone here."
    ext = base + " round two adds new arguments and asks for a score."
    outs = []
    for eng in (jeng, teng):
        eng.generate(base, slot_name="k", max_new_tokens=8)
        outs.append(eng.generate(ext, slot_name="k", max_new_tokens=8))
        assert eng.last_stats.reused_tokens > 0
    assert outs[0] == outs[1]
    assert jeng.last_stats.reused_tokens == teng.last_stats.reused_tokens
    assert _records(jeng, ["k"]) == _records(teng, ["k"])


def test_batch_with_shared_prefix_parity(engines):
    jeng, teng = engines
    shared = ("the common context paragraph that every knight receives "
              "before their personal instructions begin here. ")
    prompts = [(f"kn{i}", shared + f"You are knight {i}.")
               for i in range(3)]
    out_j, stats_j = jeng.generate_batch_with_stats(prompts,
                                                    max_new_tokens=8)
    out_t, stats_t = teng.generate_batch_with_stats(prompts,
                                                    max_new_tokens=8)
    assert out_j == out_t
    names = [n for n, _ in prompts]
    assert _records(jeng, names) == _records(teng, names)
    # the leader prefilled the common span once; the others aliased it
    assert stats_t.reused_tokens > 0
    assert stats_t.reused_tokens == stats_j.reused_tokens
    assert stats_t.prefill_tokens == stats_j.prefill_tokens


def test_describe_keys_match(engines):
    jeng, teng = engines
    dj, dt = jeng.describe(), teng.describe()
    for key in ("model", "params", "max_seq_len", "num_slots", "kv_layout",
                "paged_decode", "page_size", "num_pages", "kv_hbm_bytes"):
        assert dt[key] == dj[key], key
    # the prefix cache and the offload tier are ported and on by default
    # on a paged engine: the JAX blocks' keys (the JAX engine here has
    # both off, so its classes give them)
    from theroundtaible_tpu.engine.kv_offload import HostOffloadTier
    from theroundtaible_tpu.engine.prefix_cache import PrefixCache
    assert set(dt["prefix_cache"]) == set(PrefixCache(jeng.kv).describe())
    assert set(dt["kv_offload"]) == set(HostOffloadTier(jeng).describe())
    assert not any(k.endswith("_reason") and v == "not_ported"
                   for k, v in dt.items())
    # speculative decoding is ported: the JAX engine's provenance block,
    # on by default on the port's paged pool with the ragged seam
    assert set(dt["spec_decode"]) == set(jeng.spec_describe())
    assert dt["spec_decode"]["enabled"] is True
    assert dt["spec_decode"]["reason"] is None
    # the ragged seam is ported: the same provenance block as JAX's
    assert set(dt["ragged"]) == set(jeng.ragged_describe())
    assert dt["ragged"]["enabled"] is True
    assert dt["ragged"]["path"] == "plain_ragged"
    assert dt["ragged"]["tokens_budget"] == 1024


@pytest.mark.parametrize("key,value", [
    # a data axis on the contiguous layout (the default here) and a "pipe"
    # axis are served since Queue 1 slices 2a and 3: without a process
    # group the data axis raises RuntimeError, and InferenceEngine refuses
    # a pipe mesh, which get_engine builds a PPEngine for
    # (tests/test_torch_data_axis.py, tests/test_torch_pp_serving.py); a
    # "seq" mesh key and seq_parallel are served since slice 4 and are
    # held against the JAX engine below
    ("mesh", {"data": 2, "model": 2}), ("mesh", {"pipe": 2}),
    ("mesh", {"seq": 2}), ("seq_parallel", 2),
    # devices beyond one card (a single index selects cuda:<i>; here the
    # caller asked for the CPU) and a DCN axis
    ("devices", [1]), ("devices", [0, 1]), ("dcn_axis", "data"),
])
def test_unported_options_raise(key, value):
    config = {"model": "tiny-llama", "max_seq_len": 128, key: value}
    if key == "seq_parallel" or value == {"seq": 2}:
        _served_as_jax(config, key)
        return
    if value == {"data": 2, "model": 2}:
        raises = pytest.raises(RuntimeError,
                               match="initialized torch.distributed")
    elif value == {"pipe": 2}:
        raises = pytest.raises(ValueError, match="PPEngine.*get_engine")
    else:
        raises = pytest.raises(NotImplementedError, match="ROADMAP")
    with raises:
        InferenceEngine.from_config(config, device="cpu")


def _served_as_jax(config, key):
    """`seq_parallel: 2` builds the ring over the engine's devices in both
    packages (one device here: width 1, JAX's one-device seq mesh), and a
    "seq" mesh key is ignored as JAX's build_mesh ignores it: each
    package's engine for {"seq": 2} has the mesh it has without the key."""
    from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
    bare = {k: v for k, v in config.items() if k != key}
    if key == "seq_parallel":
        jeng = JaxEngine.from_config({**config, "mesh": {"data": 1,
                                                         "model": 1}})
        teng = InferenceEngine.from_config(config, device="cpu")
        assert teng.seq_ring.size == jeng.seq_mesh.shape["seq"] == 1
        assert teng.long_threshold == jeng.long_threshold == 2048
        return
    jax_mesh = JaxEngine.from_config(config).describe()["mesh"]
    assert jax_mesh == JaxEngine.from_config(bare).describe()["mesh"]
    got = InferenceEngine.from_config(config, device="cpu").describe()
    want = InferenceEngine.from_config(bare, device="cpu").describe()
    assert got["mesh"] == want["mesh"] == {"data": 1, "model": 1}


@pytest.mark.parametrize("key,value", [("dtype", "float16"),
                                       ("model", "tiny-mixtral")])
def test_float16_and_moe_build_and_serve(key, value):
    """`"dtype": "float16"` and a MoE model raised until item 7e-i was
    ported: both build through from_config and serve a greedy round
    (tests/test_torch_float16.py and tests/test_torch_moe.py hold them
    against the JAX engine)."""
    config = {"model": "tiny-llama", "max_seq_len": 128,
              "sampling": {"temperature": 0.0}, key: value}
    eng = InferenceEngine.from_config(config, device="cpu")
    texts = eng.generate_batch([("a", "the round table meets")],
                               max_new_tokens=4)
    assert len(texts) == 1
    if key == "dtype":
        assert eng.dtype == torch.float16
    else:
        assert "experts" in eng.params["layers"][0]


@pytest.mark.parametrize("key", ["prefix_cache", "kv_offload"])
def test_cache_and_offload_true_build_and_serve(key):
    """`prefix_cache: true` and `kv_offload: true` are served
    (tests/test_torch_prefix_cache.py, tests/test_torch_kv_offload.py): a
    paged engine builds the feature with the JAX engine's describe() block
    and serves with it - a second session attaching the first one's pages,
    or a spilled session resuming with its transcript reused."""
    config = {"model": "tiny-llama", "max_seq_len": 256,
              "kv_layout": "paged", "page_size": 32, "dtype": "float32",
              "sampling": {"temperature": 0.0, "max_new_tokens": 8},
              "spec_decode": False, key: True}
    eng = InferenceEngine.from_config(config, device="cpu")
    prompt = "The knights weigh the journal format at length. " * 3
    first = eng.generate(prompt, session="a", slot_name="kay")
    if key == "prefix_cache":
        eng.generate(prompt + "More.", session="b", slot_name="kay")
        assert eng.describe()["prefix_cache"]["hits"] == 1
        assert eng.last_stats.prefix_reused_tokens > 0
    else:
        assert eng.kv_offload.spill_session("a") == 1
        assert eng.generate(prompt, session="a", slot_name="kay") == first
        assert eng.last_stats.reused_tokens == len(prompt)
        assert eng.describe()["kv_offload"]["restores"] == 1


def test_spec_decode_true_builds_a_speculating_engine():
    """`spec_decode: true` is served (tests/test_torch_spec_decode.py): a
    paged engine builds speculation on, with the JAX engine's provenance
    at construction, `spec_max_draft` carried through from_config."""
    config = {"model": "tiny-llama", "max_seq_len": 128,
              "kv_layout": "paged", "page_size": 32, "spec_decode": True,
              "spec_max_draft": 3}
    jd = JaxEngine.from_config(dict(
        config, mesh={"data": 1, "model": 1}, prefix_cache=False,
        kv_offload=False)).spec_describe()
    td = InferenceEngine.from_config(config, device="cpu").spec_describe()
    assert td == jd
    assert td["enabled"] is True and td["max_draft"] == 3


def test_checkpoint_without_weights_raises_naming_the_dir(tmp_path):
    """`checkpoint` is served (tests/test_torch_checkpoint.py); a
    directory holding no weights fails construction, naming it."""
    config = {"model": "tiny-llama", "max_seq_len": 128,
              "checkpoint": str(tmp_path)}
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        InferenceEngine.from_config(config, device="cpu")


def test_from_config_defaults_to_contiguous():
    """No kv_layout key: the contiguous KVCache, as the JAX engine
    builds (tests/test_torch_contiguous.py compares the describe()s)."""
    eng = InferenceEngine.from_config(
        {"model": "tiny-llama", "max_seq_len": 128,
         "mesh": {"data": 1, "model": 1}, "prefix_cache": False},
        device="cpu")
    assert eng.kv_layout == "contiguous"
    assert eng.kv.layers[0][0].shape == (8, 128, 2, 16)
    assert not eng.ragged_enabled
    assert eng.warmup() > 0.0
    assert eng.kv.slot_names() == []


def test_from_config_paged_gives_the_pool():
    eng = InferenceEngine.from_config(
        {"model": "tiny-llama", "max_seq_len": 128, "kv_layout": "paged",
         "page_size": 32, "mesh": {"data": 1, "model": 1},
         "prefix_cache": False},
        device="cpu")
    assert eng.kv_layout == "paged" and eng.kv.page_size == 32
    assert eng.ragged_enabled
    assert eng.warmup() > 0.0
    assert eng.kv.slot_names() == []


def test_prefill_bucket_shrinks_at_the_cache_end():
    """No chunk ever writes past max_seq_len: near the end the bucket
    shrinks (so forward_paged's page lookup never leaves the table and
    forward_cached's in-place write never leaves the slot)."""
    widths = []

    def dispatch(chunk, offs, lengths):
        widths.append((chunk.shape[1], list(offs)))
        assert max(offs) + chunk.shape[1] <= 128
        return torch.zeros(chunk.shape[0], 4)

    serving_loop.chunked_prefill(dispatch, [[5] * 90, [6] * 10], [30, 100],
                                 128, 0)
    # 28 = the room left behind the longest row, not the 128 bucket
    assert widths[0] == (28, [30, 100])
    assert widths[1] == (18, [58, 110])


def test_tokenizers_match_jax(tmp_path):
    from conftest import save_trained_tokenizer

    from theroundtaible_tpu.engine import tokenizer as jtok
    from theroundtaible_tpu_torch.engine import tokenizer as ttok
    text = "Lancelot: the journal – snapshots every 100 turns ✓"
    jb, tb = jtok.load_tokenizer(None), ttok.load_tokenizer(None)
    assert type(tb).__name__ == "ByteTokenizer"
    assert tb.encode(text) == jb.encode(text)
    assert tb.decode(tb.encode(text)[1:]) == text
    save_trained_tokenizer(str(tmp_path))
    jh, th = (jtok.load_tokenizer(str(tmp_path)),
              ttok.load_tokenizer(str(tmp_path)))
    assert type(th).__name__ == "HfTokenizer"
    assert th.encode(text) == jh.encode(text)
    assert (th.bos_id, th.eos_id, th.pad_id, th.vocab_size) == \
        (jh.bos_id, jh.eos_id, jh.pad_id, jh.vocab_size)
    assert th.decode(th.encode(text)) == jh.decode(jh.encode(text))


def test_drain_gate_refuses_new_turns(engines):
    from theroundtaible_tpu_torch.engine import deadlines
    _, teng = engines
    deadlines.begin_drain()
    try:
        with pytest.raises(deadlines.DrainingError):
            teng.generate("hello", slot_name="drained")
    finally:
        deadlines.end_drain()
    assert "drained" not in teng.kv.slot_names()


def test_watchdog_abandons_a_hung_dispatch():
    """Armed, a dispatch that outlives its budget raises HangDetected
    (classified `hang`, not retried), and the abandoned dispatch's late
    commit is refused with StaleWait."""
    import threading
    import time

    from theroundtaible_tpu_torch.core.errors import classify_error
    from theroundtaible_tpu_torch.engine import deadlines, faults
    release, late = threading.Event(), []

    def hung():
        release.wait(5)
        try:
            with deadlines.commit_guard():
                late.append("committed")
        except deadlines.StaleWait:
            late.append("refused")

    deadlines.arm_watchdog()
    try:
        budget = deadlines.Budget.root(0.2, rung="turn")
        t0 = time.monotonic()
        with pytest.raises(deadlines.HangDetected) as err:
            serving_loop.run_dispatch(hung, faults.RetryPolicy(),
                                      budget=budget)
        assert time.monotonic() - t0 < 2.0
        assert classify_error(err.value) == "hang"
        release.set()
        for _ in range(100):
            if late:
                break
            time.sleep(0.02)
        assert late == ["refused"]
    finally:
        deadlines.disarm_watchdog()


def test_retry_policy_retries_only_transient_failures():
    from theroundtaible_tpu_torch.engine.faults import RetryPolicy
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("transient dispatch error")
        return "ok"

    assert RetryPolicy(backoff_s=0.0).run(flaky) == "ok" and len(calls) == 2
    with pytest.raises(RuntimeError):
        RetryPolicy(backoff_s=0.0).run(
            lambda: (_ for _ in ()).throw(RuntimeError("CUDA out of memory")))


def test_sampled_decode_is_seeded_and_in_vocab():
    """Sampled rows draw from the engine's torch.Generator (seeded from
    `seed`): the same seed repeats the same tokens, another seed differs,
    and a greedy row beside sampled ones stays greedy."""
    cfg = torch_config("tiny-llama", max_seq_len=256)

    def run(seed):
        eng = InferenceEngine(cfg, num_slots=4, page_size=32,
                              dtype=torch.float32, seed=seed, device="cpu")
        hot = SamplingParams(temperature=1.0, top_k=50, top_p=0.9,
                             max_new_tokens=12)
        cold = SamplingParams(temperature=0.0, max_new_tokens=12)
        eng.generate_batch_with_stats(
            [("a", "sampled knight"), ("b", "greedy knight")],
            max_new_tokens=12, sampling_per_turn=[hot, cold])
        return [eng.kv._slots[n].tokens for n in ("a", "b")]

    first, again, other = run(0), run(0), run(1)
    assert first == again
    assert first[0] != other[0]
    assert all(0 <= t < cfg.vocab_size for t in first[0])
    alone = InferenceEngine(cfg, num_slots=4, page_size=32,
                            dtype=torch.float32, seed=0, device="cpu")
    alone.generate("greedy knight", slot_name="b", max_new_tokens=12)
    assert alone.kv._slots["b"].tokens == first[1]
