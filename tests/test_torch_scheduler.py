"""PyTorch port, the continuous-batching SessionScheduler on tiny-llama
(paged pool, page 32, f32), with the JAX engine's weights bridged into the
port's engines. Sessions that join while another is mid-decode are served
through ragged mixed dispatches (K3's plain version on the CPU); their
greedy tokens must equal the JAX engine's direct generate_batch."""

import threading
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
from theroundtaible_tpu.engine.models.registry import \
    get_model_config as jax_config
from theroundtaible_tpu.engine.sampling import SamplingParams as JaxSampling
from theroundtaible_tpu_torch.adapters.base import KnightTurn
from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
from theroundtaible_tpu_torch.engine.engine import InferenceEngine
from theroundtaible_tpu_torch.engine.kvcache import SESSION_SEP
from theroundtaible_tpu_torch.engine.models.registry import \
    get_model_config as torch_config
from theroundtaible_tpu_torch.engine.sampling import SamplingParams
from theroundtaible_tpu_torch.engine.scheduler import (SchedulerRefused,
                                                       SessionScheduler,
                                                       max_rows_seen,
                                                       reset_test_counters,
                                                       scheduler_for)
from theroundtaible_tpu_torch.engine.weights import params_from_numpy

MAX_SEQ = 512
MAX_NEW = 70   # past one 64-token segment, so later sessions join mid-decode
OFF = dict(prefix_cache=False, kv_offload=False, ragged_attn=False,
           spec_decode=False)
PROMPTS = {   # tests/test_ragged_attn.py
    "s0": [("lancelot", "The round table met at dawn to discuss the "
                        "castle walls and the eastern gate.")],
    "s1": [("galahad", "A different discussion entirely, about dragons "
                       "and the kingdom's gold reserves."),
           ("percival", "A different discussion entirely, about dragons "
                        "and the kingdom's gold reserves. Percival "
                        "counts the coins.")],
    "s2": [("tristan", "Third topic: the harvest festival planning "
                       "session and the tournament.")],
}


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_engine():
    return JaxEngine(jax_config("tiny-llama", max_seq_len=MAX_SEQ),
                     mesh_shape={"data": 1, "model": 1}, num_slots=8,
                     kv_layout="paged", page_size=32, dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0,
                                          max_new_tokens=8), **OFF)


@pytest.fixture(scope="module")
def direct(jax_engine):
    """The JAX engine's direct generate_batch of every session."""
    return {sid: jax_engine.generate_batch(turns, max_new_tokens=MAX_NEW,
                                           session=sid)
            for sid, turns in PROMPTS.items()}


def make_engine(jax_engine, **kw):
    cfg = torch_config("tiny-llama", max_seq_len=MAX_SEQ)
    kw.setdefault("num_slots", 8)
    eng = InferenceEngine(
        cfg, kv_layout="paged", page_size=32, dtype=torch.float32,
        sampling=SamplingParams(temperature=0.0, max_new_tokens=8),
        params=params_from_numpy(jax.device_get(jax_engine.params), cfg,
                                 torch.float32, "cpu"),
        device="cpu", **kw)
    # Tiny prompts would resolve back to the prologue under the default
    # deferral threshold: defer every join.
    eng.ragged_defer_min = 1
    return eng


def join_mid_decode(sched, sessions, max_new=MAX_NEW):
    """Submit `sessions` so every later one joins while the first is
    mid-decode: each waits for live rows before submitting. Returns
    ({sid: (texts, stats)}, {sid: error})."""
    results, errors = {}, {}

    def run(sid, wait_active):
        try:
            if wait_active:
                deadline = time.monotonic() + 60
                while not sched._active and time.monotonic() < deadline:
                    time.sleep(0.002)
            results[sid] = sched.submit(sid, PROMPTS[sid],
                                        max_new_tokens=max_new)
        except Exception as e:  # noqa: BLE001 - asserted by callers
            errors[sid] = e

    threads = [threading.Thread(target=run, args=(sid, i > 0))
               for i, sid in enumerate(sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    return results, errors


@pytest.mark.parametrize("ragged", [True, False])
def test_join_mid_decode_matches_jax_generate_batch(jax_engine, direct,
                                                    ragged):
    """Sessions joining mid-decode get the JAX engine's direct greedy
    tokens: through ragged mixed dispatches with the seam on, through the
    blocking prologue with it off (zero ragged dispatches)."""
    eng = make_engine(jax_engine, ragged_attn=None if ragged else False)
    sched = SessionScheduler(eng)
    reset_test_counters()
    try:
        results, errors = join_mid_decode(sched, list(PROMPTS))
        assert not errors, errors
        for sid in PROMPTS:
            texts, stats = results[sid]
            assert texts == direct[sid], f"{sid} diverged"
            assert stats.sched["ttft_s"] is not None
        d = sched.describe()
        assert d["completed"] == 3 and d["failed"] == 0
        assert d["max_occupancy"] >= 2 and max_rows_seen() >= 2
        rag = eng.ragged_describe()
        if ragged:
            assert d["ragged_joins"] >= 1 and d["ragged_segments"] >= 1
            assert d["segment_prefill_tokens"] > 0
            assert rag["dispatches"].get("plain_ragged", 0) >= 1
            assert all(e["path"] == "plain_ragged" for e in rag["recent"])
        else:
            assert rag["reason"] == "disabled:config/env"
            assert d["ragged_joins"] == 0 and d["ragged_segments"] == 0
            assert rag["dispatches"] == {}
        assert eng.describe()["scheduler"]["completed"] == 3
    finally:
        sched.close()


def test_next_round_reuses_committed_prefix(jax_engine):
    """Round 2 extends round 1's transcript: retirement commits each slot
    for reuse_plan exactly like generate_batch, so round 2 prefills only
    its delta."""
    eng = make_engine(jax_engine)
    sched = scheduler_for(eng)
    try:
        assert scheduler_for(eng) is sched
        texts, _ = sched.submit("s0", PROMPTS["s0"], max_new_tokens=8)
        round2 = [(name, prompt + " " + texts[0] + " The discussion "
                   "continues into a second round.")
                  for name, prompt in PROMPTS["s0"]]
        _texts, stats = sched.submit("s0", round2, max_new_tokens=8)
        assert stats.reused_tokens > len(PROMPTS["s0"][0][1])
    finally:
        sched.close()


def test_refuses_what_never_fits(jax_engine):
    eng = make_engine(jax_engine, num_slots=4)
    sched = SessionScheduler(eng)
    try:
        with pytest.raises(SchedulerRefused) as err:
            sched.submit("big", [(f"k{i}", "prompt") for i in range(5)],
                         max_new_tokens=8)
        assert err.value.reason == "rows_never_fit"
        assert sched.describe()["refused"] == 1
    finally:
        sched.close()


def test_backpressure_queues_then_serves(jax_engine, direct):
    """With room for two rows, a second 2-knight session queues behind the
    first, then completes after retirement with the direct tokens."""
    eng = make_engine(jax_engine)
    sched = SessionScheduler(eng, max_rows=2, admit_hold_s=0.05)
    try:
        a = sched.submit_async("s1", PROMPTS["s1"], max_new_tokens=MAX_NEW)
        b = sched.submit_async("s0", PROMPTS["s0"], max_new_tokens=MAX_NEW)
        c = sched.submit_async("s2", PROMPTS["s2"], max_new_tokens=MAX_NEW)
        outs = {sid: sched.wait(r) for sid, r in
                (("s1", a), ("s0", b), ("s2", c))}
        for sid, (texts, _stats) in outs.items():
            assert texts == direct[sid], sid
        d = sched.describe()
        assert d["completed"] == 3 and d["max_occupancy"] <= 2
        assert max(o[1].sched["queue_wait_s"] for o in outs.values()) > 0
        assert any(e["event"] == "queue_wait" for e in d["events"])
    finally:
        sched.close()


def test_dispatch_failure_fails_only_its_session(jax_engine, direct,
                                                 monkeypatch):
    """A decode dispatch that fails whenever it carries a row of session
    s1 preempts the batch into per-session dispatches: s1 fails alone and
    the other sessions' tokens stay byte-identical."""
    eng = make_engine(jax_engine)
    real = eng._decode_dispatch_paged
    sick = f"s1{SESSION_SEP}"

    def failing(table, *args, **kwargs):
        pages = {slot.pages[0] for name, slot in eng.kv._slots.items()
                 if name.startswith(sick) and slot.pages}
        if pages & set(table[:, 0].tolist()):
            raise RuntimeError("injected device fault")
        return real(table, *args, **kwargs)

    monkeypatch.setattr(eng, "_decode_dispatch_paged", failing)
    sched = SessionScheduler(eng)
    try:
        results, errors = join_mid_decode(sched, ["s0", "s1", "s2"])
        assert set(errors) == {"s1"}
        assert "injected" in str(errors["s1"])
        for sid in ("s0", "s2"):
            assert results[sid][0] == direct[sid], sid
        d = sched.describe()
        assert d["preemptions"] >= 1
        assert d["failed"] == 1 and d["completed"] == 2
        assert not any(n.startswith(sick) for n in eng.kv.slot_names())
    finally:
        sched.close()


def test_adapter_rounds_go_through_the_scheduler(jax_engine):
    """attach_scheduler routes execute_round through scheduler.submit
    under the adapter's session namespace."""
    eng = make_engine(jax_engine)
    sched = SessionScheduler(eng)
    adapter = TorchLlmAdapter("torch-llm", {"model": "tiny-llama"},
                              device="cpu")
    adapter._engine = eng
    calls = []
    submit = sched.submit

    def spy(session, turns, **kwargs):
        calls.append(session)
        return submit(session, turns, **kwargs)

    sched.submit = spy
    try:
        adapter.attach_scheduler(sched, session="s1")
        turns = [KnightTurn(knight_name=n, prompt=p)
                 for n, p in PROMPTS["s1"]]
        out = adapter.execute_round(turns, timeout_ms=120_000)
        assert calls == ["s1"]
        # max_new_tokens follows the engine default (8)
        assert out == jax_engine.generate_batch(
            PROMPTS["s1"], max_new_tokens=8, session="adapter-baseline")
        assert adapter._slot_name("galahad") == f"s1{SESSION_SEP}galahad"
        assert sched.describe()["completed"] == 1
    finally:
        sched.close()


def test_unported_scheduler_options_raise(jax_engine):
    eng = make_engine(jax_engine, num_slots=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SessionScheduler(eng, idle_spill_s=1.0)
    sched = SessionScheduler(eng)
    try:
        # LoRA personas are ported: an engine without a `lora:` store
        # serves the base model and ignores adapters_per_turn, as the JAX
        # scheduler does (tests/test_torch_lora.py covers a LoRA engine).
        texts, _ = sched.submit("s", [("a", "hi")],
                                adapters_per_turn=["persona"])
        assert texts == sched.submit("s2", [("a", "hi")])[0]
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sched.submit_async("s", [("a", "hi")], on_commit=print)
    finally:
        sched.close()
