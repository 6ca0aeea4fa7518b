"""PyTorch port, the host-RAM KV offload tier (engine/kv_offload.py) and
the scheduler's spill policy against the JAX package's
(tests/test_prefix_cache.py's TestHostOffload).

tiny-llama, paged, page 32, f32, the JAX engine's weights (seed 0) bridged
into the port. A spilled session resumes at its next turn with no
re-prefill and the JAX engine's tokens; restored pages are bit-identical to
the spilled ones on bf16, int8 and int4 pools (payload and scales); pages
aliased between a session's own knights spill once and restore into one
shared page; a stale record never leaks pages; evacuate() moves kept pages
to host RAM, alone or for a subset; the scheduler spills idle sessions by
age and under page pressure instead of letting the allocator evict them.
Like JAX's tests these isolate the tier (prefix cache off) except the
round trip, which runs both and asserts its attach hits.

JAX's compile-count test (tests/test_prefix_cache.py:510) has no
counterpart: the port's spill and restore compile nothing."""

import time

import jax
import jax.numpy as jnp
import pytest
import torch

from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
from theroundtaible_tpu.engine.models.registry import \
    get_model_config as jax_config
from theroundtaible_tpu.engine.sampling import SamplingParams as JaxSampling
from theroundtaible_tpu_torch.engine.engine import InferenceEngine
from theroundtaible_tpu_torch.engine.kvcache import scoped_slot
from theroundtaible_tpu_torch.engine.models.registry import \
    get_model_config as torch_config
from theroundtaible_tpu_torch.engine.sampling import SamplingParams
from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
from theroundtaible_tpu_torch.engine.weights import params_from_numpy

MESH1 = {"data": 1, "model": 1}
MAX_SEQ = 512
PS = 32
MAX_NEW = 24
PREAMBLE = ("The round table convened at dawn. The rules of order are "
            "strict: every knight states a proposal, scores consensus "
            "from one to ten, and names the open points that remain. "
            "Honor the order of speech and keep the record true. ")
NO_CACHE = dict(prefix_cache=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_engine(**kw):
    return JaxEngine(jax_config("tiny-llama", max_seq_len=MAX_SEQ),
                     mesh_shape=MESH1, num_slots=8, kv_layout="paged",
                     page_size=PS, dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0,
                                          max_new_tokens=MAX_NEW),
                     ragged_attn=False, spec_decode=False, **kw)


def _port_engine(params, dtype=torch.float32, **kw):
    cfg = torch_config("tiny-llama", max_seq_len=MAX_SEQ)
    kw.setdefault("ragged_attn", False)
    kw.setdefault("num_slots", 8)
    return InferenceEngine(
        cfg, kv_layout="paged", page_size=PS, dtype=dtype,
        sampling=SamplingParams(temperature=0.0, max_new_tokens=MAX_NEW),
        params=params_from_numpy(params, cfg, dtype, "cpu"),
        device="cpu", spec_decode=False, **kw)


@pytest.fixture(scope="module")
def weights():
    return jax.device_get(_jax_engine(prefix_cache=False,
                                      kv_offload=False).params)


def _round_trip(eng, name, sid, p1, p2):
    """Serve p1, spill the session, serve p2 (restored inside
    _prepare_batch): (outputs, p2's prefill tokens, p2's reused tokens,
    pages in use before and after the spill)."""
    a1 = eng.generate(p1, slot_name=name)
    before = eng.kv.pages_in_use()
    assert eng.kv_offload.spill_session(sid) == 1
    after = eng.kv.pages_in_use()
    assert name not in eng.kv.slot_names() and eng.kv_offload.has(sid)
    out, st = eng.generate_batch_with_stats([(name, p2)])
    assert not eng.kv_offload.has(sid)
    return [a1, out[0]], st.prefill_tokens, st.reused_tokens, before, after


def test_spill_restore_round_trip_matches_jax(weights):
    """An idle session spilled to host RAM resumes at its next turn with
    the prefill of a never-spilled twin (the JAX engine with the tier off)
    and the JAX engine's tokens and counts; with the prefix cache on too,
    a second session still attaches the spilled session's index pages."""
    sid, name = "off0", scoped_slot("off0", "lancelot")
    p1 = PREAMBLE + "Lancelot surveys the outer wall at length."
    p2 = p1 + " He returns at dusk with the mason's tally."
    teng = _port_engine(weights)
    jeng = _jax_engine()
    ref = _jax_engine(prefix_cache=False, kv_offload=False)
    mine = _round_trip(teng, name, sid, p1, p2)
    theirs = _round_trip(jeng, name, sid, p1, p2)
    assert mine == theirs
    # the index still holds the session's complete pages: they stay
    assert mine[3] >= mine[4] > 0
    r1 = ref.generate(p1, slot_name=name)
    _, rst = ref.generate_batch_with_stats([(name, p2)])
    assert mine[0][0] == r1 and mine[1] == rst.prefill_tokens
    assert teng.describe()["kv_offload"] == jeng.describe()["kv_offload"]
    assert teng.describe()["kv_offload"]["restores"] == 1
    # the index kept the spilled session's pages: another session attaches
    p3 = PREAMBLE + "Bors answers from the gatehouse."
    other = scoped_slot("off1", "bors")
    assert teng.generate(p3, slot_name=other) == \
        jeng.generate(p3, slot_name=other)
    assert teng.describe()["prefix_cache"] == jeng.describe()["prefix_cache"]
    assert teng.describe()["prefix_cache"]["hits"] > 0


@pytest.mark.parametrize("pool", ["bf16", "int8", "int4"])
def test_spilled_bytes_round_trip_exactly(weights, pool):
    """Restored pages hold the bytes the spilled pages held, payload and
    scale pools alike, on a bf16 pool and on int8 and int4 pages."""
    kw = ({"dtype": torch.bfloat16} if pool == "bf16"
          else {"kv_quant": pool})
    eng = _port_engine(weights, **kw, **NO_CACHE)
    sid, name = "offbytes", scoped_slot("offbytes", "kay")
    eng.generate(PREAMBLE + "Kay takes the floor.", slot_name=name)
    state = eng.kv._slots[name]
    idx = list(state.pages)
    before = [(k[idx].clone(), v[idx].clone())
              for k, v in eng.kv.combined_pools()]
    assert len(before) == (1 if pool == "bf16" else 2) * len(eng.kv.pools)
    tokens = list(state.tokens)
    eng.kv_offload.spill_session(sid)
    host = eng.kv_offload._spilled[sid].host
    assert host[0][0].dtype == eng.kv.pools[0][0].dtype
    assert eng.kv_offload.restore_session(sid) == 1
    state = eng.kv._slots[name]
    assert state.tokens == tokens
    idx = list(state.pages)
    for (kb, vb), (k, v) in zip(before, eng.kv.combined_pools()):
        assert torch.equal(kb, k[idx]) and torch.equal(vb, v[idx])


def test_intra_session_alias_survives_round_trip(weights):
    """Pages aliased between a session's own knights spill their bytes once
    and restore into one shared page, as in JAX (same counts)."""
    out = {}
    shared = PREAMBLE + "The span both knights share verbatim here."
    for key, eng in (("port", _port_engine(weights, **NO_CACHE)),
                     ("jax", _jax_engine(**NO_CACHE))):
        sid = "alias0"
        a, b = scoped_slot(sid, "lancelot"), scoped_slot(sid, "galahad")
        texts = eng.generate_batch([(a, shared + " Lancelot's own tail."),
                                    (b, shared + " Galahad's tail.")])
        kv = eng.kv
        alias = [p for p in kv._slots[a].pages if p in kv._slots[b].pages]
        assert alias, "knights never aliased the shared span"
        before = kv.pages_in_use()
        assert eng.kv_offload.spill_session(sid) == 2
        rows = eng.kv_offload._spilled[sid].n_rows()
        freed = before - kv.pages_in_use()
        eng.kv_offload.restore_session(sid)
        re_alias = [p for p in kv._slots[a].pages if p in kv._slots[b].pages]
        assert len(re_alias) == len(alias)
        out[key] = (texts, len(alias), rows, freed, kv.pages_in_use())
    assert out["port"] == out["jax"]


def test_stale_record_restore_never_leaks_pages(weights):
    """A slot repopulated while its record is filed keeps its live state;
    a re-spill supersedes the stale record with the new bytes, the restore
    serves them (full reuse of the same prompt) and a flush returns every
    page, as in JAX."""
    out = {}
    for key, eng in (("port", _port_engine(weights, **NO_CACHE)),
                     ("jax", _jax_engine(**NO_CACHE))):
        sid, name = "stale0", scoped_slot("stale0", "kay")
        p1 = PREAMBLE + "Kay's first account of the border patrol."
        p2 = PREAMBLE + "Kay's second, different account entirely."
        eng.generate(p1, slot_name=name)
        eng.kv_offload.spill_session(sid)
        out2 = eng.generate(p2, slot_name=name)
        eng.kv_offload.spill_session(sid)
        eng.kv_offload.restore_session(sid)
        _, st = eng.generate_batch_with_stats([(name, p2)])
        eng.kv.flush()
        assert eng.kv.pages_in_use() == 0, "restore leaked pool pages"
        out[key] = (out2, st.prefill_tokens, st.reused_tokens,
                    eng.kv_offload.describe())
    assert out["port"] == out["jax"]


def test_evacuate_moves_kept_pages(weights):
    """A page another session still references stays resident under a
    tier hold at spill; flush + evacuate() then moves it to host RAM,
    leaving zero pages in use, and the session restores and serves the
    JAX engine's tokens."""
    out = {}
    shared = PREAMBLE + "A span two sessions happen to share."
    for key, eng in (("port", _port_engine(weights, **NO_CACHE)),
                     ("jax", _jax_engine(**NO_CACHE))):
        n_idle = scoped_slot("evac0", "kay")
        n_live = scoped_slot("evac1", "kay")
        out1 = eng.generate(shared, slot_name=n_idle)
        eng.generate(shared, slot_name=n_live)
        kv = eng.kv
        # donation is intra-session only: alias across sessions by hand
        kv.adopt_span(n_live, kv._slots[n_idle].pages[:2], 0, 2 * PS,
                      pinned=(n_idle, n_live))
        eng.kv_offload.spill_session("evac0")
        kept = [p for _n, s in eng.kv_offload._spilled["evac0"].slots.items()
                for kind, p in s.entries if kind == "kept"]
        assert kept
        assert kv.flush() >= 1
        manifest = eng.kv_offload.evacuate()
        assert kv.pages_in_use() == 0
        assert eng.kv_offload.restorable_sessions() == ["evac0"]
        eng.kv_offload.restore_session("evac0")
        out2 = eng.generate(shared, slot_name=n_idle)
        assert out1 == out2
        manifest.pop("host_bytes")
        for s in manifest["sessions"].values():
            s.pop("host_bytes")
        out[key] = (out2, len(kept), manifest)
    assert out["port"] == out["jax"]


def test_evacuate_subset_and_adopt(weights):
    """evacuate(["sub0", "sub1"]) moves only those sessions, fully
    host-resident; the third keeps its pages. A fresh engine's tier adopts
    the records and restores them, serving the first engine's tokens."""
    eng = _port_engine(weights, **NO_CACHE)
    prompts = {s: PREAMBLE + f"Bedivere recounts watch {s}."
               for s in ("sub0", "sub1", "sub2")}
    names = {s: scoped_slot(s, "kay") for s in prompts}
    outs = {s: eng.generate(p, slot_name=names[s])
            for s, p in prompts.items()}
    pages2 = list(eng.kv._slots[names["sub2"]].pages)
    manifest = eng.kv_offload.evacuate(["sub0", "sub1"])
    assert sorted(manifest["sessions"]) == ["sub0", "sub1"]
    assert manifest["slots_spilled"] == 2 and manifest["host_bytes"] > 0
    assert not eng.kv_offload.has("sub2")
    assert eng.kv._slots[names["sub2"]].pages == pages2
    fresh = _port_engine(weights, **NO_CACHE)
    assert sorted(fresh.kv_offload.adopt(eng.kv_offload)) == ["sub0", "sub1"]
    assert eng.kv_offload.spilled_sessions() == []
    for s in ("sub0", "sub1"):
        assert fresh.kv_offload.restore_session(s) == 1
        out, st = fresh.generate_batch_with_stats([(names[s], prompts[s])])
        assert out[0] == outs[s]
        assert st.reused_tokens == len(prompts[s])   # all but one token


def test_scheduler_idle_spill_and_resume(weights):
    """With idle_spill_s set, a session idle that long spills on a tick
    (event reason "idle", the sessions view saying so); its next submit
    restores it and reuses the committed transcript."""
    eng = _port_engine(weights, **NO_CACHE)
    sched = SessionScheduler(eng, idle_spill_s=0.3)
    try:
        sid = "idle0"
        turns = [("lancelot", PREAMBLE + "Lancelot opens round 1.")]
        texts, _st = sched.submit(sid, turns, max_new_tokens=MAX_NEW)
        deadline = time.monotonic() + 30
        while not eng.kv_offload.has(sid) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert eng.kv_offload.has(sid), "idle session never spilled"
        assert sched.describe()["spills"] == 1
        assert sched.describe()["spilled_sessions"] == 1
        assert sched.snapshot()["sessions"][sid] == "spilled(host RAM)"
        assert [e["reason"] for e in sched.describe()["events"]
                if e["event"] == "spill"] == ["idle"]
        committed = len(eng.kv_offload._spilled[sid].slots[
            scoped_slot(sid, "lancelot")].tokens)
        turns2 = [("lancelot", turns[0][1] + texts[0] + " Round 2.")]
        _t2, st2 = sched.submit(sid, turns2, max_new_tokens=MAX_NEW)
        assert not eng.kv_offload.has(sid)
        assert st2.reused_tokens >= committed - PS
        assert eng.kv_offload.describe()["restores"] == 1
    finally:
        sched.close()


def test_scheduler_pressure_spill_instead_of_eviction(weights):
    """An admission whose new-page demand exceeds the free pages spills the
    least recently active idle session (reason "pressure") instead of
    letting the allocator evict it; the spilled session resumes with its
    transcript reused, and serves the tokens of a pool large enough that
    it never left (the JAX engine's direct calls)."""
    long = PREAMBLE + "A very long opening statement. " * 6
    eng = _port_engine(weights, num_slots=6, num_pages=40, **NO_CACHE)
    jref = _jax_engine(prefix_cache=False, kv_offload=False)
    sched = SessionScheduler(eng)
    try:
        first = sched.submit("pr0", [("lancelot", long)],
                             max_new_tokens=MAX_NEW)
        sched.submit("pr1", [("galahad", long)], max_new_tokens=MAX_NEW)
        sched.submit("pr2", [("bors", long), ("kay", long)],
                     max_new_tokens=MAX_NEW)
        spilled = eng.kv_offload.spilled_sessions()
        assert spilled[0] == "pr0"          # least recently active first
        reasons = [e["reason"] for e in sched.describe()["events"]
                   if e["event"] == "spill"]
        assert reasons and set(reasons) == {"pressure"}
        assert sched.describe()["spills"] == len(reasons)
        committed = len(eng.kv_offload._spilled["pr0"].slots[
            scoped_slot("pr0", "lancelot")].tokens)
        nxt = long + first[0][0] + " Another word."
        texts, st = sched.submit("pr0", [("lancelot", nxt)],
                                 max_new_tokens=8)
        assert st.reused_tokens >= committed - PS
        name = scoped_slot("pr0", "lancelot")
        assert jref.generate(long, slot_name=name) == first[0][0]
        assert jref.generate(nxt, slot_name=name,
                             max_new_tokens=8) == texts[0]
    finally:
        sched.close()
