"""PyTorch port, the cross-session prefix cache (engine/prefix_cache.py and
the pool's sharing surface in engine/paging.py) against the JAX package's
(tests/test_prefix_cache.py).

The radix index on a bare pool: the same sequence of allocator and index
calls on a JAX pool and on the port's (f32, page 16) gives the same pages,
refcounts, copies and describe(). Engines: tiny-llama, paged, page 32, f32,
the JAX engine's weights bridged into the port; a second session sharing
the first one's preamble attaches its pages, with greedy tokens identical
to the JAX engine's and to the port's cache-off run and the same
prefix_reused_tokens and prefill tokens (unquantized, int8 and int4
pages); a divergent write forks without touching the first session's
pages; a LoRA batch's persona rows neither attach nor feed the index. The
scheduler: three sessions with the cache on give the tokens of the cache-off
runs, and a transcript partly produced by accepted drafts attaches and
decodes as the spec-off world does. Every engine test asserts its own
attach hits."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
from theroundtaible_tpu.engine.models.registry import \
    get_model_config as jax_config
from theroundtaible_tpu.engine.paging import PagedKVCache as JaxPaged
from theroundtaible_tpu.engine.prefix_cache import PrefixCache as JaxCache
from theroundtaible_tpu.engine.sampling import SamplingParams as JaxSampling
from theroundtaible_tpu_torch.engine import lora
from theroundtaible_tpu_torch.engine import prefix_cache as pc
from theroundtaible_tpu_torch.engine.engine import InferenceEngine
from theroundtaible_tpu_torch.engine.kvcache import scoped_slot
from theroundtaible_tpu_torch.engine.models.registry import \
    get_model_config as torch_config
from theroundtaible_tpu_torch.engine.paging import PagedKVCache
from theroundtaible_tpu_torch.engine.sampling import SamplingParams
from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
from theroundtaible_tpu_torch.engine.weights import params_from_numpy

MESH1 = {"data": 1, "model": 1}
MAX_SEQ = 512
PS = 32
MAX_NEW = 24
# ~220 byte-tokenizer tokens: about 7 complete 32-token pages, well inside
# the prompt budget (tests/test_prefix_cache.py's preamble).
PREAMBLE = ("The round table convened at dawn. The rules of order are "
            "strict: every knight states a proposal, scores consensus "
            "from one to ten, and names the open points that remain. "
            "Honor the order of speech and keep the record true. ")
SESSIONS = {
    "s0": [("lancelot", PREAMBLE + "Lancelot opens on the castle walls."),
           ("galahad", PREAMBLE + "Galahad raises the matter of the "
                                  "moat and the eastern gate.")],
    "s1": [("lancelot", PREAMBLE + "Lancelot turns to the dragon "
                                   "reports from the north."),
           ("galahad", PREAMBLE + "Galahad disputes the gold-reserve "
                                  "figures sharply.")],
    "s2": [("lancelot", PREAMBLE + "Lancelot proposes a harvest "
                                   "festival tournament."),
           ("galahad", PREAMBLE + "Galahad volunteers to judge the "
                                  "melee himself.")],
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the radix index on a bare pool
# ---------------------------------------------------------------------------


def _jax_pool(num_slots=4, num_pages=None, max_pages=None):
    cfg = jax_config("tiny-gemma", max_seq_len=128)
    copies = []

    def copy_fn(pools, src, dst):
        copies.append((np.asarray(src).tolist(), np.asarray(dst).tolist()))
        return [(k.at[dst].set(k[src]), v.at[dst].set(v[src]))
                for k, v in pools]

    kv = JaxPaged(cfg, num_slots, 128, jnp.float32, page_size=16,
                  num_pages=num_pages, copy_pages_fn=copy_fn)
    cache = JaxCache(kv, engine="unit", max_pages=max_pages)
    kv.prefix_cache = cache
    return kv, cache, copies


def _port_pool(num_slots=4, num_pages=None, max_pages=None):
    cfg = torch_config("tiny-gemma", max_seq_len=128)
    kv = PagedKVCache(cfg, num_slots, 128, torch.float32, device="cpu",
                      page_size=16, num_pages=num_pages)
    copies = []
    run = kv._run_page_copy

    def recorded(src, dst):
        copies.append((list(src), list(dst)))
        run(src, dst)

    kv._run_page_copy = recorded
    cache = pc.PrefixCache(kv, engine="unit", max_pages=max_pages)
    kv.prefix_cache = cache
    return kv, cache, copies


def _commit(kv, name, tokens, upto=48):
    kv.acquire(name)
    kv.ensure_capacity(name, upto, write_from=0)
    kv.commit(name, tokens)


def insert_and_match(kv, cache, copies):
    _commit(kv, "a", list(range(40)))          # 2 complete pages of 16
    assert cache.page_count() == 2
    nodes = cache.match(list(range(40)))
    assert [n.page for n in nodes] == kv._slots["a"].pages[:2]
    return {"diverging": len(cache.match(list(range(16)) + [999] * 24)),
            "other": len(cache.match([7] * 40)),
            "pages": [n.page for n in nodes]}


def pages_survive_release(kv, cache, copies):
    _commit(kv, "a", list(range(32)))
    pages = list(kv._slots["a"].pages)
    kv.release("a")
    assert kv.pages_in_use() == 2             # the index still holds them
    return {"refs": [kv.refcount(p) for p in pages]}


def attach_aliases(kv, cache, copies):
    _commit(kv, "a", list(range(40)))
    kv.release("a")
    tokens = list(range(40)) + [500, 501]
    kv.acquire("b")
    got = cache.attach("b", tokens)
    assert got == 32 and not copies           # pure aliasing at lo=0
    return {"got": got, "tokens": kv._slots["b"].tokens,
            "pages": kv._slots["b"].pages}


def feed_one_token(kv, cache, copies):
    _commit(kv, "a", list(range(32)))
    kv.release("a")
    kv.acquire("b")
    return {"got": cache.attach("b", list(range(32)))}   # cap // ps: 16


def cow_page(kv, cache, copies):
    _commit(kv, "a", list(range(32)))
    kv.acquire("b")
    cache.attach("b", list(range(32)) + [7, 8])
    shared = kv._slots["b"].pages[0]
    out = {"refs": kv.refcount(shared)}        # a + b + index
    fresh = kv.cow_page("b", 0)                # a real share: copied
    assert fresh != shared and kv._slots["a"].pages[0] == shared
    kv.release("b")
    p0 = kv._slots["a"].pages[0]
    out.update(fresh=fresh, before=kv.refcount(p0),
               forgot=kv.cow_page("a", 0),    # index-only share: forgets
               held=cache.holds_page(p0), again=kv.cow_page("a", 0),
               copies=list(copies))
    assert len(copies) == 1
    return out


def lru_refcount0_only(kv, cache, copies):
    _commit(kv, "a", list(range(32)))
    live = cache.reclaim(want=8)               # a still maps its pages
    kv.release("a")
    return {"live": live, "idle": cache.reclaim(want=8),
            "in_use": kv.pages_in_use(), "pages": cache.page_count()}


def page_cap(kv, cache, copies):
    _commit(kv, "a", list(range(32)))
    kv.release("a")
    _commit(kv, "b", [900 + i for i in range(48)], upto=64)
    return {"evictions": cache.evictions,
            "a": len(cache.match(list(range(32)))),
            "b": len(cache.match([900 + i for i in range(48)]))}


def alloc_pressure(kv, cache, copies):
    _commit(kv, "a", list(range(64)), upto=64)  # 4 of the 8 usable pages
    kv.release("a")
    kv.acquire("b")
    kv.ensure_capacity("b", 128, write_from=0, pinned=("b",))
    assert cache.page_count() < 4               # reclaimed under pressure
    return {"b": kv._slots["b"].pages, "cached": cache.page_count()}


def flush_drops_index(kv, cache, copies):
    _commit(kv, "a", list(range(40)))
    return {"flushed": kv.flush(), "in_use": kv.pages_in_use(),
            "pages": cache.page_count()}


def ledger_counts_shared_once(kv, cache, copies):
    _commit(kv, "a", list(range(40)))
    kv.acquire("b")
    cache.attach("b", list(range(40)) + [7, 8, 9])
    led = kv.memory_ledger()
    assert (led["pages_in_use"], led["shared_pages"],
            led["exclusive_pages"], led["prefix_cache_pages"]) == (3, 2, 1, 2)
    assert led["fragmentation"] == round(1.0 - 40 / 48, 3)
    return {k: led[k] for k in (
        "pages_in_use", "usable_pages", "shared_pages", "exclusive_pages",
        "prefix_cache_pages", "fragmentation", "cached_tokens",
        "slots_in_use", "page_utilization", "slot_occupancy")}


@pytest.mark.parametrize("scenario,kw", [
    (insert_and_match, {}), (pages_survive_release, {}),
    (attach_aliases, {}), (feed_one_token, {}), (cow_page, {}),
    (lru_refcount0_only, {}), (page_cap, {"max_pages": 2}),
    (alloc_pressure, {"num_pages": 9}), (flush_drops_index, {}),
    (ledger_counts_shared_once, {}),
], ids=lambda x: getattr(x, "__name__", ""))
def test_radix_index_matches_jax(scenario, kw):
    """tests/test_prefix_cache.py's TestRadixIndex cases, each on both
    pools: the scenario's observations and the index's describe() equal
    JAX's after the same calls."""
    mine = _port_pool(**kw)
    theirs = _jax_pool(**kw)
    assert scenario(*mine) == scenario(*theirs)
    assert mine[1].describe() == theirs[1].describe()
    assert mine[0]._refs == theirs[0]._refs


# ---------------------------------------------------------------------------
# engines: cross-session reuse
# ---------------------------------------------------------------------------


def _jax_engine(model="tiny-llama", **kw):
    kw.setdefault("ragged_attn", False)
    return JaxEngine(jax_config(model, max_seq_len=MAX_SEQ),
                     mesh_shape=MESH1, num_slots=8, kv_layout="paged",
                     page_size=PS, dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0,
                                          max_new_tokens=MAX_NEW),
                     spec_decode=False, **kw)


def _port_engine(params, model="tiny-llama", **kw):
    cfg = torch_config(model, max_seq_len=MAX_SEQ)
    kw.setdefault("ragged_attn", False)
    kw.setdefault("spec_decode", False)
    return InferenceEngine(
        cfg, num_slots=8, kv_layout="paged", page_size=PS,
        dtype=torch.float32,
        sampling=SamplingParams(temperature=0.0, max_new_tokens=MAX_NEW),
        params=params_from_numpy(params, cfg, torch.float32, "cpu"),
        device="cpu", **kw)


@pytest.fixture(scope="module")
def weights():
    """The JAX engines' weights (seed 0, as every JAX engine here draws
    them), bridged into every port engine."""
    return jax.device_get(_jax_engine(prefix_cache=False,
                                      kv_offload=False).params)


def _two_sessions(eng, p1, p2):
    """Session pcA serves p1, then session pcB serves p2: (texts, stats of
    the second call, the slots' committed records)."""
    a = eng.generate(p1, slot_name=scoped_slot("pcA", "percival"))
    b, st = eng.generate_batch_with_stats(
        [(scoped_slot("pcB", "bors"), p2)])
    records = {n: list(eng.kv._slots[n].tokens) for n in (
        scoped_slot("pcA", "percival"), scoped_slot("pcB", "bors"))}
    return [a, b[0]], st, records


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
def test_cross_session_reuse_matches_jax_and_cache_off(weights, kv_quant):
    """A second session sharing the preamble attaches the first one's
    pages: its greedy tokens equal the JAX engine's and the port's
    cache-off run, prefix_reused_tokens and prefill tokens equal JAX's,
    and the index's describe() equals JAX's."""
    p1 = PREAMBLE + "Percival files the first scouting report."
    p2 = PREAMBLE + "Bors demands a second opinion on the walls."
    pc.reset_test_counters()
    jeng = _jax_engine(kv_quant=kv_quant)
    teng = _port_engine(weights, kv_quant=kv_quant)
    toff = _port_engine(weights, kv_quant=kv_quant, prefix_cache=False)
    mine, st, rec = _two_sessions(teng, p1, p2)
    theirs, jst, jrec = _two_sessions(jeng, p1, p2)
    off, ost, orec = _two_sessions(toff, p1, p2)
    assert mine == theirs == off
    assert rec == jrec == orec
    assert st.prefix_reused_tokens == jst.prefix_reused_tokens > 0
    assert st.prefill_tokens == jst.prefill_tokens < ost.prefill_tokens
    assert st.reused_tokens == jst.reused_tokens
    d = teng.describe()["prefix_cache"]
    assert d == jeng.describe()["prefix_cache"]
    assert d["hits"] > 0 and pc.hits_seen() == d["hits"]
    keys = ("pages_in_use", "shared_pages", "exclusive_pages",
            "prefix_cache_pages", "fragmentation", "cached_tokens")
    led, jled = teng.kv.memory_ledger(), jeng.kv.memory_ledger()
    assert {k: led[k] for k in keys} == {k: jled[k] for k in keys}
    assert "kv_offload" in teng.describe()
    assert toff.describe().get("prefix_cache") is None


def test_divergent_write_forks_not_corrupts(weights):
    """Two sessions share the preamble, then diverge: the second one's
    writes copy or forget the shared pages, so the first session's pages
    are unchanged and a replay of it from a fresh slot attaches and serves
    the same tokens as the JAX engine."""
    p1 = PREAMBLE + "Kay recounts the northern campaign in detail."
    p2 = PREAMBLE + "Tristan objects and proposes a naval route."
    n1, n2 = scoped_slot("divA", "kay"), scoped_slot("divB", "tristan")
    jeng = _jax_engine()
    teng = _port_engine(weights)
    a1 = teng.generate(p1, slot_name=n1)
    pages = list(teng.kv._slots[n1].pages)
    before = [(k[pages].clone(), v[pages].clone())
              for k, v in teng.kv.pools]
    b = teng.generate(p2, slot_name=n2)
    for (kb, vb), (k, v) in zip(before, teng.kv.pools):
        assert torch.equal(kb, k[pages]) and torch.equal(vb, v[pages])
    a2 = teng.generate(p1, slot_name=scoped_slot("divA2", "kay"))
    assert [a1, b, a2] == [jeng.generate(p1, slot_name=n1),
                           jeng.generate(p2, slot_name=n2),
                           jeng.generate(p1, slot_name=scoped_slot(
                               "divA2", "kay"))]
    assert a1 == a2
    assert teng.describe()["prefix_cache"] == \
        jeng.describe()["prefix_cache"]
    assert teng.describe()["prefix_cache"]["hits"] >= 2


@pytest.fixture(scope="module")
def personas(tmp_path_factory):
    """Two persona npz files in the layout both packages load, drawn from
    a numpy seed at tiny-llama width."""
    root = tmp_path_factory.mktemp("personas")
    dims = lora.lora_dims(torch_config("tiny-llama"))
    out = {}
    for i, name in enumerate(("galahad", "percival")):
        rng = np.random.default_rng(200 + i)
        tree = {k: (rng.normal(size=(4, c)).astype(np.float32) * c ** -0.5,
                    rng.normal(size=(4, o)).astype(np.float32) * 0.6)
                for k, (c, o, _tp) in dims.items()}
        path = root / f"{name}.npz"
        lora.save_pair_tree(str(path), tree)
        out[name] = {"path": str(path)}
    return out


def test_lora_persona_rows_neither_attach_nor_feed(weights, personas):
    """A base row commits the preamble; then a batch of [base, persona]
    rows sharing it: only the base row attaches, and at commit only the
    base row's pages enter the index. Tokens, prefix_reused_tokens and the
    index's describe() equal the JAX engine's."""
    block = {"rank": 4, "max_adapters": 2, "scale": 4.0,
             "adapters": dict(personas)}
    jeng = _jax_engine(lora=dict(block))
    teng = _port_engine(weights, lora=dict(block))
    seed = [("lancelot", PREAMBLE + "Lancelot seeds the index.")]
    batch = [("bors", PREAMBLE + "Bors speaks for the base model."),
             ("galahad", PREAMBLE + "Galahad speaks as a persona.")]
    out = {}
    for key, eng in (("port", teng), ("jax", jeng)):
        eng.generate_batch(seed, session="seed")
        inserted = eng.prefix_cache.inserted_pages
        texts = eng.generate_batch(batch, session="mix",
                                   adapters_per_turn=[None, "galahad"])
        st = eng.last_stats
        persona_pages = eng.kv._slots[scoped_slot("mix", "galahad")].pages
        out[key] = (texts, st.prefix_reused_tokens,
                    eng.prefix_cache.inserted_pages - inserted,
                    eng.describe()["prefix_cache"])
        # the persona row's pages are its own and unindexed
        assert not any(eng.prefix_cache.holds_page(p)
                       for p in persona_pages)
    assert out["port"] == out["jax"]
    texts, reused, fed, d = out["port"]
    assert reused == (len(PREAMBLE) + 1) // PS * PS   # the base row's pages
    assert d["hits"] == 1


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


def test_three_sessions_cache_on_matches_off_and_jax(weights):
    """s0 runs to completion (seeding the index), then s1 and s2 arrive
    together: both attach s0's pages while sharing a batch, and every
    session's tokens equal the JAX engine's and the port's cache-off
    generate_batch."""
    jeng = _jax_engine(prefix_cache=False, kv_offload=False)
    toff = _port_engine(weights, prefix_cache=False)
    baseline = {sid: jeng.generate_batch(turns, max_new_tokens=48,
                                         session=sid)
                for sid, turns in SESSIONS.items()}
    for sid, turns in SESSIONS.items():
        assert toff.generate_batch(turns, max_new_tokens=48,
                                   session=sid) == baseline[sid]
    eng = _port_engine(weights, ragged_attn=None)
    eng.ragged_defer_min = 1
    sched = SessionScheduler(eng, admit_hold_s=0.3)
    results, errors = {}, {}

    def run(sid):
        try:
            results[sid] = sched.submit(sid, SESSIONS[sid],
                                        max_new_tokens=48)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors[sid] = e

    try:
        run("s0")
        threads = [threading.Thread(target=run, args=(s,))
                   for s in ("s1", "s2")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        assert not errors, errors
        for sid in SESSIONS:
            assert results[sid][0] == baseline[sid], sid
        for sid in ("s1", "s2"):
            assert results[sid][1].prefix_reused_tokens > 0, sid
        assert eng.describe()["prefix_cache"]["hits"] >= 4
        led = eng.kv.memory_ledger()
        assert led["shared_pages"] > 0 and led["prefix_cache_pages"] > 0
    finally:
        sched.close()


def test_prefix_cache_attach_of_drafted_transcript():
    """tests/test_spec_decode.py:442 on the port (tiny-gemma, whose random
    greedy output repeats, so the n-gram drafter drafts): a transcript
    partly produced by accepted drafts commits pages; a fresh session
    whose prompt is that transcript attaches them and decodes as the
    spec-off engine's does, and as the JAX engine's generate_batch of the
    same prompt."""
    passage = "The round table met at dawn to discuss the castle walls. "
    turns = [("galahad", passage * 3 + "Galahad speaks.")]
    jeng = _jax_engine("tiny-gemma", prefix_cache=False, kv_offload=False)
    weights = jax.device_get(jeng.params)

    def two_phase(spec):
        eng = _port_engine(weights, "tiny-gemma", ragged_attn=None,
                           spec_decode=spec)
        sched = SessionScheduler(eng)
        try:
            sched.submit("s1", turns, max_new_tokens=140)
            committed = list(eng.kv._slots[
                scoped_slot("s1", "galahad")].tokens)
            texts, stats = sched.submit("fresh", [("newknight", committed)],
                                        max_new_tokens=40)
        finally:
            sched.close()
        return eng, committed, texts, stats

    on, committed_on, texts_on, stats_on = two_phase(True)
    _off, committed_off, texts_off, _st = two_phase(False)
    assert committed_on == committed_off
    assert texts_on == texts_off
    assert texts_on == jeng.generate_batch([("newknight", committed_on)],
                                           max_new_tokens=40)
    assert stats_on.prefix_reused_tokens > 0
    assert on.spec_describe()["accepted_tokens"] > 0
    assert on.describe()["prefix_cache"]["hits"] > 0


def test_kill_switches_and_contiguous_build_neither(monkeypatch):
    """ROUNDTABLE_PREFIX_CACHE=0 / ROUNDTABLE_KV_OFFLOAD=0 and the config
    keys turn each off on a paged engine, as in JAX; a contiguous engine
    builds neither; `prefix_cache_pages` caps the index."""
    base = {"model": "tiny-llama", "max_seq_len": 128, "kv_layout": "paged",
            "page_size": 32}
    eng = InferenceEngine.from_config(dict(base, prefix_cache_pages=3),
                                      device="cpu")
    assert eng.prefix_cache.max_pages == 3 and eng.kv_offload is not None
    monkeypatch.setenv("ROUNDTABLE_PREFIX_CACHE", "0")
    monkeypatch.setenv("ROUNDTABLE_KV_OFFLOAD", "off")
    eng = InferenceEngine.from_config(base, device="cpu")
    assert eng.prefix_cache is None and eng.kv_offload is None
    d = eng.describe()
    assert "prefix_cache" not in d and "kv_offload" not in d
    eng = InferenceEngine.from_config(dict(base, prefix_cache=True,
                                           kv_offload=True), device="cpu")
    assert eng.prefix_cache is not None and eng.kv_offload is not None
    monkeypatch.delenv("ROUNDTABLE_PREFIX_CACHE")
    monkeypatch.delenv("ROUNDTABLE_KV_OFFLOAD")
    eng = InferenceEngine.from_config(dict(base, prefix_cache=False,
                                           kv_offload=False), device="cpu")
    assert eng.prefix_cache is None and eng.kv_offload is None
    eng = InferenceEngine.from_config(
        {"model": "tiny-llama", "max_seq_len": 128}, device="cpu")
    assert eng.prefix_cache is None and eng.kv_offload is None
    assert pc.env_flag is __import__(
        "theroundtaible_tpu_torch.engine.spec_decode",
        fromlist=["env_flag"]).env_flag
