"""PyTorch port, paged KV bookkeeping: one scripted sequence of acquire,
reuse_plan, alias_span, copy-on-write, eviction, adopt_span and table_for
run on the JAX package's PagedKVCache and the port's. Tables, refcounts,
free lists and token records must be equal after every step, and the page
copies must move the same bytes. Also the slot-id SlotBook."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theroundtaible_tpu.engine.kvcache import SlotBook as JaxSlotBook
from theroundtaible_tpu.engine.models.registry import \
    get_model_config as jax_config
from theroundtaible_tpu.engine.paging import PagedKVCache as JaxPaged
from theroundtaible_tpu_torch.engine.kvcache import SlotBook, lcp
from theroundtaible_tpu_torch.engine.models.registry import \
    get_model_config as torch_config
from theroundtaible_tpu_torch.engine.paging import PagedKVCache


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers' timing tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_copy(pools, src, dst):
    return [(k.at[dst].set(k[src]), v.at[dst].set(v[src])) for k, v in pools]


def _state(kv, free):
    names = kv.slot_names()
    return {"names": names,
            "table": kv.table_for(names).tolist() if names else [],
            "refs": dict(sorted(kv._refs.items())),
            "free": list(free),
            "tokens": {n: list(kv._slots[n].tokens) for n in names},
            "in_use": kv.pages_in_use()}


def test_scripted_sequence_matches_jax():
    cfg_j = jax_config("tiny-llama", max_seq_len=128)
    cfg_t = torch_config("tiny-llama", max_seq_len=128)
    ps, n_pages = 16, 24
    jkv = JaxPaged(cfg_j, num_slots=3, max_seq_len=128, dtype=jnp.float32,
                   page_size=ps, num_pages=n_pages, copy_pages_fn=_jax_copy)
    tkv = PagedKVCache(cfg_t, num_slots=3, max_seq_len=128,
                       dtype=torch.float32, device="cpu", page_size=ps,
                       num_pages=n_pages)
    # identical, distinguishable page contents in both pools
    rng = np.random.default_rng(0)
    init = [(rng.normal(size=k.shape).astype(np.float32),
             rng.normal(size=k.shape).astype(np.float32))
            for k, _ in jkv.pools]
    jkv.pools = [(jnp.asarray(k), jnp.asarray(v)) for k, v in init]
    for (tk, tv), (k, v) in zip(tkv.pools, init):
        tk.copy_(torch.from_numpy(k))
        tv.copy_(torch.from_numpy(v))

    a = list(range(3, 63))                       # 60 tokens
    b = a[:40] + list(range(100, 130))           # shares 40 with a
    c = a[:32] + list(range(200, 240))           # shares 32 with a

    def both(fn):
        rj = fn(jkv)
        rt = fn(tkv)
        assert rj == rt
        assert _state(jkv, jkv._free_by_replica[0]) == \
            _state(tkv, tkv._free)
        for (jk, jv), (tk, tv) in zip(jkv.pools, tkv.pools):
            np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
            np.testing.assert_array_equal(np.asarray(jv), tv.numpy())

    both(lambda kv: kv.reuse_plan("a", a))
    both(lambda kv: kv.ensure_capacity("a", len(a) + 16, write_from=0))
    both(lambda kv: kv.commit("a", a))
    both(lambda kv: kv.reuse_plan("b", b, ("b",)))
    # whole pages 0-1 alias, the partial boundary page 2 is copied
    both(lambda kv: kv.alias_span("a", "b", 0, 40, ("b",)))
    both(lambda kv: kv.ensure_capacity("b", len(b) + 16, write_from=40))
    both(lambda kv: kv.commit("b", b))
    both(lambda kv: kv.reuse_plan("c", c, ("c",)))
    both(lambda kv: kv.alias_span("a", "c", 0, 32, ("c",)))
    # writing from 20 hits aliased page 1: copy-on-write
    both(lambda kv: kv.ensure_capacity("c", len(c) + 16, write_from=20))
    assert tkv._slots["c"].pages[0] == tkv._slots["a"].pages[0]
    assert tkv._slots["c"].pages[1] != tkv._slots["a"].pages[1]
    both(lambda kv: kv.commit("c", c))
    both(lambda kv: kv.best_donor("c", a[:50])[1])
    # a fourth slot evicts the least recently acquired one (b)
    both(lambda kv: kv.reuse_plan("d", list(range(300, 310)), ("d",)))
    assert "b" not in tkv.slot_names()
    both(lambda kv: kv.ensure_capacity("d", 64, write_from=0))
    # page pressure: a long slot forces _alloc_page to evict slots
    both(lambda kv: kv.ensure_capacity("d", 128, write_from=0))
    both(lambda kv: kv.commit("d", list(range(300, 420))))
    both(lambda kv: kv.release("a"))
    pages = list(tkv._slots["d"].pages)
    both(lambda kv: kv.adopt_span("e", pages, 0, 48, ("e",)))
    both(lambda kv: kv.adopt_span("c", pages, 20, 48, ("c",)))
    both(lambda kv: kv.reset_slot("e"))
    both(lambda kv: kv.flush())


def test_default_num_pages_and_scratch_page_match():
    cfg_j = jax_config("tiny-llama", max_seq_len=256)
    cfg_t = torch_config("tiny-llama", max_seq_len=256)
    jkv = JaxPaged(cfg_j, num_slots=4, max_seq_len=256, dtype=jnp.float32,
                   page_size=32, copy_pages_fn=_jax_copy)
    tkv = PagedKVCache(cfg_t, num_slots=4, max_seq_len=256,
                       dtype=torch.float32, device="cpu", page_size=32)
    assert tkv.num_pages == jkv.num_pages
    assert tkv.hbm_bytes() == jkv.hbm_bytes()
    tkv.reuse_plan("x", [1, 2, 3])
    jkv.reuse_plan("x", [1, 2, 3])
    assert tkv.table_for(["x"]).tolist() == jkv.table_for(["x"]).tolist()
    assert (tkv.table_for(["x"]) == 0).all()   # scratch padding


def test_slotbook_matches_jax():
    jb, tb = JaxSlotBook(2), SlotBook(2)
    steps = [
        lambda s: s.reuse_plan("a", [1, 2, 3, 4]),
        lambda s: s.commit("a", [1, 2, 3, 4, 5]),
        lambda s: s.reuse_plan("b", [1, 2, 3, 9]),
        lambda s: s.best_donor("b", [1, 2, 3, 9])[1],
        lambda s: s.commit("b", [1, 2, 3, 9]),
        lambda s: s.reuse_plan("c", [7], ("c", "b")),   # evicts a
        lambda s: s.slot_names(),
        lambda s: s.reuse_plan("b", [1, 2, 3, 9, 10]),
    ]
    for step in steps:
        assert step(jb) == step(tb)
        assert {n: (s.slot_id, s.tokens) for n, s in jb._slots.items()} \
            == {n: (s.slot_id, s.tokens) for n, s in tb._slots.items()}


def test_lcp():
    assert lcp([1, 2, 3], [1, 2, 4]) == 2
    assert lcp([], [1]) == 0
    assert lcp([5] * 3000, [5] * 3000) == 3000
