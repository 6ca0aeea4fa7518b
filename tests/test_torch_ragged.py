"""PyTorch port, the ragged path: K3's plain version against the JAX
package's `ragged_paged_attention` (Pallas, interpret mode on the CPU) on
the inputs of tests/test_ragged_attn.py, the arrays of
`build_ragged_batch` against the JAX one's, and `forward_ragged` against
the JAX one on tiny-llama with bridged weights. Same numpy inputs on both
sides, f32. The CUDA kernel itself runs only on a card:
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theroundtaible_tpu.engine import serving_loop as jax_loop
from theroundtaible_tpu.engine.kvcache import share_prefixes as \
    jax_share_prefixes
from theroundtaible_tpu.engine.models.common import init_params as \
    jax_init_params
from theroundtaible_tpu.engine.models.registry import \
    get_model_config as jax_config
from theroundtaible_tpu.engine.paged_forward import \
    forward_ragged as jax_forward_ragged
from theroundtaible_tpu.engine.pallas import attention as pattn
from theroundtaible_tpu_torch.engine import serving_loop
from theroundtaible_tpu_torch.engine.kernels import attention as kattn
from theroundtaible_tpu_torch.engine.kvcache import share_prefixes
from theroundtaible_tpu_torch.engine.models.registry import \
    get_model_config as torch_config
from theroundtaible_tpu_torch.engine.paged_forward import forward_ragged
from theroundtaible_tpu_torch.engine.weights import params_from_numpy

# f32 on both sides: only the summation order differs.
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- K3's plain version against the JAX kernel ---

PS, KH, G, D = 16, 2, 2, 32


def ragged_case():
    """test_ragged_attn.py's mixed case plus an inert block: a 10-row
    chunk of sequence 0 at offset 5 (blocks 0-1, 6 pad rows), a decode row
    of sequence 1 at position 20 (block 2, 7 pad rows), and block 3 on the
    inert sequence 2 (kv_valid 1 over the scratch page 0)."""
    rng = np.random.default_rng(0)
    k_pool = rng.standard_normal((12, PS, KH, D)).astype(np.float32)
    v_pool = rng.standard_normal((12, PS, KH, D)).astype(np.float32)
    tables = np.zeros((3, 4), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :3] = [3, 4, 5]
    q = rng.standard_normal((32, KH * G, D)).astype(np.float32)
    meta = dict(seq_of_block=np.array([0, 0, 1, 2], np.int32),
                block_qstart=np.array([0, 8, 0, 0], np.int32),
                query_offsets=np.array([5, 20, 0], np.int32),
                kv_valid=np.array([15, 21, 1], np.int32))
    real = {0: (0, 5, 10), 1: (16, 20, 1)}   # seq: (first row, pos, n)
    return q, k_pool, v_pool, tables, meta, real


def port_ragged(q, k_pool, v_pool, tables, meta, window, softcap):
    args = [torch.from_numpy(x) for x in (
        q, k_pool, v_pool, tables, meta["seq_of_block"],
        meta["block_qstart"], meta["query_offsets"], meta["kv_valid"])]
    return kattn.ragged_paged_attention(
        *args, sliding_window=window, softcap=softcap).numpy()


@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, None),
                                            (None, 24), (30.0, 4)])
def test_ragged_plain_matches_jax_kernel(softcap, window):
    q, k_pool, v_pool, tables, meta, real = ragged_case()
    ref = np.asarray(pattn.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), *(jnp.asarray(meta[k]) for k in (
            "seq_of_block", "block_qstart", "query_offsets", "kv_valid")),
        sliding_window=window, softcap=softcap, interpret=True))
    ours = port_ragged(q, k_pool, v_pool, tables, meta, window, softcap)
    # NaN in every cell past each real sequence's kv_valid (pages >= 1;
    # page 0 is the scratch page the inert sequence reads) reaches no row.
    poisoned_k, poisoned_v = k_pool.copy(), v_pool.copy()
    for s in (0, 1):
        for j, page in enumerate(tables[s]):
            lo = max(int(meta["kv_valid"][s]) - j * PS, 0)
            if page and lo < PS:
                poisoned_k[page, lo:] = np.nan
                poisoned_v[page, lo:] = np.nan
    nan_run = port_ragged(q, poisoned_k, poisoned_v, tables, meta, window,
                          softcap)
    pad = np.ones(32, bool)
    for s, (row0, _pos, n) in real.items():
        np.testing.assert_allclose(ours[row0:row0 + n], ref[row0:row0 + n],
                                   **TOL)
        np.testing.assert_array_equal(nan_run[row0:row0 + n],
                                      ours[row0:row0 + n])
        pad[row0:row0 + n] = False
    pad[24] = False      # the inert sequence's row 0 (kv_valid 1)
    assert np.all(ours[pad] == 0.0) and np.all(nan_run[pad] == 0.0)


def test_ragged_wrapper_checks_shapes_and_decline():
    q, k_pool, v_pool, tables, meta, _ = ragged_case()
    with pytest.raises(ValueError, match="multiple of 8"):
        port_ragged(q[:12], k_pool, v_pool, tables, meta, None, None)
    bad = dict(meta, kv_valid=meta["kv_valid"][:2])
    with pytest.raises(ValueError, match="kv_valid"):
        port_ragged(q, k_pool, v_pool, tables, bad, None, None)
    with pytest.raises(ValueError, match="come together"):
        kattn.ragged_paged_attention(
            *[torch.from_numpy(x) for x in (q, k_pool, v_pool, tables)],
            *[torch.from_numpy(meta[k]) for k in (
                "seq_of_block", "block_qstart", "query_offsets",
                "kv_valid")], k_scale=torch.ones(1))
    # On the CPU the plain version takes every shape.
    assert kattn.ragged_decline_reason(48, 32, 2, 2, "cpu") is None
    assert "ragged_paged_attention" in kattn.KERNELS


# --- the flat buffer: build_ragged_batch ---


def _mix(mod):
    t0 = np.array([4, 9, 2, 7], np.int32)
    t1 = np.array([5, 6, 0, 0], np.int32)
    t2 = np.array([1, 3, 8, 10], np.int32)
    return [mod.RaggedSeq([11], 40, t0, temperature=0.7, top_k=5,
                          top_p=0.9),
            mod.RaggedSeq(list(range(3, 22)), 13, t1),
            mod.RaggedSeq([2, 4, 6, 8, 10, 12, 14, 16], 56, t2,
                          temperature=1.0)]


def test_build_ragged_batch_matches_jax():
    kw = dict(t_budget=64, s_max=5, pages_per_seq=4, scratch_page=0,
              pad_id=0, page_size=16)
    ours = serving_loop.build_ragged_batch(_mix(serving_loop), **kw)
    ref = jax_loop.build_ragged_batch(_mix(jax_loop), **kw)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            assert ours[key].dtype == value.dtype, key
            np.testing.assert_array_equal(ours[key], value, err_msg=key)
        else:
            assert ours[key] == value, key


def test_build_ragged_batch_errors_and_cache_end():
    table = np.arange(1, 5, dtype=np.int32)
    kw = dict(s_max=4, pages_per_seq=4, scratch_page=0, pad_id=0,
              page_size=16)
    RaggedSeq = serving_loop.RaggedSeq
    with pytest.raises(ValueError, match="overflow"):
        serving_loop.build_ragged_batch(
            [RaggedSeq(list(range(1, 20)), 0, table)], t_budget=16, **kw)
    with pytest.raises(ValueError, match="inert"):
        serving_loop.build_ragged_batch(
            [RaggedSeq([1], 0, table)] * 4, t_budget=64, **kw)
    with pytest.raises(ValueError, match="at least one token"):
        serving_loop.build_ragged_batch([RaggedSeq([], 0, table)],
                                        t_budget=16, **kw)
    # a verify run scores at most score_width rows, copy pairs need slots
    with pytest.raises(ValueError, match="n_scores 3 > score_width 2"):
        serving_loop.build_ragged_batch(
            [RaggedSeq([1, 2, 3], 0, table, n_scores=3)], t_budget=16,
            score_width=2, **kw)
    with pytest.raises(ValueError, match="without copy_slots"):
        serving_loop.build_ragged_batch([RaggedSeq([1], 0, table)],
                                        t_budget=16, copy_pairs=[(1, 2)],
                                        **kw)
    # A chunk ending exactly at the cache end (64 = 4 pages x 16): every
    # real token's page index stays inside the table.
    batch = serving_loop.build_ragged_batch(
        [RaggedSeq(list(range(1, 12)), 53, table)], t_budget=16, **kw)
    assert batch["kv_valid"][0] == 64
    np.testing.assert_array_equal(batch["token_pages"][:11], [4] * 11)
    np.testing.assert_array_equal(batch["token_offs"][:11],
                                  np.arange(5, 16))


def test_ragged_budget_grid_and_defer_env(monkeypatch):
    assert serving_loop.ragged_token_budget(8) == \
        jax_loop.ragged_token_budget(8) == 1024
    assert serving_loop.ragged_shape_grid(1024) == (64, 256, 1024)
    assert serving_loop.ragged_pick_shape((64, 256, 1024), 65) == 256
    assert serving_loop.ragged_pick_shape((64, 256), 999) == 256
    monkeypatch.setenv("ROUNDTABLE_RAGGED_TOKENS", "100")
    monkeypatch.setenv("ROUNDTABLE_RAGGED_DEFER_MIN", "12")
    assert serving_loop.ragged_token_budget(8) == 104
    assert serving_loop.ragged_defer_min() == jax_loop.ragged_defer_min() \
        == 12


# --- the deferred leader span of share_prefixes ---


class _Book:
    """The slot-book surface share_prefixes reads."""

    @staticmethod
    def best_donor(name, tokens):
        return None, 0

    @staticmethod
    def common_prefix_len(a, b):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        return n

    @staticmethod
    def acquire(name, pinned=()):
        return name


def test_share_prefixes_defer_span_matches_jax():
    shared = list(range(100, 180))
    tokens = [shared + [1, 2], shared + [3], shared + [4, 5, 6]]
    results = []
    for fn in (share_prefixes, jax_share_prefixes):
        plans, calls = [], []
        offsets, extra = fn(
            _Book, ["a", "b", "c"], tokens, [10, 0, 0], min_shared=16,
            add_share=lambda *a: calls.append(a), flush_shares=lambda: None,
            prefill_span=lambda *a: calls.append(("prefill",) + a),
            defer_span=lambda *a: plans.append(a))
        results.append((offsets, extra, plans, calls))
    assert results[0] == results[1]
    offsets, extra, plans, calls = results[0]
    # the leader keeps its coverage; the laggards rise to the span end
    assert offsets == [10, 80, 80] and extra == 0 and calls == []
    assert plans == [(0, 10, 80, [(1, 0), (2, 0)])]


# --- forward_ragged against the JAX one ---


@pytest.mark.parametrize("case", ["mixed", "cache_end"])
def test_forward_ragged_matches_jax(case):
    ps, pages, max_seq = 16, 10, 64
    jcfg = jax_config("tiny-llama", max_seq_len=max_seq)
    tcfg = torch_config("tiny-llama", max_seq_len=max_seq)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_numpy(jax.device_get(jparams), tcfg,
                                torch.float32, "cpu")
    rng = np.random.default_rng(5)
    shape = (pages, ps, tcfg.num_kv_heads, tcfg.head_dim)
    pools_np = [(rng.standard_normal(shape).astype(np.float32),
                 rng.standard_normal(shape).astype(np.float32))
                for _ in range(tcfg.num_layers)]
    RaggedSeq = serving_loop.RaggedSeq
    t_a = np.array([1, 2, 3, 4], np.int32)
    t_b = np.array([5, 6, 7, 8], np.int32)
    if case == "mixed":
        seqs = [RaggedSeq([2, 5, 9, 11, 5, 7, 9, 4, 6, 3], 3, t_a),
                RaggedSeq([8], 20, t_b)]
    else:   # a chunk and a decode row, each ending at the cache end
        seqs = [RaggedSeq([2, 5, 9, 11, 5, 7, 9], max_seq - 7, t_a),
                RaggedSeq([8], max_seq - 1, t_b)]
    batch = serving_loop.build_ragged_batch(
        seqs, t_budget=32, s_max=4, pages_per_seq=4, scratch_page=9,
        pad_id=0, page_size=ps)
    keys = ("tokens", "positions", "tables", "seq_of_block", "block_qstart",
            "query_offsets", "kv_valid", "token_pages", "token_offs")
    ref_logits, ref_pools = jax_forward_ragged(
        jparams, jcfg, *(jnp.asarray(batch[k]) for k in keys[:2]),
        [(jnp.asarray(k), jnp.asarray(v)) for k, v in pools_np],
        *(jnp.asarray(batch[k]) for k in keys[2:]),
        jnp.asarray(batch["token_seq"]), jnp.asarray(batch["last_rows"]))
    pools = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
             for k, v in pools_np]
    t = {k: torch.from_numpy(batch[k]) for k in keys + ("last_rows",)}
    logits = forward_ragged(
        tparams, tcfg, t["tokens"].long(), t["positions"], pools,
        *(t[k] for k in keys[2:]), t["last_rows"])
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy()[:2],
                               np.asarray(ref_logits)[:2],
                               atol=1e-4, rtol=1e-4)
    # the pool cells of every real token hold the same K/V
    real = np.concatenate([
        np.arange(batch["last_rows"][i] - len(s.tokens) + 1,
                  batch["last_rows"][i] + 1) for i, s in enumerate(seqs)])
    pages, offs = batch["token_pages"][real], batch["token_offs"][real]
    for (k, v), (rk, rv) in zip(pools, ref_pools):
        np.testing.assert_allclose(k.numpy()[pages, offs],
                                   np.asarray(rk)[pages, offs], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(v.numpy()[pages, offs],
                                   np.asarray(rv)[pages, offs], atol=1e-5,
                                   rtol=1e-5)


def test_forward_ragged_refuses_unported_inputs():
    cfg = torch_config("tiny-llama", max_seq_len=64)
    dummy = torch.zeros(8, dtype=torch.int32)
    # (verify rows and tree copies are served:
    # tests/test_torch_spec_decode.py) copies need both page lists
    with pytest.raises(ValueError, match="come together"):
        forward_ragged({}, cfg, dummy, dummy, [], dummy, dummy, dummy,
                       dummy, dummy, dummy, dummy, dummy, copy_src=dummy)
    with pytest.raises(ValueError, match="quant_spec"):
        forward_ragged({}, cfg, dummy, dummy, [], dummy, dummy, dummy,
                       dummy, dummy, dummy, dummy, dummy, scales=[])
