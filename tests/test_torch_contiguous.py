"""PyTorch port, the contiguous KV layout (the JAX engine's default): the
plain versions of K8 (flash_prefill_attention) and K9
(ragged_decode_attention), and K9's split-KV schedule (decode_split_ref),
against the JAX package's Pallas kernels in interpret mode, forward_cached
against the JAX prefill/decode programs, and the port's contiguous
InferenceEngine and SessionScheduler against the JAX ones on tiny-llama,
tiny-mistral (window 64) and tiny-gemma with the JAX engine's weights
bridged in. Same numpy inputs on both sides, f32.
The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
from theroundtaible_tpu.engine.models.common import forward as jax_forward
from theroundtaible_tpu.engine.models.common import init_params as \
    jax_init_params
from theroundtaible_tpu.engine.models.registry import \
    get_model_config as jax_config
from theroundtaible_tpu.engine.pallas import attention as pattn
from theroundtaible_tpu.engine.sampling import SamplingParams as JaxSampling
from theroundtaible_tpu.engine.scheduler import \
    SessionScheduler as JaxScheduler
from theroundtaible_tpu_torch.engine.engine import InferenceEngine
from theroundtaible_tpu_torch.engine.kernels import attention as kattn
from theroundtaible_tpu_torch.engine.kvcache import KVCache
from theroundtaible_tpu_torch.engine.models.common import forward_cached
from theroundtaible_tpu_torch.engine.models.registry import \
    get_model_config as torch_config
from theroundtaible_tpu_torch.engine.sampling import SamplingParams
from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
from theroundtaible_tpu_torch.engine.weights import params_from_numpy

# f32 on both sides: only the summation order differs.
TOL = dict(atol=1e-5, rtol=1e-5)
WINDOW_SOFTCAP = [(None, None), (48, None), (None, 30.0), (200, None),
                  (48, 30.0)]
OFF = dict(prefix_cache=False, kv_offload=False, ragged_attn=False,
           spec_decode=False)
MAX_SEQ = 256


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- K8/K9 plain versions against the JAX kernels ---


def cache_case(seed, N, S, K, D):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(N, S, K, D)).astype(np.float32)
    v = rng.normal(size=(N, S, K, D)).astype(np.float32)
    return rng, k, v


def run_decode(q, k, v, valid, window, softcap, rows=None):
    """Port (K9 wrapper on CPU tensors, reading cache rows through `rows`)
    and JAX (interpret mode, given k[rows] as its [B,S,K,D] cache)."""
    t = torch.from_numpy
    ours = kattn.ragged_decode_attention(
        t(q), t(k), t(v), t(valid), sliding_window=window, softcap=softcap,
        rows=None if rows is None else t(rows))
    sel = np.arange(q.shape[0]) if rows is None else rows
    ref = pattn.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(k[sel]), jnp.asarray(v[sel]),
        jnp.asarray(valid), sliding_window=window, softcap=softcap,
        interpret=True)
    return ours.numpy(), np.asarray(ref)


def run_prefill(q, k, v, offsets, valid, window, softcap, rows=None):
    t = torch.from_numpy
    ours = kattn.flash_prefill_attention(
        t(q), t(k), t(v), t(offsets), t(valid), sliding_window=window,
        softcap=softcap, rows=None if rows is None else t(rows))
    sel = np.arange(q.shape[0]) if rows is None else rows
    ref = pattn.flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k[sel]), jnp.asarray(v[sel]),
        jnp.asarray(offsets), jnp.asarray(valid), sliding_window=window,
        softcap=softcap, interpret=True)
    return ours.numpy(), np.asarray(ref)


@pytest.mark.parametrize("window,softcap", WINDOW_SOFTCAP)
@pytest.mark.parametrize("heads,kv_heads", [(8, 2), (2, 2), (4, 1)])
def test_ragged_decode_matches_jax_kernel(window, softcap, heads, kv_heads):
    """GQA (group 4), MHA and MQA; rows at the start, mid-block and the
    full cache length."""
    B, S, D = 3, 512, 32
    rng, k, v = cache_case(1, B, S, kv_heads, D)
    q = rng.normal(size=(B, 1, heads, D)).astype(np.float32) * D ** -0.5
    valid = np.asarray([1, 300, 512], np.int32)
    ours, ref = run_decode(q, k, v, valid, window, softcap)
    assert ours.shape == q.shape
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("window,softcap", WINDOW_SOFTCAP)
@pytest.mark.parametrize("heads,kv_heads", [(8, 2), (4, 1)])
def test_flash_prefill_matches_jax_kernel(window, softcap, heads, kv_heads):
    """Delta-prefill offsets with partial lengths: real query rows match
    the TPU kernel; pad rows (q_pos >= kv_valid), which JAX fills with
    garbage the engine drops, are 0 in the port."""
    B, T, S, D = 3, 64, 512, 32
    rng, k, v = cache_case(2, B, S, kv_heads, D)
    q = rng.normal(size=(B, T, heads, D)).astype(np.float32) * D ** -0.5
    offsets = np.asarray([0, 10, S - T], np.int32)
    lengths = np.asarray([64, 23, 64], np.int32)
    ours, ref = run_prefill(q, k, v, offsets, offsets + lengths, window,
                            softcap)
    assert ours.shape == q.shape
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(ours[b, :n], ref[b, :n], **TOL)
        assert not ours[b, n:].any()


# K8 at the edges of the CUDA kernel's tensor-core tile (64 query rows of G
# heads x 64/G chunk rows per warpgroup, two warpgroups per block, keys in
# tiles of 64; tests/test_torch_cuda.py holds the kernel to this plain
# version on a card): (H, K, D, T, offsets, lengths, window, softcap) - G
# 1, 3, 4 and 16, D 64 and 256, T = 1 and T no multiple of the tile, a
# window edge inside a key tile, softcap.
EDGE_CASES = {
    "g1": (4, 4, 32, 24, [0, 21], [24, 10], None, None),
    "g3": (6, 2, 32, 48, [5, 40], [48, 30], None, None),
    "g4_window_in_tile": (8, 2, 32, 40, [37, 3], [40, 33], 20, None),
    "g16_softcap": (16, 1, 32, 16, [70, 0], [16, 9], None, 20.0),
    "d64_window_softcap": (4, 2, 64, 24, [10, 0], [24, 24], 30, 25.0),
    "d256": (2, 1, 256, 8, [50, 0], [8, 5], None, None),
    "t1": (8, 2, 32, 1, [0, 77], [1, 1], None, None),
}


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_flash_prefill_at_kernel_tile_edges_matches_jax_kernel(name):
    """Batch rows on cache rows [2, 0] of three whose cells past kv_valid
    hold NaN (a reused slot's stale K/V); the TPU kernel reads those rows
    zeroed there. Real rows match it, pad rows are 0. A T the TPU kernel
    does not take (not a multiple of 8) rides as the first rows of a chunk
    padded to a multiple of 8: rows attend causally, so those rows are the
    same."""
    H, K, D, T, offsets, lengths, window, softcap = EDGE_CASES[name]
    S = 256
    rng, k, v = cache_case(3, 3, S, K, D)
    rows = np.asarray([2, 0], np.int32)
    offsets = np.asarray(offsets, np.int32)
    valid = offsets + np.asarray(lengths, np.int32)
    clean_k, clean_v = k[rows], v[rows]
    for b, (r, n) in enumerate(zip(rows, valid)):
        clean_k[b, n:] = clean_v[b, n:] = 0.0
        k[r, n:] = v[r, n:] = np.nan
    q = rng.normal(size=(2, T, H, D)).astype(np.float32) * D ** -0.5
    t = torch.from_numpy
    ours = kattn.flash_prefill_attention(
        t(q), t(k), t(v), t(offsets), t(valid), sliding_window=window,
        softcap=softcap, rows=t(rows)).numpy()
    qj = np.concatenate([q, np.zeros((2, -T % 8, H, D), np.float32)], 1)
    ref = np.asarray(pattn.flash_prefill_attention(
        *(jnp.asarray(x) for x in (qj, clean_k, clean_v, offsets, valid)),
        sliding_window=window, softcap=softcap, interpret=True))
    assert np.isfinite(ours).all()
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(ours[b, :n], ref[b, :n], **TOL)
        assert not ours[b, n:].any()


@pytest.mark.parametrize("window,softcap", [(None, None), (48, 30.0)])
def test_row_map_reads_cache_rows_in_place(window, softcap):
    """`rows` maps batch rows onto a permutation of the cache's rows: the
    result equals the JAX kernels given the gathered rows k[rows]."""
    N, S, K, D, H = 6, 256, 2, 32, 8
    rng, k, v = cache_case(3, N, S, K, D)
    rows = np.asarray([4, 0, 5], np.int32)
    q = rng.normal(size=(3, 1, H, D)).astype(np.float32) * D ** -0.5
    valid = np.asarray([17, 256, 130], np.int32)
    ours, ref = run_decode(q, k, v, valid, window, softcap, rows)
    np.testing.assert_allclose(ours, ref, **TOL)
    qp = rng.normal(size=(3, 32, H, D)).astype(np.float32) * D ** -0.5
    offsets = np.asarray([0, 224, 90], np.int32)
    ours, ref = run_prefill(qp, k, v, offsets, offsets + 32, window,
                            softcap, rows)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_stale_cells_past_kv_valid_contribute_nothing():
    """A reused slot holds its previous occupant's K/V past kv_valid: NaN
    there gives the result of zeros there, for K8 and K9."""
    N, S, K, D = 3, 128, 2, 16
    rng, k, v = cache_case(4, N, S, K, D)
    rows = np.asarray([2, 0], np.int32)
    valid = np.asarray([70, 128], np.int32)
    dirty_k, dirty_v, clean_k, clean_v = k.copy(), v.copy(), k.copy(), \
        v.copy()
    for r, n in zip(rows, valid):
        dirty_k[r, n:] = dirty_v[r, n:] = np.nan
        clean_k[r, n:] = clean_v[r, n:] = 0.0
    t = torch.from_numpy
    q = t(rng.normal(size=(2, 1, 4, D)).astype(np.float32))
    qp = t(rng.normal(size=(2, 16, 4, D)).astype(np.float32))
    offs = t(valid - 16)
    dec = kattn.ragged_decode_attention(q, t(dirty_k), t(dirty_v),
                                        t(valid), rows=t(rows))
    pre = kattn.flash_prefill_attention(qp, t(dirty_k), t(dirty_v), offs,
                                        t(valid), rows=t(rows))
    dec_c = kattn.ragged_decode_attention(q, t(clean_k), t(clean_v),
                                          t(valid), rows=t(rows))
    pre_c = kattn.flash_prefill_attention(qp, t(clean_k), t(clean_v), offs,
                                          t(valid), rows=t(rows))
    assert torch.isfinite(dec).all() and torch.isfinite(pre).all()
    torch.testing.assert_close(dec, dec_c, atol=0, rtol=0)
    torch.testing.assert_close(pre, pre_c, atol=0, rtol=0)


# K9's split-KV schedule (csrc/decode_split.cuh, K1's spans on the slot
# cache) at its edges: (H, K, D, S, kv_valid of three rows, window,
# softcap) - kv_valid 1, CHUNK and CHUNK + 1 (decode_chunk: 128 in f32 at
# D = 64, 32 at D = 256), G 1, 4 and 16, a window edge inside a span and a
# window that leaves whole spans below it, softcap, a row at the cache end;
# the rows read a permutation of the cache's slots, NaN past kv_valid.
DECODE_EDGES = {
    "valid_1_chunk_chunk1": (8, 2, 64, 512, [1, 128, 129], None, None),
    "g1_cache_end": (4, 4, 64, 512, [32, 160, 512], None, None),
    "g16_window_in_split": (16, 1, 64, 512, [200, 300, 512], 50, None),
    "window_leaves_splits_below": (8, 2, 64, 512, [450, 500, 512], 100,
                                   None),
    "softcap": (8, 2, 64, 512, [5, 257, 400], None, 20.0),
    "d256_chunk_edges": (8, 2, 256, 128, [1, 32, 33], None, None),
    "d256_g16_window_softcap": (16, 1, 256, 256, [64, 100, 250], 40, 30.0),
}


@pytest.mark.parametrize("name", sorted(DECODE_EDGES))
def test_ragged_decode_split_at_edges_matches_jax_kernel(name):
    """decode_split_ref on the slot cache (NaN past each row's kv_valid in
    its slot) against the TPU kernel given the clean rows k[rows]."""
    H, K, D, S, valid, window, softcap = DECODE_EDGES[name]
    rng, k, v = cache_case(24, 5, S, K, D)
    rows = np.asarray([3, 0, 4], np.int32)
    valid = np.asarray(valid, np.int32)
    dirty_k, dirty_v = k.copy(), v.copy()
    for r, n in zip(rows, valid):
        dirty_k[r, n:] = dirty_v[r, n:] = np.nan
        k[r, n:] = v[r, n:] = 0.0
    q = rng.normal(size=(3, 1, H, D)).astype(np.float32) * D ** -0.5
    t = torch.from_numpy
    kw = dict(sliding_window=window, softcap=softcap)
    ours = kattn.decode_split_ref(t(q), t(dirty_k), t(dirty_v), t(valid),
                                  rows=t(rows), **kw).numpy()
    ref = np.asarray(pattn.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(k[rows]), jnp.asarray(v[rows]),
        jnp.asarray(valid), **kw, interpret=True))
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_is_one_computation_on_both_layouts(dtype):
    """K1 and K9 share their spans: the same cells through a page table
    and through a slot row give the same bits."""
    H, K, D, S, valid, window, softcap = DECODE_EDGES[
        "window_leaves_splits_below"]
    rng, k, v = cache_case(25, 3, S, K, D)
    ps = 32
    table = (rng.permutation(3 * S // ps) + 1).reshape(3, S // ps)
    pools = []
    for cache in (k, v):
        pool = np.zeros((1 + 3 * S // ps, ps, K, D), np.float32)
        pool[table.reshape(-1)] = cache.reshape(-1, ps, K, D)
        pools.append(torch.from_numpy(pool).to(dtype))
    q = torch.from_numpy(rng.normal(size=(3, 1, H, D)).astype(
        np.float32)).to(dtype)
    kw = dict(sliding_window=window, softcap=softcap)
    valid = torch.tensor(valid, dtype=torch.int32)
    slot = kattn.decode_split_ref(q, torch.from_numpy(k).to(dtype),
                                  torch.from_numpy(v).to(dtype), valid,
                                  **kw)
    paged = kattn.decode_split_ref(q, *pools, valid, **kw,
                                   table=torch.from_numpy(table.astype(
                                       np.int32)))
    assert torch.equal(slot, paged)


def test_wrappers_refuse_what_they_do_not_take():
    q = torch.zeros(2, 1, 4, 16)
    cache = torch.zeros(3, 32, 2, 16)
    valid = torch.ones(2, dtype=torch.int32)
    with pytest.raises(IndexError):      # JAX clamps; the port raises
        kattn.ragged_decode_attention(
            q, cache, cache, valid, rows=torch.tensor([0, 3],
                                                      dtype=torch.int32))
    with pytest.raises(IndexError):
        kattn.flash_prefill_attention(
            q, cache, cache, valid - 1, valid,
            rows=torch.tensor([-1, 0], dtype=torch.int32))
    with pytest.raises(ValueError):      # no rows: caches hold B rows
        kattn.ragged_decode_attention(q, cache, cache, valid)
    with pytest.raises(ValueError):
        kattn.ragged_decode_attention(torch.zeros(2, 3, 4, 16), cache,
                                      cache, valid)
    with pytest.raises(ValueError):
        kattn.flash_prefill_attention(q, cache, cache[..., :8], valid,
                                      valid, rows=valid)
    # the CPU gate declines nothing, whatever T and S
    assert kattn.contiguous_decline_reason(37, 24, 5, "cpu") is None


# --- forward_cached against the JAX programs ---


@pytest.mark.parametrize("model,impl", [("tiny-llama", "flash"),
                                        ("tiny-mistral", "flash"),
                                        ("tiny-gemma", "dense")])
def test_forward_cached_matches_jax_forward(model, impl):
    """A prefill chunk at per-row offsets into slots 3 and 1, then two
    decode steps, against JAX forward on the gathered slots (its
    prefill_step/cached_step); the cache rows afterwards match too. One
    row's chunk ends exactly at the cache end."""
    import dataclasses
    jcfg = dataclasses.replace(jax_config(model, max_seq_len=128),
                               attn_impl=impl)
    tcfg = dataclasses.replace(torch_config(model, max_seq_len=128),
                               attn_impl=impl)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_numpy(jax.device_get(jparams), tcfg,
                                torch.float32, "cpu")
    kv = KVCache(tcfg, 4, 128, torch.float32, "cpu")
    rows = np.asarray([3, 1], np.int32)
    rng = np.random.default_rng(5)
    jcache = [(jnp.asarray(rng.normal(size=k.shape).astype(np.float32)),
               jnp.asarray(rng.normal(size=k.shape).astype(np.float32)))
              for k, _ in kv.layers]
    for (k, v), (jk, jv) in zip(kv.layers, jcache):
        k.copy_(torch.from_numpy(np.array(jk)))
        v.copy_(torch.from_numpy(np.array(jv)))
    T = 32
    offsets = np.asarray([10, 128 - T], np.int32)
    lengths = np.asarray([20, 32], np.int32)
    tokens = rng.integers(3, tcfg.vocab_size, size=(2, T)).astype(np.int32)
    t = torch.from_numpy
    for step in range(3):
        positions = offsets[:, None] + np.arange(tokens.shape[1])[None]
        valid = offsets + lengths
        last = lengths - 1
        jb = [(k[rows], v[rows]) for k, v in jcache]
        jl, jb = jax_forward(jparams, jcfg, jnp.asarray(tokens),
                             jnp.asarray(positions), jb,
                             jnp.asarray(offsets), jnp.asarray(valid),
                             last_pos=jnp.asarray(last))
        jcache = [(k.at[rows].set(nk), v.at[rows].set(nv))
                  for (k, v), (nk, nv) in zip(jcache, jb)]
        tl = forward_cached(tparams, tcfg, t(tokens).long(),
                            t(positions.astype(np.int32)), kv.layers,
                            t(rows), t(offsets), t(valid), last_pos=t(last))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        nxt = tl[:, 0].argmax(-1).numpy().astype(np.int32)
        tokens, offsets = nxt[:, None], valid
        lengths = np.ones(2, np.int32)
        if step == 0:   # the cache-end row decodes no further
            offsets = np.asarray([valid[0], valid[0] + 40], np.int32)
    # Live cells match; cells past kv_valid hold pad rows' K/V, which
    # differ past the first layer (K8 writes pad rows' outputs as 0, JAX
    # leaves garbage) and are never read.
    live = [(r, int(n)) for r, n in zip(rows, offsets)] + [(0, 128),
                                                           (2, 128)]
    for (k, v), (jk, jv) in zip(kv.layers, jcache):
        for r, n in live:
            for ours, ref in ((k, jk), (v, jv)):
                np.testing.assert_allclose(ours[r, :n].numpy(),
                                           np.asarray(ref)[r, :n],
                                           atol=1e-5, rtol=1e-5)


def test_forward_cached_refuses_a_write_past_the_cache_end():
    """JAX's dynamic_update_slice clamps an overrunning start and
    overwrites earlier cells; the port raises instead."""
    cfg = torch_config("tiny-llama", max_seq_len=64)
    kv = KVCache(cfg, 2, 64, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(0)
    from theroundtaible_tpu_torch.engine.models.common import init_params
    params = init_params(cfg, gen, torch.float32, "cpu")
    toks = torch.ones(1, 8, dtype=torch.long)
    pos = torch.arange(60, 68, dtype=torch.int32)[None]
    i32 = lambda *x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    with pytest.raises(IndexError, match="overruns"):
        forward_cached(params, cfg, toks, pos, kv.layers, i32(0), i32(60),
                       i32(68))
    with pytest.raises(IndexError, match="rows"):
        forward_cached(params, cfg, toks, pos - 60, kv.layers, i32(2),
                       i32(0), i32(8))


# --- engines against the JAX engine ---

SHARED = ("the common context paragraph that every knight receives before "
          "their personal instructions begin here. ")
LONG = {"a": "alpha beta gamma delta " * 14, "b": "omega sigma tau " * 16}


@pytest.fixture(scope="module", params=[
    ("tiny-llama", "flash"), ("tiny-llama", "auto"),
    ("tiny-mistral", "flash"), ("tiny-mistral", "auto"),
    ("tiny-gemma", "flash"), ("tiny-gemma", "auto")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def engines(request):
    model, attn = request.param
    jeng = JaxEngine(jax_config(model, max_seq_len=MAX_SEQ),
                     mesh_shape={"data": 1, "model": 1}, num_slots=4,
                     kv_layout="contiguous", attn=attn, dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0,
                                          max_new_tokens=8), **OFF)
    cfg = torch_config(model, max_seq_len=MAX_SEQ)
    teng = InferenceEngine(
        cfg, num_slots=4, attn=attn, dtype=torch.float32,
        sampling=SamplingParams(temperature=0.0, max_new_tokens=8),
        params=params_from_numpy(jax.device_get(jeng.params), cfg,
                                 torch.float32, "cpu"),
        device="cpu")
    # "auto" is dense off a TPU and off a card, in both packages
    assert teng.cfg.attn_impl == jeng.cfg.attn_impl == (
        "flash" if attn == "flash" else "dense")
    return jeng, teng


def _records(eng, names):
    return {n: list(eng.kv._slots[n].tokens) for n in names}


def _both(engines, turns, max_new=8):
    """generate_batch on both engines; asserts identical responses, slot
    records, reused and prefill token counts. Returns the port's stats."""
    jeng, teng = engines
    out_j, stats_j = jeng.generate_batch_with_stats(turns,
                                                    max_new_tokens=max_new)
    out_t, stats_t = teng.generate_batch_with_stats(turns,
                                                    max_new_tokens=max_new)
    assert out_t == out_j
    names = [n for n, _ in turns]
    assert _records(teng, names) == _records(jeng, names)
    assert stats_t.reused_tokens == stats_j.reused_tokens
    assert stats_t.prefill_tokens == stats_j.prefill_tokens
    # slot ids follow the same LRU allocation
    assert {n: teng.kv._slots[n].slot_id for n in names} == \
        {n: jeng.kv._slots[n].slot_id for n in names}
    return stats_t


def test_single_generate_parity(engines):
    stats = _both(engines, [("solo", "the knights debate the session "
                                     "store design at length")])
    assert stats.decode_tokens > 0 and stats.reused_tokens == 0


def test_multiturn_delta_prefill_parity(engines):
    base = "round one establishes the shared context for everyone here."
    _both(engines, [("k", base)])
    stats = _both(engines, [("k", base + " round two adds new arguments "
                                         "and asks for a score.")])
    assert stats.reused_tokens > len(base) // 2


def test_shared_prefix_batch_parity(engines):
    """The leader prefills the 3-knight batch's common span once; the
    others take it by K/V span copies between slots."""
    stats = _both(engines, [(f"kn{i}", SHARED + f"You are knight {i}.")
                            for i in range(3)])
    assert stats.reused_tokens >= 2 * 64


def test_donor_copy_across_calls_parity(engines):
    """A slot committed by an earlier call donates its span to a fresh
    knight of the next call (the donor pass)."""
    _both(engines, [("donor", SHARED + "The donor speaks first.")])
    stats = _both(engines, [("taker", SHARED + "The taker answers.")])
    assert stats.reused_tokens >= 64


def test_prompts_reaching_the_cache_end_parity(engines):
    """A full-prefix hit at offset 190 beside a fresh 191-token prompt
    (both tail-truncated to the prompt budget): the 256 bucket shrinks to
    64 so the first row's pad chunks stay inside the cache (they reach
    position 254 of 255)."""
    _both(engines, [("a", LONG["a"])])
    stats = _both(engines, [("a", LONG["a"]), ("b", LONG["b"])])
    assert stats.reused_tokens == MAX_SEQ - 64 - 2


# --- default config ---


def test_from_config_defaults_to_contiguous_in_both_packages():
    config = {"model": "tiny-llama", "max_seq_len": 128,
              "mesh": {"data": 1, "model": 1}, "prefix_cache": False,
              "kv_offload": False, "spec_decode": False}
    jd = JaxEngine.from_config(dict(config)).describe()
    tport = InferenceEngine.from_config(
        {k: v for k, v in config.items()
         if k not in ("prefix_cache", "kv_offload", "spec_decode")},
        device="cpu")
    td = tport.describe()
    assert td["kv_layout"] == jd["kv_layout"] == "contiguous"
    for key in ("model", "params", "max_seq_len", "num_slots"):
        assert td[key] == jd[key], key
    # no page keys on a contiguous engine, in either package
    for key in ("page_size", "num_pages", "paged_decode", "ragged"):
        assert key not in td and key not in jd, key
    assert td["attn"] == "dense"       # "auto" off a card
    # 2 layers x (K, V) x 8 slots x 128 positions x 2 kv heads x 16 x bf16
    assert td["kv_hbm_bytes"] == tport.kv.memory_ledger()["hbm_bytes"] \
        == 2 * 2 * 8 * 128 * 2 * 16 * 2
    assert tport.ragged_enabled is False and tport.ragged_reason is None


# --- the scheduler on a contiguous engine ---

SESSIONS = {
    "s0": [("lancelot", "The round table met at dawn to discuss the "
                        "castle walls and the eastern gate.")],
    "s1": [("galahad", "A different discussion entirely, about dragons "
                       "and the kingdom's gold reserves."),
           ("percival", "A different discussion entirely, about dragons "
                        "and the kingdom's gold reserves. Percival counts "
                        "the coins.")],
}


def _join_mid_decode(sched, max_new=70):
    """s0 first; s1 once s0 has live rows, so it joins mid-decode."""
    results, errors = {}, {}

    def run(sid, wait_active):
        try:
            if wait_active:
                deadline = time.monotonic() + 60
                while not sched._active and time.monotonic() < deadline:
                    time.sleep(0.002)
            results[sid] = sched.submit(sid, SESSIONS[sid],
                                        max_new_tokens=max_new)
        except Exception as e:  # noqa: BLE001 - asserted by the caller
            errors[sid] = e

    threads = [threading.Thread(target=run, args=(sid, i > 0))
               for i, sid in enumerate(SESSIONS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=240)
    return results, errors


def test_scheduler_on_contiguous_engine_matches_jax_scheduler():
    """Two sessions, the second joining while the first decodes, through
    each package's SessionScheduler on a contiguous engine (blocking
    prologue admission, pad rows on a scratch slot): identical greedy
    tokens."""
    jeng = JaxEngine(jax_config("tiny-llama", max_seq_len=512),
                     mesh_shape={"data": 1, "model": 1}, num_slots=8,
                     kv_layout="contiguous", dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0,
                                          max_new_tokens=8), **OFF)
    cfg = torch_config("tiny-llama", max_seq_len=512)
    teng = InferenceEngine(
        cfg, num_slots=8, dtype=torch.float32,
        sampling=SamplingParams(temperature=0.0, max_new_tokens=8),
        params=params_from_numpy(jax.device_get(jeng.params), cfg,
                                 torch.float32, "cpu"),
        device="cpu")
    outs = {}
    for name, eng, make in (("jax", jeng, JaxScheduler),
                            ("torch", teng, SessionScheduler)):
        sched = make(eng)
        try:
            results, errors = _join_mid_decode(sched)
            assert not errors, (name, errors)
            d = sched.describe()
            assert d["completed"] == 2 and d["ragged_joins"] == 0
            assert d["max_occupancy"] >= 2, name
        finally:
            sched.close()
        outs[name] = {sid: results[sid][0] for sid in SESSIONS}
    assert outs["torch"] == outs["jax"]
    assert teng.describe()["scheduler"]["completed"] == 2
