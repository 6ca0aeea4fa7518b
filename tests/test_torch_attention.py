"""PyTorch port, kernels K1/K2: the plain versions of paged decode and
paged prefill attention against the JAX package's Pallas kernels (run in
interpret mode on the CPU), on the cases of tests/test_pallas.py and, for
K2, at the edges of the CUDA kernel's tensor-core tile; K1's split-KV
schedule (decode_split_ref) at the edges of its spans. The same numpy
inputs go to both; f32, atol=rtol=5e-5 as the JAX kernel tests use.
The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theroundtaible_tpu.engine.pallas.attention import (
    paged_decode_attention as jax_paged_decode,
    paged_prefill_attention as jax_paged_prefill)
from theroundtaible_tpu_torch.engine.kernels import attention as kattn
from theroundtaible_tpu_torch.engine.kv_quant import (KVQuantSpec,
                                                      quantize_cells)

TOL = dict(atol=5e-5, rtol=5e-5)
WINDOW_SOFTCAP = [(None, None), (48, None), (None, 30.0), (700, None),
                  (48, 30.0)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers' timing tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shuffled_pool(rng, B, S, K, D, ps, dtype=np.float32):
    """Per-row position-aligned views scattered into a pool at shuffled
    page ids (page 0 reserved scratch, like the allocator)."""
    n_pages = S // ps
    k_view = rng.normal(size=(B, S, K, D)).astype(dtype)
    v_view = rng.normal(size=(B, S, K, D)).astype(dtype)
    table = (rng.permutation(B * n_pages) + 1).reshape(B, n_pages)
    k_pool = np.zeros((1 + B * n_pages, ps, K, D), dtype)
    v_pool = np.zeros_like(k_pool)
    k_pool[table.reshape(-1)] = k_view.reshape(B * n_pages, ps, K, D)
    v_pool[table.reshape(-1)] = v_view.reshape(B * n_pages, ps, K, D)
    return k_pool, v_pool, table.astype(np.int32)


def run_decode(q, k_pool, v_pool, table, valid, window, softcap):
    ours = kattn.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(table),
        torch.from_numpy(valid), sliding_window=window, softcap=softcap)
    ref = jax_paged_decode(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(table), jnp.asarray(valid), sliding_window=window,
        softcap=softcap, interpret=True)
    return ours.numpy(), np.asarray(ref)


def run_prefill(q, k_pool, v_pool, table, offsets, valid, window, softcap):
    ours = kattn.paged_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(table),
        torch.from_numpy(offsets), torch.from_numpy(valid),
        sliding_window=window, softcap=softcap)
    ref = jax_paged_prefill(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(table), jnp.asarray(offsets), jnp.asarray(valid),
        sliding_window=window, softcap=softcap, interpret=True)
    return ours.numpy(), np.asarray(ref)


@pytest.mark.parametrize("window,softcap", WINDOW_SOFTCAP)
@pytest.mark.parametrize("heads", [8, 2])   # GQA group 4, and MHA
def test_paged_decode_matches_jax_kernel(window, softcap, heads):
    B, S, K, D, ps = 3, 1024, 2, 32, 64
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, 1, heads, D)).astype(np.float32)
    k_pool, v_pool, table = shuffled_pool(rng, B, S, K, D, ps)
    # rows below, at, and beyond a page boundary and the full length
    valid = np.asarray([1, 512, 1024], np.int32)
    ours, ref = run_decode(q, k_pool, v_pool, table, valid, window, softcap)
    assert ours.shape == q.shape
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("window,softcap", WINDOW_SOFTCAP)
def test_paged_prefill_matches_jax_kernel(window, softcap):
    """Delta-prefill offsets and partial lengths off a shuffled pool;
    only each row's real query rows are compared (pad rows are garbage
    the engine drops)."""
    B, T, H, K, D, S, ps = 3, 192, 8, 2, 32, 1024, 64
    rng = np.random.default_rng(5)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k_pool, v_pool, table = shuffled_pool(rng, B, S, K, D, ps)
    offsets = np.asarray([0, 10, 600], np.int32)
    lengths = np.asarray([192, 40, 192], np.int32)
    valid = offsets + lengths
    ours, ref = run_prefill(q, k_pool, v_pool, table, offsets, valid,
                            window, softcap)
    assert ours.shape == q.shape
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(ours[b, :n], ref[b, :n], **TOL)


def test_nan_pages_beyond_frontier_are_never_read():
    """Pages past each row's frontier page hold NaN (garbage); both
    versions keep them out, and ours agrees with the TPU kernel."""
    B, S, K, D, ps = 2, 512, 1, 32, 64
    n_pages = S // ps
    rng = np.random.default_rng(4)
    q = rng.normal(size=(B, 1, 4, D)).astype(np.float32)
    view = rng.normal(size=(B, S, K, D)).astype(np.float32)
    valid = np.asarray([70, 300], np.int32)
    table = np.arange(1, 1 + B * n_pages, dtype=np.int32).reshape(B, n_pages)
    pool = np.full((1 + B * n_pages, ps, K, D), np.nan, np.float32)
    pool[table.reshape(-1)] = view.reshape(B * n_pages, ps, K, D)
    for b in range(B):
        for j in range((int(valid[b]) - 1) // ps + 1, n_pages):
            pool[table[b, j]] = np.nan
    ours, ref = run_decode(q, pool, pool.copy(), table, valid, None, None)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, **TOL)
    # the same pool as a prefill chunk ending at each row's frontier
    qp = rng.normal(size=(B, 16, 4, D)).astype(np.float32)
    offsets = valid - 16
    ours, ref = run_prefill(qp, pool, pool.copy(), table, offsets, valid,
                            None, None)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, **TOL)


def test_stale_cells_of_the_frontier_page_contribute_nothing():
    """Cells at or past kv_valid INSIDE the frontier page are stale and
    may hold NaN: the result equals the one with those cells zeroed."""
    B, S, K, D, ps = 2, 256, 2, 16, 64
    rng = np.random.default_rng(7)
    k_pool, v_pool, table = shuffled_pool(rng, B, S, K, D, ps)
    valid = np.asarray([70, 129], np.int32)
    clean_k, clean_v = k_pool.copy(), v_pool.copy()
    for b in range(B):
        for pos in range(int(valid[b]), S):
            page, off = table[b, pos // ps], pos % ps
            k_pool[page, off] = np.nan
            v_pool[page, off] = np.nan
            clean_k[page, off] = 0.0
            clean_v[page, off] = 0.0
    q = rng.normal(size=(B, 1, 4, D)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (q, k_pool, v_pool, table, valid)]
    dirty = kattn.paged_decode_attention(*args)
    clean = kattn.paged_decode_attention(
        args[0], torch.from_numpy(clean_k), torch.from_numpy(clean_v),
        args[3], args[4])
    assert torch.isfinite(dirty).all()
    torch.testing.assert_close(dirty, clean, atol=0, rtol=0)


# --- K2 at the edges of the CUDA kernel's tensor-core tile ---
# On a card K2's bf16 body works in tiles of 64 query rows (G heads x 64/G
# chunk rows per warpgroup, two warpgroups per block) against keys in tiles
# of 64, and tests/test_torch_cuda.py holds it to this plain version there.
# Here the plain version meets the TPU kernel at the same edges: (H, K, D,
# ps, T, offsets, lengths, window, softcap) - G 1, 3, 4 and 16, D 64 and
# 256, pages of 16 and 32 (a key tile spans pages), T = 1 and T no
# multiple of the tile, chunks starting mid-page, a window edge inside a
# key tile, softcap.
EDGE_CASES = {
    "g1_ps16": (4, 4, 32, 16, 24, [0, 21], [24, 10], None, None),
    "g3_mid_page": (6, 2, 32, 32, 48, [5, 40], [48, 30], None, None),
    "g4_window_in_tile": (8, 2, 32, 16, 40, [37, 3], [40, 33], 20, None),
    "g16_softcap": (16, 1, 32, 32, 16, [70, 0], [16, 9], None, 20.0),
    "d64_window_softcap": (4, 2, 64, 16, 24, [10, 0], [24, 24], 30, 25.0),
    "d256": (2, 1, 256, 32, 8, [50, 0], [8, 5], None, None),
    "t1": (8, 2, 32, 16, 1, [0, 77], [1, 1], None, None),
}
EDGE_S = 256


def edge_inputs(name, seed):
    """An EDGE_CASES entry's q and its pools twice: `clean` with every cell
    at or past a row's kv_valid zeroed (the TPU kernel reads the frontier
    page's tail), `dirty` with NaN there (the port must never load it)."""
    H, K, D, ps, T, offsets, lengths, _, _ = EDGE_CASES[name]
    rng = np.random.default_rng(seed)
    k_pool, v_pool, table = shuffled_pool(rng, 2, EDGE_S, K, D, ps)
    offsets = np.asarray(offsets, np.int32)
    valid = offsets + np.asarray(lengths, np.int32)
    clean, dirty = [k_pool, v_pool], [k_pool.copy(), v_pool.copy()]
    for b in range(2):
        for j in range(EDGE_S // ps):
            lo = max(int(valid[b]) - j * ps, 0)
            if lo < ps:
                for pool in clean:
                    pool[table[b, j], lo:] = 0.0
                for pool in dirty:
                    pool[table[b, j], lo:] = np.nan
    q = rng.normal(size=(2, T, H, D)).astype(np.float32)
    return rng, q, clean, dirty, table, offsets, valid


def jax_rows(q):
    """q for the TPU kernel, which takes T in multiples of 8: a shorter
    chunk rides as the first rows of an 8-row one (rows attend causally,
    so those rows are the same)."""
    pad = -q.shape[1] % 8
    return np.concatenate([q, np.zeros((q.shape[0], pad) + q.shape[2:],
                                       q.dtype)], axis=1)


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_paged_prefill_at_kernel_tile_edges_matches_jax_kernel(name):
    *_, lengths, window, softcap = EDGE_CASES[name]
    _, q, clean, dirty, table, offsets, valid = edge_inputs(name, 9)
    ours = kattn.paged_prefill_attention(
        *(torch.from_numpy(x) for x in (q, *dirty, table, offsets, valid)),
        sliding_window=window, softcap=softcap).numpy()
    ref = np.asarray(jax_paged_prefill(
        *(jnp.asarray(x) for x in (jax_rows(q), *clean, table, offsets,
                                   valid)),
        sliding_window=window, softcap=softcap, interpret=True))
    for b, n in enumerate(lengths):
        assert np.isfinite(ours[b, :n]).all()
        np.testing.assert_allclose(ours[b, :n], ref[b, :n], **TOL)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", ["g3_mid_page", "g4_window_in_tile",
                                  "d64_window_softcap"])
def test_quantized_paged_prefill_at_kernel_tile_edges_matches_jax(name,
                                                                   bits):
    """The same edges on int8/int4 pages (K4): the TPU kernel gets the
    clean cells quantized, the port random payloads and NaN scales past
    kv_valid."""
    ps, *_, lengths, window, softcap = EDGE_CASES[name][3:]
    rng, q, clean, _, table, offsets, valid = edge_inputs(name, 10)
    spec = KVQuantSpec(bits=bits)
    jax_pools, port_pools = [], []
    for pool in clean:
        qc, sc = (x.numpy() for x in quantize_cells(torch.from_numpy(pool),
                                                    spec))
        qd, sd = qc.copy(), sc.copy()
        for b in range(2):
            for j in range(EDGE_S // ps):
                lo = max(int(valid[b]) - j * ps, 0)
                if lo < ps:
                    qd[table[b, j], lo:] = rng.integers(
                        -128, 128, size=qd[table[b, j], lo:].shape)
                    sd[table[b, j], lo:] = np.nan
        jax_pools.append((qc, sc))
        port_pools.append((qd, sd))
    (tk, tks), (tv, tvs) = ((torch.from_numpy(x) for x in p)
                            for p in port_pools)
    ours = kattn.paged_prefill_attention(
        torch.from_numpy(q), tk, tv,
        *(torch.from_numpy(x) for x in (table, offsets, valid)),
        sliding_window=window, softcap=softcap, k_scale=tks, v_scale=tvs,
        kv_bits=bits).numpy()
    (jk, jks), (jv, jvs) = ((jnp.asarray(x) for x in p) for p in jax_pools)
    ref = np.asarray(jax_paged_prefill(
        jnp.asarray(jax_rows(q)), jk, jv,
        *(jnp.asarray(x) for x in (table, offsets, valid)),
        sliding_window=window, softcap=softcap, interpret=True,
        k_scale=jks, v_scale=jvs, kv_bits=bits))
    for b, n in enumerate(lengths):
        assert np.isfinite(ours[b, :n]).all()
        np.testing.assert_allclose(ours[b, :n], ref[b, :n], **TOL)


# --- K1's split-KV schedule (csrc/decode_split.cuh) at its edges ---
# On a card K1 splits each row's positions into spans of
# decode_chunk(D, dtype) aligned to position 0 (128 in f32 at D = 64, 32
# at D = 256), computes each live span's (m, l, acc) and merges them in
# order; decode_split_ref models that schedule and tests/test_torch_cuda.py
# holds the kernel to it. Here the model meets the TPU kernel: (H, K, D, ps,
# S, kv_valid of three rows, window, softcap) - kv_valid 1, CHUNK and
# CHUNK + 1, page ends at ps 16 and 32, G 1, 4 and 16, D 64 and 256, a
# window edge inside a span and a window that leaves whole spans below it,
# softcap; NaN in every cell past kv_valid.
DECODE_EDGES = {
    "valid_1_chunk_chunk1_ps16": (8, 2, 64, 16, 512, [1, 128, 129], None,
                                  None),
    "g1_page_ends_ps32": (4, 4, 64, 32, 512, [32, 160, 512], None, None),
    "g16_window_in_split": (16, 1, 64, 16, 512, [200, 300, 512], 50, None),
    "window_leaves_splits_below": (8, 2, 64, 32, 512, [450, 500, 512], 100,
                                   None),
    "softcap": (8, 2, 64, 16, 512, [5, 257, 400], None, 20.0),
    "d256_chunk_edges": (8, 2, 256, 16, 128, [1, 32, 33], None, None),
    "d256_g16_window_softcap": (16, 1, 256, 32, 256, [64, 100, 250], 40,
                                30.0),
}


def decode_edge_inputs(name, seed):
    """A DECODE_EDGES case's q and pools, `clean` (zeros past kv_valid, what
    the TPU kernel reads) and `dirty` (NaN there, never to be loaded)."""
    H, K, D, ps, S, valid, _, _ = DECODE_EDGES[name]
    rng = np.random.default_rng(seed)
    k_pool, v_pool, table = shuffled_pool(rng, 3, S, K, D, ps)
    valid = np.asarray(valid, np.int32)
    clean, dirty = [k_pool, v_pool], [k_pool.copy(), v_pool.copy()]
    for b in range(3):
        for j in range(S // ps):
            lo = max(int(valid[b]) - j * ps, 0)
            if lo < ps:
                for pool in clean:
                    pool[table[b, j], lo:] = 0.0
                for pool in dirty:
                    pool[table[b, j], lo:] = np.nan
    q = rng.normal(size=(3, 1, H, D)).astype(np.float32) * D ** -0.5
    return rng, q, clean, dirty, table, valid


@pytest.mark.parametrize("name", sorted(DECODE_EDGES))
def test_decode_split_at_edges_matches_jax_kernel(name):
    """decode_split_ref (and the wrapper's plain version) on the NaN pools
    against the TPU kernel on the clean ones."""
    *_, window, softcap = DECODE_EDGES[name]
    _, q, clean, dirty, table, valid = decode_edge_inputs(name, 21)
    port = [torch.from_numpy(x) for x in (q, *dirty, table, valid)]
    kw = dict(sliding_window=window, softcap=softcap)
    split = kattn.decode_split_ref(port[0], port[1], port[2], port[4],
                                   table=port[3], **kw).numpy()
    plain = kattn.paged_decode_attention(*port, **kw).numpy()
    ref = np.asarray(jax_paged_decode(
        *(jnp.asarray(x) for x in (q, *clean, table, valid)), **kw,
        interpret=True))
    assert np.isfinite(split).all()
    np.testing.assert_allclose(split, ref, **TOL)
    np.testing.assert_allclose(plain, ref, **TOL)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", ["valid_1_chunk_chunk1_ps16",
                                  "window_leaves_splits_below",
                                  "d256_g16_window_softcap"])
def test_quantized_decode_split_at_edges_matches_jax(name, bits):
    """The same edges on int8/int4 pages (K4 inside K1): the TPU kernel gets
    the clean cells quantized, the model random payloads and NaN scales
    past kv_valid."""
    ps, S, _, window, softcap = DECODE_EDGES[name][3:]
    rng, q, clean, _, table, valid = decode_edge_inputs(name, 22)
    spec = KVQuantSpec(bits=bits)
    jax_pools, port_pools = [], []
    for pool in clean:
        qc, sc = (x.numpy() for x in quantize_cells(torch.from_numpy(pool),
                                                    spec))
        qd, sd = qc.copy(), sc.copy()
        for b in range(3):
            for j in range(S // ps):
                lo = max(int(valid[b]) - j * ps, 0)
                if lo < ps:
                    qd[table[b, j], lo:] = rng.integers(
                        -128, 128, size=qd[table[b, j], lo:].shape)
                    sd[table[b, j], lo:] = np.nan
        jax_pools.append((qc, sc))
        port_pools.append((qd, sd))
    (tk, tks), (tv, tvs) = ((torch.from_numpy(x) for x in p)
                            for p in port_pools)
    ours = kattn.decode_split_ref(
        torch.from_numpy(q), tk, tv, torch.from_numpy(valid),
        table=torch.from_numpy(table), sliding_window=window,
        softcap=softcap, k_scale=tks, v_scale=tvs, kv_bits=bits).numpy()
    (jk, jks), (jv, jvs) = ((jnp.asarray(x) for x in p) for p in jax_pools)
    ref = np.asarray(jax_paged_decode(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(valid),
        sliding_window=window, softcap=softcap, interpret=True,
        k_scale=jks, v_scale=jvs, kv_bits=bits))
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["g1_page_ends_ps32",
                                  "window_leaves_splits_below",
                                  "d256_chunk_edges"])
def test_decode_split_shard_equals_full_slice(name, dtype):
    """K10b's premise: one shard's kv heads (and their query heads) give
    the bits of the full-head call's slice, the spans being the same."""
    H, K, *_, window, softcap = DECODE_EDGES[name]
    _, q, _, dirty, table, valid = decode_edge_inputs(name, 23)
    q, k, v = (torch.from_numpy(x).to(dtype) for x in (q, *dirty))
    table, valid = torch.from_numpy(table), torch.from_numpy(valid)
    kw = dict(table=table, sliding_window=window, softcap=softcap)
    full = kattn.decode_split_ref(q, k, v, valid, **kw)
    half_h, half_k = H // 2 if K > 1 else H, max(K // 2, 1)
    shard = kattn.decode_split_ref(
        q[:, :, H - half_h:].contiguous(), k[:, :, K - half_k:].contiguous(),
        v[:, :, K - half_k:].contiguous(), valid, **kw)
    assert torch.equal(shard, full[:, :, H - half_h:])


def test_wrappers_refuse_what_they_do_not_take():
    q = torch.zeros(2, 1, 4, 16)
    pool = torch.zeros(5, 16, 2, 16)
    table = torch.ones(2, 4, dtype=torch.int32)
    valid = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int8 payloads"):
        kattn.paged_decode_attention(q, pool, pool, table, valid,
                                     k_scale=pool, v_scale=pool)
    with pytest.raises(ValueError):
        kattn.paged_decode_attention(torch.zeros(2, 3, 4, 16), pool, pool,
                                     table, valid)
    with pytest.raises(ValueError):
        kattn.paged_prefill_attention(q, pool, pool[:, :, :1], table, valid,
                                      valid)
    with pytest.raises(ValueError):
        kattn.paged_decode_attention(q, pool.double(), pool.double(), table,
                                     valid)


def test_gates_take_any_shape_on_the_cpu():
    """As interpret mode does for the TPU gates: the plain versions serve
    any shape, so the CPU gates decline nothing."""
    assert kattn.paged_decode_supported(48, 24, 3, 5)
    assert kattn.paged_prefill_supported(100, 48, 24, 3, 5)
    assert kattn.paged_pool_direct_supported(2048, 32, 16, 2, 2)
