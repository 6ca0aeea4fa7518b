"""PyTorch port, kernels K1/K2: the plain versions of paged decode and
paged prefill attention against the JAX package's Pallas kernels (run in
interpret mode on the CPU), on the cases of tests/test_pallas.py. The same
numpy inputs go to both; f32, atol=rtol=5e-5 as the JAX kernel tests use.
The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theroundtaible_tpu.engine.pallas.attention import (
    paged_decode_attention as jax_paged_decode,
    paged_prefill_attention as jax_paged_prefill)
from theroundtaible_tpu_torch.engine.kernels import attention as kattn

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
