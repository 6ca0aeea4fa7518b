"""PyTorch port, CUDA kernels K1/K2/K3/K8/K9 against their plain versions
on the card (`cuda` marker; each test skips itself where there is no card).
The
file imports neither jax nor the JAX package, so it runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from theroundtaible_tpu_torch.engine.kernels import attention as kattn

WINDOW_SOFTCAP = [(None, None), (48, None), (None, 30.0), (700, None),
                  (48, 30.0)]


def shuffled_pool(rng, B, S, K, D, ps):
    """Per-row position-aligned views scattered into a pool at shuffled
    page ids (page 0 reserved scratch)."""
    n_pages = S // ps
    k_view = rng.normal(size=(B, S, K, D)).astype(np.float32)
    v_view = rng.normal(size=(B, S, K, D)).astype(np.float32)
    table = (rng.permutation(B * n_pages) + 1).reshape(B, n_pages)
    k_pool = np.zeros((1 + B * n_pages, ps, K, D), np.float32)
    v_pool = np.zeros_like(k_pool)
    k_pool[table.reshape(-1)] = k_view.reshape(B * n_pages, ps, K, D)
    v_pool[table.reshape(-1)] = v_view.reshape(B * n_pages, ps, K, D)
    return k_pool, v_pool, table.astype(np.int32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# bf16: p and the output round to bf16 and sums run in another order;
# f32: only the summation order differs.
DTYPES = [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_decode_kernel_matches_plain(cuda_device, dtype, tol):
    """K1 against its plain version on the card at the serving shape
    (H=32, K=8, D=128, ps=128)."""
    B, S, K, D, ps = 4, 2048, 8, 128, 128
    rng = np.random.default_rng(11)
    k_pool, v_pool, table = shuffled_pool(rng, B, S, K, D, ps)
    q = rng.normal(size=(B, 1, 32, D)).astype(np.float32) * D ** -0.5
    valid = np.asarray([1, 129, 1000, 2048], np.int32)
    dev = cuda_device
    args = [torch.from_numpy(q).to(dev, dtype),
            torch.from_numpy(k_pool).to(dev, dtype),
            torch.from_numpy(v_pool).to(dev, dtype),
            torch.from_numpy(table).to(dev), torch.from_numpy(valid).to(dev)]
    for window, softcap in WINDOW_SOFTCAP:
        out = kattn.paged_decode_attention(*args, sliding_window=window,
                                           softcap=softcap)
        ref = kattn.paged_decode_attention_ref(
            *args, sliding_window=window, softcap=softcap)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_prefill_kernel_matches_plain(cuda_device, dtype, tol):
    """K2 against its plain version on the card, offsets and partial
    lengths; real rows only."""
    B, T, K, D, S, ps = 3, 256, 8, 128, 2048, 128
    rng = np.random.default_rng(12)
    k_pool, v_pool, table = shuffled_pool(rng, B, S, K, D, ps)
    q = rng.normal(size=(B, T, 32, D)).astype(np.float32) * D ** -0.5
    offsets = np.asarray([0, 100, 1700], np.int32)
    lengths = np.asarray([256, 77, 256], np.int32)
    dev = cuda_device
    args = [torch.from_numpy(q).to(dev, dtype),
            torch.from_numpy(k_pool).to(dev, dtype),
            torch.from_numpy(v_pool).to(dev, dtype),
            torch.from_numpy(table).to(dev),
            torch.from_numpy(offsets).to(dev),
            torch.from_numpy(offsets + lengths).to(dev)]
    for window, softcap in WINDOW_SOFTCAP:
        out = kattn.paged_prefill_attention(*args, sliding_window=window,
                                            softcap=softcap)
        ref = kattn.paged_prefill_attention_ref(
            *args, sliding_window=window, softcap=softcap)
        for b, n in enumerate(lengths):
            torch.testing.assert_close(out[b, :n].float(),
                                       ref[b, :n].float(), atol=tol,
                                       rtol=tol)


def flat_buffer(runs, t, inert):
    """Flat-buffer block metadata for `runs` [(seq, n_rows)]: each run
    takes ceil(n/8) consecutive 8-row blocks; the rest point at `inert`."""
    nb = t // 8
    seq_of_block = np.full(nb, inert, np.int32)
    block_qstart = np.zeros(nb, np.int32)
    blk = 0
    for seq, n in runs:
        for k in range(-(-n // 8)):
            seq_of_block[blk], block_qstart[blk] = seq, 8 * k
            blk += 1
    return seq_of_block, block_qstart


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_ragged_kernel_matches_plain(cuda_device, dtype, tol):
    """K3 against its plain version on the card at the serving shape: three
    decode rows at ~1.6k cached tokens, a 300-row chunk at offset 200,
    inert blocks behind them; NaN in every cell past each sequence's
    kv_valid. Every row is compared: pad rows are 0 in both."""
    S, K, D, ps, T = 2048, 8, 128, 128, 384
    rng = np.random.default_rng(13)
    k_pool, v_pool, table = shuffled_pool(rng, 4, S, K, D, ps)
    tables = np.concatenate([table, np.zeros((1, S // ps), np.int32)])
    offsets = np.asarray([1599, 1649, 1699, 200, 0], np.int32)
    valid = np.asarray([1600, 1650, 1700, 500, 1], np.int32)
    for s in range(4):
        for j in range(S // ps):
            lo = max(valid[s] - j * ps, 0)
            if lo < ps:
                k_pool[tables[s, j], lo:] = np.nan
                v_pool[tables[s, j], lo:] = np.nan
    seq_of_block, block_qstart = flat_buffer(
        [(0, 1), (1, 1), (2, 1), (3, 300)], T, 4)
    q = rng.normal(size=(T, 32, D)).astype(np.float32) * D ** -0.5
    dev = cuda_device
    args = [torch.from_numpy(q).to(dev, dtype),
            torch.from_numpy(k_pool).to(dev, dtype),
            torch.from_numpy(v_pool).to(dev, dtype)] + [
        torch.from_numpy(x).to(dev) for x in (
            tables, seq_of_block, block_qstart, offsets, valid)]
    for window, softcap in WINDOW_SOFTCAP:
        out = kattn.ragged_paged_attention(*args, sliding_window=window,
                                           softcap=softcap)
        ref = kattn.ragged_paged_attention_ref(
            *args, sliding_window=window, softcap=softcap)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


def slot_cache(rng, N, S, K, D, valid, rows):
    """A contiguous cache [N,S,K,D] whose cells at or past each batch row's
    kv_valid (in its cache row) hold NaN - a reused slot's stale cells."""
    k = rng.normal(size=(N, S, K, D)).astype(np.float32)
    v = rng.normal(size=(N, S, K, D)).astype(np.float32)
    for n, r in zip(valid, rows):
        k[r, n:] = np.nan
        v[r, n:] = np.nan
    return k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_contiguous_decode_kernel_matches_plain(cuda_device, dtype,
                                                     tol):
    """K9 against its plain version on the card: batch rows read a
    permutation of 8 cache rows, one row at the cache end, NaN past every
    row's kv_valid."""
    N, S, K, D = 8, 2048, 8, 128
    rng = np.random.default_rng(14)
    rows = np.asarray([5, 0, 7, 2], np.int32)
    valid = np.asarray([1, 129, 1000, 2048], np.int32)
    k, v = slot_cache(rng, N, S, K, D, valid, rows)
    q = rng.normal(size=(4, 1, 32, D)).astype(np.float32) * D ** -0.5
    dev = cuda_device
    args = [torch.from_numpy(x).to(dev, dtype) for x in (q, k, v)] + [
        torch.from_numpy(valid).to(dev)]
    rows_t = torch.from_numpy(rows).to(dev)
    for window, softcap in WINDOW_SOFTCAP:
        out = kattn.ragged_decode_attention(*args, sliding_window=window,
                                            softcap=softcap, rows=rows_t)
        ref = kattn.ragged_decode_attention_ref(
            *args, sliding_window=window, softcap=softcap, rows=rows_t)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_contiguous_prefill_kernel_matches_plain(cuda_device, dtype,
                                                      tol):
    """K8 against its plain version on the card: offsets, partial lengths
    (pad rows are 0 in both, so every row is compared), a row whose chunk
    ends at the cache end, a T that is no multiple of 8, a row map, NaN
    past every row's kv_valid."""
    N, S, K, D, T = 6, 2048, 8, 128, 200
    rng = np.random.default_rng(15)
    rows = np.asarray([4, 1, 3], np.int32)
    offsets = np.asarray([0, 100, S - T], np.int32)
    lengths = np.asarray([200, 77, 200], np.int32)
    valid = offsets + lengths
    k, v = slot_cache(rng, N, S, K, D, valid, rows)
    q = rng.normal(size=(3, T, 32, D)).astype(np.float32) * D ** -0.5
    dev = cuda_device
    args = [torch.from_numpy(x).to(dev, dtype) for x in (q, k, v)] + [
        torch.from_numpy(x).to(dev) for x in (offsets, valid)]
    rows_t = torch.from_numpy(rows).to(dev)
    for window, softcap in WINDOW_SOFTCAP:
        out = kattn.flash_prefill_attention(*args, sliding_window=window,
                                            softcap=softcap, rows=rows_t)
        ref = kattn.flash_prefill_attention_ref(
            *args, sliding_window=window, softcap=softcap, rows=rows_t)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
