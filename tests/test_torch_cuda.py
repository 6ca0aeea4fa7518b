"""PyTorch port, CUDA kernels K1/K2/K3/K8/K9 (K1/K9 also at the edges of
their split-KV spans, against decode_split_ref; K3 at the edges of its
schedule, against ragged_tile_ref, and per shard), K4 (in-kernel KV dequant
inside K1-K3, int8 and int4 pages), K5/K6 (w4a16 decode products), K7
(grouped LoRA BGMV, one target and its in-place group form), K10's
attention wrappers (K10a-d) and K10e/K10f (K5/K6 and K7 per shard, K7's
group form too) on two gloo ranks sharing the card, and the bf16
products with f32 results, against their plain versions on the card
(`cuda` marker; each test skips itself where there is no card). The
file imports neither jax nor the JAX package, so it runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from theroundtaible_tpu_torch.engine.kernels import attention as kattn
from theroundtaible_tpu_torch.engine.kernels import build, int4mm
from theroundtaible_tpu_torch.engine.kernels import lora as klora
from theroundtaible_tpu_torch.engine.kv_quant import (KVQuantSpec,
                                                      quantize_cells)
from theroundtaible_tpu_torch.engine.models.common import Int4Leaf

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


# bf16 and f16: p and the output round to the 16-bit type and sums run in
# another order; f32: only the summation order differs.
DTYPES = [(torch.bfloat16, 2e-2), (torch.float32, 1e-4),
          (torch.float16, 2e-2)]


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


# --- K4: quantized pages inside K1-K3 ---


def quantized_pools(rng, k_pool, v_pool, tables, valid, bits):
    """int8/int4 payload and f32 scale pools of the f32 pools (quantized on
    the CPU by kv_quant.quantize_cells); every cell at or past a row's
    kv_valid gets a random payload and NaN scales - stale cells the kernels
    must never load."""
    spec = KVQuantSpec(bits=bits)
    out = []
    for pool in (k_pool, v_pool):
        q, sc = quantize_cells(torch.from_numpy(np.nan_to_num(pool)), spec)
        q, sc = q.numpy().copy(), sc.numpy().copy()
        ps = pool.shape[1]
        for row, n in zip(tables, valid):
            for j, page in enumerate(row):
                lo = max(n - j * ps, 0)
                if lo < ps:
                    q[page, lo:] = rng.integers(-128, 128,
                                                size=q[page, lo:].shape)
                    sc[page, lo:] = np.nan
        out += [q, sc]
    return out


QUANT_CASES = [(bits, dtype, tol) for bits in (8, 4)
               for dtype, tol in DTYPES]


def _pool_args(dev, dtype, q, pools):
    kq, ks, vq, vs = pools
    return ([torch.from_numpy(q).to(dev, dtype),
             torch.from_numpy(kq).to(dev), torch.from_numpy(vq).to(dev)],
            dict(k_scale=torch.from_numpy(ks).to(dev),
                 v_scale=torch.from_numpy(vs).to(dev)))


@pytest.mark.cuda
@pytest.mark.parametrize("bits,dtype,tol", QUANT_CASES)
def test_cuda_quantized_decode_kernel_matches_plain(cuda_device, bits,
                                                    dtype, tol):
    """K1 with K4's in-kernel dequant against its plain version on int8
    and int4 pages (H=32, K=8, D=128, ps=128)."""
    B, S, K, D, ps = 4, 2048, 8, 128, 128
    rng = np.random.default_rng(21)
    k_pool, v_pool, table = shuffled_pool(rng, B, S, K, D, ps)
    valid = np.asarray([1, 129, 1000, 2048], np.int32)
    pools = quantized_pools(rng, k_pool, v_pool, table, valid, bits)
    q = rng.normal(size=(B, 1, 32, D)).astype(np.float32) * D ** -0.5
    dev = cuda_device
    args, kw = _pool_args(dev, dtype, q, pools)
    args += [torch.from_numpy(table).to(dev), torch.from_numpy(valid).to(dev)]
    for window, softcap in WINDOW_SOFTCAP:
        out = kattn.paged_decode_attention(*args, sliding_window=window,
                                           softcap=softcap, kv_bits=bits,
                                           **kw)
        ref = kattn.paged_decode_attention_ref(
            *args, sliding_window=window, softcap=softcap, kv_bits=bits,
            **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,dtype,tol", QUANT_CASES)
def test_cuda_quantized_prefill_kernel_matches_plain(cuda_device, bits,
                                                     dtype, tol):
    """K2 with K4 on int8 and int4 pages, offsets and partial lengths."""
    B, T, K, D, S, ps = 3, 256, 8, 128, 2048, 128
    rng = np.random.default_rng(22)
    k_pool, v_pool, table = shuffled_pool(rng, B, S, K, D, ps)
    offsets = np.asarray([0, 100, 1700], np.int32)
    lengths = np.asarray([256, 77, 256], np.int32)
    pools = quantized_pools(rng, k_pool, v_pool, table, offsets + lengths,
                            bits)
    q = rng.normal(size=(B, T, 32, D)).astype(np.float32) * D ** -0.5
    dev = cuda_device
    args, kw = _pool_args(dev, dtype, q, pools)
    args += [torch.from_numpy(x).to(dev)
             for x in (table, offsets, offsets + lengths)]
    for window, softcap in WINDOW_SOFTCAP:
        out = kattn.paged_prefill_attention(*args, sliding_window=window,
                                            softcap=softcap, kv_bits=bits,
                                            **kw)
        ref = kattn.paged_prefill_attention_ref(
            *args, sliding_window=window, softcap=softcap, kv_bits=bits,
            **kw)
        for b, n in enumerate(lengths):
            torch.testing.assert_close(out[b, :n].float(),
                                       ref[b, :n].float(), atol=tol,
                                       rtol=tol)


# --- K1/K9's split-KV body at the edges of its spans ---
# (H, K, D, ps, S, kv_valid of three rows, window, softcap): kv_valid 1,
# CHUNK and CHUNK + 1 (decode_chunk: 128 positions in bf16 at D = 128, 64
# in f32; 256 / 128 at D = 64; 64 / 32 at D = 256), page ends at ps 16 and
# 32, G 1, 4 and 16, D 64 and 256, a window edge inside a span and a window
# that leaves whole spans below it, softcap. NaN in every cell past each
# row's kv_valid.
DECODE_EDGES = {
    "valid_1_chunk_chunk1": (32, 8, 128, 16, 1024, [1, 128, 129], None,
                             None),
    "g1_page_ends_ps32": (8, 8, 64, 32, 1024, [32, 256, 1024], None, None),
    "g16_window_in_split": (16, 1, 128, 16, 1024, [200, 300, 1024], 50,
                            None),
    "window_leaves_splits_below": (32, 8, 128, 128, 2048, [900, 1700, 2048],
                                   300, None),
    "softcap": (32, 8, 128, 64, 1024, [5, 257, 700], None, 20.0),
    "d64_chunk_edges": (16, 4, 64, 16, 1024, [255, 256, 257], None, None),
    "d256_chunk_edges": (8, 2, 256, 16, 512, [1, 64, 65], None, None),
    "d256_g16_window_softcap": (16, 1, 256, 32, 512, [64, 100, 500], 40,
                                30.0),
}


def decode_edge(name, seed):
    """A DECODE_EDGES case: q, the f32 pools with NaN past each row's
    kv_valid, the table and kv_valid."""
    H, K, D, ps, S, valid, _, _ = DECODE_EDGES[name]
    rng = np.random.default_rng(seed)
    k_pool, v_pool, table = shuffled_pool(rng, 3, S, K, D, ps)
    valid = np.asarray(valid, np.int32)
    for b in range(3):
        for j in range(S // ps):
            lo = max(int(valid[b]) - j * ps, 0)
            if lo < ps:
                k_pool[table[b, j], lo:] = np.nan
                v_pool[table[b, j], lo:] = np.nan
    q = rng.normal(size=(3, 1, H, D)).astype(np.float32) * D ** -0.5
    return rng, q, k_pool, v_pool, table, valid


def _close(out, ref, tol):
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("name", sorted(DECODE_EDGES))
def test_cuda_decode_kernels_at_split_edges(cuda_device, name, dtype, tol):
    """K1 on the pool and K9 on the same cells laid out as slot rows,
    each against its plain version and against decode_split_ref."""
    *_, window, softcap = DECODE_EDGES[name]
    _, q, k_pool, v_pool, table, valid = decode_edge(name, 31)
    dev = cuda_device
    q, kp, vp = (torch.from_numpy(x).to(dev, dtype)
                 for x in (q, k_pool, v_pool))
    table, valid = (torch.from_numpy(x).to(dev) for x in (table, valid))
    kw = dict(sliding_window=window, softcap=softcap)
    out = kattn.paged_decode_attention(q, kp, vp, table, valid, **kw)
    _close(out, kattn.paged_decode_attention_ref(q, kp, vp, table, valid,
                                                 **kw), tol)
    _close(out, kattn.decode_split_ref(q, kp, vp, valid, table=table, **kw),
           tol)
    kc = kp[table.long()].reshape(3, -1, *kp.shape[2:]).contiguous()
    vc = vp[table.long()].reshape(3, -1, *vp.shape[2:]).contiguous()
    rows = torch.tensor([2, 0, 1], dtype=torch.int32, device=dev)
    inv = torch.argsort(rows.long())
    kc, vc = kc[inv].contiguous(), vc[inv].contiguous()
    out9 = kattn.ragged_decode_attention(q, kc, vc, valid, rows=rows, **kw)
    _close(out9, kattn.ragged_decode_attention_ref(q, kc, vc, valid,
                                                   rows=rows, **kw), tol)
    _close(out9, kattn.decode_split_ref(q, kc, vc, valid, rows=rows, **kw),
           tol)
    # One computation: the same cells through a table or a slot row.
    assert torch.equal(out, out9)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,dtype,tol", QUANT_CASES)
@pytest.mark.parametrize("name", ["valid_1_chunk_chunk1",
                                  "window_leaves_splits_below",
                                  "d64_chunk_edges",
                                  "d256_g16_window_softcap"])
def test_cuda_quantized_decode_kernel_at_split_edges(cuda_device, name, bits,
                                                     dtype, tol):
    """K1 with K4 inside on int8/int4 pages (random payloads and NaN scales
    past kv_valid) against its plain version and decode_split_ref."""
    *_, window, softcap = DECODE_EDGES[name]
    rng, q, k_pool, v_pool, table, valid = decode_edge(name, 32)
    pools = quantized_pools(rng, k_pool, v_pool, table, valid, bits)
    dev = cuda_device
    args, kw = _pool_args(dev, dtype, q, pools)
    table, valid = (torch.from_numpy(x).to(dev) for x in (table, valid))
    kw.update(sliding_window=window, softcap=softcap, kv_bits=bits)
    out = kattn.paged_decode_attention(*args, table, valid, **kw)
    _close(out, kattn.paged_decode_attention_ref(*args, table, valid, **kw),
           tol)
    _close(out, kattn.decode_split_ref(*args, valid, table=table, **kw),
           tol)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [0, 8, 4])
def test_cuda_decode_kernels_are_bit_identical_across_calls(cuda_device,
                                                            bits):
    """The combine merges the spans in a fixed order without atomics: two
    identical calls of K1 (and K9) give the same bits."""
    rng, q, k_pool, v_pool, table, valid = decode_edge(
        "window_leaves_splits_below", 33)
    dev = cuda_device
    if bits:
        args, kw = _pool_args(dev, torch.bfloat16, q, quantized_pools(
            rng, k_pool, v_pool, table, valid, bits))
        kw["kv_bits"] = bits
    else:
        args, kw = [torch.from_numpy(x).to(dev, torch.bfloat16)
                    for x in (q, k_pool, v_pool)], {}
    table, valid = (torch.from_numpy(x).to(dev) for x in (table, valid))
    first = kattn.paged_decode_attention(*args, table, valid, **kw)
    assert torch.equal(first, kattn.paged_decode_attention(
        *args, table, valid, **kw))
    if not bits:
        kc = args[1][table.long()].reshape(3, -1, *args[1].shape[2:])
        vc = args[2][table.long()].reshape(3, -1, *args[2].shape[2:])
        one = kattn.ragged_decode_attention(args[0], kc.contiguous(),
                                            vc.contiguous(), valid)
        assert torch.equal(one, kattn.ragged_decode_attention(
            args[0], kc.contiguous(), vc.contiguous(), valid))


@pytest.mark.cuda
def test_cuda_decode_chunk_is_the_kernels(cuda_device):
    """The wrappers size the split workspace by decode_chunk: it must be
    the kernels' own split length."""
    for name, fn in (("paged_decode", "rt_paged_decode_chunk"),
                     ("ragged_decode", "rt_ragged_decode_chunk")):
        lib = build.library(name)
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1),
                            (torch.float16, 2)):
            for d in kattn.HEAD_DIMS:
                assert getattr(lib, fn)(code, d) == kattn.decode_chunk(
                    d, dtype)


@pytest.mark.cuda
def test_cuda_decode_split_kernels_in_ptxas(cuda_device):
    """K1's and K9's libraries hold the split and combine kernels of every
    instantiation, and the bf16 and f16 split kernels at D <= 128 on
    unquantized pages do not spill."""
    build.build_all()
    logs = build.build_logs()
    for name in ("paged_decode", "ragged_decode"):
        entries = logs[name].split("Compiling entry function '")[1:]
        split = [e for e in entries if "decode_split_kernel" in e]
        assert split and any("decode_combine_kernel" in e for e in entries)
        for e in split:
            mangled = e.split("'")[0]
            if (("__nv_bfloat16" in mangled or "__half" in mangled)
                    and "Li0EE" in mangled
                    and ("Li64E" in mangled or "Li128E" in mangled)):
                assert "0 bytes spill stores" in e, e[:400]


# --- K2/K8 at the edges of the tensor-core tile (64 query rows of G heads
# x 64/G chunk rows per warpgroup, two warpgroups per block, keys in tiles
# of 64): (H, K, D, ps, T, offsets, lengths, window, softcap). G 1, 3, 4
# and 16; D 64 and 256; pages of 16 and 32 (a key tile spans pages); T = 1
# and T no multiple of the tile; chunks starting mid-page; window edges
# inside a key tile; softcap. NaN in every cell past each row's kv_valid.
EDGE_CASES = {
    "g1": (8, 8, 128, 128, 96, [0, 130], [96, 50], None, None),
    "g3_mid_page": (12, 4, 128, 64, 100, [5, 300], [100, 77], None, None),
    "g4_ps16": (16, 4, 128, 16, 130, [37, 0], [130, 129], None, None),
    "g16_ps32_window": (16, 1, 128, 32, 64, [200, 0], [64, 33], 100, None),
    "d64_softcap": (8, 2, 64, 32, 72, [70, 3], [72, 72], None, 30.0),
    "d256_window_softcap": (4, 2, 256, 64, 40, [100, 0], [40, 17], 48, 30.0),
    "t1": (16, 4, 128, 128, 1, [0, 999], [1, 1], None, None),
    "window_in_tile": (32, 8, 128, 128, 160, [500, 800], [160, 100], 90,
                       None),
}


def edge_pool(rng, case, S=1024):
    """A shuffled pool for an EDGE_CASES entry, NaN past every row's
    kv_valid, and its q [B,T,H,D] (f32 numpy)."""
    H, K, D, ps, T, offsets, lengths, _, _ = case
    B = len(offsets)
    k_pool, v_pool, table = shuffled_pool(rng, B, S, K, D, ps)
    valid = np.asarray(offsets, np.int32) + np.asarray(lengths, np.int32)
    for b in range(B):
        for j in range(S // ps):
            lo = max(int(valid[b]) - j * ps, 0)
            if lo < ps:
                k_pool[table[b, j], lo:] = np.nan
                v_pool[table[b, j], lo:] = np.nan
    q = rng.normal(size=(B, T, H, D)).astype(np.float32) * D ** -0.5
    return q, k_pool, v_pool, table, valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_cuda_prefill_kernel_at_tile_edges(cuda_device, name, dtype, tol):
    """K2 against its plain version at the tile's edges; real rows."""
    case = EDGE_CASES[name]
    window, softcap = case[7], case[8]
    rng = np.random.default_rng(31)
    q, k_pool, v_pool, table, valid = edge_pool(rng, case)
    offsets = np.asarray(case[5], np.int32)
    dev = cuda_device
    args = [torch.from_numpy(q).to(dev, dtype),
            torch.from_numpy(k_pool).to(dev, dtype),
            torch.from_numpy(v_pool).to(dev, dtype)] + [
        torch.from_numpy(x).to(dev) for x in (table, offsets, valid)]
    out = kattn.paged_prefill_attention(*args, sliding_window=window,
                                        softcap=softcap)
    ref = kattn.paged_prefill_attention_ref(*args, sliding_window=window,
                                            softcap=softcap)
    for b, n in enumerate(case[6]):
        torch.testing.assert_close(out[b, :n].float(), ref[b, :n].float(),
                                   atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,dtype,tol", QUANT_CASES)
@pytest.mark.parametrize("name", ["g3_mid_page", "g4_ps16",
                                  "d64_softcap", "d256_window_softcap"])
def test_cuda_quantized_prefill_kernel_at_tile_edges(cuda_device, name,
                                                     bits, dtype, tol):
    """K2 with K4 on int8 and int4 pages at the tile's edges (random
    payloads and NaN scales past kv_valid); real rows."""
    case = EDGE_CASES[name]
    window, softcap = case[7], case[8]
    rng = np.random.default_rng(32)
    q, k_pool, v_pool, table, valid = edge_pool(rng, case)
    pools = quantized_pools(rng, k_pool, v_pool, table, valid, bits)
    dev = cuda_device
    args, kw = _pool_args(dev, dtype, q, pools)
    args += [torch.from_numpy(x).to(dev)
             for x in (table, np.asarray(case[5], np.int32), valid)]
    out = kattn.paged_prefill_attention(*args, sliding_window=window,
                                        softcap=softcap, kv_bits=bits, **kw)
    ref = kattn.paged_prefill_attention_ref(*args, sliding_window=window,
                                            softcap=softcap, kv_bits=bits,
                                            **kw)
    for b, n in enumerate(case[6]):
        torch.testing.assert_close(out[b, :n].float(), ref[b, :n].float(),
                                   atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_cuda_contiguous_prefill_kernel_at_tile_edges(cuda_device, name,
                                                      dtype, tol):
    """K8 against its plain version at the tile's edges, batch rows on a
    permutation of the cache rows; every row (pad rows are 0 in both)."""
    H, K, D, _, T, offsets, lengths, window, softcap = EDGE_CASES[name]
    N, S = 4, 1024
    rng = np.random.default_rng(33)
    rows = np.asarray([3, 1], np.int32)
    offsets = np.asarray(offsets, np.int32)
    valid = offsets + np.asarray(lengths, np.int32)
    k, v = slot_cache(rng, N, S, K, D, valid, rows)
    q = rng.normal(size=(2, T, H, D)).astype(np.float32) * D ** -0.5
    dev = cuda_device
    args = [torch.from_numpy(x).to(dev, dtype) for x in (q, k, v)] + [
        torch.from_numpy(x).to(dev) for x in (offsets, valid)]
    kw = dict(sliding_window=window, softcap=softcap,
              rows=torch.from_numpy(rows).to(dev))
    torch.testing.assert_close(
        kattn.flash_prefill_attention(*args, **kw).float(),
        kattn.flash_prefill_attention_ref(*args, **kw).float(), atol=tol,
        rtol=tol)


@pytest.mark.cuda
def test_cuda_prefill_kernels_run_on_the_tensor_cores(cuda_device):
    """The bf16 bodies of K2 and K8 are wgmma: their libraries hold HGMMA
    instructions (where the toolkit has cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not shutil.which(tool):
        pytest.skip("the CUDA toolkit has no cuobjdump")
    build.build_all()
    for name in ("paged_prefill", "flash_prefill"):
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        assert sass.count("HGMMA") > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("bits,dtype,tol", QUANT_CASES)
def test_cuda_quantized_ragged_kernel_matches_plain(cuda_device, bits,
                                                    dtype, tol):
    """K3 with K4 on int8 and int4 pages: decode rows, a mid-page chunk and
    inert blocks; every row compared."""
    S, K, D, ps, T = 2048, 8, 128, 128, 384
    rng = np.random.default_rng(23)
    k_pool, v_pool, table = shuffled_pool(rng, 4, S, K, D, ps)
    tables = np.concatenate([table, np.zeros((1, S // ps), np.int32)])
    offsets = np.asarray([1599, 1649, 1699, 200, 0], np.int32)
    valid = np.asarray([1600, 1650, 1700, 500, 1], np.int32)
    pools = quantized_pools(rng, k_pool, v_pool, tables[:4], valid[:4],
                            bits)
    seq_of_block, block_qstart = flat_buffer(
        [(0, 1), (1, 1), (2, 1), (3, 300)], T, 4)
    q = rng.normal(size=(T, 32, D)).astype(np.float32) * D ** -0.5
    dev = cuda_device
    args, kw = _pool_args(dev, dtype, q, pools)
    args += [torch.from_numpy(x).to(dev) for x in (
        tables, seq_of_block, block_qstart, offsets, valid)]
    for window, softcap in WINDOW_SOFTCAP:
        out = kattn.ragged_paged_attention(*args, sliding_window=window,
                                           softcap=softcap, kv_bits=bits,
                                           **kw)
        ref = kattn.ragged_paged_attention_ref(
            *args, sliding_window=window, softcap=softcap, kv_bits=bits,
            **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


# --- K3 at the edges of its schedule (attention.ragged_tiles: prefill
# tiles of 2 * (64 / G) rows on the wgmma mainloop, one-real-row tiles
# over <= 64 cells on the CUDA cores, decode items over more than 64
# cells on the split-KV body): (H, K, D, ps, T, runs [(offset, rows)],
# window, softcap), each run one sequence, the rest of the buffer inert
# blocks. G 4: runs of 1, 7, 8, 9, 31, 32 and 33 rows on pages of 16; G 1
# (128-row tiles): 127 and 129 rows; G 2: a chunk starting mid-page, a
# window crossing a key tile; G 8 (16-row tiles): 15, 16 and 17 rows,
# softcap; G 16 at D = 256 (8-row tiles): window and softcap; G 4 at D =
# 64: decode rows over 64 and 65 cells; G 3. NaN in every cell past each
# sequence's kv_valid.
RAGGED_EDGES = {
    "g4_run_lengths": (8, 2, 128, 16, 176, [(100, 1), (5, 7), (30, 8),
                                            (0, 9), (41, 31), (3, 32),
                                            (70, 33)], None, None),
    "g1_long_runs": (2, 2, 128, 128, 288, [(0, 127), (200, 129), (90, 1)],
                     None, None),
    "g2_mid_page_window": (4, 2, 128, 32, 160, [(13, 63), (50, 65),
                                                (300, 1)], 40, None),
    "g8_softcap": (8, 1, 128, 16, 72, [(7, 15), (20, 16), (33, 17),
                                       (64, 1)], None, 30.0),
    "g16_d256_window_softcap": (16, 1, 256, 64, 48, [(5, 7), (10, 9),
                                                     (70, 1), (0, 8)],
                                24, 20.0),
    "g4_d64_decode_at_64_65": (16, 4, 64, 32, 64, [(63, 1), (64, 1),
                                                   (0, 20)], None, None),
    "g3": (12, 4, 128, 64, 136, [(500, 1), (17, 100)], 90, None),
}


def ragged_edge(name, seed, S=1024):
    """q [T,H,D], NaN-poisoned f32 pools, tables (the inert sequence last,
    on the scratch page 0) and metadata of a RAGGED_EDGES case."""
    H, K, D, ps, T, runs, _, _ = RAGGED_EDGES[name]
    rng = np.random.default_rng(seed)
    n = len(runs)
    k_pool, v_pool, table = shuffled_pool(rng, n, S, K, D, ps)
    tables = np.concatenate([table, np.zeros((1, S // ps), np.int32)])
    offsets = np.asarray([o for o, _ in runs] + [0], np.int32)
    valid = np.asarray([o + m for o, m in runs] + [1], np.int32)
    for s in range(n):
        for j in range(S // ps):
            lo = max(int(valid[s]) - j * ps, 0)
            if lo < ps:
                k_pool[tables[s, j], lo:] = np.nan
                v_pool[tables[s, j], lo:] = np.nan
    seq_of_block, block_qstart = flat_buffer(
        [(s, m) for s, (_, m) in enumerate(runs)], T, n)
    q = rng.normal(size=(T, H, D)).astype(np.float32) * D ** -0.5
    return q, k_pool, v_pool, tables, (seq_of_block, block_qstart, offsets,
                                       valid)


def _ragged_check(out, args, kw, tol):
    """K3's output against its plain version and against ragged_tile_ref,
    every row (pad rows are 0 in all three)."""
    assert torch.isfinite(out).all()
    for ref in (kattn.ragged_paged_attention_ref(*args, **kw),
                kattn.ragged_tile_ref(*args, **kw)):
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("name", sorted(RAGGED_EDGES))
def test_cuda_ragged_kernel_at_schedule_edges(cuda_device, name, dtype,
                                              tol):
    """K3 at its schedule's edges against its plain version and
    ragged_tile_ref; a second call gives the same bits."""
    window, softcap = RAGGED_EDGES[name][6:]
    q, k_pool, v_pool, tables, meta = ragged_edge(name, 41)
    dev = cuda_device
    args = [torch.from_numpy(x).to(dev, dtype) for x in (q, k_pool, v_pool)]
    args += [torch.from_numpy(x).to(dev) for x in (tables, *meta)]
    kw = dict(sliding_window=window, softcap=softcap)
    out = kattn.ragged_paged_attention(*args, **kw)
    _ragged_check(out, args, kw, tol)
    assert torch.equal(out, kattn.ragged_paged_attention(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("bits,dtype,tol", QUANT_CASES)
@pytest.mark.parametrize("name", ["g4_run_lengths", "g2_mid_page_window",
                                  "g16_d256_window_softcap"])
def test_cuda_quantized_ragged_kernel_at_schedule_edges(cuda_device, name,
                                                        bits, dtype, tol):
    """K3 with K4 on int8 and int4 pages (random payloads and NaN scales
    past kv_valid) at three of its schedule's edges."""
    window, softcap = RAGGED_EDGES[name][6:]
    rng = np.random.default_rng(42)
    q, k_pool, v_pool, tables, meta = ragged_edge(name, 42)
    pools = quantized_pools(rng, k_pool, v_pool, tables[:-1], meta[3][:-1],
                            bits)
    dev = cuda_device
    args, kw = _pool_args(dev, dtype, q, pools)
    args += [torch.from_numpy(x).to(dev) for x in (tables, *meta)]
    kw.update(sliding_window=window, softcap=softcap, kv_bits=bits)
    _ragged_check(kattn.ragged_paged_attention(*args, **kw), args, kw, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ["g4_run_lengths", "g2_mid_page_window",
                                  "g3"])
def test_cuda_ragged_kernel_shard_equals_full_slice(cuda_device, name,
                                                    dtype):
    """K10d's premise on the card: K3 on the second half of the kv heads
    (and their query heads) gives the bits of the full call's slice."""
    H, K, *_ = RAGGED_EDGES[name]
    window, softcap = RAGGED_EDGES[name][6:]
    q, k_pool, v_pool, tables, meta = ragged_edge(name, 43)
    dev = cuda_device
    q, k, v = (torch.from_numpy(x).to(dev, dtype)
               for x in (q, k_pool, v_pool))
    rest = [torch.from_numpy(x).to(dev) for x in (tables, *meta)]
    kw = dict(sliding_window=window, softcap=softcap)
    full = kattn.ragged_paged_attention(q, k, v, *rest, **kw)
    shard = kattn.ragged_paged_attention(
        q[:, H // 2:].contiguous(), k[:, :, K // 2:].contiguous(),
        v[:, :, K // 2:].contiguous(), *rest, **kw)
    assert torch.equal(shard, full[:, H // 2:])


# K3 in a speculative verify dispatch: (H, K, D, ps, T, runs, window,
# softcap), runs (offset, rows, path_of) of 1 to 5 rows ending at kv_valid -
# 1; a run whose `path_of` names an earlier one is a tree path of it,
# sharing every page below its frontier page, its own frontier page a copy.
VERIFY_EDGES = {
    "g4_paths_page_end": (32, 8, 128, 128, 64, [
        (1000, 5, None), (1000, 3, 0), (1279, 5, None), (1279, 2, 2),
        (1500, 1, None)], None, None),
    "g1_ps64_softcap": (8, 8, 128, 64, 48, [
        (700, 4, None), (700, 2, 0), (1023, 5, None), (511, 1, None)],
        None, 30.0),
    "g16_d256_window": (16, 1, 256, 64, 48, [
        (900, 5, None), (900, 4, 0), (1600, 3, None)], 256, 20.0),
    "g4_d64_ps32": (16, 4, 64, 32, 48, [
        (1535, 5, None), (1535, 3, 0), (2000, 4, None)], None, None),
}


def verify_edge(name, seed, S=2048):
    """q, NaN-poisoned f32 pools, tables and metadata of a VERIFY_EDGES
    case, tree paths on their parents' pages."""
    H, K, D, ps, T, runs, _, _ = VERIFY_EDGES[name]
    rng = np.random.default_rng(seed)
    n = len(runs)
    k_pool, v_pool, table = shuffled_pool(rng, n, S, K, D, ps)
    for s, (o, _m, parent) in enumerate(runs):
        if parent is not None:
            j, c = o // ps, o % ps
            table[s, :j] = table[parent, :j]
            k_pool[table[s, j], :c] = k_pool[table[parent, j], :c]
            v_pool[table[s, j], :c] = v_pool[table[parent, j], :c]
    tables = np.concatenate([table, np.zeros((1, S // ps), np.int32)])
    offsets = np.asarray([o for o, _, _ in runs] + [0], np.int32)
    valid = np.asarray([o + m for o, m, _ in runs] + [1], np.int32)
    for s in range(n):
        for j in range(S // ps):
            lo = max(int(valid[s]) - j * ps, 0)
            if lo < ps:
                k_pool[tables[s, j], lo:] = np.nan
                v_pool[tables[s, j], lo:] = np.nan
    seq_of_block, block_qstart = flat_buffer(
        [(s, m) for s, (_, m, _) in enumerate(runs)], T, n)
    q = rng.normal(size=(T, H, D)).astype(np.float32) * D ** -0.5
    return q, k_pool, v_pool, tables, (seq_of_block, block_qstart, offsets,
                                       valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("name", sorted(VERIFY_EDGES))
def test_cuda_ragged_kernel_on_verify_runs(cuda_device, name, dtype, tol):
    """K3 on verify-shaped buffers (short runs at the frontier of a long
    cache, tree paths sharing all but a loaned frontier page) against its
    plain version and ragged_tile_ref, and on int8/int4 pages (K4)."""
    window, softcap = VERIFY_EDGES[name][6:]
    q, k_pool, v_pool, tables, meta = verify_edge(name, 51)
    dev = cuda_device
    args = [torch.from_numpy(x).to(dev, dtype) for x in (q, k_pool, v_pool)]
    args += [torch.from_numpy(x).to(dev) for x in (tables, *meta)]
    kw = dict(sliding_window=window, softcap=softcap)
    _ragged_check(kattn.ragged_paged_attention(*args, **kw), args, kw, tol)
    rng = np.random.default_rng(52)
    for bits in (8, 4):
        pools = quantized_pools(rng, k_pool, v_pool, tables[:-1],
                                meta[3][:-1], bits)
        qargs, qkw = _pool_args(dev, dtype, q, pools)
        qargs += [torch.from_numpy(x).to(dev) for x in (tables, *meta)]
        qkw.update(kw, kv_bits=bits)
        _ragged_check(kattn.ragged_paged_attention(*qargs, **qkw), qargs,
                      qkw, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [{"drafter": "model"},
                                  {"drafter": "model",
                                   "tree": {"branch": 2, "depth": 3}}])
def test_cuda_engine_verify_dispatches_through_k3(cuda_device, spec):
    """A speculating engine on the card (f32): one scheduled session's
    verify and draft dispatches launch K3, and its greedy tokens equal
    those of a spec-off engine on the same weights."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
    cfg = _ckpt_config("cuda-spec-llama", max_seq_len=1024)
    prompts = [(f"k{i}", [1] + [5 + i, 9, 7] * 60) for i in range(2)]
    kw = dict(num_slots=4, kv_layout="paged", page_size=64,
              dtype=torch.float32, device="cuda")
    off = InferenceEngine(cfg, spec_decode=False, **kw)
    on = InferenceEngine(cfg, params=off.params, spec_decode=spec, **kw)
    texts = []
    for eng in (off, on):
        sched = SessionScheduler(eng)
        kattn.reset_launch_counts()
        try:
            texts.append(sched.submit("s", prompts, max_new_tokens=72)[0])
        finally:
            sched.close()
    info = on.spec_describe()
    assert info["verify_dispatches"] > 0 and info["draft_dispatches"] > 0
    assert info["drafter"] == "model" and info["drafter_reason"] is None
    assert kattn.launch_counts()["ragged_paged_attention"] > 0
    assert texts[0] == texts[1]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_cuda_engine_attach_and_spill_restore(cuda_device, kv_quant):
    """A paged engine on the card (bf16, and int8 pages): a second session
    sharing the first one's preamble attaches its pages from the prefix
    cache and decodes through K1 over them with the tokens of a cache-off
    engine; then the first session spills to host RAM (pinned, on the
    card's copy engines) and restores bit for bit, payload and scales, and
    its next turn prefills only the delta through K2."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.kvcache import scoped_slot
    cfg = _ckpt_config("cuda-cache-llama", max_seq_len=1024)
    kw = dict(num_slots=4, kv_layout="paged", page_size=64,
              dtype=torch.bfloat16, kv_quant=kv_quant, spec_decode=False,
              device="cuda")
    eng = InferenceEngine(cfg, **kw)
    off = InferenceEngine(cfg, params=eng.params, prefix_cache=False,
                          kv_offload=False, **kw)
    pre = [1] + [5, 9, 7, 11] * 80
    turns = {"a": [("kay", pre + [13, 14])], "b": [("bors", pre + [15])]}
    out, launches = {}, {}
    for e in (eng, off):
        kattn.reset_launch_counts()
        out[id(e)] = [e.generate_batch(t, max_new_tokens=24, session=s)
                      for s, t in turns.items()]
        launches[id(e)] = kattn.launch_counts()
    assert out[id(eng)] == out[id(off)]
    assert eng.last_stats.prefix_reused_tokens == 320
    assert eng.describe()["prefix_cache"]["hits"] == 1
    assert launches[id(eng)]["paged_decode_attention"] > 0
    name = scoped_slot("a", "kay")
    pages = list(eng.kv._slots[name].pages)
    before = [(k[pages].clone(), v[pages].clone())
              for k, v in eng.kv.combined_pools()]
    assert eng.kv_offload.spill_session("a") == 1
    host = eng.kv_offload._spilled["a"].host
    assert host[0][0].is_pinned() and host[0][0].device.type == "cpu"
    assert eng.kv_offload.restore_session("a") == 1
    pages = list(eng.kv._slots[name].pages)
    for (kb, vb), (k, v) in zip(before, eng.kv.combined_pools()):
        assert torch.equal(kb, k[pages]) and torch.equal(vb, v[pages])
    committed = len(eng.kv._slots[name].tokens)
    kattn.reset_launch_counts()
    eng.kv_offload.spill_session("a")
    nxt = list(eng.kv_offload._spilled["a"].slots[name].tokens) + [17, 18]
    eng.generate_batch([("kay", nxt)], max_new_tokens=8, session="a")
    assert eng.last_stats.reused_tokens == committed
    assert kattn.launch_counts()["paged_prefill_attention"] > 0
    assert eng.describe()["kv_offload"]["restores"] == 2


@pytest.mark.cuda
def test_cuda_ragged_kernels_in_ptxas(cuda_device):
    """K3's library holds the tile kernels (wgmma and CUDA-core) and the
    split-KV decode kernels over its decode items for every dtype, D and
    payload; the bf16 and f16 split kernels do not spill, and the wgmma tile
    kernels stay within the launch's 168 registers per thread."""
    build.build_all()
    entries = build.build_logs()["ragged_paged"].split(
        "Compiling entry function '")[1:]
    names = [e.split("'")[0] for e in entries]
    # (dtype, D, payload) for the wgmma tile kernels (bf16, f16) and the
    # split kernel (f32, bf16, f16); (D, payload) for the f32 tile kernel;
    # (dtype, D) for the combine.
    for kind, count in (("ragged_tc_kernel", 18), ("ragged_simt_kernel", 9),
                        ("decode_split_kernel", 27),
                        ("decode_combine_kernel", 9)):
        found = [n for n in names if kind in n]
        assert len(found) == count, (kind, found)
    for e in entries:
        mangled = e.split("'")[0]
        used = int(e.split("Used ")[1].split(" registers")[0])
        if "decode_split_kernel" in mangled and (
                "__nv_bfloat16" in mangled or "__half" in mangled):
            assert "0 bytes spill stores" in e, e[:400]
        if "ragged_tc_kernel" in mangled:
            assert used <= 168, e[:400]


@pytest.mark.cuda
def test_cuda_allocators_default_to_the_card(cuda_device):
    """The constructors that allocate place their tensors on the card when
    the caller names no device (tests/test_torch_device_defaults.py holds
    the CPU side)."""
    from theroundtaible_tpu_torch.engine import kvcache, paging, sampling
    from theroundtaible_tpu_torch.engine.models import common
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    cfg = get_model_config("tiny-llama")
    made = [kvcache.KVCache(cfg, 2, 64, torch.float32).layers[0][0],
            paging.PagedKVCache(cfg, 2, 64, torch.float32,
                                page_size=32).pools[0][0],
            *sampling.sampling_arrays([sampling.SamplingParams()]),
            common.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                               torch.float32)["embedding"]]
    assert all(t.device.type == "cuda" for t in made)


@pytest.mark.cuda
def test_cuda_engine_devices_pins_the_card(cuda_device):
    """from_config's "devices": [0] (an index into the JAX package's
    jax.devices()) builds the engine, its weights and its cache on
    cuda:0 (tests/test_torch_engine.py raises the multi-device cases)."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    eng = InferenceEngine.from_config(
        {"model": "tiny-llama", "max_seq_len": 128, "attn": "dense",
         "devices": [0]}, device="cuda")
    card = torch.device("cuda", 0)
    assert eng.device == card
    assert eng.params["embedding"].device == card
    assert eng.kv.layers[0][0].device == card


# --- K5/K6: w4a16 decode products ---


def int4_leaf(rng, spec, shape, dtype, dev, group=64):
    """A random packed weight planned for the call site `spec`: any byte
    is two valid nibbles; positive scales around an absmax/7 of 0.1."""
    q4 = rng.integers(-128, 128, size=(*shape[:-1], shape[-1] // 2),
                      dtype=np.int8)
    s4 = rng.uniform(0.005, 0.03, size=(*shape[:-1], shape[-1] // group))
    return int4mm.plan_leaf(spec, Int4Leaf(
        q4=torch.from_numpy(q4).to(dev), s4=torch.from_numpy(s4).to(dev, dtype),
        axis=len(shape) - 1, group=group))


# Llama-3-8B's five decode projections at 3 rows: (spec, x shape, weight).
K5_SHAPES = {
    "q_proj": ("bte,ehd->bthd", (3, 1, 4096), (4096, 32, 128)),
    "kv_proj": ("bte,ekd->btkd", (3, 1, 4096), (4096, 8, 128)),
    "o_proj": ("bthd,hde->bte", (3, 1, 32, 128), (32, 128, 4096)),
    "gate_up_proj": ("bte,ef->btf", (3, 1, 4096), (4096, 14336)),
    "down_proj": ("btf,fe->bte", (3, 1, 14336), (14336, 4096)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("name", sorted(K5_SHAPES))
def test_cuda_mm_pack_out_matches_plain(cuda_device, name, dtype, tol):
    """K5 through the int4 seam at each Llama-3-8B decode projection,
    against its plain version on the same flattened operands."""
    spec, a_shape, w_shape = K5_SHAPES[name]
    rng = np.random.default_rng(31)
    dev = cuda_device
    leaf = int4_leaf(rng, spec, w_shape, dtype, dev)
    a = torch.from_numpy(rng.normal(size=a_shape).astype(np.float32)).to(
        dev, dtype)
    before = int4mm.launch_counts()["mm_pack_out"]
    out, reason = int4mm.einsum_int4_or_reason(spec, a, leaf)
    assert reason is None and out.dtype == torch.float32
    assert int4mm.launch_counts()["mm_pack_out"] == before + 1
    n_cont = 2 if name == "o_proj" else 1
    c = int(np.prod(w_shape[:n_cont]))
    ref = int4mm.mm_pack_out_ref(
        a.reshape(-1, c), leaf.q4.reshape(c, -1),
        leaf.s4.reshape(c, -1), leaf.group // 2)
    torch.testing.assert_close(out.reshape(ref.shape), ref, atol=tol,
                               rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 9, 64])
@pytest.mark.parametrize("name", sorted(K5_SHAPES))
def test_cuda_mm_pack_out_rows_match_plain(cuda_device, name, rows):
    """bf16 K5 at each Llama-3-8B decode projection with 1 and 8 rows (one
    n-tile of the tensor-core body), 9 (two) and 64 (eight), against its
    plain version, and the same bits on a second call."""
    spec, a_shape, w_shape = K5_SHAPES[name]
    rng = np.random.default_rng(35)
    dev = cuda_device
    leaf = int4_leaf(rng, spec, w_shape, torch.bfloat16, dev)
    a = torch.from_numpy(rng.normal(size=(rows, *a_shape[1:])).astype(
        np.float32)).to(dev, torch.bfloat16)
    out, reason = int4mm.einsum_int4_or_reason(spec, a, leaf)
    assert reason is None
    n_cont = 2 if name == "o_proj" else 1
    c = int(np.prod(w_shape[:n_cont]))
    ref = int4mm.mm_pack_out_ref(
        a.reshape(-1, c), leaf.q4.reshape(c, -1),
        leaf.s4.reshape(c, -1), leaf.group // 2)
    torch.testing.assert_close(out.reshape(ref.shape), ref, atol=2e-2,
                               rtol=2e-2)
    again, _ = int4mm.einsum_int4_or_reason(spec, a, leaf)
    assert torch.equal(out, again)


# K5/K6 at the edges of their plans, (mode, rows, C, P or (N, Cp), group):
# groups of 32 values (gp = 16); a C of 4096 + 48 that leaves a partial
# last split and a partial 32-row stage; a packed width of 48 bytes (a
# partial column tile) under a C of 2001 (x's rows not 16-byte aligned); a
# head whose packed width 1040 leaves a partial 64-byte chunk and whose
# 1000 vocab rows a partial 16-row tile; 64 rows staging x in pieces.
INT4_EDGES = {
    "k5_group32_partial_split": ("out", 3, 4096 + 48, 1024, 32),
    "k5_partial_col_tile_9rows": ("out", 9, 2001, 48, 32),
    "k5_64rows_group32": ("out", 64, 4096 + 48, 512, 32),
    "k6_group32_partial_chunk": ("contract", 3, None, (1000, 1040), 32),
    "k6_64rows_pieces": ("contract", 64, None, (1000, 2048), 64),
    "k6_9rows_group32": ("contract", 9, None, (3000, 2048), 32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("edge", sorted(INT4_EDGES))
def test_cuda_int4_kernels_at_plan_edges(cuda_device, edge, dtype, tol):
    """K5/K6 at INT4_EDGES against their plain versions, the same bits on
    repeated calls."""
    mode, rows, c, dims, group = INT4_EDGES[edge]
    rng = np.random.default_rng(36)
    dev = cuda_device
    if mode == "out":
        w_shape = (c, 2 * dims)
        spec, x_shape = "bte,ef->btf", (rows, 1, c)
    else:
        w_shape = (dims[0], 2 * dims[1])
        spec, x_shape = "bte,ve->btv", (rows, 1, 2 * dims[1])
    leaf = int4_leaf(rng, spec, w_shape, dtype, dev, group=group)
    a = torch.from_numpy(rng.normal(size=x_shape).astype(np.float32)).to(
        dev, dtype)
    out, reason = int4mm.einsum_int4_or_reason(spec, a, leaf)
    assert reason is None
    x2 = a.reshape(rows, -1)
    ref = (int4mm.mm_pack_out_ref if mode == "out"
           else int4mm.mm_pack_contract_ref)(x2, leaf.q4, leaf.s4,
                                             group // 2)
    torch.testing.assert_close(out.reshape(ref.shape), ref, atol=tol,
                               rtol=tol)
    for _ in range(2):
        again, _ = int4mm.einsum_int4_or_reason(spec, a, leaf)
        assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rows", [1, 3, 9, 64])
def test_cuda_mm_pack_contract_matches_plain(cuda_device, rows, dtype, tol):
    """K6 (the int4 lm head, "bte,ve->btv") at a 4096-wide head with
    20000 vocabulary rows; 9 rows take two n-tiles of the tensor-core body
    (three passes of the f32 body), 64 rows eight."""
    rng = np.random.default_rng(32)
    dev = cuda_device
    leaf = int4_leaf(rng, "bte,ve->btv", (20000, 4096), dtype, dev)
    a = torch.from_numpy(rng.normal(size=(rows, 1, 4096)).astype(
        np.float32)).to(dev, dtype)
    out, reason = int4mm.einsum_int4_or_reason("bte,ve->btv", a, leaf)
    assert reason is None and out.shape == (rows, 1, 20000)
    ref = int4mm.mm_pack_contract_ref(a.reshape(rows, -1), leaf.q4,
                                      leaf.s4, leaf.group // 2)
    torch.testing.assert_close(out.reshape(ref.shape), ref, atol=tol,
                               rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K5_SHAPES) + ["lm_head"])
def test_cuda_int4_products_are_bit_identical_across_calls(cuda_device,
                                                           name):
    """K5 (split C summed in split order by the last block of each column
    tile) and K6 give the same bits on repeated identical calls, at 3 and
    at 64 rows, so a greedy decode step does not change between runs."""
    spec, a_shape, w_shape = K5_SHAPES.get(
        name, ("bte,ve->btv", (3, 1, 4096), (20000, 4096)))
    rng = np.random.default_rng(33)
    leaf = int4_leaf(rng, spec, w_shape, torch.bfloat16, cuda_device)
    for rows in (a_shape[0], 64):
        a = torch.from_numpy(rng.normal(size=(rows, *a_shape[1:])).astype(
            np.float32)).to(cuda_device, torch.bfloat16)
        first, _ = int4mm.einsum_int4_or_reason(spec, a, leaf)
        for _ in range(3):
            again, _ = int4mm.einsum_int4_or_reason(spec, a, leaf)
            assert torch.equal(first, again)


@pytest.mark.cuda
def test_cuda_engine_refuses_int4_leaves_the_kernels_decline(cuda_device,
                                                             monkeypatch):
    """On a card the engine is not built when K5/K6 decline a leaf
    (tiny-llama's q/k/v have groups of 16) or ROUNDTABLE_INT4_MM=0 turns
    them off: decode never leaves the kernels; a declined leaf's product
    raises rather than dequantizing."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    config = {"model": "tiny-llama", "max_seq_len": 256,
              "kv_layout": "paged", "quant": "int4"}
    with pytest.raises(ValueError, match="pack:group 16"):
        InferenceEngine.from_config(config, device="cuda")
    monkeypatch.setenv("ROUNDTABLE_INT4_MM", "0")
    with pytest.raises(ValueError, match="kernel-disabled"):
        InferenceEngine.from_config(config, device="cuda")
    rng = np.random.default_rng(34)
    leaf = int4_leaf(rng, "bte,ef->btf", (256, 512), torch.bfloat16,
                     cuda_device)
    a = torch.ones(1, 1, 256, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="kernel-disabled"):
        int4mm.einsum_int4_or_reason("bte,ef->btf", a, leaf)


# K7 at Llama-3-8B's LoRA targets, (C, O): q/o, k/v, gate/up, down.
LORA_SHAPES = {"q_proj": (4096, 4096), "k_proj": (4096, 1024),
               "gate_proj": (4096, 14336), "down_proj": (14336, 4096)}


def lora_operands(rng, target, rows, rank, dtype, dev, slots=9):
    """x [rows, C] and 9-slot stacks at a persona's scale (A ~ N(0, 1/C),
    B ~ N(0, 0.02^2) x scale 2), slot 0 zero, ids mixed with 0."""
    c, o = LORA_SHAPES[target]
    x = rng.normal(size=(rows, c)).astype(np.float32)
    a_t = (rng.normal(size=(slots, rank, c)) * c ** -0.5).astype(np.float32)
    b_s = (rng.normal(size=(slots, rank, o)) * 0.04).astype(np.float32)
    a_t[0] = b_s[0] = 0.0
    ids = ((np.arange(rows) * 5 + 1) % slots).astype(np.int32)
    ids[0] = 0
    return [torch.from_numpy(v).to(dev, dtype) for v in (x, a_t, b_s)] + [
        torch.from_numpy(ids).to(dev)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rank", [8, 16])
@pytest.mark.parametrize("rows", [1, 3, 64])
@pytest.mark.parametrize("target", sorted(LORA_SHAPES))
def test_cuda_lora_bgmv_matches_plain(cuda_device, target, rows, rank,
                                      dtype, tol):
    """K7 against its plain version at the four Llama-3-8B (C, O) pairs,
    S = 9 slots; a base row's delta is exactly zero."""
    rng = np.random.default_rng(41 + rows + rank)
    x, a_t, b_s, ids = lora_operands(rng, target, rows, rank, dtype,
                                     cuda_device)
    before = klora.launch_counts()["lora_bgmv"]
    out = klora.lora_bgmv(x, a_t, b_s, ids)
    ref = klora.bgmv_ref(x, a_t, b_s, ids)
    torch.cuda.synchronize()
    assert klora.launch_counts()["lora_bgmv"] == before + 1
    assert out.dtype == torch.float32 and out.shape == ref.shape
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
    assert not out[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("target", sorted(LORA_SHAPES))
def test_cuda_lora_bgmv_is_bit_identical_across_calls(cuda_device, target):
    """Warps and their partial sums meet in a fixed order: two identical
    calls give the same bits."""
    rng = np.random.default_rng(43)
    args = lora_operands(rng, target, 3, 8, torch.bfloat16, cuda_device)
    first = klora.lora_bgmv(*args)
    for _ in range(3):
        assert torch.equal(first, klora.lora_bgmv(*args))


@pytest.mark.cuda
def test_cuda_lora_bgmv_refuses_what_it_cannot_serve(cuda_device):
    """On a CUDA tensor the wrapper launches or raises: prefill rows, a
    dtype mix and a misaligned width raise instead of falling back."""
    rng = np.random.default_rng(44)
    x, a_t, b_s, ids = lora_operands(rng, "k_proj", 65, 8, torch.bfloat16,
                                     cuda_device)
    with pytest.raises(ValueError, match="rows:prefill-m"):
        klora.lora_bgmv(x, a_t, b_s, ids)
    with pytest.raises(ValueError, match="dtype"):
        klora.lora_bgmv(x[:3], a_t.float(), b_s, ids[:3])
    with pytest.raises(ValueError, match="dims:contract-misaligned"):
        klora.lora_bgmv(x[:3, :100].contiguous(),
                        a_t[:, :, :100].contiguous(), b_s, ids[:3])


@pytest.mark.cuda
def test_cuda_engine_refuses_lora_shapes_k7_declines(cuda_device,
                                                     monkeypatch):
    """On a card a LoRA engine is not built when K7 would decline its
    decode dispatches: rank 513 (rank:unsupported) or ROUNDTABLE_LORA_MM=0
    (kernel-disabled). An int8 store takes the grouped einsums by design
    and builds."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    # Dense attention on contiguous slots: the tiny model's head_dim 16
    # is no attention kernel's, and this test is about K7's gate alone.
    config = {"model": "tiny-llama", "max_seq_len": 256, "attn": "dense",
              "lora": {"rank": 513}}
    with pytest.raises(ValueError, match="rank:unsupported"):
        InferenceEngine.from_config(config, device="cuda")
    config["lora"] = {"rank": 8, "quant": "int8"}
    assert InferenceEngine.from_config(config, device="cuda").lora.quant \
        == "int8"
    monkeypatch.setenv("ROUNDTABLE_LORA_MM", "0")
    config["lora"] = {"rank": 8}
    with pytest.raises(ValueError, match="kernel-disabled"):
        InferenceEngine.from_config(config, device="cuda")


# K7's group form at Llama-3-8B's input groups: (C, (O_t, ...)).
LORA_GROUPS = {"qkv": (4096, (4096, 1024, 1024)), "o": (4096, (4096,)),
               "gate_up": (4096, (14336, 14336)), "down": (14336, (4096,))}


def lora_group_operands(gen, group, rows, rank, dtype, dev, ids=None):
    """x [rows, C], per target stacks at a persona's scale (9 slots, 4 at
    rank 512; slot 0 zero), f32 base products y0, ids mixed with 0 and
    repeats unless given; drawn on the card."""
    c, outs = LORA_GROUPS[group]
    slots = 4 if rank > 16 else 9
    x = torch.randn(rows, c, generator=gen, device=dev).to(dtype)
    stacks = []
    for o in outs:
        a_t = (torch.randn(slots, rank, c, generator=gen, device=dev)
               * c ** -0.5).to(dtype)
        b_s = (torch.randn(slots, rank, o, generator=gen, device=dev)
               * 0.04).to(dtype)
        a_t[0] = 0
        b_s[0] = 0
        stacks.append((a_t, b_s))
    ys = [torch.randn(rows, o, generator=gen, device=dev) for o in outs]
    if ids is None:
        ids = (torch.arange(rows, device=dev) * 5 + 1) % slots
        ids[0] = 0
    return x, stacks, ys, ids.to(torch.int32)


def plain_group(x, stacks, ys, ids):
    out = [y.clone() for y in ys]
    klora.bgmv_add_ref(x, stacks, out, ids)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rank", [8, 16, 512])
@pytest.mark.parametrize("rows", [1, 3, 8, 64])
@pytest.mark.parametrize("group", sorted(LORA_GROUPS))
def test_cuda_lora_group_matches_plain(cuda_device, group, rows, rank,
                                       dtype, tol):
    """K7's group form (one wrapper call, two launches) against
    bgmv_add_ref at Llama-3-8B's four input groups: every y within the
    tolerance of y0 plus its plain delta; base rows keep y0 bit for bit;
    one count per call."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows + rank)
    x, stacks, ys, ids = lora_group_operands(gen, group, rows, rank, dtype,
                                             cuda_device)
    ref = plain_group(x, stacks, ys, ids)
    y0 = [y.clone() for y in ys]
    before = klora.launch_counts()["lora_bgmv"]
    klora.lora_bgmv_add(x, stacks, ys, ids)
    torch.cuda.synchronize()
    assert klora.launch_counts()["lora_bgmv"] == before + 1
    base = ids == 0
    for y, r, y_0 in zip(ys, ref, y0):
        torch.testing.assert_close(y, r, atol=tol, rtol=tol)
        assert torch.equal(y[base], y_0[base])


@pytest.mark.cuda
@pytest.mark.parametrize("group", sorted(LORA_GROUPS))
def test_cuda_lora_group_base_rows_and_one_adapter(cuda_device, group):
    """All-base rows leave every y untouched (bit for bit); 64 rows of one
    shared adapter (one read of its A per block, 64 rows' dots) match the
    plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    zeros = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    x, stacks, ys, ids = lora_group_operands(
        gen, group, 8, 8, torch.bfloat16, cuda_device, ids=zeros)
    y0 = [y.clone() for y in ys]
    klora.lora_bgmv_add(x, stacks, ys, ids)
    torch.cuda.synchronize()
    assert all(torch.equal(y, y_0) for y, y_0 in zip(ys, y0))
    shared = torch.full((64,), 3, dtype=torch.int32, device=cuda_device)
    x, stacks, ys, ids = lora_group_operands(
        gen, group, 64, 8, torch.bfloat16, cuda_device, ids=shared)
    ref = plain_group(x, stacks, ys, ids)
    klora.lora_bgmv_add(x, stacks, ys, ids)
    for y, r in zip(ys, ref):
        torch.testing.assert_close(y, r, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [3, 64])
@pytest.mark.parametrize("group", sorted(LORA_GROUPS))
def test_cuda_lora_group_is_bit_identical_across_calls(cuda_device, group,
                                                       rows):
    """The splits of xa meet in one fixed order (tickets, no float
    atomics): repeat calls from the same y0 give the same bits, and the
    one-target lora_bgmv plus y0 equals the group's y bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(43)
    x, stacks, ys, ids = lora_group_operands(gen, group, rows, 8,
                                             torch.bfloat16, cuda_device)
    first = [y.clone() for y in ys]
    klora.lora_bgmv_add(x, stacks, first, ids)
    for _ in range(3):
        again = [y.clone() for y in ys]
        klora.lora_bgmv_add(x, stacks, again, ids)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    for (a_t, b_s), y, y_0 in zip(stacks, first, ys):
        assert torch.equal(y, y_0 + klora.lora_bgmv(x, a_t, b_s, ids))


@pytest.mark.cuda
def test_cuda_lora_group_refuses_what_it_cannot_serve(cuda_device):
    """On CUDA tensors the group wrapper launches or raises: prefill rows,
    a non-f32, non-contiguous or overlapping y, a dtype mix, and a
    misaligned width."""
    gen = torch.Generator(device=cuda_device).manual_seed(44)
    x, stacks, ys, ids = lora_group_operands(gen, "qkv", 65, 8,
                                             torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="rows:prefill-m"):
        klora.lora_bgmv_add(x, stacks, ys, ids)
    x, ys, ids = x[:3], [y[:3].contiguous() for y in ys], ids[:3]
    for match, bad in (
            ("float32", [ys[0].bfloat16(), ys[1], ys[2]]),
            ("contiguous", [ys[0], ys[1], torch.zeros(
                1024, 3, device=cuda_device).t()]),
            ("overlaps", [ys[0], ys[0].view(-1)[:3072].view(3, 1024),
                          ys[2]])):
        with pytest.raises(ValueError, match=match):
            klora.lora_bgmv_add(x, stacks, bad, ids)
    with pytest.raises(ValueError, match="dtype"):
        klora.lora_bgmv_add(x, [(stacks[0][0].float(), stacks[0][1])],
                            ys[:1], ids)
    a_t, b_s = stacks[1]
    with pytest.raises(ValueError, match="dims:out-misaligned"):
        klora.lora_bgmv_add(x, [(a_t, b_s[:, :, :100].contiguous())],
                            [torch.zeros(3, 100, device=cuda_device)], ids)


# --- the weight products' f32 results (models/common._mm_f32) ---


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,n", [(3, 4096, 4096), (512, 4096, 1024),
                                   (3, 4096, 128256)])
def test_cuda_bf16_products_have_f32_results(cuda_device, m, c, n):
    """A bf16 GEMM writing f32 (torch.mm's out_dtype, aten::mm.dtype)
    against the f32 product of the same bf16 values: every bf16 product is
    exact in f32, so only the summation order differs (f32 rounding over
    c terms). Its result is not rounded to bf16."""
    from theroundtaible_tpu_torch.engine.models import common
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(m, c, generator=gen, device=cuda_device).bfloat16()
    w = (torch.randn(c, n, generator=gen, device=cuda_device)
         * c ** -0.5).bfloat16()
    out = common._mm_f32(a, w)
    assert out.dtype == torch.float32
    ref = torch.mm(a.float(), w.float())
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    assert not torch.equal(out, out.bfloat16().float())
    head = common._dense(common.SPEC_HEAD, a[None], w.t().contiguous())
    torch.testing.assert_close(head[0], ref, atol=1e-4, rtol=1e-4)


# --- K10: the attention wrappers on two ranks sharing the card ---


def _spmd_rank(rank):
    """One of two gloo ranks on cuda:0 (tensor parallel, model axis 2):
    K10a-d on this rank's kv heads of Llama-3-8B's attention (H=32, K=8,
    D=128, page 128) in bf16, each against its plain version on the same
    local tensors. Returns ({wrapper: (max |diff|, within atol = rtol =
    2e-2)}, launch counts)."""
    from theroundtaible_tpu_torch.engine.sharding import Mesh
    dev = torch.device("cuda", 0)
    mesh = Mesh(1, 2, rank)
    heads, h, kh, D, ps = (32, 8), 16, 4, 128, 128
    gen = torch.Generator(device=dev).manual_seed(7)   # same on both ranks
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    def shard(x, axis):
        n = x.shape[axis] // 2
        return x.narrow(axis, rank * n, n).contiguous()

    kattn.reset_launch_counts()
    errs = {}

    def diff(out, ref):
        out, ref = out.float(), ref.float()
        d = (out - ref).abs()
        return (float(d.max()), bool(torch.isfinite(out).all())
                and bool((d <= 2e-2 + 2e-2 * ref.abs()).all()))

    # K10b/c: a pool of 3 rows x 16 pages, decode at ~1.6k, a 256-row chunk
    B, pp = 3, 16
    k_pool, v_pool = randn(1 + B * pp, ps, 8, D), randn(1 + B * pp, ps, 8, D)
    table = (torch.randperm(B * pp, generator=gen, device=dev) + 1) \
        .reshape(B, pp).to(torch.int32)
    kp, vp = shard(k_pool, 2), shard(v_pool, 2)
    valid = torch.tensor([1600, 1650, 1700], dtype=torch.int32, device=dev)
    q = shard(randn(B, 1, 32, D) * D ** -0.5, 2)
    args = (mesh, q, kp, vp, table, valid)
    errs["paged_decode_spmd"] = diff(
        kattn.paged_decode_spmd(*args, heads=heads),
        kattn.paged_decode_spmd_ref(*args, heads=heads))
    offsets = torch.tensor([0, 700, 1200], dtype=torch.int32, device=dev)
    q = shard(randn(B, 256, 32, D) * D ** -0.5, 2)
    args = (mesh, q, kp, vp, table, offsets, offsets + 256)
    errs["paged_prefill_spmd"] = diff(
        kattn.paged_prefill_spmd(*args, heads=heads),
        kattn.paged_prefill_spmd_ref(*args, heads=heads))
    # int8 pages (K4 inside K1 under the wrapper)
    spec = KVQuantSpec(bits=8)
    (kq, ks), (vq, vs) = quantize_cells(kp, spec), quantize_cells(vp, spec)
    args = (mesh, shard(randn(B, 1, 32, D) * D ** -0.5, 2), kq, vq, table,
            valid)
    kw = dict(heads=heads, k_scale=ks, v_scale=vs, kv_bits=8)
    errs["paged_decode_spmd:int8"] = diff(
        kattn.paged_decode_spmd(*args, **kw),
        kattn.paged_decode_spmd_ref(*args, **kw))
    # K10d: 3 decode rows and a 200-row chunk in one 256-row buffer
    tables = torch.cat([table, torch.zeros(1, pp, dtype=torch.int32,
                                           device=dev)])
    sob, bqs = flat_buffer([(0, 1), (1, 1), (2, 200)], 256, 3)
    qo = torch.tensor([1599, 1649, 0, 0], dtype=torch.int32, device=dev)
    rv = torch.tensor([1600, 1650, 200, 1], dtype=torch.int32, device=dev)
    q = shard(randn(256, 32, D) * D ** -0.5, 1)
    args = (mesh, q, kp, vp, tables, torch.from_numpy(sob).to(dev),
            torch.from_numpy(bqs).to(dev), qo, rv)
    errs["ragged_paged_spmd"] = diff(
        kattn.ragged_paged_spmd(*args, heads=heads),
        kattn.ragged_paged_spmd_ref(*args, heads=heads))
    # K10a: 8 slots x 2048 positions read through a row map
    kc, vc = shard(randn(8, 2048, 8, D), 2), shard(randn(8, 2048, 8, D), 2)
    rows = torch.tensor([5, 0, 3], dtype=torch.int32, device=dev)
    for t, name in ((1, "flash_attention_spmd:decode"),
                    (128, "flash_attention_spmd:prefill")):
        q = shard(randn(B, t, 32, D) * D ** -0.5, 2)
        offs = valid - 1 if t == 1 else offsets
        args = (mesh, q, kc, vc, offs, offs + t)
        errs[name] = diff(
            kattn.flash_attention_spmd(*args, heads=heads, rows=rows),
            kattn.flash_attention_spmd_ref(*args, heads=heads, rows=rows))
    torch.cuda.synchronize()
    return errs, kattn.launch_counts()


@pytest.mark.cuda
def test_cuda_spmd_wrappers_on_two_ranks_match_plain(cuda_device):
    """Two gloo ranks on one card, each running K10a-d over the CUDA
    kernels on its half of Llama-3-8B's heads, within the bf16 tolerance
    of the plain versions; every wrapper and its kernel launched on both
    ranks."""
    from theroundtaible_tpu_torch.engine import distributed
    from theroundtaible_tpu_torch.engine.kernels import build
    build.build_all()      # once, before the ranks load the libraries
    ranks = distributed.launch(_spmd_rank, 2, "gloo", "cuda:0",
                               timeout_s=600)
    for errs, counts in ranks:
        assert all(ok for _, ok in errs.values()), errs
        for name in kattn.SPMD_WRAPPERS + kattn.KERNELS:
            assert counts[name] > 0, (name, counts)


@pytest.mark.cuda
def test_cuda_attention_refuses_a_shard_the_kernels_decline(cuda_device):
    """Under a mesh, models/common.attention on the card serves through
    flash_attention_spmd or raises: a shard K8/K9 decline (64 q heads on 2
    kv heads over a 2-way model axis leaves one rank 32 q heads on one kv
    head, a GQA group above MAX_GROUP) fails with the reason and is not
    served by dense math."""
    import dataclasses
    from theroundtaible_tpu_torch.engine.models import common
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.sharding import Mesh
    cfg = dataclasses.replace(get_model_config("tiny-llama"), embed_dim=256,
                              num_heads=64, num_kv_heads=2, head_dim=128,
                              attn_impl="flash")
    mesh = Mesh(1, 2, 0)
    assert kattn.spmd_decline_reason(
        "flash", mesh, (64, 2), 1, 8, 0, 128, cuda_device) == \
        f"group:32 not in 1..{kattn.MAX_GROUP}"
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def randn(*shape):
        return (torch.randn(*shape, generator=gen, device=cuda_device)
                * 0.05).bfloat16()

    layer = {"q_proj": randn(256, 32, 128), "k_proj": randn(256, 1, 128),
             "v_proj": randn(256, 1, 128), "o_proj": randn(32, 128, 256)}
    x = randn(1, 8, 256)
    positions = torch.arange(8, device=cuda_device)[None]
    mask = torch.ones(1, 8, 8, dtype=torch.bool, device=cuda_device).tril()
    valid = torch.tensor([8], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="flash attention under mesh"):
        common.attention(x, layer, cfg, positions, None, None, mask,
                         kv_valid=valid, mesh=mesh)


# --- K10e/K10f: the w4a16 and LoRA wrappers on two ranks sharing the card ---


def _quant_spmd_rank(rank):
    """One of two gloo ranks on cuda:0 (model axis 2): K10e on this rank's
    shard of a gate/up (column), a down (row) and a head (K6, column)
    weight, K10f on a column and a row target, in bf16. Each against its
    plain version (atol = rtol = 2e-2); a column product against its slice
    of the single-device kernel's output bit for bit, a row product's
    all-reduced partial sums against it within the tolerance. Returns
    ({name: (plain diff, single-device diff, ok)}, launch counts)."""
    from theroundtaible_tpu_torch.engine import distributed, sharding
    from theroundtaible_tpu_torch.engine.sharding import build_mesh
    dev, bf16 = torch.device("cuda", 0), torch.bfloat16
    mesh = build_mesh({"data": 1, "model": 2})
    gen = torch.Generator(device=dev).manual_seed(9)   # same on both ranks
    int4mm.reset_launch_counts()
    klora.reset_launch_counts()
    errs = {}

    def shard(x, axis):
        n = x.shape[axis] // 2
        return x.narrow(axis, rank * n, n).contiguous()

    def diff(out, ref):
        d = (out.float() - ref.float()).abs()
        return float(d.max()), bool(torch.isfinite(out).all()) and bool(
            (d <= 2e-2 + 2e-2 * ref.float().abs()).all())

    def record(name, tp, out, plain, full, axis, exact):
        e_plain, ok_plain = diff(out, plain)
        if tp == "col" and exact:
            e_full = float((out - shard(full, axis)).abs().max())
            ok_full = e_full == 0.0
        elif tp == "col":
            e_full, ok_full = diff(out, shard(full, axis))
        else:
            total = distributed.all_reduce_sum(out.clone(), mesh.model_group)
            e_full, ok_full = diff(total, full)
        errs[name] = (e_plain, e_full, ok_plain and ok_full)

    for name, spec, tp, w_shape, w_ax, a_shape, a_ax in (
            ("gate", "bte,ef->btf", "col", (1024, 4096), 1, (3, 1, 1024),
             None),
            ("down", "btf,fe->bte", "row", (4096, 1024), 0, (3, 1, 4096), 2),
            ("head", "bte,ve->btv", "col", (8192, 1024), 0, (3, 1, 1024),
             None)):
        q4 = torch.randint(-128, 128, (w_shape[0], w_shape[1] // 2),
                           generator=gen, device=dev, dtype=torch.int8)
        s4 = (torch.rand(w_shape[0], w_shape[1] // 64, generator=gen,
                         device=dev) * 0.02 + 0.005).to(bf16)
        a = torch.randn(*a_shape, generator=gen, device=dev).to(bf16)
        full, _ = int4mm.einsum_int4_or_reason(
            spec, a, int4mm.plan_leaf(spec, Int4Leaf(q4, s4, 1, 64)))
        local = sharding.plan_int4_shard(
            spec, Int4Leaf(shard(q4, w_ax), shard(s4, w_ax), 1, 64), mesh,
            w_shape, tp)
        a_l = shard(a, a_ax) if a_ax is not None else a
        kw = dict(w_shape=w_shape, tp=tp)
        out, _ = int4mm.einsum_int4_spmd(mesh, spec, a_l, local, **kw)
        plain, _ = int4mm.einsum_int4_spmd_ref(mesh, spec, a_l, local, **kw)
        record(name, tp, out, plain, full, 2, exact=False)
    ids = torch.tensor([1, 2, 0], dtype=torch.int32, device=dev)
    for name, tp, c, o in (("lora_col", "col", 1024, 4096),
                           ("lora_row", "row", 4096, 1024)):
        x = torch.randn(3, c, generator=gen, device=dev).to(bf16)
        a_t = (torch.randn(4, 8, c, generator=gen, device=dev)
               * c ** -0.5).to(bf16)
        b_s = (torch.randn(4, 8, o, generator=gen, device=dev)
               * 0.05).to(bf16)
        # Slot 0 is the base adapter, all zeros (K7 skips its rows).
        a_t[0] = 0
        b_s[0] = 0
        full = klora.lora_bgmv(x, a_t, b_s, ids)
        if tp == "col":
            args = (x, a_t, shard(b_s, 2), ids)
        else:
            args = (shard(x, 1), shard(a_t, 2), b_s, ids)
        kw = dict(dims=(c, o), tp=tp, units=o if tp == "col" else c)
        out, _ = klora.lora_bgmv_spmd(mesh, *args, **kw)
        plain, _ = klora.lora_bgmv_spmd_ref(mesh, *args, **kw)
        record(name, tp, out, plain, full, 1, exact=True)
    # The group form on a q/k/v column group (k/v's one kv head unsplit):
    # each y against its slice of the one-device group call, bit for bit.
    c, outs, units = 1024, (2048, 256, 256), (16, 1, 1)
    x = torch.randn(3, c, generator=gen, device=dev).to(bf16)
    stacks = [((torch.randn(4, 8, c, generator=gen, device=dev)
                * c ** -0.5).to(bf16),
               (torch.randn(4, 8, o, generator=gen, device=dev)
                * 0.05).to(bf16)) for o in outs]
    for a_t, b_s in stacks:
        a_t[0] = 0
        b_s[0] = 0
    y0 = [torch.randn(3, o, generator=gen, device=dev) for o in outs]
    full = [y.clone() for y in y0]
    klora.lora_bgmv_add(x, stacks, full, ids)
    local, ys, want = [], [], []
    for (a_t, b_s), o, u, y, f in zip(stacks, outs, units, y0, full):
        split = klora.spmd_dims(mesh, c, o, "col", u)[0] == "out"
        local.append((a_t, shard(b_s, 2) if split else b_s))
        ys.append(shard(y, 1) if split else y.clone())
        want.append(shard(f, 1) if split else f)
    plain = [y.clone() for y in ys]
    kw = dict(dims=[(c, o) for o in outs], tp="col", units=list(units))
    why = klora.lora_bgmv_add_spmd(mesh, x, local, ys, ids, **kw)
    klora.lora_bgmv_add_spmd_ref(mesh, x, local, plain, ids, **kw)
    for n, (y, p, f) in enumerate(zip(ys, plain, want)):
        e_plain, ok_plain = diff(y, p)
        e_full = float((y - f).abs().max())
        errs[f"lora_group_{n}"] = (e_plain, e_full, why is None and ok_plain
                                   and e_full == 0.0)
    torch.cuda.synchronize()
    return errs, {**int4mm.launch_counts(), **klora.launch_counts()}


@pytest.mark.cuda
def test_cuda_quant_spmd_wrappers_on_two_ranks(cuda_device):
    """K10e over K5/K6 and K10f over K7 on two gloo ranks sharing the card:
    within the bf16 tolerance of their plain versions, column shards equal
    to the single-device output's slice (K10f bit for bit, its group form
    on a q/k/v column group too; K10e within the tolerance, as K5 splits C
    by the shard's own width), row shards' sums within the tolerance of
    it; every wrapper and kernel launched on both ranks."""
    from theroundtaible_tpu_torch.engine import distributed
    from theroundtaible_tpu_torch.engine.kernels import build
    build.build_all()
    ranks = distributed.launch(_quant_spmd_rank, 2, "gloo", "cuda:0",
                               timeout_s=600)
    for errs, counts in ranks:
        assert all(ok for *_, ok in errs.values()), errs
        for name in ("einsum_int4_spmd", "mm_pack_out", "mm_pack_contract",
                     "lora_bgmv_spmd", "lora_bgmv"):
            assert counts[name] > 0, (name, counts)


def _declining_shard_rank(rank):
    """On cuda:0 under a 2-way model axis: a K10e shard the kernels decline
    raises where it is called; a TP int4 engine whose q/k/v shards K5
    declines (tiny-llama's groups of 16), and a TP LoRA engine whose MLP
    shards K7 declines (a hidden of 100: 50 per rank), fail construction
    with the reasons. Returns the messages."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.sharding import (build_mesh,
                                                          plan_int4_shard)
    dev = torch.device("cuda", 0)
    mesh = build_mesh({"data": 1, "model": 2})
    out = {}
    q4 = torch.zeros(256, 12, dtype=torch.int8, device=dev)   # F 48 / rank
    s4 = torch.ones(256, 1, dtype=torch.bfloat16, device=dev)
    leaf = plan_int4_shard("bte,ef->btf", Int4Leaf(q4, s4, 1, 24), mesh,
                           (256, 48), "col")
    out["plan"] = leaf.plan.reason
    try:
        int4mm.einsum_int4_spmd(mesh, "bte,ef->btf",
                                torch.ones(1, 1, 256, dtype=torch.bfloat16,
                                           device=dev), leaf,
                                w_shape=(256, 48), tp="col")
        out["call"] = "served"
    except ValueError as e:
        out["call"] = str(e)
    tiny = get_model_config("tiny-llama", max_seq_len=256)
    for name, cfg, kw in (
            ("int4", tiny, {"quant": "int4"}),
            ("lora", dataclasses.replace(tiny, head_dim=64, mlp_dim=100),
             {"lora": {"rank": 4, "max_adapters": 2}})):
        try:
            InferenceEngine(cfg, mesh_shape={"data": 1, "model": 2},
                            kv_layout="paged", page_size=32, num_slots=2,
                            device=dev, **kw)
            out[name] = "built"
        except ValueError as e:
            out[name] = str(e)
    return out


@pytest.mark.cuda
def test_cuda_tp_refuses_shards_the_kernels_decline(cuda_device):
    """On the card a per-shard shape K5/K6/K7 decline is refused: the K10e
    call raises with the reason, and an engine holding such a shard fails
    construction, naming the reason with "/sharded"."""
    from theroundtaible_tpu_torch.engine import distributed
    from theroundtaible_tpu_torch.engine.kernels import build
    build.build_all()
    for out in distributed.launch(_declining_shard_rank, 2, "gloo",
                                  "cuda:0", timeout_s=600):
        assert out["plan"] == ("pack:group 24 not a multiple of 32"
                               "/sharded"), out
        assert "no w4a16 kernel serves this leaf on the card" in out["call"]
        assert "pack:group 16 not a multiple of 32/sharded" in out["int4"]
        assert "dims:out-misaligned/sharded" in out["lora"]


def _device_rank(rank):
    return str(torch.empty(0).cuda().device), torch.cuda.current_device()


@pytest.mark.cuda
def test_cuda_launch_defaults_to_the_card(cuda_device):
    """distributed.launch without device= runs the ranks on the card (rank
    r on card r modulo the cards: both on card 0 of a one-card machine,
    over gloo)."""
    from theroundtaible_tpu_torch.engine import distributed
    n = torch.cuda.device_count()
    ranks = distributed.launch(_device_rank, 2, "gloo", timeout_s=300)
    assert ranks == [(f"cuda:{r % n}", r % n) for r in range(2)]


# --- checkpoint load and `discuss` on the card ---

def _chip_smoke():
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


# A tiny Llama whose head_dim (64) the attention kernels serve.
def _ckpt_config(name="cuda-ckpt-llama", **kw):
    from theroundtaible_tpu_torch.engine.models.common import ModelConfig
    args = dict(vocab_size=512, num_layers=2, embed_dim=256, num_heads=4,
                num_kv_heads=2, head_dim=64, mlp_dim=512, max_seq_len=4096,
                tie_embeddings=False)
    args.update(kw)
    return ModelConfig(name=name, **args)


def _write_checkpoint(cfg, path, dtype=torch.float32, seed=0):
    """Seeded random weights of `cfg` on the CPU, written in HF layout by
    chip_smoke.write_hf_checkpoint; returns them."""
    from theroundtaible_tpu_torch.engine.models.common import init_params
    params = init_params(cfg, torch.Generator().manual_seed(seed), dtype,
                         "cpu")
    _chip_smoke().write_hf_checkpoint(torch, params, cfg, path)
    return params


@pytest.mark.cuda
def test_cuda_checkpoint_load_equals_params_from_numpy(cuda_device,
                                                       tmp_path):
    """A checkpoint loaded onto the card equals weights.params_from_numpy
    of the same arrays, bit for bit, in f32 and bf16."""
    from theroundtaible_tpu_torch.engine.checkpoint import \
        load_hf_checkpoint
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    cfg = _ckpt_config()
    params = _write_checkpoint(cfg, tmp_path)
    tree = {"embedding": params["embedding"].numpy(),
            "final_norm": params["final_norm"].numpy(),
            "lm_head": params["lm_head"].numpy(),
            "layers": [{k: v.numpy() for k, v in layer.items()}
                       for layer in params["layers"]]}
    for dtype in (torch.float32, torch.bfloat16):
        got = load_hf_checkpoint(tmp_path, cfg, dtype, cuda_device)
        want = params_from_numpy(tree, cfg, dtype, cuda_device)
        flat = dict(_chip_smoke().tree_leaves(got))
        assert flat.keys() == dict(_chip_smoke().tree_leaves(want)).keys()
        for name, leaf in _chip_smoke().tree_leaves(want):
            assert flat[name].device.type == "cuda", name
            assert flat[name].dtype == dtype and \
                torch.equal(flat[name], leaf), name


@pytest.mark.cuda
def test_cuda_int8_load_peak_under_bf16_tree_plus_a_layer(cuda_device,
                                                          tmp_path):
    """Loading a bf16 checkpoint as int8 layer by layer never holds more
    device memory than the bf16 tree plus one of its layers."""
    import functools
    from theroundtaible_tpu_torch.engine.checkpoint import \
        load_hf_checkpoint
    from theroundtaible_tpu_torch.engine.quant import quantize_leaves
    cfg = _ckpt_config(num_layers=6, embed_dim=512, num_heads=8,
                       num_kv_heads=2, mlp_dim=2048, vocab_size=1024)
    params = _write_checkpoint(cfg, tmp_path, torch.bfloat16)
    nbytes = dict((k, v.numel() * v.element_size())
                  for k, v in _chip_smoke().tree_leaves(params))
    tree_bytes = sum(nbytes.values())
    layer_bytes = sum(n for k, n in nbytes.items()
                      if k.startswith("layers[0]."))
    quantize = functools.partial(quantize_leaves, cfg=cfg,
                                 act_dtype=torch.bfloat16,
                                 free_source=True, bits=8)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = load_hf_checkpoint(tmp_path, cfg, torch.bfloat16, cuda_device,
                             quantize=quantize)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    assert got["layers"][0]["q_proj"]["q"].dtype == torch.int8
    assert peak < tree_bytes + layer_bytes, (peak, tree_bytes, layer_bytes)


@pytest.mark.cuda
def test_cuda_discuss_on_torch_llm_knights(cuda_device, tmp_path,
                                           monkeypatch):
    """`discuss` through cli.main on the card: three torch-llm knights on
    one paged int8 engine built from a checkpoint run both rounds; the
    session is written and K1 and K2 launched."""
    import io
    import json
    import sys
    from theroundtaible_tpu_torch import cli
    from theroundtaible_tpu_torch.engine import reset_engines
    from theroundtaible_tpu_torch.engine.models import registry
    cfg = _ckpt_config()
    monkeypatch.setitem(registry._REGISTRY, cfg.name, cfg)
    _write_checkpoint(cfg, tmp_path / "ckpt", torch.bfloat16)
    root = tmp_path / "project"
    (root / ".roundtable").mkdir(parents=True)
    config = _chip_smoke().discuss_config(tmp_path / "ckpt")
    config["adapter_config"]["torch-llm"].update(
        model=cfg.name, max_seq_len=cfg.max_seq_len)
    (root / ".roundtable" / "config.json").write_text(json.dumps(config))
    monkeypatch.chdir(root)
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    # the update check would reach for PyPI: off in tests
    monkeypatch.setattr(cli, "check_for_update", lambda on_update: None)
    kattn.reset_launch_counts()
    reset_engines()
    try:
        rc = cli.main(["discuss", "event log or snapshots?",
                       "--no-read-code"], device="cuda")
    finally:
        reset_engines()
    assert rc == 0
    counts = kattn.launch_counts()
    assert counts["paged_decode_attention"] > 0
    assert counts["paged_prefill_attention"] > 0
    (session,) = (root / ".roundtable" / "sessions").iterdir()
    transcript = json.loads((session / "transcript.json").read_text())
    assert len(transcript) == 6
    assert json.loads((session / "status.json").read_text())["phase"] == \
        "escalated"
    metrics = json.loads((session / "metrics.json").read_text())
    assert [t["engine"]["reused_tokens"] > 0 for r in metrics["rounds"]
            for t in r["turns"] if t.get("engine")][-1]


# --- supervision on the card (F5 and a restart at tiny size) ---

_DEVICE_FAULT_CHILD = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
from theroundtaible_tpu_torch.core.errors import classify_error
from theroundtaible_tpu_torch.engine.faults import RetryPolicy
x = torch.zeros(16, device="cuda")
y = x[torch.tensor([1 << 30], device="cuda")]   # past the end: the
kinds = []                                        # gather kernel asserts
try:
    torch.cuda.synchronize()
except Exception as e:
    kinds.append([type(e).__name__, classify_error(e), str(e)[:120]])
attempts = []
def call():
    attempts.append(1)
    return torch.ones(2, device="cuda").sum().item()
try:
    RetryPolicy(max_retries=3, backoff_s=0.01).run(call)
except Exception as e:
    kinds.append([type(e).__name__, classify_error(e), str(e)[:120]])
print(json.dumps({"kinds": kinds, "attempts": len(attempts)}), flush=True)
os._exit(0)
"""


@pytest.mark.cuda
def test_cuda_sticky_fault_classifies_device_lost_and_is_not_retried(
        cuda_device):
    """F5 on the card, in a subprocess (the fault ends its CUDA context):
    an out-of-range index into a CUDA tensor trips a device-side assert;
    the error that follows classifies `device_lost`, and a RetryPolicy
    around a later call makes one attempt."""
    import json
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _DEVICE_FAULT_CHILD,
                          str(root)], capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["kinds"] and all(k[1] == "device_lost"
                                for k in res["kinds"]), res
    assert res["attempts"] == 1, res


@pytest.mark.cuda
def test_cuda_supervised_restart_restores_pages_and_tokens(cuda_device,
                                                           tmp_path,
                                                           monkeypatch):
    """A device_lost injected into a scheduled round on the card (tiny
    Llama, bf16 pages, the offload tier on): the supervisor evacuates the
    idle session, rebuilds the engine from its config and restores it;
    its pages equal a snapshot taken before the fault and every round's
    greedy tokens equal an uninterrupted engine's."""
    from theroundtaible_tpu_torch.engine import faults
    from theroundtaible_tpu_torch.engine import supervisor as sup
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.models import registry
    from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
    monkeypatch.setenv("ROUNDTABLE_TELEMETRY_DIR", str(tmp_path))
    # The kernels take head_dim 64-256: a tiny Llama at head_dim 64.
    model = _ckpt_config("cuda-supervised-llama", max_seq_len=512)
    monkeypatch.setitem(registry._REGISTRY, model.name, model)
    cfg = {"model": model.name, "max_seq_len": 512, "num_slots": 8,
           "kv_layout": "paged", "page_size": 16, "kv_offload": True,
           "prefix_cache": False, "spec_decode": False,
           "sampling": {"temperature": 0.0}}
    a1 = [("k1", "Round one of session A on the gate."),
          ("k2", "Round one of session A on the levy.")]
    b1 = [("k1", "Session B opens on the northern ford.")]
    a2 = [(k, p + " Round two: answer the objections.") for k, p in a1]

    def serve(sched, retry=False):
        out = []
        for sess, turns in (("A", a1), ("B", b1), ("A", a2)):
            for attempt in range(3):
                try:
                    out.append(sched.submit(sess, turns, max_new_tokens=12,
                                            timeout_s=120)[0])
                    break
                except Exception:   # noqa: BLE001 - the injected fault
                    assert retry and attempt < 2
                    lock = sup.supervisor()._restart_lock
                    assert lock.acquire(timeout=120)
                    lock.release()
            if retry and sess == "A" and len(out) == 1:
                snap.append(pages_of_a(sched.engine))
                faults.arm("device_lost", count=1)
            if retry and sess == "B":
                restored.append(pages_of_a(sched.engine))
        return out

    def pages_of_a(eng):
        pages = [p for n in sorted(eng.kv.slot_names()) if n.startswith("A")
                 for p in eng.kv._slots[n].pages]
        idx = torch.tensor(pages, device=cuda_device)
        return [(k.index_select(0, idx).cpu(), v.index_select(0, idx).cpu())
                for k, v in eng.kv.combined_pools()]

    ref_sched = SessionScheduler(InferenceEngine.from_config(dict(cfg)))
    try:
        want = serve(ref_sched)
    finally:
        ref_sched.close()
    snap: list = []
    restored: list = []
    sup.set_supervisor(sup.EngineSupervisor())
    engine = InferenceEngine.from_config(dict(cfg))
    sched = SessionScheduler(engine)
    try:
        got = serve(sched, retry=True)
        snapshot = sup.supervisor_snapshot()
        new = sched.engine
    finally:
        faults.disarm()
        sched.close()
        sup.set_supervisor(None)
    assert got == want
    assert new is not engine
    assert all(torch.equal(a, b) and torch.equal(c, d) for (a, c), (b, d)
               in zip(snap[0], restored[0]))
    assert snapshot["restarts"] == 1
    assert snapshot["sessions_recovered"] >= 1
    hist = snapshot["engines"][0]["history"]
    assert hist[-1]["reason"] == "device_lost" and hist[-1]["ok"]


@pytest.mark.cuda
def test_cuda_engine_detects_the_card_chip_spec(cuda_device, monkeypatch):
    """The perf model's chip table holds the H100: an engine on the card
    detects it by name (no env override), with the card's ceilings."""
    from theroundtaible_tpu_torch.engine import trace_hooks
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.models import registry
    from theroundtaible_tpu_torch.utils import perfmodel
    monkeypatch.delenv(perfmodel.CHIP_ENV, raising=False)
    model = _ckpt_config("cuda-perf-llama", max_seq_len=512)
    monkeypatch.setitem(registry._REGISTRY, model.name, model)
    engine = InferenceEngine.from_config(
        {"model": model.name, "max_seq_len": 512, "kv_layout": "paged",
         "page_size": 16, "spec_decode": False})
    name = torch.cuda.get_device_name(cuda_device)
    perf = engine.perf
    if not name.startswith("NVIDIA H100 80GB HBM3"):
        assert perf.chip is None and perf.chip_source == "none"
        return
    assert (perf.chip.name, perf.chip_source) == ("h100", "detected")
    assert perf.param_bytes == perfmodel.streamed_param_bytes(engine.params)
    assert perf.decode_ceiling == pytest.approx(3350e9 / perf.param_bytes)
    assert perf.prefill_peak == pytest.approx(
        989e12 / (2 * engine.num_params))
    ledger = trace_hooks.publish_memory_ledger(engine)
    assert 0 < ledger["hbm_bytes_in_use"] <= \
        torch.cuda.mem_get_info(cuda_device)[1]


@pytest.mark.cuda
def test_cuda_gateway_stream_equals_submit(cuda_device, tmp_path,
                                           monkeypatch):
    """A tiny Llama on the card behind the gateway: a /v1/discussions
    stream carries exactly the tokens of the scheduler's own submission of
    the same turns."""
    import json
    import socket
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.models import registry
    from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
    from theroundtaible_tpu_torch.gateway import Gateway
    monkeypatch.setenv("ROUNDTABLE_TRACE_DIR", str(tmp_path / "traces"))
    model = _ckpt_config("cuda-gateway-llama", max_seq_len=512)
    monkeypatch.setitem(registry._REGISTRY, model.name, model)
    engine = InferenceEngine.from_config(
        {"model": model.name, "max_seq_len": 512, "kv_layout": "paged",
         "page_size": 16, "spec_decode": False, "prefix_cache": False,
         "sampling": {"temperature": 0.0}})
    turns = [("k1", "The round table met at dawn on the gate."),
             ("k2", "A second knight weighs the levy and the ford.")]
    sched = SessionScheduler(engine)
    gw = Gateway(sched, port=0)
    port = gw.start_in_thread()
    try:
        body = json.dumps({"session": "gw", "max_new_tokens": 24, "turns": [
            {"knight": k, "prompt": p} for k, p in turns]}).encode()
        sock = socket.create_connection(("127.0.0.1", port), timeout=120)
        sock.sendall(b"POST /v1/discussions HTTP/1.1\r\nHost: t\r\n"
                     b"Content-Length: %d\r\n\r\n" % len(body) + body)
        raw = b""
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            raw += chunk
        sock.close()
        events = [json.loads(ln[6:]) for ln in raw.decode().split("\n")
                  if ln.startswith("data: ")]
        streamed = [[], []]
        for ev in events:
            if ev["type"] == "tokens":
                streamed[ev["row"]].extend(ev["tokens"])
        assert events[-1]["type"] == "retired"
        want = []
        req = sched.submit_async("ref", turns, max_new_tokens=24,
                                 on_commit=want.append)
        texts, _stats = sched.wait(req)
        ref = [[], []]
        for ev in want:
            if ev["type"] == "tokens":
                ref[ev["row"]].extend(ev["tokens"])
        assert streamed == ref
        assert [engine.tokenizer.decode(r) for r in streamed] == texts
    finally:
        gw.stop()
        sched.close()


@pytest.mark.cuda
def test_cuda_replicas_hold_one_tree_and_migrate_pages_equal(cuda_device,
                                                             tmp_path,
                                                             monkeypatch):
    """Two replicas on the card (a tiny Llama, bf16 pages, the offload tier
    on): r1, rebuilt from r0's recipe, holds r0's tree leaf for leaf; a
    session migrated r0 -> r1 restores pages torch.equal to a snapshot
    taken on r0, and its next turn equals an unmigrated copy's."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.kvcache import session_of
    from theroundtaible_tpu_torch.engine.models import registry
    from theroundtaible_tpu_torch.engine.session_journal import \
        SessionJournal
    from theroundtaible_tpu_torch.router import (SessionRouter,
                                                 build_replicas)
    monkeypatch.setenv("ROUNDTABLE_TELEMETRY_DIR", str(tmp_path))
    model = _ckpt_config("cuda-router-llama", max_seq_len=512)
    monkeypatch.setitem(registry._REGISTRY, model.name, model)
    engine = InferenceEngine.from_config(
        {"model": model.name, "max_seq_len": 512, "kv_layout": "paged",
         "page_size": 16, "kv_offload": True, "prefix_cache": False,
         "spec_decode": False, "sampling": {"temperature": 0.0}})
    journal = SessionJournal(tmp_path / "journal")
    router = SessionRouter(build_replicas(engine, 2, journal=journal),
                           journal=journal)
    r0, r1 = router.replicas
    try:
        flat = [torch.utils._pytree.tree_leaves(r.engine.params)
                for r in (r0, r1)]
        assert len(flat[0]) == len(flat[1]) > 0
        assert all(torch.equal(a, b) for a, b in zip(*flat))
        turns = [("k1", "Round one of session A on the gate."),
                 ("k2", "Round one of session A on the levy.")]
        nxt = [(k, p + " Round two: answer the objections.")
               for k, p in turns]
        for s in ("A", "A-ref"):
            router.migrate(s, dst="r0")
            r0.scheduler.submit(s, turns, max_new_tokens=12, timeout_s=120)

        def pages(kv):
            ids = [p for n in sorted(kv.slot_names()) if session_of(n) == "A"
                   for p in kv._slots[n].pages]
            idx = torch.tensor(ids, device=kv.pools[0][0].device)
            return [(k.index_select(0, idx).cpu(), v.index_select(0, idx)
                     .cpu()) for k, v in kv.combined_pools()]
        snap = pages(r0.engine.kv)
        router.migrate("A", dst="r1")
        assert r1.tier.has("A")
        r1.tier.restore_session("A")
        after = pages(r1.engine.kv)
        assert len(after) == len(snap)
        assert all(torch.equal(a, b) and torch.equal(c, d)
                   for (a, c), (b, d) in zip(after, snap))
        got = r1.scheduler.submit("A", nxt, max_new_tokens=12,
                                  timeout_s=120)[0]
        ref = r0.scheduler.submit("A-ref", nxt, max_new_tokens=12,
                                  timeout_s=120)[0]
        assert got == ref
    finally:
        router.close()
        for rep in router.replicas:
            rep.scheduler.close()


@pytest.mark.cuda
def test_cuda_loadgen_stack_builds_at_llama3_width(cuda_device, tmp_path):
    """`roundtable loadgen`'s stack on a card: Llama-3-8B-Instruct at full
    width cut to 2 layers (tiny-gemma's head_dim 16 is outside the
    kernels), 8 slots, max_seq_len 512, the perf model's chip detected;
    one session streams through its gateway."""
    from theroundtaible_tpu_torch.loadgen import bench
    cfg = bench.stack_model_config("cuda")
    assert (cfg.name, cfg.num_layers, cfg.embed_dim, cfg.head_dim,
            cfg.max_seq_len) == ("llama-3-8b-instruct", 2, 4096, 128, 512)
    gw, sched, engine, port = bench._build_stack(
        str(tmp_path), smoke=True, max_inflight=4, max_queue_depth=2)
    try:
        assert engine.device.type == "cuda" and engine.kv.num_slots == 8
        assert engine.perf.chip is not None
        from theroundtaible_tpu_torch.loadgen import GatewayDriver
        from theroundtaible_tpu_torch.loadgen.workload import WorkloadMix
        spec = WorkloadMix(max_new_tokens=4, max_turns=1).draw(0, 0)
        (rec,) = GatewayDriver(port).run([spec], [0.0], timeout_s=120)
        assert rec["outcome"] == "completed" and rec["tokens"] > 0
    finally:
        gw.stop()
        sched.close()


def _moe_config(**over):
    """tiny-mixtral at head_dim 64 (the kernels' smallest), 8 heads, 4
    experts; `over` widens it."""
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    base = dict(num_heads=8, num_kv_heads=2, head_dim=64, embed_dim=512,
                mlp_dim=512, max_seq_len=1024, name="cuda-moe")
    base.update(over)
    return dataclasses.replace(get_model_config("tiny-mixtral"), **base)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_moe_engine_serves_through_the_kernels(cuda_device, dtype):
    """A MoE engine on the card (bf16 and f16, paged): a 2-knight batch
    prefills through K2 and decodes through K1, and its logits on the
    kernel path stay within 5e-2 of the plain path's (forward_paged with
    plain=True) on the same weights and tokens."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.paged_forward import forward_paged
    cfg = _moe_config()
    eng = InferenceEngine(cfg, num_slots=4, kv_layout="paged", page_size=64,
                          dtype=dtype, spec_decode=False, device="cuda")
    kattn.reset_launch_counts()
    texts = eng.generate_batch([("a", [1, 5, 9, 7] * 40),
                                ("b", [1, 8, 3] * 50)], max_new_tokens=12)
    assert len(texts) == 2
    counts = kattn.launch_counts()
    assert counts["paged_prefill_attention"] > 0
    assert counts["paged_decode_attention"] > 0
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(3, 259, (2, 96), generator=gen, device="cuda")
    pos = torch.arange(96, dtype=torch.int32, device="cuda").expand(
        2, 96).contiguous()
    valid = torch.full((2,), 96, dtype=torch.int32, device="cuda")
    table = torch.arange(1, 5, dtype=torch.int32, device="cuda").reshape(
        2, 2)
    out = []
    for plain in (False, True):
        pools = [(torch.zeros(5, 64, 2, 64, dtype=dtype, device="cuda"),
                  torch.zeros(5, 64, 2, 64, dtype=dtype, device="cuda"))
                 for _ in range(cfg.num_layers)]
        out.append(forward_paged(eng.params, cfg, tokens, pos, pools, table,
                                 valid, last_pos=valid - 1, plain=plain))
    assert torch.isfinite(out[0]).all()
    assert ((out[0] - out[1]).abs()
            <= 5e-2 + 5e-2 * out[1].abs()).all()


@pytest.mark.cuda
def test_cuda_moe_int4_expert_down_runs_k5(cuda_device):
    """int4 experts on the card: the expert down product ("btxf,xfe->bte",
    C = X * F) launches K5 at decode rows and matches its plain version;
    the expert gate/up take the dequant path (the one product no kernel
    serves) instead of refusing; the engine builds and serves."""
    from theroundtaible_tpu_torch.engine import quant
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.models import common
    cfg = _moe_config()
    params = quant.quantize_params(
        common.init_params(cfg, torch.Generator(device="cuda").manual_seed(
            0), torch.bfloat16, "cuda"), cfg, bits=4)
    down = params["layers"][0]["experts"]["down_proj"]
    assert down.plan.reason is None and down.plan.width == 4 * 512
    a = torch.randn(3, 1, 4, 512, device="cuda").to(torch.bfloat16)
    int4mm.reset_launch_counts()
    y, reason = int4mm.einsum_int4_or_reason(common.SPEC_EXPERT_DOWN, a,
                                             down)
    assert reason is None and int4mm.launch_counts()["mm_pack_out"] == 1
    ref, _ = int4mm.einsum_int4_or_reason(
        common.SPEC_EXPERT_DOWN, a, dataclasses.replace(
            down, plan=dataclasses.replace(down.plan, plain=True)))
    assert ((y - ref).abs() <= 2e-2 + 2e-2 * ref.abs()).all()
    up = params["layers"][0]["experts"]["gate_proj"]
    x = torch.randn(3, 1, 512, device="cuda").to(torch.bfloat16)
    assert int4mm.einsum_int4_or_reason(common.SPEC_EXPERT_UP, x, up) == (
        None, "spec:mixed-kept-contracted")
    eng = InferenceEngine(cfg, num_slots=2, kv_layout="paged", page_size=64,
                          quant="int4", params=params, spec_decode=False,
                          device="cuda")
    int4mm.reset_launch_counts()
    eng.generate_batch([("a", [1, 5, 9] * 30)], max_new_tokens=6)
    assert int4mm.launch_counts()["mm_pack_out"] > 0
    paths = eng.describe()["int4_paths"]
    assert common.SPEC_EXPERT_DOWN in {e["spec"]
                                       for e in paths["cuda_w4a16"]}


# --- a data axis and the scheduler on a mesh (two gloo ranks on card 0) ---

MESH_TURNS = [("a", [1] + [5, 9, 13] * 60), ("b", [1] + [7, 11] * 80),
              ("c", [1] + [3, 17, 19, 23] * 40)]


def _mesh_engine(mesh, **kw):
    """The tiny head_dim-64 Llama on `mesh` (seeded weights: every rank
    draws the same), paged, page 128, f32: only summation orders differ
    from one device."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.sampling import SamplingParams
    kw = {"num_slots": 6, "kv_layout": "paged", "page_size": 128,
          "spec_decode": False, "dtype": torch.float32,
          "sampling": SamplingParams(temperature=0.0, max_new_tokens=16),
          **kw}
    return InferenceEngine(_ckpt_config(max_seq_len=1024), mesh_shape=mesh,
                           device="cuda", **kw)


def _data_axis_rank(rank):
    """On cuda:0 over {"data": 2, "model": 1}: three rows (one pad row) on
    f32 pages and on int8 pages; each case's launches (K10b/K10c over the
    replicas' pools) and tokens, then rank 0's one-device tokens."""
    import torch.distributed as dist
    out = {}
    for name, kw in (("f32", {}), ("int8", {"kv_quant": "int8"})):
        eng = _mesh_engine({"data": 2, "model": 1}, **kw)
        kattn.reset_launch_counts()
        texts = eng.generate_batch(MESH_TURNS, max_new_tokens=16)
        torch.cuda.synchronize()
        out[name] = {"texts": texts,
                     "launches": {**kattn.launch_counts(),
                                  **kattn.replica_launch_counts(),
                                  **kattn.dequant_launch_counts()},
                     "pages": int(eng.kv.pools[0][0].shape[0]),
                     "num_pages": eng.kv.num_pages}
        del eng
        if rank == 0:
            single = _mesh_engine(None, num_pages=out[name]["num_pages"],
                                  **kw)
            out[name]["single"] = single.generate_batch(MESH_TURNS,
                                                        max_new_tokens=16)
            del single
        dist.barrier()
    return out


@pytest.mark.cuda
def test_cuda_data_axis_engine_runs_k10bc_over_replica_pools(cuda_device):
    """A real two-rank engine step on a data axis: each rank holds half
    the pages, K10b/K10c launch over the replicas' pools (f32 and int8
    pages, K4 inside), K3 never, and both ranks give the one-device
    engine's greedy tokens."""
    from theroundtaible_tpu_torch.engine import distributed
    build.build_all()
    ranks = distributed.launch(_data_axis_rank, 2, "gloo", "cuda:0",
                               timeout_s=600)
    for name in ("f32", "int8"):
        for r in ranks:
            got = r[name]
            n = got["launches"]
            assert n["paged_decode_spmd:pool_replicas"] > 0, n
            assert n["paged_prefill_spmd:pool_replicas"] > 0, n
            assert n["ragged_paged_attention"] == 0, n
            if name == "int8":
                assert n["paged_decode_attention:int8"] > 0, n
            assert 2 * got["pages"] == got["num_pages"]
            assert got["texts"] == ranks[0][name]["single"]


def _mesh_scheduler_rank(rank):
    """On cuda:0 over {"data": 1, "model": 2}: generate_batch references,
    then a scheduler (rank 0 submits, rank 1 follows) where session "j"
    joins "s" mid-decode through a ragged dispatch."""
    import threading
    import time
    from theroundtaible_tpu_torch.engine.scheduler import scheduler_for
    eng = _mesh_engine({"data": 1, "model": 2})
    eng.ragged_defer_min = 1
    # "s" decodes 200 tokens: "j" arrives after its first 64-step segment
    # with three more to go, so it joins mid-decode however fast the card.
    news = {"s": 200, "j": 80}
    refs = {s: eng.generate_batch(t, max_new_tokens=news[s],
                                  session=f"r{s}")
            for s, t in (("s", MESH_TURNS[:2]), ("j", MESH_TURNS[2:]))}
    sched = scheduler_for(eng)
    kattn.reset_launch_counts()
    out = {"refs": refs}
    if rank == 0:
        got = {}
        first = threading.Thread(target=lambda: got.update(s=sched.submit(
            "s", MESH_TURNS[:2], max_new_tokens=news["s"])[0]))
        first.start()
        deadline = time.monotonic() + 120
        while sched.segments < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        got["j"] = sched.submit("j", MESH_TURNS[2:],
                                max_new_tokens=news["j"])[0]
        first.join(120)
        out["got"] = got
        out["describe"] = sched.describe()
        sched.close()
    else:
        sched.close(timeout_s=300)
    torch.cuda.synchronize()
    out["launches"] = kattn.launch_counts()
    out["plans"] = sched.plan_counts()
    return out


@pytest.mark.cuda
def test_cuda_mesh_scheduler_smoke_two_ranks(cuda_device):
    """The SessionScheduler on a TP mesh on the card: rank 0's sessions
    give the engine's generate_batch tokens, the join runs K10d on both
    ranks, and the follower makes every plan rank 0 sent."""
    from theroundtaible_tpu_torch.engine import distributed
    build.build_all()
    lead, follow = distributed.launch(_mesh_scheduler_rank, 2, "gloo",
                                      "cuda:0", timeout_s=600)
    assert lead["got"] == lead["refs"] and follow["refs"] == lead["refs"]
    assert lead["describe"]["ragged_joins"] >= 1
    assert lead["describe"]["max_occupancy"] > 1
    for r in (lead, follow):
        assert r["launches"]["ragged_paged_spmd"] > 0, r["launches"]
    assert follow["plans"]["plans"] == lead["plans"]["plans"] > 0
    assert follow["plans"]["dispatches"] == lead["plans"]["dispatches"]
    assert follow["plans"]["errors"] == 0


# --- the contiguous layout on a data axis and a two-stage pipeline (two
# gloo ranks on card 0) ---


def _contiguous_data_rank(rank):
    """On cuda:0 over {"data": 2, "model": 1} on the contiguous layout:
    three rows (slots 0-2 of 6: two on replica 0, one on replica 1), the
    launches and tokens, then rank 0's one-device tokens."""
    import torch.distributed as dist
    eng = _mesh_engine({"data": 2, "model": 1}, kv_layout="contiguous")
    kattn.reset_launch_counts()
    out = {"texts": eng.generate_batch(MESH_TURNS, max_new_tokens=16)}
    torch.cuda.synchronize()
    out["launches"] = kattn.launch_counts()
    out["slots"] = int(eng.kv.layers[0][0].shape[0])
    del eng
    if rank == 0:
        single = _mesh_engine(None, kv_layout="contiguous")
        out["single"] = single.generate_batch(MESH_TURNS, max_new_tokens=16)
        del single
    dist.barrier()
    return out


@pytest.mark.cuda
def test_cuda_contiguous_data_axis_runs_k8_k9_per_replica(cuda_device):
    """A real two-rank step of the contiguous layout on a data axis: each
    rank holds half the slots and runs its replica's rows through K8 and
    K9 (no paged kernel), and both ranks give the one-device engine's
    greedy tokens."""
    from theroundtaible_tpu_torch.engine import distributed
    build.build_all()
    ranks = distributed.launch(_contiguous_data_rank, 2, "gloo", "cuda:0",
                               timeout_s=600)
    for r in ranks:
        n = r["launches"]
        assert n["flash_prefill_attention"] > 0, n
        assert n["ragged_decode_attention"] > 0, n
        assert n["paged_decode_attention"] == 0, n
        assert r["slots"] == 3
        assert r["texts"] == ranks[0]["single"]


def _pp_rank(rank, layout):
    """On cuda:0, a two-stage PPEngine of the tiny head_dim-64 Llama
    (seeded weights: each stage keeps its layer of the same draw) on
    `layout`: the launches, tokens and point-to-point counts, then rank
    0's one-device tokens."""
    import torch.distributed as dist
    from theroundtaible_tpu_torch.engine.distributed import reset_p2p_counts
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.pp_serving import PPEngine
    from theroundtaible_tpu_torch.engine.sampling import SamplingParams
    kw = {"kv_layout": layout, "page_size": 128} if layout == "paged" \
        else {}
    sp = SamplingParams(temperature=0.0, max_new_tokens=16)
    cfg = _ckpt_config(max_seq_len=1024)
    eng = PPEngine(cfg, n_stages=2, num_slots=6, dtype=torch.float32,
                   sampling=sp, device="cuda", **kw)
    kattn.reset_launch_counts()
    reset_p2p_counts()
    out = {"texts": eng.generate_batch(MESH_TURNS, max_new_tokens=16)}
    torch.cuda.synchronize()
    d = eng.describe()
    out.update(launches=kattn.launch_counts(), p2p=d["p2p"],
               layers=d["layers"], kv_layout=d["kv_layout"])
    del eng
    if rank == 0:
        single = InferenceEngine(cfg, num_slots=6, dtype=torch.float32,
                                 sampling=sp, spec_decode=False,
                                 device="cuda", **kw)
        out["single"] = single.generate_batch(MESH_TURNS, max_new_tokens=16)
        del single
    dist.barrier()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_pp_engine_two_stages(cuda_device, layout):
    """A real two-rank pipeline step on the card: each stage holds one of
    the two layers and runs its layout's kernels (K2/K1 pool-direct, or
    K8/K9) on every rank, the other layout's never; the stages exchange
    activations (rank 0 sends, rank 1 receives); both ranks give the
    one-device engine's greedy tokens."""
    from theroundtaible_tpu_torch.engine import distributed
    build.build_all()
    ranks = distributed.launch(_pp_rank, 2, "gloo", "cuda:0",
                               args=(layout,), timeout_s=600)
    want, other = (("paged_prefill_attention", "paged_decode_attention"),
                   ("flash_prefill_attention", "ragged_decode_attention"))
    if layout == "contiguous":
        want, other = other, want
    for r in ranks:
        for name in want:
            assert r["launches"][name] > 0, r["launches"]
        for name in other:
            assert r["launches"][name] == 0, r["launches"]
        assert r["texts"] == ranks[0]["single"]
    assert [r["layers"] for r in ranks] == [[0, 1], [1, 2]]
    assert ranks[0]["p2p"]["send_calls"] > 0
    assert ranks[1]["p2p"]["recv_calls"] == ranks[0]["p2p"]["send_calls"]
    assert ranks[0]["kv_layout"] == f"stage-local {layout}" + (
        " (pool-direct)" if layout == "paged" else "")


# --- Queue 1 slices 4 and 5: the ring prefill and the fleet planner ---

def _depth(base, layers):
    """`base` at full width cut to `layers` layers, registered."""
    from theroundtaible_tpu_torch.engine.models import registry
    name = f"{base}-{layers}l"
    registry.register(dataclasses.replace(registry.get_model_config(base),
                                          name=name, num_layers=layers))
    return name


@pytest.mark.cuda
@pytest.mark.parametrize("base", ["llama-3-8b-instruct",
                                  "mistral-7b-instruct"])
def test_cuda_width_1_ring_matches_the_chunked_engine(cuda_device, base):
    """A one-card engine with seq_parallel (a ring of width 1) prefills a
    fresh 4,500-token prompt (padded to 8192) through the ring - past
    Mistral's 4,096-token window - then decodes through K1: its first
    logits stay within 5e-2 of the same engine's chunked prefill (K2),
    and its greedy tokens equal it."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    cfg = get_model_config(_depth(base, 2))
    eng = InferenceEngine(cfg, num_slots=2, kv_layout="paged",
                          spec_decode=False, prefix_cache=False,
                          kv_offload=False, seq_parallel=2,
                          long_threshold=2048, device="cuda")
    assert eng.seq_ring.size == 1
    gen = torch.Generator().manual_seed(5)
    prompt = [1] + torch.randint(5, 30000, (4499,),
                                 generator=gen).tolist()
    outs = []
    for ring in (True, False):
        if not ring:
            eng._ring_prefill = None
        eng.kv.release("a")
        kattn.reset_launch_counts()
        before = eng.ring_dispatches
        texts = eng.generate_batch([("a", prompt)], max_new_tokens=8)
        tokens = list(eng.kv._slots["a"].tokens[len(prompt):])
        outs.append((texts, tokens, eng.ring_dispatches - before,
                     kattn.launch_counts()))
    (ring_t, ring_tok, rings, ring_l), (ch_t, ch_tok, none, ch_l) = outs
    assert rings == 1 and none == 0
    assert ring_l["paged_prefill_attention"] == 0
    assert ring_l["paged_decode_attention"] > 0
    assert ch_l["paged_prefill_attention"] > 0
    assert ring_tok == ch_tok


@pytest.mark.cuda
def test_cuda_device_memory_bytes_reads_the_card(cuda_device):
    """device_memory_bytes is the card's total memory times 0.75, the
    device count the cards'; the trio plans on that budget."""
    from theroundtaible_tpu_torch.engine import fleet
    total = torch.cuda.get_device_properties(0).total_memory
    assert fleet.device_memory_bytes() == int(total * 0.75)
    assert fleet.device_count() == torch.cuda.device_count()
    cfgs = [{"model": m, "num_slots": 8, "max_seq_len": 8192,
             "kv_layout": "paged"}
            for m in ("gemma-7b-it", "llama-3-8b-instruct",
                      "mistral-7b-instruct")]
    fleet.plan_fleet(cfgs)
    assert all(c["devices"] == [0] for c in cfgs)
    assert cfgs[0].get("quant") in ("int8", "int4")


@pytest.mark.cuda
@pytest.mark.parametrize("base,quant", [("gemma-7b-it", "int4"),
                                        ("gemma-7b-it", "none"),
                                        ("mistral-7b-instruct", "int4")])
def test_cuda_7b_widths_through_every_gate(cuda_device, base, quant):
    """Gemma-7B (D 256, H = K 16, F 24,576, the tied 256,000-row head) and
    Mistral-7B (window 4,096) at full width, 2 layers: every gate takes
    the engine (pool-direct K1/K2, K3's ragged seam, K5/K6 on int4), a
    batch serves through the kernels, and the kernel path's logits stay
    within 5e-2 of the plain path's."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.paged_forward import forward_paged
    cfg = get_model_config(_depth(base, 2))
    eng = InferenceEngine(cfg, num_slots=4, kv_layout="paged", quant=quant,
                          spec_decode=False, device="cuda")
    assert eng.paged_direct and eng.ragged_enabled
    if quant == "int4":
        # every int4 product's decode rows run K5/K6 (only prefill rows
        # take the dequantized weight)
        assert all(e["rows"] != "all"
                   for e in eng.int4_path_report()["xla_dequant"])
    kattn.reset_launch_counts()
    int4mm.reset_launch_counts()
    texts = eng.generate_batch([("a", [1, 5, 9, 7] * 300),
                                ("b", [1, 8, 3] * 200)], max_new_tokens=8)
    assert len(texts) == 2
    counts = {**kattn.launch_counts(), **int4mm.launch_counts()}
    assert counts["paged_prefill_attention"] > 0
    assert counts["paged_decode_attention"] > 0
    if quant == "int4":
        assert counts["mm_pack_out"] > 0 and counts["mm_pack_contract"] > 0
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(3, 30000, (2, 256), generator=gen, device="cuda")
    pos = torch.arange(256, dtype=torch.int32, device="cuda").expand(
        2, 256).contiguous()
    valid = torch.full((2,), 256, dtype=torch.int32, device="cuda")
    table = torch.arange(1, 5, dtype=torch.int32, device="cuda").reshape(
        2, 2)
    out = []
    for plain in (False, True):
        pools = [(torch.zeros(5, 128, cfg.num_kv_heads, cfg.head_dim,
                              dtype=torch.bfloat16, device="cuda"),
                  torch.zeros(5, 128, cfg.num_kv_heads, cfg.head_dim,
                              dtype=torch.bfloat16, device="cuda"))
                 for _ in range(cfg.num_layers)]
        out.append(forward_paged(eng.params, cfg, tokens, pos, pools, table,
                                 valid, last_pos=valid - 1, plain=plain))
    assert torch.isfinite(out[0]).all()
    assert ((out[0] - out[1]).abs()
            <= 5e-2 + 5e-2 * out[1].abs()).all()
