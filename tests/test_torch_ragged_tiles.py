"""PyTorch port, K3's schedule: `ragged_tiles` (the work list K3's CUDA
kernels derive on the card from the flat buffer's metadata: prefill tiles
of 2 * (64 // G) rows and split-KV decode items) and `ragged_tile_ref`
(the plain model of that schedule) against the JAX package's
`ragged_paged_attention` (Pallas, interpret mode on the CPU) at the tile
edges, on NaN-poisoned pools (JAX reads clean ones). Same numpy inputs on
both sides. The CUDA kernels themselves run only on a card:
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theroundtaible_tpu.engine.pallas import attention as pattn
from theroundtaible_tpu_torch.engine import kv_quant as kvq
from theroundtaible_tpu_torch.engine import serving_loop
from theroundtaible_tpu_torch.engine.kernels import attention as kattn

# f32 on both sides: only the summation order differs (the model walks
# keys in tiles of 64 with an online softmax).
TOL = dict(atol=2e-5, rtol=2e-5)
BQ8 = serving_loop.RAGGED_BLOCK_Q


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_meta(runs, t):
    """Block metadata of a flat buffer holding `runs` [(offset, rows)] as
    build_ragged_batch lays them out: one sequence each, consecutive
    blocks, every unused block on the inert sequence len(runs) (kv_valid 1,
    offset 0)."""
    nb = t // BQ8
    n = len(runs)
    seq_of_block = np.full(nb, n, np.int32)
    block_qstart = np.zeros(nb, np.int32)
    blk = 0
    for s, (_o, m) in enumerate(runs):
        for k in range(-(-m // BQ8)):
            seq_of_block[blk], block_qstart[blk] = s, BQ8 * k
            blk += 1
    offsets = np.asarray([o for o, _ in runs] + [0], np.int32)
    valid = np.asarray([o + m for o, m in runs] + [1], np.int32)
    return seq_of_block, block_qstart, offsets, valid


def real_rows(seq_of_block, block_qstart, offsets, valid):
    """(flat row, sequence) of every real row: q_pos < kv_valid."""
    rows = []
    for blk, (s, qs) in enumerate(zip(seq_of_block, block_qstart)):
        for i in range(BQ8):
            if offsets[s] + qs + i < valid[s]:
                rows.append((BQ8 * blk + i, int(s)))
    return rows


# --- ragged_tiles: the work list ---

# Metadata of flat buffers: (seq_of_block, block_qstart, query_offsets,
# kv_valid). "built" comes from serving_loop.build_ragged_batch itself;
# "arbitrary" holds what build_ragged_batch never makes but the kernel
# contract allows: a sequence in two runs (both decode-shaped), a 16-row
# decode run, a run not starting at block_qstart 0.
META = {
    "built": None,
    "main_like": flat_meta([(1599, 1), (1649, 1), (1699, 1), (0, 1000)],
                           1024),
    "lengths_inert": flat_meta([(70, 1), (5, 7), (30, 8), (0, 9), (41, 31),
                                (3, 32), (20, 33)], 192),
    "arbitrary": (np.array([0, 1, 1, 0, 2, 2, 2, 3, 3], np.int32),
                  np.array([0, 0, 8, 0, 16, 24, 32, 0, 0], np.int32),
                  np.array([99, 200, 10, 0, 0], np.int32),
                  np.array([100, 201, 60, 1, 1], np.int32)),
}


def built_meta():
    table = np.arange(1, 17, dtype=np.int32)
    seqs = [serving_loop.RaggedSeq([5] * n, pos, table)
            for n, pos in ((1, 300), (77, 0), (1, 40), (130, 64))]
    b = serving_loop.build_ragged_batch(
        seqs, t_budget=256, s_max=6, pages_per_seq=16, scratch_page=0,
        pad_id=0, page_size=32)
    return (b["seq_of_block"], b["block_qstart"], b["query_offsets"],
            b["kv_valid"])


@pytest.mark.parametrize("group", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("name", sorted(META))
def test_ragged_tiles_cover_every_real_row_once(name, group):
    """Every real row lies in exactly one item; a tile never spans two
    runs and holds consecutive positions of one sequence; each inert block
    is a run of its own; every tile but a run's last is 2 * (64 // G) rows
    high, whatever the buffer holds; decode items are first runs whose
    only real row is their first, over more than 64 cells."""
    meta = built_meta() if META[name] is None else META[name]
    seq_of_block, block_qstart, offsets, valid = meta
    tiles, decode = kattn.ragged_tiles(*meta, group)
    height = 2 * (64 // group)
    covered = {}
    for row0, n, pos0, s in tiles:
        assert 1 <= n <= height
        blocks = range(row0 // BQ8, (row0 + n - 1) // BQ8 + 1)
        for i in range(n):
            blk, r = divmod(row0 + i, BQ8)
            assert seq_of_block[blk] == s
            assert offsets[s] + block_qstart[blk] + r == pos0 + i
            covered[row0 + i] = covered.get(row0 + i, 0) + 1
        for blk in list(blocks)[1:]:        # no run start inside a tile
            assert block_qstart[blk] != 0
        if (row0 + n) % BQ8 == 0 and (row0 + n) // BQ8 < len(seq_of_block):
            nxt = (row0 + n) // BQ8
            cont = (seq_of_block[nxt] == s and block_qstart[nxt] != 0
                    and block_qstart[nxt] == block_qstart[nxt - 1] + BQ8)
            assert n == height or not cont  # short only at a run's end
    for row, s in decode:
        blk = row // BQ8
        assert row % BQ8 == 0 and seq_of_block[blk] == s
        assert offsets[s] + block_qstart[blk] == valid[s] - 1
        assert valid[s] > kattn.KEY_TILE
        assert list(seq_of_block).index(s) == blk   # its first run
        covered[row] = covered.get(row, 0) + 1
    for row, _s in real_rows(*meta):
        assert covered.get(row) == 1, (row, covered.get(row))
    inert = len(offsets) - 1                # the last sequence slot
    inert_tiles = [t for t in tiles if t[3] == inert]
    assert len(inert_tiles) == int((seq_of_block == inert).sum())
    assert all(n == BQ8 for _, n, _, _ in inert_tiles)


def test_ragged_tiles_heights_follow_the_group_alone():
    """The same run gives the same tiles in any buffer and at any kv
    head count: only G sets the height (K10d's shard does the same work as
    its slice of the one-device launch)."""
    for group in (1, 2, 4, 8, 16):
        a = kattn.ragged_tiles(*flat_meta([(0, 300)], 304), group)[0]
        b = kattn.ragged_tiles(*flat_meta([(0, 300)], 1024), group)[0]
        assert [t for t in b if t[3] == 0] == a[:len([t for t in b
                                                      if t[3] == 0])]
        height = 2 * (64 // group)
        assert [n for _, n, _, s in a if s == 0][:-1] == [height] * (
            -(-304 // height) - 1)


def test_ragged_tiles_arbitrary_runs():
    """The 'arbitrary' buffer, item by item: sequence 0's second run
    (decode-shaped too) is a tile, since only a sequence's first run is a
    decode item; sequence 1's 16-row run is one decode item; sequence 2
    starts at block_qstart 16."""
    tiles, decode = kattn.ragged_tiles(*META["arbitrary"], 4)
    assert decode == [(0, 0), (8, 1)]
    assert (24, 8, 99, 0) in tiles
    assert (32, 24, 26, 2) in tiles
    assert [(r, s) for r, _, _, s in tiles if s == 3] == [(56, 3), (64, 3)]


# --- ragged_tile_ref against the JAX kernel at the tile edges ---

# (H, K, D, ps, T, runs [(offset, rows)], window, softcap). G=4 (tiles of
# 32 rows): runs of 1, 7, 8, 9, 31, 32 and 33 rows and inert blocks; G=1
# (128-row tiles): a chunk starting mid-page, 129 rows; G=2: a window
# crossing a key tile; G=8 (16-row tiles): 15, 16, 17 rows, softcap; G=16
# (8-row tiles) at D=256 with window and softcap; decode rows over 64 and
# 65 cells (a tile, then a decode item). Decode rows over more than 64
# cells everywhere else.
EDGES = {
    "g4_run_lengths": (8, 2, 64, 16, 192, [(70, 1), (5, 7), (30, 8), (0, 9),
                                           (41, 31), (3, 32), (20, 33)],
                       None, None),
    "g1_mid_page": (2, 2, 64, 16, 152, [(13, 129), (200, 1)], None, None),
    "g2_window_crosses_tile": (4, 2, 128, 32, 96, [(50, 70), (90, 1)], 40,
                               None),
    "g8_softcap": (8, 1, 128, 16, 72, [(7, 15), (20, 16), (33, 17),
                                       (64, 1)], None, 30.0),
    "g16_d256_window_softcap": (16, 1, 256, 32, 48, [(5, 7), (10, 9),
                                                     (70, 1), (0, 8)],
                                24, 20.0),
    "decode_at_64_and_65": (8, 2, 64, 16, 48, [(63, 1), (64, 1), (0, 20)],
                            None, None),
}


def edge_inputs(name, seed):
    """q [T,H,D], clean and NaN-poisoned pools, tables and metadata of an
    EDGES case; every sequence's pages shuffled, page 0 the scratch page
    the inert sequence reads."""
    H, K, D, ps, T, runs, _, _ = EDGES[name]
    rng = np.random.default_rng(seed)
    meta = flat_meta(runs, T)
    valid = meta[3]
    pp = -(-max(valid) // ps) + 1
    n = len(runs)
    tables = np.zeros((n + 1, pp), np.int32)
    tables[:n] = (rng.permutation(n * pp) + 1).reshape(n, pp)
    k = rng.standard_normal((1 + n * pp, ps, K, D)).astype(np.float32)
    v = rng.standard_normal((1 + n * pp, ps, K, D)).astype(np.float32)
    k_dirty, v_dirty = k.copy(), v.copy()
    for s in range(n):
        for j, page in enumerate(tables[s]):
            lo = max(int(valid[s]) - j * ps, 0)
            if lo < ps:
                k_dirty[page, lo:] = np.nan
                v_dirty[page, lo:] = np.nan
    q = rng.standard_normal((T, H, D)).astype(np.float32) * D ** -0.5
    return q, (k, v), (k_dirty, v_dirty), tables, meta


def jax_ragged(q, pools, tables, meta, window, softcap, **kw):
    return np.asarray(pattn.ragged_paged_attention(
        jnp.asarray(q), *(jnp.asarray(x) for x in pools),
        jnp.asarray(tables), *(jnp.asarray(x) for x in meta),
        sliding_window=window, softcap=softcap, interpret=True, **kw))


def port_args(q, pools, tables, meta, dtype=torch.float32):
    return ([torch.from_numpy(x).to(dtype) for x in (q, *pools)]
            + [torch.from_numpy(np.asarray(x)) for x in (tables, *meta)])


@pytest.mark.parametrize("name", sorted(EDGES))
def test_ragged_tile_ref_at_tile_edges_matches_jax_kernel(name):
    """Real rows within TOL of the JAX kernel (which reads clean pools);
    pad rows 0; the plain version K3's wrapper runs on the CPU agrees on
    every row; NaN past every kv_valid reaches no row."""
    window, softcap = EDGES[name][6:]
    q, clean, dirty, tables, meta = edge_inputs(name, 61)
    ref = jax_ragged(q, clean, tables, meta, window, softcap)
    args = port_args(q, dirty, tables, meta)
    kw = dict(sliding_window=window, softcap=softcap)
    ours = kattn.ragged_tile_ref(*args, **kw).numpy()
    plain = kattn.ragged_paged_attention(*args, **kw).numpy()
    assert np.isfinite(ours).all()
    rows = [r for r, _ in real_rows(*meta)]
    np.testing.assert_allclose(ours[rows], ref[rows], **TOL)
    np.testing.assert_allclose(ours, plain, **TOL)
    pad = np.ones(len(q), bool)
    pad[rows] = False
    assert np.all(ours[pad] == 0.0)


def quant_pools(rng, pools, bits, tables, valid, ps):
    """The pools quantized (kv_quant.quantize_cells), twice: clean, and
    dirty with a random payload and NaN scales at or past every
    sequence's kv_valid."""
    spec = kvq.KVQuantSpec(bits=bits, group=32)
    clean, dirty = [], []
    for x in pools:
        qx, sx = kvq.quantize_cells(torch.from_numpy(x), spec)
        qx, sx = qx.numpy(), sx.numpy()
        qd, sd = qx.copy(), sx.copy()
        for row, n in zip(tables[:-1], valid[:-1]):
            for j, page in enumerate(row):
                lo = max(int(n) - j * ps, 0)
                if lo < ps:
                    qd[page, lo:] = rng.integers(-128, 128,
                                                 size=qd[page, lo:].shape)
                    sd[page, lo:] = np.nan
        clean += [qx, sx]
        dirty += [qd, sd]
    return clean, dirty


@pytest.mark.parametrize("bits,name", [(8, "g4_run_lengths"),
                                       (4, "g2_window_crosses_tile")])
def test_quantized_ragged_tile_ref_matches_jax_kernel(bits, name):
    """K4 in K3's schedule: int8 and int4 pages (groups of 32) at one edge
    each, the same payload and scales on both sides; real rows."""
    H, K, D, ps, T, runs, window, softcap = EDGES[name]
    rng = np.random.default_rng(62 + bits)
    q, clean, _, tables, meta = edge_inputs(name, 62 + bits)
    (kq, ks, vq, vs), (kqd, ksd, vqd, vsd) = quant_pools(
        rng, clean, bits, tables, meta[3], ps)
    ref = jax_ragged(q, (kq, vq), tables, meta, window, softcap,
                     k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                     kv_bits=bits)
    args = ([torch.from_numpy(x) for x in (q, kqd, vqd)]
            + [torch.from_numpy(np.asarray(x)) for x in (tables, *meta)])
    ours = kattn.ragged_tile_ref(
        *args, sliding_window=window, softcap=softcap,
        k_scale=torch.from_numpy(ksd), v_scale=torch.from_numpy(vsd),
        kv_bits=bits).numpy()
    rows = [r for r, _ in real_rows(*meta)]
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours[rows], ref[rows], **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["g4_run_lengths", "g2_window_crosses_tile",
                                  "decode_at_64_and_65"])
def test_ragged_tile_ref_shard_equals_full_slice(name, dtype):
    """K10d's premise: one shard's kv heads (and their query heads) give
    the bits of the full-head call's slice, the tiles and splits being the
    same."""
    H, K, *_, window, softcap = EDGES[name]
    q, _, dirty, tables, meta = edge_inputs(name, 63)
    args = port_args(q, dirty, tables, meta, dtype)
    kw = dict(sliding_window=window, softcap=softcap)
    full = kattn.ragged_tile_ref(*args, **kw)
    half_h, half_k = H // 2, K // 2
    shard = list(args)
    shard[0] = args[0][:, H - half_h:].contiguous()
    shard[1] = args[1][:, :, K - half_k:].contiguous()
    shard[2] = args[2][:, :, K - half_k:].contiguous()
    assert torch.equal(kattn.ragged_tile_ref(*shard, **kw),
                       full[:, H - half_h:])
