"""PyTorch port, sequence-parallel long-context prefill
(engine/longcontext.py and the engine's ring path) against the JAX
package's on the same numpy inputs.

The JAX side runs in this process on the virtual 8-CPU mesh (its seq mesh
over 2 or 4 devices, shard_map). The port runs four gloo ranks, spawned
once for the module: the ring and Ulysses cores on rings of 4 and 2
ranks, the whole ring prefill on 4 ranks, and two engines on a {"data":
2, "model": 2} mesh whose weights each rank holds as its model shard (the
ring gathers each layer's shards before it runs): a paged ring engine on
a three-row batch with a pad row, its one-row follow-up turn, a fresh long
session through the SessionScheduler on the mesh, and a contiguous int8
engine on Ulysses. On one device (ring width 1) the contiguous, paged
and int8 ring engines, the chunked fallback below a page boundary, the
scheduler's prologue and the LoRA decline. Everything runs in f32.

Tolerances: the attention cores (f32 products of f32 inputs, the same
online update in the same key blocks) within CORE_TOL; the ring prefill's
last-token logits and caches within PREFILL_TOL; every engine's greedy
tokens and committed records identical. This module imports only torch
and numpy at its top (the spawned ranks import it)."""

import numpy as np
import pytest
import torch

from theroundtaible_tpu_torch.engine import distributed

SPAWN_TIMEOUT_S = 300.0
CORE_TOL = 2e-5
PREFILL_TOL = 2e-4
T = 96            # past tiny-mistral's 64-key window
BLOCK = 16        # key blocks of both packages' cores
VALID = (T, T - 11)
CORE_MODELS = {"tiny-gemma": {"attn_logit_softcap": 50.0},
               "tiny-llama": {}, "tiny-mistral": {}}
MESH = {"data": 2, "model": 2}
MAX_NEW = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _core_inputs(name, seed=0):
    """q [2,T,H,D], k/v [2,T,K,D] f32, positions [2,T], valid [2]."""
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    cfg = get_model_config(name, **CORE_MODELS[name])
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, T, cfg.num_heads, cfg.head_dim), np.float32)
    k = rng.standard_normal((2, T, cfg.num_kv_heads, cfg.head_dim),
                            np.float32)
    v = rng.standard_normal((2, T, cfg.num_kv_heads, cfg.head_dim),
                            np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T)).copy()
    return q, k, v, pos, np.asarray(VALID, np.int32)


def _tokens(seed, n, vocab=512):
    """A pre-tokenized prompt of n ids (bos first): a follow-up can then
    extend the committed record exactly."""
    rng = np.random.default_rng(seed)
    return [2] + [int(x) for x in rng.integers(5, vocab, n - 1)]


def _records(eng):
    return {n: list(eng.kv._slots[n].tokens) for n in eng.kv.slot_names()}


# --- the port's four ranks ---

def _cores_rank(rank):
    """Ring and Ulysses on rings of 4 and 2 (each rank its shard)."""
    from theroundtaible_tpu_torch.engine.longcontext import (
        build_seq_mesh, ring_attention, ulysses_attention)
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    out = {}
    for n in (4, 2):
        ring = build_seq_mesh(n)
        if rank >= n:
            continue
        tl = T // n
        sl = slice(rank * tl, (rank + 1) * tl)
        for name, over in CORE_MODELS.items():
            cfg = get_model_config(name, **over)
            q, k, v, pos, valid = (torch.from_numpy(x)
                                   for x in _core_inputs(name))
            q, k, v, pos = q[:, sl], k[:, sl], v[:, sl], pos[:, sl]
            out[(n, name, "ring")] = ring_attention(
                q, k, v, pos, pos, valid, cfg, ring, BLOCK).numpy()
            out[(n, name, "ulysses")] = ulysses_attention(
                q, k, v, pos, valid, cfg, ring, BLOCK).numpy()
    return out


PREFILL_LENGTHS = (64, 40)


def _prefill_inputs(vocab):
    b, tpad = 2, 64
    tokens = (np.arange(b * tpad).reshape(b, tpad) * 7 + 3) % vocab
    positions = np.broadcast_to(np.arange(tpad), (b, tpad)).copy()
    return (tokens.astype(np.int64), positions.astype(np.int32),
            np.asarray(PREFILL_LENGTHS, np.int32))


def _prefill_rank(tree):
    """make_ring_prefill on the 4-rank ring with whole weights."""
    from theroundtaible_tpu_torch.engine.longcontext import (
        build_seq_mesh, make_ring_prefill)
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    cfg = get_model_config("tiny-gemma")
    params = params_from_numpy(tree, cfg, torch.float32, "cpu")
    ring = build_seq_mesh(4)
    tokens, positions, lengths = (torch.from_numpy(x) for x in
                                  _prefill_inputs(cfg.vocab_size))
    out = {}
    for scheme in ("ring", "ulysses"):
        logits, caches = make_ring_prefill(cfg, ring, scheme)(
            params, tokens, positions, lengths)
        out[scheme] = (logits.numpy(),
                       [(k.numpy(), v.numpy()) for k, v in caches])
    return out


PAGED_KW = dict(num_slots=4, kv_layout="paged", page_size=32, num_pages=40,
                seed=3, seq_parallel=4, long_threshold=32)
INT8_KW = dict(num_slots=4, quant="int8", seed=3, seq_parallel=4,
               long_threshold=32, long_scheme="ulysses")
# test_paging.py's ring case: 256, 200 and 180 tokens (tpad 256), three
# rows over two replicas (a pad row)
PAD_ROWS = [("a", [2] + [7] * 255), ("b", [2] + [9] * 199),
            ("c", [2] + [11] * 179)]


def _mesh_workload(eng):
    """The padded batch, a one-row follow-up turn on row b (its delta
    prefills chunked), and the ring dispatches of each."""
    out = {"batch": eng.generate_batch(PAD_ROWS, max_new_tokens=MAX_NEW),
           "batch_rings": eng.ring_dispatches}
    follow = list(eng.kv._slots["b"].tokens) + _tokens(5, 12)[1:]
    out["follow"] = eng.generate_batch([("b", follow)],
                                       max_new_tokens=MAX_NEW)
    out["follow_reused"] = eng.last_stats.reused_tokens
    out["follow_rings"] = eng.ring_dispatches
    out["records"] = _records(eng)
    return out


SCHED_PROMPT = [("s", _tokens(9, 200))]


def _mesh_rank(rank, trees):
    """The two engines on {"data": 2, "model": 2}, every rank its shard of
    the weights; rank 0's scheduler serves one fresh long session and the
    others follow."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.sampling import SamplingParams
    from theroundtaible_tpu_torch.engine.scheduler import scheduler_for
    from theroundtaible_tpu_torch.engine.sharding import Mesh
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    cfg = get_model_config("tiny-llama", max_seq_len=512)
    coords = Mesh(MESH["data"], MESH["model"], rank)
    sp = SamplingParams(temperature=0.0, max_new_tokens=MAX_NEW)

    def build(tree, **kw):
        return InferenceEngine(
            cfg, mesh_shape=dict(MESH), dtype=torch.float32, sampling=sp,
            params=params_from_numpy(tree, cfg, torch.float32, "cpu",
                                     mesh=coords), device="cpu", **kw)

    out = {}
    eng = build(trees["paged"], **PAGED_KW)
    out["paged"] = _mesh_workload(eng)
    out["paged"]["paged_direct"] = eng.paged_direct
    out["paged"]["ring_width"] = eng.seq_ring.size
    out["paged"]["p2p"] = distributed.p2p_counts()
    for name in list(eng.kv.slot_names()):
        eng.kv.release(name)
    before = eng.ring_dispatches
    sched = scheduler_for(eng)
    if rank == 0:
        out["sched"] = sched.submit("long", SCHED_PROMPT,
                                    max_new_tokens=MAX_NEW)[0]
        sched.close()
    else:
        sched.close(timeout_s=240)
    out["sched_rings"] = eng.ring_dispatches - before
    del eng, sched
    eng = build(trees["int8"], **INT8_KW)
    out["int8"] = {"batch": eng.generate_batch(PAD_ROWS[:2],
                                               max_new_tokens=MAX_NEW),
                   "rings": eng.ring_dispatches,
                   "records": _records(eng)}
    return out


def _rank(rank, prefill_tree, mesh_trees):
    torch.set_num_threads(1)
    distributed.reset_p2p_counts()
    out = {"cores": _cores_rank(rank), "p2p_cores": distributed.p2p_counts()}
    out["prefill"] = _prefill_rank(prefill_tree)
    out["mesh"] = _mesh_rank(rank, mesh_trees)
    return out


# --- the JAX side ---

def _jax_cores():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from theroundtaible_tpu.engine.longcontext import (
        SEQ_AXIS, _shard_map, build_seq_mesh, ring_attention,
        ulysses_attention)
    from theroundtaible_tpu.engine.models.registry import get_model_config
    out = {}
    spec = P(None, SEQ_AXIS)
    for n in (4, 2):
        mesh = build_seq_mesh(n)
        for name, over in CORE_MODELS.items():
            cfg = get_model_config(name, **over)
            args = tuple(jnp.asarray(x) for x in _core_inputs(name))

            def ring(q, k, v, pos, valid, cfg=cfg, n=n):
                return ring_attention(q, k, v, pos, pos, valid, cfg,
                                      SEQ_AXIS, n)

            def uly(q, k, v, pos, valid, cfg=cfg, n=n):
                return ulysses_attention(q, k, v, pos, valid, cfg,
                                         SEQ_AXIS, n, block=BLOCK)

            for scheme, fn in (("ring", ring), ("ulysses", uly)):
                got = jax.jit(_shard_map(
                    fn, mesh, in_specs=(spec, spec, spec, spec, P(None)),
                    out_specs=spec))(*args)
                out[(n, name, scheme)] = np.asarray(got)
    return out


def _jax_prefill():
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.longcontext import (build_seq_mesh,
                                                       make_ring_prefill)
    from theroundtaible_tpu.engine.models.common import init_params
    from theroundtaible_tpu.engine.models.registry import get_model_config
    cfg = get_model_config("tiny-gemma")
    params = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    args = tuple(jnp.asarray(x) for x in _prefill_inputs(cfg.vocab_size))
    out = {}
    for scheme in ("ring", "ulysses"):
        logits, caches = make_ring_prefill(cfg, build_seq_mesh(4),
                                           scheme)(params, *args)
        out[scheme] = (np.asarray(logits),
                       [(np.asarray(k), np.asarray(v)) for k, v in caches])
    return jax.device_get(params), out


def _counting_ring(jeng):
    """Count the JAX engine's ring dispatches (its own _prefill_ring,
    wrapped on the instance)."""
    jeng.ring_dispatches = 0
    inner = jeng._prefill_ring

    def counted(*args, **kwargs):
        jeng.ring_dispatches += 1
        return inner(*args, **kwargs)
    jeng._prefill_ring = counted
    return jeng


def _jax_mesh():
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu.engine.sampling import \
        SamplingParams as JaxSampling
    from theroundtaible_tpu.engine.scheduler import \
        SessionScheduler as JaxScheduler

    def build(**kw):
        return _counting_ring(JaxEngine(
            jax_config("tiny-llama", max_seq_len=512),
            mesh_shape=dict(MESH), dtype=jnp.float32,
            sampling=JaxSampling(temperature=0.0, max_new_tokens=MAX_NEW),
            **kw))

    jeng = build(**PAGED_KW)
    trees = {"paged": jax.device_get(jeng.params)}
    ref = {"paged": _mesh_workload(jeng)}
    for name in list(jeng.kv.slot_names()):
        jeng.kv.release(name)
    before = jeng.ring_dispatches
    sched = JaxScheduler(jeng)
    try:
        ref["sched"] = sched.submit("long", SCHED_PROMPT,
                                    max_new_tokens=MAX_NEW)[0]
    finally:
        sched.close()
    ref["sched_rings"] = jeng.ring_dispatches - before
    qeng = build(**INT8_KW)
    trees["int8"] = jax.device_get(qeng.params)
    ref["int8"] = {"batch": qeng.generate_batch(PAD_ROWS[:2],
                                                max_new_tokens=MAX_NEW),
                   "rings": qeng.ring_dispatches, "records": _records(qeng)}
    return trees, ref


@pytest.fixture(scope="module")
def runs():
    from concurrent.futures import ThreadPoolExecutor
    prefill_tree, prefill_ref = _jax_prefill()
    mesh_trees, mesh_ref = _jax_mesh()
    # the ranks run while this process computes JAX's cores
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(distributed.launch, _rank, 4, "gloo", "cpu",
                            args=(prefill_tree, mesh_trees),
                            timeout_s=SPAWN_TIMEOUT_S)
        cores = _jax_cores()
        ranks = ranks.result()
    return {"cores": cores, "prefill": prefill_ref, "mesh": mesh_ref}, ranks


# --- the cores ---

@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("name", list(CORE_MODELS))
@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_sharded_cores_match_jax(runs, n, name, scheme):
    """Each rank's shard of ring_attention / ulysses_attention equals the
    JAX shard_map's on a seq mesh of the same size: softcap (tiny-gemma
    at 50), GQA (every tiny model; Ulysses on 4 ranks GQA-expands the 2
    kv heads) and the sliding window (tiny-mistral, 64 of 96 keys)."""
    ref, ranks = runs
    got = np.concatenate([ranks[r]["cores"][(n, name, scheme)]
                          for r in range(n)], axis=1)
    np.testing.assert_allclose(got, ref["cores"][(n, name, scheme)],
                               rtol=CORE_TOL, atol=CORE_TOL)


def test_ring_hops_and_all_to_alls_are_counted(runs):
    """Each ring of n ranks makes n - 1 hops per call; Ulysses four
    all-to-alls per call, on the ranks of its ring only."""
    _ref, ranks = runs
    calls = len(CORE_MODELS)
    for r, out in enumerate(ranks):
        p2p = out["p2p_cores"]
        rings = [n for n in (4, 2) if r < n]
        assert p2p["ring_hops"] == calls * sum(n - 1 for n in rings)
        assert p2p["all_to_all_calls"] == calls * 4 * len(rings)
        assert p2p["ring_s"] > 0 and p2p["all_to_all_s"] > 0


@pytest.mark.parametrize("name", list(CORE_MODELS))
def test_blockwise_sdpa_matches_jax(name):
    """The local core alone, one device, in key blocks of BLOCK."""
    import jax.numpy as jnp
    from theroundtaible_tpu.engine import longcontext as jlc
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu_torch.engine import longcontext as tlc
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    q, k, v, pos, valid = _core_inputs(name, seed=2)
    want = jlc.blockwise_sdpa(*(jnp.asarray(x) for x in (q, k, v, pos, pos,
                                                         valid)),
                              jax_config(name, **CORE_MODELS[name]),
                              block=BLOCK)
    got = tlc.blockwise_sdpa(*(torch.from_numpy(x) for x in (q, k, v, pos,
                                                            pos, valid)),
                             get_model_config(name, **CORE_MODELS[name]),
                             block=BLOCK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=CORE_TOL, atol=CORE_TOL)


@pytest.mark.parametrize("name", list(CORE_MODELS))
def test_online_update_and_finalize_match_jax(name):
    """Two online steps from the empty state - a block some queries may
    attend, then one no query may (all masked: the state must not move) -
    and the finalize, against JAX's _online_update and _finalize; and
    _gqa_expand."""
    import jax.numpy as jnp
    from theroundtaible_tpu.engine import longcontext as jlc
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu_torch.engine import longcontext as tlc
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    q, k, v, pos, valid = _core_inputs(name, seed=3)
    tq = slice(40, 72)
    blocks = (slice(24, 56), slice(80, 96))    # the second: all causal-masked
    b, h, d = q.shape[0], q.shape[2], q.shape[3]
    jcfg = jax_config(name, **CORE_MODELS[name])
    tcfg = get_model_config(name, **CORE_MODELS[name])
    t = tq.stop - tq.start
    js = (jnp.full((b, h, t), -jnp.inf), jnp.zeros((b, h, t)),
          jnp.zeros((b, h, t, d)))
    ts = (torch.full((b, h, t), float("-inf")), torch.zeros((b, h, t)),
          torch.zeros((b, h, t, d)))
    for blk in blocks:
        js = jlc._online_update(*js, jnp.asarray(q[:, tq]),
                                jnp.asarray(k[:, blk]), jnp.asarray(v[:, blk]),
                                jnp.asarray(pos[:, tq]),
                                jnp.asarray(pos[:, blk]), jnp.asarray(valid),
                                jcfg, jcfg.kv_repeat)
        ts = tlc._online_update(*ts, torch.from_numpy(q[:, tq]),
                                torch.from_numpy(k[:, blk]),
                                torch.from_numpy(v[:, blk]),
                                torch.from_numpy(pos[:, tq]),
                                torch.from_numpy(pos[:, blk]),
                                torch.from_numpy(valid), tcfg,
                                tcfg.kv_repeat)
        for got, want in zip(ts, js):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=CORE_TOL, atol=CORE_TOL)
    np.testing.assert_allclose(
        tlc._finalize(ts[1], ts[2], torch.float32).numpy(),
        np.asarray(jlc._finalize(js[1], js[2], jnp.float32)),
        rtol=CORE_TOL, atol=CORE_TOL)
    np.testing.assert_array_equal(
        tlc._gqa_expand(torch.from_numpy(k), 2).numpy(),
        np.asarray(jlc._gqa_expand(jnp.asarray(k), 2)))


def test_ulysses_refuses_heads_the_ring_does_not_divide():
    """JAX's refusal, with JAX's message (checked before any collective:
    a width-3 ring over 4 heads)."""
    import jax.numpy as jnp
    from theroundtaible_tpu.engine import longcontext as jlc
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu_torch.engine import longcontext as tlc
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    q, k, v, pos, valid = _core_inputs("tiny-llama")
    with pytest.raises(ValueError) as want:
        jlc.ulysses_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos), jnp.asarray(valid),
                              jax_config("tiny-llama"), axis_size=3)
    with pytest.raises(ValueError) as got:
        tlc.ulysses_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(pos),
                              torch.from_numpy(valid),
                              get_model_config("tiny-llama"),
                              tlc.SeqRing(size=3))
    assert str(got.value) == str(want.value)


# --- the whole prefill ---

@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_ring_prefill_logits_and_caches_match_jax(runs, scheme):
    """make_ring_prefill on four ranks: the last-token logits (every rank
    the same) and every layer's whole-sequence K/V inside the valid
    lengths equal JAX's program on a 4-device seq mesh."""
    ref, ranks = runs
    want_logits, want_caches = ref["prefill"][scheme]
    for out in ranks:
        logits, caches = out["prefill"][scheme]
        np.testing.assert_allclose(logits, want_logits, rtol=PREFILL_TOL,
                                   atol=PREFILL_TOL)
        assert len(caches) == len(want_caches)
        for (k, v), (wk, wv) in zip(caches, want_caches):
            for i, n in enumerate(PREFILL_LENGTHS):
                np.testing.assert_allclose(k[i, :n], wk[i, :n],
                                           rtol=PREFILL_TOL,
                                           atol=PREFILL_TOL)
                np.testing.assert_allclose(v[i, :n], wv[i, :n],
                                           rtol=PREFILL_TOL,
                                           atol=PREFILL_TOL)


PAD_CASES = [(100, 8, 512), (8, 8, 512), (513, 8, 1024), (600, 8, 512),
             (500, 8, 510), (511, 8, 510), (2048, 1, 8192),
             (4000, 1, 8192), (5000, 2, 8192), (9000, 1, 8192), (7, 4, 6),
             (1, 1, 1)]


@pytest.mark.parametrize("lengths_max,n_seq,cache_len", PAD_CASES)
def test_pad_to_ring_equals_jax(lengths_max, n_seq, cache_len):
    from theroundtaible_tpu.engine.longcontext import pad_to_ring as jax_pad
    from theroundtaible_tpu_torch.engine.longcontext import pad_to_ring
    assert pad_to_ring(lengths_max, n_seq, cache_len) == jax_pad(
        lengths_max, n_seq, cache_len)


# --- the engines on {"data": 2, "model": 2} ---

@pytest.mark.parametrize("part", ["batch", "batch_rings", "follow",
                                  "follow_reused", "follow_rings",
                                  "records"])
def test_mesh_ring_engine_matches_jax(runs, part):
    """Three fresh rows over two data replicas (one pad row) take the ring
    over the four ranks, each rank writing its replica's rows and its kv
    heads into its pages; the one-row follow-up reuses the prefix and
    prefills its delta chunked. Tokens, reuse, ring dispatches and
    records equal JAX's engine on the same mesh on every rank."""
    ref, ranks = runs
    for out in ranks:
        assert out["mesh"]["paged"][part] == ref["mesh"]["paged"][part]
    assert ref["mesh"]["paged"]["batch_rings"] == 1
    assert ref["mesh"]["paged"]["follow_rings"] == 1
    assert ref["mesh"]["paged"]["follow_reused"] > 0


def test_mesh_ring_is_the_engines_ranks(runs):
    """The ring spans the engine's four ranks, pool-direct, and its hops
    were counted."""
    _ref, ranks = runs
    for out in ranks:
        paged = out["mesh"]["paged"]
        assert paged["ring_width"] == 4 and paged["paged_direct"]
        assert paged["p2p"]["ring_hops"] > 0


def test_mesh_scheduler_takes_the_ring_as_jax(runs):
    """A fresh long session admitted with nothing decoding takes the
    scheduler's blocking prologue, and so the ring, in both packages: one
    ring dispatch on every rank, JAX's tokens."""
    ref, ranks = runs
    assert ref["mesh"]["sched_rings"] == 1
    assert ranks[0]["mesh"]["sched"] == ref["mesh"]["sched"]
    for out in ranks:
        assert out["mesh"]["sched_rings"] == 1


@pytest.mark.parametrize("part", ["batch", "rings", "records"])
def test_mesh_int8_ulysses_engine_matches_jax(runs, part):
    """Int8 weights on the contiguous layout with Ulysses over four ranks
    (one head each, the kv heads GQA-expanded): JAX's tokens."""
    ref, ranks = runs
    assert ref["mesh"]["int8"]["rings"] == 1
    for out in ranks:
        assert out["mesh"]["int8"][part] == ref["mesh"]["int8"][part]


# --- one device: the ring of width 1 ---

ONE_KW = dict(num_slots=2, seq_parallel=4, long_threshold=32)
ONE_LAYOUTS = {"contiguous": {}, "paged": dict(kv_layout="paged",
                                               page_size=32),
               "int8": dict(quant="int8"),
               # the ring's K/V quantized on write into int8 pages
               "int8_pages": dict(kv_layout="paged", page_size=32,
                                  kv_quant="int8")}


def _one_device(kind, **over):
    """(JAX engine, port engine on its weights, port chunked engine):
    tiny-gemma f32 at 256 positions, one device."""
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu.engine.sampling import \
        SamplingParams as JaxSampling
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.sampling import SamplingParams
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    kw = {**ONE_KW, **ONE_LAYOUTS[kind], **over}
    jeng = _counting_ring(JaxEngine(
        jax_config("tiny-gemma", max_seq_len=256),
        mesh_shape={"data": 1, "model": 1}, dtype=jnp.float32,
        sampling=JaxSampling(temperature=0.0, max_new_tokens=MAX_NEW), **kw))
    cfg = get_model_config("tiny-gemma", max_seq_len=256)
    tree = jax.device_get(jeng.params)

    def port(**extra):
        return InferenceEngine(
            cfg, dtype=torch.float32,
            sampling=SamplingParams(temperature=0.0, max_new_tokens=MAX_NEW),
            params=params_from_numpy(tree, cfg, torch.float32, "cpu"),
            device="cpu", **{**kw, **extra})
    return jeng, port(), port(seq_parallel=0)


def _two_turns(eng, prompt):
    first = eng.generate_batch([("k", prompt)], max_new_tokens=MAX_NEW)
    rings = eng.ring_dispatches
    follow = list(eng.kv._slots["k"].tokens) + _tokens(11, 9)[1:]
    second = eng.generate_batch([("k", follow)], max_new_tokens=MAX_NEW)
    return {"texts": first + second, "rings": (rings, eng.ring_dispatches),
            "reused": eng.last_stats.reused_tokens,
            "records": _records(eng)}


@pytest.mark.parametrize("kind", list(ONE_LAYOUTS))
def test_one_device_ring_engine_matches_jax(kind):
    """A fresh 100-token prompt takes the width-1 ring (padded to 128, a
    page boundary) in both packages, then the follow-up turn reuses it and
    prefills its delta chunked: JAX's tokens and records, and the port's
    own chunked engine's."""
    jeng, teng, chunked = _one_device(kind)
    prompt = _tokens(1, 100)
    got, want = _two_turns(teng, prompt), _two_turns(jeng, prompt)
    assert got == want
    assert got["rings"] == (1, 1) and got["reused"] > 0
    assert teng.seq_ring.size == 1 and teng.ring_seconds > 0
    plain = _two_turns(chunked, prompt)
    assert plain["texts"] == got["texts"]
    assert plain["rings"] == (0, 0)


def test_off_page_boundary_prefills_chunked_as_jax():
    """A 20-token fresh prompt over a threshold of 16 pads to 32; on
    64-token pages that is no page boundary, so both packages prefill it
    chunked (the JAX rule, not widened)."""
    jeng, teng, _ = _one_device("paged", long_threshold=16, page_size=64)
    prompt = _tokens(4, 20)
    got, want = _two_turns(teng, prompt), _two_turns(jeng, prompt)
    assert got == want and got["rings"] == (0, 0)


def test_one_device_scheduler_prologue_takes_the_ring():
    """The SessionScheduler's blocking prologue for a fresh long session
    runs the engine's prefill, so the ring, as JAX's does."""
    from theroundtaible_tpu.engine.scheduler import \
        SessionScheduler as JaxScheduler
    from theroundtaible_tpu_torch.engine.scheduler import scheduler_for
    jeng, teng, _ = _one_device("paged")
    prompt = [("k", _tokens(6, 100))]
    out = []
    for eng, sched in ((jeng, JaxScheduler(jeng)),
                       (teng, scheduler_for(teng))):
        try:
            out.append((sched.submit("s", prompt,
                                     max_new_tokens=MAX_NEW)[0],
                        eng.ring_dispatches))
        finally:
            sched.close()
    assert out[0] == out[1] and out[1][1] == 1


def test_lora_declines_on_seq_parallel():
    """A seq_parallel engine declines its `lora:` block with JAX's reason
    (the ring prefill has no LoRA seam)."""
    from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    lora = {"rank": 4, "max_adapters": 2}
    jeng = JaxEngine(jax_config("tiny-llama", max_seq_len=128),
                     mesh_shape={"data": 1, "model": 1}, num_slots=2,
                     seq_parallel=2, lora=dict(lora))
    teng = InferenceEngine(get_model_config("tiny-llama", max_seq_len=128),
                           num_slots=2, seq_parallel=2, lora=dict(lora),
                           device="cpu")
    assert jeng.lora is None and teng.lora is None
    assert teng.lora_reason == jeng.lora_reason == \
        "seq_parallel:ring-prefill"
    assert teng.describe()["lora"]["reason"] == "seq_parallel:ring-prefill"


def test_warmup_warms_the_ring_lengths():
    """warmup() runs the chunked buckets with the ring off (a delta
    prefill's bucket never first runs mid-serve), then one ring prefill
    per length from long_threshold, doubling, to the cache cap (256 - 64
    - 1 = 191 positions here), as the JAX engine's warmup does."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    eng = InferenceEngine(get_model_config("tiny-llama", max_seq_len=256),
                          num_slots=2, seq_parallel=2, long_threshold=64,
                          device="cpu")
    eng.warmup(max_prompt_tokens=64)
    assert eng.ring_dispatches == 3      # 64, 128 and 191 tokens
    assert eng._ring_prefill is not None
