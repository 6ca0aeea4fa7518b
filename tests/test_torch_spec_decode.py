"""PyTorch port, speculative decoding's host side and device seam against
the JAX package's (engine/spec_decode.py and tests/test_spec_decode.py).

The same numpy-seeded inputs go through both packages: the n-gram drafter,
the chain and tree acceptance rules, the per-row throttle with its
re-probe hysteresis, the `spec_decode:` block's resolution, the verify
batch builder (`score_width`, `copy_pairs`), `forward_ragged` with verify
rows and tree page copies (f32, on unquantized, int8 and int4 pages), and
the engines' resolved provenance. Scheduled serving with every drafter:
tests/test_torch_spec_scheduler.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theroundtaible_tpu.engine import kv_quant as jkvq
from theroundtaible_tpu.engine import serving_loop as jax_loop
from theroundtaible_tpu.engine import spec_decode as jsd
from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
from theroundtaible_tpu.engine.models.common import init_params as \
    jax_init_params
from theroundtaible_tpu.engine.models.registry import \
    get_model_config as jax_config
from theroundtaible_tpu.engine.paged_forward import \
    forward_ragged as jax_forward_ragged
from theroundtaible_tpu_torch.engine import kv_quant as kvq
from theroundtaible_tpu_torch.engine import serving_loop
from theroundtaible_tpu_torch.engine import spec_decode as sd
from theroundtaible_tpu_torch.engine.engine import InferenceEngine
from theroundtaible_tpu_torch.engine.models.registry import \
    get_model_config as torch_config
from theroundtaible_tpu_torch.engine.paged_forward import forward_ragged
from theroundtaible_tpu_torch.engine.weights import params_from_numpy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the n-gram drafter ---

# tests/test_spec_decode.py's hand cases: (corpus, draft(n) calls).
NGRAM_CASES = [
    ([1, 2, 3, 4, 5, 1, 2, 3], [4, 2]),
    ([7, 1, 9, 2, 9], [3]),
    ([1, 2, 3], [4]),
    ([], [4]),
    ([1, 1], [0, 3]),
    ([7, 1, 2, 4, 1, 2, 9, 7, 1, 2], [3]),
    ([1, 2, 3, 4, 1, 2], [3]),
]


@pytest.mark.parametrize("corpus,calls", NGRAM_CASES)
def test_ngram_hand_cases_match_jax(corpus, calls):
    ours, ref = sd.NGramDrafter(corpus), jsd.NGramDrafter(corpus)
    assert len(ours) == len(ref)
    for n in calls:
        assert ours.draft(n) == ref.draft(n)
        for branch in (1, 2, 3):
            assert ours.draft_paths(n, branch) == ref.draft_paths(n, branch)
    assert isinstance(ours, sd.Drafter)


@pytest.mark.parametrize("seed", range(6))
def test_ngram_incremental_drafts_match_jax(seed):
    """A random corpus over a small vocabulary (so grams recur), indexed
    as a prompt and then synced one committed chunk at a time: every draft
    and every tree path set equals the JAX drafter's after every sync."""
    rng = np.random.default_rng(seed)
    vocab = int(rng.integers(3, 9))
    prompt = [int(x) for x in rng.integers(0, vocab, int(rng.integers(0, 30)))]
    produced = [int(x) for x in rng.integers(0, vocab, 60)]
    ours, ref = sd.NGramDrafter(prompt), jsd.NGramDrafter(prompt)
    done = 0
    while done < len(produced):
        done = min(done + int(rng.integers(1, 6)), len(produced))
        ours.sync_parts(prompt, produced[:done])
        ref.sync_parts(prompt, produced[:done])
        assert len(ours) == len(ref) == len(prompt) + done
        for n in range(0, 7):
            assert ours.draft(n) == ref.draft(n), (done, n)
            for branch in (1, 2, 3):
                assert ours.draft_paths(n, branch) == \
                    ref.draft_paths(n, branch), (done, n, branch)
    fresh = sd.NGramDrafter(prompt + produced)
    for n in range(1, 6):
        assert fresh.draft(n) == ours.draft(n)


# --- acceptance rules ---


@pytest.mark.parametrize("seed", range(4))
def test_accept_prefix_and_tree_match_jax(seed):
    """Random drafts and device tokens over a 3-token vocabulary (so
    matches happen at every depth): the chain rule and the tree walk give
    the JAX module's (emit, accepted[, winner])."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(300):
        k = int(rng.integers(0, 6))
        drafts = [int(x) for x in rng.integers(0, 3, k)]
        props = [int(x) for x in rng.integers(0, 3, k + 1)]
        assert sd.accept_prefix(drafts, props) == \
            jsd.accept_prefix(drafts, props)
        npaths = int(rng.integers(1, 4))
        paths = [[int(x) for x in rng.integers(0, 3, rng.integers(1, 5))]
                 for _ in range(npaths)]
        tprops = [[int(x) for x in rng.integers(0, 3, len(p) + 1)]
                  for p in paths]
        assert sd.accept_tree(paths, tprops) == \
            jsd.accept_tree(paths, tprops)
    # tests/test_spec_decode.py's hand cases
    assert sd.accept_prefix([4, 5], [4, 5, 9]) == ([4, 5, 9], 2)
    assert sd.accept_tree([[5, 6], [9, 7]], [[9, 1, 2], [9, 7, 4]]) == \
        ([9, 7, 4], 2, 1)
    assert sd.accept_tree([[5, 6, 7], [8]], [[8, 0, 0, 0], [8, 2]]) == \
        ([8, 2], 1, 1)


# --- the throttle and its re-probe hysteresis ---


def _counters(mod):
    return (mod.reprobes_seen(), mod.reprobe_recoveries_seen())


@pytest.mark.parametrize("floor,reprobe,seed", [
    (None, None, 0), (None, "4", 1), ("0.6", "3", 2), ("0.9", "1", 3),
    ("bogus", "x", 4), ("0.0", "8", 5),
])
def test_rowspec_throttle_and_reprobe_match_jax(monkeypatch, floor, reprobe,
                                                seed):
    """A random schedule of verify outcomes, idle marks, probe checks and
    failed probes through both packages' RowSpec: every return value, the
    throttle state, the window's rate and the module's re-probe counters
    move alike."""
    for name, value in (("ROUNDTABLE_SPEC_ACCEPT_FLOOR", floor),
                        ("ROUNDTABLE_SPEC_REPROBE", reprobe)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert sd.accept_floor() == jsd.accept_floor()
    assert sd.reprobe_interval() == jsd.reprobe_interval()
    rng = np.random.default_rng(seed)
    ours, ref = sd.RowSpec([1, 2, 3]), jsd.RowSpec([1, 2, 3])
    c0, j0 = _counters(sd), _counters(jsd)
    produced = 0
    trace = []
    for _ in range(200):
        op = int(rng.integers(0, 4))
        if op == 0:
            drafted = int(rng.integers(0, 5))
            # mostly-rejecting phases, then accepting ones
            accepted = int(rng.integers(0, drafted + 1)) \
                if rng.random() < 0.4 else 0
            got = (ours.note(drafted, accepted), ref.note(drafted, accepted))
        elif op == 1:
            produced += int(rng.integers(0, 4))
            got = (ours.should_draft(produced), ref.should_draft(produced))
        elif op == 2:
            ours.mark_idle(produced)
            ref.mark_idle(produced)
            got = (None, None)
        else:
            ours.probe_failed(produced)
            ref.probe_failed(produced)
            got = (None, None)
        assert got[0] == got[1]
        state = (ours.disabled, ours.probing, ours.drafted, ours.accepted,
                 round(ours.rate(), 9), list(ours.recent))
        assert state == (ref.disabled, ref.probing, ref.drafted,
                         ref.accepted, round(ref.rate(), 9),
                         list(ref.recent))
        trace.append(state[0])
        c1, j1 = _counters(sd), _counters(jsd)
        assert (c1[0] - c0[0], c1[1] - c0[1]) == (j1[0] - j0[0],
                                                  j1[1] - j0[1])
    if floor not in ("0.0",):
        assert any(trace), "the schedule never throttled the row"


def test_throttle_hand_cases(monkeypatch):
    """tests/test_spec_decode.py's throttle units on the port: trips once,
    spares accepting rows, ignores zero-draft dispatches, and a probe that
    proposes nothing waits a whole interval."""
    rs = sd.RowSpec([1, 2, 3])
    tripped = [rs.note(4, 0) for _ in range(sd.SPEC_MIN_DISPATCHES + 2)]
    assert tripped.count(True) == 1 and rs.disabled
    good = sd.RowSpec([1, 2, 3])
    for _ in range(sd.SPEC_WINDOW):
        assert not good.note(4, 3)
    assert not good.disabled and good.rate() == pytest.approx(0.75)
    assert not sd.RowSpec([]).note(0, 0)
    monkeypatch.setenv("ROUNDTABLE_SPEC_REPROBE", "4")
    rs = sd.RowSpec([1, 2, 3])
    for _ in range(sd.SPEC_MIN_DISPATCHES):
        rs.note(4, 0)
    rs.mark_idle(0)
    before = sd.reprobes_seen()
    assert rs.should_draft(4) and rs.probing
    rs.probe_failed(4)
    assert not rs.probing and sd.reprobes_seen() == before + 1
    assert not rs.should_draft(6) and rs.should_draft(8)


# --- the spec_decode: block ---

OPTION_CASES = [
    True, False, None, {}, {"drafter": "ngram"},
    {"drafter": "model", "tree": {"branch": 3, "depth": 2}, "max_draft": 5,
     "draft_checkpoint": "/x"},
    {"drafter": "lora", "adapter": "head", "enabled": True},
    {"tree": {"branch": 2}}, {"tree": {}}, {"drafter": "oracle"},
    {"tree": {"branch": 1}}, {"tree": {"branch": 2, "depth": 0}},
    {"tree": [2, 2]}, {"drafter": "lora"}, {"max_draft": "3"},
]


def _resolve(mod, flag):
    try:
        o = mod.SpecOptions.resolve(flag)
    except ValueError as e:
        return ("error", str(e))
    return (o.drafter, o.tree, o.max_draft, o.draft_checkpoint, o.adapter)


@pytest.mark.parametrize("flag", OPTION_CASES)
def test_spec_options_match_jax(flag):
    assert _resolve(sd, flag) == _resolve(jsd, flag)


@pytest.mark.parametrize("env", [None, "0", "false", "off", "1", "yes"])
@pytest.mark.parametrize("flag", [None, True, False, {"drafter": "model"},
                                  {"enabled": True}, {"enabled": False}])
def test_spec_enabled_matches_jax(monkeypatch, env, flag):
    if env is None:
        monkeypatch.delenv(sd.SPEC_ENV, raising=False)
    else:
        monkeypatch.setenv(sd.SPEC_ENV, env)
    assert sd.spec_enabled(flag) == jsd.spec_enabled(flag)
    assert sd.SPEC_ENV == jsd.SPEC_ENV


def test_module_constants_match_jax():
    for name in ("DRAFTER_KINDS", "DEFAULT_MAX_DRAFT", "NGRAM_MAX",
                 "SPEC_WINDOW", "SPEC_MIN_DISPATCHES", "SPEC_ACCEPT_FLOOR",
                 "SPEC_REPROBE_DISPATCHES", "DRAFT_SCOPE", "PROPOSE_RUN"):
        assert getattr(sd, name) == getattr(jsd, name), name
    assert sd.draft_slot_name("s\x1fk") == jsd.draft_slot_name("s\x1fk")
    assert issubclass(sd.DraftUnavailable, RuntimeError)


# --- the verify batch builder ---


def _verify_seqs(mod):
    t0 = np.array([4, 9, 2, 7], np.int32)
    t1 = np.array([5, 6, 3, 0], np.int32)
    t2 = np.array([1, 3, 8, 10], np.int32)
    return [mod.RaggedSeq([11, 12, 13, 14, 15], 30, t0, temperature=0.7,
                          top_k=5, top_p=0.9, n_scores=5),
            mod.RaggedSeq([8], 20, t1, n_scores=1),
            mod.RaggedSeq(list(range(3, 13)), 13, t2),
            mod.RaggedSeq([11, 21, 22], 30, t2, n_scores=2, adapter=2)]


@pytest.mark.parametrize("score_width,copy_pairs,copy_slots", [
    (5, None, 0), (5, [(9, 10)], 3), (6, [], 2), (5, [(1, 2), (3, 4)], 2),
    (0, None, 0),
])
def test_verify_batch_matches_jax(score_width, copy_pairs, copy_slots):
    kw = dict(t_budget=64, s_max=7, pages_per_seq=4, scratch_page=0,
              pad_id=0, page_size=16, score_width=score_width,
              copy_pairs=copy_pairs, copy_slots=copy_slots)
    ours = serving_loop.build_ragged_batch(_verify_seqs(serving_loop), **kw)
    ref = jax_loop.build_ragged_batch(_verify_seqs(jax_loop), **kw)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            assert ours[key].dtype == value.dtype, key
            np.testing.assert_array_equal(ours[key], value, err_msg=key)
        else:
            assert ours[key] == value, key
    if score_width:
        # [s_max, score_width] whatever the composition
        assert ours["sample_rows"].shape == (7, score_width)


@pytest.mark.parametrize("case", [
    dict(seqs=[([9], 2)], score_width=5),                 # n_scores > run
    dict(seqs=[([9] * 7, 7)], score_width=5),             # > score_width
    dict(seqs=[([9], 0)], score_width=5),                 # n_scores < 1
    dict(seqs=[([9], 1)], copy_pairs=[(1, 2), (3, 4)], copy_slots=1),
    dict(seqs=[([9], 1)], copy_pairs=[(1, 2)]),
])
def test_verify_batch_errors_match_jax(case):
    def build(mod):
        table = np.zeros(4, np.int32)
        seqs = [mod.RaggedSeq(t, 0, table, n_scores=n)
                for t, n in case["seqs"]]
        try:
            mod.build_ragged_batch(
                seqs, t_budget=64, s_max=5, pages_per_seq=4, scratch_page=0,
                pad_id=0, page_size=16,
                score_width=case.get("score_width", 0),
                copy_pairs=case.get("copy_pairs"),
                copy_slots=case.get("copy_slots", 0))
        except ValueError as e:
            return str(e)
        return None
    msg = build(serving_loop)
    assert msg is not None and msg == build(jax_loop)


# --- forward_ragged: verify rows and tree page copies ---

PS, MAX_SEQ, POOL_PAGES = 16, 128, 24


def _verify_batch(mod):
    """A chain verify run of 5 crossing a page end (positions 30..34 of a
    row whose pages are 1-3), a plain decode row, a 3-row run at the very
    start of a row, and a tree path of the first row: its table swaps
    logical pages 1-2 (pool pages 2 and 3) for the loaned pages 20 and 21,
    with the frontier page 2 copied into 20 in the dispatch."""
    t0 = np.array([1, 2, 3, 0, 0, 0, 0, 0], np.int32)
    t1 = np.array([4, 5, 0, 0, 0, 0, 0, 0], np.int32)
    t2 = np.array([6, 0, 0, 0, 0, 0, 0, 0], np.int32)
    tp = np.array([1, 20, 21, 0, 0, 0, 0, 0], np.int32)
    seqs = [mod.RaggedSeq([7, 11, 13, 17, 19], 30, t0, n_scores=5),
            mod.RaggedSeq([8], 24, t1),
            mod.RaggedSeq([2, 5, 9], 0, t2, n_scores=3),
            mod.RaggedSeq([7, 23, 29], 30, tp, n_scores=3)]
    return mod.build_ragged_batch(
        seqs, t_budget=64, s_max=6, pages_per_seq=8, scratch_page=0,
        pad_id=0, page_size=PS, score_width=5, copy_pairs=[(2, 20)],
        copy_slots=2)


@pytest.mark.parametrize("pages", ["float", "int8", "int4"])
def test_forward_ragged_verify_matches_jax(pages):
    """The same verify batch through both forwards on bridged f32 weights:
    the [S, R, V] logits of every real scored row within 1e-4, and the
    pools alike afterwards - every token's written cell, and the copied
    frontier page's committed cells in the loaned page."""
    jcfg = jax_config("tiny-llama", max_seq_len=MAX_SEQ)
    tcfg = torch_config("tiny-llama", max_seq_len=MAX_SEQ)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_numpy(jax.device_get(jparams), tcfg,
                                torch.float32, "cpu")
    rng = np.random.default_rng(7)
    shape = (POOL_PAGES, PS, tcfg.num_kv_heads, tcfg.head_dim)
    floats = [(rng.standard_normal(shape).astype(np.float32),
               rng.standard_normal(shape).astype(np.float32))
              for _ in range(tcfg.num_layers)]
    batch = _verify_batch(serving_loop)
    jbatch = _verify_batch(jax_loop)
    for key, value in jbatch.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(batch[key], value, err_msg=key)
    spec_j = spec_t = None
    scales_np = None
    pools_np = floats
    if pages != "float":
        bits = 8 if pages == "int8" else 4
        spec_j, spec_t = jkvq.KVQuantSpec(bits=bits), kvq.KVQuantSpec(
            bits=bits)
        pools_np, scales_np = [], []
        for k, v in floats:
            kq, ks = jkvq.quantize_cells(jnp.asarray(k), spec_j)
            vq, vs = jkvq.quantize_cells(jnp.asarray(v), spec_j)
            pools_np.append((np.asarray(kq), np.asarray(vq)))
            scales_np.append((np.asarray(ks), np.asarray(vs)))
    keys = ("tokens", "positions", "tables", "seq_of_block", "block_qstart",
            "query_offsets", "kv_valid", "token_pages", "token_offs")
    ref_logits, ref_out = jax_forward_ragged(
        jparams, jcfg, *(jnp.asarray(batch[k]) for k in keys[:2]),
        [(jnp.asarray(k), jnp.asarray(v)) for k, v in pools_np],
        *(jnp.asarray(batch[k]) for k in keys[2:]),
        jnp.asarray(batch["token_seq"]), jnp.asarray(batch["last_rows"]),
        sample_rows=jnp.asarray(batch["sample_rows"]),
        scales=([(jnp.asarray(k), jnp.asarray(v)) for k, v in scales_np]
                if scales_np is not None else None),
        quant_spec=spec_j, copy_src=jnp.asarray(batch["copy_src"]),
        copy_dst=jnp.asarray(batch["copy_dst"]))
    n_layers = tcfg.num_layers
    ref_pools = ref_out[:n_layers]
    ref_scales = ref_out[n_layers:] if scales_np is not None else None
    pools = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
             for k, v in pools_np]
    scales = ([(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
               for k, v in scales_np] if scales_np is not None else None)
    t = {k: torch.from_numpy(batch[k]) for k in keys + (
        "last_rows", "sample_rows", "copy_src", "copy_dst")}
    logits = forward_ragged(
        tparams, tcfg, t["tokens"].long(), t["positions"], pools,
        *(t[k] for k in keys[2:]), t["last_rows"], plain=True,
        sample_rows=t["sample_rows"], scales=scales, quant_spec=spec_t,
        copy_src=t["copy_src"], copy_dst=t["copy_dst"])
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (6, 5, tcfg.vocab_size)
    ref = np.asarray(ref_logits)
    for s, n in enumerate((5, 1, 3, 3)):
        np.testing.assert_allclose(logits.numpy()[s, :n], ref[s, :n],
                                   atol=1e-4, rtol=1e-4, err_msg=str(s))
    # every real token's written cell, then the loaned page's copied
    # committed cells (offsets 0..13 of page 20, positions 16..29: the
    # path writes 30 onwards)
    real = np.concatenate([
        np.arange(batch["last_rows"][i] - n + 1, batch["last_rows"][i] + 1)
        for i, n in enumerate((5, 1, 3, 3))])
    cells = (batch["token_pages"][real], batch["token_offs"][real])
    for li in range(n_layers):
        for j in range(2):
            ours_np, ref_np = pools[li][j].numpy(), np.asarray(
                ref_pools[li][j])
            if pages == "float":
                np.testing.assert_allclose(ours_np[cells], ref_np[cells],
                                           atol=1e-5, rtol=1e-5)
            else:
                # dequantized, within one quantization step where the f32
                # sums round a cell the other way
                deq = [kvq.dequantize_cells(
                    torch.from_numpy(np.ascontiguousarray(p[cells])),
                    torch.from_numpy(np.ascontiguousarray(sc[cells])),
                    spec_t, torch.float32).numpy()
                    for p, sc in ((ours_np, scales[li][j].numpy()),
                                  (ref_np, np.asarray(ref_scales[li][j])))]
                ref_sc = np.asarray(ref_scales[li][j])[cells]
                np.testing.assert_allclose(scales[li][j].numpy()[cells],
                                           ref_sc, rtol=1e-4, atol=1e-7)
                assert np.abs(deq[0] - deq[1]).max() <= 1.01 * ref_sc.max()
            np.testing.assert_array_equal(ours_np[20, :14],
                                          ref_np[20, :14])
            np.testing.assert_array_equal(ours_np[20, :14],
                                          pools_np[li][j][2, :14])
            if scales is not None:
                np.testing.assert_array_equal(
                    scales[li][j].numpy()[20, :14],
                    scales_np[li][j][2, :14])


# --- engine resolution ---


def _spec_state(eng):
    return (eng.spec_describe(), eng.spec_s_max, eng.spec_copy_slots,
            eng.spec_branch, eng.spec_tree)


ENGINE_CASES = [
    dict(), dict(spec_decode=True), dict(spec_decode=False),
    dict(spec_decode={"drafter": "ngram", "max_draft": 2}),
    dict(spec_decode={"drafter": "model"}),
    dict(spec_decode={"tree": {"branch": 2, "depth": 3}}),
    dict(spec_decode={"drafter": "model", "tree": {"branch": 3,
                                                   "depth": 2}}),
    # the lora drafter without a store falls back to the n-gram chain
    dict(spec_decode={"drafter": "lora", "adapter": "ghost"}),
    dict(spec_decode={"drafter": "lora", "adapter": "head"},
         lora={"rank": 4, "adapters": {"head": {"seed": 1,
                                                "init_std": 0.0}}}),
    dict(spec_max_draft=7),
    dict(ragged_attn=False),
    dict(kv_layout="contiguous"),
    dict(kv_layout="contiguous", spec_decode=True),
]


@pytest.mark.parametrize("kw", ENGINE_CASES)
def test_engine_spec_resolution_matches_jax(kw):
    """The resolved speculation of both engines at construction, for the
    bool and dict configs, the lora fallback, the ragged seam off and the
    contiguous layout: spec_describe() and the verify statics alike."""
    kw = dict(kw)
    layout = kw.pop("kv_layout", "paged")
    jeng = JaxEngine(jax_config("tiny-gemma", max_seq_len=256),
                     mesh_shape={"data": 1, "model": 1}, num_slots=4,
                     kv_layout=layout, dtype=jnp.float32,
                     prefix_cache=False, kv_offload=False, **kw)
    teng = InferenceEngine(torch_config("tiny-gemma", max_seq_len=256),
                           num_slots=4, kv_layout=layout,
                           dtype=torch.float32, device="cpu", **kw)
    assert _spec_state(teng) == _spec_state(jeng)
    if layout == "paged":
        assert teng.describe()["spec_decode"] == teng.spec_describe()
    else:
        assert teng.spec_reason == "kv_layout:contiguous"


def test_env_kill_switch_resolution_matches_jax(monkeypatch):
    monkeypatch.setenv("ROUNDTABLE_SPEC_DECODE", "0")
    for kw in (dict(), dict(spec_decode={"drafter": "model"}),
               dict(spec_decode={"enabled": True})):
        jeng = JaxEngine(jax_config("tiny-gemma", max_seq_len=256),
                         mesh_shape={"data": 1, "model": 1}, num_slots=2,
                         kv_layout="paged", dtype=jnp.float32,
                         prefix_cache=False, kv_offload=False, **kw)
        teng = InferenceEngine(torch_config("tiny-gemma", max_seq_len=256),
                               num_slots=2, kv_layout="paged",
                               dtype=torch.float32, device="cpu", **kw)
        assert teng.spec_describe() == jeng.spec_describe()
        # the kill switch holds unless the block pins `enabled`
        assert teng.spec_decode == ("enabled" in kw.get("spec_decode", {}))


@pytest.mark.parametrize("kw", [
    dict(spec_max_draft=0), dict(spec_max_draft=8),
    dict(spec_max_draft=2, spec_decode={"tree": {"branch": 2, "depth": 3}}),
    dict(spec_decode={"drafter": "oracle"}),
    dict(spec_decode={"drafter": "lora"}),
])
def test_engine_spec_validation_matches_jax(kw):
    def build(ctor, cfg, **extra):
        try:
            ctor(cfg, num_slots=2, kv_layout="paged", **extra, **kw)
        except ValueError as e:
            return str(e)
        return None
    ours = build(InferenceEngine, torch_config("tiny-gemma"), device="cpu")
    ref = build(JaxEngine, jax_config("tiny-gemma"),
                mesh_shape={"data": 1, "model": 1})
    assert ours is not None and ours == ref


def test_from_config_carries_spec_max_draft():
    base = {"model": "tiny-gemma", "max_seq_len": 256, "kv_layout": "paged",
            "num_slots": 2}
    eng = InferenceEngine.from_config(dict(base, spec_max_draft=2),
                                      device="cpu")
    assert eng.spec_max_draft == 2 and eng.spec_decode
    # `is not None`: 0 reaches the range check instead of the default
    with pytest.raises(ValueError, match="spec_max_draft"):
        InferenceEngine.from_config(dict(base, spec_max_draft=0),
                                    device="cpu")


def test_set_spec_drafter_swaps_and_refuses():
    """A hot swap needs speculation on; an unknown kind raises and leaves
    the drafter as it was; a lora drafter without a store raises."""
    off = InferenceEngine(torch_config("tiny-gemma", max_seq_len=256),
                          num_slots=2, kv_layout="paged", spec_decode=False,
                          dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="disabled:config/env"):
        off.set_spec_drafter("model")
    eng = InferenceEngine(torch_config("tiny-gemma", max_seq_len=256),
                          num_slots=2, kv_layout="paged",
                          dtype=torch.float32, device="cpu")
    eng.set_spec_drafter("model")
    assert eng.spec_describe()["drafter"] == "model"
    with pytest.raises(ValueError, match="drafter must be one of"):
        eng.set_spec_drafter("oracle")
    assert eng.spec_drafter == "model"
    with pytest.raises(RuntimeError, match="lora drafter needs"):
        eng.set_spec_drafter("lora", adapter="x")
    eng.set_spec_drafter("ngram")
    assert eng.spec_device_drafter is None and eng.spec_drafter == "ngram"
