"""PyTorch port, float16: every kernel's plain version at f16 against the
JAX package's Pallas kernel in interpret mode on the same f16 inputs (K1
and K2 on plain and int8/int4 pages - K4 -, K3, K8, K9, K5, K6, K7), and
f16 tiny-llama engines (paged and contiguous, int8/int4 KV pages, int4
weights, an npz LoRA persona, the scheduler's ragged join) against the
JAX engine built with `"dtype": "float16"` on the same weights.

Tolerances: the kernels round p (and K7's xa) to f16 and sum in f32 on
both sides, in another order, so an output may differ by a few f16 steps
(atol = rtol = 4e-3 at these magnitudes, ~4 steps of f16 near 1). Engines:
greedy tokens identical, except where the JAX engine's own next-token
logits hold a near tie: f16 activations round after every product, so a
summation order that differs by an f32 ulp can move a hidden by an f16
step and flip a top-2 pair whose margin is below NEAR_TIE (2e-3 in f32
logits). Such a flip is allowed only at a position where the JAX forward
over the common prefix has its two best tokens that close, and those two
are the tokens the packages picked. The CUDA kernels' f16 bodies run only
on a card: tests/test_torch_cuda.py (its DTYPES hold float16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
from theroundtaible_tpu.engine.models.registry import \
    get_model_config as jax_config
from theroundtaible_tpu.engine.pallas import attention as pattn
from theroundtaible_tpu.engine.pallas import int4mm as jint4mm
from theroundtaible_tpu.engine.pallas import lora as jplora
from theroundtaible_tpu.engine.sampling import SamplingParams as JaxSampling
from theroundtaible_tpu_torch.engine import lora
from theroundtaible_tpu_torch.engine.engine import InferenceEngine
from theroundtaible_tpu_torch.engine.kernels import attention as kattn
from theroundtaible_tpu_torch.engine.kernels import int4mm
from theroundtaible_tpu_torch.engine.kernels import lora as klora
from theroundtaible_tpu_torch.engine.kv_quant import (KVQuantSpec,
                                                      quantize_cells)
from theroundtaible_tpu_torch.engine.models.registry import \
    get_model_config as torch_config
from theroundtaible_tpu_torch.engine.sampling import SamplingParams
from theroundtaible_tpu_torch.engine.weights import params_from_numpy

F16_TOL = dict(atol=4e-3, rtol=4e-3)
NEAR_TIE = 2e-3
MAX_SEQ = 256
OFF = dict(prefix_cache=False, kv_offload=False, spec_decode=False)
BASE = "the knights debate the session store design at length. "
ROUND1 = [("lancelot", BASE + "Lancelot, your view?"),
          ("gawain", BASE + "Gawain, your view?")]
ROUND2 = [(n, p + " Round two: answer the objection.") for n, p in ROUND1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f16(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float16)


def t(x):
    return torch.from_numpy(np.asarray(x))


def j(x):
    return jnp.asarray(x)


def paged_pools(rng, B, S, K, D, ps):
    """A shuffled page pool of f16 cells for B rows of S positions (page 0
    unused), and each row's table."""
    n = S // ps
    table = (rng.permutation(B * n) + 1).reshape(B, n).astype(np.int32)
    k_pool = np.zeros((1 + B * n, ps, K, D), np.float16)
    v_pool = np.zeros_like(k_pool)
    k_pool[table.reshape(-1)] = f16(rng, B * n, ps, K, D)
    v_pool[table.reshape(-1)] = f16(rng, B * n, ps, K, D)
    return k_pool, v_pool, table


def quantized(pool, bits):
    q, s = quantize_cells(torch.from_numpy(pool.astype(np.float32)),
                          KVQuantSpec(bits=bits))
    return q.numpy(), s.numpy()


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_k1_paged_decode_f16_matches_jax(bits):
    """K1 (K4 inside on int8/int4 pages) at f16: 3 rows over 8 pages of
    32, GQA group 4, one row past a page edge."""
    rng = np.random.default_rng(1)
    B, S, K, D, ps = 3, 256, 2, 64, 32
    q = f16(rng, B, 1, 8, D)
    k_pool, v_pool, table = paged_pools(rng, B, S, K, D, ps)
    valid = np.asarray([1, 77, 256], np.int32)
    kw_t, kw_j = {}, {}
    if bits:
        (kq, ks), (vq, vs) = quantized(k_pool, bits), quantized(v_pool, bits)
        k_pool, v_pool = kq, vq
        kw_t = dict(k_scale=t(ks), v_scale=t(vs), kv_bits=bits)
        kw_j = dict(k_scale=j(ks), v_scale=j(vs), kv_bits=bits)
    ours = kattn.paged_decode_attention(t(q), t(k_pool), t(v_pool), t(table),
                                        t(valid), **kw_t)
    ref = pattn.paged_decode_attention(j(q), j(k_pool), j(v_pool), j(table),
                                       j(valid), interpret=True, **kw_j)
    assert ours.dtype == torch.float16
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), **F16_TOL)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_k2_paged_prefill_f16_matches_jax(bits):
    """K2 (K4 inside on int8/int4 pages) at f16: a delta chunk at an offset
    and a full chunk, window 48 on the int4 case."""
    rng = np.random.default_rng(2)
    B, T, H, K, D, S, ps = 2, 64, 8, 2, 64, 256, 32
    q = f16(rng, B, T, H, D)
    k_pool, v_pool, table = paged_pools(rng, B, S, K, D, ps)
    offsets = np.asarray([0, 100], np.int32)
    lengths = np.asarray([64, 40], np.int32)
    valid = offsets + lengths
    window = 48 if bits == 4 else None
    kw_t, kw_j = {}, {}
    if bits:
        (kq, ks), (vq, vs) = quantized(k_pool, bits), quantized(v_pool, bits)
        k_pool, v_pool = kq, vq
        kw_t = dict(k_scale=t(ks), v_scale=t(vs), kv_bits=bits)
        kw_j = dict(k_scale=j(ks), v_scale=j(vs), kv_bits=bits)
    ours = kattn.paged_prefill_attention(
        t(q), t(k_pool), t(v_pool), t(table), t(offsets), t(valid),
        sliding_window=window, **kw_t).float().numpy()
    ref = np.asarray(pattn.paged_prefill_attention(
        j(q), j(k_pool), j(v_pool), j(table), j(offsets), j(valid),
        sliding_window=window, interpret=True, **kw_j), np.float32)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(ours[b, :n], ref[b, :n], **F16_TOL)


def test_k3_ragged_f16_matches_jax():
    """K3 at f16: a 10-row chunk at offset 5 and a decode row at position
    20 in one flat buffer (tests/test_torch_ragged.py's case)."""
    rng = np.random.default_rng(3)
    ps, kh, g, d = 16, 2, 2, 32
    k_pool = f16(rng, 12, ps, kh, d)
    v_pool = f16(rng, 12, ps, kh, d)
    tables = np.zeros((3, 4), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :3] = [3, 4, 5]
    q = f16(rng, 32, kh * g, d)
    meta = [np.array(x, np.int32) for x in ([0, 0, 1, 2], [0, 8, 0, 0],
                                            [5, 20, 0], [15, 21, 1])]
    ours = kattn.ragged_paged_attention(
        t(q), t(k_pool), t(v_pool), t(tables), *map(t, meta)).float()
    ref = np.asarray(pattn.ragged_paged_attention(
        j(q), j(k_pool), j(v_pool), j(tables), *map(j, meta),
        interpret=True), np.float32)
    for row0, n in ((0, 10), (16, 1)):
        np.testing.assert_allclose(ours.numpy()[row0:row0 + n],
                                   ref[row0:row0 + n], **F16_TOL)


def test_k8_k9_contiguous_f16_match_jax():
    """K8 (a chunk at offsets 0 and 37) and K9 (one decode position per
    row) at f16 on a position-aligned cache."""
    rng = np.random.default_rng(4)
    N, S, K, D, H = 2, 128, 2, 64, 8
    k, v = f16(rng, N, S, K, D), f16(rng, N, S, K, D)
    q = f16(rng, N, 24, H, D)
    offsets = np.asarray([0, 37], np.int32)
    valid = offsets + 24
    ours = kattn.flash_prefill_attention(t(q), t(k), t(v), t(offsets),
                                         t(valid)).float().numpy()
    ref = np.asarray(pattn.flash_prefill_attention(
        j(q), j(k), j(v), j(offsets), j(valid), interpret=True), np.float32)
    np.testing.assert_allclose(ours, ref, **F16_TOL)
    qd = f16(rng, N, 1, H, D)
    dvalid = np.asarray([1, 99], np.int32)
    ours = kattn.ragged_decode_attention(t(qd), t(k), t(v),
                                         t(dvalid)).float().numpy()
    ref = np.asarray(pattn.ragged_decode_attention(
        j(qd), j(k), j(v), j(dvalid), interpret=True), np.float32)
    np.testing.assert_allclose(ours, ref, **F16_TOL)


def _int4_leaves(rng, spec, shape):
    """A JAX Int4Leaf of f16 scales for `shape` and the port's bridge of
    it (packed on the last axis, groups of 64)."""
    from theroundtaible_tpu.engine import quant as jquant
    from theroundtaible_tpu_torch.engine.models import common
    w = rng.normal(size=shape).astype(np.float32)
    axes = (0,) if spec == "bte,ve->btv" else (len(shape) - 1,)
    jleaf = jquant._quantize_leaf_int4(jnp.asarray(w), axes, jnp.float16,
                                       False, 64)
    tleaf = int4mm.plan_leaf(spec, common.Int4Leaf(
        q4=t(jleaf.q4), s4=t(np.asarray(jleaf.s4)), axis=jleaf.axis,
        group=jleaf.group))
    return jleaf, tleaf


@pytest.mark.parametrize("spec,ashape,wshape", [
    ("bte,ef->btf", (3, 1, 256), (256, 512)),          # K5
    ("btxf,xfe->bte", (2, 1, 2, 256), (2, 256, 256)),  # K5, expert down
    ("bte,ve->btv", (3, 1, 256), (512, 256)),          # K6, the head
])
def test_k5_k6_f16_match_jax(spec, ashape, wshape):
    """K5 and K6 at f16 (f16 activations and scales, f32 out): the port's
    plain versions against `_mm_pack_out` / `_mm_pack_contract` in
    interpret mode."""
    rng = np.random.default_rng(5)
    jleaf, tleaf = _int4_leaves(rng, spec, wshape)
    a = f16(rng, *ashape)
    want, why = jint4mm.einsum_int4_or_reason(spec, j(a), jleaf)
    assert why is None
    got, reason = int4mm.einsum_int4_or_reason(spec, t(a), tleaf)
    assert reason is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F16_TOL)


def test_k7_bgmv_f16_matches_jax():
    """K7 at f16: xa rounded to f16 before the second product, as the TPU
    kernel's `xa.astype(x.dtype)`, against `_bgmv` in interpret mode."""
    rng = np.random.default_rng(6)
    s, r, c, o, m = 4, 8, 256, 128, 3
    x = f16(rng, m, c)
    a_t = f16(rng, s, r, c, scale=c ** -0.5)
    b_s = f16(rng, s, r, o, scale=0.5)
    a_t[0] = 0
    b_s[0] = 0
    ids = np.asarray([0, 2, 3], np.int32)
    ref, reason = jplora.lora_bgmv_or_reason(j(x), j(a_t), j(b_s), j(ids))
    assert reason is None
    ours = klora.lora_bgmv(t(x), t(a_t), t(b_s), t(ids))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **F16_TOL)


# --- engines ---


def _two_rounds(eng):
    outs = [eng.generate_batch(ROUND1, max_new_tokens=8),
            eng.generate_batch(ROUND2, max_new_tokens=8)]
    records = {n: list(eng.kv._slots[n].tokens) for n, _ in ROUND1}
    return outs, records, eng.last_stats.reused_tokens


def assert_same_or_near_tie(ours, theirs, jeng):
    """_two_rounds' results equal, or each slot record equal up to a first
    difference where the JAX forward over the common prefix ranks the two
    tokens the packages chose first and second, NEAR_TIE apart."""
    if ours == theirs:
        return
    from theroundtaible_tpu.engine.models import common as jcommon
    for name, mine in ours[1].items():
        ref = theirs[1][name]
        k = next((i for i, (a, b) in enumerate(zip(mine, ref)) if a != b),
                 None)
        if k is None:
            assert len(mine) == len(ref), name
            continue
        toks = jnp.asarray([ref[:k]], jnp.int32)
        logits = np.asarray(jcommon.forward(
            jeng.params, jeng.cfg, toks, jnp.arange(k)[None], None, None,
            jnp.asarray([k], jnp.int32))[0][0, -1], np.float32)
        top = np.argsort(logits)[::-1][:2]
        assert {mine[k], ref[k]} == set(top.tolist()), (name, k)
        assert logits[top[0]] - logits[top[1]] < NEAR_TIE, (name, k)


def _engines(layout, **kw):
    kw = dict(kv_layout=layout, **kw)
    if layout == "paged":
        kw = {"page_size": 32, "ragged_attn": False, **kw}
    jeng = JaxEngine(jax_config("tiny-llama", max_seq_len=MAX_SEQ),
                     mesh_shape={"data": 1, "model": 1}, num_slots=4,
                     dtype=jnp.float16,
                     sampling=JaxSampling(temperature=0.0, max_new_tokens=8),
                     **OFF, **kw)
    cfg = torch_config("tiny-llama", max_seq_len=MAX_SEQ)
    teng = InferenceEngine(
        cfg, num_slots=4, dtype=torch.float16,
        sampling=SamplingParams(temperature=0.0, max_new_tokens=8),
        params=params_from_numpy(jax.device_get(jeng.params), cfg,
                                 torch.float16, "cpu"),
        device="cpu", **OFF, **kw)
    return jeng, teng


@pytest.mark.parametrize("layout,extra", [
    ("paged", {}), ("contiguous", {}),
    ("paged", {"kv_quant": "int8"}), ("paged", {"kv_quant": "int4"}),
    ("paged", {"quant": "int4"}), ("contiguous", {"quant": "int8"}),
], ids=["paged", "contiguous", "kv-int8", "kv-int4", "w-int4", "w-int8"])
def test_f16_engine_matches_jax(monkeypatch, layout, extra):
    """A 2-knight round and its delta round in f16: the JAX f16 engine's
    greedy tokens, slot records and reuse (or a flip at one of its near
    ties); the pools in f16 (int8 payloads when the KV is quantized) and
    describe()'s size keys equal."""
    monkeypatch.setenv("ROUNDTABLE_INT4_MM", "1")
    jeng, teng = _engines(layout, **extra)
    assert_same_or_near_tie(_two_rounds(teng), _two_rounds(jeng), jeng)
    dj, dt = jeng.describe(), teng.describe()
    for key in ("params", "num_pages", "kv_hbm_bytes", "quant", "kv_quant"):
        if key in dj:
            assert dt[key] == dj[key], key
    pool = (teng.kv.pools if layout == "paged" else teng.kv.layers)[0][0]
    assert pool.dtype == (torch.int8 if "kv_quant" in extra
                          else torch.float16)


def test_f16_lora_persona_matches_jax(tmp_path):
    """An npz persona (the same file in both packages) served in f16 beside
    a base row: the JAX f16 engine's greedy tokens."""
    rng = np.random.default_rng(7)
    dims = lora.lora_dims(torch_config("tiny-llama"))
    tree = {k: (rng.normal(size=(4, c)).astype(np.float32) * c ** -0.5,
                rng.normal(size=(4, o)).astype(np.float32) * 0.6)
            for k, (c, o, _tp) in dims.items()}
    path = tmp_path / "galahad.npz"
    lora.save_pair_tree(str(path), tree)
    block = {"rank": 4, "max_adapters": 3, "scale": 4.0,
             "adapters": {"galahad": {"path": str(path)}}}
    jeng, teng = _engines("paged", lora=block)
    ads = [None, "galahad"]
    ours = teng.generate_batch(ROUND1, max_new_tokens=8,
                               adapters_per_turn=ads)
    assert ours == jeng.generate_batch(ROUND1, max_new_tokens=8,
                                       adapters_per_turn=ads)
    assert teng.describe()["lora"]["lora_paths"]["plain_bgmv"]


def test_f16_scheduler_join_matches_jax():
    """A session joining mid-decode in f16 through the ragged seam (K3's
    plain version): the JAX f16 engine's direct greedy tokens."""
    import threading
    import time

    from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
    jeng, teng = _engines("paged", ragged_attn=None)
    teng.ragged_defer_min = 1
    prompts = {"s0": ROUND1[:1], "s1": ROUND1[1:]}
    direct = {sid: jeng.generate_batch(turns, max_new_tokens=70,
                                       session=sid)
              for sid, turns in prompts.items()}
    sched = SessionScheduler(teng)
    results, errors = {}, {}

    def run(sid, wait):
        try:
            if wait:
                deadline = time.monotonic() + 60
                while not sched._active and time.monotonic() < deadline:
                    time.sleep(0.002)
            results[sid] = sched.submit(sid, prompts[sid],
                                        max_new_tokens=70)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors[sid] = e

    try:
        threads = [threading.Thread(target=run, args=(sid, i > 0))
                   for i, sid in enumerate(prompts)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=240)
        assert not errors, errors
        for sid in prompts:
            assert results[sid][0] == direct[sid], sid
        assert teng.ragged_describe()["dispatches"].get("plain_ragged", 0) \
            >= 1
    finally:
        sched.close()


def test_from_config_builds_float16():
    """`"dtype": "float16"` builds an f16 engine, as JAX's from_config
    maps it; an unknown dtype is refused."""
    eng = InferenceEngine.from_config(
        {"model": "tiny-llama", "max_seq_len": 128, "dtype": "float16"},
        device="cpu")
    assert eng.dtype == torch.float16
    assert eng.params["embedding"].dtype == torch.float16
    with pytest.raises(ValueError, match="unknown dtype"):
        InferenceEngine.from_config(
            {"model": "tiny-llama", "max_seq_len": 128, "dtype": "int3"},
            device="cpu")
