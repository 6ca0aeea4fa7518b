"""PyTorch port, quantized KV pages: kv_quant's cells against the JAX
package's bit for bit, the K1-K3 plain versions with int8/int4 scale
operands (K4's math) against the JAX Pallas kernels in interpret mode, and
paged engines on bridged weights with quantized pools, the gather view, a
scheduled mid-run ragged join and the kill switch against the JAX engine's
greedy tokens. f32 unless stated; inputs from numpy seeds. The CUDA
kernels themselves run only on a card: tests/test_torch_cuda.py."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theroundtaible_tpu.engine import kv_quant as jkvq
from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
from theroundtaible_tpu.engine.models.registry import \
    get_model_config as jax_config
from theroundtaible_tpu.engine.pallas import attention as pattn
from theroundtaible_tpu.engine.sampling import SamplingParams as JaxSampling
from theroundtaible_tpu_torch.engine import kv_quant as kvq
from theroundtaible_tpu_torch.engine.engine import InferenceEngine
from theroundtaible_tpu_torch.engine.kernels import attention as kattn
from theroundtaible_tpu_torch.engine.models.registry import \
    get_model_config as torch_config
from theroundtaible_tpu_torch.engine.paging import PagedKVCache
from theroundtaible_tpu_torch.engine.sampling import SamplingParams
from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
from theroundtaible_tpu_torch.engine.weights import params_from_numpy

# The plain versions and the interpret-mode kernels: f32, only the
# summation order differs.
TOL = dict(atol=1e-5, rtol=1e-5)
OFF = dict(prefix_cache=False, kv_offload=False, spec_decode=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs():
    return [(8, 32), (4, 32), (4, 16)]


# --- the cells, bit for bit ---


@pytest.mark.parametrize("bits,group", _specs())
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_cells_bit_identical(bits, group, dtype):
    rng = np.random.default_rng(bits * 100 + group)
    x = (rng.normal(size=(5, 7, 3, 64)) * rng.uniform(0.01, 4.0, (5, 7, 3,
                                                               1)))
    x[0, 0, 0] = 0.0      # an all-zero cell: the absmax floor
    x = x.astype(np.float32)
    spec_j = jkvq.KVQuantSpec(bits=bits, group=group)
    spec_t = kvq.KVQuantSpec(bits=bits, group=group)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qj, sj = jkvq.quantize_cells(xj, spec_j)
    qt, st = kvq.quantize_cells(xt, spec_t)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    for out in ("float32", "bfloat16"):
        dj = jkvq.dequantize_cells(qj, sj, spec_j, getattr(jnp, out))
        dt = kvq.dequantize_cells(qt, st, spec_t, getattr(torch, out))
        np.testing.assert_array_equal(dt.float().numpy(),
                                      np.asarray(dj.astype(jnp.float32)))
    np.testing.assert_array_equal(kvq.unpack_int4(qt).numpy(),
                                  np.asarray(jkvq.unpack_int4(qj)))


@pytest.mark.parametrize("bits,group", _specs())
@pytest.mark.parametrize("d", [16, 64, 128, 96])
def test_spec_accounting_matches_jax(bits, group, d):
    sj = jkvq.KVQuantSpec(bits=bits, group=group)
    st = kvq.KVQuantSpec(bits=bits, group=group)
    for name in ("packed_dim", "num_groups", "effective_group",
                 "cell_bytes"):
        assert getattr(st, name)(d) == getattr(sj, name)(d), name
    assert kvq.page_ratio(st, d) == jkvq.page_ratio(sj, d)
    assert kvq.page_ratio(st, d, 4) == jkvq.page_ratio(sj, d, 4)
    cfg_t, cfg_j = torch_config("tiny-llama"), jax_config("tiny-llama")
    assert (kvq.cell_bytes_per_token(cfg_t, st)
            == jkvq.cell_bytes_per_token(cfg_j, sj))
    assert (kvq.cell_bytes_per_token(cfg_t, None)
            == jkvq.cell_bytes_per_token(cfg_j, None))


@pytest.mark.parametrize("value", ["int8", "int4", {"bits": 4, "group": 16},
                                   {"bits": 8}, None, "none", ""])
@pytest.mark.parametrize("env", [None, "0", "1"])
def test_resolve_spec_and_kill_switch_match_jax(monkeypatch, value, env):
    if env is None:
        monkeypatch.delenv("ROUNDTABLE_KV_QUANT", raising=False)
    else:
        monkeypatch.setenv("ROUNDTABLE_KV_QUANT", env)
    spec_j, why_j = jkvq.resolve_spec(value)
    spec_t, why_t = kvq.resolve_spec(value)
    assert why_t == why_j
    assert (spec_t is None) == (spec_j is None)
    if spec_t is not None:
        assert (spec_t.bits, spec_t.group) == (spec_j.bits, spec_j.group)
    for bad in ("int2", {"bits": 3}, {"bits": 4, "group": 1}, 7):
        if env == "0":
            continue
        with pytest.raises(ValueError):
            kvq.resolve_spec(bad)


def test_dispatch_counters():
    kvq.reset_test_counters()
    kvq.note_quant_dispatch(True)
    kvq.note_quant_dispatch(False)
    kvq.note_quant_dispatch(True)
    assert kvq.quant_dispatches() == 3
    assert kvq.quant_kernel_dispatches() == 2
    assert kvq.quant_fallback_dispatches() == 1


# --- K1-K3 plain versions with scales against the JAX kernels ---

PS, KH, D = 16, 2, 64


def quant_pools(rng, n_pages, bits, tables, valid):
    """Quantized K/V pools of random cells, twice: `clean` with every cell
    at or past a sequence's kv_valid zeroed (scale 0), `dirty` with a
    random payload and NaN scales there - stale cells that must never
    reach an output."""
    spec = kvq.KVQuantSpec(bits=bits)
    clean, dirty = [], []
    for _ in range(2):
        x = rng.normal(size=(n_pages, PS, KH, D)).astype(np.float32)
        q, s = kvq.quantize_cells(torch.from_numpy(x), spec)
        q, s = q.numpy(), s.numpy()
        qc, sc, qd, sd = q.copy(), s.copy(), q.copy(), s.copy()
        for row, n in zip(tables, valid):
            for j, page in enumerate(row):
                lo = max(int(n) - j * PS, 0)
                if page and lo < PS:
                    sc[page, lo:] = 0.0
                    qd[page, lo:] = rng.integers(-128, 128,
                                                 size=qd[page, lo:].shape)
                    sd[page, lo:] = np.nan
        clean += [qc, sc]
        dirty += [qd, sd]
    return clean, dirty


def _jax_pools(pools):
    kq, ks, vq, vs = (jnp.asarray(x) for x in pools)
    return (kq, vq), dict(k_scale=ks, v_scale=vs)


def _port_pools(pools):
    kq, ks, vq, vs = (torch.from_numpy(x) for x in pools)
    return (kq, vq), dict(k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("window,softcap", [(None, None), (40, 30.0)])
def test_quantized_decode_and_prefill_match_jax_kernels(bits, window,
                                                        softcap):
    B, pp = 3, 6
    rng = np.random.default_rng(40 + bits)
    table = (rng.permutation(B * pp) + 1).reshape(B, pp).astype(np.int32)
    valid = np.asarray([1, 40, 96], np.int32)
    clean, dirty = quant_pools(rng, 1 + B * pp, bits, table, valid)
    (jk, jv), jkw = _jax_pools(clean)
    (tk, tv), tkw = _port_pools(dirty)
    q = rng.normal(size=(B, 1, 4, D)).astype(np.float32)
    ref = pattn.paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(valid),
        sliding_window=window, softcap=softcap, interpret=True,
        kv_bits=bits, **jkw)
    ours = kattn.paged_decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(table),
        torch.from_numpy(valid), sliding_window=window, softcap=softcap,
        kv_bits=bits, **tkw)
    assert np.isfinite(ours.numpy()).all()
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)

    qp = rng.normal(size=(B, 24, 4, D)).astype(np.float32)
    offsets = np.asarray([0, 20, 72], np.int32)
    lengths = np.asarray([1, 20, 24], np.int32)
    ref = pattn.paged_prefill_attention(
        jnp.asarray(qp), jk, jv, jnp.asarray(table), jnp.asarray(offsets),
        jnp.asarray(offsets + lengths), sliding_window=window,
        softcap=softcap, interpret=True, kv_bits=bits, **jkw)
    ours = kattn.paged_prefill_attention(
        torch.from_numpy(qp), tk, tv, torch.from_numpy(table),
        torch.from_numpy(offsets), torch.from_numpy(offsets + lengths),
        sliding_window=window, softcap=softcap, kv_bits=bits, **tkw)
    for b, n in enumerate(lengths):
        assert np.isfinite(ours[b, :n].numpy()).all()
        np.testing.assert_allclose(ours[b, :n].numpy(),
                                   np.asarray(ref)[b, :n], **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_ragged_matches_jax_kernel(bits):
    """A 10-row chunk at offset 5, a decode row at position 20, an inert
    block on the scratch page; real rows compared."""
    rng = np.random.default_rng(50 + bits)
    tables = np.zeros((3, 4), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :3] = [3, 4, 5]
    valid = np.asarray([15, 21, 1], np.int32)
    clean, dirty = quant_pools(rng, 12, bits, tables[:2], valid[:2])
    meta = [np.array([0, 0, 1, 2], np.int32), np.array([0, 8, 0, 0],
                                                       np.int32),
            np.array([5, 20, 0], np.int32), valid]
    q = rng.normal(size=(32, 4, D)).astype(np.float32)
    (jk, jv), jkw = _jax_pools(clean)
    (tk, tv), tkw = _port_pools(dirty)
    ref = np.asarray(pattn.ragged_paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(tables),
        *(jnp.asarray(x) for x in meta), interpret=True, kv_bits=bits,
        **jkw))
    ours = kattn.ragged_paged_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
        *(torch.from_numpy(x) for x in meta), kv_bits=bits, **tkw).numpy()
    for row0, n in ((0, 10), (16, 1)):
        assert np.isfinite(ours[row0:row0 + n]).all()
        np.testing.assert_allclose(ours[row0:row0 + n], ref[row0:row0 + n],
                                   **TOL)


def test_quantized_wrappers_check_their_operands():
    q = torch.zeros(2, 1, 4, 64)
    table = torch.ones(2, 4, dtype=torch.int32)
    valid = torch.ones(2, dtype=torch.int32)
    pool = torch.zeros(5, 16, 2, 32, dtype=torch.int8)
    scale = torch.ones(5, 16, 2, 2)
    with pytest.raises(ValueError, match="come together"):
        kattn.paged_decode_attention(q, pool, pool, table, valid,
                                     k_scale=scale, kv_bits=4)
    with pytest.raises(ValueError, match="bytes per cell"):
        kattn.paged_decode_attention(q, pool, pool, table, valid,
                                     k_scale=scale, v_scale=scale, kv_bits=8)
    with pytest.raises(ValueError, match="float32"):
        kattn.paged_decode_attention(q, pool, pool, table, valid,
                                     k_scale=scale.double(),
                                     v_scale=scale.double(), kv_bits=4)
    out = kattn.paged_decode_attention(q, pool, pool, table, valid,
                                       k_scale=scale, v_scale=scale,
                                       kv_bits=4)
    assert out.shape == q.shape
    assert kattn.kv_quant_decline_reason(16, 64, 2, 2, 3) == "kv_bits:3"
    assert kattn.kv_quant_decline_reason(16, 63, 2, 2, 4).startswith(
        "int4_head_dim")
    assert kattn.kv_quant_decline_reason(16, 64, 2, 2, 4, 16) is None


# --- the pool ---


def test_quantized_pool_layout_budget_and_copy_on_write():
    """int8 pages [P,ps,K,D] with f32 scales [P,ps,K,1] at the unquantized
    default's byte budget (the JAX allocator's page count), and a
    copy-on-write page carries its scales."""
    cfg = torch_config("tiny-llama", max_seq_len=256)
    for bits in (8, 4):
        spec = kvq.KVQuantSpec(bits=bits)
        kv = PagedKVCache(cfg, 4, 256, torch.float32, "cpu", page_size=32,
                          kv_quant=spec)
        from theroundtaible_tpu.engine.paging import \
            PagedKVCache as JaxPaged
        jkv = JaxPaged(jax_config("tiny-llama", max_seq_len=256), 4, 256,
                       jnp.float32, page_size=32,
                       kv_quant=jkvq.KVQuantSpec(bits=bits),
                       copy_pages_fn=lambda *a: None)
        assert kv.num_pages == jkv.num_pages
        assert kv.hbm_bytes() == jkv.hbm_bytes()
        assert kv.hbm_bytes_logical() == jkv.hbm_bytes_logical()
        k, _ = kv.pools[0]
        ks, _ = kv.scales[0]
        assert k.dtype == torch.int8 and ks.dtype == torch.float32
        assert k.shape[-1] == spec.packed_dim(16)
        assert ks.shape[-1] == spec.num_groups(16)
    kv.ensure_capacity("a", 40, write_from=0)
    src = kv._slots["a"].pages[1]
    for k, v in kv.pools:
        k[src] = 3
        v[src] = -2
    for ks, vs in kv.scales:
        ks[src] = 0.25
        vs[src] = 0.5
    kv.commit("a", list(range(40)))
    kv.alias_span("a", "b", 0, 64)
    assert kv._slots["b"].pages[1] == src
    kv.ensure_capacity("b", 50, write_from=40)      # COW of the shared page
    fresh = kv._slots["b"].pages[1]
    assert fresh != src
    for (k, v), (ks, vs) in zip(kv.pools, kv.scales):
        assert torch.equal(k[fresh], k[src]) and torch.equal(v[fresh], v[src])
        assert bool((ks[fresh] == 0.25).all()) and bool(
            (vs[fresh] == 0.5).all())


# --- engines on bridged weights against the JAX engine ---

MAX_SEQ = 512
BASE = "the knights debate the session store design at length. "
ROUND1 = [("lancelot", BASE + "Lancelot, your view?"),
          ("gawain", BASE + "Gawain, your view?")]
ROUND2 = [(n, p + " Round two: answer the objection.") for n, p in ROUND1]


def _jax_engine(**kw):
    kw.setdefault("num_slots", 4)
    return JaxEngine(jax_config("tiny-llama", max_seq_len=MAX_SEQ),
                     mesh_shape={"data": 1, "model": 1},
                     kv_layout="paged", page_size=32, dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0, max_new_tokens=8),
                     **OFF, **kw)


def _port_engine(jeng, **kw):
    cfg = torch_config("tiny-llama", max_seq_len=MAX_SEQ)
    kw.setdefault("num_slots", 4)
    return InferenceEngine(
        cfg, kv_layout="paged", page_size=32, dtype=torch.float32,
        sampling=SamplingParams(temperature=0.0, max_new_tokens=8),
        params=params_from_numpy(jax.device_get(jeng.params), cfg,
                                 torch.float32, "cpu"),
        device="cpu", **OFF, **kw)


def _two_rounds(eng):
    outs = [eng.generate_batch(ROUND1, max_new_tokens=8),
            eng.generate_batch(ROUND2, max_new_tokens=8)]
    records = {n: list(eng.kv._slots[n].tokens) for n, _ in ROUND1}
    return outs, records, eng.last_stats.reused_tokens


@pytest.mark.parametrize("cfg", [
    dict(kv_quant="int8"),
    dict(kv_quant="int4", ragged_attn=False),
    dict(kv_quant="int8", attn="dense", ragged_attn=False),
], ids=["int8-pages", "int4-pages", "int8-pages-gather-view"])
def test_quantized_pool_engine_matches_jax(cfg):
    """A 2-knight round and its delta round on quantized pages: greedy
    tokens, slot records, reused tokens and the describe() keys equal the
    JAX engine's (pool-direct through K1/K2's plain versions with scales,
    or the gather view)."""
    jeng = _jax_engine(**cfg)
    teng = _port_engine(jeng, **cfg)
    assert _two_rounds(teng) == _two_rounds(jeng)
    dj, dt = jeng.describe(), teng.describe()
    for key in ("quant", "num_pages", "kv_hbm_bytes", "paged_decode",
                "kv_quant"):
        assert dt[key] == dj[key], key
    gather = cfg.get("attn") == "dense"
    path = "xla_dequant" if gather else "kernel_dequant"
    assert set(dt["kv_quant"]["dispatches"]) == {f"prefill:{path}",
                                                 f"decode:{path}"}
    assert dt["paged_decode"] == ("gather-view" if gather
                                  else "pool-direct")


PREAMBLE = ("The round table convened at dawn. The rules of order are "
            "strict: every knight states a proposal, scores consensus "
            "from one to ten, and names the open points that remain. ")


def test_scheduled_mid_run_join_on_int8_pages_matches_jax():
    """Sessions joining while another decodes on an int8 pool (ragged
    dispatches through K3's plain version with scales) give the JAX int8
    engine's direct greedy tokens."""
    jeng = _jax_engine(kv_quant="int8", ragged_attn=False, num_slots=8)
    prompts = {f"s{i}": [("kn", PREAMBLE + f"Knight {i} argues.")]
               for i in range(3)}
    direct = {sid: jeng.generate_batch(turns, max_new_tokens=70,
                                       session=sid)
              for sid, turns in prompts.items()}
    teng = _port_engine(jeng, kv_quant="int8", num_slots=8)
    teng.ragged_defer_min = 1
    sched = SessionScheduler(teng)
    results, errors = {}, {}

    def run(sid, wait):
        try:
            if wait:
                deadline = time.monotonic() + 60
                while not sched._active and time.monotonic() < deadline:
                    time.sleep(0.002)
            results[sid] = sched.submit(sid, prompts[sid],
                                        max_new_tokens=70)[0]
        except Exception as e:  # noqa: BLE001 - asserted below
            errors[sid] = e

    try:
        threads = [threading.Thread(target=run, args=(sid, i > 0))
                   for i, sid in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        assert not errors, errors
        assert results == direct
        d = sched.describe()
        assert d["ragged_joins"] >= 1
        disp = teng.kv_quant_describe()["dispatches"]
        assert disp.get("ragged:kernel_dequant", 0) >= 1
    finally:
        sched.close()


def test_kill_switch_restores_unquantized_pools(monkeypatch):
    """ROUNDTABLE_KV_QUANT=0 beats `kv_quant: int8`: unquantized pools of
    the same page count and bytes, no scales, and tokens byte-identical
    to an engine never configured for it."""
    jeng = _jax_engine()
    monkeypatch.setenv("ROUNDTABLE_KV_QUANT", "0")
    killed = _port_engine(jeng, kv_quant="int8")
    plain = _port_engine(jeng)
    assert killed.kv_quant_spec is None
    assert killed.kv_quant_describe()["reason"] == "disabled:env"
    assert killed.kv.scales is None
    assert killed.kv.pools[0][0].dtype == torch.float32
    assert killed.kv.num_pages == plain.kv.num_pages
    assert killed.kv.hbm_bytes() == plain.kv.hbm_bytes()
    assert _two_rounds(killed) == _two_rounds(plain)
    for (k1, v1), (k2, v2) in zip(killed.kv.pools, plain.kv.pools):
        assert torch.equal(k1, k2) and torch.equal(v1, v2)


def test_contiguous_layout_declines_kv_quant():
    """As in the JAX engine: the contiguous layout records why and serves
    unquantized slots."""
    eng = InferenceEngine.from_config(
        {"model": "tiny-llama", "max_seq_len": 128, "kv_quant": "int8"},
        device="cpu")
    assert eng.kv_layout == "contiguous"
    assert eng.kv_quant_describe()["reason"] == "kv_layout:contiguous"
    assert "kv_quant" not in eng.describe()
