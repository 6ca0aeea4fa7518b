"""PyTorch port, multi-LoRA personas: K7's plain version against the JAX
package's `_bgmv` run in interpret mode and against its `_xla_grouped`,
the plan's reasons, `grouped_bmm`, the int8 stack quantization bit for
bit, LoraStore against the JAX store, engines on bridged weights with
npz personas (the same files in both packages) against the JAX engine's
greedy tokens on both KV layouts, the scheduler with a ragged join, and
the torch-llm adapter's persona map. f32; inputs from numpy seeds. The
CUDA kernel itself runs only on a card: tests/test_torch_cuda.py."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theroundtaible_tpu.adapters.base import KnightTurn as JaxTurn
from theroundtaible_tpu.adapters.tpu_llm import TpuLlmAdapter
from theroundtaible_tpu.engine import lora as jlora
from theroundtaible_tpu.engine import quant as jquant
from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
from theroundtaible_tpu.engine.models.registry import \
    get_model_config as jax_config
from theroundtaible_tpu.engine.pallas import lora as jplora
from theroundtaible_tpu.engine.sampling import SamplingParams as JaxSampling
from theroundtaible_tpu_torch.adapters.base import KnightTurn
from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
from theroundtaible_tpu_torch.engine import lora
from theroundtaible_tpu_torch.engine import quant
from theroundtaible_tpu_torch.engine.engine import InferenceEngine
from theroundtaible_tpu_torch.engine.kernels import lora as klora
from theroundtaible_tpu_torch.engine.models.registry import \
    get_model_config as torch_config
from theroundtaible_tpu_torch.engine.sampling import SamplingParams
from theroundtaible_tpu_torch.engine.scheduler import (SchedulerRefused,
                                                       SessionScheduler)
from theroundtaible_tpu_torch.engine.weights import params_from_numpy

# The plain versions against the JAX functions: f32, sums in another
# order.
TOL = dict(atol=1e-5, rtol=1e-5)
OFF = dict(prefix_cache=False, kv_offload=False, spec_decode=False)
MESH1 = {"data": 1, "model": 1}
MAX_SEQ = 512
RANK = 4
NAMES = ("galahad", "percival", "lancelot")
PROMPT = "the knights debate the session store design at the roundtable"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stacks(rng, s, r, c, o, m):
    """x [m, c] and S-slot stacks at a persona's scale (A ~ N(0, 1/C), as
    the stores draw it, so xa is O(1)); slot 0 zero, ids mixed."""
    x = rng.normal(size=(m, c)).astype(np.float32)
    a_t = (rng.normal(size=(s, r, c)) * c ** -0.5).astype(np.float32)
    b_s = (rng.normal(size=(s, r, o)) * 0.5).astype(np.float32)
    a_t[0] = 0.0
    b_s[0] = 0.0
    # mixed ids, slot 0 (the base) among them
    ids = (np.arange(m) * 7 + 3) % s
    ids[0] = 0
    return x, a_t, b_s, ids.astype(np.int32)


def _jax_bgmv(x, a_t, b_s, ids):
    y, reason = jplora.lora_bgmv_or_reason(
        jnp.asarray(x), jnp.asarray(a_t), jnp.asarray(b_s),
        jnp.asarray(ids))
    assert reason is None, reason
    return np.asarray(y)


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


CASES = ([(m, r, c, o) for m in (1, 3, 8, 64) for r, (c, o) in
          zip((1, 8, 16), ((128, 512), (256, 256), (512, 128)))]
         + [(3, 8, c, o) for c in (128, 256, 512) for o in (128, 256, 512)])


@pytest.mark.parametrize("m,r,c,o", CASES)
def test_plain_bgmv_matches_jax_kernel_and_grouped(monkeypatch, m, r, c, o):
    """K7's plain version against JAX's _bgmv in interpret mode and its
    _xla_grouped, and the port's grouped_bmm against _xla_grouped, at
    mixed ids (slot 0 included); the delta of a base row is zero."""
    monkeypatch.setenv("ROUNDTABLE_LORA_MM", "1")
    rng = np.random.default_rng(m * 1000 + r * 100 + c + o)
    x, a_t, b_s, ids = stacks(rng, 5, r, c, o, m)
    ref_kernel = _jax_bgmv(x, a_t, b_s, ids)
    ref_grouped = np.asarray(jlora._xla_grouped(
        jnp.asarray(x), jnp.asarray(a_t), jnp.asarray(b_s),
        jnp.asarray(ids)))
    xt, at, bt, it = _torch(x, a_t, b_s, ids)
    ours = klora.lora_bgmv(xt, at, bt, it)
    assert ours.dtype == torch.float32 and ours.shape == (m, o)
    np.testing.assert_allclose(ours.numpy(), ref_kernel, **TOL)
    np.testing.assert_allclose(ours.numpy(), ref_grouped, **TOL)
    np.testing.assert_allclose(lora.grouped_bmm(xt, at, bt, it).numpy(),
                               ref_grouped, **TOL)
    assert not ours[0].any()


def test_plain_bgmv_rounds_xa_to_the_activation_dtype():
    """bf16 activations: xa is rounded to bf16 before the second product,
    as the TPU kernel's `xa.astype(x.dtype)` (JAX interpret mode on the
    same bf16 values)."""
    rng = np.random.default_rng(5)
    x, a_t, b_s, ids = stacks(rng, 4, 8, 256, 128, 3)
    jx = [jnp.asarray(v, jnp.bfloat16) for v in (x, a_t, b_s)]
    ref, reason = jplora.lora_bgmv_or_reason(*jx, jnp.asarray(ids))
    assert reason is None or reason == "rows:prefill-m"
    if ref is None:
        pytest.fail("JAX plan declined a decode shape")
    tx = [torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.bfloat16) for v in jx]
    ours = klora.bgmv_ref(*tx, torch.from_numpy(ids))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("m,r", [(64, 8), (65, 8), (3, 0), (3, 513),
                                 (3, 1), (3, 512)])
def test_plan_reasons_match_jax(m, r):
    """rows:prefill-m past 64 rows and rank:unsupported outside 1..512,
    with the JAX package's strings; the card's alignment in place of the
    TPU's (C, O multiples of the 16-byte vector, not of 128)."""
    _jplan, jreason = jplora.plan_bgmv(m, 256, r, 512)
    plan, reason = klora.plan_bgmv(m, 256, r, 512, torch.bfloat16)
    assert reason == jreason
    assert (plan is None) == (reason is not None)
    assert klora.plan_bgmv(3, 100, 8, 512, torch.bfloat16)[1] == \
        "dims:contract-misaligned"
    assert klora.plan_bgmv(3, 256, 8, 100, torch.bfloat16)[1] == \
        "dims:out-misaligned"
    assert klora.plan_bgmv(3, 100, 8, 96, torch.float32)[1] is None
    # float16 is served since item 7e-i; float64 still declines
    assert klora.plan_bgmv(3, 256, 8, 512, torch.float16)[1] is None
    assert klora.plan_bgmv(3, 256, 8, 512, torch.float64)[1] == \
        "dtype:float64"


def test_lora_bgmv_or_reason_and_wrapper_checks():
    rng = np.random.default_rng(9)
    x, a_t, b_s, ids = stacks(rng, 3, 4, 64, 64, 65)
    xt, at, bt, it = _torch(x, a_t, b_s, ids)
    assert klora.lora_bgmv_or_reason(xt, at, bt, it) == (None,
                                                         "rows:prefill-m")
    with pytest.raises(ValueError, match="int32"):
        klora.lora_bgmv(xt[:3], at, bt, it[:3].long())
    with pytest.raises(ValueError, match="do not match"):
        klora.lora_bgmv(xt[:3], at, bt, it[:2])


@pytest.mark.parametrize("shape", [(4, 3, 64), (9, 8, 256)])
def test_quantize_lora_stack_and_slot_bit_identical(shape):
    rng = np.random.default_rng(shape[-1])
    w = rng.normal(size=shape).astype(np.float32) * 0.05
    w[0] = 0.0
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        theirs = jquant.quantize_lora_stack(jnp.asarray(w, jdt), jdt)
        ours = quant.quantize_lora_stack(
            torch.from_numpy(np.array(jnp.asarray(w, jdt).astype(
                jnp.float32))).to(tdt), tdt)
        np.testing.assert_array_equal(ours["q"].numpy(),
                                      np.asarray(theirs["q"]))
        np.testing.assert_array_equal(
            ours["s"].float().numpy(),
            np.asarray(theirs["s"].astype(jnp.float32)))
        value = rng.normal(size=shape[1:]).astype(np.float32)

        def set_slot(stack, slot, v):
            return stack.at[slot].set(v.astype(stack.dtype))

        theirs = jquant.quantize_lora_slot(theirs, jnp.int32(2),
                                           jnp.asarray(value), set_slot)
        quant.quantize_lora_slot(ours, 2, torch.from_numpy(value))
        np.testing.assert_array_equal(ours["q"].numpy(),
                                      np.asarray(theirs["q"]))
        np.testing.assert_array_equal(
            ours["s"].float().numpy(),
            np.asarray(theirs["s"].astype(jnp.float32)))


# --- the store ---


@pytest.fixture(scope="module")
def personas(tmp_path_factory):
    """Persona npz files in the layout both packages load, drawn from a
    numpy seed at tiny-llama and tiny-gemma widths (init_std 0.6, so a
    persona changes the greedy tokens)."""
    root = tmp_path_factory.mktemp("personas")
    out = {}
    for model in ("tiny-llama", "tiny-gemma"):
        dims = lora.lora_dims(torch_config(model))
        out[model] = {}
        for i, name in enumerate(NAMES + ("extra",)):
            rng = np.random.default_rng(100 + i)
            tree = {k: (rng.normal(size=(RANK, c)).astype(np.float32)
                        * c ** -0.5,
                        rng.normal(size=(RANK, o)).astype(np.float32) * 0.6)
                    for k, (c, o, _tp) in dims.items()}
            path = root / f"{model}-{name}.npz"
            lora.save_pair_tree(str(path), tree)
            out[model][name] = {"path": str(path)}
    return out


def _stores(personas, model="tiny-gemma", **kw):
    ours = lora.LoraStore(torch_config(model), rank=RANK,
                          adapters=dict(personas[model]),
                          dtype=torch.float32, device="cpu", **kw)
    theirs = jlora.LoraStore(jax_config(model), rank=RANK,
                             adapters=dict(personas[model]),
                             dtype=jnp.float32, **kw)
    return ours, theirs


def _same_stacks(ours, theirs):
    for key, ent in ours.stacked.items():
        for t in ("a", "b"):
            a, b = ent[t], theirs.stacked[key][t]
            if isinstance(a, dict):
                np.testing.assert_array_equal(a["q"].numpy(),
                                              np.asarray(b["q"]))
                np.testing.assert_array_equal(a["s"].numpy(),
                                              np.asarray(b["s"]))
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _counts(store):
    d = store.describe()
    return {k: d[k] for k in ("resident", "refs", "loads", "evictions",
                              "swaps", "adapter_bytes", "resident_bytes",
                              "stack_bytes", "registered", "targets")}


@pytest.mark.parametrize("qmode", ["none", "int8"])
def test_store_load_evict_lru_matches_jax(personas, qmode):
    ours, theirs = _stores(personas, max_adapters=2, quant=qmode)
    for store in (ours, theirs):
        assert sorted((store.load("galahad"), store.load("percival"))) == \
            [1, 2]
        # full: a third load evicts the LRU unreferenced adapter
        assert store.load("lancelot") == 1
        store.acquire(["percival"])
        with pytest.raises(RuntimeError, match="reference"):
            store.evict("percival")
        store.acquire(["lancelot"])
        with pytest.raises(RuntimeError, match="exhausted"):
            store.load("galahad")
        assert not store.can_admit(["galahad"])
        store.release(["percival", "lancelot"])
        assert store.can_admit(["galahad"])
    _same_stacks(ours, theirs)
    assert _counts(ours) == _counts(theirs)


def test_store_two_pass_acquire_and_atomicity_match_jax(personas):
    ours, theirs = _stores(personas, max_adapters=2)
    for store in (ours, theirs):
        tree = store.make_pair_tree("galahad")
        store.load("galahad", tree)
        store.load("percival")
        g = store.slot_of("galahad")
        # the resident pass refs galahad first, so percival is the victim
        slots = store.acquire(["lancelot", "galahad"])
        assert slots[1] == g and "percival" not in store.resident()
        # exception-atomic: a failing load releases this call's refs
        store.register("broken", {"path": "/nonexistent/persona.npz"})
        with pytest.raises(Exception):
            store.acquire(["galahad", "broken"])
        assert store.describe()["refs"] == {"lancelot": 1, "galahad": 1}
        store.release(["lancelot", "galahad"])
        assert store.describe()["refs"] == {}
    _same_stacks(ours, theirs)
    assert _counts(ours) == _counts(theirs)


def test_store_validate_errors_match_jax(personas):
    ours, theirs = _stores(personas, max_adapters=2)
    for bad in ([None], ["mordred", None], ["galahad", "percival",
                                            "lancelot"]):
        msgs = []
        for store in (ours, theirs):
            with pytest.raises(ValueError) as e:
                store.validate(bad, 2 if len(bad) != 1 else 2)
            msgs.append(str(e.value).replace("—", "-"))
        assert msgs[0] == msgs[1]
    ours.validate([None, "galahad"], 2)
    with pytest.raises(ValueError, match="max_adapters"):
        lora.LoraStore(torch_config("tiny-gemma"), max_adapters=0,
                       device="cpu")
    with pytest.raises(ValueError, match="unknown lora targets"):
        lora.LoraStore(torch_config("tiny-gemma"), targets=["router"],
                       device="cpu")
    with pytest.raises(KeyError, match="unknown lora adapter"):
        ours.make_pair_tree("mordred")


@pytest.mark.parametrize("block", [
    {"rank": 4, "max_adapters": 3},
    {"rank": 4, "max_adapters": 3, "quant": "int8"},
    {"rank": 8, "max_adapters": 2, "targets": ["q_proj", "v_proj"]}])
def test_stack_bytes_for_matches_jax_and_store(block):
    for model in ("tiny-llama", "tiny-gemma"):
        ours = lora.stack_bytes_for(torch_config(model), block)
        assert ours == jlora.stack_bytes_for(jax_config(model), block)
        store = lora.LoraStore(
            torch_config(model), rank=block["rank"],
            max_adapters=block["max_adapters"],
            quant=block.get("quant", "none"), targets=block.get("targets"),
            device="cpu")
        if block.get("quant") != "int8":
            assert store.stack_bytes() == ours


def test_seed_personas_have_the_jax_distributions():
    """Seed personas draw from a torch.Generator (not jax.random's bits):
    the same shapes, A ~ N(0, 1/C), B ~ N(0, init_std^2)."""
    store = lora.LoraStore(torch_config("tiny-llama"), rank=64,
                           adapters={"p": {"seed": 3, "init_std": 0.5}},
                           device="cpu")
    tree = store.make_pair_tree("p")
    jstore = jlora.LoraStore(jax_config("tiny-llama"), rank=64,
                             adapters={"p": {"seed": 3, "init_std": 0.5}})
    jtree = jstore.make_pair_tree("p")
    for key, (a, b) in tree.items():
        assert a.shape == jtree[key][0].shape and b.shape == \
            jtree[key][1].shape
        c = a.shape[1]
        assert abs(a.std() * c ** 0.5 - 1.0) < 0.1
        assert abs(b.std() / 0.5 - 1.0) < 0.1
    np.testing.assert_array_equal(tree["q_proj"][0],
                                  store.make_pair_tree("p")["q_proj"][0])


# --- engines ---

TURNS = [("gawain", PROMPT), ("galahad", PROMPT + " again"),
         ("percival", PROMPT + " once more")]
ADS = [None, "galahad", "percival"]


def _engines(personas, model, layout, lora_block=None, ragged=False,
             quant_mode="none"):
    """The JAX engine and the port's on its bridged weights, both with the
    npz personas; the port's paged engine has its ragged seam on when
    `ragged` (the JAX engine serves direct calls only)."""
    block = {"rank": RANK, "max_adapters": 3, "scale": 4.0,
             "adapters": dict(personas[model])}
    block.update(lora_block or {})
    kw = dict(kv_layout=layout, quant=quant_mode)
    if layout == "paged":
        kw.update(page_size=32, ragged_attn=False)
    jeng = JaxEngine(jax_config(model, max_seq_len=MAX_SEQ),
                     mesh_shape=MESH1, num_slots=6, dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0,
                                          max_new_tokens=8),
                     lora=dict(block), **OFF, **kw)
    cfg = torch_config(model, max_seq_len=MAX_SEQ)
    teng = InferenceEngine(
        cfg, num_slots=6, dtype=torch.float32,
        sampling=SamplingParams(temperature=0.0, max_new_tokens=8),
        params=params_from_numpy(jax.device_get(jeng.params), cfg,
                                 torch.float32, "cpu"),
        lora=dict(block), device="cpu", **OFF,
        **{**kw, "ragged_attn": None if ragged else kw.get("ragged_attn")})
    # Tiny prompts would resolve back to the prologue under the default
    # deferral threshold: defer every join.
    teng.ragged_defer_min = 1
    return jeng, teng


def _serve(eng, session, turns, ads):
    texts = eng.generate_batch(turns, max_new_tokens=8, session=session,
                               adapters_per_turn=ads)
    return texts, eng.last_stats.reused_tokens


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("model", ["tiny-llama", "tiny-gemma"])
def test_engine_mixed_and_single_adapters_match_jax(personas, model,
                                                    layout):
    """One batch of [base, galahad, percival], then each knight alone on
    fresh slots: the JAX engine's greedy tokens, and each row of the mixed
    batch equals its adapter served alone. The mixed batch suppresses
    sharing (counted as in JAX); K7's plain version served every decode
    dispatch and the grouped einsums every prefill one."""
    jeng, teng = _engines(personas, model, layout)
    lora.reset_test_counters()
    ours = _serve(teng, "mix", TURNS, ADS)
    assert ours == _serve(jeng, "mix", TURNS, ADS)
    assert lora.max_mixed_seen() == 2
    assert len(set(ours[0])) == 3
    for i, a in enumerate(ADS):
        alone = _serve(teng, f"solo{i}", [TURNS[i]], [a])
        assert alone == _serve(jeng, f"solo{i}", [TURNS[i]], [a])
        assert alone[0][0] == ours[0][i], f"adapter {a} diverged"
    dj, dt = jeng.describe()["lora"], teng.describe()["lora"]
    for key in ("enabled", "reason", "apply_tokens", "share_suppressed"):
        assert dt[key] == dj[key], key
    assert dt["share_suppressed"] == 1
    assert _counts_of(dt["store"]) == _counts_of(dj["store"])
    paths = dt["lora_paths"]
    assert {(e["leaf"], e["path"]) for e in paths["plain_bgmv"]} == {
        (k, "plain_bgmv") for k in lora.lora_dims(teng.cfg)}
    assert {e["fallback_reason"] for e in paths["xla_grouped_bmm"]} == {
        "rows:prefill-m"}
    assert all(e["rows"] <= klora.MAX_ROWS for e in paths["plain_bgmv"])
    assert dt["store"]["refs"] == {}


def _counts_of(d):
    return {k: d[k] for k in ("resident", "refs", "loads", "evictions",
                              "swaps", "adapter_bytes", "stack_bytes")}


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_uniform_batch_shares_and_adapter_flip_matches_jax(personas,
                                                           layout):
    """A uniform-adapter batch shares its prefix (donors of its own
    adapter only); a knight re-served under another adapter - persona to
    base, and base to persona - is released and prefills afresh: tokens
    and reused-token counts equal the JAX engine's."""
    jeng, teng = _engines(personas, "tiny-llama", layout)
    long = PROMPT * 6
    steps = [
        ("u", [("a", long + " one"), ("b", long + " two")],
         ["galahad", "galahad"]),
        ("u", [("a", long + " one more"), ("b", long + " two more")],
         ["galahad", "galahad"]),
        ("u", [("a", long + " one more")], [None]),        # persona -> base
        ("v", [("a", long)], [None]),
        ("v", [("a", long)], ["percival"]),                # base -> persona
        ("v", [("b", long + " x")], ["galahad"]),          # donor filtered
    ]
    for session, turns, ads in steps:
        assert _serve(teng, session, turns, ads) == \
            _serve(jeng, session, turns, ads), (session, turns, ads)
    assert teng.describe()["lora"]["share_suppressed"] == \
        jeng.describe()["lora"]["share_suppressed"] == 0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_kill_switch_is_byte_identical(personas, monkeypatch, layout):
    """ROUNDTABLE_LORA=0: a `lora:` engine serves exactly a LoRA-less
    engine's tokens and cache bytes, ignoring adapters_per_turn."""
    monkeypatch.setenv("ROUNDTABLE_LORA", "0")
    _jeng, killed = _engines(personas, "tiny-gemma", layout)
    cfg = torch_config("tiny-gemma", max_seq_len=MAX_SEQ)
    kw = dict(kv_layout=layout)
    if layout == "paged":
        kw.update(page_size=32, ragged_attn=False)
    plain = InferenceEngine(
        cfg, num_slots=6, dtype=torch.float32,
        sampling=SamplingParams(temperature=0.0, max_new_tokens=8),
        params=killed.params, device="cpu", **OFF, **kw)
    assert killed.lora is None
    assert killed.describe()["lora"] == {
        "enabled": False, "reason": "disabled:env", "apply_tokens": 0,
        "share_suppressed": 0}
    assert plain.describe()["lora"]["reason"] == "disabled:config"
    out_k = killed.generate_batch(TURNS, max_new_tokens=8,
                                  adapters_per_turn=ADS)
    out_p = plain.generate_batch(TURNS, max_new_tokens=8)
    assert out_k == out_p
    caches_k = killed.kv.pools if layout == "paged" else killed.kv.layers
    caches_p = plain.kv.pools if layout == "paged" else plain.kv.layers
    for (kk, vk), (kp, vp) in zip(caches_k, caches_p):
        assert torch.equal(kk, kp) and torch.equal(vk, vp)


def test_unknown_adapter_and_length_errors_match_jax(personas):
    jeng, teng = _engines(personas, "tiny-gemma", "contiguous")
    for ads in (["mordred"], [None, "galahad"]):
        msgs = []
        for eng in (teng, jeng):
            with pytest.raises(ValueError) as e:
                eng.generate_batch([("k", PROMPT)], max_new_tokens=4,
                                   adapters_per_turn=ads)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        assert teng.lora.describe()["refs"] == {}


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_int8_store_matches_jax(personas, layout):
    """An int8 store (`lora: {quant: "int8"}`): K7 declines with
    quant:int8-stack and the grouped einsums serve every dispatch, with
    the JAX engine's tokens."""
    jeng, teng = _engines(personas, "tiny-llama", layout,
                          lora_block={"quant": "int8"})
    assert _serve(teng, "q", TURNS, ADS) == _serve(jeng, "q", TURNS, ADS)
    paths = teng.describe()["lora"]["lora_paths"]
    assert paths["plain_bgmv"] == []
    assert {e["fallback_reason"] for e in paths["xla_grouped_bmm"]} == {
        "quant:int8-stack"}


@pytest.mark.parametrize("quant_mode", ["int8", "int4"])
def test_quantized_base_with_personas_matches_jax(personas, monkeypatch,
                                                  quant_mode):
    """Personas over int8 or int4 base weights (the shipped knights'
    quant): the deltas add to the quantized products' f32 results, with
    the JAX engine's tokens (ROUNDTABLE_INT4_MM=1, as the int4 parity
    suite runs the JAX seam)."""
    monkeypatch.setenv("ROUNDTABLE_INT4_MM", "1")
    jeng, teng = _engines(personas, "tiny-llama", "paged",
                          quant_mode=quant_mode)
    assert teng.describe()["quant"] == quant_mode
    assert _serve(teng, "q", TURNS, ADS) == _serve(jeng, "q", TURNS, ADS)
    assert teng.describe()["lora"]["share_suppressed"] == 1


def test_from_config_builds_the_store_jax_builds(personas):
    """`lora:` through from_config: the store's config and the describe()
    block's keys equal the JAX engine's; the engine cache keys on it."""
    config = {"model": "tiny-gemma", "max_seq_len": 256,
              "kv_layout": "paged", "page_size": 32, "dtype": "float32",
              "mesh": MESH1, "prefix_cache": False, "spec_decode": False,
              "lora": {"rank": RANK, "max_adapters": 2, "scale": 3.0,
                       "targets": ["q_proj", "down_proj"],
                       "adapters": dict(personas["tiny-gemma"])}}
    ours = InferenceEngine.from_config(config, device="cpu")
    theirs = JaxEngine.from_config(config)
    dt, dj = ours.describe()["lora"], theirs.describe()["lora"]
    assert set(dt) == set(dj)
    assert _counts_of(dt["store"]) == _counts_of(dj["store"])
    assert dt["store"]["targets"] == ["down_proj", "q_proj"]
    assert (dt["store"]["rank"], dt["store"]["scale"]) == (RANK, 3.0)


def test_kernel_disabled_routes_to_grouped_on_the_cpu(personas,
                                                      monkeypatch):
    """ROUNDTABLE_LORA_MM=0 declines K7 (`kernel-disabled`): the CPU
    serves the grouped einsums with the same tokens (a card refuses the
    engine: tests/test_torch_cuda.py)."""
    _jeng, teng = _engines(personas, "tiny-llama", "paged")
    monkeypatch.setenv("ROUNDTABLE_LORA_MM", "0")
    _jeng, off = _engines(personas, "tiny-llama", "paged")
    assert _serve(off, "k", TURNS, ADS) == _serve(teng, "k", TURNS, ADS)
    reasons = {e["fallback_reason"] for e in
               off.describe()["lora"]["lora_paths"]["xla_grouped_bmm"]}
    assert reasons == {"kernel-disabled"}


# --- the scheduler ---

SESSIONS = {
    "s0": ([("lancelot", "The round table met at dawn to discuss the "
                         "castle walls and the eastern gate.")],
           ["galahad"]),
    "s1": ([("galahad", "A different discussion entirely, about dragons "
                        "and the kingdom's gold reserves."),
            ("percival", "A different discussion entirely, about dragons "
                         "and the kingdom's gold reserves. Percival counts "
                         "the coins.")],
           ["percival", None]),
    "s2": ([("tristan", "Third topic: the harvest festival planning "
                        "session and the tournament.")],
           ["lancelot"]),
}
MAX_NEW = 70   # past one 64-token segment, so later sessions join mid-decode


def test_scheduler_ragged_join_with_personas_matches_jax(personas):
    """Three sessions with distinct personas: s0 admits into an empty
    batch, s1 and s2 join while it decodes, through ragged dispatches
    carrying per-token adapter slots. Tokens equal the JAX engine's
    direct generate_batch; every ref is released at retirement."""
    jeng, teng = _engines(personas, "tiny-llama", "paged", ragged=True)
    assert teng.ragged_enabled
    direct = {sid: jeng.generate_batch(turns, max_new_tokens=MAX_NEW,
                                       session=sid, adapters_per_turn=ads)
              for sid, (turns, ads) in SESSIONS.items()}
    sched = SessionScheduler(teng)
    results, errors = {}, {}
    lora.reset_test_counters()

    def run(sid, wait_active):
        try:
            if wait_active:
                deadline = time.monotonic() + 60
                while not sched._active and time.monotonic() < deadline:
                    time.sleep(0.002)
            turns, ads = SESSIONS[sid]
            results[sid] = sched.submit(sid, turns, max_new_tokens=MAX_NEW,
                                        adapters_per_turn=ads)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors[sid] = e

    try:
        threads = [threading.Thread(target=run, args=(sid, i > 0))
                   for i, sid in enumerate(SESSIONS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        assert not errors, errors
        for sid, (_turns, ads) in SESSIONS.items():
            texts, stats = results[sid]
            assert texts == direct[sid], f"{sid} diverged"
            assert stats.sched["lora_adapters"] == ads
        d = sched.describe()
        assert d["completed"] == 3 and d["ragged_joins"] >= 1
        assert teng.ragged_describe()["dispatches"]["plain_ragged"] >= 1
        assert lora.max_mixed_seen() >= 2
        assert teng.lora.describe()["refs"] == {}
        assert teng.describe()["lora"]["apply_tokens"] > 0
    finally:
        sched.close()


def test_scheduler_refuses_more_adapters_than_the_store(personas):
    _jeng, teng = _engines(personas, "tiny-gemma", "paged")
    teng.lora.register("extra", personas["tiny-gemma"]["extra"])
    sched = SessionScheduler(teng)
    try:
        with pytest.raises(SchedulerRefused, match="distinct lora") as e:
            sched.submit("over", [(f"k{i}", PROMPT) for i in range(4)],
                         max_new_tokens=4,
                         adapters_per_turn=list(NAMES) + ["extra"])
        assert e.value.reason == "adapters_never_fit"
        with pytest.raises(ValueError, match="unknown lora"):
            sched.submit("unk", [("k", PROMPT)], max_new_tokens=4,
                         adapters_per_turn=["mordred"])
        assert sched.describe()["refused"] == 1
        texts, stats = sched.submit("ok", [("k", PROMPT)],
                                    max_new_tokens=4,
                                    adapters_per_turn=["galahad"])
        assert stats.sched["lora_adapters"] == ["galahad"]
        assert teng.lora.describe()["refs"] == {}
    finally:
        sched.close()


# --- the adapter ---


def test_adapter_persona_map_matches_tpu_llm(personas):
    """`lora_adapter` and `knight_adapters` give each seat's persona as in
    the tpu-llm adapter; a round passes them only to a LoRA engine, and a
    round of mixed personas serves each knight under its adapter."""
    cfg = {"model": "tiny-llama", "max_seq_len": 256, "kv_layout": "paged",
           "page_size": 32, "dtype": "float32",
           "sampling": {"temperature": 0.0, "max_new_tokens": 6},
           "lora_adapter": "galahad",
           "knight_adapters": {"skeptic": "percival", "plain": None},
           "lora": {"rank": RANK, "max_adapters": 3,
                    "adapters": dict(personas["tiny-llama"])}}
    names = ("skeptic", "builder", "plain")
    ours = TorchLlmAdapter("a", cfg, device="cpu")
    theirs = TpuLlmAdapter("a", cfg)
    assert ours.persona_adapter == theirs.persona_adapter == "galahad"
    assert ours._adapters_for([KnightTurn(n, "x") for n in names]) == \
        theirs._adapters_for([JaxTurn(n, "x") for n in names]) == \
        ["percival", "galahad", None]
    no_persona = {k: v for k, v in cfg.items()
                  if k not in ("lora_adapter", "knight_adapters")}
    assert TorchLlmAdapter("b", no_persona, device="cpu")._adapters_for(
        [KnightTurn("x", "y")]) is None
    out = ours.execute_round([KnightTurn(n, PROMPT) for n in names])
    engine = ours._get_engine()
    assert len(out) == 3 and engine.describe()["lora"]["apply_tokens"] > 0
    alone = engine.generate_batch([("solo", PROMPT)], max_new_tokens=6,
                                  adapters_per_turn=["percival"])
    assert out[0] == alone[0]
    # An engine without a store gets the base-model call: no
    # adapters_per_turn reaches it.
    calls = []
    base = TorchLlmAdapter("c", {k: v for k, v in cfg.items()
                                 if k != "lora"}, device="cpu")
    base_engine = base._get_engine()
    real = base_engine.generate_batch_with_stats

    def spy(turns, **kw):
        calls.append(kw)
        return real(turns, **kw)

    base_engine.generate_batch_with_stats = spy
    base.execute_round([KnightTurn(n, PROMPT) for n in names])
    assert calls and all("adapters_per_turn" not in kw for kw in calls)
