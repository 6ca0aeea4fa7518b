"""PyTorch port, Mixtral-style MoE: moe_mlp and its routing against the
JAX package's, the Mixtral registry entries, tiny-mixtral engines (paged,
contiguous, the scheduler's ragged joins, int8/int4 experts) against the
JAX engine's greedy tokens on bridged weights, expert parallelism on two
gloo ranks against one device, the HF `block_sparse_moe` layout against
the JAX loader, quantized experts against JAX's quantize_params and
against the explicitly dequantized tree, and the expert down product's
K5 route against JAX's `_mm_pack_out` in interpret mode.

This module imports only torch and numpy at its top: the spawned EP ranks
import it to find their function and must not import jax. The JAX side is
imported inside the tests.

Tolerances, each stated where it is used: f32 on both sides differs only
in summation order (moe_mlp within 1e-5, logits within 1e-4, greedy
tokens identical); bf16 moe_mlp within 2e-2 (one bf16 rounding of the
hidden and of the output, on both sides); EP logits within 1e-4 of one
device (the down partials summed per rank, then all-reduced)."""

import dataclasses

import numpy as np
import pytest
import torch

from theroundtaible_tpu_torch.engine import distributed, quant
from theroundtaible_tpu_torch.engine.kernels import int4mm
from theroundtaible_tpu_torch.engine.models import common
from theroundtaible_tpu_torch.engine.models.registry import \
    get_model_config as torch_config
from theroundtaible_tpu_torch.engine.sharding import Mesh

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
LOGIT_ATOL = 1e-4
SPAWN_TIMEOUT_S = 300.0
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


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def jax_tree(name="tiny-mixtral", seed=0, dtype="float32", **over):
    """(JAX config, port config, the JAX init_params tree as numpy)."""
    jax, jnp = _jax()
    from theroundtaible_tpu.engine.models.common import init_params
    from theroundtaible_tpu.engine.models.registry import get_model_config
    jc = get_model_config(name, **over)
    tc = torch_config(name, **over)
    tree = init_params(jc, jax.random.PRNGKey(seed),
                       {"float32": jnp.float32,
                        "bfloat16": jnp.bfloat16}[dtype])
    return jc, tc, jax.device_get(tree)


def bridge(tree, tc, dtype=torch.float32, mesh=None):
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    return params_from_numpy(tree, tc, dtype, "cpu", mesh=mesh)


# --- moe_mlp and the router ---


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_moe_mlp_matches_jax(dtype, tol):
    """One layer's moe_mlp on the same weights and hidden: f32 equal up to
    summation order (so every token routes to the same experts), bf16
    within one rounding of the hidden and the output."""
    jax, jnp = _jax()
    from theroundtaible_tpu.engine.models.common import moe_mlp as jax_moe
    jc, tc, tree = jax_tree(dtype=dtype, seed=1)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    layer = bridge(tree, tc, tdt)["layers"][0]
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 5, tc.embed_dim)) * 0.5).astype(np.float32)
    want = np.asarray(jax_moe(jnp.asarray(x, jdt), tree["layers"][0], jc),
                      np.float32)
    got = common.moe_mlp(torch.from_numpy(x).to(tdt), layer, tc)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_route_picks_k_experts_and_the_lower_index_at_a_tie():
    """route(): k nonzero weights per token that sum to 1 (a softmax over
    the top-k logits only), the JAX package's top-k - lax.top_k, whose
    exact ties go to the lower expert index - on random and tied logits."""
    jax, jnp = _jax()
    cfg = torch_config("tiny-mixtral")
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 4, cfg.num_experts)).astype(np.float32)
    logits[0, 0] = [1.0, 2.0, 2.0, 2.0]   # a three-way tie for the top
    logits[0, 1] = [0.5, 0.5, 0.5, 0.5]   # every expert tied
    w = common.route(torch.from_numpy(logits), cfg).numpy()
    assert ((w > 0).sum(-1) == cfg.num_experts_per_tok).all()
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-6)
    vals, idx = jax.lax.top_k(jnp.asarray(logits), cfg.num_experts_per_tok)
    gates = np.asarray(jax.nn.softmax(vals, axis=-1))
    want = np.zeros_like(logits)
    np.put_along_axis(want, np.asarray(idx), gates, axis=-1)
    np.testing.assert_allclose(w, want, atol=1e-6)
    assert np.flatnonzero(w[0, 0]).tolist() == [1, 2]
    assert np.flatnonzero(w[0, 1]).tolist() == [0, 1]


@pytest.mark.parametrize("name", ["mixtral-8x7b-instruct", "tiny-mixtral"])
def test_mixtral_registry_entries_match_jax(name):
    from theroundtaible_tpu.engine.models.registry import get_model_config
    assert dataclasses.asdict(torch_config(name)) == \
        dataclasses.asdict(get_model_config(name))
    cfg = torch_config(name)
    assert cfg.num_experts in (4, 8) and cfg.num_experts_per_tok == 2


def test_init_params_draws_the_jax_layout():
    """init_params' MoE layer: the router [E, X] and the expert stacks
    gate/up [X, E, F], down [X, F, E], as the JAX package's."""
    _, tc, tree = jax_tree()
    ours = common.init_params(tc, torch.Generator().manual_seed(0),
                              torch.float32, "cpu")
    for lo, lt in zip(ours["layers"], tree["layers"]):
        assert set(lo) == set(lt)
        assert tuple(lo["router"].shape) == tuple(lt["router"].shape)
        for k, v in lt["experts"].items():
            assert tuple(lo["experts"][k].shape) == tuple(v.shape), k
    assert common.param_count(ours) == sum(
        np.asarray(x).size for x in _np_leaves(tree))


def _np_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _np_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _np_leaves(v)
    else:
        yield tree


# --- engines on bridged weights ---


def _two_rounds(eng):
    outs = [eng.generate_batch(ROUND1, max_new_tokens=8),
            eng.generate_batch(ROUND2, max_new_tokens=8)]
    records = {n: list(eng.kv._slots[n].tokens) for n, _ in ROUND1}
    return outs, records, eng.last_stats.reused_tokens


def _engines(layout, quant_mode="none", **extra):
    jax, jnp = _jax()
    from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
    from theroundtaible_tpu.engine.models.registry import get_model_config
    from theroundtaible_tpu.engine.sampling import \
        SamplingParams as JaxSampling
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.sampling import SamplingParams
    kw = dict(kv_layout=layout, quant=quant_mode)
    if layout == "paged":
        kw.update(page_size=32, ragged_attn=False)
    kw.update(extra)
    jeng = JaxEngine(get_model_config("tiny-mixtral", max_seq_len=MAX_SEQ),
                     mesh_shape={"data": 1, "model": 1}, num_slots=4,
                     dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0, max_new_tokens=8),
                     **OFF, **kw)
    cfg = torch_config("tiny-mixtral", max_seq_len=MAX_SEQ)
    teng = InferenceEngine(
        cfg, num_slots=4, dtype=torch.float32,
        sampling=SamplingParams(temperature=0.0, max_new_tokens=8),
        params=bridge(jax.device_get(jeng.params), cfg), device="cpu",
        **OFF, **kw)
    return jeng, teng


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_moe_engine_matches_jax(layout):
    """A 2-knight round and its delta round on tiny-mixtral: greedy tokens,
    slot records and reused tokens equal the JAX engine's, and describe()
    reports the same parameter count and pool size."""
    jeng, teng = _engines(layout)
    assert _two_rounds(teng) == _two_rounds(jeng)
    dj, dt = jeng.describe(), teng.describe()
    for key in ("params", "num_pages", "kv_hbm_bytes", "quant"):
        if key in dj:
            assert dt[key] == dj[key], key


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_moe_engine_matches_jax(monkeypatch, mode):
    """int8/int4 experts (the router full precision) on the paged pool:
    the JAX engine's greedy tokens; the int4 route lists the expert sites -
    gate/up on the dequant path with JAX's reason, down on K5's plain
    version at decode rows."""
    monkeypatch.setenv("ROUNDTABLE_INT4_MM", "1")
    jeng, teng = _engines("paged", mode)
    assert _two_rounds(teng) == _two_rounds(jeng)
    assert teng.describe()["params"] == jeng.describe()["params"]
    if mode == "int4":
        paths = teng.describe()["int4_paths"]
        up = [e for e in paths["xla_dequant"]
              if e["spec"] == common.SPEC_EXPERT_UP]
        assert up and {e["fallback_reason"] for e in up} == {
            "spec:mixed-kept-contracted"}
        assert common.SPEC_EXPERT_DOWN in {
            e["spec"] for e in paths["plain_w4a16"]}


def test_moe_scheduler_join_matches_jax():
    """A session joining mid-decode through the scheduler's ragged seam
    (K3's plain version) gets the JAX engine's direct greedy tokens."""
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
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        assert not errors, errors
        for sid in prompts:
            assert results[sid][0] == direct[sid], sid
        assert sched.describe()["completed"] == 2
        assert teng.ragged_describe()["dispatches"].get("plain_ragged", 0) \
            >= 1
    finally:
        sched.close()


def test_lora_on_moe_targets_attention_and_serves():
    """LoRA personas on a MoE engine: the store targets attention only (the
    JAX package's lora_dims), the K7 plain path serves a persona round and
    the scheduler's adapter path runs."""
    from theroundtaible_tpu.engine.lora import lora_dims as jax_lora_dims
    from theroundtaible_tpu.engine.models.registry import get_model_config
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.lora import lora_dims
    from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
    assert set(lora_dims(torch_config("tiny-mixtral"))) == set(
        jax_lora_dims(get_model_config("tiny-mixtral"))) == {
        "q_proj", "k_proj", "v_proj", "o_proj"}
    config = {"model": "tiny-mixtral", "max_seq_len": MAX_SEQ,
              "dtype": "float32", "kv_layout": "paged", "page_size": 32,
              **OFF, "lora": {"rank": 4, "max_adapters": 3, "adapters": {
                  "galahad": {"seed": 1, "init_std": 0.6}}}}

    def fresh():
        return InferenceEngine.from_config(config, device="cpu")

    base = fresh().generate_batch(ROUND1, max_new_tokens=6)
    eng = fresh()
    mixed = eng.generate_batch(ROUND1, max_new_tokens=6,
                               adapters_per_turn=[None, "galahad"])
    assert mixed[0] == base[0] and mixed[1] != base[1]
    assert eng.describe()["lora"]["lora_paths"]
    sched = SessionScheduler(fresh())
    try:
        texts, _ = sched.submit("s", ROUND1, max_new_tokens=6,
                                adapters_per_turn=[None, "galahad"])
        assert texts == mixed
    finally:
        sched.close()


# --- quantized experts ---


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_experts_bit_identical(bits):
    """quantize_params on a MoE tree: every expert leaf equals the JAX
    package's (_EXPERT_SCALE_AXES), the router passes through."""
    from theroundtaible_tpu.engine import quant as jquant
    jc, tc, tree = jax_tree(seed=2)
    theirs = jquant.quantize_params(tree, jc, act_dtype=np.float32,
                                    bits=bits)
    ours = quant.quantize_params(bridge(tree, tc), tc,
                                 act_dtype=torch.float32, bits=bits)
    for lo, lt in zip(ours["layers"], theirs["layers"]):
        assert isinstance(lo["router"], torch.Tensor)
        np.testing.assert_array_equal(lo["router"].numpy(),
                                      np.asarray(lt["router"]))
        for k, v in lt["experts"].items():
            got = lo["experts"][k]
            if hasattr(v, "q4"):
                assert isinstance(got, common.Int4Leaf)
                assert (got.axis, got.group) == (v.axis, v.group)
                np.testing.assert_array_equal(got.q4.numpy(),
                                              np.asarray(v.q4))
                np.testing.assert_array_equal(got.s4.numpy(),
                                              np.asarray(v.s4))
                assert got.plan.spec == common.LEAF_SPECS[f"experts.{k}"]
            else:
                np.testing.assert_array_equal(got["q"].numpy(),
                                              np.asarray(v["q"]))
                np.testing.assert_array_equal(got["s"].numpy(),
                                              np.asarray(v["s"]))


def _dequantized(params):
    """The quantized tree with every leaf dequantized (int8 q * s over its
    kept axes, int4 through dequant_int4)."""
    def deq(key, leaf):
        if isinstance(leaf, common.Int4Leaf):
            return common.dequant_int4(leaf.q4, leaf.s4, leaf.axis,
                                       leaf.group, leaf.s4.dtype)
        if isinstance(leaf, dict) and "q" in leaf:
            axes = quant._SCALE_AXES[key]
            q = leaf["q"].float()
            keep = tuple(a % q.dim() for a in axes)
            s = leaf["s"].float()
            for a in range(q.dim()):
                if a not in keep:
                    s = s.unsqueeze(a)
            return q * s
        return leaf

    out = {k: deq(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [common.nest_layer({k: deq(k, v) for k, v in
                                        common.flat_layer(layer).items()})
                     for layer in params["layers"]]
    return out


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_experts_forward_equals_dequantized_tree(bits):
    """The serving mechanics of quantized experts (JAX
    tests/test_quant.py's contract): the forward over the quantized tree
    equals the forward over its explicitly dequantized tree - f32, the
    same routing, within summation order (1e-4 on the logits; int4's
    expert down runs K5's plain version at these decode rows)."""
    _, tc, tree = jax_tree(seed=4)
    qp = quant.quantize_params(bridge(tree, tc), tc, act_dtype=torch.float32,
                               bits=bits)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, tc.vocab_size, (2, 3)))
    positions = torch.arange(3)[None].repeat(2, 1)
    valid = torch.full((2,), 3, dtype=torch.int32)
    got, _ = common.forward(qp, tc, tokens, positions, None, None, valid)
    want, _ = common.forward(_dequantized(qp), tc, tokens, positions, None,
                             None, valid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGIT_ATOL,
                               rtol=0)


def test_expert_down_k5_route_matches_jax_interpret(monkeypatch):
    """At tiny-mixtral with embed 256 and mlp 256 the int4 expert down leaf
    (4, 256, 128) packed) is pack-on-output with C = X * F: JAX's plan
    takes `_mm_pack_out` (interpret mode here) and the port's K5 (its plain
    version); the products agree (f32, 1e-5). Gate/up decline in both with
    `spec:mixed-kept-contracted`."""
    jax, jnp = _jax()
    from theroundtaible_tpu.engine import quant as jquant
    from theroundtaible_tpu.engine.pallas import int4mm as jint4mm
    jc, tc, tree = jax_tree(embed_dim=256, mlp_dim=256, seed=5)
    jq = jquant.quantize_params(tree, jc, act_dtype=jnp.float32, bits=4)
    jleaf = jq["layers"][0]["experts"]["down_proj"]
    assert tuple(jleaf.q4.shape) == (4, 256, 128)
    tleaf = bridge(jax.device_get(jq), tc)["layers"][0]["experts"][
        "down_proj"]
    rng = np.random.default_rng(2)
    for rows in (1, 3):
        shape = (rows, 1, tc.num_experts, tc.mlp_dim)
        assert jint4mm.plan_reason(common.SPEC_EXPERT_DOWN, shape,
                                   jleaf) is None
        assert int4mm.plan_reason(common.SPEC_EXPERT_DOWN, shape,
                                  tleaf) is None
        a = rng.normal(size=shape).astype(np.float32)
        want, why = jint4mm.einsum_int4_or_reason(
            common.SPEC_EXPERT_DOWN, jnp.asarray(a), jleaf)
        assert why is None
        got, reason = int4mm.einsum_int4_or_reason(
            common.SPEC_EXPERT_DOWN, torch.from_numpy(a), tleaf)
        assert reason is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    up = jq["layers"][0]["experts"]["gate_proj"]
    assert jint4mm.plan_reason(common.SPEC_EXPERT_UP, (1, 1, 256), up) == \
        "spec:mixed-kept-contracted"
    tup = bridge(jax.device_get(jq), tc)["layers"][0]["experts"]["gate_proj"]
    assert int4mm.plan_reason(common.SPEC_EXPERT_UP, (1, 1, 256), tup) == \
        "spec:mixed-kept-contracted"


def test_card_plan_takes_the_mixtral_expert_down():
    """At Mixtral-8x7B's width the int4 expert down (C = 8 x 14336 =
    114,688, P = 2048 packed) plans K5 on a card at decode rows, whole and
    as an EP shard (C = 57,344 per rank at EP 2); gate/up keep their
    decline, which a card serves on the dequant path instead of
    refusing; K5's split plan covers C."""
    cfg = torch_config("mixtral-8x7b-instruct")
    x, e, f = cfg.num_experts, cfg.embed_dim, cfg.mlp_dim
    for experts in (x, x // 2):
        leaf = common.Int4Leaf(
            q4=torch.empty(experts, f, e // 2, device="meta",
                           dtype=torch.int8),
            s4=torch.empty(experts, f, e // 64, device="meta",
                           dtype=torch.bfloat16), axis=2, group=64)
        leaf = int4mm.plan_leaf(common.SPEC_EXPERT_DOWN, leaf)
        assert leaf.plan.reason is None and leaf.plan.width == experts * f
        for rows in (1, 3, 64):
            plan = int4mm.out_plan(rows, experts * f, e // 2, 132)
            ranges = plan.split_ranges(experts * f)
            assert ranges[0][0] == 0 and ranges[-1][1] == experts * f
            assert all(b - a <= plan.rows for a, b in ranges)
        f32 = int4mm.out_plan(1, experts * f, e // 2, 132, torch.float32)
        assert f32.rows <= int4mm._F32_MAX_ROWS
    up = int4mm.plan_leaf(common.SPEC_EXPERT_UP, common.Int4Leaf(
        q4=torch.empty(x, e, f // 2, device="meta", dtype=torch.int8),
        s4=torch.empty(x, e, f // 64, device="meta", dtype=torch.bfloat16),
        axis=2, group=64))
    assert up.plan.reason == "spec:mixed-kept-contracted"
    report = int4mm.route_report([(common.SPEC_EXPERT_UP, up)],
                                 torch.device("cuda"))
    assert report["xla_dequant"][0]["fallback_reason"] == \
        "spec:mixed-kept-contracted"


# --- expert parallelism over two gloo ranks ---


def _ep_rank(rank, tree, qtrees, fwd):
    """One rank of a {"data": 1, "model": 2} mesh: the forward of the
    dense and quantized bridged trees (this rank's experts) and a greedy
    engine round on the dense weights."""
    torch.set_num_threads(1)
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.sampling import SamplingParams
    cfg = torch_config("tiny-mixtral", max_seq_len=MAX_SEQ)
    coords = Mesh(1, 2, rank)
    out = {}
    params = bridge(tree, cfg, mesh=coords)
    eng = InferenceEngine(
        cfg, mesh_shape={"data": 1, "model": 2}, num_slots=4,
        kv_layout="paged", page_size=32, dtype=torch.float32,
        sampling=SamplingParams(temperature=0.0, max_new_tokens=8),
        params=params, ragged_attn=False, device="cpu", **OFF)
    out["experts"] = tuple(
        params["layers"][0]["experts"]["down_proj"].shape)
    out["round"] = eng.generate_batch(ROUND1, max_new_tokens=8)
    t = {k: torch.from_numpy(v) for k, v in fwd.items()}
    for name, tr in [("dense", None)] + list(qtrees.items()):
        p = params if tr is None else bridge(tr, cfg, mesh=coords)
        logits, _ = common.forward(p, cfg, t["tokens"].long(),
                                   t["positions"], None, None, t["valid"],
                                   mesh=eng.mesh)
        out[name] = logits.numpy()
    return out


@pytest.fixture(scope="module")
def ep_runs():
    jax, jnp = _jax()
    from theroundtaible_tpu.engine import quant as jquant
    from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
    from theroundtaible_tpu.engine.models.registry import get_model_config
    from theroundtaible_tpu.engine.sampling import \
        SamplingParams as JaxSampling
    jcfg = get_model_config("tiny-mixtral", max_seq_len=MAX_SEQ)
    jeng = JaxEngine(jcfg, mesh_shape={"data": 1, "model": 1}, num_slots=4,
                     kv_layout="paged", page_size=32, dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0, max_new_tokens=8),
                     ragged_attn=False, **OFF)
    tree = jax.device_get(jeng.params)
    qtrees = {f"int{b}": jax.device_get(jquant.quantize_params(
        tree, jcfg, act_dtype=jnp.float32, bits=b, model_shards=2))
        for b in (8, 4)}
    rng = np.random.default_rng(5)
    fwd = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 12)).astype(
        np.int32),
        "positions": np.broadcast_to(np.arange(12, dtype=np.int32),
                                     (2, 12)).copy(),
        "valid": np.full((2,), 12, np.int32)}
    cfg = torch_config("tiny-mixtral", max_seq_len=MAX_SEQ)
    single = {}
    t = {k: torch.from_numpy(v) for k, v in fwd.items()}
    for name, tr in [("dense", tree)] + list(qtrees.items()):
        single[name] = common.forward(bridge(tr, cfg), cfg,
                                      t["tokens"].long(), t["positions"],
                                      None, None, t["valid"])[0].numpy()
    ref = {"round": jeng.generate_batch(ROUND1, max_new_tokens=8),
           "single": single}
    ranks = distributed.launch(_ep_rank, 2, "gloo", "cpu",
                               args=(tree, qtrees, fwd),
                               timeout_s=SPAWN_TIMEOUT_S)
    return ref, ranks


@pytest.mark.parametrize("name", ["dense", "int8", "int4"])
def test_ep_logits_match_one_device(ep_runs, name):
    """Experts split 2 and 2 over two gloo ranks: the f32 logits of the
    dense, int8 and int4 trees within 1e-4 of one device's forward on the
    whole tree, and equal on both ranks (one all-reduce of the down
    partials)."""
    ref, ranks = ep_runs
    for r in ranks:
        np.testing.assert_allclose(r[name], ref["single"][name],
                                   atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(ranks[0][name], ranks[1][name])


def test_ep_engine_matches_jax_and_holds_its_experts(ep_runs):
    """The EP engine's greedy round equals the JAX engine's on one device,
    on both ranks; each rank holds 2 of the 4 experts."""
    ref, ranks = ep_runs
    for r in ranks:
        assert r["round"] == ref["round"]
        assert r["experts"][0] == 2


def test_param_specs_and_shardable_match_jax():
    """The EP spec tree (experts on the model axis, the router replicated)
    and shardable() (num_experts % m) agree with the JAX package's."""
    from theroundtaible_tpu.engine import sharding as jsharding
    from theroundtaible_tpu.engine.models.registry import get_model_config
    from theroundtaible_tpu_torch.engine import sharding
    jc, tc = get_model_config("tiny-mixtral"), torch_config("tiny-mixtral")
    jl = jsharding.param_specs(jc)["layers"][0]
    tl = sharding.param_specs(tc)["layers"][0]
    assert tl["router"] == tuple(jl["router"])
    assert {k: tuple(v) for k, v in jl["experts"].items()} == tl["experts"]
    for m in (2, 3, 4):
        jmesh = type("M", (), {"shape": {"data": 1, "model": m}})()
        assert sharding.shardable(tc, Mesh(1, m, 0)) == \
            jsharding.shardable(jc, jmesh)


# --- the HF block_sparse_moe layout ---


def _mixtral_dir(tmp_path, experts=4):
    import transformers
    torch.manual_seed(0)
    hf = transformers.MixtralForCausalLM(transformers.MixtralConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=experts, num_experts_per_tok=2,
        max_position_embeddings=512, tie_word_embeddings=False))
    hf.save_pretrained(tmp_path, safe_serialization=True)
    return tmp_path


def test_hf_block_sparse_moe_loads_as_jax(tmp_path):
    """A transformers-written Mixtral directory: the router, the stacked
    experts and every other leaf equal the JAX loader's; int8 experts
    quantize on the way in as quantize_params would."""
    jax, jnp = _jax()
    from theroundtaible_tpu.engine.checkpoint import \
        load_hf_checkpoint as jax_load
    from theroundtaible_tpu.engine.models.registry import get_model_config
    from theroundtaible_tpu_torch.engine.checkpoint import load_hf_checkpoint
    d = _mixtral_dir(tmp_path)
    jc, tc = get_model_config("tiny-mixtral"), torch_config("tiny-mixtral")
    theirs = jax.device_get(jax_load(d, jc, jnp.float32))
    ours = load_hf_checkpoint(d, tc, torch.float32, "cpu")
    for lo, lt in zip(ours["layers"], theirs["layers"]):
        flat = common.flat_layer(lo)
        for k, v in common.flat_layer(lt).items():
            np.testing.assert_array_equal(flat[k].numpy(), np.asarray(v), k)
    from functools import partial
    q = load_hf_checkpoint(d, tc, torch.float32, "cpu", quantize=partial(
        quant.quantize_leaves, cfg=tc, act_dtype=torch.float32, bits=8))
    want = quant.quantize_params(ours, tc, act_dtype=torch.float32, bits=8)
    for lq, lw in zip(q["layers"], want["layers"]):
        for k, v in lw["experts"].items():
            assert torch.equal(lq["experts"][k]["q"], v["q"]), k


def test_hf_expert_index_beyond_the_config_raises(tmp_path):
    """A checkpoint with more experts than the config: the JAX loader's
    error, in both packages."""
    jax, jnp = _jax()
    from theroundtaible_tpu.engine.checkpoint import \
        load_hf_checkpoint as jax_load
    from theroundtaible_tpu.engine.models.registry import get_model_config
    from theroundtaible_tpu_torch.engine.checkpoint import load_hf_checkpoint
    d = _mixtral_dir(tmp_path, experts=6)
    with pytest.raises(ValueError, match="expert index 4") as jerr:
        jax_load(d, get_model_config("tiny-mixtral"), jnp.float32)
    with pytest.raises(ValueError, match="expert index 4") as terr:
        load_hf_checkpoint(d, torch_config("tiny-mixtral"), torch.float32,
                           "cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("name", ["mixtral-8x7b-instruct", "tiny-mixtral"])
def test_fleet_estimates_match_jax(name, dtype):
    """fleet's size estimates of a MoE config (all experts resident, the
    router beside them) in every dtype equal the JAX package's."""
    from theroundtaible_tpu.engine import fleet as jfleet
    from theroundtaible_tpu.engine.models.registry import get_model_config
    from theroundtaible_tpu_torch.engine import fleet
    assert fleet.estimate_param_count(torch_config(name)) == \
        jfleet.estimate_param_count(get_model_config(name))
    cfg = {"model": name, "dtype": dtype, "num_slots": 4,
           "max_seq_len": 512}
    assert fleet.estimate_engine_hbm_bytes(cfg) == \
        jfleet.estimate_engine_hbm_bytes(cfg)


@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
def test_perf_model_streams_the_jax_tree_bytes(mode):
    """The perf model's streamed bytes of a (quantized) MoE tree equal the
    JAX perf model's on the same tree: every expert once, the router in
    full precision."""
    jax, jnp = _jax()
    from theroundtaible_tpu.engine import quant as jquant
    from theroundtaible_tpu.utils import perfmodel as jperf
    from theroundtaible_tpu_torch.utils import perfmodel
    jc, tc, tree = jax_tree(seed=6)
    if mode != "none":
        tree = jax.device_get(jquant.quantize_params(
            tree, jc, act_dtype=jnp.float32, bits=int(mode[-1])))
    assert perfmodel.streamed_param_bytes(bridge(tree, tc)) == \
        jperf.streamed_param_bytes(tree)


def test_chip_smoke_writer_holds_the_hf_mixtral_layout(tmp_path):
    """chip_smoke.write_hf_checkpoint of a MoE tree writes the HF
    block_sparse_moe layout: MixtralForCausalLM.from_pretrained reads it
    and gives the port's logits on the loaded tree (f32, within 1e-4; its
    router softmax over every expert, then the top-k renormalized, equals
    the softmax over the top-k), and the JAX loader reads the same
    tensors."""
    import sys
    from pathlib import Path

    import jax.numpy as jnp
    from transformers import MixtralForCausalLM
    from theroundtaible_tpu.engine.checkpoint import \
        load_hf_checkpoint as jax_load
    from theroundtaible_tpu.engine.models.registry import get_model_config
    from theroundtaible_tpu_torch.engine.checkpoint import load_hf_checkpoint
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    tc = torch_config("tiny-mixtral")
    params = common.init_params(tc, torch.Generator().manual_seed(8),
                                torch.float32, "cpu")
    chip_smoke.write_hf_checkpoint(torch, params, tc, tmp_path, shards=2)
    ours = load_hf_checkpoint(tmp_path, tc, torch.float32, "cpu")
    theirs = jax_load(tmp_path, get_model_config("tiny-mixtral"),
                      jnp.float32)
    for lo, lp, lt in zip(ours["layers"], params["layers"],
                          theirs["layers"]):
        flat, want = common.flat_layer(lo), common.flat_layer(lp)
        for k, v in common.flat_layer(lt).items():
            assert torch.equal(flat[k], want[k]), k
            np.testing.assert_array_equal(flat[k].numpy(), np.asarray(v), k)
    hf = MixtralForCausalLM.from_pretrained(tmp_path,
                                            torch_dtype=torch.float32)
    tokens = torch.tensor([[1, 9, 4, 7, 200, 31, 5, 77]])
    with torch.no_grad():
        ref = hf(tokens).logits[0]
    got, _ = common.forward(ours, tc, tokens, torch.arange(8)[None], None,
                            None, torch.tensor([8]))
    np.testing.assert_allclose(got[0].numpy(), ref.numpy(), atol=1e-4,
                               rtol=1e-4)
