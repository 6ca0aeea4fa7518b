"""PyTorch port, weight quantization: quantize_params against the JAX
package's bit for bit (int8, grouped int4, and an int4 tree with a leaf
that falls back to int8), the K5/K6 plain versions against the JAX
package's `_mm_pack_out`/`_mm_pack_contract` run in interpret mode at
every call site of a tiny llama and a tiny gemma (tied head), the int4
plan against JAX's (the same classification and rows; the card's block
constraints in place of the TPU's VMEM plan), and engines on bridged
quantized weights against the JAX engine's greedy tokens on both KV
layouts. f32 unless stated; inputs
from numpy seeds. The CUDA kernels themselves run only on a card:
tests/test_torch_cuda.py."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theroundtaible_tpu.engine import quant as jquant
from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
from theroundtaible_tpu.engine.models.common import \
    init_params as jax_init_params
from theroundtaible_tpu.engine.models.common import \
    param_count as jax_param_count
from theroundtaible_tpu.engine.models.registry import \
    get_model_config as jax_config
from theroundtaible_tpu.engine.pallas import int4mm as jint4mm
from theroundtaible_tpu.engine.sampling import SamplingParams as JaxSampling
from theroundtaible_tpu_torch.adapters.base import KnightTurn
from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
from theroundtaible_tpu_torch.engine import quant
from theroundtaible_tpu_torch.engine.engine import InferenceEngine
from theroundtaible_tpu_torch.engine.kernels import int4mm
from theroundtaible_tpu_torch.engine.models import common
from theroundtaible_tpu_torch.engine.models.common import Int4Leaf
from theroundtaible_tpu_torch.engine.models.registry import \
    get_model_config as torch_config
from theroundtaible_tpu_torch.engine.sampling import SamplingParams
from theroundtaible_tpu_torch.engine.weights import params_from_numpy

# The plain versions against the interpret-mode kernels: f32, blocked sums
# in another order.
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


MODELS = {
    "tiny-llama": {},
    "tiny-gemma": {},
    # gate/up [64, 127]: no even group divides 127, so those leaves stay
    # int8 inside an int4 tree
    "tiny-llama-odd-mlp": {"mlp_dim": 127},
}


def configs(name):
    base = name.replace("-odd-mlp", "")
    over = MODELS[name]
    jc = dataclasses.replace(jax_config(base), **over)
    tc = dataclasses.replace(torch_config(base), **over)
    return jc, tc


def dense_trees(name, dtype):
    jc, tc = configs(name)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jparams = jax_init_params(jc, jax.random.PRNGKey(3), jdt)
    return jc, tc, jparams, params_from_numpy(jax.device_get(jparams), tc,
                                              tdt, "cpu"), jdt, tdt


def _bits(x):
    """A torch tensor's values as comparable numpy (bf16 as its f32
    widening, exact)."""
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def assert_same_leaf(ours, theirs, where):
    if isinstance(theirs, dict):
        assert isinstance(ours, dict), where
        assert ours["q"].dtype == torch.int8, where
        np.testing.assert_array_equal(ours["q"].numpy(),
                                      np.asarray(theirs["q"]), where)
        np.testing.assert_array_equal(
            _bits(ours["s"]), np.asarray(theirs["s"]).astype(np.float32),
            where)
    elif hasattr(theirs, "q4"):
        assert isinstance(ours, Int4Leaf), where
        assert (ours.axis, ours.group) == (theirs.axis, theirs.group), where
        np.testing.assert_array_equal(ours.q4.numpy(),
                                      np.asarray(theirs.q4), where)
        np.testing.assert_array_equal(
            _bits(ours.s4), np.asarray(theirs.s4).astype(np.float32), where)
    else:
        np.testing.assert_array_equal(
            _bits(ours), np.asarray(theirs).astype(np.float32), where)


def assert_same_tree(ours, theirs):
    for key in ("embedding", "lm_head", "final_norm"):
        if key in theirs:
            assert_same_leaf(ours[key], theirs[key], key)
    for i, (lo, lt) in enumerate(zip(ours["layers"], theirs["layers"])):
        assert set(lo) == set(lt)
        for key in lt:
            assert_same_leaf(lo[key], lt[key], f"layers[{i}].{key}")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_quantize_params_bit_identical(name, dtype, bits):
    """The port's quantize_params of the bridged dense tree equals the
    JAX package's quantized tree (q from the f32 scale, s in the
    activation dtype, even element in the low nibble), and the JAX
    quantized tree bridges to the same thing."""
    jc, tc, jparams, tparams, jdt, tdt = dense_trees(name, dtype)
    theirs = jax.device_get(jquant.quantize_params(jparams, jc, act_dtype=jdt,
                                                   bits=bits))
    ours = quant.quantize_params(tparams, tc, act_dtype=tdt, bits=bits)
    assert_same_tree(ours, theirs)
    assert_same_tree(params_from_numpy(theirs, tc, tdt, "cpu"), theirs)
    assert common.param_count(ours) == jax_param_count(theirs)
    leaves = [v for layer in ours["layers"] for v in layer.values()]
    if bits == 4 and name.endswith("odd-mlp"):
        assert isinstance(ours["layers"][0]["gate_proj"], dict)
        assert isinstance(ours["layers"][0]["down_proj"], Int4Leaf)
    elif bits == 4:
        assert all(not isinstance(v, dict) for v in leaves)


def test_free_source_releases_each_dense_leaf():
    tc, tdt = torch_config("tiny-llama"), torch.float32
    tparams = common.init_params(tc, torch.Generator().manual_seed(0), tdt,
                                 "cpu")
    q_proj = tparams["layers"][0]["q_proj"]
    norm = tparams["layers"][0]["input_norm"]
    out = quant.quantize_params(tparams, tc, act_dtype=tdt, bits=4,
                                free_source=True)
    assert q_proj.untyped_storage().nbytes() == 0
    assert norm.untyped_storage().nbytes() > 0
    assert out["layers"][0]["input_norm"] is norm
    # MoE experts (item 7e-i) release theirs too; the router stays
    mc = torch_config("tiny-mixtral")
    mparams = common.init_params(mc, torch.Generator().manual_seed(0), tdt,
                                 "cpu")
    down = mparams["layers"][0]["experts"]["down_proj"]
    router = mparams["layers"][0]["router"]
    mout = quant.quantize_params(mparams, mc, act_dtype=tdt, bits=4,
                                 free_source=True)
    assert down.untyped_storage().nbytes() == 0
    assert mout["layers"][0]["router"] is router
    assert isinstance(mout["layers"][0]["experts"]["down_proj"], Int4Leaf)


def call_sites(cfg, params, rows, t=1):
    """(spec, activation shape, weight leaf) of every Int4Leaf product a
    forward makes, at `rows` x `t` activation rows (the head at `rows`)."""
    e, h, d, f = cfg.embed_dim, cfg.num_heads, cfg.head_dim, cfg.mlp_dim
    layer = params["layers"][0]
    head = params["embedding"] if cfg.tie_embeddings else params["lm_head"]
    sites = [("bte,ehd->bthd", (rows, t, e), layer["q_proj"]),
             ("bte,ekd->btkd", (rows, t, e), layer["k_proj"]),
             ("bthd,hde->bte", (rows, t, h, d), layer["o_proj"]),
             ("bte,ef->btf", (rows, t, e), layer["gate_proj"]),
             ("btf,fe->bte", (rows, t, f), layer["down_proj"]),
             ("bte,ve->btv", (rows, t, e), head)]
    return [(spec, shape, leaf) for spec, shape, leaf in sites
            if isinstance(leaf, Int4Leaf)]


def _jax_leaf(leaf):
    from theroundtaible_tpu.engine.models.common import Int4Leaf as JLeaf
    return JLeaf(q4=jnp.asarray(leaf.q4.numpy()),
                 s4=jnp.asarray(leaf.s4.float().numpy()), axis=leaf.axis,
                 group=leaf.group)


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-gemma"])
def test_plain_k5_k6_match_jax_kernels_at_every_call_site(name):
    """Every int4 product of the model through the JAX package's
    _mm_pack_out / _mm_pack_contract (interpret mode, whole-axis blocks,
    rows padded to 8) against the port's plain versions."""
    _, tc, _, tparams, _, tdt = dense_trees(name, "float32")
    params = quant.quantize_params(tparams, tc, act_dtype=tdt, bits=4)
    rng = np.random.default_rng(9)
    for spec, shape, leaf in call_sites(tc, params, rows=3):
        mode, n_cont, gp = int4mm.classify(spec, leaf)[0]
        a = rng.normal(size=shape).astype(np.float32)
        q4, s4 = leaf.q4, leaf.s4
        if mode == "out":
            c = int(np.prod(q4.shape[:n_cont]))
            x = a.reshape(-1, c)
            q2, s2 = q4.reshape(c, -1), s4.reshape(c, -1)
            ref = np.asarray(jint4mm._mm_pack_out(
                jnp.asarray(np.pad(x, ((0, 8 - x.shape[0]), (0, 0)))),
                jnp.asarray(q2.numpy()), jnp.asarray(s2.numpy()), gp, 8,
                q2.shape[1], c, True))[:x.shape[0]]
            ours = int4mm.mm_pack_out_ref(torch.from_numpy(x), q2, s2, gp)
        else:
            cp = q4.shape[-1]
            x = a.reshape(-1, 2 * cp)
            xp = np.pad(x, ((0, 8 - x.shape[0]), (0, 0)))
            ref = np.asarray(jint4mm._mm_pack_contract(
                jnp.asarray(xp[:, 0::2]), jnp.asarray(xp[:, 1::2]),
                jnp.asarray(q4.numpy()), jnp.asarray(s4.numpy()), gp, 8,
                q4.shape[0], True))[:x.shape[0]]
            ours = int4mm.mm_pack_contract_ref(torch.from_numpy(x), q4, s4,
                                               gp)
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), ref, **TOL, err_msg=spec)


# test_int4mm.py's serving shapes, where the JAX plan runs its kernels.
JAX_KERNEL_CASES = [
    ("bte,ef->btf", (2, 3, 256), (256, 512)),
    ("btf,fe->bte", (2, 3, 1024), (1024, 256)),
    ("bte,ehd->bthd", (1, 3, 256), (256, 4, 128)),
    ("bthd,hde->bte", (1, 3, 4, 128), (4, 128, 256)),
    ("bte,ve->btv", (2, 1, 256), (512, 256)),
]


@pytest.mark.parametrize("spec,ashape,wshape", JAX_KERNEL_CASES)
def test_einsum_int4_seam_matches_jax(monkeypatch, spec, ashape, wshape):
    """einsum_int4_or_reason on the CPU (the plain versions) against the
    JAX seam with ROUNDTABLE_INT4_MM=1 (its Pallas kernels in interpret
    mode), on shapes both plans accept."""
    monkeypatch.setenv("ROUNDTABLE_INT4_MM", "1")
    rng = np.random.default_rng(4)
    w = rng.normal(size=wshape).astype(np.float32) * 0.1
    leaf = int4mm.plan_leaf(spec, quant._quantize_leaf_int4(
        torch.from_numpy(w), (0,), torch.float32, 64))
    a = rng.normal(size=ashape).astype(np.float32)
    ref, why = jint4mm.einsum_int4_or_reason(spec, jnp.asarray(a),
                                             _jax_leaf(leaf))
    assert why is None
    ours, reason = int4mm.einsum_int4_or_reason(spec, torch.from_numpy(a),
                                                leaf)
    assert reason is None and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    with torch.no_grad():
        via_seam = common._matmul(torch.from_numpy(a), leaf, spec)
    np.testing.assert_allclose(via_seam.numpy(), np.asarray(ref), **TOL)


def shape_sites(cfg, rows, t=1, dtype=torch.bfloat16):
    """call_sites of an int4 tree of `cfg` built from shapes alone: the
    port's leaves on the meta device, each with the JAX package's twin
    (q4 a shape-only stand-in), groups as quantize_params picks them."""
    e, h, k, d, f, v = (cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.mlp_dim, cfg.vocab_size)
    from theroundtaible_tpu.engine.models.common import Int4Leaf as JLeaf

    def leaf(*shape):
        g = quant._int4_group_for(shape[-1], 64)
        packed = (*shape[:-1], shape[-1] // 2)
        ours = Int4Leaf(q4=torch.empty(packed, dtype=torch.int8,
                                       device="meta"),
                        s4=torch.empty(*shape[:-1], shape[-1] // g,
                                       dtype=dtype, device="meta"),
                        axis=len(shape) - 1, group=g)
        n = int(np.prod(packed))
        q4 = types.SimpleNamespace(shape=packed, ndim=len(packed), size=n)
        return ours, JLeaf(q4=q4, s4=None, axis=len(shape) - 1, group=g)

    layer = {"q_proj": leaf(e, h, d), "k_proj": leaf(e, k, d),
             "o_proj": leaf(h, d, e), "gate_proj": leaf(e, f),
             "down_proj": leaf(f, e)}
    head = leaf(v, e)
    ours = {"layers": [{n: p[0] for n, p in layer.items()}],
            "embedding": head[0], "lm_head": head[0]}
    theirs = {n: p[1] for n, p in layer.items()}
    theirs["embedding"] = theirs["lm_head"] = head[1]
    keys = ["q_proj", "k_proj", "o_proj", "gate_proj", "down_proj",
            "embedding"]
    return [(spec, shape, lf, theirs[key]) for (spec, shape, lf), key
            in zip(call_sites(cfg, ours, rows, t), keys)]


# The TPU plan's own reasons (its blocks and VMEM budget), where the card
# has its block constraints instead.
TPU_ONLY = ("blocks:", "vmem:")


@pytest.mark.parametrize("rows,t", [(3, 1), (1, 512)])
@pytest.mark.parametrize("name", ["tiny-llama", "tiny-gemma",
                                  "llama-3-8b-instruct"])
def test_plan_reason_matches_jax(name, rows, t):
    """The port's one planner against the JAX package's plan_reason at
    every call site, 3 decode rows and a 512-row prefill chunk: the same
    answer wherever JAX's is about the call site (`spec:*`, `pack:*`) or
    its rows (`rows:prefill-m`) - so at Llama-3-8B width everywhere; where
    JAX's comes from its TPU blocks or VMEM, the card's constraints
    answer instead (tiny q/k/v, groups of 16, decline with
    `pack:group`)."""
    cfg = torch_config(name)
    sites = shape_sites(cfg, rows, t)
    assert len(sites) == 6
    for spec, shape, leaf, jleaf in sites:
        ours = int4mm.plan_reason(spec, shape, leaf)
        theirs = jint4mm.plan_reason(spec, shape, jleaf)
        if theirs is not None and theirs.startswith(TPU_ONLY):
            assert name.startswith("tiny") and t == 1, (spec, theirs)
            assert ours is None or ours.startswith("pack:group"), spec
        else:
            assert ours == theirs, (spec, ours, theirs)
    leaf = sites[0][2]
    assert int4mm.plan_reason("bte,xef->btxf", (1, 1, 64), leaf) == \
        "spec:mixed-kept-contracted"


def test_card_plan_takes_every_llama3_8b_decode_product():
    """On a card every Llama-3-8B product at decode (3 rows) runs K5/K6;
    prefill rows take the dequant path (`rows:prefill-m`); a group the
    kernels' 16-byte loads cannot share declines. Shapes only: the leaves
    live on the meta device."""
    cfg = torch_config("llama-3-8b-instruct")
    for spec, shape, lf, _ in shape_sites(cfg, rows=3):
        assert int4mm.plan_reason(spec, shape, lf) is None, spec
        assert int4mm.plan_leaf(spec, lf).plan.reason is None, spec
    for spec, shape, lf, _ in shape_sites(cfg, rows=1, t=512):
        assert int4mm.plan_reason(spec, shape, lf) == "rows:prefill-m"
    e = cfg.embed_dim
    odd = Int4Leaf(q4=torch.empty(e, 8, device="meta", dtype=torch.int8),
                   s4=torch.empty(e, 1, device="meta", dtype=torch.bfloat16),
                   axis=1, group=16)
    assert int4mm.plan_reason("bte,ef->btf", (3, 1, e),
                              odd).startswith("pack:group")


@pytest.mark.parametrize("disabled", [False, True])
def test_int4_routing_is_recorded(monkeypatch, disabled):
    """A leaf's plan routes its products: decode rows to the kernel path,
    prefill rows to the dequant path (`rows:prefill-m`), every row there
    under ROUNDTABLE_INT4_MM=0 (`kernel-disabled`); route_report says so
    from the plan alone."""
    if disabled:
        monkeypatch.setenv("ROUNDTABLE_INT4_MM", "0")
    rng = np.random.default_rng(5)
    w = rng.normal(size=(256, 512)).astype(np.float32)
    leaf = int4mm.plan_leaf("bte,ef->btf", quant._quantize_leaf_int4(
        torch.from_numpy(w), (0,), torch.float32, 64))
    monkeypatch.delenv("ROUNDTABLE_INT4_MM", raising=False)
    dense = common.dequant_int4(leaf.q4, leaf.s4, 1, 64, torch.float32)
    reasons = []
    for t in (1, 100):
        a = torch.from_numpy(rng.normal(size=(2, t, 256)).astype(np.float32))
        y, reason = int4mm.einsum_int4_or_reason("bte,ef->btf", a, leaf)
        reasons.append(reason)
        np.testing.assert_allclose(
            common._matmul(a, leaf, "bte,ef->btf").numpy(),
            (a @ dense).numpy(), **TOL)
        if reason is None:
            np.testing.assert_allclose(y.numpy(), (a @ dense).numpy(), **TOL)
    report = int4mm.route_report([("bte,ef->btf", leaf)], "cpu")
    w_shape = [256, 512]
    if disabled:
        assert reasons == ["kernel-disabled", "kernel-disabled"]
        assert report == {"plain_w4a16": [], "xla_dequant": [
            {"spec": "bte,ef->btf", "w_shape": w_shape, "rows": "all",
             "fallback_reason": "kernel-disabled"}]}
    else:
        assert reasons == [None, "rows:prefill-m"]
        assert report == {
            "plain_w4a16": [{"spec": "bte,ef->btf", "w_shape": w_shape,
                             "rows": "<=64"}],
            "xla_dequant": [{"spec": "bte,ef->btf", "w_shape": w_shape,
                             "rows": ">64",
                             "fallback_reason": "rows:prefill-m"}]}


@pytest.mark.parametrize("disabled", [False, True])
def test_card_refuses_int4_leaves_the_kernels_decline(monkeypatch,
                                                      disabled):
    """The same plans on a card: a leaf K5/K6 decline (tiny-llama's q/k/v,
    groups of 16) or ROUNDTABLE_INT4_MM=0 fails construction there, with
    the reason, instead of serving decode through the dequant path; an
    unplanned leaf is refused."""
    if disabled:
        monkeypatch.setenv("ROUNDTABLE_INT4_MM", "0")
    tc = torch_config("tiny-llama")
    params = quant.quantize_params(
        common.init_params(tc, torch.Generator().manual_seed(0),
                           torch.float32, "cpu"), tc, act_dtype=torch.float32,
        bits=4)
    sites = common.int4_sites(params, tc)
    assert len(sites) == 2 * 7 + 1
    reason = ("kernel-disabled" if disabled
              else "pack:group 16 not a multiple of 32")
    hint = " \\(ROUNDTABLE_INT4_MM=0\\)" if disabled else ""
    with pytest.raises(ValueError, match=f"cuda: {reason}{hint}"):
        int4mm.route_report(sites, torch.device("cuda"))
    # The CPU serves those leaves through the dequant path, with the reason.
    eng = InferenceEngine(tc, num_slots=2, dtype=torch.float32,
                          kv_layout="paged", page_size=32, quant="int4",
                          params=params, device="cpu")
    reasons = {e["fallback_reason"]
               for e in eng.describe()["int4_paths"]["xla_dequant"]}
    assert reason in reasons
    bare = dataclasses.replace(sites[0][1], plan=None)
    with pytest.raises(ValueError, match="planned"):
        int4mm.einsum_int4_or_reason(sites[0][0], torch.ones(1, 1, 64), bare)


# --- engines on bridged quantized weights ---

MAX_SEQ = 256
BASE = "the knights debate the session store design at length. "
ROUND1 = [("lancelot", BASE + "Lancelot, your view?"),
          ("gawain", BASE + "Gawain, your view?")]
ROUND2 = [(n, p + " Round two: answer the objection.") for n, p in ROUND1]


def _two_rounds(eng):
    outs = [eng.generate_batch(ROUND1, max_new_tokens=8),
            eng.generate_batch(ROUND2, max_new_tokens=8)]
    records = {n: list(eng.kv._slots[n].tokens) for n, _ in ROUND1}
    return outs, records, eng.last_stats.reused_tokens


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_engine_matches_jax(monkeypatch, mode, layout):
    """A 2-knight round and its delta round from int8 or int4 weights:
    greedy tokens, slot records, reused tokens and the describe() keys
    equal the JAX engine's (ROUNDTABLE_INT4_MM=1, so the JAX seam takes
    its kernels' plan); the port's int4 routing is its plan's."""
    monkeypatch.setenv("ROUNDTABLE_INT4_MM", "1")
    kw = dict(kv_layout=layout, quant=mode)
    if layout == "paged":
        kw.update(page_size=32, ragged_attn=False)
    jeng = JaxEngine(jax_config("tiny-llama", max_seq_len=MAX_SEQ),
                     mesh_shape={"data": 1, "model": 1}, num_slots=4,
                     dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0, max_new_tokens=8),
                     **OFF, **kw)
    cfg = torch_config("tiny-llama", max_seq_len=MAX_SEQ)
    params = params_from_numpy(jax.device_get(jeng.params), cfg,
                               torch.float32, "cpu")
    teng = InferenceEngine(
        cfg, num_slots=4, dtype=torch.float32,
        sampling=SamplingParams(temperature=0.0, max_new_tokens=8),
        params=params, device="cpu", **OFF, **kw)
    assert _two_rounds(teng) == _two_rounds(jeng)
    dj, dt = jeng.describe(), teng.describe()
    for key in ("quant", "params", "num_pages", "kv_hbm_bytes",
                "kv_quant"):
        if key in dj:
            assert dt[key] == dj[key], key
    if mode == "int4":
        # The port routes by the card's plan (JAX's TPU plan declines
        # every tiny product): q/k/v's groups of 16 take the dequant path,
        # the other decode products the plain K5/K6, prefill the dequant
        # path - with the same greedy tokens as above.
        tp = dt["int4_paths"]
        assert tp == int4mm.route_report(common.int4_sites(teng.params, cfg),
                                         "cpu")
        assert sorted(e["spec"] for e in tp["plain_w4a16"]) == [
            "bte,ef->btf", "bte,ve->btv", "btf,fe->bte", "bthd,hde->bte"]
        assert {e["fallback_reason"] for e in tp["xla_dequant"]} == {
            "rows:prefill-m", "pack:group 16 not a multiple of 32"}
        assert teng.last_stats.int4_paths == tp
        assert teng.describe()["kernel_launches"]["mm_pack_out"] == 0
    else:
        assert "int4_paths" not in dt and teng.last_stats.int4_paths is None
    with pytest.raises(ValueError, match="quantized but quant"):
        InferenceEngine(cfg, num_slots=4, dtype=torch.float32,
                        params=params, device="cpu",
                        quant="int8" if mode == "int4" else "int4")


def test_adapter_builds_a_quantized_engine():
    """TorchLlmAdapter.from_config passes quant/kv_quant through: the
    shipped knights' {"quant": ..., "kv_layout": "paged", "kv_quant": ...}
    on the CPU, int4 weights and int8 pages."""
    config = {"model": "tiny-llama", "max_seq_len": 256,
              "kv_layout": "paged", "page_size": 32, "quant": "int4",
              "kv_quant": "int8", "num_slots": 4,
              "sampling": {"temperature": 0.0, "max_new_tokens": 6}}
    ad = TorchLlmAdapter.from_config("torch-llm", config, device="cpu")
    out = ad.execute_round([KnightTurn("a", "hi there"),
                            KnightTurn("b", "hi there, knights")])
    assert len(out) == 2 and ad.last_degradation is None
    d = ad._get_engine().describe()
    assert d["quant"] == "int4" and d["kv_quant"]["dtype"] == "int8"
    assert d["kv_quant"]["dispatches"]["decode:kernel_dequant"] >= 1
    assert d["int4_paths"]["xla_dequant"]
    from theroundtaible_tpu_torch.engine import reset_engines
    reset_engines()


@pytest.mark.parametrize("extra,item", [
    ({"quant": "int4", "mesh": {"data": 2, "model": 1},
      "kv_layout": "contiguous"}, "initialized torch.distributed"),
    ({"quant": "int8", "model": "tiny-mixtral"}, None),
], ids=["int4-sharded", "quantized-moe"])
def test_out_of_scope_quant_options_still_raise(extra, item):
    """Quantization is ported on one device, on a model axis and on a
    data axis over either layout (tests/test_torch_data_axis.py,
    tests/test_torch_data_contiguous.py): on the contiguous layout's data
    axis, which refused naming its ROADMAP item until Queue 1 slice 2a
    was ported, a mesh without a process group now raises RuntimeError
    (quantized weights under LoRA personas serve:
    tests/test_torch_lora.py; on a model axis:
    tests/test_torch_tp_quant.py; with the prefix cache and the offload
    tier: test_quantized_paged_engine_serves_with). Quantized MoE experts
    raised until item 7e-i was ported: now they build and serve
    (tests/test_torch_moe.py holds them against the JAX engine)."""
    config = {"model": "tiny-llama", "max_seq_len": 128, **extra}
    if item is None:
        eng = InferenceEngine.from_config(config, device="cpu")
        assert eng.describe()["quant"] == "int8"
        assert eng.generate_batch([("a", "the round table")],
                                  max_new_tokens=2)
        return
    with pytest.raises(RuntimeError, match=item):
        InferenceEngine.from_config(config, device="cpu")


@pytest.mark.parametrize("extra", [
    {"kv_quant": "int8", "quant": "int8", "prefix_cache": True},
    {"kv_quant": "int4", "quant": "int4", "kv_offload": True},
], ids=["quantized-prefix-cache", "quantized-offload"])
def test_quantized_paged_engine_serves_with(extra):
    """A quantized paged engine builds and serves with the prefix cache
    (a second session attaches the first one's int8 pages and their
    scales) and with the offload tier (a spilled session's int4 pages and
    scales come back bit for bit and its next turn reuses them), with the
    greedy tokens of the same engine without either."""
    config = {"model": "tiny-llama", "max_seq_len": 256,
              "kv_layout": "paged", "page_size": 32, "dtype": "float32",
              "sampling": {"temperature": 0.0, "max_new_tokens": 8},
              "spec_decode": False, **extra}
    off = dict(config, prefix_cache=False, kv_offload=False)
    eng = InferenceEngine.from_config(config, device="cpu")
    ref = InferenceEngine.from_config(off, device="cpu")
    prompt = "The knights weigh the session store design at length. " * 3
    for sid in ("qa", "qb"):
        assert eng.generate(prompt + sid, session=sid, slot_name="kay") == \
            ref.generate(prompt + sid, session=sid, slot_name="kay")
    if "prefix_cache" in extra:
        assert eng.describe()["prefix_cache"]["hits"] >= 1
        assert eng.last_stats.prefix_reused_tokens > 0
        return
    from theroundtaible_tpu_torch.engine.kvcache import scoped_slot
    name = scoped_slot("qa", "kay")
    pages = list(eng.kv._slots[name].pages)
    before = [(k[pages].clone(), v[pages].clone())
              for k, v in eng.kv.combined_pools()]
    assert eng.kv_offload.spill_session("qa") == 1
    assert eng.kv_offload.restore_session("qa") == 1
    pages = list(eng.kv._slots[name].pages)
    for (kb, vb), (k, v) in zip(before, eng.kv.combined_pools()):
        assert torch.equal(kb, k[pages]) and torch.equal(vb, v[pages])
    assert eng.describe()["kv_offload"]["restores"] == 1
