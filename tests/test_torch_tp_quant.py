"""PyTorch port, quantized weights and LoRA personas under tensor
parallelism: K10e (kernels/int4mm.einsum_int4_spmd) and K10f
(kernels/lora.lora_bgmv_spmd) against the JAX package's SPMD wrappers,
their decline reasons, quantize_params' shard-aligned int4 groups, the
whole-leaf scales of a TP-quantized tree, and TP engines with int8, int4
and LoRA personas on a {"data": 1, "model": 2} mesh against the JAX TP
engines on bridged weights.

The JAX side runs in this process on the virtual 8-CPU mesh (its kernels
in interpret mode, ROUNDTABLE_INT4_MM=1 / ROUNDTABLE_LORA_MM=1, as
tests/test_int4mm.py and tests/test_lora.py run them). The wrappers hold
no collective (a row-parallel product returns this rank's partial sum,
which the forward all-reduces once), so each rank's call runs here on a
sharding.Mesh of its coordinates and the ranks' outputs are put back
together - concatenated, or summed for a row product. The engines need a
process group: two gloo ranks are spawned once for the module. This
module imports only torch and numpy at its top, so the spawned ranks never
import jax.

Tolerances: f32 on both sides, so only summation orders differ - K10e
within 3e-5 (tests/test_int4mm.py's), K10f within 1e-4 (tests/test_lora.py's),
logits within 1e-4 (tests/test_torch_tp.py's), greedy tokens identical."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from theroundtaible_tpu_torch.engine import distributed, quant, sharding
from theroundtaible_tpu_torch.engine.kernels import int4mm
from theroundtaible_tpu_torch.engine.kernels import lora as klora
from theroundtaible_tpu_torch.engine.models import common
from theroundtaible_tpu_torch.engine.models.common import Int4Leaf
from theroundtaible_tpu_torch.engine.sharding import Mesh, param_specs

INT4_TOL = dict(atol=3e-5, rtol=3e-5)
LORA_TOL = dict(atol=1e-4, rtol=1e-4)
LOGIT_ATOL = 1e-4
SPAWN_TIMEOUT_S = 300.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mesh(model):
    import jax
    return jax.sharding.Mesh(np.array(jax.devices()[:model]).reshape(
        1, model), ("data", "model"))


def _part(x, axis, model, i):
    n = x.shape[axis] // model
    return np.take(x, np.arange(i * n, (i + 1) * n), axis=axis)


# --- K10e: einsum_int4_spmd ---

# tests/test_int4mm.py's SPMD_CASES, each with the weight axis the model
# axis shards (sharding.param_specs), the activation axis a row product
# contracts over it, and the output axis a column product splits.
SPMD_CASES = {
    "gate_up": ("bte,ef->btf", "col", (2, 3, 256), (256, 1024), 1, None, 2),
    "down": ("btf,fe->bte", "row", (2, 3, 1024), (1024, 256), 0, 2, None),
    "qkv": ("bte,ehd->bthd", "col", (1, 3, 256), (256, 8, 128), 1, None, 2),
    "o": ("bthd,hde->bte", "row", (1, 3, 8, 128), (8, 128, 256), 0, 2,
          None),
    "head": ("bte,ve->btv", "col", (2, 1, 256), (512, 256), 0, None, 2),
}


def _jax_int4(wshape, group, shards, seed):
    """The JAX package's shard-aligned int4 leaf of a seeded weight, as
    (leaf, q4, s4)."""
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.quant import _quantize_leaf_int4
    w = jax.random.normal(jax.random.PRNGKey(seed), wshape,
                          dtype=jnp.float32) * 0.1
    leaf = _quantize_leaf_int4(w, (0,), jnp.float32, False, group, shards)
    return leaf, np.asarray(leaf.q4), np.asarray(leaf.s4)


def _k10e_case(name, model, group=64):
    """(JAX einsum_int4_spmd's output, the port's ranks put together, the
    port's reasons) for one case on a 1 x model mesh."""
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.pallas import int4mm as jint4mm
    spec, tp, ashape, wshape, w_ax, a_ax, out_ax = SPMD_CASES[name]
    leaf, q4, s4 = _jax_int4(wshape, group, model, 0)
    a = np.asarray(jax.random.normal(jax.random.PRNGKey(1), ashape,
                                     dtype=jnp.float32))
    ref, reason = jint4mm.einsum_int4_spmd(_jax_mesh(model), spec,
                                           jnp.asarray(a), leaf, tp=tp)
    assert reason is None, reason
    sharded = q4.shape[w_ax] % model == 0 and s4.shape[w_ax] % model == 0
    parts, reasons = [], []
    for r in range(model):
        mesh = Mesh(1, model, r)
        q4_l, s4_l, a_l = q4, s4, a
        if sharded:
            q4_l, s4_l = _part(q4, w_ax, model, r), _part(s4, w_ax, model, r)
            if a_ax is not None:
                a_l = _part(a, a_ax, model, r)
        local = sharding.plan_int4_shard(
            spec, Int4Leaf(q4=torch.from_numpy(q4_l.copy()),
                           s4=torch.from_numpy(s4_l.copy()), axis=leaf.axis,
                           group=leaf.group), mesh, wshape, tp)
        a_t = torch.from_numpy(a_l.copy())
        y, why = int4mm.einsum_int4_spmd_ref(mesh, spec, a_t, local,
                                             w_shape=wshape, tp=tp)
        reasons.append(why)
        if y is None:
            # the seam's route for a declined shard: the dequantized
            # local weight
            y = common._int4_matmul(spec, a_t, local, mesh)
        parts.append(y.numpy())
    if not sharded:
        for p in parts[1:]:
            np.testing.assert_array_equal(p, parts[0])
        ours = parts[0]
    elif out_ax is not None:
        ours = np.concatenate(parts, axis=out_ax)
    else:
        ours = np.sum(parts, axis=0)
    return np.asarray(ref), ours, reasons


@pytest.fixture(autouse=True)
def _jax_kernels_on(monkeypatch):
    monkeypatch.setenv("ROUNDTABLE_INT4_MM", "1")
    monkeypatch.setenv("ROUNDTABLE_LORA_MM", "1")


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name", sorted(SPMD_CASES))
def test_k10e_plain_matches_jax(name, model):
    """Every projection's K10e plain version on each rank's shard (column
    products' slices put together, row products' partial sums added)
    against JAX's einsum_int4_spmd on the same global weight and input."""
    ref, ours, reasons = _k10e_case(name, model)
    assert reasons == [None] * model
    np.testing.assert_allclose(ours, ref, **INT4_TOL)


def test_k10e_uneven_axis_replicates():
    """8 heads over a 3-way axis do not divide: the leaf is whole on every
    rank (as JAX's placement) and each rank computes the whole product."""
    ref, ours, reasons = _k10e_case("qkv", 3)
    assert reasons == [None] * 3
    np.testing.assert_allclose(ours, ref, **INT4_TOL)


@pytest.mark.parametrize("group", [64, 32, 16])
def test_k10e_groups(group):
    """Groups of 64/32/16 on the sharded pack axis (gate/up): equal to
    JAX's. Groups of 16 are below the CUDA kernel's 16-byte loads: the
    shard declines with the card's reason and "/sharded", and the seam's
    dequant route gives JAX's numbers."""
    ref, ours, reasons = _k10e_case("gate_up", 2, group)
    want = (None if group > 16
            else "pack:group 16 not a multiple of 32/sharded")
    assert reasons == [want, want]
    np.testing.assert_allclose(ours, ref, **INT4_TOL)


def _decline_cases():
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.models.common import Int4Leaf as JLeaf
    gate, gq4, gs4 = _jax_int4((256, 1024), 64, 2, 2)
    head, hq4, hs4 = _jax_int4((512, 256), 64, 2, 3)
    qkv, qq4, qs4 = _jax_int4((256, 8, 128), 64, 3, 4)
    moe, mq4, ms4 = _jax_int4((2, 256, 512), 64, 1, 5)
    odd = JLeaf(q4=jnp.zeros((256, 258), jnp.int8),
                s4=jnp.ones((256, 172), jnp.float32), axis=1, group=3)
    minor = JLeaf(q4=gate.q4, s4=gate.s4, axis=0, group=64)

    def a(shape):
        return np.asarray(jax.random.normal(jax.random.PRNGKey(9), shape))

    # name: (spec, tp, model, activation, JAX leaf, whole dense shape,
    #        the rank-0 shard's (q4, s4) as numpy)
    return {
        "prefill_sharded": ("bte,ef->btf", "col", 2, a((2, 64, 256)), gate,
                            (256, 1024), (gq4[:, :256], gs4[:, :8])),
        "head_prefill_sharded": ("bte,ve->btv", "col", 2, a((2, 40, 256)),
                                 head, (512, 256), (hq4[:256], hs4[:256])),
        "prefill_replicated": ("bte,ehd->bthd", "col", 3, a((1, 80, 256)),
                               qkv, (256, 8, 128), (qq4, qs4)),
        "moe_spec": ("bte,xef->btxf", None, 2, a((1, 3, 256)), moe,
                     (2, 256, 512), (mq4, ms4)),
        "odd_group": ("bte,ef->btf", "col", 2, a((1, 3, 256)), odd,
                      (256, 516), (np.zeros((256, 258), np.int8),
                                   np.ones((256, 172), np.float32))),
        "non_minor_axis": ("bte,ef->btf", "col", 2, a((1, 3, 256)), minor,
                           (256, 1024), (gq4, gs4)),
    }


def test_k10e_decline_reasons_match_jax():
    """Where JAX's einsum_int4_spmd declines with a spec:, pack: or rows:
    reason the port's gives the same string: "/sharded" after the rows
    reason of a sharded leaf, none on a replicated one or where the spec
    or pack layout rules the kernels out before any sharding."""
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.pallas import int4mm as jint4mm
    for name, (spec, tp, model, a, jleaf, w_shape, (q4, s4)) in \
            _decline_cases().items():
        _, want = jint4mm.einsum_int4_spmd(_jax_mesh(model), spec,
                                           jnp.asarray(a), jleaf, tp=tp)
        leaf = sharding.plan_int4_shard(
            spec, Int4Leaf(q4=torch.from_numpy(np.array(q4)),
                           s4=torch.from_numpy(np.array(s4)),
                           axis=jleaf.axis, group=jleaf.group),
            Mesh(1, model, 0), w_shape, tp)
        y, got = int4mm.einsum_int4_spmd_ref(
            Mesh(1, model, 0), spec, torch.from_numpy(a.copy()), leaf,
            w_shape=w_shape, tp=tp)
        assert y is None and got == want, (name, got, want)


def test_k10e_checks_its_shard_and_counts_nothing_on_the_cpu():
    """A whole leaf planned where the mesh splits it raises; a leaf not
    planned for the mesh, or planned for another, raises at the call; the
    CPU runs the plain versions and counts no launch."""
    spec, tp, ashape, wshape, *_ = SPMD_CASES["gate_up"]
    _, q4, s4 = _jax_int4(wshape, 64, 2, 0)
    whole = Int4Leaf(q4=torch.from_numpy(q4.copy()),
                     s4=torch.from_numpy(s4.copy()), axis=1, group=64)
    a = torch.ones(ashape)
    with pytest.raises(ValueError, match="not this rank's shard"):
        sharding.plan_int4_shard(spec, whole, Mesh(1, 2, 0), wshape, tp)
    int4mm.reset_launch_counts()
    half = Int4Leaf(q4=whole.q4[:, :256].contiguous(),
                    s4=whole.s4[:, :8].contiguous(), axis=1, group=64)
    quarter = Int4Leaf(q4=whole.q4[:, :128].contiguous(),
                       s4=whole.s4[:, :4].contiguous(), axis=1, group=64)
    for other in (half, int4mm.plan_leaf(spec, half),
                  sharding.plan_int4_shard(spec, quarter, Mesh(1, 4, 1),
                                           wshape, tp)):
        with pytest.raises(ValueError, match="not planned as a shard"):
            int4mm.einsum_int4_spmd(Mesh(1, 2, 1), spec, a, other,
                                    w_shape=wshape, tp=tp)
    half = sharding.plan_int4_shard(spec, half, Mesh(1, 2, 1), wshape, tp)
    y, _ = int4mm.einsum_int4_spmd(Mesh(1, 2, 1), spec, a, half,
                                   w_shape=wshape, tp=tp)
    assert y is not None and y.shape == (2, 3, 512)
    assert not any(int4mm.launch_counts().values())


def test_int4_shard_axis_matches_jax():
    """int4_shard_axis and lora_shard_axis give the JAX package's
    answers."""
    from theroundtaible_tpu.engine import sharding as jsharding
    from theroundtaible_tpu_torch.engine import sharding
    for tp in ("col", "row", None):
        for mode, n_cont, ndim in (("out", 1, 2), ("out", 2, 3),
                                   ("contract", 1, 2)):
            assert sharding.int4_shard_axis(tp, ndim, n_cont, mode) == \
                jsharding.int4_shard_axis(tp, ndim, n_cont, mode)
        assert sharding.lora_shard_axis(tp) == jsharding.lora_shard_axis(tp)


# --- K10f: lora_bgmv_spmd ---


def _lora_inputs(m=8, c=512, r=8, o=512, s=3, seed=2):
    """tests/test_lora.py's spmd case."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, c)).astype(np.float32),
            rng.normal(size=(s, r, c)).astype(np.float32),
            rng.normal(size=(s, r, o)).astype(np.float32),
            np.resize(np.array([0, 2, 1, 1, 0, 2, 1, 0], np.int32), m))


def _k10f_ranks(tp, model, x2, a_t, b_s, ids):
    """The port's K10f plain version on each rank's shard, put together:
    (output, reasons)."""
    m, c = x2.shape
    o = b_s.shape[2]
    # JAX's rule: the flat dim of the sharded axis must divide
    which = {"col": "out", "row": "in"}[tp]
    units = o if which == "out" else c
    if units % model:
        which = None
    parts, reasons = [], []
    for r in range(model):
        x_l, a_l, b_l = x2, a_t, b_s
        if which == "in":
            x_l, a_l = _part(x2, 1, model, r), _part(a_t, 2, model, r)
        elif which == "out":
            b_l = _part(b_s, 2, model, r)
        t = [torch.from_numpy(np.ascontiguousarray(v))
             for v in (x_l, a_l, b_l, ids)]
        y, why = klora.lora_bgmv_spmd_ref(Mesh(1, model, r), *t, dims=(c, o),
                                          tp=tp, units=units)
        reasons.append(why)
        parts.append(None if y is None else y.numpy())
    if parts[0] is None:
        return None, reasons
    if which == "out":
        return np.concatenate(parts, axis=1), reasons
    return (np.sum(parts, axis=0) if which == "in" else parts[0]), reasons


def _jax_k10f(tp, model, x2, a_t, b_s, ids):
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.pallas import lora as jplora
    y, reason = jplora.lora_bgmv_spmd(
        _jax_mesh(model), jnp.asarray(x2), jnp.asarray(a_t),
        jnp.asarray(b_s), jnp.asarray(ids), tp=tp)
    return (None if y is None else np.asarray(y)), reason


@pytest.mark.parametrize("model", [2, 4, 3])
@pytest.mark.parametrize("tp", ["col", "row"])
def test_k10f_plain_matches_jax(tp, model):
    """K10f's plain version on each rank's shard (column slices put
    together, row partials added) against JAX's lora_bgmv_spmd; on a
    3-way axis 512 does not divide and every rank holds the whole
    stacks."""
    inputs = _lora_inputs()
    ref, reason = _jax_k10f(tp, model, *inputs)
    assert reason is None, reason
    ours, reasons = _k10f_ranks(tp, model, *inputs)
    assert reasons == [None] * model
    np.testing.assert_allclose(ours, ref, **LORA_TOL)


@pytest.mark.parametrize("case", ["rows_sharded", "rank_sharded",
                                  "rows_replicated"])
def test_k10f_decline_reasons_match_jax(case):
    """The plan's reasons on per-shard dims, "/sharded" on a sharded
    target, as JAX's lora_bgmv_spmd gives them."""
    tp, model, kw = {"rows_sharded": ("col", 2, dict(m=80)),
                     "rank_sharded": ("row", 2, dict(r=600, m=2)),
                     "rows_replicated": ("col", 3, dict(m=80))}[case]
    inputs = _lora_inputs(**kw)
    _, want = _jax_k10f(tp, model, *inputs)
    ours, reasons = _k10f_ranks(tp, model, *inputs)
    assert ours is None and reasons == [want] * model, (reasons, want)


def test_k10f_checks_its_shard():
    x2, a_t, b_s, ids = (torch.from_numpy(v) for v in _lora_inputs())
    with pytest.raises(ValueError, match="not this rank's shard"):
        klora.lora_bgmv_spmd(Mesh(1, 2, 0), x2, a_t, b_s, ids,
                             dims=(512, 512), tp="col", units=512)


def test_lora_stacks_follow_their_base_weights():
    """A store on a mesh splits each target's stacks exactly where its
    base weight is split: B on the output for q/k/v and gate/up, A on the
    contraction for o/down; with one kv head the k/v stacks stay whole
    (JAX would split their B on D), with 3 heads q/o stay whole."""
    from theroundtaible_tpu_torch.engine.lora import LoraStore
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    cfg = get_model_config("tiny-llama")
    mqa = dataclasses.replace(cfg, num_kv_heads=1)
    heads3 = dataclasses.replace(cfg, num_heads=3, num_kv_heads=3)
    got = {name: LoraStore(c, rank=4, device="cpu",
                           mesh=Mesh(1, 2, 1)).shards
           for name, c in (("llama", cfg), ("mqa", mqa), ("h3", heads3))}
    assert got["llama"] == {
        "q_proj": ("out", 64, 32), "k_proj": ("out", 64, 16),
        "v_proj": ("out", 64, 16), "o_proj": ("in", 32, 64),
        "gate_proj": ("out", 64, 64), "up_proj": ("out", 64, 64),
        "down_proj": ("in", 64, 64)}
    assert got["mqa"]["k_proj"] == (None, 64, 16)
    assert got["mqa"]["q_proj"] == ("out", 64, 32)
    assert got["h3"]["q_proj"] == (None, 64, 48)
    assert got["h3"]["o_proj"] == (None, 48, 64)


# --- quantization: shard-aligned groups and whole-leaf scales ---


@pytest.mark.parametrize("dim,group,shards", [
    (512, 64, 1), (512, 64, 4), (768, 64, 4), (768, 40, 4), (8, 64, 4),
    (128, 64, 4), (96, 64, 4), (7, 64, 1)])
def test_int4_group_for_matches_jax(dim, group, shards):
    from theroundtaible_tpu.engine.quant import _int4_group_for
    assert quant._int4_group_for(dim, group, shards) == \
        _int4_group_for(dim, group, shards)


@pytest.mark.parametrize("group,shards", [(64, 4), (16, 2), (48, 2)])
def test_quantize_params_model_shards_bit_identical(group, shards):
    """quantize_params(model_shards=) of the bridged tiny-llama tree equals
    the JAX package's leaf for leaf, bit for bit: gate/up's groups align to
    the per-shard hidden."""
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine import quant as jquant
    from theroundtaible_tpu.engine.models import common as jcommon
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    jc = jax_config("tiny-llama")
    tree = jax.device_get(jcommon.init_params(jc, jax.random.PRNGKey(0),
                                              jnp.float32))
    theirs = jax.device_get(jquant.quantize_params(
        tree, jc, act_dtype=jnp.float32, bits=4, group=group,
        model_shards=shards))
    cfg = get_model_config("tiny-llama")
    ours = quant.quantize_params(params_from_numpy(tree, cfg, torch.float32),
                                 cfg, act_dtype=torch.float32, bits=4,
                                 group=group, model_shards=shards)
    for a, b in zip(ours["layers"], theirs["layers"]):
        for name, leaf in a.items():
            want = b[name]
            if isinstance(leaf, Int4Leaf):
                assert leaf.group == want.group, name
                np.testing.assert_array_equal(leaf.q4.numpy(), want.q4)
                np.testing.assert_array_equal(leaf.s4.numpy(), want.s4)
            elif isinstance(leaf, dict):
                np.testing.assert_array_equal(leaf["q"].numpy(), want["q"])
                np.testing.assert_array_equal(leaf["s"].numpy(), want["s"])
    gate = ours["layers"][0]["gate_proj"]
    assert (cfg.mlp_dim // shards) % gate.group == 0


def test_quantized_specs_match_jax():
    """quantized_specs of int8 and int4 trees: the JAX package's spec tree
    (PartitionSpecs as tuples; an Int4Leaf's q4/s4 specs)."""
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine import quant as jquant
    from theroundtaible_tpu.engine import sharding as jsharding
    from theroundtaible_tpu.engine.models import common as jcommon
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    jc, cfg = jax_config("tiny-llama"), get_model_config("tiny-llama")
    tree = jax.device_get(jcommon.init_params(jc, jax.random.PRNGKey(0),
                                              jnp.float32))
    for bits in (8, 4):
        jq = jquant.quantize_params(tree, jc, act_dtype=jnp.float32,
                                    bits=bits, model_shards=2)
        theirs = jquant.quantized_specs(jsharding.param_specs(jc), jq)
        tq = quant.quantize_params(params_from_numpy(tree, cfg,
                                                     torch.float32), cfg,
                                   act_dtype=torch.float32, bits=bits,
                                   model_shards=2)
        ours = quant.quantized_specs(param_specs(cfg), tq)

        def same(a, b):
            if isinstance(a, Int4Leaf):
                assert (a.q4, a.s4) == (tuple(b.q4), tuple(b.s4))
            elif isinstance(a, dict):
                assert a == {k: tuple(v) for k, v in b.items()}
            else:
                assert a == tuple(b)

        for key in ("embedding", "lm_head"):
            same(ours[key], theirs[key])
        for a, b in zip(ours["layers"], theirs["layers"]):
            for name in a:
                same(a[name], b[name])


def _concat_check(whole, parts, spec, model):
    """Each leaf's shards put back along its sharded axis equal the whole
    leaf bit for bit (a replicated part equals the whole)."""
    from theroundtaible_tpu_torch.engine.sharding import _fallback_replicated
    if isinstance(whole, Int4Leaf):
        spec = spec.q4 if isinstance(spec, Int4Leaf) else spec
        for name in ("q4", "s4"):
            _concat_check(getattr(whole, name), [getattr(p, name)
                                                 for p in parts],
                          spec, model)
        return
    if isinstance(whole, dict):
        for name in ("q", "s"):
            _concat_check(whole[name], [p[name] for p in parts], spec[name],
                          model)
        return
    fixed = _fallback_replicated(spec, tuple(whole.shape), Mesh(1, model, 0))
    axis = next((i for i, a in enumerate(fixed) if a == "model"), None)
    if axis is None:
        for p in parts:
            assert torch.equal(p, whole)
    else:
        assert torch.equal(torch.cat(parts, axis), whole)


@pytest.mark.parametrize("bits,model", [(8, 2), (4, 2), (8, 4), (4, 4)])
def test_tp_quantized_tree_concatenates_to_the_single_device_tree(bits,
                                                                  model):
    """init_params(mesh=, quantize=) on every rank of a 1 x model mesh: the
    shards of each quantized leaf concatenate bit for bit to the
    single-device quantization of the same draws (every scale the whole
    leaf's: o_proj's and down_proj's int8 s[E] whole on every rank), and
    each Int4Leaf shard is planned for the mesh with the whole weight's
    shape."""
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    cfg = get_model_config("tiny-llama")
    hook = functools.partial(quant.quantize_leaves, cfg=cfg,
                             act_dtype=torch.float32, bits=bits,
                             model_shards=model)
    whole = common.init_params(cfg, torch.Generator().manual_seed(4),
                               torch.float32, quantize=hook)
    ranks = [common.init_params(cfg, torch.Generator().manual_seed(4),
                                torch.float32, mesh=Mesh(1, model, r),
                                quantize=hook) for r in range(model)]
    specs = quant.quantized_specs(param_specs(cfg), whole)
    for key in ("embedding", "lm_head", "final_norm"):
        _concat_check(whole[key], [r[key] for r in ranks], specs[key],
                      model)
    for i, layer in enumerate(whole["layers"]):
        for name, leaf in layer.items():
            _concat_check(leaf, [r["layers"][i][name] for r in ranks],
                          specs["layers"][i][name], model)
    down = ranks[0]["layers"][0]["down_proj"]
    if bits == 4:
        assert down.plan.w_shape == (cfg.mlp_dim, cfg.embed_dim)
        assert down.plan.shard_axis == 0 and down.plan.psum
        assert down.plan.mesh_shape == (1, model)
    else:
        assert torch.equal(down["s"], whole["layers"][0]["down_proj"]["s"])


@pytest.mark.parametrize("bits", [8, 4])
def test_bridge_under_a_mesh_holds_one_whole_leaf(monkeypatch, bits):
    """params_from_numpy under a mesh bridges one leaf of a JAX-quantized
    tree at a time: every whole leaf is gone before the next is bridged,
    and no kept slice is a view of a whole leaf - the host holds one whole
    leaf at most, not the whole model."""
    import gc
    import weakref

    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine import quant as jquant
    from theroundtaible_tpu.engine.models import common as jcommon
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu_torch.engine import weights
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    jc, cfg = jax_config("tiny-llama"), get_model_config("tiny-llama")
    tree = jax.device_get(jquant.quantize_params(
        jcommon.init_params(jc, jax.random.PRNGKey(0), jnp.float32), jc,
        act_dtype=jnp.float32, bits=bits, model_shards=2))
    bridged, real = [], weights._leaf

    def payload(leaf):
        return (leaf.q4 if isinstance(leaf, Int4Leaf)
                else leaf["q"] if isinstance(leaf, dict) else leaf)

    def leaf(x, shape, name, dtype, device):
        gc.collect()
        assert all(ref() is None for ref in bridged), name
        out = real(x, shape, name, dtype, device)
        bridged.append(weakref.ref(payload(out)))
        return out

    monkeypatch.setattr(weights, "_leaf", leaf)
    part = weights.params_from_numpy(tree, cfg, torch.float32, "cpu",
                                     mesh=Mesh(1, 2, 1))
    n_leaves = 3 + sum(len(layer) for layer in part["layers"])
    assert len(bridged) == n_leaves
    for value in [part["embedding"], part["lm_head"],
                  *(v for layer in part["layers"] for v in layer.values())]:
        assert payload(value)._base is None


# --- TP engines against the JAX TP engines ---

MESH = {"data": 1, "model": 2}
MAX_SEQ = 256
RANK = 4
OFF = dict(prefix_cache=False, kv_offload=False, spec_decode=False)
BASE = "the knights debate the session store design at length. "
ROUND1 = [("lancelot", BASE + "Lancelot, your view?"),
          ("gawain", BASE + "Gawain, your view?"),
          ("percival", BASE + "Percival, be brief.")]
ROUND2 = [(n, p + " Round two: answer the objection.") for n, p in ROUND1]
ADAPTERS = [None, "galahad", "percival"]
# name: (model overrides, layout, engine options)
ENGINE_CASES = {
    "int8_paged": ({}, "paged", {"quant": "int8"}),
    "int8_contiguous": ({}, "contiguous", {"quant": "int8"}),
    "int4_paged": ({}, "paged", {"quant": "int4"}),
    "int4_contiguous": ({}, "contiguous", {"quant": "int4"}),
    "lora_paged": ({}, "paged", {"lora": {}}),
    "lora_contiguous": ({}, "contiguous", {"lora": {}}),
    "lora_int8_store": ({}, "paged", {"lora": {"quant": "int8"}}),
    # the placement cases: k/v stacks whole with MQA's one kv head, and
    # q/o stacks whole where 3 heads do not divide the axis
    "lora_mqa": ({"num_kv_heads": 1}, "paged", {"lora": {}}),
    "lora_heads3": ({"num_heads": 3, "num_kv_heads": 3}, "contiguous",
                    {"lora": {}}),
}


def _lora_block(personas, extra):
    return {"rank": RANK, "max_adapters": 3, "scale": 4.0,
            "adapters": dict(personas), **extra}


def _serve(eng, lora):
    """Two 3-knight rounds (a mixed-adapter batch under LoRA): texts,
    committed tokens and reused tokens."""
    ads = ADAPTERS if lora else None
    outs = [eng.generate_batch(ROUND1, max_new_tokens=8,
                               adapters_per_turn=ads),
            eng.generate_batch(ROUND2, max_new_tokens=8,
                               adapters_per_turn=ads)]
    return {"texts": outs, "reused": eng.last_stats.reused_tokens,
            "records": {n: list(eng.kv._slots[n].tokens)
                        for n, _ in ROUND1}}


def _forward_inputs(seed=5):
    rng = np.random.default_rng(seed)
    b, t = 3, 20
    return {"tokens": rng.integers(0, 512, (b, t)).astype(np.int32),
            "positions": np.broadcast_to(np.arange(t, dtype=np.int32),
                                         (b, t)).copy(),
            "valid": np.full((b,), t, np.int32)}


def _engine_rank(rank, cases):
    """One rank: per case a TP engine on its slices of the JAX engine's
    bridged (quantized) weights with the case's options, the two rounds,
    describe(), and the f32 forward logits under the mesh (with the
    mixed-adapter LoraBatch under LoRA); then the refusal of dense params
    with `quant` on a mesh."""
    torch.set_num_threads(1)
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.lora import LoraBatch
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.sampling import SamplingParams
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    results = {}
    coords = Mesh(1, 2, rank)
    fwd = {k: torch.from_numpy(v) for k, v in _forward_inputs().items()}
    base = get_model_config("tiny-llama", max_seq_len=MAX_SEQ)
    for name, (tree, overrides, layout, kw) in cases.items():
        cfg = dataclasses.replace(base, **overrides)
        eng = InferenceEngine(
            cfg, mesh_shape=dict(MESH), num_slots=5, kv_layout=layout,
            dtype=torch.float32,
            sampling=SamplingParams(temperature=0.0, max_new_tokens=8),
            params=params_from_numpy(tree, cfg, torch.float32, "cpu",
                                     mesh=coords),
            device="cpu", **OFF, **kw)
        out = _serve(eng, "lora" in kw)
        d = eng.describe()
        out["describe"] = {k: d.get(k) for k in ("quant", "params", "mesh",
                                                 "int4_paths")}
        out["lora"] = d["lora"]
        lora = None
        if eng.lora is not None:
            lora = LoraBatch(eng.lora, [0] + [eng.lora.slot_of(a)
                                              for a in ADAPTERS[1:]])
        out["logits"] = common.forward(
            eng.params, eng.cfg, fwd["tokens"].long(), fwd["positions"],
            None, None, fwd["valid"], lora=lora, mesh=eng.mesh)[0].numpy()
        results[name] = out
        del eng
    dense = params_from_numpy(cases["lora_paged"][0], base, torch.float32,
                              "cpu", mesh=coords)
    try:
        InferenceEngine(base, mesh_shape=dict(MESH), dtype=torch.float32,
                        params=dense, quant="int8", device="cpu", **OFF)
        results["dense_with_quant"] = "built"
    except ValueError as e:
        results["dense_with_quant"] = str(e)
    return results


@pytest.fixture(scope="module")
def personas(tmp_path_factory):
    """Persona npz files both packages load (numpy seeds, init_std 0.6 so a
    persona changes the greedy tokens), at the widths of every engine
    case (tiny-llama and its 1-kv-head and 3-head variants)."""
    from theroundtaible_tpu_torch.engine import lora
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    root = tmp_path_factory.mktemp("tp_personas")
    out = {}
    for i, name in enumerate(ADAPTERS[1:]):
        rng = np.random.default_rng(200 + i)
        tree = {}
        for variant in ({}, {"num_kv_heads": 1},
                        {"num_heads": 3, "num_kv_heads": 3}):
            cfg = dataclasses.replace(get_model_config("tiny-llama"),
                                      **variant)
            for k, (c, o, _tp) in lora.lora_dims(cfg).items():
                tree.setdefault((k, c, o), (
                    rng.normal(size=(RANK, c)).astype(np.float32) * c ** -0.5,
                    rng.normal(size=(RANK, o)).astype(np.float32) * 0.6))
        out[name] = tree
    return root, out


def _persona_paths(personas, cfg):
    """{adapter: {"path": npz}} of the pair trees at `cfg`'s widths."""
    from theroundtaible_tpu_torch.engine import lora
    root, trees = personas
    paths = {}
    for name, tree in trees.items():
        pairs = {k: tree[(k, c, o)]
                 for k, (c, o, _tp) in lora.lora_dims(cfg).items()}
        path = root / f"{name}-{cfg.num_heads}-{cfg.num_kv_heads}.npz"
        lora.save_pair_tree(str(path), pairs)
        paths[name] = {"path": str(path)}
    return paths


@pytest.fixture(scope="module")
def engine_runs(personas):
    """The JAX TP engines' results (in this process) and the two ranks'."""
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine import lora as jlora
    from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
    from theroundtaible_tpu.engine.models import common as jcommon
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu.engine.sampling import \
        SamplingParams as JaxSampling
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    jax_out, cases = {}, {}
    fwd = {k: jnp.asarray(v) for k, v in _forward_inputs().items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ROUNDTABLE_INT4_MM", "1")
        mp.setenv("ROUNDTABLE_LORA_MM", "1")
        for name, (overrides, layout, opts) in ENGINE_CASES.items():
            jcfg = dataclasses.replace(
                jax_config("tiny-llama", max_seq_len=MAX_SEQ), **overrides)
            kw = dict(opts)
            if "lora" in kw:
                paths = _persona_paths(personas, dataclasses.replace(
                    get_model_config("tiny-llama"), **overrides))
                kw["lora"] = _lora_block(paths, kw["lora"])
            if layout == "paged":
                kw.update(page_size=32, ragged_attn=False)
            jeng = JaxEngine(jcfg, mesh_shape=dict(MESH), num_slots=5,
                             kv_layout=layout, dtype=jnp.float32,
                             sampling=JaxSampling(temperature=0.0,
                                                  max_new_tokens=8),
                             **OFF, **kw)
            tree = jax.device_get(jeng.params)
            out = _serve(jeng, "lora" in opts)
            d = jeng.describe()
            out["describe"] = {k: d.get(k) for k in ("quant", "params",
                                                     "mesh", "int4_paths")}
            out["lora"] = d["lora"]
            payload = None
            if jeng.lora is not None:
                payload = (jeng.lora.stacked, jnp.asarray(
                    [0] + [jeng.lora.slot_of(a) for a in ADAPTERS[1:]],
                    jnp.int32))
            with jlora.lora_scope(payload, quant=d["lora"].get(
                    "store", {}).get("quant", "none")):
                out["logits"] = np.asarray(jcommon.forward(
                    tree, jcfg, fwd["tokens"], fwd["positions"], None, None,
                    fwd["valid"])[0])
            jax_out[name] = out
            cases[name] = (tree, overrides, layout, kw)
            del jeng
        ranks = distributed.launch(_engine_rank, 2, "gloo", "cpu",
                                   args=(cases,), timeout_s=SPAWN_TIMEOUT_S)
    return jax_out, ranks


def _check_int4_paths(ours, theirs):
    """int4_paths of the port's TP engine against JAX's: both None, or the
    same (spec, global w_shape) entries; a leaf the port's kernels take at
    decode rows goes to the dequant route at prefill rows with JAX's
    reason ("rows:prefill-m/sharded"; the head runs no prefill rows in
    JAX's engine); a leaf the port declines at every
    row count JAX declines at decode rows too; each leaf's decline carries
    "/sharded" on both sides alike. The reasons of a decode-row decline
    differ by design (the TPU's block rules, "blocks:...", against the
    card's 16-byte rules, "pack:group ..."), and here the TPU's rules
    decline every shard of the tiny model where the card's take all but
    the groups of 16 (test_tp_int4_paths_are_the_shards_plans)."""
    assert (ours is None) == (theirs is None)
    if ours is None:
        return

    def entries(paths):
        return [e for v in paths.values() for e in v]

    def key(e):
        return e["spec"], tuple(e["w_shape"])

    assert {key(e) for e in entries(ours)} == \
        {key(e) for e in entries(theirs)}
    jax_prefill = {key(e): e["fallback_reason"]
                   for e in theirs["xla_dequant"]
                   if e["fallback_reason"].startswith("rows:")}
    port_prefill = {key(e): e["fallback_reason"]
                    for e in ours["xla_dequant"] if e["rows"] == ">64"}
    shared = port_prefill.keys() & jax_prefill.keys()
    assert shared and all(port_prefill[k] == jax_prefill[k] for k in shared)
    jax_decode_kernel = {key(e) for e in entries(theirs)
                         if e["path"] != "xla_dequant"}
    assert not jax_decode_kernel & {key(e) for e in ours["xla_dequant"]
                                    if e["rows"] == "all"}

    def sharded(paths):
        return {key(e): e["fallback_reason"].endswith("/sharded")
                for e in paths["xla_dequant"]}

    mine = sharded(ours)
    assert all(mine.get(k, v) == v for k, v in sharded(theirs).items())


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_tp_engine_matches_jax_tp_engine(engine_runs, name):
    """Each quantized or LoRA engine on 2 gloo ranks against JAX's engine
    on the same 2-way model mesh and weights: the same greedy texts,
    committed tokens and reuse, the same describe() "quant", "params" and
    "mesh", and on int4 engines "int4_paths" as _check_int4_paths compares
    them; f32 logits of the forward under the mesh (with the personas'
    LoraBatch) within 1e-4 of JAX's on the whole tree; both ranks
    alike."""
    jax_out, ranks = engine_runs
    ref = jax_out[name]
    for r in ranks:
        got = r[name]
        for key in ("texts", "records", "reused"):
            assert got[key] == ref[key], (name, key)
        for key in ("quant", "params", "mesh"):
            assert got["describe"][key] == ref["describe"][key], (name, key)
        _check_int4_paths(got["describe"]["int4_paths"],
                          ref["describe"]["int4_paths"])
        np.testing.assert_allclose(got["logits"], ref["logits"],
                                   atol=LOGIT_ATOL, rtol=0)
    assert ranks[0][name]["records"] == ranks[1][name]["records"]
    np.testing.assert_array_equal(ranks[0][name]["logits"],
                                  ranks[1][name]["logits"])


@pytest.mark.parametrize("name", [n for n in sorted(ENGINE_CASES)
                                  if n.startswith("lora")])
def test_tp_lora_describe_matches_jax(engine_runs, name):
    """The lora block: JAX's state and counts; every decode dispatch of
    the seven targets on K7's plain version (K10f) and the prefill rows on
    the grouped einsums with "rows:prefill-m" (plus "/sharded" where a
    stack is split), or, for the int8 store, all on the grouped einsums
    with "quant:int8-stack"."""
    jax_out, ranks = engine_runs
    dj = jax_out[name]["lora"]
    for r in ranks:
        dt = r[name]["lora"]
        for key in ("enabled", "reason", "apply_tokens", "share_suppressed"):
            assert dt[key] == dj[key], key
        for key in ("resident", "loads", "evictions", "swaps", "quant",
                    "targets"):
            assert dt["store"][key] == dj["store"][key], key
        paths = dt["lora_paths"]
        reasons = {e["fallback_reason"] for e in paths["xla_grouped_bmm"]}
        if name == "lora_int8_store":
            assert not paths["plain_bgmv"]
            assert reasons == {"quant:int8-stack"}
        else:
            assert {e["leaf"] for e in paths["plain_bgmv"]} == set(
                dt["store"]["targets"])
            assert reasons <= {"rows:prefill-m", "rows:prefill-m/sharded"}


def test_tp_int4_paths_are_the_shards_plans(engine_runs):
    """int4_paths under the mesh: the whole weights' shapes (as the JAX
    engine records its global leaves), the sharded leaves' reasons with
    "/sharded"."""
    _, ranks = engine_runs
    paths = ranks[0]["int4_paged"]["describe"]["int4_paths"]
    shapes = {tuple(e["w_shape"]) for v in paths.values() for e in v}
    assert (128, 64) in shapes and (512, 64) in shapes
    reasons = {e["fallback_reason"] for e in paths["xla_dequant"]}
    assert reasons == {"rows:prefill-m/sharded",
                       "pack:group 16 not a multiple of 32/sharded"}
    assert paths == ranks[1]["int4_paged"]["describe"]["int4_paths"]


def test_dense_params_with_quant_on_a_mesh_raise(engine_runs):
    """A rank's dense slices cannot be quantized with the whole leaves'
    scales: quant with dense params on a mesh refuses."""
    _, ranks = engine_runs
    for r in ranks:
        assert "quantized whole" in r["dense_with_quant"]
