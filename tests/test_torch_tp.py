"""PyTorch port, tensor parallelism over torch.distributed ranks: the K10
attention wrappers (flash_attention_spmd, paged_decode_spmd,
paged_prefill_spmd, ragged_paged_spmd), the sharded weight bridge, the
engine on a {"data": 1, "model": 2} mesh, and what a mesh refuses.

The JAX side runs in this process on the virtual 8-CPU mesh (the SPMD
wrappers in interpret mode, as tests/test_pallas.py runs them; the TP
engine as tests/test_engine.py builds it). The port's side runs on ranks
spawned with engine/distributed.launch on gloo, each fed its own slices
of the same numpy inputs; their outputs are put back together here. This
module imports only torch and numpy at its top, so the spawned ranks
(which import it to find their functions) never import jax; the JAX
reference is imported inside the fixtures.

Tolerances: f32 on both sides, so only summation orders differ -
attention outputs within 2e-5 (as tests/test_torch_ragged.py), logits
within 1e-4 (as tests/test_torch_model.py), greedy tokens identical,
across packages and across ranks. Each group of ranks is spawned once per
module (a spawn costs seconds) and the cases read its results."""

import numpy as np
import pytest
import torch

from theroundtaible_tpu_torch.engine import distributed
from theroundtaible_tpu_torch.engine.sharding import (Mesh, local_config,
                                                      param_specs,
                                                      shard_params)

TOL = dict(atol=2e-5, rtol=2e-5)
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


def _launch(fn, world_size, *args):
    return distributed.launch(fn, world_size, "gloo", "cpu", args=args,
                              timeout_s=SPAWN_TIMEOUT_S)


# --- the K10 wrappers: inputs, rank side, reference side ---

H, KH, D, PS = 4, 2, 16, 16


def _rng_case(seed, b, t, h, kh, s, pool_pages=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, D)).astype(np.float32)
    n = pool_pages if pool_pages is not None else b
    k = rng.standard_normal((n, s, kh, D)).astype(np.float32)
    v = rng.standard_normal((n, s, kh, D)).astype(np.float32)
    return q, k, v


def flash_case(seed, b, t, h, kh, offsets, lengths, s=64):
    q, k, v = _rng_case(seed, b, t, h, kh, s)
    offsets = np.asarray(offsets, np.int32)
    return {"kind": "flash", "heads": (h, kh), "batch": b,
            "q": q, "k": k, "v": v, "offsets": offsets,
            "kv_valid": offsets + np.asarray(lengths, np.int32),
            "real": list(lengths) if t > 1 else None}


def paged_case(seed, kind, b, t, h, kh, offsets, lengths, pp=4,
               replicas=1, bits=0):
    """Rows of `b` over a pool of b*pp pages (+ a scratch page per
    replica), each row's pages from its own replica's range; int8 pages
    when `bits`."""
    per = 1 + (b // replicas) * pp
    pages = replicas * per
    q, k, v = _rng_case(seed, b, t, h, kh, PS, pool_pages=pages)
    rng = np.random.default_rng(seed + 100)
    table = np.zeros((b, pp), np.int32)
    rows_per = b // replicas
    for r in range(replicas):
        ids = r * per + 1 + rng.permutation(rows_per * pp)
        table[r * rows_per:(r + 1) * rows_per] = ids.reshape(rows_per, pp)
    offsets = np.asarray(offsets, np.int32)
    case = {"kind": kind, "heads": (h, kh), "batch": b, "q": q, "k": k,
            "v": v, "table": table, "offsets": offsets,
            "kv_valid": offsets + np.asarray(lengths, np.int32),
            "replicas": replicas, "bits": bits,
            "real": list(lengths) if t > 1 else None}
    if bits:
        from theroundtaible_tpu_torch.engine.kv_quant import (KVQuantSpec,
                                                              quantize_cells)
        spec = KVQuantSpec(bits=bits)
        for name in ("k", "v"):
            qx, sc = quantize_cells(torch.from_numpy(case[name]), spec)
            case[name], case[name + "_scale"] = qx.numpy(), sc.numpy()
    return case


def ragged_case(h=H, kh=KH):
    """tests/test_torch_ragged.py's mixed case: a 10-row chunk of sequence
    0 at offset 5, a decode row of sequence 1 at position 20, an inert
    block."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((12, PS, kh, D)).astype(np.float32)
    v = rng.standard_normal((12, PS, kh, D)).astype(np.float32)
    tables = np.zeros((3, 4), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :3] = [3, 4, 5]
    q = rng.standard_normal((32, h, D)).astype(np.float32)
    return {"kind": "ragged", "heads": (h, kh), "batch": 32, "q": q,
            "k": k, "v": v, "tables": tables,
            "seq_of_block": np.array([0, 0, 1, 2], np.int32),
            "block_qstart": np.array([0, 8, 0, 0], np.int32),
            "query_offsets": np.array([5, 20, 0], np.int32),
            "kv_valid": np.array([15, 21, 1], np.int32),
            "real_rows": list(range(0, 10)) + [16]}


def _axes(case, data, model):
    """(rows split over data, q heads split, kv heads split): the TPU
    wrappers' partitioning (_spmd_axes)."""
    h, kh = case["heads"]
    rows = data > 1 and case["kind"] != "ragged" \
        and case["batch"] % data == 0
    return rows, model > 1, model > 1 and kh % model == 0


def _local(case, data, model, rank):
    """This rank's slices of a case's global arrays."""
    d_i, m_i = rank // model, rank % model
    rows, heads, kv = _axes(case, data, model)
    h, kh = case["heads"]

    def part(n, parts, i):
        return slice(i * (n // parts), (i + 1) * (n // parts))

    rs = part(case["batch"], data, d_i) if rows else slice(None)
    hs = part(h, model, m_i) if heads else slice(None)
    ks = part(kh, model, m_i) if kv else slice(None)
    out = {k: v for k, v in case.items()}
    if case["kind"] == "ragged":
        out["q"] = case["q"][:, hs]
    else:
        out["q"] = case["q"][rs][:, :, hs]
        for name in ("offsets", "kv_valid", "table"):
            if name in case:
                out[name] = case[name][rs]
    pool_rows = slice(None)
    if case.get("replicas", 1) > 1:
        pool_rows = part(case["k"].shape[0], data, d_i)
    elif case["kind"] == "flash" and rows:
        pool_rows = rs
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in case:
            out[name] = case[name][pool_rows][:, :, ks]
    return out, rs, hs


def _run_wrapper(mesh, case):
    from theroundtaible_tpu_torch.engine.kernels import attention as kattn
    t = {k: (torch.from_numpy(np.ascontiguousarray(v))
             if isinstance(v, np.ndarray) else v) for k, v in case.items()}
    kw = dict(heads=case["heads"])
    if case["kind"] == "ragged":
        out = kattn.ragged_paged_spmd(
            mesh, t["q"], t["k"], t["v"], t["tables"], t["seq_of_block"],
            t["block_qstart"], t["query_offsets"], t["kv_valid"], **kw)
        return None if out is None else out.numpy()
    kw["batch"] = case["batch"]
    if case["kind"] == "flash":
        out = kattn.flash_attention_spmd(mesh, t["q"], t["k"], t["v"],
                                         t["offsets"], t["kv_valid"], **kw)
        return None if out is None else out.numpy()
    kw.update(pool_replicas=case["replicas"], k_scale=t.get("k_scale"),
              v_scale=t.get("v_scale"), kv_bits=case["bits"] or 8)
    if case["kind"] == "decode":
        out = kattn.paged_decode_spmd(mesh, t["q"], t["k"], t["v"],
                                      t["table"], t["kv_valid"], **kw)
    else:
        out = kattn.paged_prefill_spmd(mesh, t["q"], t["k"], t["v"],
                                       t["table"], t["offsets"],
                                       t["kv_valid"], **kw)
    return None if out is None else out.numpy()


def _wrapper_rank(rank, data, model, cases, forward_case=None):
    """One rank: every case's wrapper on this rank's slices; with
    `forward_case` (tree, inputs) also the dense tiny-llama forward on a
    1 x 4 model mesh over all four ranks, whose 2 kv heads do not divide
    the axis and stay whole on every rank (models/common.kv_head_index
    pairs each rank's q head with its kv head)."""
    torch.set_num_threads(1)
    mesh = Mesh(data, model, rank)
    out = {}
    for name, case in cases.items():
        local, _, _ = _local(case, data, model, rank)
        out[name] = _run_wrapper(mesh, local)
    if forward_case is not None:
        from theroundtaible_tpu_torch.engine.models import common
        from theroundtaible_tpu_torch.engine.models.registry import \
            get_model_config
        from theroundtaible_tpu_torch.engine.sharding import build_mesh
        from theroundtaible_tpu_torch.engine.weights import \
            params_from_numpy
        tree, fwd = forward_case
        cfg = get_model_config("tiny-llama")
        tp = build_mesh({"data": 1, "model": 4})
        params = params_from_numpy(tree, cfg, torch.float32, "cpu",
                                   mesh=tp)
        t = {k: torch.from_numpy(v) for k, v in fwd.items()}
        out["forward_model4"] = common.forward(
            params, cfg, t["tokens"].long(), t["positions"], None, None,
            t["valid"], mesh=tp)[0].numpy()
    return out


def _jax_wrapper(case, data, model):
    """The JAX package's SPMD wrapper on the virtual CPU mesh, interpret
    mode; None where it declines."""
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.pallas import attention as pattn
    from theroundtaible_tpu.engine.sharding import build_mesh
    mesh = build_mesh({"data": data, "model": model},
                      jax.devices()[:data * model])
    j = {k: jnp.asarray(v) for k, v in case.items()
         if isinstance(v, np.ndarray)}
    if case["kind"] == "ragged":
        out = pattn.ragged_paged_spmd(
            mesh, j["q"], j["k"], j["v"], j["tables"], j["seq_of_block"],
            j["block_qstart"], j["query_offsets"], j["kv_valid"],
            interpret=True)
    elif case["kind"] == "flash":
        out = pattn.flash_attention_spmd(mesh, j["q"], j["k"], j["v"],
                                         j["offsets"], j["kv_valid"],
                                         interpret=True)
    else:
        kw = dict(interpret=True, pool_replicas=case["replicas"],
                  k_scale=j.get("k_scale"), v_scale=j.get("v_scale"),
                  kv_bits=case["bits"] or 8)
        if case["kind"] == "decode":
            out = pattn.paged_decode_spmd(mesh, j["q"], j["k"], j["v"],
                                          j["table"], j["kv_valid"], **kw)
        else:
            out = pattn.paged_prefill_spmd(mesh, j["q"], j["k"], j["v"],
                                           j["table"], j["offsets"],
                                           j["kv_valid"], **kw)
    return None if out is None else np.asarray(out)


def _assemble(case, locals_, data, model):
    """The ranks' outputs put back at their rows and heads (a replicated
    block from the first rank that holds it)."""
    if any(x is None for x in locals_):
        assert all(x is None for x in locals_), "ranks disagree on None"
        return None
    full = np.full(case["q"].shape, np.nan, np.float32)
    for rank, x in enumerate(locals_):
        _, rs, hs = _local(case, data, model, rank)
        if case["kind"] == "ragged":
            full[:, hs] = x
        else:
            full[rs, :, hs] = x
    return full


def _compare(case, ours, ref):
    if case["kind"] == "ragged":
        rows = case["real_rows"]
        np.testing.assert_allclose(ours[rows], ref[rows], **TOL)
    elif case["real"] is not None:
        for b, n in enumerate(case["real"]):
            np.testing.assert_allclose(ours[b, :n], ref[b, :n], **TOL)
    else:
        np.testing.assert_allclose(ours, ref, **TOL)


def _int8(case):
    return dict(case, bits=8)


MODEL2_CASES = {
    "flash_prefill": flash_case(0, 3, 16, H, KH, [0, 10, 40], [16, 9, 16]),
    "flash_decode": flash_case(1, 3, 1, H, KH, [0, 31, 63], [1, 1, 1]),
    "flash_mqa": flash_case(2, 2, 8, 8, 1, [0, 20], [8, 5]),
    "paged_decode": paged_case(3, "decode", 3, 1, H, KH, [0, 20, 63],
                               [1, 1, 1]),
    "paged_prefill": paged_case(4, "prefill", 2, 16, H, KH, [0, 30],
                                [16, 12]),
    "paged_decode_int8": paged_case(5, "decode", 3, 1, H, KH, [5, 33, 60],
                                    [1, 1, 1], bits=8),
    "paged_prefill_int8": paged_case(6, "prefill", 2, 8, H, KH, [0, 17],
                                     [8, 6], bits=8),
    "paged_decode_mqa": paged_case(7, "decode", 2, 1, 8, 1, [7, 40],
                                   [1, 1]),
    "ragged": ragged_case(),
    # 6 q heads over 3 kv heads do not partition on a 2-way model axis
    # (the kv heads neither divide nor are MQA's one): None on both sides.
    "flash_indivisible": flash_case(8, 2, 8, 6, 3, [0, 8], [8, 8]),
    "paged_decode_indivisible": paged_case(9, "decode", 2, 1, 6, 3,
                                           [3, 9], [1, 1]),
    "ragged_indivisible": ragged_case(h=6, kh=3),
}

# data=2 x model=2: rows on "data" (flash), per-replica pools whose page
# axis shards over "data" (pool_replicas=2, tables rebased per replica),
# and the ragged wrapper declining the data axis.
MESH22_CASES = {
    "flash_rows_on_data": flash_case(10, 4, 8, H, KH, [0, 4, 20, 50],
                                     [8, 8, 3, 8]),
    "flash_decode_rows_on_data": flash_case(11, 4, 1, H, KH,
                                            [0, 9, 30, 63], [1, 1, 1, 1]),
    "paged_decode_replicas": paged_case(12, "decode", 4, 1, H, KH,
                                        [0, 15, 33, 62], [1, 1, 1, 1],
                                        replicas=2),
    "paged_prefill_replicas": paged_case(13, "prefill", 4, 8, H, KH,
                                         [0, 8, 20, 40], [8, 5, 8, 2],
                                         replicas=2),
    "paged_decode_replicas_int8": paged_case(14, "decode", 4, 1, H, KH,
                                             [2, 16, 31, 50], [1, 1, 1, 1],
                                             replicas=2, bits=8),
    "ragged_data_axis": ragged_case(),
}


def _wrapper_results(cases, data, model, forward_case=None):
    refs = {name: _jax_wrapper(case, data, model)
            for name, case in cases.items()}
    return refs, _launch(_wrapper_rank, data * model, data, model, cases,
                         forward_case)


@pytest.fixture(scope="module")
def model2_runs():
    return _wrapper_results(MODEL2_CASES, 1, 2)


@pytest.fixture(scope="module")
def mesh22_runs():
    """The 4-rank spawn, which also runs the 1 x 4 tiny-llama forward;
    its JAX reference is the whole-weight forward."""
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.models import common as jcommon
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    tree = _tree("tiny-llama")
    fwd = _forward_inputs(512)
    j = {k: jnp.asarray(v) for k, v in fwd.items()}
    ref = np.asarray(jcommon.forward(tree, jax_config("tiny-llama"),
                                     j["tokens"], j["positions"], None,
                                     None, j["valid"])[0])
    refs, ranks = _wrapper_results(MESH22_CASES, 2, 2, (tree, fwd))
    return dict(refs, forward_model4=ref), ranks


@pytest.mark.parametrize("name", sorted(MODEL2_CASES))
def test_spmd_wrappers_match_jax_on_model2(model2_runs, name):
    """Each K10 wrapper on 2 gloo ranks (data 1, model 2), the ranks'
    head slices put together, against the JAX wrapper on the same global
    inputs; None where JAX returns None."""
    refs, ranks = model2_runs
    case = MODEL2_CASES[name]
    ours = _assemble(case, [r[name] for r in ranks], 1, 2)
    ref = refs[name]
    if ref is None:
        assert ours is None, name
        return
    assert ours is not None, name
    _compare(case, ours, ref)


@pytest.mark.parametrize("name", sorted(MESH22_CASES))
def test_spmd_wrappers_match_jax_on_data2_model2(mesh22_runs, name):
    """4 gloo ranks on a 2 x 2 (data, model) mesh: rows split over data
    where they divide, per-replica pools rebased to their local pages,
    the ragged wrapper declining the data axis - against the JAX wrappers
    on the same mesh."""
    refs, ranks = mesh22_runs
    case = MESH22_CASES[name]
    ours = _assemble(case, [r[name] for r in ranks], 2, 2)
    ref = refs[name]
    if ref is None:
        assert ours is None, name
        return
    assert ours is not None, name
    _compare(case, ours, ref)


def test_forward_on_model4_with_replicated_kv_heads(mesh22_runs):
    """tiny-llama on a 4-way model axis: 4 q heads split one per rank, its
    2 kv heads whole on every rank (the JAX package's
    _fallback_replicated), dense attention on each rank's head, f32
    logits within 1e-4 of JAX's whole-weight forward on all ranks."""
    refs, ranks = mesh22_runs
    for r in ranks:
        np.testing.assert_allclose(r["forward_model4"],
                                   refs["forward_model4"], atol=LOGIT_ATOL,
                                   rtol=0)


def test_spmd_decline_reasons():
    """The reasons behind the Nones, asked without any rank: heads that do
    not partition, a data axis under the ragged wrapper, pool replicas
    whose rows do not split over the data axis; on the CPU every shard
    shape goes."""
    from theroundtaible_tpu_torch.engine.kernels import attention as kattn
    m2, m22 = Mesh(1, 2, 0), Mesh(2, 2, 0)
    assert kattn.spmd_decline_reason("flash", m2, (4, 2), 3, 16, 0, D,
                                     "cpu") is None
    assert kattn.spmd_decline_reason("flash", m2, (8, 1), 3, 16, 0, D,
                                     "cpu") is None
    assert kattn.spmd_decline_reason("decode", m2, (6, 3), 3, 1, PS, D,
                                     "cpu") == "heads:model-axis"
    assert kattn.spmd_decline_reason("ragged", m22, (4, 2), 32, 8, PS, D,
                                     "cpu") == "mesh:data-axis"
    assert kattn.spmd_decline_reason(
        "decode", m22, (4, 2), 3, 1, PS, D, "cpu",
        pool_replicas=2).startswith("pool_replicas:2")
    assert kattn.spmd_decline_reason("decode", m22, (4, 2), 4, 1, PS, D,
                                     "cpu", pool_replicas=2) is None


def test_spmd_wrapper_checks_its_shard():
    """A local tensor that is not this rank's shard raises (the caller
    passed whole heads where the mesh splits them)."""
    from theroundtaible_tpu_torch.engine.kernels import attention as kattn
    case = MODEL2_CASES["paged_decode"]
    t = {k: torch.from_numpy(case[k]) for k in ("q", "k", "v", "table",
                                                "kv_valid")}
    with pytest.raises(ValueError, match="not this rank's shard"):
        kattn.paged_decode_spmd(Mesh(1, 2, 0), t["q"], t["k"], t["v"],
                                t["table"], t["kv_valid"], heads=(H, KH))
    with pytest.raises(ValueError, match="global row count"):
        kattn.flash_attention_spmd(
            Mesh(2, 1, 0), t["q"], t["k"], t["v"], t["kv_valid"] - 1,
            t["kv_valid"], heads=(H, KH))


def test_attention_takes_dense_math_where_the_wrapper_declines_on_the_cpu():
    """On the CPU, models/common.attention under a mesh whose heads do not
    partition (3 q and 3 kv heads over a 2-way model axis: both stay whole
    on every rank, so no collective runs) gives the dense math's result,
    as JAX's attention() does where flash_attention_spmd returns None."""
    import dataclasses
    from theroundtaible_tpu_torch.engine.models import common
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    cfg = dataclasses.replace(get_model_config("tiny-llama"), num_heads=3,
                              num_kv_heads=3, attn_impl="flash")
    mesh = Mesh(1, 2, 0)
    gen = torch.Generator().manual_seed(0)
    e, d = cfg.embed_dim, cfg.head_dim
    layer = {name: torch.randn(*shape, generator=gen) * 0.1
             for name, shape in (("q_proj", (e, 3, d)), ("k_proj", (e, 3, d)),
                                 ("v_proj", (e, 3, d)),
                                 ("o_proj", (3, d, e)))}
    x = torch.randn(2, 5, e, generator=gen)
    positions = torch.arange(5)[None].repeat(2, 1)
    mask = torch.ones(2, 5, 5, dtype=torch.bool).tril()
    valid = torch.tensor([5, 5], dtype=torch.int32)
    out, _ = common.attention(x, layer, cfg, positions, None, None, mask,
                              kv_valid=valid, mesh=mesh)
    ref, _ = common.attention(x, layer, dataclasses.replace(
        cfg, attn_impl="dense"), positions, None, None, mask, mesh=mesh)
    assert torch.equal(out, ref)


def test_spmd_launch_counts_stay_zero_on_the_cpu():
    """A wrapper counts only launches of its CUDA kernel: the CPU runs the
    plain versions and counts nothing."""
    from theroundtaible_tpu_torch.engine.kernels import attention as kattn
    kattn.reset_launch_counts()
    case = MODEL2_CASES["flash_decode"]
    local, _, _ = _local(case, 1, 2, 0)
    assert _run_wrapper(Mesh(1, 2, 0), local) is not None
    assert not any(kattn.launch_counts().values())


# --- the weight bridge ---


def _tree(name, dtype=np.float32):
    """The JAX package's init tree as numpy."""
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.models import common as jcommon
    from theroundtaible_tpu.engine.models.registry import get_model_config
    jcfg = get_model_config(name)
    return jax.device_get(jcommon.init_params(jcfg, jax.random.PRNGKey(0),
                                              jnp.float32))


@pytest.mark.parametrize("name,model", [("tiny-llama", 2), ("tiny-qwen", 2),
                                        ("tiny-gemma", 2),
                                        ("tiny-llama", 4)])
def test_shard_params_concatenate_back(name, model):
    """The ranks' slices of every leaf put back along its spec's sharded
    axis equal the unsharded leaf bit for bit; a dimension the axis does
    not divide (tiny-llama's 2 kv heads on 4 ranks) is whole on every
    rank."""
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    cfg = get_model_config(name)
    tree = _tree(name)
    shards = [shard_params(tree, cfg, Mesh(1, model, r))
              for r in range(model)]
    specs = param_specs(cfg)

    def check(leaf, parts, spec):
        axis = next((i for i, a in enumerate(spec) if a == "model"), None)
        if axis is None or leaf.shape[axis] % model:
            for p in parts:
                np.testing.assert_array_equal(p, leaf)
            return
        np.testing.assert_array_equal(np.concatenate(parts, axis), leaf)

    for key in tree:
        if key == "layers":
            for i, layer in enumerate(tree["layers"]):
                for leaf_name, leaf in layer.items():
                    check(leaf, [s["layers"][i][leaf_name] for s in shards],
                          specs["layers"][i][leaf_name])
        else:
            check(tree[key], [s[key] for s in shards], specs[key])


@pytest.mark.parametrize("name,model", [("tiny-llama", 2), ("tiny-llama", 4),
                                        ("tiny-gemma", 8)])
def test_mesh_rules_match_jax(name, model):
    """param_specs, kv_cache_spec and model_axis_size give the JAX
    package's answers on the same mesh shape (PartitionSpecs as tuples),
    and Mesh.splits the sharding JAX's _fallback_replicated keeps."""
    import jax
    from theroundtaible_tpu.engine import sharding as jsharding
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu_torch.engine import sharding
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    jmesh = jsharding.build_mesh({"data": 1, "model": model},
                                 jax.devices()[:model])
    mesh = Mesh(1, model, 0)
    cfg, jcfg = get_model_config(name), jax_config(name)
    for n in (cfg.num_heads, cfg.num_kv_heads, cfg.mlp_dim, cfg.vocab_size,
              1, 3):
        kept = jsharding._fallback_replicated(
            jsharding.P("model"), (n,), jmesh)
        assert mesh.splits(n) == (tuple(kept) == ("model",)), n
        assert mesh.local(n) == (n // model if mesh.splits(n) else n)
    assert sharding.model_axis_size(mesh) == \
        jsharding.model_axis_size(jmesh)
    assert sharding.kv_cache_spec() == tuple(jsharding.kv_cache_spec())
    ours, theirs = param_specs(cfg), jsharding.param_specs(jcfg)
    assert ours["embedding"] == tuple(theirs["embedding"])
    for a, b in zip(ours["layers"], theirs["layers"]):
        assert a == {k: tuple(v) for k, v in b.items()}


def test_bridge_and_init_shard_alike():
    """params_from_numpy under a mesh gives the rank's slices with the
    local config's shapes; init_params under a mesh draws the whole
    tensors and keeps the same slices of them as shard_params."""
    from theroundtaible_tpu_torch.engine.models import common as tcommon
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    cfg = get_model_config("tiny-qwen")
    tree = _tree("tiny-qwen")
    mesh = Mesh(1, 2, 1)
    local = params_from_numpy(tree, cfg, torch.float32, "cpu", mesh=mesh)
    lcfg = local_config(cfg, mesh)
    assert local["layers"][0]["q_proj"].shape == (64, lcfg.num_heads, 16)
    assert local["layers"][0]["q_bias"].shape == (lcfg.num_heads, 16)
    assert local["embedding"].shape == (lcfg.vocab_size, 64)
    np.testing.assert_array_equal(
        local["layers"][1]["down_proj"].numpy(),
        tree["layers"][1]["down_proj"][64:])
    full = tcommon.init_params(cfg, torch.Generator().manual_seed(3),
                               torch.float32, "cpu")
    mine = tcommon.init_params(cfg, torch.Generator().manual_seed(3),
                               torch.float32, "cpu", mesh=mesh)
    want = shard_params(full, cfg, mesh)
    for key in ("embedding", "final_norm"):
        assert torch.equal(mine[key], want[key])
    for a, b in zip(mine["layers"], want["layers"]):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


# --- the engine on a {"data": 1, "model": 2} mesh ---

MESH = {"data": 1, "model": 2}
ENGINE_CASES = [("tiny-llama", "contiguous"), ("tiny-llama", "paged"),
                ("tiny-qwen", "contiguous"), ("tiny-qwen", "paged")]
OFF = dict(prefix_cache=False, kv_offload=False, ragged_attn=False,
           spec_decode=False)
SHARED = ("the common context paragraph that every knight receives before "
          "their personal instructions begin here. ")
BASE = "round one establishes the shared context for everyone here."
EXT = BASE + " round two adds new arguments and asks for a score."


def _serve(eng):
    """The engine tests' workload: one generate, a delta prefill of the
    same slot, a 3-knight batch with a shared prefix. Returns texts, the
    committed token records and the reuse counts."""
    out = {"one": eng.generate("the knights debate the session store",
                               slot_name="a", max_new_tokens=8)}
    eng.generate(BASE, slot_name="k", max_new_tokens=8)
    out["delta"] = eng.generate(EXT, slot_name="k", max_new_tokens=8)
    out["delta_reused"] = eng.last_stats.reused_tokens
    prompts = [(f"kn{i}", SHARED + f"You are knight {i}.") for i in range(3)]
    texts, stats = eng.generate_batch_with_stats(prompts, max_new_tokens=8)
    out["batch"] = texts
    out["batch_reused"] = stats.reused_tokens
    out["batch_prefill"] = stats.prefill_tokens
    names = ["a", "k"] + [n for n, _ in prompts]
    out["records"] = {n: list(eng.kv._slots[n].tokens) for n in names}
    return out


def _forward_inputs(vocab):
    rng = np.random.default_rng(5)
    b, t = 2, 24
    return {"tokens": rng.integers(0, vocab, (b, t)).astype(np.int32),
            "positions": np.broadcast_to(np.arange(t, dtype=np.int32),
                                         (b, t)).copy(),
            "valid": np.full((b,), t, np.int32)}


def _ragged_inputs():
    """tests/test_torch_ragged.py's mixed flat buffer on tiny-llama (page
    16, 10 pages, max_seq_len 64): a 10-token chunk at offset 3 and a
    decode row at position 20."""
    from theroundtaible_tpu_torch.engine import serving_loop
    rng = np.random.default_rng(5)
    pools = [(rng.standard_normal((10, 16, 2, 16)).astype(np.float32),
              rng.standard_normal((10, 16, 2, 16)).astype(np.float32))
             for _ in range(2)]
    seqs = [serving_loop.RaggedSeq([2, 5, 9, 11, 5, 7, 9, 4, 6, 3], 3,
                                   np.array([1, 2, 3, 4], np.int32)),
            serving_loop.RaggedSeq([8], 20, np.array([5, 6, 7, 8],
                                                     np.int32))]
    batch = serving_loop.build_ragged_batch(
        seqs, t_budget=32, s_max=4, pages_per_seq=4, scratch_page=9,
        pad_id=0, page_size=16)
    return pools, batch


RAGGED_KEYS = ("tokens", "positions", "tables", "seq_of_block",
               "block_qstart", "query_offsets", "kv_valid", "token_pages",
               "token_offs")


def _ragged_rank(tree, rank):
    """forward_ragged under the mesh on this rank's kv heads of the
    pools."""
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.paged_forward import forward_ragged
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    cfg = get_model_config("tiny-llama", max_seq_len=64)
    mesh = Mesh(1, 2, rank)
    params = params_from_numpy(tree, cfg, torch.float32, "cpu", mesh=mesh)
    pools_np, batch = _ragged_inputs()
    pools = [(torch.from_numpy(k[:, :, rank:rank + 1].copy()),
              torch.from_numpy(v[:, :, rank:rank + 1].copy()))
             for k, v in pools_np]
    t = {k: torch.from_numpy(batch[k]) for k in RAGGED_KEYS + ("last_rows",)}
    return forward_ragged(params, cfg, t["tokens"].long(), t["positions"],
                          pools, *(t[k] for k in RAGGED_KEYS[2:]),
                          t["last_rows"], mesh=mesh).numpy()


def _engine_rank(rank, cases, ragged_tree):
    """One rank: per (model, layout) a TP engine on bridged weights and the
    workload (tiny-llama also with attn "flash", the K10 wrapper's plain
    version); the dense forward, forward_paged and forward_ragged under
    the mesh on the same inputs; the scheduler's refusal on a live
    mesh."""
    torch.set_num_threads(1)
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.models import common as tcommon
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.paged_forward import forward_paged
    from theroundtaible_tpu_torch.engine.sampling import SamplingParams
    from theroundtaible_tpu_torch.engine.scheduler import scheduler_for
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    results = {"ragged": _ragged_rank(ragged_tree, rank)}
    coords = Mesh(1, 2, rank)
    runs = [(key, key[1]) for key in cases]
    runs.append((("tiny-llama", "contiguous-flash"), "contiguous"))
    for (name, layout), kv_layout in runs:
        tree, fwd = cases[(name, kv_layout)]
        cfg = get_model_config(name, max_seq_len=256)
        params = params_from_numpy(tree, cfg, torch.float32, "cpu",
                                   mesh=coords)
        eng = InferenceEngine(
            cfg, mesh_shape=dict(MESH), num_slots=5, kv_layout=kv_layout,
            page_size=32, dtype=torch.float32,
            sampling=SamplingParams(temperature=0.0, max_new_tokens=8),
            params=params, ragged_attn=False,
            attn="flash" if layout == "contiguous-flash" else "auto",
            device="cpu")
        out = _serve(eng)
        d = eng.describe()
        out.update(mesh=d["mesh"], devices=d["devices"],
                   params=d["params"], attn=d.get("attn"),
                   kv_shape=tuple((eng.kv.layers if kv_layout == "contiguous"
                                   else eng.kv.pools)[0][0].shape),
                   paged_decode=d.get("paged_decode"))
        if (name, layout) == ("tiny-llama", "paged"):
            try:
                scheduler_for(eng)
                out["scheduler"] = "built"
            except NotImplementedError as e:
                out["scheduler"] = str(e)
        if layout == "paged":
            t = {k: torch.from_numpy(v) for k, v in fwd.items()}
            logits, _ = tcommon.forward(params, eng.cfg,
                                        t["tokens"].long(), t["positions"],
                                        None, None, t["valid"],
                                        mesh=eng.mesh)
            out["forward"] = logits.numpy()
            lcfg = local_config(cfg, eng.mesh)
            pp = 2
            pools = [(torch.zeros(1 + 2 * pp, 16, lcfg.num_kv_heads, 16),
                      torch.zeros(1 + 2 * pp, 16, lcfg.num_kv_heads, 16))
                     for _ in range(cfg.num_layers)]
            table = torch.arange(1, 1 + 2 * pp,
                                 dtype=torch.int32).reshape(2, pp)
            out["paged"] = forward_paged(
                params, eng.cfg, t["tokens"].long(), t["positions"], pools,
                table, t["valid"], mesh=eng.mesh).numpy()
        results[(name, layout)] = out
        del eng
    return results


@pytest.fixture(scope="module")
def engine_runs():
    """The JAX TP engines' results (in this process) and the ranks'."""
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
    from theroundtaible_tpu.engine.models import common as jcommon
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu.engine.paged_forward import \
        forward_paged as jax_forward_paged
    from theroundtaible_tpu.engine.sampling import \
        SamplingParams as JaxSampling
    from theroundtaible_tpu.engine.paged_forward import \
        forward_ragged as jax_forward_ragged
    jax_out, cases = {}, {}
    # forward_ragged on tiny-llama (max_seq_len 64) whole
    rcfg = jax_config("tiny-llama", max_seq_len=64)
    ragged_tree = jax.device_get(jcommon.init_params(
        rcfg, jax.random.PRNGKey(0), jnp.float32))
    pools_np, batch = _ragged_inputs()
    jax_out["ragged"] = np.asarray(jax_forward_ragged(
        ragged_tree, rcfg, *(jnp.asarray(batch[k]) for k in RAGGED_KEYS[:2]),
        [(jnp.asarray(k), jnp.asarray(v)) for k, v in pools_np],
        *(jnp.asarray(batch[k]) for k in RAGGED_KEYS[2:]),
        jnp.asarray(batch["token_seq"]), jnp.asarray(batch["last_rows"]))[0])
    for name, layout in ENGINE_CASES:
        jeng = JaxEngine(jax_config(name, max_seq_len=256),
                         mesh_shape=dict(MESH), num_slots=5,
                         kv_layout=layout, page_size=32, dtype=jnp.float32,
                         sampling=JaxSampling(temperature=0.0,
                                              max_new_tokens=8), **OFF)
        tree = jax.device_get(jeng.params)
        out = _serve(jeng)
        out["mesh"] = jeng.describe()["mesh"]
        out["params"] = jeng.describe()["params"]
        fwd = _forward_inputs(jeng.cfg.vocab_size)
        if layout == "paged":
            jcfg = jax_config(name, max_seq_len=256)
            j = {k: jnp.asarray(v) for k, v in fwd.items()}
            out["forward"] = np.asarray(jcommon.forward(
                tree, jcfg, j["tokens"], j["positions"], None, None,
                j["valid"])[0])
            k_, d_ = jcfg.num_kv_heads, jcfg.head_dim
            pools = [(jnp.zeros((5, 16, k_, d_)), jnp.zeros((5, 16, k_, d_)))
                     for _ in range(jcfg.num_layers)]
            table = jnp.arange(1, 5, dtype=jnp.int32).reshape(2, 2)
            out["paged"] = np.asarray(jax_forward_paged(
                tree, jcfg, j["tokens"], j["positions"], pools, table,
                j["valid"])[0])
        jax_out[(name, layout)] = out
        cases[(name, layout)] = (tree, fwd)
    ranks = _launch(_engine_rank, 2, cases, ragged_tree)
    return jax_out, ranks


@pytest.mark.parametrize("name,layout", ENGINE_CASES + [
    ("tiny-llama", "contiguous-flash")])
def test_tp_engine_matches_jax_tp_engine(engine_runs, name, layout):
    """The port on 2 gloo ranks against JAX's engine on the same 2-way
    model mesh and weights: the same greedy texts and committed tokens,
    the same reuse counts, the same describe()["mesh"] and parameter
    count; every rank returns the same tokens. "contiguous-flash" is the
    port's contiguous engine with attn "flash" (flash_attention_spmd's
    plain version on the CPU) held against JAX's dense TP engine."""
    jax_out, ranks = engine_runs
    ref = jax_out[(name, layout.replace("-flash", ""))]
    if layout.endswith("flash"):
        assert all(r[(name, layout)]["attn"] == "flash" for r in ranks)
    for r in ranks:
        got = r[(name, layout)]
        for key in ("one", "delta", "batch", "records", "delta_reused",
                    "batch_reused", "batch_prefill", "mesh", "params"):
            assert got[key] == ref[key], (name, layout, key)
    assert ranks[0][(name, layout)]["records"] == \
        ranks[1][(name, layout)]["records"]


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-qwen"])
def test_tp_forward_logits_match_jax(engine_runs, name):
    """f32 logits of the dense forward and of forward_paged under the mesh
    (the vocab-gathered head, f32 all-reduces) against JAX's forward and
    forward_paged on the whole weights, on both ranks."""
    jax_out, ranks = engine_runs
    ref = jax_out[(name, "paged")]
    for r in ranks:
        got = r[(name, "paged")]
        for key in ("forward", "paged"):
            np.testing.assert_allclose(got[key], ref[key], atol=LOGIT_ATOL,
                                       rtol=0)
    np.testing.assert_array_equal(ranks[0][(name, "paged")]["forward"],
                                  ranks[1][(name, "paged")]["forward"])


def test_tp_forward_ragged_matches_jax(engine_runs):
    """forward_ragged under the mesh (ragged_paged_spmd over K3's plain
    version, each rank on its kv head of the pools) against JAX's
    forward_ragged on the whole weights and pools."""
    jax_out, ranks = engine_runs
    for r in ranks:
        np.testing.assert_allclose(r["ragged"][:2], jax_out["ragged"][:2],
                                   atol=LOGIT_ATOL, rtol=LOGIT_ATOL)


def test_tp_engine_holds_its_shard(engine_runs):
    """Each rank's cache or pool holds its kv heads only (1 of tiny-llama's
    2), pool-direct paged decode, and describe() names both ranks'
    devices."""
    _, ranks = engine_runs
    for r in ranks:
        assert r[("tiny-llama", "contiguous")]["kv_shape"][2] == 1
        assert r[("tiny-llama", "paged")]["kv_shape"][2] == 1
        assert r[("tiny-llama", "paged")]["paged_decode"] == "pool-direct"
        assert r[("tiny-llama", "paged")]["devices"] == ["cpu", "cpu"]


def test_scheduler_on_a_mesh_raises(engine_runs):
    _, ranks = engine_runs
    for r in ranks:
        msg = r[("tiny-llama", "paged")]["scheduler"]
        assert "scheduler on a mesh" in msg and "ROADMAP" in msg


# --- refusals without a live group ---


@pytest.mark.parametrize("key,value", [
    ("mesh", {"data": 2, "model": 2}), ("quant", "int4"), ("quant", "int8"),
    ("lora", {"rank": 4, "max_adapters": 2}),
])
def test_unported_mesh_options_raise(key, value):
    """A data axis raises NotImplementedError naming its slice before any
    group is needed, alone and with quantized weights or LoRA, which a
    model axis serves (tests/test_torch_tp_quant.py)."""
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    config = {"model": "tiny-llama", "max_seq_len": 128,
              "mesh": {"data": 2, "model": 2}, key: value}
    with pytest.raises(NotImplementedError, match="ROADMAP, slice 7"):
        InferenceEngine.from_config(config, device="cpu")


def test_mesh_without_a_process_group_raises():
    import torch.distributed as dist
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized torch.distributed"):
        InferenceEngine.from_config(
            {"model": "tiny-llama", "max_seq_len": 128, "mesh": dict(MESH)},
            device="cpu")


def test_mesh_of_another_size_than_the_group_raises():
    """A one-rank group cannot hold a 2-way model axis."""
    import torch.distributed as dist
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    distributed.initialize("gloo", "cpu",
                           f"tcp://localhost:{distributed.free_port()}", 1, 0)
    try:
        with pytest.raises(ValueError, match="needs 2 ranks.*has 1"):
            InferenceEngine.from_config(
                {"model": "tiny-llama", "max_seq_len": 128,
                 "mesh": dict(MESH)}, device="cpu")
    finally:
        dist.destroy_process_group()


def test_launch_defaults_to_the_card():
    """launch without device= asks for the card, as every entry point of
    the port does: with none it raises before any rank starts (device="cpu"
    runs the ranks on the CPU, as every other test here)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the "
                    "default there")
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        distributed.launch(_failing_rank, 2, "gloo")


def test_launch_reraises_a_rank_failure():
    with pytest.raises(distributed.RankFailed, match="rank 1 failed"):
        _launch(_failing_rank, 2)


def _failing_rank(rank):
    if rank == 1:
        raise ValueError("this rank fails on purpose")
    return rank
