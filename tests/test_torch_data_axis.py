"""PyTorch port, a "data" mesh axis: per-replica page pools and the
ReplicaGroupPlan, against the JAX package's engine on the same mesh.

The JAX side runs in this process on the virtual 8-CPU mesh (its
NamedSharding splits the pool's page axis over "data"). The port runs one
gloo rank per device (engine/distributed.launch), each holding only its
replica's range of pages, [num_pages / data, page_size, K / model, D] per
layer; the ranks' host programs stay in lockstep and return the same
tokens. Both sides serve the same numpy weights in f32, so greedy tokens
and reuse counts must be identical: an odd batch that pads a replica
group, a one-row follow-up turn, a same-session share and a cross-session
prefix attach whose donor pages sit on the other replica (copied between
ranks), pool exhaustion on one replica (JAX's message), and one int4
weights + int8 pages case. ReplicaGroupPlan is held against JAX's class
on plain numpy. This module imports only torch and numpy at its top (the
spawned ranks import it); each mesh's ranks are spawned once."""

import numpy as np
import pytest
import torch

from theroundtaible_tpu_torch.engine import distributed
from theroundtaible_tpu_torch.engine.serving_loop import ReplicaGroupPlan

SPAWN_TIMEOUT_S = 300.0
SHARED = ("the common context paragraph that every knight receives before "
          "their personal instructions begin here. ")
PREAMBLE = SHARED * 3
LONG = "a long petition to the round table about the eastern gate " * 3
ENGINE_KW = dict(num_slots=6, num_pages=40, page_size=32, kv_layout="paged",
                 spec_decode=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- ReplicaGroupPlan (pure numpy) ---

PLAN_CASES = [([0, 1, 0], 2, False), ([1, 1, 1], 2, False),
              ([0, 1, 2, 3, 0], 4, False), ([0, 0, 0, 1], 2, True),
              ([2], 3, True), ([0, 1], 2, True)]


@pytest.mark.parametrize("replicas,n,bucket", PLAN_CASES)
def test_replica_group_plan_equals_jax(replicas, n, bucket):
    from theroundtaible_tpu.engine.serving_loop import \
        ReplicaGroupPlan as JaxPlan
    ours = ReplicaGroupPlan(replicas, n, bucket_group=bucket)
    ref = JaxPlan(replicas, n, bucket_group=bucket)
    assert (ours.group, ours.b_padded) == (ref.group, ref.b_padded)
    np.testing.assert_array_equal(ours.pos, ref.pos)
    np.testing.assert_array_equal(ours.pad_positions, ref.pad_positions)
    assert ours.pad_replicas == ref.pad_replicas
    table = np.arange(len(replicas) * 3, dtype=np.int32).reshape(-1, 3) + 1
    np.testing.assert_array_equal(
        ours.pad_table(table, lambda r: 100 * r),
        ref.pad_table(table, lambda r: 100 * r))
    vals = np.arange(len(replicas), dtype=np.int32) + 7
    np.testing.assert_array_equal(
        ours.scatter_rows(torch.from_numpy(vals), -1).numpy(),
        np.asarray(ref.scatter_rows(vals, -1)))
    assert ours.scatter_list(list(vals), -1) == ref.scatter_list(
        list(vals), -1)


# --- the engines: one workload for both packages ---

def _records(eng):
    return {n: list(eng.kv._slots[n].tokens) for n in eng.kv.slot_names()}


def _workload(eng):
    """An odd batch of three knights (two replicas: one pad row) sharing a
    long prefix (the leader's span reaches the other replica by copy), a
    one-row follow-up turn, then two sessions sharing a preamble (the
    second attaches the first's pages from the prefix cache; its slot sits
    on the other replica). Returns texts, reuse counts, slot records and
    each slot's replica."""
    out = {}
    prompts = [(f"kn{i}", SHARED + f"You are knight {i}.") for i in range(3)]
    texts, st = eng.generate_batch_with_stats(prompts, max_new_tokens=8,
                                              session="s1")
    out["batch"] = (texts, st.reused_tokens, st.prefill_tokens)
    out["batch_replicas"] = _replicas(eng)
    out["copies"] = [getattr(eng.kv, "cross_replica_copies", None)]
    texts2, st = eng.generate_batch_with_stats(
        [("kn1", prompts[1][1] + texts[1] + " Go on.")], max_new_tokens=8,
        session="s1")
    out["follow"] = (texts2, st.reused_tokens, st.prefill_tokens)
    # (a short turn first, so that the balancer puts kay and bors on
    # different replicas)
    eng.generate("Kay sits down.", slot_name="kay0", max_new_tokens=2,
                 session="A")
    a = eng.generate(PREAMBLE + "Kay speaks first.", slot_name="kay",
                     max_new_tokens=8, session="A")
    b = eng.generate(PREAMBLE + "Bors answers him.", slot_name="bors",
                     max_new_tokens=8, session="B")
    out["prefix"] = ([a, b], eng.last_stats.prefix_reused_tokens,
                     eng.last_stats.reused_tokens)
    out["records"] = _records(eng)
    out["replicas"] = _replicas(eng)
    out["copies"].append(getattr(eng.kv, "cross_replica_copies", None))
    return out


def _replicas(eng):
    return {n: eng.kv._slots[n].replica for n in eng.kv.slot_names()}


def _exhaust(eng):
    """Three long rows over two replicas of 8 usable pages each (18
    pages): replica 0 holds two rows, which need 14 pages."""
    try:
        eng.generate_batch([(f"x{i}", LONG + f"Knight {i}.")
                            for i in range(3)], max_new_tokens=8)
    except RuntimeError as e:
        return str(e)
    return None


def _quant_round(eng):
    prompts = [(f"q{i}", SHARED + f"Quantized knight {i}.")
               for i in range(3)]
    texts, st = eng.generate_batch_with_stats(prompts, max_new_tokens=8,
                                              session="q")
    return texts, st.reused_tokens, _records(eng)


def _unported_axes():
    """On a live group: a "pipe" mesh builds a PPEngine through get_engine
    (pipe 2 over the group, TP inside its stages on four ranks), while
    from_config and build_mesh refuse it with a ValueError naming PPEngine;
    "pipe" beside "data" raises JAX's ValueError from all three; a "seq"
    axis raises NotImplementedError naming item 7e-ii from all three."""
    from theroundtaible_tpu_torch.engine import get_engine, reset_engines
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.sharding import build_mesh
    world = torch.distributed.get_world_size()
    pipe = {"pipe": 2, "model": world // 2} if world > 2 else {"pipe": 2}
    out = []
    for axes in (pipe, {"seq": world}, {"data": 1, "model": 1, "pipe": world}):
        config = {"model": "tiny-llama", "max_seq_len": 128,
                  "kv_layout": "paged", "page_size": 32, "mesh": axes}
        for build in (lambda: InferenceEngine.from_config(config, "cpu"),
                      lambda: get_engine(config, device="cpu"),
                      lambda: build_mesh(axes)):
            try:
                eng = build()
                out.append(type(eng).__name__)
            except (NotImplementedError, ValueError) as e:
                out.append(f"{type(e).__name__}: {e}")
    reset_engines()
    return out


def _rank(rank, mesh, trees, name):
    """One rank: the port's engines on bridged weights, with this rank's
    pool shape and describe() beside the workloads' results."""
    torch.set_num_threads(1)
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.sampling import SamplingParams
    from theroundtaible_tpu_torch.engine.sharding import Mesh
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    coords = Mesh(mesh["data"], mesh["model"], rank)
    cfg = get_model_config(name, max_seq_len=256)
    out = {"f7": _unported_axes()}

    def build(tree, **kw):
        params = params_from_numpy(tree, cfg, torch.float32, "cpu",
                                   mesh=coords)
        return InferenceEngine(
            cfg, mesh_shape=dict(mesh), dtype=torch.float32,
            sampling=SamplingParams(temperature=0.0, max_new_tokens=8),
            params=params, device="cpu", **{**ENGINE_KW, **kw})

    eng = build(trees["dense"])
    out["workload"] = _workload(eng)
    d = eng.describe()
    out["describe"] = {k: d[k] for k in ("mesh", "paged_decode",
                                         "paged_replicas", "num_pages",
                                         "kv_hbm_bytes")}
    out["ragged_reason"] = d["ragged"]["reason"]
    out["pool_shape"] = tuple(eng.kv.pools[0][0].shape)
    del eng
    if "int4" in trees:
        out["exhaust"] = _exhaust(build(trees["dense"], num_pages=18))
        out["quant"] = _quant_round(build(trees["int4"], quant="int4",
                                          kv_quant="int8"))
    return out


def _jax_runs(mesh, name, quant):
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu.engine.sampling import \
        SamplingParams as JaxSampling

    def build(**kw):
        return JaxEngine(jax_config(name, max_seq_len=256),
                         mesh_shape=dict(mesh), dtype=jnp.float32,
                         sampling=JaxSampling(temperature=0.0,
                                              max_new_tokens=8),
                         **{**ENGINE_KW, **kw})

    jeng = build()
    trees = {"dense": jax.device_get(jeng.params)}
    ref = {"workload": _workload(jeng), "describe": jeng.describe()}
    if quant:
        ref["exhaust"] = _exhaust(build(num_pages=18))
        qeng = build(quant="int4", kv_quant="int8")
        trees["int4"] = jax.device_get(qeng.params)
        ref["quant"] = _quant_round(qeng)
    return trees, ref


MESHES = {"d2m1": {"data": 2, "model": 1}, "d2m2": {"data": 2, "model": 2}}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for key, mesh in MESHES.items():
        trees, ref = _jax_runs(mesh, "tiny-llama", quant=key == "d2m1")
        ranks = distributed.launch(
            _rank, mesh["data"] * mesh["model"], "gloo", "cpu",
            args=(mesh, trees, "tiny-llama"), timeout_s=SPAWN_TIMEOUT_S)
        out[key] = (ref, ranks)
    return out


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("part", ["batch", "follow", "prefix", "records",
                                  "batch_replicas", "replicas"])
def test_data_axis_engine_matches_jax(runs, key, part):
    """Greedy texts, reuse counts, committed records and slot replicas of
    the port's ranks equal JAX's engine on the same mesh; every rank
    agrees."""
    ref, ranks = runs[key]
    for r in ranks:
        assert r["workload"][part] == ref["workload"][part], (key, part)


@pytest.mark.parametrize("key", list(MESHES))
def test_shares_really_crossed_replicas(runs, key):
    """The workload's shares are the ones this slice is about: the batch's
    followers sit on a replica other than their leader's, and the prefix
    attach reused tokens from a slot of the other replica."""
    ref, ranks = runs[key]
    w = ranks[0]["workload"]

    def rep(knight, part="replicas"):
        return next(r for n, r in w[part].items() if n.endswith(knight))
    assert rep("kn0", "batch_replicas") != rep("kn1", "batch_replicas")
    assert rep("kay") != rep("bors")
    # pages went between the ranks for the batch's share and the attach
    copies = w["copies"]
    assert 0 < copies[0] < copies[1]
    assert w["batch"][1] > 0 and w["prefix"][1] > 0


@pytest.mark.parametrize("key", list(MESHES))
def test_each_rank_holds_its_replica_range(runs, key):
    """Each rank's pools hold num_pages / data pages of its kv heads;
    describe() reports pool-direct decode over the replicas, the rank's
    pool bytes, and the ragged seam off with JAX's reason."""
    ref, ranks = runs[key]
    mesh = MESHES[key]
    for r in ranks:
        d = r["describe"]
        assert d["mesh"] == mesh == ref["describe"]["mesh"]
        assert d["num_pages"] == ref["describe"]["num_pages"]
        assert d["paged_decode"] == "pool-direct"
        assert d["paged_replicas"] == mesh["data"]
        assert r["pool_shape"][0] == d["num_pages"] // mesh["data"]
        assert r["pool_shape"][2] == 2 // mesh["model"]
        assert d["kv_hbm_bytes"] * mesh["data"] * mesh["model"] == \
            ref["describe"]["kv_hbm_bytes"]
        assert r["ragged_reason"] == "mesh:data-axis" == \
            ref["describe"]["ragged"]["reason"]


def test_pool_exhaustion_on_one_replica_says_so_as_jax(runs):
    ref, ranks = runs["d2m1"]
    want = "Page pool exhausted on data replica 0"
    assert ref["exhaust"] is not None and ref["exhaust"].startswith(want)
    for r in ranks:
        assert r["exhaust"] is not None and r["exhaust"].startswith(want)


def test_int4_weights_int8_pages_on_a_data_axis(runs):
    ref, ranks = runs["d2m1"]
    for r in ranks:
        assert r["quant"] == ref["quant"]


def test_pipe_and_seq_axes_raise_on_live_ranks(runs):
    """On ranks of an initialized group a "pipe" mesh builds a PPEngine
    through get_engine (where it used to build a tensor-parallel engine
    over the whole group, F7), while InferenceEngine.from_config and
    build_mesh refuse it naming PPEngine; "pipe" beside "data" raises
    JAX's message from all three; a "seq" axis raises NotImplementedError
    naming item 7e-ii from all three."""
    for key in MESHES:
        for r in runs[key][1]:
            f7 = r["f7"]
            assert len(f7) == 9
            assert f7[0].startswith("ValueError") and "PPEngine" in f7[0]
            assert f7[1] == "PPEngine"
            assert f7[2].startswith("ValueError") and "PPEngine" in f7[2]
            for msg in f7[3:6]:
                assert msg.startswith("NotImplementedError")
                assert "ROADMAP, item 7e-ii" in msg and "'seq' axis" in msg
            for msg in f7[6:]:
                assert msg.startswith("ValueError: mesh axes ['data']")
