"""PyTorch port, the contiguous layout on a "data" mesh axis (Queue 1
slice 2a) and the gather view (`attn: "dense"`) on a paged data axis,
against the JAX package's engine on the same mesh.

The JAX side runs in this process on the virtual 8-CPU mesh: its slot
cache [num_slots, S, K, D] is sharded on the slot axis over "data"
(sharding.kv_cache_spec), replicated where num_slots does not divide
(_fallback_replicated). The port runs one gloo rank per device: a data
rank's layers hold its replica's block of num_slots / data slots, it runs
its replica's rows of the replica-grouped batch (K8/K9's plain versions
with `attn: "flash"`, the dense math with "auto" on the CPU; under a model
axis each rank its kv heads), and a donor span whose source slot sits on
another replica arrives over the data group. Both sides serve the same
numpy weights in f32, so greedy texts, reuse counts and committed records
must be identical: slots that divide (4 over 2) and do not (5: every rank
holds every slot), a leader span and a donor span crossing replicas,
{"data": 2, "model": 2} with int4 weights, and the paged pool's gather
view on a data axis (describe() says "gather-view" as JAX's). This module
imports only torch and numpy at its top (the spawned ranks import it);
each mesh's ranks are spawned once."""

import pytest
import torch

from theroundtaible_tpu_torch.engine import distributed

SPAWN_TIMEOUT_S = 300.0
SHARED = ("the common context paragraph that every knight receives before "
          "their personal instructions begin here. ")
PREAMBLE = SHARED * 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(eng):
    return {n: list(eng.kv._slots[n].tokens) for n in eng.kv.slot_names()}


def _workload(eng):
    """Three knights of one session on slots 0-2 (replicas 0, 0, 1 with
    4 slots over 2: the leader's span reaches kn2 across replicas), a
    follow-up turn, then a donor: kay takes the last free slot (replica
    1), bors evicts kn0's slot (replica 0) and copies kay's span."""
    out = {}
    prompts = [(f"kn{i}", SHARED + f"You are knight {i}.") for i in range(3)]
    texts, st = eng.generate_batch_with_stats(prompts, max_new_tokens=8,
                                              session="s1")
    out["batch"] = (texts, st.reused_tokens, st.prefill_tokens)
    texts2, st = eng.generate_batch_with_stats(
        [("kn1", prompts[1][1] + texts[1] + " Go on.")], max_new_tokens=8,
        session="s1")
    out["follow"] = (texts2, st.reused_tokens, st.prefill_tokens)
    a = eng.generate(PREAMBLE + "Kay speaks first.", slot_name="kay",
                     max_new_tokens=8, session="s1")
    b = eng.generate(PREAMBLE + "Kay speaks first. Bors answers him.",
                     slot_name="bors", max_new_tokens=8, session="s1")
    out["donor"] = ([a, b], eng.last_stats.reused_tokens)
    out["records"] = _records(eng)
    return out


# key: (mesh, engine kwargs, JAX engine kwargs)
CASES = {
    "d2m1": ({"data": 2, "model": 1}, dict(num_slots=4), None),
    "d2m1_flash": ({"data": 2, "model": 1},
                   dict(num_slots=4, attn="flash"), dict(num_slots=4)),
    "d2m1_replicated": ({"data": 2, "model": 1}, dict(num_slots=5), None),
    "d2m2_int4": ({"data": 2, "model": 2},
                  dict(num_slots=4, quant="int4"), None),
    "d2m1_gather": ({"data": 2, "model": 1},
                    dict(num_slots=4, kv_layout="paged", page_size=32,
                         num_pages=40, attn="dense", spec_decode=False),
                    None),
}


def _rank(rank, cases, trees):
    torch.set_num_threads(1)
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.sampling import SamplingParams
    from theroundtaible_tpu_torch.engine.sharding import Mesh
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    cfg = get_model_config("tiny-llama", max_seq_len=256)
    out = {}
    for key, (mesh, kw, _jkw) in cases.items():
        params = params_from_numpy(trees[key], cfg, torch.float32, "cpu",
                                   mesh=Mesh(mesh["data"], mesh["model"],
                                             rank))
        eng = InferenceEngine(
            cfg, mesh_shape=dict(mesh), dtype=torch.float32,
            sampling=SamplingParams(temperature=0.0, max_new_tokens=8),
            params=params, device="cpu", **kw)
        res = {"workload": _workload(eng)}
        d = eng.describe()
        res["describe"] = {k: d.get(k) for k in ("mesh", "kv_layout",
                                                 "paged_decode")}
        caches = (eng.kv.pools if eng.kv_layout == "paged"
                  else eng.kv.layers)
        res["cache_shape"] = tuple(caches[0][0].shape)
        res["cross"] = eng.kv.cross_replica_copies
        out[key] = res
        del eng
    return out


def _jax_runs(cases):
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu.engine.sampling import \
        SamplingParams as JaxSampling
    trees, ref = {}, {}
    for key, (mesh, kw, jkw) in cases.items():
        jeng = JaxEngine(jax_config("tiny-llama", max_seq_len=256),
                         mesh_shape=dict(mesh), dtype=jnp.float32,
                         sampling=JaxSampling(temperature=0.0,
                                              max_new_tokens=8),
                         **(jkw if jkw is not None else kw))
        trees[key] = jax.device_get(jeng.params)
        d = jeng.describe()
        ref[key] = {"workload": _workload(jeng),
                    "describe": {k: d.get(k) for k in (
                        "mesh", "kv_layout", "paged_decode")}}
    return trees, ref


@pytest.fixture(scope="module")
def runs():
    out = {}
    for world in (2, 4):
        cases = {k: c for k, c in CASES.items()
                 if c[0]["data"] * c[0]["model"] == world}
        trees, ref = _jax_runs(cases)
        ranks = distributed.launch(_rank, world, "gloo", "cpu",
                                   args=(cases, trees),
                                   timeout_s=SPAWN_TIMEOUT_S)
        for key in cases:
            out[key] = (ref[key], [r[key] for r in ranks])
    return out


@pytest.mark.parametrize("key", list(CASES))
@pytest.mark.parametrize("part", ["batch", "follow", "donor", "records"])
def test_data_axis_engine_matches_jax(runs, key, part):
    """Greedy texts, reuse counts and committed records of every rank
    equal JAX's engine on the same mesh."""
    ref, ranks = runs[key]
    for r in ranks:
        assert r["workload"][part] == ref["workload"][part], (key, part)


@pytest.mark.parametrize("key", list(CASES))
def test_each_rank_holds_its_block(runs, key):
    """A data rank's slots are its replica's block (num_slots / data),
    every slot where they do not divide; the kv heads are the model
    axis's share; the shares that crossed replicas went over the data
    group; describe() reports the layout and decode path as JAX's."""
    ref, ranks = runs[key]
    mesh, kw, _jkw = CASES[key]
    for r in ranks:
        assert r["describe"] == ref["describe"]
        shape = r["cache_shape"]
        assert shape[2] == 2 // mesh["model"]
        if kw.get("kv_layout") == "paged":
            assert shape[0] == kw["num_pages"] // mesh["data"]
            assert r["describe"]["paged_decode"] == "gather-view"
        elif kw["num_slots"] % mesh["data"]:
            assert shape[0] == kw["num_slots"] and r["cross"] == 0
        else:
            assert shape[0] == kw["num_slots"] // mesh["data"]
            assert r["cross"] > 0
