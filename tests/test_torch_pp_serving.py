"""PyTorch port, pipeline-parallel serving (engine/pp_serving.PPEngine),
against the JAX package's PPEngine on the same weights.

The JAX side runs every case of tests/test_pp_serving.py's engines in this
process on the virtual 8-CPU mesh. The port runs one gloo rank per device
(two stages; four ranks for four stages and for TP inside stages), each
rank holding only its stage's slice of the same numpy tree
(weights.params_from_numpy with `stage=` and the stage's model mesh). Both
sides serve in f32 at tiny sizes, so greedy texts, reuse counts and
prefill counts must be identical and the prefill logits agree within
LOGIT_ATOL: parity (one prompt, a batch in one and two microbatches, a
slot reused across turns, four stages), per-row sampling, donor and leader
prefix sharing, int8 weights, the paged pool pool-direct and through the
gather view (slot reuse, page aliasing, the prefix cache), TP inside
stages (dense, int8, paged, flash), and describe(). JAX's own PP x TP int4
test fails under jax 0.9.0, so the port's PP x TP int4 engine is held
against JAX's single-engine int4 tokens. A generation ended early - a
deadline at a prefill chunk or between decode segments, `timeout_s`, a
cancelled budget - raises the same on every rank and leaves every rank's
engine serving the reference tokens. get_engine builds a PPEngine for a
pipe mesh, the adapter serves a round through it, the scheduler refuses
it, and `serve` on a pipe mesh runs the sessions on rank 0 while rank 1
makes rank 0's plans and writes nothing. This module imports only torch
and numpy at its top (the spawned ranks import it); each rank count's
ranks are spawned once."""

import json
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from theroundtaible_tpu_torch.engine import distributed

SPAWN_TIMEOUT_S = 300.0
LOGIT_ATOL = 1e-4
SHARED = ("the common context paragraph that every knight receives "
          "before their personal instructions begin. ")
PROMPTS = [("a", "first knight question about caching"),
           ("b", "second knight question, a bit longer than one")]
TP_PROMPTS = [("a", "the knights debate tensor parallel stages today"),
              ("b", "a second, longer question about memory layouts")]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- workloads: the same calls on either package's engine ---

def _parity(eng):
    """tests/test_pp_serving.py's parity calls on one engine."""
    out = {"single": eng.generate(
        "the knights debate the merits of pipeline parallel serving",
        slot_name="s", max_new_tokens=8)}
    out["batch"] = eng.generate_batch(PROMPTS, max_new_tokens=8)
    base = "round one says the store needs an event log."
    eng.generate(base, slot_name="k", max_new_tokens=8)
    out["reuse"] = eng.generate(base + " round two asks for sizing "
                                "estimates.", slot_name="k",
                                max_new_tokens=8)
    out["reused_tokens"] = eng.last_stats.reused_tokens
    return out


def _sampling(eng, sampling):
    """A greedy row beside a hot one, then both greedy: the greedy row's
    text is the same (the hot row's depends on the package's generator)."""
    greedy = sampling(temperature=0.0, max_new_tokens=8)
    hot = sampling(temperature=1.5, max_new_tokens=8)
    prompts = [("ga", "the deterministic knight"), ("gb", "the spicy knight")]
    mixed = eng.generate_batch(prompts, max_new_tokens=8,
                               sampling_per_turn=[greedy, hot])
    for n, _ in prompts:
        eng.kv.release(n)
    all_greedy = eng.generate_batch(prompts, max_new_tokens=8,
                                    sampling_per_turn=[greedy, greedy])
    try:
        eng.generate_batch([("x", "one"), ("y", "two")], max_new_tokens=4,
                           sampling_per_turn=[greedy])
        mismatch = None
    except ValueError as e:
        mismatch = str(e)
    return {"greedy_row": mixed[0], "all_greedy": all_greedy,
            "greedy_unaffected": mixed[0] == all_greedy[0],
            "mismatch": mismatch}


def _sharing(eng):
    """A donor's span copied (or aliased), then a leader pass."""
    a = SHARED + "You are knight Alpha."
    b = SHARED + "You are knight Beta."
    eng.generate(a, slot_name="alpha", max_new_tokens=8)
    out = {"donor": eng.generate(b, slot_name="beta", max_new_tokens=8),
           "donor_reused": eng.last_stats.reused_tokens}
    texts, st = eng.generate_batch_with_stats(
        [(f"kn{i}", SHARED + f"You are knight {i}.") for i in range(3)],
        max_new_tokens=8)
    out["leader"] = (texts, st.reused_tokens, st.prefill_tokens)
    return out


def _paged(eng):
    """Reuse across a page boundary, page aliasing in a batch, pages that
    grow with use, a prefix-cache attach across sessions."""
    base = "the paged pipeline debates its own page tables at length."
    eng.generate(base, slot_name="k", max_new_tokens=8)
    out = {"reuse": eng.generate(base + " a second turn crosses a page "
                                 "boundary here.", slot_name="k",
                                 max_new_tokens=8),
           "reused": eng.last_stats.reused_tokens}
    used = eng.kv.pages_in_use()
    eng.generate("a much longer prompt " * 6, slot_name="l",
                 max_new_tokens=8)
    out["pages_grow"] = eng.kv.pages_in_use() > used
    texts, st = eng.generate_batch_with_stats(
        [(f"kn{i}", SHARED + f"knight {i} speaks") for i in range(3)],
        max_new_tokens=8)
    out["alias"] = (texts, st.reused_tokens)
    pre = SHARED * 2
    eng.generate(pre + "Kay speaks first.", slot_name="kay",
                 max_new_tokens=8, session="A")
    out["attach"] = (eng.generate(pre + "Bors answers him.",
                                  slot_name="bors", max_new_tokens=8,
                                  session="B"),
                     eng.last_stats.prefix_reused_tokens)
    return out


def _timeout(eng):
    """timeout_s=0 at the first prefill chunk: TimeoutError, the view
    released, and the next turn serves."""
    try:
        eng.generate("a prompt that will never finish", slot_name="t",
                     max_new_tokens=120, timeout_s=0.0)
        raised = None
    except TimeoutError as e:
        raised = f"TimeoutError ({type(e).__name__})"
    return {"raised": raised,
            "view_released": eng.kc is None and eng.vc is None,
            "after": eng.generate("recovery prompt after the timeout",
                                  slot_name="t", max_new_tokens=8)}


def _describe(eng, keys):
    d = eng.describe()
    return {k: d.get(k) for k in keys}


DESCRIBE = ("model", "params", "max_seq_len", "mesh", "n_micro",
            "num_slots", "kv_layout", "attn", "quant", "scope")

# key: (model, layers, seed, engine kwargs, workloads); the port's and
# JAX's engines run the same workloads in order.
RUNS2 = {
    "micro2": ("tiny-llama", 2, 0, dict(n_micro=2),
               ("parity", "sampling", "sharing", "logits")),
    "micro1": ("tiny-llama", 2, 0, dict(n_micro=1), ("parity",)),
    "int8": ("tiny-llama", 2, 0, dict(quant="int8"), ("parity",)),
    "paged": ("tiny-llama", 2, 0, dict(kv_layout="paged", page_size=32),
              ("paged", "sharing", "logits", "timeout")),
    "gather": ("tiny-gemma", 2, 3, dict(kv_layout="paged", attn="dense"),
               ("tp",)),
    "pool_direct": ("tiny-gemma", 2, 3, dict(kv_layout="paged"),
                    ("tp", "parity")),
    "flash": ("tiny-gemma", 2, 3, dict(attn="flash"), ("tp",)),
    "flash_paged_int8": ("tiny-gemma", 2, 3, dict(
        kv_layout="paged", attn="flash", quant="int8"), ("tp",)),
}
RUNS4 = {
    "stages4": ("tiny-llama", 4, 0, dict(n_stages=4), ("parity",)),
    "tp": ("tiny-gemma", 2, 3, dict(n_model=2), ("tp", "parity")),
    "tp_int8": ("tiny-gemma", 2, 3, dict(n_model=2, quant="int8"),
                ("tp",)),
    "tp_paged": ("tiny-gemma", 2, 3, dict(n_model=2, kv_layout="paged",
                                          page_size=32),
                 ("tp", "paged")),
    "tp_flash": ("tiny-gemma", 2, 3, dict(n_model=2, attn="flash"),
                 ("tp",)),
}
# PP x TP int4 against JAX's single engine (int4, seed 7), both layouts.
INT4 = {"tp_int4": {}, "tp_int4_paged": dict(kv_layout="paged",
                                             page_size=32, num_pages=9)}
INT4_PROMPT = "the pipeline serves packed nibbles now"


def _run(eng, workloads, sampling, logits_fn):
    out = {}
    for w in workloads:
        if w == "parity":
            out[w] = _parity(eng)
        elif w == "sampling":
            out[w] = _sampling(eng, sampling)
        elif w == "sharing":
            out[w] = _sharing(eng)
        elif w == "paged":
            out[w] = _paged(eng)
        elif w == "timeout":
            out[w] = _timeout(eng)
        elif w == "tp":
            texts, st = eng.generate_batch_with_stats(TP_PROMPTS,
                                                      max_new_tokens=12)
            out[w] = (texts, st.decode_tokens > 0)
        elif w == "logits":
            out[w] = logits_fn(eng)
    return out


def _int4_turns(eng):
    """Two turns on one slot: the texts, whether the second reused the
    slot, and the slot's committed ids."""
    eng.kv.release("k")
    a = eng.generate(INT4_PROMPT, slot_name="k", max_new_tokens=8)
    b = eng.generate(INT4_PROMPT + " and a follow-up turn reuses the slot "
                     "prefix", slot_name="k", max_new_tokens=8)
    return [a, b, eng.last_stats.reused_tokens > 0,
            [int(t) for t in eng.kv._slots["k"].tokens]]


# --- the port's ranks ---

LOGIT_PROMPTS = ["the knights compare logits", "across the two packages"]


def _port_logits(eng):
    """Last-token prefill logits of two fresh rows (slots 2 and 3, or
    fresh pages), on the last stage (None elsewhere)."""
    toks = [eng.tokenizer.encode(p) for p in LOGIT_PROMPTS]
    if eng.kv_layout == "paged":
        names = ["lg0", "lg1"]
        for n, t in zip(names, toks):
            eng.kv.reuse_plan(n, t, tuple(names))
            eng.kv.ensure_capacity(n, len(t) + 64, write_from=0,
                                   pinned=tuple(names))
        rows = eng.kv.table_for(names)
    else:
        rows = [2, 3]
    logits = eng._prefill_rows(rows, toks, [0, 0], float("inf"))
    return logits.numpy() if eng.mesh.last else None


def _build_port(spec, tree):
    from theroundtaible_tpu_torch.engine.models.common import Stage
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.pp_serving import PPEngine
    from theroundtaible_tpu_torch.engine.sampling import SamplingParams
    from theroundtaible_tpu_torch.engine.sharding import Mesh
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    model, layers, seed, kw = spec
    kw = dict(kw)
    n_stages = kw.pop("n_stages", 2)
    n_model = kw.pop("n_model", 1)
    rank = torch.distributed.get_rank()
    cfg = get_model_config(model, max_seq_len=kw.pop("max_seq_len", 256),
                           num_layers=layers)
    smesh = (Mesh(1, n_model, rank % n_model) if n_model > 1 else None)
    params = params_from_numpy(tree, cfg, torch.float32, "cpu", mesh=smesh,
                               stage=Stage(rank // n_model, n_stages))
    max_new = 12 if model == "tiny-gemma" else 8
    return PPEngine(cfg, n_stages=n_stages, n_model=n_model,
                    num_slots=kw.pop("num_slots", 4), dtype=torch.float32,
                    sampling=SamplingParams(temperature=0.0,
                                            max_new_tokens=max_new),
                    params=params, device="cpu", **kw)


def _early_ends(rank):
    """Every early end on live ranks: timeout_s 0, a cancelled budget, a
    deadline passing between decode segments (every rank's segments slowed
    alike, rank 0 decides), then a turn that must equal a fresh engine's."""
    from theroundtaible_tpu_torch.engine import deadlines
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.pp_serving import PPEngine
    from theroundtaible_tpu_torch.engine.sampling import SamplingParams

    def build(**kw):
        return PPEngine(get_model_config("tiny-llama", max_seq_len=256),
                        n_stages=2, num_slots=4, dtype=torch.float32,
                        sampling=SamplingParams(temperature=0.0,
                                                max_new_tokens=8),
                        device="cpu", **kw)

    out = {}
    for layout in ("contiguous", "paged"):
        kw = {"kv_layout": layout, "page_size": 32} if layout == "paged" \
            else {}
        eng = build(**kw)
        res = {}

        def outcome(fn):
            try:
                fn()
                return None
            except Exception as e:  # noqa: BLE001 - the outcome
                return type(e).__name__

        res["timeout_s"] = outcome(lambda: eng.generate(
            "never", slot_name="t", max_new_tokens=120, timeout_s=0.0))
        token = deadlines.CancelToken()
        token.cancel("drain")
        budget = deadlines.Budget.root(600.0, rung="turn", token=token)
        res["cancelled"] = outcome(lambda: eng.generate_batch(
            [("c", "a cancelled turn")], max_new_tokens=120, budget=budget))
        seg = eng._decode_segment

        def slow(*a, **k):
            time.sleep(1.2)
            return seg(*a, **k)
        eng._decode_segment = slow
        t0 = time.monotonic()
        res["decode_deadline"] = outcome(lambda: eng.generate(
            "a long answer", slot_name="d", max_new_tokens=120,
            timeout_s=1.0))
        res["decode_deadline_s"] = time.monotonic() - t0
        eng._decode_segment = seg
        p = "recovery prompt after the timeout"
        res["after"] = eng.generate(p, slot_name="t", max_new_tokens=8)
        res["fresh"] = build(**kw).generate(p, slot_name="f",
                                            max_new_tokens=8)
        out[layout] = res
    return out


def _routing(rank):
    """get_engine on live ranks: a PPEngine for {"pipe": 2} serving a round
    through the adapter; the scheduler refuses it; InferenceEngine and
    build_mesh refuse the pipe mesh; "seq" still raises."""
    from theroundtaible_tpu_torch.adapters.base import KnightTurn
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    from theroundtaible_tpu_torch.engine import get_engine, reset_engines
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.pp_serving import PPEngine
    from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler
    from theroundtaible_tpu_torch.engine.sharding import build_mesh
    reset_engines()
    config = {"model": "tiny-llama", "max_seq_len": 256,
              "mesh": {"pipe": 2}, "n_micro": 2, "num_slots": 4,
              "dtype": "float32", "_quant_auto_degraded": True,
              "sampling": {"temperature": 0.0, "max_new_tokens": 8}}
    out = {}
    eng = get_engine(config, device="cpu")
    out["type"] = type(eng).__name__
    out["cached"] = get_engine(config, device="cpu") is eng
    out["identity"] = (eng._engine_cache_key is not None
                       and eng._engine_config == config)
    d = eng.describe()
    out["describe"] = {k: d[k] for k in ("mesh", "quant", "kv_layout")}
    adapter = TorchLlmAdapter("pp-knight", config, device="cpu")
    out["available"] = adapter.is_available()
    outs = adapter.execute_round(
        [KnightTurn("a", "what say you about pipelines?"),
         KnightTurn("b", "and what about stage local caches?")])
    out["round"] = (len(outs), adapter.last_stats()["decode_tokens"] > 0)
    try:
        SessionScheduler(eng)
        out["scheduler"] = None
    except TypeError as e:
        out["scheduler"] = str(e)
    for name, build in (
            ("inference", lambda: InferenceEngine.from_config(config,
                                                              "cpu")),
            ("build_mesh", lambda: build_mesh({"pipe": 2}))):
        try:
            build()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    out["seq"] = []
    for build in (lambda: get_engine({**config, "mesh": {"seq": 2}}, "cpu"),
                  lambda: PPEngine.from_config({**config, "mesh": {
                      "pipe": 2, "seq": 1}}, "cpu")):
        try:
            build()
            out["seq"].append(None)
        except (NotImplementedError, ValueError) as e:
            out["seq"].append(f"{type(e).__name__}: {e}")
    reset_engines()
    return out


def _serve_project(root: Path) -> None:
    (root / ".roundtable" / "sessions").mkdir(parents=True)
    engine_cfg = {"model": "tiny-llama", "max_seq_len": 512,
                  "num_slots": 8, "kv_layout": "paged", "page_size": 32,
                  "dtype": "float32", "mesh": {"pipe": 2},
                  "sampling": {"temperature": 0.0, "max_new_tokens": 16}}
    (root / ".roundtable" / "config.json").write_text(json.dumps({
        "version": "1.0", "project": "t", "language": "en",
        "knights": [{"name": n, "adapter": "torch-llm",
                     "capabilities": [], "priority": i + 1}
                    for i, n in enumerate(("Knight-A", "Knight-B"))],
        "rules": {"max_rounds": 1, "consensus_threshold": 9,
                  "timeout_per_turn_seconds": 120,
                  "escalate_to_user_after": 3, "auto_execute": False,
                  "ignore": [".git"]},
        "chronicle": "chronicle.md",
        "adapter_config": {"torch-llm": engine_cfg}}))


def _files(root: Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*")}


def _serve(rank):
    """`serve "<topic>" --sessions 2` through cli.main on both pipe ranks,
    each in its own copy of the project; then `gateway`'s scheduler seam,
    which refuses the pipe mesh's engine as JAX's does."""
    import io
    import sys
    import tempfile
    from theroundtaible_tpu_torch import cli
    from theroundtaible_tpu_torch.commands import gateway_cmd
    from theroundtaible_tpu_torch.core.errors import ConfigError
    from theroundtaible_tpu_torch.engine import get_engine, reset_engines
    from theroundtaible_tpu_torch.engine.mesh_plan import follow_config
    reset_engines()
    root = Path(tempfile.mkdtemp(prefix="pp-serve-"))
    proj = root / f"rank{rank}"
    _serve_project(proj)
    before = _files(proj)
    cli.check_for_update = lambda cb: None
    os.environ.update(RANK=str(rank),
                      WORLD_SIZE=str(torch.distributed.get_world_size()))
    cwd = os.getcwd()
    os.chdir(proj)
    saved, sys.stdin = sys.stdin, io.StringIO("")
    try:
        rc = cli.main(["serve", "Should the castle get a moat?",
                       "--sessions", "2", "--no-read-code"], device="cpu")
    finally:
        sys.stdin = saved
        os.chdir(cwd)
    config = json.loads((proj / ".roundtable" / "config.json").read_text())
    eng = get_engine(config["adapter_config"]["torch-llm"], "cpu")
    out = {"rc": rc, "new_files": sorted(_files(proj) - before),
           "plans": eng.plan_counts()}
    reset_engines()
    try:
        from theroundtaible_tpu_torch.core.config import load_config
        cfg = load_config(str(proj))
        if rank == 0:
            gateway_cmd._build_scheduler(cfg, None, device="cpu")
        else:
            follow_config(cfg, "cpu")
        out["gateway"] = None
    except ConfigError as e:
        out["gateway"] = f"ConfigError: {e}"
    finally:
        for k in ("RANK", "WORLD_SIZE"):
            os.environ.pop(k, None)
        reset_engines()
    return out


# --- the JAX side ---

def _jax_tree(model, layers, seed):
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.models.common import \
        init_params as jax_init
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    cfg = jax_config(model, max_seq_len=256, num_layers=layers)
    return cfg, jax_init(cfg, jax.random.PRNGKey(seed), jnp.float32)


def _jax_logits(eng):
    import jax.numpy as jnp
    toks = [eng.tokenizer.encode(p) for p in LOGIT_PROMPTS]
    if eng.kv_layout == "paged":
        names = ["lg0", "lg1"]
        for n, t in zip(names, toks):
            eng.kv.reuse_plan(n, t, tuple(names))
            eng.kv.ensure_capacity(n, len(t) + 64, write_from=0,
                                   pinned=tuple(names))
        tables = jnp.asarray(eng.kv.table_for(names))
        got = eng._chunked_rows_pool_direct(toks, [0, 0], tables,
                                            float("inf"))
    else:
        got = eng._chunked_rows([2, 3], toks, [0, 0], float("inf"))
    return np.asarray(got, np.float32)


def _jax_runs(runs):
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.pp_serving import PPEngine as JaxPP
    from theroundtaible_tpu.engine.quant import quantize_params
    from theroundtaible_tpu.engine.sampling import \
        SamplingParams as JaxSampling
    trees, out = {}, {}
    for key, (model, layers, seed, kw, workloads) in runs.items():
        cfg, params = _jax_tree(model, layers, seed)
        kw = dict(kw)
        n_model = kw.get("n_model", 1)
        if (model, layers, seed) not in trees:
            trees[(model, layers, seed)] = jax.device_get(params)
        tree_key = (model, layers, seed)
        if kw.get("quant", "none") != "none":
            q = quantize_params(params, cfg, act_dtype=jnp.float32,
                                bits=8 if kw["quant"] == "int8" else 4,
                                model_shards=n_model)
            tree_key = (model, layers, seed, kw["quant"], n_model)
            trees[tree_key] = jax.device_get(q)
        max_new = 12 if model == "tiny-gemma" else 8
        eng = JaxPP(cfg, n_stages=kw.pop("n_stages", 2), num_slots=4,
                    dtype=jnp.float32, seed=seed,
                    sampling=JaxSampling(temperature=0.0,
                                         max_new_tokens=max_new), **kw)
        res = _run(eng, workloads, JaxSampling, _jax_logits)
        res["describe"] = _describe(eng, DESCRIBE)
        res["pool_direct"] = eng._pool_direct
        res["tree_key"] = tree_key
        out[key] = res
    return trees, out


def _jax_int4():
    """JAX's single-engine int4 tokens (seed 7) and the PP x TP tree: the
    same dense weights quantized with groups aligned to two model
    shards."""
    import jax
    import jax.numpy as jnp
    from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
    from theroundtaible_tpu.engine.models.common import \
        init_params as jax_init
    from theroundtaible_tpu.engine.models.registry import \
        get_model_config as jax_config
    from theroundtaible_tpu.engine.quant import quantize_params
    from theroundtaible_tpu.engine.sampling import \
        SamplingParams as JaxSampling
    cfg = jax_config("tiny-llama", max_seq_len=128)
    ref = JaxEngine(cfg, num_slots=2, quant="int4", dtype=jnp.float32,
                    seed=7, sampling=JaxSampling(temperature=0.0,
                                                 max_new_tokens=8))
    dense = jax_init(cfg, jax.random.PRNGKey(7), jnp.float32)
    tree = jax.device_get(quantize_params(
        dense, cfg, act_dtype=jnp.float32, bits=4, model_shards=2))
    single = jax.device_get(quantize_params(
        dense, cfg, act_dtype=jnp.float32, bits=4, model_shards=1))
    return ({k: {"tree": tree} for k in INT4}, _int4_turns(ref), single)


@pytest.fixture(scope="module")
def runs():
    trees2, ref2 = _jax_runs(RUNS2)
    trees4, ref4 = _jax_runs(RUNS4)
    int4_trees, int4_want, int4_single = _jax_int4()
    out = {"ref": {**ref2, **ref4}, "int4_want": int4_want,
           "int4_single_tree": int4_single}
    out["ranks2"] = distributed.launch(
        _rank2, 2, "gloo", "cpu",
        args=(RUNS2, {k: trees2[ref2[k]["tree_key"]] for k in RUNS2}),
        timeout_s=SPAWN_TIMEOUT_S)
    out["ranks4"] = distributed.launch(
        _rank4, 4, "gloo", "cpu",
        args=(RUNS4, {k: trees4[ref4[k]["tree_key"]] for k in RUNS4},
              int4_trees),
        timeout_s=SPAWN_TIMEOUT_S)
    return out


def _rank_runs(runs, trees):
    from theroundtaible_tpu_torch.engine.sampling import SamplingParams
    out = {}
    for key, (model, layers, seed, kw, workloads) in runs.items():
        eng = _build_port((model, layers, seed, kw), trees[key])
        res = _run(eng, workloads, SamplingParams, _port_logits)
        res["describe"] = _describe(eng, DESCRIBE)
        res["pool_direct"] = eng._pool_direct
        res["stage_bytes"] = eng._kv.hbm_bytes()
        caches = (eng._kv.pools if eng.kv_layout == "paged"
                  else eng._kv.layers)
        res["cache"] = (len(caches), tuple(caches[0][0].shape))
        res["p2p"] = eng.describe()["p2p"]
        out[key] = res
        del eng
    return out


def _rank2(rank, runs, trees):
    torch.set_num_threads(1)
    out = _rank_runs(runs, trees)
    out["early"] = _early_ends(rank)
    out["routing"] = _routing(rank)
    out["serve"] = _serve(rank)
    return out


def _rank4(rank, runs, trees, int4_trees):
    torch.set_num_threads(1)
    out = _rank_runs(runs, trees)
    for key, kw in INT4.items():
        eng = _build_port(("tiny-llama", 2, 7, dict(
            n_model=2, quant="int4", num_slots=2, max_seq_len=128, **kw)),
            int4_trees[key]["tree"])
        out[key] = {"turns": _int4_turns(eng),
                    "int4_paths": eng.describe()["int4_paths"]}
        del eng
    return out


ALL = [(2, k) for k in RUNS2] + [(4, k) for k in RUNS4]


def _ranks(runs, n):
    return runs["ranks2"] if n == 2 else runs["ranks4"]


@pytest.mark.parametrize("n,key", ALL, ids=[k for _n, k in ALL])
def test_pp_engine_matches_jax(runs, n, key):
    """Greedy texts, reuse and prefill counts, on every rank, equal JAX's
    PPEngine on the same weights."""
    ref = runs["ref"][key]
    for r in _ranks(runs, n):
        got = r[key]
        for w in RUNS2.get(key, RUNS4.get(key))[4]:
            if w == "logits":
                continue
            assert got[w] == ref[w], (key, w)


@pytest.mark.parametrize("key", ["micro2", "paged"])
def test_prefill_logits_match_jax(runs, key):
    """The last stage's prefill logits (two rows, two microbatches) are
    JAX's within LOGIT_ATOL; the other stage holds none."""
    want = runs["ref"][key]["logits"]
    first, last = (r[key]["logits"] for r in runs["ranks2"])
    assert first is None
    np.testing.assert_allclose(last, want, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("n,key", ALL, ids=[k for _n, k in ALL])
def test_describe_equals_jax(runs, n, key):
    """describe()'s JAX keys hold JAX's values (the kv_layout and scope
    strings included) on every rank; pool-direct as JAX decides it."""
    ref = runs["ref"][key]
    for r in _ranks(runs, n):
        assert r[key]["describe"] == ref["describe"], key
        assert r[key]["pool_direct"] == ref["pool_direct"], key


def test_per_row_sampling_and_mismatch(runs):
    ref = runs["ref"]["micro2"]["sampling"]
    assert ref["greedy_unaffected"]
    for r in runs["ranks2"]:
        got = r["micro2"]["sampling"]
        assert got["greedy_unaffected"]
        assert got["mismatch"] == ref["mismatch"]
        assert "entries" in got["mismatch"]


def test_sharing_really_shared(runs):
    for key in ("micro2", "paged"):
        got = runs["ranks2"][0][key]["sharing"]
        assert got["donor_reused"] > 0 and got["leader"][1] > 0
    paged = runs["ranks2"][0]["paged"]["paged"]
    assert paged["pages_grow"] and paged["reused"] > 0
    assert paged["attach"][1] > 0   # the prefix cache attached


def test_each_stage_holds_its_share_of_the_cache(runs):
    """Each rank's cache holds its stage's layers only (one of two, one of
    four) and, under TP inside stages, half of the kv heads."""
    for n, key in ALL:
        model, layers, _seed, kw, _w = RUNS2.get(key) or RUNS4[key]
        kv_heads = 2 // kw.get("n_model", 1)
        for r in _ranks(runs, n):
            n_layers, shape = r[key]["cache"]
            assert n_layers == layers // kw.get("n_stages", 2)
            assert shape[2] == kv_heads


def test_timeout_mid_serve_leaves_engine_serviceable(runs):
    ref = runs["ref"]["paged"]["timeout"]
    assert ref["raised"].startswith("TimeoutError") and ref["view_released"]
    for r in runs["ranks2"]:
        assert r["paged"]["timeout"] == ref


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_early_ends_raise_alike_and_leave_ranks_serving(runs, layout):
    """timeout_s 0, a cancelled budget and a deadline between decode
    segments raise the same on both ranks (no rank waits in a receive the
    other left: the spawn's join has its timeout), and the next turn equals
    a fresh engine's."""
    a, b = (r["early"][layout] for r in runs["ranks2"])
    assert a["timeout_s"] == b["timeout_s"] == "BudgetExceeded"
    assert a["cancelled"] == b["cancelled"] == "Cancelled"
    assert a["decode_deadline"] == b["decode_deadline"] == "TimeoutError"
    for r in (a, b):
        assert r["after"] == r["fresh"] == a["after"]


NEAR_TIE = 0.05


def _margins(tree, ids, prompt_len):
    """The port's single-device int4 engine's top-1 minus top-2 logit at
    each generated position of `ids` (its forward on the bridged tree)."""
    from theroundtaible_tpu_torch.engine.models.common import forward
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    cfg = get_model_config("tiny-llama", max_seq_len=128)
    params = params_from_numpy(tree, cfg, torch.float32, "cpu")
    out = []
    for k in range(prompt_len, len(ids) + 1):
        seq = torch.tensor([ids[:k]])
        logits, _ = forward(params, cfg, seq, torch.arange(k)[None], None,
                            None, torch.tensor([k]))
        top = torch.topk(logits[0, -1].float(), 2).values
        out.append(float(top[0] - top[1]))
    return out


def test_pp_tp_int4_matches_jax_single_engine(runs):
    """PP x TP int4 (groups aligned to two model shards, both layouts)
    gives JAX's single-device int4 engine's tokens, with the slot reused,
    up to a near tie: the follow-up turn's last token has a top-2 logit
    margin under 0.01 in f32, where JAX's own XLA:CPU results differ from
    process to process (its test_pp_tp_int4_matches_main_engine fails
    there), so a token may differ only at a position whose margin is under
    NEAR_TIE. The int4 path report lists the whole model's call sites."""
    want = runs["int4_want"]
    got = [r[key]["turns"] for r in runs["ranks4"] for key in INT4]
    assert all(g == got[0] for g in got)
    texts_a, _b, reused, ids = got[0]
    assert texts_a == want[0] and reused and want[2]
    jax_ids = want[3]
    if ids != jax_ids:
        from theroundtaible_tpu_torch.engine.serving_loop import \
            prompt_budget
        from theroundtaible_tpu_torch.engine.tokenizer import load_tokenizer
        prompt = min(len(load_tokenizer(None).encode(
            INT4_PROMPT + " and a follow-up turn reuses the slot prefix")),
            prompt_budget(128, 64))
        i = next((k for k, (x, y) in enumerate(zip(ids, jax_ids))
                  if x != y), min(len(ids), len(jax_ids)))
        assert i >= prompt
        margins = _margins(runs["int4_single_tree"], ids, prompt)
        assert margins[i - prompt] < NEAR_TIE, (i, margins)
    paths = runs["ranks4"][0]["tp_int4"]["int4_paths"]
    specs = {e["spec"] for entries in paths.values() for e in entries}
    assert "bte,ve->btv" in specs and "bthd,hde->bte" in specs


def test_get_engine_routes_pipe_meshes(runs):
    for r in runs["ranks2"]:
        got = r["routing"]
        assert got["type"] == "PPEngine" and got["cached"]
        assert got["identity"]
        assert got["describe"] == {"mesh": {"pipe": 2},
                                   "quant": "none (auto-degraded)",
                                   "kv_layout": "stage-local contiguous"}
        assert got["available"] and got["round"] == (2, True)
        assert "pipe-mesh engines serve round-level batches" in \
            got["scheduler"]
        assert "PPEngine" in got["inference"] and \
            "get_engine" in got["inference"]
        assert "PPEngine" in got["build_mesh"]
        assert got["seq"][0].startswith("NotImplementedError") and \
            "ROADMAP, item 7e-ii" in got["seq"][0]
        assert got["seq"][1].startswith("ValueError: mesh axes ['seq']")


def test_serve_on_a_pipe_mesh(runs):
    """`serve --sessions 2` on both pipe ranks: rc 0 on each, two session
    directories from rank 0, nothing written by rank 1, which made every
    plan rank 0 sent; the gateway then refuses the engine with JAX's error
    kind on rank 0, and rank 1 leaves with it."""
    r0, r1 = (r["serve"] for r in runs["ranks2"])
    assert r0["rc"] == 0 and r1["rc"] == 0
    sessions = {f.split("/")[2] for f in r0["new_files"]
                if f.startswith(".roundtable/sessions/") and f.count("/") >= 2}
    assert len(sessions) == 2
    assert r1["new_files"] == []
    assert r0["plans"]["role"] == "rank0" and r0["plans"]["plans"] > 0
    assert r1["plans"]["plans"] == r0["plans"]["plans"]
    assert r1["plans"]["errors"] == 0
    assert r0["gateway"].startswith("ConfigError")
    assert r1["gateway"] is None


def test_config_validation_as_jax():
    """from_config refuses what JAX's refuses, with its messages, before
    any process group is needed."""
    from theroundtaible_tpu.engine.pp_serving import PPEngine as JaxPP
    from theroundtaible_tpu_torch.engine import get_engine
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.pp_serving import PPEngine
    base = {"model": "tiny-llama", "max_seq_len": 256, "mesh": {"pipe": 2}}
    for extra in ({"mesh": {"pipe": 2, "data": 2}}, {"seq_parallel": 4}):
        cfg = {**base, **extra}
        with pytest.raises(ValueError) as jerr:
            JaxPP.from_config(cfg)
        with pytest.raises(ValueError) as err:
            PPEngine.from_config(cfg, device="cpu")
        assert str(err.value) == str(jerr.value)
    cfg = {**base, "mesh": {"pipe": 2, "data": 2}}
    for build in (lambda: get_engine(cfg, device="cpu"),
                  lambda: InferenceEngine.from_config(cfg, device="cpu")):
        with pytest.raises(ValueError, match=r"mesh axes \['data'\]"):
            build()
    # explicit flash on heads a 4-way model axis does not divide
    cfg = {**base, "mesh": {"pipe": 2, "model": 4}, "attn": "flash"}
    with pytest.raises(ValueError, match="divisible"):
        JaxPP.from_config(cfg)
    with pytest.raises(ValueError, match="divisible"):
        PPEngine.from_config(cfg, device="cpu")


def test_pipe_engine_without_a_group_raises():
    import torch.distributed as dist
    from theroundtaible_tpu_torch.engine.pp_serving import PPEngine
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized torch.distributed"):
        PPEngine.from_config({"model": "tiny-llama", "max_seq_len": 128,
                              "mesh": {"pipe": 2}}, device="cpu")
