"""PyTorch port, speculative decoding through the SessionScheduler against
the JAX package's (tests/test_spec_decode.py's scheduled tests), on
tiny-gemma in f32 with the JAX engine's weights bridged into the port.

One session of three greedy rows whose prompt repeats a passage is served
with speculation off and with each drafter: the n-gram chain and tree, the
`model` drafter on the engine's own weights (chain and tree) and from a
draft checkpoint, and the `lora` drafter on a persona adapter. Every run's
tokens equal the port's spec-off run and the JAX engine's spec-on run, and
its verify dispatches, drafted, accepted and tree-node counts equal
JAX's; the self-drafting model accepts every draft. Then the edges:
budget and EOS truncation, the throttle and its re-probe, hot swaps, the
fallback of a drafter whose dependency is missing, the kill switch, and
`roundtable serve` through cli.main."""

import io
import json
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theroundtaible_tpu.engine.engine import InferenceEngine as JaxEngine
from theroundtaible_tpu.engine.models.registry import \
    get_model_config as jax_config
from theroundtaible_tpu.engine.sampling import SamplingParams as JaxSampling
from theroundtaible_tpu.engine.scheduler import \
    SessionScheduler as JaxScheduler
from theroundtaible_tpu_torch.engine import lora
from theroundtaible_tpu_torch.engine import spec_decode as sd
from theroundtaible_tpu_torch.engine.engine import InferenceEngine
from theroundtaible_tpu_torch.engine.models.registry import \
    get_model_config as torch_config
from theroundtaible_tpu_torch.engine.sampling import SamplingParams
from theroundtaible_tpu_torch.engine.scheduler import SessionScheduler, _Row
from theroundtaible_tpu_torch.engine.weights import params_from_numpy

MODEL = "tiny-gemma"
MAX_SEQ = 512
MAX_NEW = 100
PASSAGE = "The round table met at dawn to discuss the castle walls. "
TURNS = [(f"knight{i}", PASSAGE * 3 + f"Knight {i} speaks.")
         for i in range(3)]
TREE = {"branch": 2, "depth": 3}
OFF = dict(prefix_cache=False, kv_offload=False)
COUNTS = ("verify_dispatches", "drafted_tokens", "accepted_tokens",
          "tree_nodes", "tree_rows", "draft_dispatches", "drafter",
          "drafter_reason", "tree", "max_draft")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_engine(spec, **kw):
    return JaxEngine(jax_config(MODEL, max_seq_len=MAX_SEQ),
                     mesh_shape={"data": 1, "model": 1}, num_slots=8,
                     kv_layout="paged", page_size=32, dtype=jnp.float32,
                     sampling=JaxSampling(temperature=0.0,
                                          max_new_tokens=8),
                     spec_decode=spec, **OFF, **kw)


def port_engine(params, spec, **kw):
    cfg = torch_config(MODEL, max_seq_len=MAX_SEQ)
    kw.setdefault("num_slots", 8)
    return InferenceEngine(
        cfg, kv_layout="paged", page_size=32, dtype=torch.float32,
        sampling=SamplingParams(temperature=0.0, max_new_tokens=8),
        params=params_from_numpy(params, cfg, torch.float32, "cpu"),
        device="cpu", spec_decode=spec, **kw)


def serve(scheduler_cls, engine, turns=TURNS, max_new=MAX_NEW,
          session="s"):
    """One session through a fresh scheduler: (texts, stats, scheduler
    provenance)."""
    sched = scheduler_cls(engine)
    try:
        texts, stats = sched.submit(session, turns, max_new_tokens=max_new)
        return texts, stats, sched.describe()
    finally:
        sched.close()


@pytest.fixture(scope="module")
def weights():
    """The JAX engine's weights (numpy), bridged into every port engine."""
    return jax.device_get(jax_engine(False).params)


@pytest.fixture(scope="module")
def spec_off(weights):
    eng = port_engine(weights, False)
    texts, _stats, prov = serve(SessionScheduler, eng)
    assert prov["spec_segments"] == 0
    assert eng.spec_describe()["verify_dispatches"] == 0
    return texts


@pytest.fixture(scope="module")
def persona(tmp_path_factory):
    """A draft-head persona npz both packages load: small random pairs,
    so the LoRA drafter proposes tokens the base model partly rejects."""
    path = tmp_path_factory.mktemp("persona") / "drafthead.npz"
    rng = np.random.default_rng(11)
    dims = lora.lora_dims(torch_config(MODEL))
    lora.save_pair_tree(str(path), {
        k: (rng.normal(size=(4, c)).astype(np.float32) * c ** -0.5,
            rng.normal(size=(4, o)).astype(np.float32) * 0.3)
        for k, (c, o, _tp) in dims.items()})
    return {"rank": 4, "max_adapters": 3,
            "adapters": {"drafthead": {"path": str(path)}}}


CASES = {
    "ngram_chain": (True, False),
    "ngram_tree": ({"tree": TREE}, False),
    "model_chain": ({"drafter": "model"}, False),
    "model_tree": ({"drafter": "model", "tree": TREE}, False),
    "lora_tree": ({"drafter": "lora", "adapter": "drafthead",
                   "tree": TREE}, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_drafter_equals_spec_off_and_jax(weights, spec_off, persona, case):
    spec, with_lora = CASES[case]
    extra = {"lora": persona} if with_lora else {}
    jeng = jax_engine(spec, **extra)
    jtexts, _js, jprov = serve(JaxScheduler, jeng)
    teng = port_engine(weights, spec, **extra)
    texts, stats, prov = serve(SessionScheduler, teng)
    assert texts == spec_off, f"{case}: spec changed the greedy tokens"
    assert texts == jtexts
    ours, ref = teng.spec_describe(), jeng.spec_describe()
    assert {k: ours[k] for k in COUNTS} == {k: ref[k] for k in COUNTS}
    assert ours["drafter"] == (spec.get("drafter", "ngram")
                               if isinstance(spec, dict) else "ngram")
    assert ours["drafter_reason"] is None
    assert ours["verify_dispatches"] > 0
    assert prov["spec_segments"] == jprov["spec_segments"] > 0
    assert stats.sched["spec"]["drafted"] > 0
    if case == "model_chain":
        # the engine drafting for itself: every draft is the target's own
        # greedy token
        assert ours["accepted_tokens"] == ours["drafted_tokens"] > 0
    if case.startswith(("model", "lora")):
        assert ours["draft_dispatches"] > 0
    if case.endswith("tree") and case != "ngram_tree":
        assert ours["tree_rows"] > 0 and ours["tree_nodes"] > \
            ours["tree_rows"]
    if with_lora:
        # drafting rode the persona's adapter slot: its per-token ids
        # reached the lora paths; the retired rows' draft slots are gone
        assert teng.lora_describe()["lora_paths"]
        assert teng.lora._refs.get("drafthead", 0) == 1
    assert not any(n.startswith(sd.DRAFT_SCOPE)
                   for n in teng.kv.slot_names())


def _hf_gemma_checkpoint(path):
    """A transformers Gemma at tiny-gemma's shapes, saved as safetensors:
    a draft model with weights of its own (drawn wide, so it is not the
    last-token copier a near-zero init makes, which the degenerate target
    would accept in full)."""
    import transformers
    cfg = torch_config(MODEL)
    torch.manual_seed(5)
    hf = transformers.GemmaForCausalLM(transformers.GemmaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.embed_dim,
        intermediate_size=cfg.mlp_dim, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        hidden_act="gelu_pytorch_tanh", max_position_embeddings=MAX_SEQ,
        tie_word_embeddings=True, attention_bias=False, bos_token_id=1,
        eos_token_id=2, pad_token_id=0, initializer_range=0.5))
    hf.eval().save_pretrained(path, safe_serialization=True)
    return str(path)


def test_model_drafter_from_checkpoint_equals_jax(weights, spec_off,
                                                  tmp_path):
    """The `model` drafter from a draft checkpoint of another model on the
    engine's shapes, loaded by each package's own loader: tokens still
    equal spec-off serving, and every count equals JAX's."""
    ckpt = _hf_gemma_checkpoint(tmp_path / "draft")
    spec = {"drafter": "model", "draft_checkpoint": ckpt}
    jeng = jax_engine(spec)
    jtexts, _js, _jp = serve(JaxScheduler, jeng)
    teng = port_engine(weights, spec)
    texts, _s, _p = serve(SessionScheduler, teng)
    assert texts == spec_off == jtexts
    ours, ref = teng.spec_describe(), jeng.spec_describe()
    assert {k: ours[k] for k in COUNTS} == {k: ref[k] for k in COUNTS}
    assert ours["drafter"] == "model" and ours["drafter_reason"] is None
    # both loaders read the same draft weights, which are not the engine's
    draft, jdraft = (teng.spec_device_drafter.params,
                     jax.device_get(jeng.spec_device_drafter.params))
    for key in ("q_proj", "down_proj"):
        np.testing.assert_allclose(draft["layers"][1][key].numpy(),
                                   np.asarray(jdraft["layers"][1][key]),
                                   rtol=1e-6, atol=1e-6)
    assert not torch.equal(draft["embedding"], teng.params["embedding"])
    assert ours["accepted_tokens"] < ours["drafted_tokens"]


def test_budget_truncation_counts_only_committed(weights):
    """A turn budget that truncates an accepted tree path counts only the
    committed tokens: each row commits 5 tokens, one at admission, so at
    most 4 per row can be accepted drafts."""
    spec = {"drafter": "model", "tree": TREE}
    off, _s, _p = serve(SessionScheduler, port_engine(weights, False),
                        max_new=5)
    eng = port_engine(weights, spec)
    on, _s, _p = serve(SessionScheduler, eng, max_new=5)
    jeng = jax_engine(spec)
    jon, _js, _jp = serve(JaxScheduler, jeng, max_new=5)
    assert on == off == jon
    info = eng.spec_describe()
    assert 0 < info["accepted_tokens"] <= 4 * len(TURNS)
    assert info["accepted_tokens"] == jeng.spec_describe()["accepted_tokens"]


def test_eos_inside_tree_counts_only_committed(weights, monkeypatch):
    """An accepted tree path cut by EOS commits up to the EOS only, counts
    only those tokens as accepted, adopts the winning path's loaned page
    and leaks no page (crafted drafts and device tokens through the real
    _run_spec_segment, as tests/test_spec_decode.py does)."""
    engine = port_engine(weights, {"tree": TREE}, num_slots=2)
    eos = engine.tokenizer.eos_id
    sched = SessionScheduler(engine)
    try:
        name = "eosrow"
        prompt = [engine.tokenizer.bos_id, 5, 6, 7]
        engine.kv.ensure_capacity(name, len(prompt) + 64, write_from=0)
        r = _Row(name=name, tokens=prompt,
                 sampling=SamplingParams(temperature=0.0), max_new=20,
                 produced=[9], last=9, valid=len(prompt))
        r.spec = sd.RowSpec(list(prompt))
        monkeypatch.setattr(sd.NGramDrafter, "draft_paths",
                            lambda self, n, branch=1: [[11, 12, 13],
                                                       [14, eos, 15]])
        free_before = len(engine.kv._free)

        def fake_dispatch(batch):
            out = np.zeros((engine.spec_s_max, batch["score_width"]),
                           np.int32)
            out[0, 0] = 14                      # the trunk dies at once
            out[1, :4] = [14, eos, 15, 99]      # path 1 runs past eos
            assert list(batch["copy_src"][:1]) == [
                engine.kv.table_for([name])[0][0]]
            return torch.from_numpy(out)

        monkeypatch.setattr(engine, "_ragged_dispatch", fake_dispatch)
        assert sched._run_spec_segment([r])
        assert r.produced == [9, 14, eos]
        assert r.done and r.valid == len(prompt) + 2
        info = engine.spec_describe()
        assert info["accepted_tokens"] == 2
        assert info["tree_nodes"] == 6 and info["tree_rows"] == 1
        assert len(engine.kv._free) == free_before
        assert sd.tree_accepted_paths_seen() >= 1
    finally:
        sched.close()


def _always_wrong(engine):
    bad = engine.cfg.vocab_size - 1
    return lambda self, n: [bad] * n if len(self) else []


def test_throttle_disables_a_non_accepting_row(weights, spec_off,
                                               monkeypatch):
    """A drafter that is always wrong trips the throttle of every row:
    the rows fall back to 1-token decode, nothing is accepted, and the
    tokens are still spec-off serving's."""
    engine = port_engine(weights, True)
    monkeypatch.setattr(sd.NGramDrafter, "draft", _always_wrong(engine))
    sched = SessionScheduler(engine)
    try:
        texts, _stats = sched.submit("s", TURNS, max_new_tokens=MAX_NEW)
        events = [e for e in sched.describe()["events"]
                  if e["event"] == "spec_throttle"]
    finally:
        sched.close()
    assert texts == spec_off
    info = engine.spec_describe()
    assert info["throttled_rows"] == len(TURNS) == len(events)
    assert info["accepted_tokens"] == 0 and info["drafted_tokens"] > 0


def test_throttled_rows_reprobe_through_the_scheduler(weights, monkeypatch):
    """With ROUNDTABLE_SPEC_REPROBE=4 a throttled row re-probes instead of
    decoding 1-token for the rest of its turn; every failed probe's
    correction is the plain token, so the output is unchanged."""
    monkeypatch.setenv("ROUNDTABLE_SPEC_REPROBE", "4")
    base, _s, _p = serve(SessionScheduler, port_engine(weights, False),
                         turns=TURNS[:1], max_new=160)
    engine = port_engine(weights, True)
    monkeypatch.setattr(sd.NGramDrafter, "draft", _always_wrong(engine))
    before = (sd.reprobes_seen(), sd.reprobe_recoveries_seen())
    texts, _s, _p = serve(SessionScheduler, engine, turns=TURNS[:1],
                          max_new=160)
    assert texts == base
    assert engine.spec_describe()["throttled_rows"] >= 1
    assert sd.reprobes_seen() > before[0]
    assert sd.reprobe_recoveries_seen() == before[1]


def test_hot_swaps_release_draft_slots_and_heads(weights, spec_off,
                                                 persona):
    """model -> lora -> ngram hot swaps between sessions: each swap frees
    the outgoing drafter's draft slots, the LoRA head's residency
    reference lives exactly as long as the lora drafter, and every
    session's tokens stay spec-off serving's."""
    engine = port_engine(weights, {"drafter": "model"}, lora=persona)
    sched = SessionScheduler(engine)
    try:
        out = [sched.submit("a", TURNS, max_new_tokens=MAX_NEW)[0]]
        engine.set_spec_drafter("lora", adapter="drafthead")
        assert engine.lora._refs.get("drafthead", 0) == 1
        out.append(sched.submit("b", TURNS, max_new_tokens=MAX_NEW)[0])
        # a live row's draft slot while the lora drafter serves
        engine.kv.acquire(sd.draft_slot_name("x"))
        engine.set_spec_drafter("ngram")
        assert engine.lora._refs.get("drafthead", 0) == 0
        assert not any(n.startswith(sd.DRAFT_SCOPE)
                       for n in engine.kv.slot_names())
        out.append(sched.submit("c", TURNS, max_new_tokens=MAX_NEW)[0])
    finally:
        sched.close()
    assert out == [spec_off] * 3
    info = engine.spec_describe()
    assert set(info["by_drafter"]) == {"model", "lora", "ngram"}


def test_missing_drafter_dependency_falls_back_like_jax(weights, spec_off):
    """A lora drafter on an engine without a store serves the n-gram
    chain, with JAX's recorded reason."""
    spec = {"drafter": "lora", "adapter": "ghost"}
    jeng = jax_engine(spec)
    teng = port_engine(weights, spec)
    assert teng.spec_drafter == "ngram"
    assert teng.spec_drafter_reason == jeng.spec_drafter_reason
    assert "lora" in teng.spec_drafter_reason
    texts, _s, _p = serve(SessionScheduler, teng)
    assert texts == spec_off
    assert teng.spec_describe()["by_drafter"].keys() <= {"ngram"}


def test_kill_switch_serves_no_verify_dispatch(weights, spec_off,
                                               monkeypatch):
    """ROUNDTABLE_SPEC_DECODE=0 on one session (no second session, so no
    join races the check): zero verify dispatches and spec segments, no
    spec entry in the ragged ring, spec-off tokens."""
    monkeypatch.setenv("ROUNDTABLE_SPEC_DECODE", "0")
    engine = port_engine(weights, None)
    assert not engine.spec_decode
    assert engine.spec_reason == "disabled:config/env"
    texts, _s, prov = serve(SessionScheduler, engine)
    assert texts == spec_off
    assert prov["spec_segments"] == 0
    info = engine.spec_describe()
    assert info["verify_dispatches"] == info["drafted_tokens"] == 0
    assert all("spec" not in e
               for e in engine.ragged_describe()["recent"])


def test_sampled_rows_serve_through_verify(weights):
    """Sampled rows run the per-position sampling verify (each row's
    temperature/top-k repeated over its scored positions): the turn
    completes with drafted tokens on record."""
    engine = port_engine(weights, {"drafter": "model"})
    sched = SessionScheduler(engine)
    try:
        sp = [SamplingParams(temperature=0.8, top_k=20,
                             max_new_tokens=40)] * len(TURNS)
        texts, _stats = sched.submit("s", TURNS, max_new_tokens=40,
                                     sampling_per_turn=sp)
    finally:
        sched.close()
    assert len(texts) == len(TURNS)
    assert engine.spec_describe()["drafted_tokens"] > 0


# --- roundtable serve ---

SERVE_ENGINE = {"model": "tiny-mistral", "max_seq_len": 8192, "num_slots": 8,
                "kv_layout": "paged", "page_size": 128, "dtype": "float32",
                "seed": 0, "sampling": {"temperature": 0.0,
                                        "max_new_tokens": 96}}


def _serve_cli(root, engine_cfg, monkeypatch):
    from theroundtaible_tpu_torch import cli
    from theroundtaible_tpu_torch import engine as port_engines
    (root / ".roundtable" / "sessions").mkdir(parents=True)
    (root / ".roundtable" / "config.json").write_text(json.dumps({
        "version": "1.0", "project": "t", "language": "en",
        "knights": [{"name": n, "adapter": "torch-llm", "capabilities": [],
                     "priority": i + 1} for i, n in enumerate("AB")],
        "rules": {"max_rounds": 1, "consensus_threshold": 9,
                  "timeout_per_turn_seconds": 300,
                  "escalate_to_user_after": 3, "auto_execute": False,
                  "ignore": [".git"]},
        "chronicle": "chronicle.md",
        "adapter_config": {"torch-llm": engine_cfg}}))
    monkeypatch.setattr(cli, "check_for_update", lambda cb: None)
    monkeypatch.chdir(root)
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    port_engines.reset_engines()
    try:
        assert cli.main(["serve", "Should we?", "--sessions", "2",
                         "--no-read-code"], device="cpu") == 0
        engine = port_engines.get_engine(engine_cfg, device="cpu")
    finally:
        port_engines.reset_engines()
    # session directories are date-HHMM-slug: keyed by the slug
    transcripts = {
        p.parent.name[len("YYYY-MM-DD-HHMM-"):]: [
            (e["knight"], e["round"], e["response"])
                        for e in json.loads(p.read_text())]
        for p in (root / ".roundtable" / "sessions").glob("*/transcript.json")}
    return transcripts, engine


def test_serve_cli_speculates_by_default(tmp_path, monkeypatch):
    """`roundtable serve` on torch-llm knights: with the default config the
    shared scheduler runs spec segments, and the transcripts equal those
    of a `spec_decode: false` run."""
    on, eng_on = _serve_cli(tmp_path / "on", SERVE_ENGINE, monkeypatch)
    off, eng_off = _serve_cli(tmp_path / "off",
                              dict(SERVE_ENGINE, spec_decode=False),
                              monkeypatch)
    assert len(on) == 2 and on == off
    assert eng_on.describe()["scheduler"]["spec_segments"] > 0
    assert eng_on.spec_describe()["verify_dispatches"] > 0
    assert eng_off.describe()["scheduler"]["spec_segments"] == 0
    assert all(len(r) > 1 for t in on.values() for _k, _r, r in t)


def test_spec_rows_join_mid_decode(weights):
    """A second session joining while the first speculates: its prompt
    chunks ride ragged segments, speculation resumes once it has filled,
    and both sessions' tokens equal serving each alone without
    speculation."""
    alone = {}
    for sid, turns in (("a", TURNS[:2]), ("b", TURNS[2:])):
        alone[sid] = serve(SessionScheduler, port_engine(weights, False),
                           turns=turns, session=sid)[0]
    engine = port_engine(weights, {"drafter": "model"})
    engine.ragged_defer_min = 1
    sched = SessionScheduler(engine)
    results = {}
    try:
        def run(sid, turns, wait):
            if wait:
                for _ in range(60000):
                    if sched.spec_segments:
                        break
                    threading.Event().wait(0.002)
            results[sid] = sched.submit(sid, turns,
                                        max_new_tokens=MAX_NEW)[0]
        threads = [threading.Thread(target=run, args=("a", TURNS[:2], False)),
                   threading.Thread(target=run, args=("b", TURNS[2:], True))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        prov = sched.describe()
    finally:
        sched.close()
    assert results == alone
    assert prov["ragged_joins"] >= 1 and prov["spec_segments"] > 0
