"""PyTorch port, the discussion layer: core/orchestrator, consensus,
prompts and the session files, against the JAX package on the same
inputs.

- run_discussion in both packages with the same scripted fake knights,
  over the scenarios of tests/test_orchestrator.py, writes the same
  session files (transcript, status, discussion, decisions, topic,
  metrics, chronicle) but for timestamps, durations, the
  session directory's date and the project's path.
- parse_consensus_from_response gives the same block on every reply of
  tests/test_consensus.py, and the prompt builders give the same strings.
- The constructed checkpoint of tests/test_emergent_consensus.py, served
  through the port's torch-llm adapter on the CPU, ends in round 1 on the
  same decoded consensus block, transcript and decisions as the JAX run
  on tpu-llm."""

import ast
import dataclasses
import importlib
import json
import random
import re
from pathlib import Path

import pytest
import torch

from test_emergent_consensus import REPLY, consensus_ckpt  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("theroundtaible_tpu", "theroundtaible_tpu_torch")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mod(package: str, name: str):
    return importlib.import_module(f"{package}.{name}")


# --- session files, normalized ---

_TS = re.compile(r"\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}(\.\d+)?"
                 r"(Z|[+-]\d{2}:\d{2})?")
_SESSION_DATE = re.compile(r"\d{4}-\d{2}-\d{2}-\d{4}-")
_DURATION_KEYS = ("wall_s", "queue_wait_s", "decode_seconds",
                  "prefill_seconds", "decode_tps", "prefill_tps")


def _normalize_text(text: str, root: Path) -> str:
    text = text.replace(str(root), "<root>")
    text = _TS.sub("<ts>", text)
    text = _SESSION_DATE.sub("<date>-", text)
    # Dates in prose (chronicle / decree headings): YYYY-MM-DD
    text = re.sub(r"\d{4}-\d{2}-\d{2}", "<day>", text)
    return re.sub(r"\b\d+\.\d+s\b", "<dur>", text)


def _normalize_json(value):
    if isinstance(value, dict):
        return {k: ("<dur>" if k in _DURATION_KEYS or k.endswith("_at")
                    else _normalize_json(v)) for k, v in value.items()}
    if isinstance(value, list):
        return [_normalize_json(v) for v in value]
    return value


def session_files(root: Path) -> dict[str, object]:
    """Every file the discussion wrote under `.roundtable`, and the
    chronicle at the project's root, normalized."""
    out = {}
    paths = sorted((root / ".roundtable").rglob("*"))
    for path in paths + sorted(root.glob("*.md")):
        if not path.is_file() or path.name == "config.json":
            continue
        rel = _SESSION_DATE.sub("<date>-", str(path.relative_to(root)))
        text = _normalize_text(path.read_text(encoding="utf-8"), root)
        out[rel] = (_normalize_json(json.loads(text))
                    if path.suffix == ".json" else text)
    return out


# --- scenarios of tests/test_orchestrator.py, in both packages ---


def _two_knights(types):
    return [types.KnightConfig(name="A", adapter="fa", priority=1),
            types.KnightConfig(name="B", adapter="fb", priority=2)]


def _config(types, knights, rules=None, adapter_config=None):
    return types.RoundtableConfig(
        version="1.0", project="t", language="en", knights=knights,
        rules=rules or types.RulesConfig(max_rounds=3),
        chronicle="chronicle.md", adapter_config=adapter_config or {})


def scenario(name, pkg, root: Path):
    """(config, adapters, run kwargs) of one tests/test_orchestrator.py
    scenario built from `pkg`'s types."""
    types = mod(pkg, "core.types")
    fake = mod(pkg, "adapters.fake")
    F, s = fake.FakeAdapter, fake.scripted_response
    two = _two_knights(types)
    rules = types.RulesConfig
    if name == "consensus_first_round":
        return _config(types, two), {
            "fa": F("A", [s(9, proposal="Do X")]),
            "fb": F("B", [s(10)])}, {}
    if name == "consensus_in_later_round":
        return _config(types, two), {
            "fa": F("A", [s(5), s(9)]), "fb": F("B", [s(9), s(9)])}, {}
    if name == "unanimous_rejection":
        return _config(types, two), {
            "fa": F("A", [s(1, text="Terrible.")]),
            "fb": F("B", [s(2, text="Awful.")])}, {}
    if name == "escalation":
        return _config(types, two, rules(max_rounds=2)), {
            "fa": F("A", [s(5)]), "fb": F("B", [s(9)])}, {}
    if name == "crash_mid_round":
        return _config(types, two), {
            "fa": F("A", [RuntimeError("boom"), s(9)]),
            "fb": F("B", [s(9), s(9)])}, {}
    if name == "missing_adapter":
        return _config(types, two, rules(max_rounds=1)), {
            "fb": F("B", [s(9)])}, {}
    if name == "runtime_fallback":
        knights = [types.KnightConfig(name="A", adapter="fa", priority=1,
                                      fallback="fake")]
        return _config(types, knights, rules(max_rounds=1),
                       {"fake": {"name": "A"}}), {
            "fa": F("A", [RuntimeError("rate limited")])}, {}
    if name == "send_back_resume":
        return _config(types, two, rules(max_rounds=1)), {
            "fa": F("A", [s(5), s(9)]), "fb": F("B", [s(9), s(9)])}, {}
    if name == "file_requests":
        (root / "notes.txt").write_text("SECRET_CONTENT")
        return _config(types, two, rules(max_rounds=2)), {
            "fa": F("A", [s(5, file_requests=["notes.txt"]), s(9)]),
            "fb": F("B", [s(9), s(9)])}, {}
    if name == "verify_commands":
        (root / "data.txt").write_text("verify-me")
        return _config(types, two, rules(max_rounds=2)), {
            "fa": F("A", [s(5, verify_commands=["cat data.txt"]), s(9)]),
            "fb": F("B", [s(9), s(9)])}, {}
    if name == "source_budget":
        (root / "big.py").write_text("x" * 100_000)
        return _config(types, two, rules(max_rounds=1)), {
            "fa": F("A", [s(9)], max_source_chars=5_000),
            "fb": F("B", [s(9)])}, {"read_source_code": True}
    if name == "discussion_budget":
        return _config(types, two, rules(
            max_rounds=3, discussion_budget_seconds=1e-9)), {
            "fa": F("A", [s(9)]), "fb": F("B", [s(9)])}, {}
    if name == "batched_dispatch":
        class BatchFake(F):
            def supports_batched_rounds(self):
                return True

            def execute_round(self, turns, timeout_ms=0):
                self.batched_calls.append([t.prompt for t in turns])
                return [s(9) for _ in turns]

        knights = [types.KnightConfig(name="A", adapter="tpu", priority=1),
                   types.KnightConfig(name="B", adapter="tpu", priority=2)]
        return _config(types, knights,
                       rules(max_rounds=1, parallel_rounds=True)), {
            "tpu": BatchFake("Engine")}, {}
    raise KeyError(name)


SCENARIOS = ("consensus_first_round", "consensus_in_later_round",
             "unanimous_rejection", "escalation", "crash_mid_round",
             "missing_adapter", "runtime_fallback", "send_back_resume",
             "file_requests", "verify_commands", "source_budget",
             "discussion_budget", "batched_dispatch")


def run_scenario(name, pkg, root: Path):
    """Run the scenario in `pkg`; returns (result summary, every prompt
    each adapter saw, the session files)."""
    (root / ".roundtable" / "sessions").mkdir(parents=True)
    orch = mod(pkg, "core.orchestrator")
    types = mod(pkg, "core.types")
    config, adapters, kwargs = scenario(name, pkg, root)
    fakes = dict(adapters)
    result = orch.run_discussion("topic", config, adapters, str(root),
                                 rng=random.Random(0), **kwargs)
    if name == "send_back_resume":
        cont = types.ContinueOptions(
            session_path=result.session_path, all_rounds=result.all_rounds,
            start_round=result.rounds + 1,
            resolved_files=result.resolved_files,
            resolved_commands=result.resolved_commands)
        result = orch.run_discussion("topic", config, adapters, str(root),
                                     continue_from=cont,
                                     rng=random.Random(0))
    summary = {"consensus": result.consensus, "rounds": result.rounds,
               "rejection": result.unanimous_rejection,
               "decision": result.decision,
               "blocks": [dataclasses.asdict(b) for b in result.blocks],
               "seated": sorted(adapters)}
    prompts = {k: (a.calls, a.batched_calls) for k, a in fakes.items()}
    return summary, _normalize_json(json.loads(_normalize_text(
        json.dumps(prompts), root))), session_files(root)


@pytest.mark.parametrize("name", SCENARIOS)
def test_scripted_discussion_writes_the_same_session(name, tmp_path):
    runs = [run_scenario(name, pkg, tmp_path / pkg) for pkg in PACKAGES]
    (jax_summary, jax_prompts, jax_files), (summary, prompts, files) = runs
    assert summary == jax_summary
    assert prompts == jax_prompts
    assert files.keys() == jax_files.keys()
    assert any(k.endswith("status.json") for k in files)
    for key in files:
        assert files[key] == jax_files[key], key


def test_turns_reach_the_metrics_registry(tmp_path):
    from theroundtaible_tpu_torch.utils import telemetry
    run_scenario("escalation", PACKAGES[1], tmp_path)
    text = telemetry.REGISTRY.prometheus_text()
    assert 'roundtable_turns_total{knight="A"}' in text
    assert "roundtable_turn_wall_seconds_count" in text


@pytest.mark.parametrize("pkg", PACKAGES)
def test_rung_caps_bound_the_budget_tree(pkg, monkeypatch):
    deadlines = mod(pkg, "engine.deadlines")
    monkeypatch.setitem(deadlines._rung_caps, "round", 5.0)
    root = deadlines.Budget.root(None, rung="discussion")
    assert root.remaining() == float("inf")
    assert 0 < root.child("round").remaining() <= 5.0
    assert deadlines.rung_cap("round") == 5.0
    assert deadlines.rung_cap("turn") is None
    with pytest.raises(ValueError, match="unknown rung"):
        deadlines.configure_rungs({"nope": 1.0})


# --- consensus parsing and prompts ---


def _consensus_corpus() -> list[str]:
    """Every string literal of tests/test_consensus.py that could be a
    knight's reply (it holds a brace)."""
    tree = ast.parse((ROOT / "tests" / "test_consensus.py").read_text())
    out = [n.value for n in ast.walk(tree)
           if isinstance(n, ast.Constant) and isinstance(n.value, str)
           and "{" in n.value]
    assert len(out) > 15
    return out


def test_consensus_parsing_matches_on_every_sloppy_reply():
    jax_c = mod(PACKAGES[0], "core.consensus")
    port_c = mod(PACKAGES[1], "core.consensus")
    parsed = 0
    for reply in _consensus_corpus():
        want = jax_c.parse_consensus_from_response(reply, "Knight", 2)
        got = port_c.parse_consensus_from_response(reply, "Knight", 2)
        assert (got is None) == (want is None), reply
        if want is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            parsed += 1
        assert port_c.strip_consensus_json(reply) == \
            jax_c.strip_consensus_json(reply)
        assert port_c.repair_json(reply) == jax_c.repair_json(reply)
    assert parsed > 10


@pytest.mark.parametrize("language", ("en", "nl"))
def test_preamble_and_tail_strings_are_identical(language):
    built = []
    for pkg in PACKAGES:
        types = mod(pkg, "core.types")
        prompt = mod(pkg, "core.prompt")
        knights = [types.KnightConfig(name=n, adapter="fake",
                                      capabilities=["logic", "review"],
                                      priority=i + 1)
                   for i, n in enumerate(("Claude", "Gemini", "Someone"))]
        rounds = [types.RoundEntry(
            knight="Claude", round=1, response="I propose X.",
            timestamp="t", consensus=types.ConsensusBlock(
                knight="Claude", round=1, consensus_score=7,
                pending_issues=["cost"]))]
        preamble = prompt.build_shared_preamble(
            "Should we?", "# chronicle", rounds, "manifest", "decrees",
            language)
        tails = [prompt.build_knight_tail(k, knights, "Should we?",
                                          language) for k in knights]
        built.append((preamble, tails, prompt.scaffold_strings(language)))
    assert built[0] == built[1]
    assert "Should we?" in built[1][0]


# --- emergent consensus through torch-llm (the item-1 check) ---


def _emergent_config(types, adapter_id):
    return types.RoundtableConfig(
        version="1.0", project="emergent", language="en",
        knights=[types.KnightConfig(name=f"Knight-{c}", adapter=adapter_id,
                                    capabilities=[], priority=i + 1)
                 for i, c in enumerate("ABC")],
        rules=types.RulesConfig(max_rounds=5, consensus_threshold=9,
                                timeout_per_turn_seconds=300,
                                escalate_to_user_after=4,
                                auto_execute=False, parallel_rounds=True),
        chronicle="chronicle.md", adapter_config={adapter_id: {}})


ENGINE_CFG = {"model": "tiny-llama", "max_seq_len": 512, "num_slots": 4,
              "sampling": {"temperature": 0.0, "max_new_tokens": 16}}


def test_emergent_consensus_through_torch_llm(consensus_ckpt,  # noqa: F811
                                              tmp_path):
    ckpt, _ = consensus_ckpt
    topic = "Should the session store move to an append-only event log?"
    runs = {}
    for pkg, adapter_id in zip(PACKAGES, ("tpu-llm", "torch-llm")):
        root = tmp_path / pkg
        (root / ".roundtable" / "sessions").mkdir(parents=True)
        types = mod(pkg, "core.types")
        engine_pkg = mod(pkg, "engine")
        engine_pkg.reset_engines()
        config = {**ENGINE_CFG, "checkpoint": ckpt}
        if pkg == PACKAGES[0]:
            from theroundtaible_tpu.adapters.tpu_llm import TpuLlmAdapter
            adapter = TpuLlmAdapter(adapter_id, config)
        else:
            from theroundtaible_tpu_torch.adapters.torch_llm import \
                TorchLlmAdapter
            adapter = TorchLlmAdapter(adapter_id, config, device="cpu")
        try:
            result = mod(pkg, "core.orchestrator").run_discussion(
                topic, _emergent_config(types, adapter_id),
                {adapter_id: adapter}, str(root), read_source_code=False)
        finally:
            engine_pkg.reset_engines()
        runs[pkg] = (result, session_files(root))
    (jres, jfiles), (res, files) = runs[PACKAGES[0]], runs[PACKAGES[1]]
    assert res.consensus and res.rounds == 1 == jres.rounds
    assert [dataclasses.asdict(b) for b in res.blocks] == \
        [dataclasses.asdict(b) for b in jres.blocks]
    assert {b.consensus_score for b in res.blocks} == {9.5}
    assert res.decision == jres.decision
    keys = [k for k in files if k.endswith(("transcript.json",
                                            "decisions.md"))]
    assert len(keys) == 2
    for key in keys:
        assert files[key] == jfiles[key], key
    text = json.dumps(files[[k for k in keys
                             if k.endswith("transcript.json")][0]])
    assert text.count('\\"consensus_score\\": 9.5') >= 3
    assert REPLY.strip().splitlines()[0] in text
