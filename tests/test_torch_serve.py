"""PyTorch port, `roundtable serve`: concurrent discussions on one engine
behind one SessionScheduler, against the JAX package's serve_discussions
on the same weights (tests/test_scheduler.py's
test_serve_discussions_two_concurrent_scripted_sessions, on a paged
tiny-llama engine in f32 as tests/test_torch_scheduler.py runs it).

- Two sessions of one topic run concurrently through the orchestrator in
  both packages; the port's adapters are torch-llm knights over an engine
  built from the JAX engine's weights on the CPU. Both share one
  scheduler (admitted >= 2, max_occupancy > 1), their session
  directories differ, and every (session, knight) greedy response is the
  JAX run's.
- `serve --journal`, `--resume` and `--replicas 2` raise naming their
  ROADMAP items before any engine is built.
"""

import io
import json
import sys

import jax
import pytest
import torch

from theroundtaible_tpu_torch import cli
from theroundtaible_tpu_torch.core.errors import ITEM_7C, ITEM_7D

ENGINE_CFG = {"model": "tiny-llama", "max_seq_len": 512, "num_slots": 8,
              "kv_layout": "paged", "page_size": 32, "dtype": "float32",
              "prefix_cache": False, "kv_offload": False,
              "spec_decode": False,
              "sampling": {"temperature": 0.0, "max_new_tokens": 24}}
TOPICS = ["Topic one for the table", "Topic one for the table"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config_of(types):
    return types.RoundtableConfig(
        version="1.0", project="t", language="en",
        knights=[types.KnightConfig(name=f"Knight-{c}", adapter="tpu-llm",
                                    capabilities=[], priority=i + 1)
                 for i, c in enumerate("AB")],
        rules=types.RulesConfig(max_rounds=1, consensus_threshold=9,
                                timeout_per_turn_seconds=120,
                                escalate_to_user_after=4,
                                auto_execute=False, parallel_rounds=True),
        chronicle="chronicle.md", adapter_config={"tpu-llm": {}})


def scripted(base, types, engine=None):
    """The engine adapter of `base`'s package whose knights always agree
    (the JAX test's Scripted), on `engine` when one is given."""
    class Scripted(base):
        def parse_consensus(self, response, round_num):
            return types.ConsensusBlock(
                knight=self.name, round=round_num, consensus_score=9.5,
                agrees_with=[], pending_issues=[], proposal="p",
                files_to_modify=["x.md"])

        if engine is not None:
            def _get_engine(self, retry_construction=False):
                return engine
    return Scripted


def responses(report) -> dict:
    """{(session index, knight): response} of a serve report."""
    out = {}
    for i, entry in enumerate(report["sessions"]):
        assert entry["ok"], entry.get("error")
        for e in entry["result"].all_rounds:
            out[(i, e.knight)] = e.response
    return out


def jax_serve(root):
    from theroundtaible_tpu.adapters import factory
    from theroundtaible_tpu.adapters.tpu_llm import TpuLlmAdapter
    from theroundtaible_tpu.commands.serve import serve_discussions
    from theroundtaible_tpu.core import types
    from theroundtaible_tpu.engine import get_engine, reset_engines
    reset_engines()
    cls = scripted(TpuLlmAdapter, types)
    real = factory.create_adapter
    factory.create_adapter = lambda adapter_id, cfg, timeout_ms: (
        cls("tpu-llm", ENGINE_CFG, timeout_ms)
        if adapter_id.startswith("tpu-llm") else real(adapter_id, cfg,
                                                      timeout_ms))
    try:
        report = serve_discussions(TOPICS, config_of(types), str(root),
                                   admit_hold_s=0.4)
        params = jax.device_get(get_engine(ENGINE_CFG).params)
    finally:
        factory.create_adapter = real
        reset_engines()
    return report, params


def port_serve(root, params, monkeypatch):
    from theroundtaible_tpu_torch.adapters import factory
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    from theroundtaible_tpu_torch.commands.serve import serve_discussions
    from theroundtaible_tpu_torch.core import types
    from theroundtaible_tpu_torch.engine.engine import InferenceEngine
    from theroundtaible_tpu_torch.engine.models.registry import \
        get_model_config
    from theroundtaible_tpu_torch.engine.sampling import SamplingParams
    from theroundtaible_tpu_torch.engine.weights import params_from_numpy
    cfg = get_model_config("tiny-llama", max_seq_len=512)
    engine = InferenceEngine(
        cfg, num_slots=8, kv_layout="paged", page_size=32,
        dtype=torch.float32,
        sampling=SamplingParams(temperature=0.0, max_new_tokens=24),
        params=params_from_numpy(params, cfg, torch.float32, "cpu"),
        device="cpu")
    cls = scripted(TorchLlmAdapter, types, engine)
    real = factory.create_adapter
    monkeypatch.setattr(
        factory, "create_adapter",
        lambda adapter_id, c, timeout_ms, device="cuda": (
            cls("tpu-llm", ENGINE_CFG, timeout_ms, device=device)
            if adapter_id.startswith("tpu-llm")
            else real(adapter_id, c, timeout_ms, device)))
    report = serve_discussions(TOPICS, config_of(types), str(root),
                               admit_hold_s=0.4, device="cpu")
    return report, engine


def test_serve_discussions_equals_jax(tmp_path, monkeypatch):
    for tag in ("jax", "port"):
        (tmp_path / tag / ".roundtable" / "sessions").mkdir(parents=True)
    ref, params = jax_serve(tmp_path / "jax")
    report, engine = port_serve(tmp_path / "port", params, monkeypatch)
    assert all(e["ok"] for e in report["sessions"]), report["sessions"]
    assert all(e["result"].consensus for e in report["sessions"])
    assert len(report["schedulers"]) == 1
    prov = report["schedulers"][0]
    assert prov["admitted"] >= 2 and prov["max_occupancy"] > 1
    assert prov["completed"] == prov["admitted"] and prov["failed"] == 0
    assert engine._scheduler.closed
    paths = {e["session_path"] for e in report["sessions"]}
    assert len(paths) == 2
    assert [e["topic"] for e in report["sessions"]] == \
        [e["topic"] for e in ref["sessions"]]
    ours = responses(report)
    assert sorted(ours) == [(i, f"Knight-{c}") for i in (0, 1)
                            for c in "AB"]
    assert ours == responses(ref)


def test_serve_command_through_the_cli(tmp_path, monkeypatch, capsys):
    """`serve "<topic>" --sessions 2` through cli.main with scripted fake
    knights (no engine: the scheduler path is held above): two session
    directories, rc 0, one line per session; a topic count that does not
    match --sessions is a config error."""
    root = tmp_path / "proj"
    (root / ".roundtable" / "sessions").mkdir(parents=True)
    (root / ".roundtable" / "config.json").write_text(json.dumps({
        "version": "1.0", "project": "t", "language": "en",
        "knights": [{"name": n, "adapter": "fake", "capabilities": [],
                     "priority": i + 1} for i, n in enumerate("AB")],
        "rules": {"max_rounds": 2, "consensus_threshold": 9,
                  "timeout_per_turn_seconds": 5, "escalate_to_user_after": 3,
                  "auto_execute": False, "ignore": [".git"]},
        "chronicle": "chronicle.md", "adapter_config": {"fake": {}}}))
    monkeypatch.setattr(cli, "check_for_update", lambda cb: None)
    monkeypatch.chdir(root)
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    assert cli.main(["serve", "Should we?", "--sessions", "2",
                     "--no-read-code"], device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("consensus in 1 round(s)") == 2
    assert len(list((root / ".roundtable" / "sessions").iterdir())) == 2
    assert cli.main(["serve", "a", "b", "c", "--sessions", "2"],
                    device="cpu") == 2
    assert "--sessions 2 with 3 topics" in capsys.readouterr().err
    assert cli.main(["serve"], device="cpu") == 2


@pytest.mark.parametrize("argv,item", [
    (["--journal", "j"], ITEM_7C), (["--resume", "r"], ITEM_7C),
    (["--replicas", "2"], ITEM_7D)], ids=["journal", "resume", "replicas"])
def test_unported_serve_options_raise_before_any_engine(argv, item, tmp_path,
                                                        monkeypatch, capsys):
    from theroundtaible_tpu_torch import engine as port_engine
    from theroundtaible_tpu_torch.commands.serve import serve_discussions

    def no_engine(*a, **kw):
        raise AssertionError("an engine was built")
    monkeypatch.setattr(port_engine, "get_engine", no_engine)
    monkeypatch.setattr(cli, "check_for_update", lambda cb: None)
    monkeypatch.chdir(tmp_path)     # no config either: the option is first
    rc = cli.main(["serve", "t", "--sessions", "2", *argv], device="cpu")
    err = capsys.readouterr().err
    assert rc != 0
    assert f"`serve {argv[0]}" in err and f"ROADMAP, {item.split(':')[0]}" \
        in err
    if argv[0] != "--resume":
        with pytest.raises(NotImplementedError, match=item.split(":")[0]):
            serve_discussions(["t"], None, str(tmp_path), device="cpu",
                              **({"journal_dir": "j"}
                                 if argv[0] == "--journal"
                                 else {"replicas": 2}))
