"""PyTorch port, the CLI: `python -m theroundtaible_tpu_torch discuss`
against the JAX package's `discuss` on the same scratch project, the
argparse surface, `--continue`, and what is not ported.

- discuss with fake knights writes the same session files in both
  packages (normalized as in tests/test_torch_discuss.py); the port runs
  as a real `python -m` process, the JAX CLI in-process with its update
  check switched off (it would reach for the network).
- discuss on torch-llm knights runs in-process on the CPU
  (`cli.main(argv, device="cpu")`) from a checkpoint.
- Every command the port does not serve, and every adapter id, exits
  non-zero or raises naming its ROADMAP item; so does arming telemetry.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_discuss import session_files
from theroundtaible_tpu_torch import cli
from theroundtaible_tpu_torch.adapters import factory
from theroundtaible_tpu_torch.core.config import load_config

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers: keep this file's torch CPU math
    on one thread so it does not crowd the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_config(root: Path, knights=None, adapter_config=None,
                 rules=None) -> dict:
    cfg = {
        "version": "1.0", "project": "t", "language": "en",
        "knights": knights or [
            {"name": "A", "adapter": "fake", "capabilities": [],
             "priority": 1},
            {"name": "B", "adapter": "fake", "capabilities": [],
             "priority": 2}],
        "rules": rules or {
            "max_rounds": 2, "consensus_threshold": 9,
            "timeout_per_turn_seconds": 5, "escalate_to_user_after": 3,
            "auto_execute": False, "ignore": [".git"]},
        "chronicle": "chronicle.md",
        "adapter_config": adapter_config or {"fake": {"name": "A"}},
    }
    (root / ".roundtable" / "sessions").mkdir(parents=True, exist_ok=True)
    (root / ".roundtable" / "config.json").write_text(json.dumps(cfg))
    return cfg


def run_port(root: Path, *argv: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-m", "theroundtaible_tpu_torch", *argv], cwd=root,
        env=env, stdin=subprocess.DEVNULL, capture_output=True, text=True,
        timeout=120)


def run_jax(root: Path, monkeypatch, *argv: str) -> int:
    import theroundtaible_tpu.cli as jax_cli
    monkeypatch.setattr(jax_cli, "check_for_update", lambda cb: None)
    monkeypatch.chdir(root)
    return jax_cli.main(list(argv))


def test_discuss_module_writes_the_jax_session(tmp_path, monkeypatch):
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    for root in (port_root, jax_root):
        write_config(root)
    out = run_port(port_root, "discuss", "Should we do X?",
                   "--no-read-code")
    assert out.returncode == 0, out.stderr
    assert "actually agree" in out.stdout
    assert run_jax(jax_root, monkeypatch, "discuss", "Should we do X?",
                   "--no-read-code") == 0
    files, jax_files = session_files(port_root), session_files(jax_root)
    assert any(k.endswith("decisions.md") for k in files)
    assert files == jax_files


def test_continue_resumes_as_in_jax(tmp_path, monkeypatch, capsys):
    """`discuss --continue` as tests/test_commands.py holds the JAX
    CLI's: nothing to resume, a crashed session resumed in place, a
    finished one refused."""
    from theroundtaible_tpu_torch.adapters.fake import scripted_response
    from theroundtaible_tpu_torch.core.types import (ConsensusBlock,
                                                     RoundEntry)
    from theroundtaible_tpu_torch.utils.session import (create_session,
                                                        update_status,
                                                        write_transcript)
    root = tmp_path / "port"
    write_config(root)
    monkeypatch.chdir(root)
    assert cli.main(["discuss", "--continue", "--no-read-code"],
                    device="cpu") == 1
    assert "No sessions to continue" in capsys.readouterr().out
    sp = create_session(root, "an unfinished topic")
    write_transcript(sp, [RoundEntry("A", 1, scripted_response(5),
                                     ConsensusBlock("A", 1, 5), "ts")])
    update_status(sp, phase="discussing", round=1)
    assert cli.main(["discuss", "--continue", "--no-read-code"],
                    device="cpu") == 0
    out = capsys.readouterr().out
    assert "Resuming" in out and "actually agree" in out
    assert (sp / "decisions.md").exists()
    assert cli.main(["discuss", "--continue", "--no-read-code"],
                    device="cpu") == 1
    assert "not resumable" in capsys.readouterr().out


def test_parser_is_the_jax_parser():
    from theroundtaible_tpu.cli import build_parser as jax_parser

    def surface(parser):
        out = {}
        for action in parser._actions:
            if getattr(action, "choices", None) and isinstance(
                    action.choices, dict):
                for name, sub in action.choices.items():
                    out[name] = surface(sub)
            else:
                out[tuple(action.option_strings) or action.dest] = (
                    action.dest, action.nargs, action.default)
        return out

    assert surface(cli.build_parser()) == surface(jax_parser())


@pytest.mark.parametrize("argv", [
    ["init"], ["serve", "t"], ["summon"], ["status"], ["list"],
    ["chronicle"], ["decrees"], ["manifest", "list"], ["apply"],
    ["code-red", "x"], ["warmup"], ["gateway"], ["loadgen", "--smoke"],
    ["trace", "list"], ["lint"]])
def test_unported_commands_exit_nonzero_naming_the_item(argv, tmp_path,
                                                        monkeypatch,
                                                        capsys):
    monkeypatch.chdir(tmp_path)
    rc = cli.main(argv, device="cpu")
    err = capsys.readouterr().err
    assert rc != 0
    item = cli._NOT_PORTED[argv[0]].split(":")[0]
    assert f"ROADMAP, {item}" in err and f"roundtable {argv[0]}" in err


def test_unported_command_through_the_module(tmp_path):
    out = run_port(tmp_path, "status")
    assert out.returncode != 0
    assert "item 1b" in out.stderr


@pytest.mark.parametrize("adapter_id", [
    "claude-cli", "gemini-cli", "openai-cli", "claude-api", "gemini-api",
    "openai-api", "local-llm", "local-llm-qwen"])
def test_external_adapters_raise_naming_item_1b(adapter_id, tmp_path):
    write_config(tmp_path, knights=[{"name": "A", "adapter": adapter_id,
                                     "capabilities": [], "priority": 1}],
                 adapter_config={adapter_id: {"endpoint": "x",
                                              "model": "y"}})
    config = load_config(tmp_path)
    with pytest.raises(NotImplementedError, match="item 1b"):
        factory.create_adapter(adapter_id, config)
    with pytest.raises(NotImplementedError, match="item 1b"):
        factory.initialize_adapters(config, device="cpu")


def test_discuss_with_an_unported_knight_exits_nonzero(tmp_path,
                                                       monkeypatch, capsys):
    write_config(tmp_path, knights=[{"name": "A", "adapter": "claude-cli",
                                     "capabilities": [], "priority": 1}])
    monkeypatch.chdir(tmp_path)
    assert cli.main(["discuss", "t", "--no-read-code"], device="cpu") != 0
    assert "item 1b" in capsys.readouterr().err


def test_engine_ids_seat_torch_llm_knights_on_the_requested_device(
        tmp_path):
    from theroundtaible_tpu_torch.adapters.torch_llm import TorchLlmAdapter
    write_config(tmp_path, knights=[
        {"name": "A", "adapter": "tpu-llm-claude", "capabilities": [],
         "priority": 1},
        {"name": "B", "adapter": "torch-llm", "capabilities": [],
         "priority": 2}],
        adapter_config={"tpu-llm-claude": {"model": "tiny-llama"},
                        "torch-llm": {"model": "tiny-llama"}})
    config = load_config(tmp_path)
    events = []
    adapters = factory.initialize_adapters(
        config, lambda kind, msg: events.append((kind, msg)), device="cpu")
    assert set(adapters) == {"tpu-llm-claude", "torch-llm"}
    assert all(isinstance(a, TorchLlmAdapter) and a.device == "cpu"
               for a in adapters.values())
    assert not any(kind == "unavailable" for kind, _ in events)


def test_heterogeneous_engine_knights_hear_fleet_planning_is_unported(
        tmp_path):
    write_config(tmp_path, knights=[
        {"name": "A", "adapter": "torch-llm-a", "capabilities": [],
         "priority": 1},
        {"name": "B", "adapter": "torch-llm-b", "capabilities": [],
         "priority": 2}],
        adapter_config={"torch-llm-a": {"model": "tiny-llama"},
                        "torch-llm-b": {"model": "tiny-gemma"}})
    events = []
    adapters = factory.initialize_adapters(
        load_config(tmp_path), lambda kind, msg: events.append((kind, msg)),
        device="cpu")
    assert len(adapters) == 2
    notices = [m for kind, m in events if kind == "unavailable"]
    assert len(notices) == 1
    assert "item 7e-ii" in notices[0] and "share the card" in notices[0]


def test_telemetry_cannot_be_armed(monkeypatch):
    from theroundtaible_tpu_torch.utils import telemetry
    with pytest.raises(NotImplementedError, match="item 7c"):
        telemetry.arm()
    assert telemetry.ACTIVE is False
    env = dict(os.environ, PYTHONPATH=str(ROOT), ROUNDTABLE_TELEMETRY="1")
    out = subprocess.run(
        [sys.executable, "-c",
         "import theroundtaible_tpu_torch.utils.telemetry"],
        env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and "item 7c" in out.stderr


def test_cli_opens_no_connection(tmp_path, monkeypatch):
    """The port's CLI reaches for no outside host: the JAX CLI's update
    check is not ported yet (item 1b), and a discussion with local knights
    opens no socket."""
    import socket
    assert not hasattr(cli, "check_for_update")

    def refuse(*a, **kw):
        raise AssertionError("the CLI reached for the network")
    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)
    write_config(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["discuss", "Should we do X?", "--no-read-code"],
                    device="cpu") == 0


def test_discuss_on_torch_llm_knights_from_a_checkpoint(tmp_path,
                                                        monkeypatch,
                                                        capsys):
    """The main path on the CPU: cli.main(..., device="cpu") seats three
    torch-llm knights on one engine built from an HF checkpoint (trained
    BPE tokenizer included) and runs both rounds to escalation; round 2
    reuses round 1's tokens."""
    from conftest import make_tiny_hf_llama, save_trained_tokenizer
    from theroundtaible_tpu_torch.engine import reset_engines
    ckpt = tmp_path / "ckpt"
    save_trained_tokenizer(ckpt)
    make_tiny_hf_llama(512, seed=4).save_pretrained(
        ckpt, safe_serialization=True)
    knights = [{"name": n, "adapter": "torch-llm", "capabilities": [],
                "priority": i + 1} for i, n in enumerate("ABC")]
    root = tmp_path / "project"
    write_config(root, knights=knights, adapter_config={"torch-llm": {
        "model": "tiny-llama", "checkpoint": str(ckpt), "max_seq_len": 4096,
        "num_slots": 8, "kv_layout": "paged", "page_size": 32,
        "quant": "int8",
        "knight_sampling": {n: {"max_new_tokens": 8} for n in "ABC"}}},
        rules={"max_rounds": 2, "consensus_threshold": 9,
               "timeout_per_turn_seconds": 300, "escalate_to_user_after": 3,
               "auto_execute": False, "parallel_rounds": True})
    monkeypatch.chdir(root)
    # the King's menu after escalation reads an empty stdin: adjourned
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    reset_engines()
    try:
        rc = cli.main(["discuss", "event log or snapshots?",
                       "--no-read-code"], device="cpu")
    finally:
        reset_engines()
    out = capsys.readouterr()
    assert rc == 0, out.err
    (session,) = (root / ".roundtable" / "sessions").iterdir()
    transcript = json.loads((session / "transcript.json").read_text())
    assert sorted((e["round"], e["knight"]) for e in transcript) == [
        (r, k) for r in (1, 2) for k in "ABC"]
    metrics = json.loads((session / "metrics.json").read_text())
    engine_stats = [t["engine"] for r in metrics["rounds"]
                    for t in r["turns"] if t.get("engine")]
    assert len(engine_stats) == 2 and engine_stats[1]["reused_tokens"] > 0
    assert json.loads((session / "status.json").read_text())["phase"] == \
        "escalated"
    assert "King waves dismissively" in out.out
