"""PyTorch port, the CLI: `python -m theroundtaible_tpu_torch discuss`
against the JAX package's `discuss` on the same scratch project, the
argparse surface, `--continue`, the update check, and what is not ported.

- discuss with fake knights writes the same session files in both
  packages (normalized as in tests/test_torch_discuss.py); the port runs
  its package's `__main__` in a process of its own, the JAX CLI
  in-process. Both CLIs' update checks (a request to PyPI) are switched
  off, except where a test holds the port's with every connection
  refused; no vendor CLI is on PATH and no API key is set.
- discuss on torch-llm knights runs in-process on the CPU
  (`cli.main(argv, device="cpu")`) from a checkpoint.
- Every command the port does not serve exits non-zero naming its ROADMAP
  item. Telemetry arms (in-process and through ROUNDTABLE_TELEMETRY), as
  in the JAX package. Every adapter id seats its knight.
"""

import importlib
import io
import json
import os
import shutil
import subprocess
import threading
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


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    """No update check, no vendor CLI on PATH (git only), no API key, a
    private keystore."""
    monkeypatch.setattr(cli, "check_for_update", lambda cb: None)
    git = shutil.which("git")
    monkeypatch.setenv("PATH", str(Path(git).parent))
    for var in ("ANTHROPIC_API_KEY", "GEMINI_API_KEY", "OPENAI_API_KEY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("ROUNDTABLE_KEYS_DIR", str(tmp_path / "_keys"))


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


# The package's __main__ as `python -m` runs it, with the update check
# switched off first.
_MAIN = ("import runpy, sys\n"
         "from theroundtaible_tpu_torch import cli\n"
         "cli.check_for_update = lambda on_update: None\n"
         "sys.argv = ['theroundtaible_tpu_torch', *sys.argv[1:]]\n"
         "runpy.run_module('theroundtaible_tpu_torch', run_name='__main__',"
         " alter_sys=True)\n")


def run_port(root: Path, *argv: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-c", _MAIN, *argv], cwd=root,
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
    ["gateway", "--replicas", "2"], ["loadgen", "--smoke"],
    ["status", "--fleet"], ["lint"]])
def test_unported_commands_exit_nonzero_naming_the_item(argv, tmp_path,
                                                        monkeypatch,
                                                        capsys):
    """Every command is served now: `lint` (the last, item 7e-ii's slice
    1) runs and is clean on this checkout (tests/test_torch_lint.py holds
    its rules against JAX's). The session router's surfaces (item 7d-ii)
    run: `gateway --replicas 2` gets past its options and fails on this
    directory's missing config, `loadgen --smoke` sweeps (here over a
    stand-in run_capacity; tests/test_torch_loadgen.py runs the real one)
    and writes nothing, `status --fleet` renders."""
    from theroundtaible_tpu_torch.loadgen import bench
    from theroundtaible_tpu_torch.loadgen.capacity import build_record
    monkeypatch.chdir(tmp_path)

    def stand_in(**kw):
        assert kw["smoke"] and kw["device"] == "cpu"
        points = [{"offered_rps": r, "duration_s": 3.0, "arrivals": 10,
                   "admitted": 10 - shed, "shed": shed,
                   "shed_rate": shed / 10, "ttft_p50_s": 0.1,
                   "ttft_p95_s": 0.2, "ttft_p99_s": 0.3,
                   "accepted_tok_s": 4.0 * r,
                   "peak_concurrent_sessions": 2, "sessions_per_chip": 2.0}
                  for r, shed in ((3.0, 0), (6.0, 0), (12.0, 0), (24.0, 4))]
        record = build_record(points=points, arrival={"kind": "poisson"},
                              workload={}, seed=kw["seed"])
        return {"detail": {"frontier": record, "acceptance": {
            "meets": True}}}
    monkeypatch.setattr(bench, "run_capacity", stand_in)
    rc = cli.main(argv, device="cpu")
    out, err = capsys.readouterr()
    if argv[0] == "lint":
        assert rc == 0 and "roundtable lint: clean" in out
        assert "ROADMAP" not in err and not hasattr(cli, "_NOT_PORTED")
        return
    assert "ROADMAP" not in err
    if argv[0] == "gateway":
        assert rc != 0 and "config" in err.lower()
    elif argv[0] == "loadgen":
        assert rc == 0 and "Knee: 12.00 sessions/s" in out
        assert "no artifact written" in out
        assert list(tmp_path.iterdir()) == []
    else:
        assert rc == 0 and "Multi-replica serving" in out


def test_unported_command_through_the_module(tmp_path):
    """`python -m theroundtaible_tpu_torch loadgen --smoke` runs on the card
    by default: without one it exits nonzero saying so, having written
    nothing."""
    out = run_port(tmp_path, "loadgen", "--smoke")
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("adapter_id", [
    "claude-cli", "gemini-cli", "openai-cli", "claude-api", "gemini-api",
    "openai-api", "local-llm", "local-llm-qwen"])
def test_external_adapters_raise_naming_item_1b(adapter_id, tmp_path):
    """The external knights are ported (item 1b): each id builds the JAX
    factory's adapter class with the same settings, and with no tool on
    PATH, no key and no server, seating reports each knight unavailable
    (tests/test_torch_adapters_external.py holds them working)."""
    from theroundtaible_tpu.adapters import factory as jax_factory
    from theroundtaible_tpu.core.config import load_config as jax_load
    write_config(tmp_path, knights=[{"name": "A", "adapter": adapter_id,
                                     "capabilities": [], "priority": 1}],
                 adapter_config={adapter_id: {"endpoint": "http://127.0.0.1:9",
                                              "model": "y"}})
    ours = factory.create_adapter(adapter_id, load_config(tmp_path))
    ref = jax_factory.create_adapter(adapter_id, jax_load(tmp_path))
    assert type(ours).__name__ == type(ref).__name__
    assert vars(ours) == vars(ref)
    events = []
    assert factory.initialize_adapters(
        load_config(tmp_path), lambda kind, msg: events.append(kind),
        device="cpu") == {}
    assert events == ["unavailable"]


def test_discuss_with_an_unported_knight_exits_nonzero(tmp_path,
                                                       monkeypatch, capsys):
    """A claude-cli knight whose tool is missing, with no API key to fall
    back on: nobody is seated, and discuss exits with the config error."""
    write_config(tmp_path, knights=[{"name": "A", "adapter": "claude-cli",
                                     "capabilities": [], "priority": 1}])
    monkeypatch.chdir(tmp_path)
    assert cli.main(["discuss", "t", "--no-read-code"], device="cpu") == 2
    out = capsys.readouterr()
    assert "A (claude-cli) is unavailable" in out.out
    assert "no knights is just a table" in out.err


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
    """Fleet planning is ported (engine/fleet.plan_fleet): two engine
    knights on different models are planned before any engine is built -
    on the CPU one device, no memory limit to check (as JAX's CPU
    backend), so both groups are [0] - and seat with no notice."""
    events = []
    config = load_config(tmp_path)
    adapters = factory.initialize_adapters(
        config, lambda kind, msg: events.append((kind, msg)), device="cpu")
    assert len(adapters) == 2
    assert not [m for kind, m in events if kind == "unavailable"]
    assert all(config.adapter_config[a]["devices"] == [0]
               for a in ("torch-llm-a", "torch-llm-b"))


def test_telemetry_cannot_be_armed(monkeypatch):
    """Item 7c-i ported the span tracer: arming no longer raises. arm()
    and disarm() flip ACTIVE in-process, and ROUNDTABLE_TELEMETRY arms the
    module at import, as in the JAX package."""
    from theroundtaible_tpu_torch.utils import telemetry
    was = telemetry.ACTIVE
    try:
        telemetry.arm()
        assert telemetry.ACTIVE is True
        assert telemetry.span("turn") is not telemetry._NULL_SPAN
        telemetry.disarm()
        assert telemetry.ACTIVE is False
        assert telemetry.span("turn") is telemetry._NULL_SPAN
    finally:
        telemetry.ACTIVE = was
    env = dict(os.environ, PYTHONPATH=str(ROOT), ROUNDTABLE_TELEMETRY="1")
    out = subprocess.run(
        [sys.executable, "-c",
         "import theroundtaible_tpu_torch.utils.telemetry as t; "
         "print(t.ACTIVE)"],
        env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"


def test_cli_opens_no_connection(tmp_path, monkeypatch, capsys):
    """The CLI's only outward connection is the update check's request to
    PYPI_URL, made from a daemon thread as the JAX CLI makes it (every
    connection refused here): the refusal leaves discuss's rc and output
    as they are without the check, and a newer version on PyPI prints the
    JAX CLI's notice."""
    import socket
    import urllib.request

    from theroundtaible_tpu import cli as jax_cli
    from theroundtaible_tpu_torch.utils import update_check
    for var in ("http_proxy", "https_proxy", "HTTP_PROXY", "HTTPS_PROXY",
                "all_proxy", "ALL_PROXY", "no_proxy", "NO_PROXY"):
        monkeypatch.delenv(var, raising=False)
    attempts = []

    def refuse(address, *a, **kw):
        attempts.append((address, threading.current_thread()))
        raise ConnectionRefusedError("connections are refused here")
    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(socket, "getaddrinfo",
                        lambda host, port, *a, **kw: refuse((host, port)))
    monkeypatch.setattr(socket.socket, "connect",
                        lambda self, address: refuse(address))
    checks = []
    monkeypatch.setattr(cli, "check_for_update", lambda on_update: checks.append(
        update_check.check_for_update(on_update)))

    def discuss(root):
        write_config(root)
        monkeypatch.chdir(root)
        rc = cli.main(["discuss", "Should we do X?", "--no-read-code"],
                      device="cpu")
        for thread in checks:
            thread.join(timeout=30)
            assert not thread.is_alive()
        out = capsys.readouterr()
        return rc, out.out.replace(str(root), "<root>"), out.err
    checked = discuss(tmp_path / "checked")
    (thread,) = checks
    assert thread.daemon
    host = urllib.request.urlsplit(update_check.PYPI_URL).hostname
    assert [(address, t) for address, t in attempts] == [((host, 443),
                                                          thread)]
    checks.clear()
    monkeypatch.setattr(cli, "check_for_update", lambda on_update: None)
    assert checked == discuss(tmp_path / "unchecked")
    assert checked[0] == 0 and "actually agree" in checked[1]

    class Newer(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    asked = []
    monkeypatch.setattr(urllib.request, "urlopen", lambda url, timeout: (
        asked.append((url, timeout)) or Newer(b'{"info": {"version": "9.9"}}')))
    monkeypatch.setattr(cli, "check_for_update", lambda on_update: checks.append(
        update_check.check_for_update(on_update)))
    assert cli.main(["list"], device="cpu") == 0
    checks[0].join(timeout=30)
    jax_cli._print_update_notice(update_check.__version__, "9.9")
    notice = capsys.readouterr().err
    assert notice.count("Update available: 0.1.0 → 9.9") == 2
    assert notice[:len(notice) // 2] == notice[len(notice) // 2:]
    assert asked == [(update_check.PYPI_URL, 3)]
    assert update_check.PYPI_URL == \
        importlib.import_module("theroundtaible_tpu.utils.update_check").PYPI_URL


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
