"""PyTorch port, the CLI's other commands against the JAX package's on the
same projects: the parsers, `summon`, `code-red` with the error log, the
read-only commands (`status`, `list`, `chronicle`, `decrees`, `manifest`),
`init`, `warmup` and `local_detect`.

- Both CLIs run in-process (`cli.main(argv)`, the port's with
  device="cpu") with their update checks switched off; knights are the
  scripted `fake` adapter, patched into each package's factory where a
  test scripts them.
- Sessions, error logs, manifests and stdout are compared normalized as
  tests/test_torch_discuss.py normalizes session files (timestamps,
  session dates, the project's path).
- External tools are kept out: PATH holds only git, no API key is set,
  and the engine probe runs on the switches the JAX package reads.
"""

import importlib
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest
import torch

from test_code_red import DIAG_RESPONSE, TRIAGE_RESPONSE
from test_torch_cli import write_config
from test_torch_discuss import _normalize_text, session_files
from theroundtaible_tpu_torch.adapters.fake import (
    scripted_response as fake_response)

PACKAGES = ("theroundtaible_tpu", "theroundtaible_tpu_torch")
PORT = PACKAGES[1]
GIT = shutil.which("git")


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    """No vendor CLI on PATH, no API key, no keystore, one torch thread."""
    tools = tmp_path / "_path"
    tools.mkdir()
    monkeypatch.setenv("PATH", f"{tools}{os.pathsep}{Path(GIT).parent}")
    for var in ("ANTHROPIC_API_KEY", "GEMINI_API_KEY", "OPENAI_API_KEY",
                "ROUNDTABLE_FORCE_TPU_DETECT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("ROUNDTABLE_KEYS_DIR", str(tmp_path / "_keys"))
    monkeypatch.setenv("ROUNDTABLE_DISABLE_TPU_DETECT", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tools
    torch.set_num_threads(n)


def run_cli(pkg, argv, root, monkeypatch, capsys, stdin=""):
    """`pkg`'s cli.main(argv) in `root`, its update check off: (rc,
    stdout, stderr) with the project's path normalized."""
    cli = importlib.import_module(f"{pkg}.cli")
    monkeypatch.setattr(cli, "check_for_update", lambda cb: None)
    monkeypatch.chdir(root)
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    rc = cli.main(argv, **({"device": "cpu"} if pkg == PORT else {}))
    out = capsys.readouterr()
    return (rc, _normalize_text(out.out, root),
            _normalize_text(out.err, root))


def git(root: Path, *args: str) -> None:
    subprocess.run([GIT, "-c", "user.email=t@localhost", "-c",
                    "user.name=t", *args], cwd=root, check=True,
                   capture_output=True, timeout=60)


def scripted_factory(monkeypatch, pkg, scripts: dict) -> None:
    """`fake-<name>` ids seat FakeAdapters answering scripts[name][i]
    for the i-th adapter built for that id (code-red builds one, its
    "fix now" apply another)."""
    factory = importlib.import_module(f"{pkg}.adapters.factory")
    fake = importlib.import_module(f"{pkg}.adapters.fake")
    built: dict = {}

    def create(adapter_id, config, timeout_ms, *device):
        for name, per_build in scripts.items():
            if adapter_id == f"fake-{name}":
                i = built[name] = built.get(name, -1) + 1
                return fake.FakeAdapter(
                    name=name, script=per_build[min(i, len(per_build) - 1)])
        return None
    monkeypatch.setattr(factory, "create_adapter", create)


# --- the parsers ---

ARGVS = [
    ["init"], ["discuss", "t"], ["discuss", "--continue", "--read-code"],
    ["serve", "a", "b", "--sessions", "2", "--no-read-code"],
    ["serve", "t", "--journal", "j", "--resume", "r", "--replicas", "3"],
    ["gateway", "--host", "h", "--port", "0", "--replicas", "2"],
    ["summon", "--read-code"], ["loadgen", "--smoke", "--rates", "1,2"],
    ["status", "--telemetry", "--perf", "--kv", "--health", "--gateway",
     "--capacity", "--fleet", "--slo"],
    ["trace", "show", "abc", "--dir", "d"], ["list"], ["chronicle"],
    ["decrees"], ["manifest"], ["manifest", "list"],
    ["manifest", "add", "--id", "f", "--files", "a,b", "--status",
     "partial"], ["manifest", "deprecate", "f", "--replaced-by", "g"],
    ["manifest", "check"],
    ["apply", "--noparley", "--dry-run", "--override-scope", "--session",
     "s"], ["code-red", "it broke"], ["warmup"],
    ["lint", "--rules", "A,B", "--jaxpr", "--json", "--root", "r"]]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a))
def test_parser_parses_as_jax(argv):
    from theroundtaible_tpu.cli import build_parser as jax_parser
    from theroundtaible_tpu_torch.cli import build_parser
    assert vars(build_parser().parse_args(argv)) == \
        vars(jax_parser().parse_args(argv))


def test_every_subcommand_and_option_is_the_jax_parsers():
    from theroundtaible_tpu.cli import build_parser as jax_parser
    from theroundtaible_tpu_torch.cli import build_parser

    def subparsers(parser):
        (sub,) = [a for a in parser._actions
                  if isinstance(getattr(a, "choices", None), dict)]
        return sub.choices

    ours, ref = subparsers(build_parser()), subparsers(jax_parser())
    assert list(ours) == list(ref)
    for name in ref:
        assert [(a.option_strings, a.dest, a.nargs, a.default, a.choices
                 if not isinstance(a.choices, dict) else sorted(a.choices))
                for a in ours[name]._actions] == \
            [(a.option_strings, a.dest, a.nargs, a.default, a.choices
              if not isinstance(a.choices, dict) else sorted(a.choices))
             for a in ref[name]._actions]


def test_only_the_serving_tier_and_lint_are_not_ported():
    from theroundtaible_tpu_torch import cli
    assert set(cli._NOT_PORTED) == {"gateway", "loadgen", "trace", "lint"}


# --- summon ---

def summon_project(root: Path, change: bool) -> None:
    root.mkdir(parents=True)
    git(root, "init", "-q")
    (root / "app.py").write_text("def f():\n    return 1\n")
    git(root, "add", "app.py")
    git(root, "commit", "-q", "-m", "first")
    write_config(root)
    if change:
        (root / "app.py").write_text("def f():\n    return 2\n")
        git(root, "add", "app.py")


@pytest.mark.parametrize("change", [True, False], ids=["diff", "clean"])
def test_summon_writes_the_jax_session(change, tmp_path, monkeypatch,
                                       capsys):
    out = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg / "proj"
        summon_project(root, change)
        rc, stdout, _ = run_cli(pkg, ["summon", "--no-read-code"], root,
                                monkeypatch, capsys)
        out[pkg] = (rc, session_files(root.parent / "proj"))
        assert rc == 0
        if not change:
            assert "Nothing to review" in stdout
    assert out[PORT] == out[PACKAGES[0]]
    topics = [v for k, v in out[PORT][1].items() if k.endswith("topic.md")]
    if change:
        (topic,) = topics
        assert 'branch "' in topic and "1 file(s) changed" in topic
        assert "diff --git a/app.py b/app.py" in topic
        assert "- return 1 + return 2" in topic
    else:
        assert topics == []


# --- code-red and the error log ---

def code_red_project(root: Path) -> None:
    root.mkdir(parents=True)
    (root / "app.py").write_text("x = 1\n")
    write_config(root, knights=[
        {"name": n, "adapter": f"fake-{n}", "capabilities": [],
         "priority": i + 1} for i, n in enumerate("AB")],
        adapter_config={f"fake-{n}": {"name": n} for n in "AB"},
        rules={"max_rounds": 4, "consensus_threshold": 9,
               "timeout_per_turn_seconds": 10, "escalate_to_user_after": 3,
               "auto_execute": False, "ignore": []})


class Tty(io.StringIO):
    """Scripted stdin that reports a terminal, for the outcome menu."""

    def isatty(self):
        return True


FIX = ("RTDIFF/1\nFILE: app.py\nBLOCK_REPLACE B001\n<<<\nx = 2\n>>>\n")
OTHER = DIAG_RESPONSE.replace("stale-cache-key", "totally-other-cause")
CODE_RED = {
    # name: (scripts per doctor: one list per adapter build, stdin - a
    # terminal's after "tty:" -, rc)
    "converged": ({n: [[TRIAGE_RESPONSE, DIAG_RESPONSE]] for n in "AB"},
                  "", 0),
    "no_convergence": ({"A": [[TRIAGE_RESPONSE, DIAG_RESPONSE]],
                        "B": [[TRIAGE_RESPONSE, OTHER]]}, "", 1),
    "fix_now": ({"A": [[TRIAGE_RESPONSE, DIAG_RESPONSE], [FIX]],
                 "B": [[TRIAGE_RESPONSE, DIAG_RESPONSE], [FIX]]},
                "tty:1\ny\n", 0),
    "fix_now_unparseable": ({n: [[TRIAGE_RESPONSE, DIAG_RESPONSE]]
                             for n in "AB"}, "tty:1\n", 0),
    "log_for_later": ({n: [[TRIAGE_RESPONSE, DIAG_RESPONSE]] for n in "AB"},
                      "tty:3\n", 0),
    "a_doctor_fails": ({"A": [[TRIAGE_RESPONSE, DIAG_RESPONSE]],
                        "B": [[RuntimeError("connection reset")]]}, "", 1),
}


@pytest.mark.parametrize("name", CODE_RED)
def test_code_red_equals_jax(name, tmp_path, monkeypatch, capsys):
    scripts, stdin, expected = CODE_RED[name]
    out = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg / "proj"
        code_red_project(root)
        scripted_factory(monkeypatch, pkg, scripts)
        cli = importlib.import_module(f"{pkg}.cli")
        monkeypatch.setattr(cli, "check_for_update", lambda cb: None)
        monkeypatch.chdir(root)
        monkeypatch.setattr(sys, "stdin", Tty(stdin[4:])
                            if stdin.startswith("tty:") else
                            io.StringIO(stdin))
        rc = cli.main(["code-red", "login crashes on submit"],
                      **({"device": "cpu"} if pkg == PORT else {}))
        stdout = _normalize_text(capsys.readouterr().out, root)
        out[pkg] = (rc, stdout, session_files(root),
                    (root / "app.py").read_text())
    assert out[PORT] == out[PACKAGES[0]]
    rc, stdout, files, app = out[PORT]
    assert rc == expected
    log = files[".roundtable/error-log.md"]
    if name == "no_convergence":
        assert "could not agree" in stdout and "**Status:** OPEN" in log
    if name == "fix_now":
        assert app == "x = 2\n" and "**Status:** RESOLVED" in log
    if name == "fix_now_unparseable":
        assert "Surgery failed" in stdout and "**Status:** OPEN" in log
    if name == "log_for_later":
        assert "**Status:** PARKED" in log
    if name == "converged":
        assert "DIAGNOSIS CONVERGED: stale-cache-key" in stdout


def test_error_log_equals_jax(tmp_path):
    logs = {}
    for pkg in PACKAGES:
        el = importlib.import_module(f"{pkg}.utils.error_log")
        root = tmp_path / pkg
        root.mkdir()
        ids = [el.next_cr_id(root),
               el.add_error_entry(root, "login broken", None),
               el.add_error_entry(root, "slow page", "cache key", "PARKED",
                                  session="s1"),
               el.add_error_entry(root, "crash", "null deref",
                                  session="s2")]
        flips = [el.set_entry_status(root, "CR-002", "RESOLVED"),
                 el.set_entry_status(root, "CR-009", "OPEN")]
        logs[pkg] = (ids, flips, el.count_by_status(root),
                     el.read_error_log(root))
    assert logs[PORT] == logs[PACKAGES[0]]
    ids, flips, counts, _ = logs[PORT]
    assert ids == ["CR-001", "CR-001", "CR-002", "CR-003"]
    assert flips == [True, False]
    assert counts == {"OPEN": 2, "RESOLVED": 1, "PARKED": 0}


# --- discuss: the King's "apply now" ---

APPLY_NOW = {
    # name: (the Lead Knight's answer at apply, expected in stdout)
    "applied": (FIX, "The decision has been carried out"),
    "unparseable": ("I would rather not write code today.",
                    "Apply failed"),
}


@pytest.mark.parametrize("name", APPLY_NOW)
def test_kings_apply_now_equals_jax(name, tmp_path, monkeypatch, capsys):
    """Two scripted knights agree in round one on app.py; the King
    answers "1" (apply now) and "a" (write all) at a terminal. Both
    packages write the same files, manifest entry, status and stdout; an
    unparseable Lead Knight output leaves discuss at rc 0 with "Apply
    failed" and nothing written."""
    response, expect = APPLY_NOW[name]
    agree = fake_response(9, files=["app.py"])
    out = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg / "proj"
        code_red_project(root)
        scripted_factory(monkeypatch, pkg, {"A": [[agree], [response]],
                                            "B": [[agree], [response]]})
        cli = importlib.import_module(f"{pkg}.cli")
        monkeypatch.setattr(cli, "check_for_update", lambda cb: None)
        monkeypatch.chdir(root)
        monkeypatch.setattr(sys, "stdin", Tty("1\na\n"))
        rc = cli.main(["discuss", "raise x", "--no-read-code"],
                      **({"device": "cpu"} if pkg == PORT else {}))
        stdout = _normalize_text(capsys.readouterr().out, root)
        out[pkg] = (rc, stdout, session_files(root),
                    (root / "app.py").read_text())
    assert out[PORT] == out[PACKAGES[0]]
    rc, stdout, files, app = out[PORT]
    assert rc == 0 and "What is your decree" in stdout and expect in stdout
    (status,) = [v for k, v in files.items() if k.endswith("status.json")]
    manifest = files.get(".roundtable/manifest.json")
    if name == "applied":
        assert app == "x = 2\n" and status["phase"] == "completed"
        (entry,) = manifest["features"]
        assert entry["files"] == ["app.py"] and entry["lead_knight"] == "A"
    else:
        assert app == "x = 1\n" and status["phase"] == "consensus_reached"
        assert manifest is None


# --- the read-only commands ---

READ_ONLY = [["status"], ["list"], ["chronicle"], ["decrees"],
             ["manifest"], ["manifest", "list"], ["manifest", "check"]]


@pytest.fixture
def history(tmp_path, monkeypatch, capsys):
    """A project with history, made by the JAX CLI: a discussion that
    reached consensus, one that escalated, a decree, a manifest entry
    whose file is gone and one that was deprecated."""
    from theroundtaible_tpu.adapters.fake import scripted_response
    from theroundtaible_tpu.core.types import ManifestEntry
    from theroundtaible_tpu.utils.decree_log import add_decree_entry
    from theroundtaible_tpu.utils.manifest import (add_manifest_entry,
                                                   deprecate_feature)
    root = tmp_path / "history"
    root.mkdir()
    write_config(root, knights=[
        {"name": n, "adapter": f"fake-{n}", "capabilities": [],
         "priority": i + 1} for i, n in enumerate("AB")],
        adapter_config={f"fake-{n}": {"name": n} for n in "AB"})
    low = scripted_response(4, "A long answer " * 8,
                            proposal="Keep it as is.")
    scripted_factory(monkeypatch, PACKAGES[0], {"A": [[low]], "B": [[low]]})
    run_cli(PACKAGES[0], ["discuss", "a question about X?",
                          "--no-read-code"],
            root, monkeypatch, capsys)
    scripted_factory(monkeypatch, PACKAGES[0], {
        n: [[scripted_response(9, files=["a.py", "NEW:b.py"])]]
        for n in "AB"})
    time.sleep(0.01)
    run_cli(PACKAGES[0], ["discuss", "The much longer topic of whether "
                          "the session store should move to an event log",
                          "--no-read-code"], root, monkeypatch, capsys)
    session = sorted((root / ".roundtable" / "sessions").iterdir())[-1].name
    add_decree_entry(root, "deferred", session, "a question about X?",
                     "King will decide later")
    for fid, files in (("store", ["a.py", "gone.py", "c.py", "d.py",
                                  "e.py"]), ("old", ["a.py"])):
        add_manifest_entry(root, ManifestEntry(
            id=fid, session=session, status="implemented", files=files,
            summary=f"{fid} summary", applied_at="2026-01-01T00:00:00Z",
            lead_knight="A"))
    (root / "a.py").write_text("a = 1\n")
    deprecate_feature(root, "old", "store")
    return root


@pytest.mark.parametrize("argv", READ_ONLY, ids=" ".join)
def test_read_only_commands_print_as_jax(argv, history, tmp_path,
                                         monkeypatch, capsys):
    empty = tmp_path / "empty"
    write_config(empty)
    for root in (history, empty):
        ours = run_cli(PORT, argv, root, monkeypatch, capsys)
        ref = run_cli(PACKAGES[0], argv, root, monkeypatch, capsys)
        assert ours == ref
        assert ours[0] == 0 and ours[1].strip()


def test_status_shows_the_session_as_jax(history, monkeypatch, capsys):
    rc, out, _ = run_cli(PORT, ["status"], history, monkeypatch, capsys)
    assert rc == 0 and "Consensus reached" in out
    assert "Decision preview:" in out
    from theroundtaible_tpu_torch.commands.status import (PHASE_DISPLAY,
                                                          phase_display)
    from theroundtaible_tpu_torch.core.types import SessionStatus
    from theroundtaible_tpu.commands import status as jstatus
    for phase in list(PHASE_DISPLAY) + ["diagnosing"]:
        for rejected in (False, True):
            s = SessionStatus(phase=phase, current_knight=None, round=1,
                              consensus_reached=True, started_at="t",
                              updated_at="t", unanimous_rejection=rejected)
            icon, label, color = phase_display(s)
            ricon, rlabel, rcolor = jstatus.phase_display(s)
            assert (icon, label, color("x")) == (ricon, rlabel, rcolor("x"))


@pytest.mark.parametrize("flag", ["telemetry", "perf", "kv", "health",
                                  "gateway", "fleet", "capacity", "slo"])
def test_status_views_raise_naming_their_item(flag, history, monkeypatch,
                                              capsys):
    from theroundtaible_tpu_torch.commands.status import VIEW_ITEMS
    rc, out, err = run_cli(PORT, ["status", f"--{flag}"], history,
                           monkeypatch, capsys)
    item = VIEW_ITEMS[flag].split(":")[0]
    assert rc != 0 and out == ""
    assert f"`roundtable status --{flag}`" in err
    assert f"ROADMAP, {item}" in err
    assert item in ("item 7c", "item 7d")


def test_manifest_edits_equal_jax(tmp_path, monkeypatch, capsys):
    out = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg / "proj"
        root.mkdir(parents=True)
        write_config(root)
        results = [
            run_cli(pkg, ["manifest", "add", "--id", "auth", "--files",
                          "a.py, b.py", "--status", "partial"], root,
                    monkeypatch, capsys, stdin="Login flow\n"),
            run_cli(pkg, ["manifest", "add"], root, monkeypatch, capsys,
                    stdin="cache\n\n"),
            run_cli(pkg, ["manifest", "add"], root, monkeypatch, capsys),
            run_cli(pkg, ["manifest", "deprecate", "auth", "--replaced-by",
                          "cache"], root, monkeypatch, capsys),
            run_cli(pkg, ["manifest", "deprecate", "nope"], root,
                    monkeypatch, capsys),
            run_cli(pkg, ["manifest", "check"], root, monkeypatch, capsys),
            run_cli(pkg, ["manifest", "list"], root, monkeypatch, capsys)]
        manifest = json.loads(
            (root / ".roundtable" / "manifest.json").read_text())
        for f in manifest["features"]:
            f.pop("applied_at")
        manifest.pop("last_updated")
        out[pkg] = (results, manifest)
    assert out[PORT] == out[PACKAGES[0]]
    results, manifest = out[PORT]
    assert [r[0] for r in results] == [0, 0, 1, 0, 1, 0, 0]
    assert [(f["id"], f["status"]) for f in manifest["features"]] == [
        ("auth", "deprecated"), ("cache", "implemented")]


# --- init ---

def stub_tool(tools: Path, name: str, rc: int = 0) -> None:
    """An executable on PATH that answers `--version` with `rc`."""
    path = tools / name
    path.write_text(f"#!/bin/sh\necho '{name} 1.0'\nexit {rc}\n")
    path.chmod(0o755)


@pytest.mark.parametrize("tools_on_path", [(), ("claude", "codex")],
                         ids=["no_tools", "claude_and_codex"])
def test_init_non_interactive_scaffolds_as_jax(tools_on_path, tmp_path,
                                               monkeypatch, capsys,
                                               _hermetic):
    for name in tools_on_path:
        stub_tool(_hermetic, name)
    stub_tool(_hermetic, "gemini", rc=1)
    out = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg / "proj"
        root.mkdir(parents=True)
        first = run_cli(pkg, ["init"], root, monkeypatch, capsys)
        if pkg == PORT:     # the port's words for its own accelerator
            first = (first[0], first[1].replace("CUDA edition", "TPU edition")
                     .replace("CUDA host", "TPU host"), first[2])
        config = (root / ".roundtable" / "config.json").read_text()
        again = run_cli(pkg, ["init"], root, monkeypatch, capsys)
        assert (root / ".roundtable" / "config.json").read_text() == config
        manifest = json.loads(
            (root / ".roundtable" / "manifest.json").read_text())
        manifest.pop("last_updated")
        out[pkg] = (first, again, json.loads(config), manifest,
                    (root / ".roundtable" / "chronicle.md").read_text(),
                    sorted(p.name for p in (root / ".roundtable").iterdir()))
    assert out[PORT] == out[PACKAGES[0]]
    knights = [k["adapter"] for k in out[PORT][2]["knights"]]
    assert knights == (["claude-cli", "openai-cli"] if tools_on_path
                       else ["claude-cli"])


def test_init_offers_a_knight_named_after_the_card(tmp_path, monkeypatch,
                                                   capsys):
    """With a card the probe offers the in-tree engine: init seats one
    torch-llm knight named after it, with the JAX init's engine
    settings."""
    monkeypatch.delenv("ROUNDTABLE_DISABLE_TPU_DETECT")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    root = tmp_path / "proj"
    root.mkdir()
    rc, out, _ = run_cli(PORT, ["init"], root, monkeypatch, capsys)
    assert rc == 0 and "1 knight(s) seated" in out
    config = json.loads((root / ".roundtable" / "config.json").read_text())
    assert config["knights"] == [{
        "name": "H100 Sage", "adapter": "torch-llm",
        "capabilities": ["local-inference", "cuda"], "priority": 1}]
    assert config["adapter_config"]["torch-llm"] == {
        "name": "H100 Sage", "model": "gemma-2b-it", "checkpoint": "",
        "max_seq_len": 8192, "dtype": "bfloat16",
        "mesh": {"data": 1, "model": 1}}


# --- local_detect ---

def test_engine_probe_follows_the_jax_switches(monkeypatch):
    from theroundtaible_tpu_torch.utils import local_detect as ld
    assert ld.detect_tpu_engine() == []          # disabled
    monkeypatch.delenv("ROUNDTABLE_DISABLE_TPU_DETECT")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ld.detect_tpu_engine() == []          # no card
    monkeypatch.setenv("ROUNDTABLE_FORCE_TPU_DETECT", "1")
    assert ld.detect_tpu_engine() == [ld.LocalModel(
        id="torch-llm", name="In-tree torch engine (CPU ×1)",
        endpoint="in-process", source="cuda")]
    monkeypatch.delenv("ROUNDTABLE_FORCE_TPU_DETECT")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    (found,) = ld.detect_tpu_engine()
    assert found.name == "In-tree torch engine (NVIDIA H100 80GB HBM3 ×4)"

    def wedged():
        time.sleep(2)
        return True
    monkeypatch.setattr(torch.cuda, "is_available", wedged)
    t0 = time.monotonic()
    assert ld.detect_tpu_engine(timeout_s=0.2) == []
    assert time.monotonic() - t0 < 1.5


class _Models(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - http.server's name
        body = json.dumps({"data": [
            {"id": "qwen/qwen2.5-coder-14b"}, {"id": "text-embedding-3"},
            {"id": "llama3.1:latest"}, {"id": ""}]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_local_servers_are_detected_as_jax(monkeypatch, _hermetic):
    """Both packages probe a loopback `/v1/models` stub standing in for
    LM Studio and Ollama, and fall back to `ollama list`, with the same
    models found."""
    from theroundtaible_tpu.utils import local_detect as jld
    from theroundtaible_tpu_torch.utils import local_detect as pld
    for var in ("http_proxy", "HTTP_PROXY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("no_proxy", "*")
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Models)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    ollama = _hermetic / "ollama"
    ollama.write_text("#!/bin/sh\necho 'NAME ID SIZE'\n"
                      "echo 'mistral:7b abc 4GB'\necho 'nomic-embed x 1GB'\n")
    ollama.chmod(0o755)
    try:
        found = {}
        for mod in (jld, pld):
            monkeypatch.setattr(mod, "LM_STUDIO_ENDPOINT", url)
            found[mod] = (mod.detect_local_models(include_tpu=False),
                          mod._ollama_cli_fallback(),
                          [mod.prettify_model_id(m) for m in (
                              "qwen/qwen2.5-coder-14b", "llama3.1:latest",
                              "deepseek_r1-7b")])
    finally:
        server.shutdown()
        thread.join(timeout=10)
    ours, ref = found[pld], found[jld]
    assert [[vars(m) for m in ms] for ms in ours[:2]] == \
        [[vars(m) for m in ms] for ms in ref[:2]]
    assert ours[2] == ref[2]
    assert [m.id for m in ours[0]] == ["qwen/qwen2.5-coder-14b",
                                       "llama3.1:latest", "mistral:7b"]


# --- warmup ---

def test_warmup_warms_each_engine_knight_on_the_cpu(tmp_path, monkeypatch,
                                                    capsys):
    """As tests/test_commands.py holds the JAX command: no engine knight is
    a no-op; two knights on one tiny engine warm batch sizes [1, 2], and
    the engine the first discussion finds is the warmed one."""
    from theroundtaible_tpu_torch.engine import get_engine, reset_engines
    root = tmp_path / "proj"
    root.mkdir()
    write_config(root)
    rc, out, _ = run_cli(PORT, ["warmup"], root, monkeypatch, capsys)
    assert rc == 0 and "nothing to warm" in out
    engine_cfg = {"model": "tiny-gemma", "max_seq_len": 256,
                  "num_slots": 4,
                  "sampling": {"temperature": 0.0, "max_new_tokens": 8}}
    write_config(root, knights=[
        {"name": n, "adapter": "tpu-llm", "capabilities": [],
         "priority": i + 1} for i, n in enumerate("AB")],
        adapter_config={"tpu-llm": engine_cfg})
    reset_engines()
    try:
        rc, out, _ = run_cli(PORT, ["warmup"], root, monkeypatch, capsys)
        assert rc == 0
        assert "Warming tpu-llm (batch sizes [1, 2])" in out
        assert "tiny-gemma on mesh {'data': 1, 'model': 1}" in out
        engine = get_engine(engine_cfg, "cpu")
        assert engine.describe()["model"] == "tiny-gemma"
        assert not any(name.startswith("__warmup")
                       for name in engine.kv._slots)
    finally:
        reset_engines()
