"""PyTorch port, the apply path: `apply/` (block scanner, RTDIFF/1 parser,
validation, executor, prompt) and `roundtable apply` against the JAX
package's on the same inputs.

- The scanner, parser, validator and executor run on tests/test_apply.py's
  corpus in both packages: the same blocks and BLOCK_MAPs, the same parses
  (or ParseError messages), the same validation issues and the same
  written bytes.
- `apply_command` with a scripted Lead Knight in two scratch projects (one
  per package) writes the same files, manifest entry and status, and
  returns the same exit codes: 4 when validation blocks, FileWriteError
  when the knight's output does not parse, 1 when the King adjourns at
  parley.
"""

import dataclasses
import io
import json
import sys
from pathlib import Path

import pytest

from test_apply import PYFILE, RTDIFF_OK
from theroundtaible_tpu import apply as japply
from theroundtaible_tpu.apply import blocks as jblocks
from theroundtaible_tpu.apply import prompt as jprompt
from theroundtaible_tpu.apply import validate as jvalidate
from theroundtaible_tpu_torch import apply as papply
from theroundtaible_tpu_torch.apply import blocks as pblocks
from theroundtaible_tpu_torch.apply import prompt as pprompt
from theroundtaible_tpu_torch.apply import validate as pvalidate

BIG = "def big():\n" + "\n".join(f"    line_{i} = {i}" for i in range(150))
SPLIT = "\n".join(
    line for i in range(12)
    for line in [f"def f{i}():", *(f"    x{j} = {j}" for j in range(8)), ""])
FILES = {
    "python": PYFILE, "empty": "", "one_line": "x = 1\n", "oversized": BIG,
    "split_at_blank": SPLIT,
    "markdown": "# Title\n\nPara one line one.\nline two.\n\n## Section\n\n"
                "more\n",
}

RT = "RTDIFF/1\n"
CORPUS = {
    "ok": RTDIFF_OK,
    "fenced": "```\n" + RTDIFF_OK + "\n```",
    "no_header": "FILE: x.py\nBLOCK_DELETE B001\n",
    "unterminated": RT + "FILE: a.py\nBLOCK_REPLACE B001\n<<<\nnever closed",
    "op_before_file": RT + "BLOCK_DELETE B001\n",
    "bad_block_id": RT + "FILE: a.py\nBLOCK_DELETE banana\n",
    "header_without_ops": RT + "FILE: a.py\n",
    "prose_between_ops": RT + "FILE: a.py\nThis modifies the file.\n"
                              "BLOCK_DELETE B001\n",
    "top_anchor": RT + "FILE: a.py\nBLOCK_INSERT_AFTER B000\n<<<\n"
                       "import sys\n>>>\n",
    "empty_content": RT + "FILE: a.py\nBLOCK_REPLACE B001\n<<<\n>>>\n",
    "angle_lines": RT + "FILE: a.py\nBLOCK_REPLACE B001\n<<<\n"
                        "if a << 2 > b:\n    pass\n>>>\n",
    "legacy": "EDIT: src/app.py\nSEARCH:\n<<<\nreturn 1\n>>>\n"
              "REPLACE:\n<<<\nreturn 2\n>>>\n",
    "legacy_missing_replace": "EDIT: a.py\nSEARCH:\n<<<\nx\n>>>\n",
    "neither": "I think we should refactor the auth.",
    "rtdiff_wins": RTDIFF_OK + "\nEDIT: other.py\n",
}

# (RTDIFF body or whole legacy text, allowed_files, source_hashes,
# override_scope): TestValidation's cases in tests/test_apply.py.
STALE = {"src/app.py": jvalidate.sha256_text("old content")}
GOOD = {"src/app.py": jvalidate.sha256_text(PYFILE)}
VALIDATION = {
    "clean": (RT + "FILE: src/app.py\nBLOCK_REPLACE B002\n<<<\nimport sys\n"
                   ">>>\n", ["src/app.py"], None, False),
    "out_of_scope": (RT + "FILE: src/app.py\nBLOCK_DELETE B002\n",
                     ["other.py"], None, False),
    "override_scope": (RT + "FILE: src/app.py\nBLOCK_DELETE B002\n",
                       ["other.py"], None, True),
    "no_scope_data": (RT + "FILE: src/app.py\nBLOCK_DELETE B002\n", None,
                      None, False),
    "new_prefix_scope": (RT + "FILE: NEW:src/new.py\nFILE_CREATE\n<<<\n"
                              "x = 1\n>>>\n", ["src/new.py"], None, False),
    "new_prefix_scope_new": (RT + "FILE: NEW:src/new.py\nFILE_CREATE\n<<<\n"
                                  "x = 1\n>>>\n", ["NEW:src/new.py"], None,
                             False),
    "traversal": (RT + "FILE: ../evil.py\nBLOCK_DELETE B001\n", None, None,
                  False),
    "absolute": (RT + "FILE: /etc/passwd\nBLOCK_DELETE B001\n", None, None,
                 False),
    "unknown_block": (RT + "FILE: src/app.py\nBLOCK_DELETE B099\n", None,
                      None, False),
    "duplicate_block_ops": (RT + "FILE: src/app.py\nBLOCK_DELETE B002\n"
                                 "BLOCK_REPLACE B002\n<<<\nx\n>>>\n", None,
                            None, False),
    "missing_file": (RT + "FILE: src/ghost.py\nBLOCK_DELETE B001\n", None,
                     None, False),
    "create_existing": (RT + "FILE: NEW:src/app.py\nFILE_CREATE\n<<<\nx\n"
                             ">>>\n", None, None, False),
    "create_without_new": (RT + "FILE: src/fresh.py\nFILE_CREATE\n<<<\nx\n"
                                ">>>\n", None, None, False),
    "new_without_create": (RT + "FILE: NEW:src/fresh.py\nBLOCK_DELETE "
                                "B001\n", None, None, False),
    "empty_replace": (RT + "FILE: src/app.py\nBLOCK_REPLACE B002\n<<<\n"
                           ">>>\n", None, None, False),
    "sha_mismatch": (RT + "FILE: src/app.py\nBLOCK_DELETE B002\n", None,
                     STALE, False),
    "sha_match": (RT + "FILE: src/app.py\nBLOCK_DELETE B002\n", None, GOOD,
                  False),
    "top_anchor_replace": (RT + "FILE: src/app.py\nBLOCK_REPLACE B000\n"
                                "<<<\nx\n>>>\n", None, None, False),
    "legacy_not_found": ("EDIT: src/app.py\nSEARCH:\n<<<\nNO SUCH\n>>>\n"
                         "REPLACE:\n<<<\nx\n>>>\n", None, None, False),
    "legacy_ambiguous": ("EDIT: src/app.py\nSEARCH:\n<<<\n    return\n>>>\n"
                         "REPLACE:\n<<<\n    pass\n>>>\n", None, None,
                         False),
    "duplicate_file_sections": (RT + "FILE: src/app.py\nBLOCK_DELETE B002\n"
                                     "FILE: src/app.py\nBLOCK_DELETE B003\n",
                                None, None, False),
}

# Edits of PYFILE for the executor: TestExecutor's cases.
EDITS = {
    "replace": RT + "FILE: src/app.py\nBLOCK_REPLACE B002\n<<<\n"
                    "def alpha():\n    return 42\n>>>\n",
    "delete": RT + "FILE: src/app.py\nBLOCK_DELETE B004\n",
    "delete_middle": RT + "FILE: src/app.py\nBLOCK_DELETE B002\n",
    "insert_after": RT + "FILE: src/app.py\nBLOCK_INSERT_AFTER B002\n<<<\n"
                         "def alpha2():\n    return 11\n>>>\n",
    "insert_at_top": RT + "FILE: src/app.py\nBLOCK_INSERT_AFTER B000\n<<<\n"
                          "#!/usr/bin/env python\n>>>\n",
    "bottom_up": RT + "FILE: src/app.py\nBLOCK_REPLACE B002\n<<<\n"
                      "def alpha():\n    return 9\n>>>\nBLOCK_DELETE B004\n",
    "create": RT + "FILE: src/app.py\nBLOCK_REPLACE B001\n<<<\n\"\"\"New "
                   "docstring.\"\"\"\n>>>\nFILE: NEW:src/fresh.py\n"
                   "FILE_CREATE\n<<<\nz = 3\n>>>\n",
    "legacy": "EDIT: src/app.py\nSEARCH:\n<<<\n    return 1\n>>>\n"
              "REPLACE:\n<<<\n    return 99\n>>>\n",
}


def blocks_of(mod, text):
    return [(b.id, b.start, b.end, b.text, b.signature)
            for b in mod.scan_blocks(text)]


def parse_of(mod, text):
    try:
        return dataclasses.asdict(mod.parse_knight_output(text))
    except mod.ParseError as e:
        return ("ParseError", str(e))


@pytest.mark.parametrize("name", FILES)
def test_blocks_and_block_map_equal_jax(name):
    text = FILES[name]
    assert blocks_of(pblocks, text) == blocks_of(jblocks, text)
    assert pblocks.render_block_map("m.py", pblocks.scan_blocks(text)) == \
        jblocks.render_block_map("m.py", jblocks.scan_blocks(text))


@pytest.mark.parametrize("name", CORPUS)
def test_parse_equals_jax(name):
    ours = parse_of(papply, CORPUS[name])
    assert ours == parse_of(japply, CORPUS[name])
    if name in ("ok", "fenced", "legacy"):
        assert not isinstance(ours, tuple)


def project(root: Path) -> Path:
    (root / "src").mkdir(parents=True)
    (root / "src" / "app.py").write_text(PYFILE, encoding="utf-8")
    return root


@pytest.mark.parametrize("name", VALIDATION)
def test_validation_issues_equal_jax(name, tmp_path):
    text, allowed, hashes, override = VALIDATION[name]
    out = {}
    for tag, pkg in (("jax", japply), ("port", papply)):
        root = project(tmp_path / tag)
        issues = pkg.validate_edits(pkg.parse_knight_output(text), root,
                                    allowed, hashes, override_scope=override)
        out[tag] = [dataclasses.astuple(i) for i in issues]
    assert out["port"] == out["jax"]
    clean = ("clean", "override_scope", "no_scope_data", "new_prefix_scope",
             "new_prefix_scope_new", "sha_match")
    assert (out["port"] == []) == (name in clean)


@pytest.mark.parametrize("name", EDITS)
def test_executor_writes_the_jax_bytes(name, tmp_path):
    """materialize_edit on PYFILE, then apply_edits into a project with
    its backups: the same new texts, written files, skips and backup
    pre-images in both packages; a dry run and a parley that refuses
    write nothing."""
    text = EDITS[name]
    out = {}
    for tag, pkg in (("jax", japply), ("port", papply)):
        parsed = pkg.parse_knight_output(text)
        texts = [pkg.materialize_edit(
            e, None if e.is_new else PYFILE) for e in parsed.edits]
        root = project(tmp_path / tag)
        dry = pkg.apply_edits(parsed.edits, root, "s", dry_run=True)
        refused = pkg.apply_edits(parsed.edits, root, "s",
                                  approve=lambda p, t: False)
        assert (root / "src" / "app.py").read_text() == PYFILE
        outcome = pkg.apply_edits(parsed.edits, root, "sess-1")
        files = {str(p.relative_to(root)): p.read_bytes()
                 for p in sorted((root / "src").rglob("*")) if p.is_file()}
        backups = {str(p.relative_to(outcome.backup_dir)): p.read_bytes()
                   for p in sorted(Path(outcome.backup_dir).rglob("*"))
                   if p.is_file()} if outcome.backup_dir else {}
        out[tag] = (texts, dry.written, refused.skipped, outcome.written,
                    files, backups)
    assert out["port"] == out["jax"]
    assert out["port"][5] == {"src/app.py": PYFILE.encode()}


def test_apply_prompt_equals_jax(tmp_path):
    root = project(tmp_path)
    (root / "src" / "big.py").write_text("x = 1\n" * 20000)
    scope = ["src/app.py", "src/big.py", "NEW:src/fresh.py"]
    ours = pprompt.build_apply_prompt(root, "t", "decide", scope)
    ref = jprompt.build_apply_prompt(root, "t", "decide", scope)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.truncated == ["src/big.py"]
    (root / "src" / "huge.py").write_text("y = 2\n" * 90000)
    from theroundtaible_tpu_torch.core.errors import FileWriteError
    with pytest.raises(FileWriteError, match="500KB"):
        pprompt.build_apply_prompt(
            root, "t", "d", ["src/app.py"] + ["src/huge.py"] * 8)
    assert pvalidate.sha256_text(PYFILE) == jvalidate.sha256_text(PYFILE)


# ------------------------------------------------------------ apply_command

def consensus_project(root: Path, pkg: str, allowed, lead="A") -> Path:
    """A scratch project whose latest session reached consensus, written
    through `pkg`'s own session helpers."""
    import importlib
    session = importlib.import_module(f"{pkg}.utils.session")
    project(root)
    rt = root / ".roundtable"
    (rt / "sessions").mkdir(parents=True)
    (rt / "config.json").write_text(json.dumps({
        "version": "1.0", "project": "t", "language": "en",
        "knights": [{"name": lead, "adapter": "fake", "capabilities": [],
                     "priority": 1}],
        "rules": {"max_rounds": 2, "consensus_threshold": 9,
                  "timeout_per_turn_seconds": 10,
                  "escalate_to_user_after": 2, "auto_execute": False,
                  "ignore": []},
        "adapter_config": {"fake": {"name": lead}}}))
    path = session.create_session(root, "improve the app")
    session.write_decisions(path, "improve the app",
                            "Replace alpha with 42.", [])
    session.update_status(path, phase="consensus_reached",
                          consensus_reached=True, lead_knight=lead,
                          allowed_files=allowed)
    return Path(path)


def script_lead(monkeypatch, pkg: str, response: str) -> None:
    """Seat a FakeAdapter that answers `response` in place of the fake
    id's default script, in `pkg`'s factory."""
    import importlib
    factory = importlib.import_module(f"{pkg}.adapters.factory")
    fake = importlib.import_module(f"{pkg}.adapters.fake")

    def create(adapter_id, config, timeout_ms, *device):
        return (fake.FakeAdapter(name="A", script=[response])
                if adapter_id == "fake" else None)
    monkeypatch.setattr(factory, "create_adapter", create)


def run_apply(tmp_path, monkeypatch, pkg, response, allowed, stdin="",
              **kwargs):
    """apply_command of `pkg` in its own scratch project: (rc or the
    raised error, the session's path)."""
    import importlib
    command = importlib.import_module(f"{pkg}.commands.apply")
    root = tmp_path / pkg
    path = consensus_project(root, pkg, allowed)
    script_lead(monkeypatch, pkg, response)
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    extra = {"device": "cpu"} if pkg.endswith("_torch") else {}
    try:
        rc = command.apply_command(project_root=str(root), **kwargs, **extra)
    except Exception as e:  # noqa: BLE001 - compared across packages
        rc = (type(e).__name__, getattr(e, "exit_code", None), str(e))
    return rc, root, path


def project_state(root: Path, path: Path) -> dict:
    """What an apply leaves behind, without timestamps: the project's
    files, the manifest's entries, the session's status."""
    files = {str(p.relative_to(root)): p.read_bytes()
             for p in sorted((root / "src").rglob("*")) if p.is_file()}
    manifest_path = root / ".roundtable" / "manifest.json"
    manifest = (json.loads(manifest_path.read_text())["features"]
                if manifest_path.exists() else [])
    for entry in manifest:
        entry.pop("applied_at")
        entry["session"] = entry["session"][16:]   # drop the date-time
    status = json.loads((path / "status.json").read_text())
    for key in ("started_at", "updated_at"):
        status.pop(key)
    backup_root = root / ".roundtable" / "backups"
    backups = sorted("/".join(p.relative_to(backup_root).parts[1:])
                     for p in backup_root.rglob("*") if p.is_file())
    return {"files": files, "manifest": manifest, "status": status,
            "backups": backups}


WRITE = (RT + "FILE: src/app.py\nBLOCK_REPLACE B002\n<<<\ndef alpha():\n"
         "    return 42\n>>>\nFILE: NEW:src/fresh.py\nFILE_CREATE\n<<<\n"
         "z = 3\n>>>\n")

APPLY_CASES = {
    # name: (response, allowed_files, kwargs, stdin, expected rc)
    "noparley": (WRITE, ["src/app.py", "NEW:src/fresh.py"],
                 {"noparley": True}, "", 0),
    "parley_yes_then_no": (WRITE, ["src/app.py", "NEW:src/fresh.py"], {},
                           "y\nn\n", 0),
    "parley_all": (WRITE, ["src/app.py", "NEW:src/fresh.py"], {}, "a\n", 0),
    "dry_run": (WRITE, ["src/app.py", "NEW:src/fresh.py"],
                {"dry_run": True}, "", 0),
    "no_scope_data": (WRITE, None, {"noparley": True}, "", 0),
    "validation_blocks": (WRITE, ["other.py"], {"noparley": True}, "", 4),
    "unparseable": ("I would rather not write code today.",
                    ["src/app.py"], {"noparley": True}, "",
                    ("FileWriteError", 5)),
    "adjourned": (WRITE, ["src/app.py", "NEW:src/fresh.py"], {}, "q\n", 1),
    "override_refused": (WRITE, ["other.py"], {"override_scope": True},
                         "no\n", 1),
    "override_confirmed": (WRITE, ["other.py"], {"override_scope": True,
                                                 "noparley": True},
                           "YES\nthe scope was too narrow\n", 0),
}


@pytest.mark.parametrize("name", APPLY_CASES)
def test_apply_command_equals_jax(name, tmp_path, monkeypatch, capsys):
    response, allowed, kwargs, stdin, expected = APPLY_CASES[name]
    out = {}
    for pkg in ("theroundtaible_tpu", "theroundtaible_tpu_torch"):
        rc, root, path = run_apply(tmp_path, monkeypatch, pkg, response,
                                   allowed, stdin, **kwargs)
        state = project_state(root, path)
        decrees = root / ".roundtable" / "decree-log.json"
        if decrees.exists():
            state["decrees"] = [
                (e["type"], e["topic"], e["reason"])
                for e in json.loads(decrees.read_text())["entries"]]
        out[pkg] = (rc, state)
    assert out["theroundtaible_tpu_torch"] == out["theroundtaible_tpu"]
    rc, state = out["theroundtaible_tpu_torch"]
    if isinstance(expected, tuple):
        assert rc[:2] == expected
    else:
        assert rc == expected
    phase = state["status"]["phase"]
    written = state["manifest"] != []
    assert phase == ("completed" if written else "consensus_reached")
    if name == "noparley":
        assert b"return 42" in state["files"]["src/app.py"]
        assert state["files"]["src/fresh.py"] == b"z = 3\n"
        assert state["manifest"][0]["status"] == "implemented"
        assert state["manifest"][0]["files"] == ["src/app.py",
                                                 "src/fresh.py"]
        assert state["backups"] == ["src/app.py"]
    if name == "parley_yes_then_no":
        assert state["manifest"][0]["status"] == "partial"
        assert state["manifest"][0]["files_skipped"] == ["src/fresh.py"]
    if name in ("validation_blocks", "unparseable", "adjourned",
                "dry_run"):
        assert state["files"] == {"src/app.py": PYFILE.encode()}


def test_apply_without_a_consensus_session_raises(tmp_path):
    from theroundtaible_tpu_torch.commands.apply import apply_command
    from theroundtaible_tpu_torch.core.errors import SessionError
    from theroundtaible_tpu_torch.utils.session import update_status
    root = tmp_path / "p"
    (root / ".roundtable").mkdir(parents=True)
    (root / ".roundtable" / "config.json").write_text(
        (consensus_project(tmp_path / "q", "theroundtaible_tpu_torch",
                           ["src/app.py"]).parents[1] / "config.json")
        .read_text())
    with pytest.raises(SessionError, match="no sessions found"):
        apply_command(noparley=True, project_root=str(root), device="cpu")
    (path,) = (tmp_path / "q" / ".roundtable" / "sessions").iterdir()
    update_status(path, consensus_reached=False)
    with pytest.raises(SessionError, match="no consensus"):
        apply_command(noparley=True, project_root=str(tmp_path / "q"),
                      device="cpu")
    with pytest.raises(SessionError, match="not found"):
        apply_command(noparley=True, project_root=str(tmp_path / "q"),
                      session_name="nope", device="cpu")


def test_parley_on_an_exhausted_stdin_adjourns(tmp_path, monkeypatch):
    """Without --noparley and with nothing left on stdin (a pipe,
    /dev/null, CI), the first parley prompt adjourns the apply: rc 1,
    nothing written, the session back at consensus_reached. The prompt is
    asked once, not again and again."""
    import builtins
    asked = []
    real_input = builtins.input

    def counting_input(prompt=""):
        asked.append(prompt)
        assert len(asked) <= 3, "parley asked an exhausted stdin again"
        return real_input(prompt)
    monkeypatch.setattr(builtins, "input", counting_input)
    rc, root, path = run_apply(tmp_path, monkeypatch,
                               "theroundtaible_tpu_torch", WRITE,
                               ["src/app.py", "NEW:src/fresh.py"], stdin="")
    state = project_state(root, path)
    assert rc == 1
    assert len(asked) == 1 and "Write this file?" in asked[0]
    assert state["files"] == {"src/app.py": PYFILE.encode()}
    assert state["manifest"] == [] and state["backups"] == []
    assert state["status"]["phase"] == "consensus_reached"
