"""`roundtable apply` — Lead Knight executes the consensus decision
(counterpart of theroundtaible_tpu/commands/apply.py; an engine Lead Knight
runs on `device=`).

The documented pipeline (reference README.md:159-207, TODO.md:87-138;
SURVEY.md §2.2): load the latest consensus session → build the apply
prompt (decision + in-scope sources + BLOCK_MAPs + editing rules) →
Lead Knight emits RTDIFF/1 → parse → validate (scope, blocks, sha256
integrity) → parley per file (default) → backup → write → manifest
auto-update → decree on scope override.

Flags: --noparley (write without per-file approval), --dry-run (full
pipeline, no writes), --override-scope (typed YES + reason, audited to the
decree log, reference README.md:206 + TODO.md:87).
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

from ..adapters.factory import initialize_adapters
from ..apply import (
    ParseError,
    apply_edits,
    parse_knight_output,
    validate_edits,
)
from ..apply.prompt import build_apply_prompt
from ..core.config import load_config
from ..core.errors import FileWriteError, SessionError
from ..core.orchestrator import execute_with_fallback
from ..utils.decree_log import add_decree_entry
from ..utils.manifest import (
    add_manifest_entry,
    get_feature_summary,
    topic_to_feature_id,
)
from ..core.types import ManifestEntry
from ..utils.session import (
    find_latest_session,
    now_iso,
    read_status,
    update_status,
)
from ..utils.ui import style


def _ask(prompt: str) -> str:
    try:
        return input(prompt)
    except EOFError:
        return ""


def _read_topic(session_path: str) -> str:
    topic_path = Path(session_path) / "topic.md"
    if topic_path.is_file():
        raw = topic_path.read_text(encoding="utf-8")
        m = re.search(r"^# Topic\s*\n\n(.+)", raw, re.MULTILINE)
        return (m.group(1).strip() if m else raw.strip())
    return Path(session_path).name


def _confirm_override(project_root: str, session_name: str,
                      topic: str) -> bool:
    """Typed-YES confirmation + reason, audited to the decree log
    (reference README.md:206, TODO.md:87; decree type override_scope)."""
    print(style.yellow("\n  You are about to BYPASS the agreed file "
                       "scope. The knights negotiated that scope for a "
                       "reason."))
    answer = _ask("  Type YES (all caps) to proceed: ").strip()
    if answer != "YES":
        print(style.dim("  Scope override cancelled."))
        return False
    reason = _ask("  Reason (for the audit log): ").strip()
    add_decree_entry(project_root, "override_scope", session_name, topic,
                     reason or "no reason given")
    return True


def _parley(path: str, new_text: str, state: dict) -> bool:
    """Per-file approval (reference architecture-docs.md:215-217:
    'Parley mode (default): each file shown for approval before
    writing')."""
    if state.get("all"):
        return True
    n_lines = len(new_text.splitlines())
    print(style.bold(f"\n  ── parley: {path} ({n_lines} lines) ──"))
    for line in new_text.splitlines()[:20]:
        print(style.dim(f"  {line[:100]}"))
    if n_lines > 20:
        print(style.dim(f"  … {n_lines - 20} more lines"))
    while True:
        try:
            ans = input("  Write this file? [y]es / [n]o / [a]ll / "
                        "[q]uit: ").strip().lower()
        except EOFError:
            # No one left to answer (a pipe, /dev/null, CI): adjourn
            # rather than ask an empty stdin forever.
            raise KeyboardInterrupt from None
        if ans in ("y", "yes"):
            return True
        if ans in ("n", "no"):
            return False
        if ans in ("a", "all"):
            state["all"] = True
            return True
        if ans in ("q", "quit"):
            raise KeyboardInterrupt


def apply_command(noparley: bool = False, dry_run: bool = False,
                  override_scope: bool = False,
                  project_root: Optional[str] = None,
                  session_name: Optional[str] = None,
                  result: Optional[dict] = None,
                  device="cuda") -> int:
    """`result`, when given, receives {"written": [...]} so callers (code-red
    fix-now) can distinguish a real apply from an all-skipped rc==0 run."""
    if result is not None:
        result.setdefault("written", [])
    project_root = project_root or os.getcwd()
    config = load_config(project_root)

    # --- locate the session to apply ---
    if session_name:
        session_path = str(Path(project_root) / ".roundtable" / "sessions"
                           / session_name)
        if not Path(session_path).is_dir():
            raise SessionError(f"session {session_name} not found")
        status = read_status(session_path)
    else:
        latest = find_latest_session(project_root)
        if latest is None:
            raise SessionError(
                "no sessions found — hold a discussion first",
                hint='roundtable discuss "your topic"')
        session_path, status = latest.path, latest.status
        session_name = latest.name
    if status is None or not status.consensus_reached:
        raise SessionError(
            "the latest session has no consensus to apply",
            hint="reach consensus first (roundtable discuss), or pass "
                 "--session for one that did")

    decisions_path = Path(session_path) / "decisions.md"
    if not decisions_path.is_file():
        raise SessionError("decisions.md missing from the session")
    decision = decisions_path.read_text(encoding="utf-8")
    topic = _read_topic(session_path)

    # Old sessions without scope data work normally — no enforcement
    # (reference README.md:207).
    allowed_files = status.allowed_files or None
    if allowed_files is None:
        print(style.dim("\n  No scope data in this session — scope "
                        "enforcement skipped (old session)."))

    override_active = False
    if override_scope:
        if not _confirm_override(project_root, session_name, topic):
            return 1
        override_active = True

    # --- seat the Lead Knight ---
    adapters = initialize_adapters(config, device=device)
    if not adapters:
        raise SessionError("no knights available to execute the decision")
    lead = next((k for k in config.knights
                 if k.name == status.lead_knight), None) \
        or min(config.knights, key=lambda k: k.priority)
    adapter = adapters.get(lead.adapter)
    if adapter is None:
        lead = next((k for k in config.knights if k.adapter in adapters),
                    None)
        if lead is None:
            raise SessionError("no seated adapter for any knight")
        adapter = adapters[lead.adapter]
    print(style.cyan(f"\n  Lead Knight {style.bold(lead.name)} takes up "
                     "the sword."))

    # --- build prompt, execute, parse ---
    ctx = build_apply_prompt(project_root, topic, decision,
                             allowed_files or [])
    update_status(session_path, phase="applying")
    timeout_ms = config.rules.timeout_per_turn_seconds * 1000

    from .reporter import ConsoleReporter
    response, _served_by = execute_with_fallback(
        adapter, lead, config, ctx.prompt, timeout_ms, adapters,
        ConsoleReporter())

    try:
        parsed = parse_knight_output(response)
    except ParseError as e:
        update_status(session_path, phase="consensus_reached")
        raise FileWriteError(
            f"the Lead Knight's output was not applicable: {e}",
            hint="re-run apply; knight output varies between attempts")
    if parsed.legacy:
        print(style.yellow("  ⚠ knight used the deprecated EDIT: format "
                           "— applied via search/replace"))

    # --- validate (all-or-nothing, reference TODO.md:141-144) ---
    issues = validate_edits(parsed, project_root, allowed_files,
                            ctx.source_hashes,
                            override_scope=override_active)
    fatal = [i for i in issues if i.fatal]
    if fatal:
        update_status(session_path, phase="consensus_reached")
        print(style.red(f"\n  Validation blocked the apply "
                        f"({len(fatal)} issue(s), nothing written):"))
        for i in fatal:
            print(style.red(f"    ✗ {i.path}: {i.message}"))
        return 4
    for w in parsed.warnings:
        print(style.dim(f"  note: {w}"))

    # --- parley + write ---
    state = {"all": noparley or dry_run}
    try:
        outcome = apply_edits(
            parsed.edits, project_root, session_name,
            approve=lambda p, t: _parley(p, t, state), dry_run=dry_run)
    except KeyboardInterrupt:
        update_status(session_path, phase="consensus_reached")
        print(style.dim("\n  Apply adjourned — nothing more written."))
        return 1

    if dry_run:
        print(style.green(f"\n  DRY RUN — {len(outcome.written)} file(s) "
                          "would be written:"))
        for f in outcome.written:
            print(style.dim(f"    ~ {f}"))
        update_status(session_path, phase="consensus_reached")
        return 0

    for f in outcome.written:
        print(style.green(f"    ✓ {f}"))
    for f in outcome.skipped:
        print(style.yellow(f"    − {f} (skipped at parley)"))
    if outcome.backup_dir:
        print(style.dim(f"  Backups: {outcome.backup_dir}"))

    # --- manifest auto-update (reference README.md:177-179) ---
    manifest_status = "implemented" if not outcome.skipped else "partial"
    add_manifest_entry(project_root, ManifestEntry(
        id=topic_to_feature_id(topic),
        session=session_name,
        status=manifest_status,
        files=outcome.written,
        files_skipped=outcome.skipped or None,
        summary=get_feature_summary(session_path, topic),
        applied_at=now_iso(),
        lead_knight=lead.name,
    ))
    update_status(session_path, phase="completed")
    if result is not None:
        result["written"] = list(outcome.written)
    print(style.bold(style.green(
        f"\n  The decision has been carried out — {len(outcome.written)} "
        f"file(s) written ({manifest_status}).")))
    return 0
