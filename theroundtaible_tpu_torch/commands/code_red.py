"""`roundtable code-red` — diagnostic mode (triage → blind → convergence)
(counterpart of theroundtaible_tpu/commands/code_red.py; the doctors' engine
knights run on `device=`).

The reference's documented flow (architecture-docs.md:119-167,
README.md:159-175; SURVEY.md §2.2):

- **Triage round:** every doctor sees the symptoms + project context and
  gives a first assessment.
- **Blind round:** each doctor diagnoses INDEPENDENTLY — the transcript of
  the other doctors is withheld to prevent anchoring/groupthink. (In the
  engine this is natural: each doctor's KV slot simply doesn't receive
  the shared-transcript delta.)
- **Convergence rounds:** doctors see everything and compare root causes;
  between rounds their `file_requests` are resolved and injected.
- **Convergence** = 2+ doctors fuzzy-matching root_cause_key with
  confidence >= 8 → outcomes: Fix now / Report only / Log for later, each
  recorded in `.roundtable/error-log.md` as CR-XXX OPEN/RESOLVED/PARKED.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

from ..adapters.factory import initialize_adapters
from ..core.config import load_config
from ..core.diagnostic import (
    DiagnosticBlock,
    check_convergence,
    parse_diagnostic_from_response,
    strip_diagnostic_json,
    summarize_diagnosis,
)
from ..core.errors import ConfigError, classify_error, format_error
from ..core.orchestrator import (
    assemble_shared_context,
    execute_with_fallback,
    resolve_file_requests,
)
from ..core.prompt import load_template
from ..core.types import RoundEntry
from ..utils.context import build_context
from ..utils.error_log import add_error_entry, set_entry_status
from ..utils.session import (
    create_session,
    now_iso,
    update_status,
    write_decisions,
    write_discussion,
)
from ..utils.ui import ask, knight_color, style
from .reporter import ConsoleReporter

MAX_DIAG_ROUNDS = 4  # triage + blind + up to 2 convergence rounds

_PHASE_RULES = {
    "triage": (
        "TRIAGE — first assessment. What do the symptoms suggest? What are "
        "the candidate mechanisms? What evidence would discriminate between "
        "them? Confidence above 6 is premature in triage."),
    "blind": (
        "BLIND DIAGNOSIS — you see the symptoms and the project context but "
        "NOT the other doctors' notes this round (anti-anchoring). Commit "
        "to your own best root_cause_key and the test that would prove it."),
    "convergence": (
        "CONVERGENCE — compare your diagnosis with the other doctors'. "
        "Address disagreements head-on: either adopt a colleague's key "
        "(citing their evidence) or present the evidence that refutes it."),
}


def _build_prompt(symptoms: str, phase: str, context_text: str,
                  resolved_files: str, doctors: list[str], me: str,
                  transcript: list[RoundEntry]) -> str:
    template = load_template("code_red_prompt.md")
    others = ", ".join(d for d in doctors if d != me) or "(you consult alone)"
    if phase == "blind":
        transcript_text = "(withheld this round — diagnose independently)"
    elif transcript:
        transcript_text = "\n\n".join(
            f"### Round {e.round} — Dr. {e.knight}\n{e.response}"
            for e in transcript)
    else:
        transcript_text = "(none yet)"
    filled = template
    for key, value in (
        ("{{symptoms}}", symptoms),
        ("{{phase}}", phase.upper()),
        ("{{phase_rules}}", _PHASE_RULES[phase]),
        ("{{context}}", context_text),
        ("{{resolved_files}}", resolved_files or "(none requested)"),
        ("{{other_doctors}}", others),
        ("{{transcript}}", transcript_text),
    ):
        filled = filled.replace(key, value)
    return filled + f"\n\nYou are Dr. {me}. Your diagnosis:"


def code_red_command(description: str,
                     project_root: Optional[str] = None,
                     device="cuda") -> int:
    project_root = project_root or os.getcwd()
    config = load_config(project_root)

    print(style.bold(style.red("\n  ── CODE RED ──")))
    print(style.dim(f'  Incident: "{description}"\n'))

    adapters = initialize_adapters(
        config, on_event=lambda k, m: print(style.dim(f"  {m}")),
        device=device)
    if not adapters:
        raise ConfigError("No doctors available for the consultation.")

    context = build_context(project_root, config, read_source_code=True)
    context_text = assemble_shared_context("", context, "", "")
    session_path = create_session(project_root, f"code-red {description}")
    update_status(session_path, phase="diagnosing")

    doctors = [k.name for k in config.knights if k.adapter in adapters]
    timeout_ms = config.rules.timeout_per_turn_seconds * 1000
    reporter = ConsoleReporter()

    transcript: list[RoundEntry] = []
    resolved_files = ""
    phases = ["triage", "blind"] + \
        ["convergence"] * (MAX_DIAG_ROUNDS - 2)

    converged = None
    for round_num, phase in enumerate(phases, start=1):
        print(style.bold(f"\n  ── Round {round_num}: {phase.upper()} ──"))
        round_blocks: list[DiagnosticBlock] = []
        pending_requests: list[str] = []
        for knight in config.knights:
            if knight.adapter not in adapters:
                continue
            adapter = adapters[knight.adapter]
            prompt = _build_prompt(
                description, phase, context_text, resolved_files,
                doctors, knight.name, transcript)
            update_status(session_path, phase="diagnosing",
                          current_knight=knight.name, round=round_num)
            try:
                response, _served_by = execute_with_fallback(
                    adapter, knight, config, prompt, timeout_ms,
                    adapters, reporter)
            except Exception as e:
                print(style.red(f"  Dr. {knight.name} is unavailable "
                                f"({classify_error(e)}) — the consult "
                                "continues without them."))
                continue
            block = parse_diagnostic_from_response(
                response, knight.name, round_num)
            display = strip_diagnostic_json(response)
            print(f"\n  {knight_color(knight.name, f'Dr. {knight.name}')}"
                  f" (round {round_num}):")
            for line in display.splitlines()[:30]:
                print(style.dim(f"  {line}"))
            if block:
                conf_color = (style.green if block.confidence_score >= 8
                              else style.yellow)
                print(conf_color(
                    f"  {block.root_cause_key or '(no key)'} — confidence "
                    f"{block.confidence_score:g}/10"))
                round_blocks.append(block)
                pending_requests.extend(block.file_requests)
            transcript.append(RoundEntry(
                knight=knight.name, round=round_num, response=response,
                consensus=None, timestamp=now_iso()))

        write_discussion(session_path, transcript)

        if pending_requests:
            resolved_files = resolve_file_requests(
                pending_requests, project_root, config.rules.ignore)

        # Convergence is checked on the latest round's diagnoses — stale
        # triage guesses must not fake agreement with fresh evidence.
        if phase != "triage" and round_blocks:
            converged = check_convergence(round_blocks)
            if converged:
                break

    if converged is None:
        print(style.yellow("\n  The doctors could not agree on a root "
                           "cause. The patient lives... for now."))
        cr_id = add_error_entry(project_root, description, None,
                                status="OPEN",
                                session=os.path.basename(session_path))
        update_status(session_path, phase="escalated")
        print(style.dim(f"  Logged as {cr_id} (OPEN) in "
                        ".roundtable/error-log.md\n"))
        return 1

    key, group = converged
    diagnosis = summarize_diagnosis(key, group)
    print(style.bold(style.green(f"\n  DIAGNOSIS CONVERGED: {key}")))
    print(style.dim("  " + "\n  ".join(diagnosis.splitlines()[:12])))
    write_decisions(session_path, f"code-red: {description}", diagnosis,
                    transcript)
    # Scope for a follow-up fix = the evidence files the doctors pulled
    # (reference TODO.md:228).
    update_status(session_path, phase="consensus_reached",
                  consensus_reached=True,
                  allowed_files=sorted({
                      fr.split(":")[0] for b in group
                      for fr in b.file_requests}) or None)

    cr_id = add_error_entry(project_root, description, diagnosis,
                            status="OPEN",
                            session=os.path.basename(session_path))

    # --- outcome menu (reference README.md:174-175) ---
    if not sys.stdin.isatty():
        print(style.dim(f"\n  Logged as {cr_id}. Fix with: "
                        "roundtable apply\n"))
        return 0
    print(style.bold("\n  The diagnosis is in. Your orders?\n"))
    print(f"  {style.bold('1.')} {style.green('Fix now')} — the Lead "
          "Knight operates immediately")
    print(f"  {style.bold('2.')} {style.cyan('Report only')} — record "
          "the diagnosis, no surgery")
    print(f"  {style.bold('3.')} {style.dim('Log for later')} — park it\n")
    answer = ask(style.bold(style.yellow("  Your orders? [1-3] ")),
                 default="2").strip()
    if answer == "1":
        from .apply import apply_command
        try:
            apply_result: dict = {}
            rc = apply_command(project_root=project_root,
                               result=apply_result, device=device)
            # apply returning success with files written = resolved; a
            # 0-file apply (everything skipped at parley) must NOT flip the
            # status (reference TODO.md:227 "code-red false RESOLVED" fix).
            if rc == 0 and apply_result.get("written"):
                set_entry_status(project_root, cr_id, "RESOLVED")
                print(style.green(f"  {cr_id} RESOLVED."))
            elif rc == 0:
                print(style.yellow(
                    f"  Nothing was written — {cr_id} stays OPEN."))
        except Exception as e:
            print(style.red(f"  Surgery failed: {format_error(e)}"))
        return 0
    if answer == "3":
        set_entry_status(project_root, cr_id, "PARKED")
        print(style.dim(f"\n  {cr_id} PARKED. It will be back.\n"))
        return 0
    print(style.dim(f"\n  {cr_id} recorded (OPEN). The report is in "
                    "decisions.md.\n"))
    return 0
