"""`roundtable discuss` — the main command (counterpart of
theroundtaible_tpu/commands/discuss.py; engine knights, and the Lead Knight
of the King's "apply now", run on `device=`).

Parity with reference src/commands/discuss.ts:39-260: adapter seating, the
read-codebase question, the discussion loop, and the King's Choice menu on
no-consensus (pick a knight's proposal 1..N, or send them back for
unanimity, which resumes the same session). On the King's choice a decree
entry is written (the reference's storage side exists but nothing writes —
SURVEY.md §2.2 third bullet; we close that gap).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Optional

from ..adapters.factory import initialize_adapters
from ..core.config import load_config
from ..core.errors import ConfigError
from ..core.orchestrator import run_discussion
from ..core.types import ContinueOptions, RoundEntry, SessionResult
from ..utils.decree_log import add_decree_entry
from ..utils.session import update_status, write_decisions
from ..utils.ui import ask, ask_yes_no, knight_color, style
from .reporter import ConsoleReporter


def ask_read_codebase() -> bool:
    """[Y/N] read-codebase question (reference discuss.ts:16-33)."""
    print(style.bold("  Shall the knights read the codebase first?\n"))
    print(f"  {style.bold('Y.')} {style.cyan('Yes')} — full codebase scan "
          "(more context, better proposals)")
    print(f"  {style.bold('N.')} {style.dim('No')} — topic only "
          "(faster, cheaper)\n")
    answer = ask_yes_no(style.bold(style.yellow("  Read codebase?")),
                        default=False)
    if answer:
        print(style.cyan(
            "\n  The knights will study the codebase before debating.\n"))
    else:
        print(style.dim("\n  Topic only. The knights go in blind.\n"))
    return answer


def continue_command(read_code: Optional[bool] = None,
                     project_root: Optional[str] = None,
                     device="cuda") -> int:
    """`discuss --continue`: resume the latest unfinished session after a
    crash/interrupt (reference future work TODO.md:179). The transcript is
    rebuilt from the session's transcript.json; knights pick up at the
    next round with no King's ultimatum injected."""
    from pathlib import Path

    from ..utils.session import find_latest_session, read_transcript

    project_root = project_root or os.getcwd()
    session = find_latest_session(project_root)  # SessionInfo, not a path
    if session is None:
        print(style.dim("\n  No sessions to continue.\n"))
        return 1
    status = session.status
    if status is None or status.phase not in ("discussing", "escalated"):
        print(style.dim(
            f"\n  Latest session ({session.name}) is not resumable "
            f"(phase: {status.phase if status else 'unknown'}).\n"))
        return 1
    rounds = read_transcript(session.path)
    if not rounds:
        print(style.yellow(
            "\n  No transcript.json in the session — nothing to rebuild "
            "from (sessions from older versions can't be continued).\n"))
        return 1
    topic_file = Path(session.path) / "topic.md"
    topic = ""
    if topic_file.exists():
        for line in topic_file.read_text(encoding="utf-8").splitlines():
            if line.strip() and not line.startswith("#"):
                topic = line.strip()
                break
    last_round = max(e.round for e in rounds)
    print(style.bold(f"\n  Resuming: {session.name} "
                     f"(round {last_round} done)\n"))
    continue_from = ContinueOptions(
        session_path=session.path, all_rounds=rounds,
        start_round=last_round + 1, king_demand=False)
    return discuss_command(topic or "(resumed session)", read_code,
                           project_root, continue_from=continue_from,
                           device=device)


def discuss_command(topic: str, read_code: Optional[bool] = None,
                    project_root: Optional[str] = None,
                    continue_from: Optional[ContinueOptions] = None,
                    device="cuda") -> int:
    """Seat the knights (engine knights on `device`: the card unless the
    caller asks for the CPU), run the discussion and the King's menus."""
    project_root = project_root or os.getcwd()
    config = load_config(project_root)

    print(style.bold(f'\n  Topic: "{topic}"\n'))
    print(style.dim("  Summoning the knights to the table...\n"))

    def seat_event(kind: str, message: str) -> None:
        if kind == "seated":
            print(style.dim(f"  {message}"))
        else:
            print(style.yellow(f"  {message}"))

    adapters = initialize_adapters(config, on_event=seat_event,
                                   device=device)
    if not adapters:
        raise ConfigError(
            "A roundtable with no knights is just a table.",
            hint="Install at least one AI CLI tool (claude, gemini, codex), "
                 "set an API key, or configure the torch-llm adapter.")
    print("")

    read_codebase = read_code if read_code is not None else ask_read_codebase()

    reporter = ConsoleReporter()
    result = run_discussion(topic, config, adapters, project_root,
                            read_codebase, continue_from=continue_from,
                            reporter=reporter)

    while True:
        print(style.bold("\n" + "=" * 50))
        if result.consensus:
            if result.unanimous_rejection:
                _handle_rejection(result)
            else:
                _handle_consensus(result)
                _kings_decree(result, topic, project_root, device)
            break
        action = _handle_no_consensus(result, topic, project_root)
        if action != "send_back":
            break
        print(style.bold("=" * 50))
        continue_from = ContinueOptions(
            session_path=result.session_path,
            all_rounds=result.all_rounds,
            start_round=result.rounds + 1,
            resolved_files=result.resolved_files,
            resolved_commands=result.resolved_commands,
        )
        result = run_discussion(topic, config, adapters, project_root,
                                read_codebase, continue_from=continue_from,
                                reporter=reporter)
    print(style.bold("=" * 50 + "\n"))
    return 0


def _handle_consensus(result: SessionResult) -> None:
    print(style.bold(style.green(
        "  A miracle has occurred. The knights actually agree.")))
    print(style.dim(f"  Rounds: {result.rounds}"))
    print(style.dim(f"  Session: {result.session_path}"))
    print(style.bold("\n  The advice has been recorded."))
    print(style.dim(
        f"  Read the decision: {result.session_path}/decisions.md\n"))


def _kings_decree(result: SessionResult, topic: str,
                  project_root: str, device="cuda") -> None:
    """Post-consensus decree menu: apply now / wield the sword myself /
    decide later (reference architecture-docs.md:209 'King's Choice: apply
    now, do it yourself, or decide later'; decree writes on self/later per
    reference TODO.md:100 — the gap SURVEY.md §2.2 flags). Interactive
    only: scripted/piped runs keep the classic 'run apply yourself' hint.
    """
    import sys
    session_name = os.path.basename(result.session_path)
    if not sys.stdin.isatty():
        print(style.dim("  Execute it with: roundtable apply\n"))
        return
    print(style.bold("\n  What is your decree, Your Majesty?\n"))
    print(f"  {style.bold('1.')} {style.green('Apply now')} — the Lead "
          "Knight executes the decision")
    sword = style.cyan("I will wield the sword myself")
    print(f"  {style.bold('2.')} {sword} — no apply, the King codes it")
    print(f"  {style.bold('3.')} {style.dim('Decide later')} — "
          "adjourn; roundtable apply still works afterwards\n")
    answer = ask(style.bold(style.yellow("  Your decree? [1-3] ")),
                 default="3")
    if answer.strip() == "1":
        from .apply import apply_command
        try:
            apply_command(project_root=project_root, device=device)
        except Exception as e:  # apply failures must not unwind discuss
            print(style.red(f"  Apply failed: {e}"))
            print(style.dim("  The decision is saved — retry with "
                            "roundtable apply."))
        return
    if answer.strip() == "2":
        add_decree_entry(project_root, "rejected_no_apply", session_name,
                         topic, "King wields the sword personally")
        print(style.dim("\n  So be it. The code is yours, Your Majesty.\n"))
        return
    add_decree_entry(project_root, "deferred", session_name, topic,
                     "King will decide later")
    print(style.dim("\n  The decision rests. roundtable apply awaits "
                    "your command.\n"))


def _handle_rejection(result: SessionResult) -> None:
    print(style.bold(style.red(
        "  The knights unanimously reject this proposal.")))
    print(style.dim(f"  Rounds: {result.rounds}"))
    print(style.dim(f"  Session: {result.session_path}"))
    print(style.dim(
        "\n  Their reasoning has been recorded in decisions.md."))
    print(style.dim("  Perhaps a wiser question next time, Your Majesty.\n"))


@dataclass
class KnightProposal:
    knight: str
    score: float
    summary: str
    full_response: str


def get_last_proposals(all_rounds: list[RoundEntry]) -> list[KnightProposal]:
    """Latest turn per knight, with a one-line summary
    (reference discuss.ts:229-260)."""
    last_by_knight: dict[str, RoundEntry] = {}
    for entry in all_rounds:
        last_by_knight[entry.knight] = entry
    proposals = []
    for entry in last_by_knight.values():
        score = entry.consensus.consensus_score if entry.consensus else 0
        cleaned = re.sub(r"```json[\s\S]*?```", "", entry.response)
        cleaned = re.sub(r'\{[^{}]*"consensus_score"[^{}]*\}', "", cleaned)
        cleaned = cleaned.strip()
        lines = [l for l in cleaned.split("\n") if len(l.strip()) > 10]
        summary = lines[0].strip() if lines else "No summary available"
        if len(summary) > 80:
            summary = summary[:77] + "..."
        proposals.append(KnightProposal(
            knight=entry.knight, score=score, summary=summary,
            full_response=entry.response))
    return proposals


def _handle_no_consensus(result: SessionResult, topic: str,
                         project_root: str) -> str:
    """King's Choice menu; returns "send_back" or "done"
    (reference discuss.ts:132-217)."""
    print(style.bold(style.yellow(
        "  The knights have agreed to disagree. As usual.")))
    print(style.dim(f"  Rounds: {result.rounds}"))
    print(style.dim(f"  Session: {result.session_path}"))

    proposals = get_last_proposals(result.all_rounds)
    if not proposals:
        print(style.dim(
            "\n  No proposals to choose from. "
            "The knights were useless today."))
        return "done"

    print(style.bold("\n  But YOU are the King. The final word is yours.\n"))
    for i, p in enumerate(proposals):
        score_color = (style.green if p.score >= 9
                       else style.yellow if p.score >= 6 else style.red)
        from ..core.types import format_score
        print(f"  {style.bold(f'{i + 1}.')} "
              f"{knight_color(p.knight, p.knight)} "
              f"{score_color(f'({format_score(p.score)}/10)')} — "
              f"{style.dim(p.summary)}")
    print(f"  {style.bold(f'{len(proposals) + 1}.')} "
          f"{style.dim('Send them back — they must reach unanimity!')}")
    print("")
    answer = ask(style.bold(style.yellow(
        f"  What say you, Your Majesty? [1-{len(proposals) + 1}] ")))
    try:
        choice = int(answer.strip())
    except ValueError:
        choice = -1
    if choice < 1 or choice > len(proposals) + 1:
        print(style.dim(
            "  The King waves dismissively. Perhaps another time."))
        # King walks away without applying — record a deferred decree so the
        # knights don't re-propose blindly (SURVEY.md §2.2 decree gap).
        add_decree_entry(project_root, "deferred",
                         os.path.basename(result.session_path), topic,
                         "King adjourned without a decision")
        return "done"

    if choice == len(proposals) + 1:
        return "send_back"

    chosen = proposals[choice - 1]
    print(style.bold(
        f"\n  The King has chosen "
        f"{knight_color(chosen.knight, chosen.knight)}'s advice. "
        "So it shall be."))
    write_decisions(result.session_path, topic, chosen.full_response,
                    result.all_rounds)
    update_status(result.session_path, phase="consensus_reached",
                  consensus_reached=True)
    print(style.bold("\n  The advice has been recorded."))
    print(style.dim(
        f"  Read the decision: {result.session_path}/decisions.md\n"))
    return "done"
