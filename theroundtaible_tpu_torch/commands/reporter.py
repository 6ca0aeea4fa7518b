"""Console Reporter — the CLI's personality-heavy display of the round loop.

Implements core.orchestrator.Reporter over the terminal, covering the
reference's inline chalk/ora output (src/orchestrator.ts:295, 361-535).
"""

from __future__ import annotations

from typing import Callable, Optional

from ..core.consensus import summarize_consensus
from ..core.orchestrator import Reporter
from ..core.types import ConsensusBlock
from ..utils.context import ProjectContext
from ..utils.ui import (
    Spinner,
    knight_color,
    round_header,
    score_bar,
    style,
    thinking_message,
)


class ConsoleReporter(Reporter):
    def __init__(self):
        self._context_spinner: Optional[Spinner] = None

    def context_start(self) -> None:
        self._context_spinner = Spinner(
            "  Gathering intel from the codebase...").start()

    def context_done(self, context: ProjectContext, manifest_features: int,
                     decree_count: int) -> None:
        detail = (f"manifest: {manifest_features} features, "
                  f"decrees: {decree_count}")
        if context.source_file_contents:
            kb = round(len(context.source_file_contents) / 1024)
            detail = f"source: {kb}KB, {detail}"
        if self._context_spinner:
            self._context_spinner.succeed(f"Context assembled ({detail})")
            self._context_spinner = None

    def session_started(self, session_path: str, resumed: bool) -> None:
        if resumed:
            print(style.bold(style.yellow(
                "\n  The King has spoken. Back to the table, knights!\n")))
        else:
            print(style.dim(f"  Session: {session_path}"))

    def round_started(self, round_num: int, order: list[str],
                      shuffled: bool) -> None:
        if shuffled:
            print(style.dim(f"  Speaking order: {' → '.join(order)}"))
        print(style.bold(style.blue(f"\n  {round_header(round_num)}\n")))

    def knight_skipped(self, knight: str) -> None:
        print(style.yellow(f"  {knight} didn't show up today. Typical."))

    def knight_thinking(self, knight: str) -> Callable[[], None]:
        spinner = Spinner(
            knight_color(knight, f"  {knight} {thinking_message(knight)}"))
        spinner.start()
        return spinner.stop

    def knight_spoke(self, knight: str, round_num: int, display_text: str,
                     consensus: Optional[ConsensusBlock]) -> None:
        divider = knight_color(knight, "─" * 50)
        print(divider)
        print(knight_color(knight, f"  {knight}")
              + style.dim(f" (Round {round_num})"))
        print(divider)
        indented = "\n".join(f"  {line}"
                             for line in display_text.split("\n"))
        print(indented)
        if consensus is not None:
            print("")
            print(f"  {knight_color(knight, knight)} score: "
                  f"{score_bar(consensus.consensus_score)}")
            if consensus.agrees_with:
                print(style.dim(
                    f"  Agrees with: {', '.join(consensus.agrees_with)}"))
            if consensus.pending_issues:
                print(style.yellow(
                    f"  Open issues: {', '.join(consensus.pending_issues)}"))
        else:
            print(style.yellow(
                "\n  (no consensus block found — the knight forgot the rules)"))
        print("")

    def knight_failed(self, knight: str, kind: str, message: str,
                      hint: Optional[str]) -> None:
        print(style.red(f"  {knight} crashed and burned"))
        print(style.red(f"  Error ({kind}): {message}"))
        if hint:
            print(style.dim(f"  Hint: {hint}"))

    def fallback_engaged(self, knight: str, fallback_id: str) -> None:
        print(style.yellow(
            f"  {knight} primary adapter failed, switching to fallback "
            f"({fallback_id})..."))

    def resolving_files(self, knight: str, requests: list[str]) -> None:
        print(style.dim(f"  Requesting files: {', '.join(requests)}"))

    def resolving_commands(self, knight: str) -> None:
        print(style.dim("  Verification commands:"))

    def verify_event(self, kind: str, message: str) -> None:
        if kind == "denied" or kind == "warning":
            print(style.yellow(f"  {message}"))
        else:
            print(style.dim(f"  {message}"))

    def consensus_reached(self, blocks: list[ConsensusBlock],
                          allowed_files: list[str]) -> None:
        print(style.bold(style.green(
            "\n  Against all odds... they actually agree.")))
        print(summarize_consensus(blocks))
        if allowed_files:
            print(style.cyan(
                f"\n  Scope: {len(allowed_files)} file(s) in modification "
                "scope:"))
            for f in allowed_files:
                if f.upper().startswith("NEW:"):
                    print(style.green(f"    + {f[4:]} (new)"))
                else:
                    print(style.dim(f"    ~ {f}"))

    def unanimous_rejection(self, blocks: list[ConsensusBlock]) -> None:
        print(style.bold(style.red(
            "\n  A rare sight — the knights actually agree on something.")))
        print(style.bold(style.red(
            "  Unfortunately, they agree that your idea is terrible.\n")))
        print(summarize_consensus(blocks))

    def escalation_warning(self, round_num: int, rounds_left: int) -> None:
        print(style.yellow(
            f"\n  Round {round_num}: Still no consensus. {rounds_left} "
            "round(s) left before escalation."))

    def escalated(self, blocks: list[ConsensusBlock]) -> None:
        print(style.bold(style.yellow(
            "\n  The knights have agreed to disagree. Your move.")))
        print(summarize_consensus(blocks))

    def overflow_warning(self, skipped: int, max_chars: int) -> None:
        kb = round(max_chars / 1024)
        print(style.yellow(
            f"\n  ⚔️  The scrolls overflow! {skipped} file(s) skipped or cut "
            f"— the knights can only carry {kb}KB into battle."))
        print(style.dim(
            "  Tip: narrow the scope with ignore patterns in "
            ".roundtable/config.json, or seat knights with bigger context.\n"))

    def round_footer(self, round_metric) -> None:
        """Per-round timing + engine throughput (SURVEY.md §5.1 — the
        tok/s surfaced where the reference had only spinner theater)."""
        from ..utils.metrics import aggregate_engine_stats
        agg = aggregate_engine_stats(round_metric.turns)
        line = f"\n  ⏱  Round {round_metric.round}: {round_metric.wall_s:.1f}s"
        if agg["prefill_tokens"] or agg["decode_tokens"]:
            total_in = agg["prefill_tokens"] + agg["reused_tokens"]
            pct = (round(100 * agg["reused_tokens"] / total_in)
                   if total_in else 0)
            tps = (f" @ {agg['decode_tps']:.0f} tok/s"
                   if agg["decode_seconds"] else "")
            line += (f" · prefill {agg['prefill_tokens']} tok "
                     f"({pct}% cache reuse)"
                     f" · decode {agg['decode_tokens']} tok{tps}")
        print(style.dim(line))
