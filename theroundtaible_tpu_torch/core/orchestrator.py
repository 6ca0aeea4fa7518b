"""The orchestrator — round loop until consensus, rejection, or escalation
(counterpart of theroundtaible_tpu/core/orchestrator.py).

Parity with reference src/orchestrator.ts:271-673:

- source budget = min over adapters' get_max_source_chars (fairness, :281-292)
- round 1 in priority order; later rounds shuffled against yes-man drift
  (:348-357)
- per-knight turn: status write → prompt build → execute with runtime
  fallback → consensus parse → file_requests/verify_commands resolution;
  a crashed knight is classified, hinted, and the round continues (:521-535)
- per-round: discussion.md rewrite, positive/negative consensus checks,
  escalation warning; terminal writes to decisions.md/status/chronicle
- "King sends back" resume via ContinueOptions (:313-344)

Engine addition: when every knight in a round is served by one adapter
that supports batched rounds (the torch-llm engine) and the config opts in
(`rules` extension `parallel_rounds`), the inner serial loop collapses into
one batched dispatch — knights speak simultaneously instead of seeing
same-round earlier turns. Default stays the reference's sequential semantics.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from pathlib import Path
from typing import Callable, Optional

from ..adapters.base import BaseAdapter, KnightTurn
from ..adapters.factory import create_adapter
from ..engine import deadlines
from ..utils import telemetry
from ..utils.chronicle import append_to_chronicle
from ..utils.context import ProjectContext, build_context
from ..utils.decree_log import (
    format_decrees_for_prompt,
    get_active_decrees,
    read_decree_log,
)
from ..utils.manifest import get_manifest_summary, read_manifest
from ..utils.session import (
    create_session,
    now_iso,
    update_status,
    write_decisions,
    write_discussion,
    write_transcript,
)
from ..utils.verify import resolve_verify_commands
from .consensus import (
    check_consensus,
    check_negative_consensus,
    strip_consensus_json,
    summarize_consensus,
    warn_missing_scope_at_consensus,
)
from .errors import classify_error, hint_for_kind
from .types import (
    ConsensusBlock,
    ContinueOptions,
    KnightConfig,
    RoundEntry,
    RoundtableConfig,
    SessionResult,
)

DEFAULT_MAX_SOURCE_CHARS = 200_000
GIT_DIFF_PROMPT_CHARS = 3000
FILE_REQUEST_DEFAULT_LINES = 200


class Reporter:
    """Display hooks for the command layer; the default is silent so the
    orchestrator stays import-safe for tests and embedding. The CLI installs
    a console reporter (commands/discuss.py)."""

    def context_start(self) -> None: ...
    def context_done(self, context: ProjectContext, manifest_features: int,
                     decree_count: int) -> None: ...
    def session_started(self, session_path: str, resumed: bool) -> None: ...
    def round_started(self, round_num: int, order: list[str],
                      shuffled: bool) -> None: ...
    def knight_skipped(self, knight: str) -> None: ...
    def knight_thinking(self, knight: str) -> Callable[[], None]:
        return lambda: None
    def knight_spoke(self, knight: str, round_num: int, display_text: str,
                     consensus: Optional[ConsensusBlock]) -> None: ...
    def knight_failed(self, knight: str, kind: str, message: str,
                      hint: Optional[str]) -> None: ...
    def fallback_engaged(self, knight: str, fallback_id: str) -> None: ...
    def resolving_files(self, knight: str, requests: list[str]) -> None: ...
    def resolving_commands(self, knight: str) -> None: ...
    def verify_event(self, kind: str, message: str) -> None: ...
    def consensus_reached(self, blocks: list[ConsensusBlock],
                          allowed_files: list[str]) -> None: ...
    def unanimous_rejection(self, blocks: list[ConsensusBlock]) -> None: ...
    def escalation_warning(self, round_num: int, rounds_left: int) -> None: ...
    def escalated(self, blocks: list[ConsensusBlock]) -> None: ...
    def overflow_warning(self, skipped: int, max_chars: int) -> None: ...
    def round_footer(self, round_metric) -> None: ...


def shuffle_order(knights: list[KnightConfig],
                  rng: Optional[random.Random] = None) -> list[KnightConfig]:
    order = list(knights)
    (rng or random).shuffle(order)
    return order


def _budget_kwargs(adapter: BaseAdapter, budget) -> dict:
    """The budget kwarg, but only for adapters that opted in
    (accepts_budget) — third-party/test subclasses overriding the
    legacy (turns, timeout_ms) signatures keep working unchanged."""
    if budget is not None and getattr(adapter, "accepts_budget", False):
        return {"budget": budget}
    return {}


def execute_with_fallback(
    primary: BaseAdapter, knight: KnightConfig, config: RoundtableConfig,
    prompt: str, timeout_ms: int, adapters: dict[str, BaseAdapter],
    reporter: Reporter, budget=None,
) -> tuple[str, BaseAdapter]:
    """Primary execute; on failure lazily create + cache the knight's
    configured fallback adapter and retry once (reference :45-73).
    Returns (response, the adapter that actually served it). `budget` is
    the knight's turn-rung Budget (engine/deadlines.py); the fallback
    attempt gets its own sibling node so a primary that burned the turn
    hanging still leaves the fallback the round's remaining time."""
    try:
        return primary.execute_for(
            knight.name, prompt, timeout_ms,
            **_budget_kwargs(primary, budget)), primary
    except Exception as primary_error:
        if not knight.fallback:
            raise
        cache_key = f"__fallback_{knight.name}"
        fallback = adapters.get(cache_key)
        if fallback is None:
            # on the primary's device: a CPU discussion never builds an
            # engine on the card for its fallback
            created = create_adapter(knight.fallback, config, timeout_ms,
                                     getattr(primary, "device", "cuda"))
            if created is not None and created.is_available():
                adapters[cache_key] = created
                fallback = created
        if fallback is None:
            raise primary_error
        reporter.fallback_engaged(knight.name, knight.fallback)
        fb_budget = budget.parent.child("turn") if (
            budget is not None and budget.parent is not None) else None
        return fallback.execute_for(
            knight.name, prompt, timeout_ms,
            **_budget_kwargs(fallback, fb_budget)), fallback


def select_lead_knight(knights: list[KnightConfig],
                       blocks: list[ConsensusBlock]) -> KnightConfig:
    """Top scorer of the last round; priority (lowest number) breaks ties;
    fallback = highest-priority knight (reference :114-141)."""
    if blocks:
        last_round = max(b.round for b in blocks)
        last_blocks = [b for b in blocks if b.round == last_round]
        if last_blocks:
            max_score = max(b.consensus_score for b in last_blocks)
            top = [b for b in last_blocks if b.consensus_score == max_score]
            by_name = {k.name: k for k in knights}
            candidates = sorted(
                (by_name[b.knight] for b in top if b.knight in by_name),
                key=lambda k: k.priority)
            if candidates:
                return candidates[0]
    return sorted(knights, key=lambda k: k.priority)[0]


def compute_allowed_files(blocks: list[ConsensusBlock]) -> list[str]:
    """Dedup union of all knights' files_to_modify (reference :145-158)."""
    seen: dict[str, None] = {}
    for block in blocks:
        for f in block.files_to_modify:
            seen.setdefault(f)
    return list(seen)


def resolve_file_requests(file_requests: list[str], project_root: str,
                          ignore_patterns: list[str]) -> str:
    """Read requested files with traversal/ignore guards and range syntax
    `path:start-end`; 200-line default cap (reference :164-222)."""
    import os
    import re

    results: list[str] = []
    for req in file_requests[:4]:
        m = re.match(r"^(.+?):(\d+)-(\d+)$", req)
        file_path = m.group(1) if m else req
        start = int(m.group(2)) if m else None
        end = int(m.group(3)) if m else None

        normalized = os.path.normpath(file_path).replace("\\", "/")
        if ".." in normalized.split("/") or normalized.startswith("/"):
            results.append(f"[DENIED] {req} — path traversal not allowed")
            continue
        if any(normalized.startswith(p) or f"/{p}/" in normalized
               for p in ignore_patterns):
            results.append(f"[DENIED] {req} — matches ignore pattern")
            continue
        full = Path(project_root) / normalized
        if not full.exists():
            results.append(f"[NOT FOUND] {req}")
            continue
        try:
            lines = full.read_text(encoding="utf-8",
                                   errors="replace").split("\n")
        except OSError:
            results.append(f"[ERROR] {req} — could not read file")
            continue
        if start is not None and end is not None:
            excerpt = "\n".join(lines[max(0, start - 1):min(len(lines), end)])
        else:
            excerpt = "\n".join(lines[:FILE_REQUEST_DEFAULT_LINES])
            if len(lines) > FILE_REQUEST_DEFAULT_LINES:
                excerpt += (f"\n...({len(lines) - FILE_REQUEST_DEFAULT_LINES}"
                            " more lines)")
        results.append(f"### {req}\n```\n{excerpt}\n```")
    return "\n\n".join(results)


def king_demand_text(language: str = "en") -> str:
    """The King's send-back demand, in the session's language."""
    from .prompt import scaffold_strings
    return scaffold_strings(language)["king_demand"]


def assemble_shared_context(king_demand: str, context: ProjectContext,
                            resolved_files: str, resolved_commands: str,
                            language: str = "en") -> str:
    """The knight-independent context block (reference :386-425's non-persona
    sections). Sits between the shared preamble and the knight tail so the
    whole head of every prompt is byte-identical across knights — the engine
    prefix-caches it once per round. Section banners are localized with the
    templates (prompt.scaffold_strings) so an nl session isn't Dutch rules
    stitched to English context headers."""
    from .prompt import scaffold_strings
    s = scaffold_strings(language)
    parts = [
        king_demand,
        s["git_branch"].format(branch=context.git_branch)
        if context.git_branch else "",
        (f"{s['git_diff']}\n```\n"
         f"{context.git_diff[:GIT_DIFF_PROMPT_CHARS]}\n```")
        if context.git_diff else "",
        f"{s['recent_commits']}\n{context.recent_commits}"
        if context.recent_commits else "",
        f"\n{s['project_files']}\n{context.key_file_contents}"
        if context.key_file_contents else "",
        f"\n{s['source_code']}\n{context.source_file_contents}"
        if context.source_file_contents else "",
        f"\n{s['requested_files']}\n{resolved_files}"
        if resolved_files else "",
        f"\n{s['verification_results']}\n{resolved_commands}"
        if resolved_commands else "",
    ]
    return "\n".join(p for p in parts if p)


@dataclass
class _RunState:
    all_rounds: list[RoundEntry]
    latest_blocks: dict[str, ConsensusBlock]
    resolved_files: str = ""
    resolved_commands: str = ""
    metrics: object = None  # SessionMetrics (utils/metrics.py)


def run_discussion(
    topic: str,
    config: RoundtableConfig,
    adapters: dict[str, BaseAdapter],
    project_root: str,
    read_source_code: bool = False,
    continue_from: Optional[ContinueOptions] = None,
    reporter: Optional[Reporter] = None,
    rng: Optional[random.Random] = None,
) -> SessionResult:
    """The hot loop owner (reference :271-673)."""
    reporter = reporter or Reporter()
    rules = config.rules
    threshold = rules.consensus_threshold
    timeout_ms = rules.timeout_per_turn_seconds * 1000

    # Fairness: every knight sees the same source budget = min over adapters.
    max_source_chars = DEFAULT_MAX_SOURCE_CHARS
    for knight in config.knights:
        adapter = adapters.get(knight.adapter)
        if adapter:
            budget = adapter.get_max_source_chars()
            if budget is not None and budget < max_source_chars:
                max_source_chars = budget

    reporter.context_start()
    context = build_context(project_root, config, read_source_code,
                            max_source_chars,
                            on_overflow=reporter.overflow_warning)
    manifest = read_manifest(project_root)
    manifest_summary = get_manifest_summary(manifest, config.language)
    decree_log = read_decree_log(project_root)
    active_decrees = get_active_decrees(decree_log)
    decrees_context = format_decrees_for_prompt(active_decrees,
                                                config.language)
    reporter.context_done(context, len(manifest.features), len(active_decrees))

    if continue_from:
        session_path = continue_from.session_path
    else:
        session_path = str(create_session(project_root, topic))
    reporter.session_started(session_path, resumed=continue_from is not None)

    sorted_knights = sorted(config.knights, key=lambda k: k.priority)
    state = _RunState(
        all_rounds=list(continue_from.all_rounds) if continue_from else [],
        latest_blocks={},
        resolved_files=continue_from.resolved_files if continue_from else "",
        resolved_commands=(continue_from.resolved_commands
                           if continue_from else ""),
    )
    if continue_from:
        for entry in continue_from.all_rounds:
            if entry.consensus:
                state.latest_blocks[entry.knight] = entry.consensus

    start_round = continue_from.start_round if continue_from else 1
    end_round = start_round + rules.max_rounds - 1
    king_demand = (king_demand_text(config.language)
                   if continue_from and continue_from.king_demand else "")

    from ..utils.metrics import SessionMetrics, maybe_profile
    state.metrics = SessionMetrics(session_path)

    # Time-ladder root: the discussion budget bounds every
    # round budget, which bounds every turn — threaded top-down through
    # the budget-aware adapters into the engines' prefill/decode/dispatch
    # rungs (engine/deadlines.py). Unset budgets are unbounded roots, so
    # the reference's timeout-per-turn-only behavior is the default.
    discussion_budget = deadlines.Budget.root(
        rules.discussion_budget_seconds, rung="discussion")

    # Span-tree root: the discussion span mirrors the root
    # Budget above; the per-session JSONL sink rides the span tree so
    # every child — across adapter pool threads and the scheduler —
    # lands in <session>/telemetry/spans.jsonl. Under maybe_profile the
    # "profile" root wraps this, sharing one trace id with xprof.
    tele_sink = (telemetry.session_sink(session_path)
                 if telemetry.ACTIVE else None)
    with maybe_profile(session_path), telemetry.span(
            "discussion", sink=tele_sink,
            session=Path(session_path).name, knights=len(sorted_knights)):
        for round_num in range(start_round, end_round + 1):
            if discussion_budget.expired:
                # Hard discussion budget exhausted: return PARTIAL
                # results through the normal escalation path (transcript
                # and blocks intact, culprit named) instead of letting
                # the window die with nothing.
                # The budget can also come from a configured discussion
                # rung cap, so name whichever bound actually applied.
                bound = (f"{rules.discussion_budget_seconds:.0f}s"
                         if rules.discussion_budget_seconds
                         else f"rung cap {deadlines.rung_cap('discussion'):.0f}s")
                reporter.verify_event(
                    "warning",
                    f"discussion budget ({bound}) exhausted before "
                    f"round {round_num} — returning partial results")
                break
            round_budget = discussion_budget.child(
                "round", timeout_s=rules.round_budget_seconds)
            is_first = round_num == start_round and not continue_from
            round_order = (sorted_knights if is_first
                           else shuffle_order(sorted_knights, rng))
            reporter.round_started(round_num, [k.name for k in round_order],
                                   shuffled=not is_first)

            state.metrics.start_round(round_num)
            with telemetry.span("round", round=round_num):
                _run_round_turns(
                    round_order, round_num, topic, config, adapters,
                    project_root, session_path, context, manifest_summary,
                    decrees_context, king_demand, state, timeout_ms,
                    reporter, round_budget)
            state.metrics.end_round()
            if state.metrics.rounds:
                reporter.round_footer(state.metrics.rounds[-1])

            write_discussion(session_path, state.all_rounds)
            write_transcript(session_path, state.all_rounds)
            current_blocks = list(state.latest_blocks.values())

            if check_consensus(current_blocks, threshold):
                state.metrics.finish("consensus_reached")
                return _finish_consensus(
                    topic, config, project_root, session_path, round_num,
                    current_blocks, state, reporter)

            if check_negative_consensus(current_blocks):
                state.metrics.finish("unanimous_rejection")
                return _finish_rejection(
                    topic, config, project_root, session_path, round_num,
                    current_blocks, state, reporter)

            if rules.escalate_to_user_after <= round_num < end_round:
                reporter.escalation_warning(round_num, end_round - round_num)

    state.metrics.finish("escalated")
    reporter.escalated(list(state.latest_blocks.values()))
    update_status(session_path, phase="escalated", consensus_reached=False,
                  round=end_round)
    return SessionResult(
        session_path=session_path, consensus=False, rounds=end_round,
        decision=None, blocks=list(state.latest_blocks.values()),
        all_rounds=state.all_rounds,
        resolved_files=state.resolved_files,
        resolved_commands=state.resolved_commands,
    )


def _build_turn_prompt(knight, config, topic, context, manifest_summary,
                       decrees_context, king_demand, state):
    from .prompt import build_knight_tail, build_shared_preamble

    shared = (build_shared_preamble(
        topic, context.chronicle, state.all_rounds, manifest_summary,
        decrees_context, config.language)
        + "\n" + assemble_shared_context(
            king_demand, context, state.resolved_files,
            state.resolved_commands, config.language))
    return shared + "\n" + build_knight_tail(knight, config.knights, topic,
                                             config.language)


def _batch_groups(round_order, adapters):
    """Partition the round into batch-capable adapter groups + the rest.

    Knights sharing one batch-capable adapter (same resident model) form a
    group served by ONE batched device program. DIFFERENT batch-capable
    adapters (heterogeneous fleet — per-model submeshes, engine/fleet.py)
    become separate groups that run CONCURRENTLY: their submeshes are
    disjoint chips, so the round's wall-clock is max, not sum. Knights on
    non-batchable adapters (CLI/API/local) stay on the serial path.
    """
    groups: dict[int, tuple[BaseAdapter, list]] = {}
    serial = []
    for k in round_order:
        a = adapters.get(k.adapter)
        # A KNOWN-sick batch adapter (open circuit breaker, dead engine)
        # routes its knights to the SERIAL path, where
        # execute_with_fallback engages each knight's configured
        # fallback — the discussion continues instead of the whole group
        # failing every round (the engine→adapter-fallback rung).
        # known_unhealthy, not is_available: grouping must stay cheap —
        # is_available lazily BUILDS the engine, which would serialize
        # first-round construction here instead of in the group pool.
        if (a is not None and a.supports_batched_rounds()
                and not a.known_unhealthy()):
            groups.setdefault(id(a), (a, []))[1].append(k)
        else:
            serial.append(k)
    # A lone batchable knight gains nothing from the batch path but would
    # lose its place in the speaking order (batch groups dispatch against
    # the round-start snapshot, ahead of serial knights) — keep the round
    # fully serial unless there's real batching or fleet concurrency.
    if sum(len(ks) for _, ks in groups.values()) < 2:
        return [], list(round_order)
    return list(groups.values()), serial


def _run_round_turns(round_order, round_num, topic, config, adapters,
                     project_root, session_path, context, manifest_summary,
                     decrees_context, king_demand, state, timeout_ms,
                     reporter, round_budget=None) -> None:
    if config.rules.parallel_rounds:
        groups, serial_order = _batch_groups(round_order, adapters)
    else:
        groups, serial_order = [], round_order

    if groups:
        # Batched dispatch: each group's knights speak against the same
        # transcript snapshot in ONE device program (SURVEY.md §7.1);
        # multiple groups (heterogeneous models) dispatch concurrently.
        update_status(session_path, phase="discussing", current_knight=None,
                      round=round_num)
        jobs = []
        for adapter, knights in groups:
            turns = [KnightTurn(
                knight_name=k.name,
                prompt=_build_turn_prompt(
                    k, config, topic, context, manifest_summary,
                    decrees_context, king_demand, state))
                for k in knights]
            jobs.append((adapter, knights, turns))

        # The round span lives on THIS thread; group jobs run on pool
        # threads, so the span context is handed across explicitly and
        # re-attached there (telemetry's cross-thread parenting seam) —
        # the engines' turn/prefill/decode spans then nest under the
        # right round in the session's JSONL.
        tele_ctx = telemetry.current_context() if telemetry.ACTIVE \
            else None

        def run_group(job):
            adapter, knights, turns = job
            t0 = time.monotonic()
            # Each group receives the round budget directly (the adapter
            # derives its own round-rung child): groups run CONCURRENTLY
            # on disjoint submeshes, so they share the round's
            # wall-clock, not a division of it.
            with telemetry.attached(tele_ctx):
                responses = adapter.execute_round(
                    turns, timeout_ms,
                    **_budget_kwargs(adapter, round_budget))
            if len(responses) != len(turns):
                raise RuntimeError(
                    f"batched round returned {len(responses)} responses "
                    f"for {len(turns)} turns")
            return responses, time.monotonic() - t0, adapter.last_stats()

        if len(jobs) == 1:
            results = [_try(run_group, jobs[0])]
        else:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
                results = list(pool.map(lambda j: _try(run_group, j), jobs))

        # Record in round order regardless of completion order.
        response_by_knight = {}
        retry_serially = []
        for (adapter, knights, turns), outcome in zip(jobs, results):
            if isinstance(outcome, Exception):
                # Group-failure degradation: the batched
                # dispatch (and the adapter's own serial retry) gave up —
                # fall through to the per-knight serial path below, where
                # execute_with_fallback retries the primary once more and
                # then engages the knight's configured fallback adapter.
                # Only knights that fail THERE too are reported failed.
                retry_serially.extend(knights)
                continue
            responses, group_wall, engine_stats = outcome
            if state.metrics:
                # one batched program served the whole group: group wall
                # for every knight, engine numbers attached once (to the
                # first knight) so totals don't multiply. Scheduler
                # provenance (queue wait, decode-batch occupancy) is a
                # property of the whole round, not a summable quantity —
                # every knight's turn record carries it.
                sched = (engine_stats or {}).get("sched") or {}
                for i, (k, t, resp) in enumerate(
                        zip(knights, turns, responses)):
                    state.metrics.record_turn(
                        k.name, round_num, group_wall,
                        chars_in=len(t.prompt), chars_out=len(resp),
                        engine=engine_stats if i == 0 else None,
                        queue_wait_s=sched.get("queue_wait_s"),
                        batch_occupancy=sched.get("occupancy_mean"))
            for k, resp in zip(knights, responses):
                response_by_knight[k.name] = (resp, adapter)
        for knight in round_order:
            if knight.name in response_by_knight:
                resp, adapter = response_by_knight[knight.name]
                _record_turn(knight, round_num, resp, adapter, config,
                             project_root, state, reporter)
        if retry_serially:
            serial_order = list(serial_order) + retry_serially

    for knight in serial_order:
        adapter = adapters.get(knight.adapter)
        if adapter is None:
            reporter.knight_skipped(knight.name)
            continue
        update_status(session_path, phase="discussing",
                      current_knight=knight.name, round=round_num)
        prompt = _build_turn_prompt(
            knight, config, topic, context, manifest_summary,
            decrees_context, king_demand, state)
        stop_thinking = reporter.knight_thinking(knight.name)
        t0 = time.monotonic()
        turn_budget = (round_budget.child(
            "turn", timeout_s=timeout_ms / 1000)
            if round_budget is not None else None)
        try:
            response, served_by = execute_with_fallback(
                adapter, knight, config, prompt, timeout_ms, adapters,
                reporter, budget=turn_budget)
        except Exception as error:  # noqa: BLE001 — turn-level containment
            stop_thinking()
            kind = classify_error(error)
            reporter.knight_failed(knight.name, kind, str(error),
                                   hint_for_kind(kind))
            continue
        stop_thinking()
        if state.metrics:
            state.metrics.record_turn(
                knight.name, round_num, time.monotonic() - t0,
                chars_in=len(prompt), chars_out=len(response),
                engine=served_by.last_stats())
        _record_turn(knight, round_num, response, served_by, config,
                     project_root, state, reporter)


def _try(fn, arg):
    """Run fn(arg), returning the exception instead of raising (used to
    contain per-group failures in the concurrent fan-out)."""
    try:
        return fn(arg)
    except Exception as e:  # noqa: BLE001 — containment by design
        return e


def _record_turn(knight, round_num, response, adapter, config, project_root,
                 state, reporter) -> None:
    consensus = adapter.parse_consensus(response, round_num)
    if consensus is not None:
        # Adapter-level parse keeps the adapter's own knight naming; pin the
        # turn to the configured knight name for transcript consistency.
        consensus.knight = knight.name
    entry = RoundEntry(knight=knight.name, round=round_num, response=response,
                       consensus=consensus, timestamp=now_iso())
    state.all_rounds.append(entry)
    display = strip_consensus_json(response)
    reporter.knight_spoke(knight.name, round_num, display, consensus)

    if consensus is None:
        return
    state.latest_blocks[knight.name] = consensus
    if consensus.file_requests:
        reporter.resolving_files(knight.name, consensus.file_requests)
        new_files = resolve_file_requests(
            consensus.file_requests, project_root, config.rules.ignore)
        if new_files:
            state.resolved_files += \
                ("\n\n" if state.resolved_files else "") + new_files
    if consensus.verify_commands:
        reporter.resolving_commands(knight.name)
        new_commands = resolve_verify_commands(
            consensus.verify_commands, project_root,
            on_event=reporter.verify_event)
        if new_commands:
            state.resolved_commands += \
                ("\n\n" if state.resolved_commands else "") + new_commands


def _finish_consensus(topic, config, project_root, session_path, round_num,
                      current_blocks, state, reporter) -> SessionResult:
    for block in current_blocks:
        warning = warn_missing_scope_at_consensus(block)
        if warning:
            reporter.verify_event("warning", warning)
    allowed_files = compute_allowed_files(current_blocks)
    reporter.consensus_reached(current_blocks, allowed_files)

    last_proposal = None
    for entry in reversed(state.all_rounds):
        if entry.consensus and entry.consensus.proposal:
            last_proposal = entry.consensus.proposal
            break
    if last_proposal is None:
        last_proposal = (state.all_rounds[-1].response if state.all_rounds
                         else "No proposal text available.")

    lead = select_lead_knight(config.knights, current_blocks)
    write_decisions(session_path, topic, last_proposal, state.all_rounds)
    update_status(session_path, phase="consensus_reached",
                  consensus_reached=True, round=round_num,
                  allowed_files=allowed_files if allowed_files else None,
                  lead_knight=lead.name)
    append_to_chronicle(
        project_root, config.chronicle, topic=topic,
        outcome=(f"Consensus in {round_num} round(s). "
                 f"Lead Knight: {lead.name}.\n\n{last_proposal}"),
        knights=[b.knight for b in current_blocks],
        date=datetime.now(timezone.utc).strftime("%Y-%m-%d"))
    return SessionResult(
        session_path=session_path, consensus=True, rounds=round_num,
        decision=last_proposal, blocks=current_blocks,
        all_rounds=state.all_rounds,
        resolved_files=state.resolved_files,
        resolved_commands=state.resolved_commands,
    )


def _finish_rejection(topic, config, project_root, session_path, round_num,
                      current_blocks, state, reporter) -> SessionResult:
    reporter.unanimous_rejection(current_blocks)
    rejection_summary = "\n\n---\n\n".join(
        f"## {r.knight}\n\n{r.response}"
        for r in state.all_rounds if r.round == round_num)
    write_decisions(session_path, topic, rejection_summary, state.all_rounds)
    update_status(session_path, phase="consensus_reached",
                  consensus_reached=True, round=round_num,
                  unanimous_rejection=True)
    append_to_chronicle(
        project_root, config.chronicle, topic=topic,
        outcome=(f"Unanimous rejection in {round_num} round(s). "
                 "All knights advise against this."),
        knights=[b.knight for b in current_blocks],
        date=datetime.now(timezone.utc).strftime("%Y-%m-%d"))
    return SessionResult(
        session_path=session_path, consensus=True, unanimous_rejection=True,
        rounds=round_num, decision=rejection_summary, blocks=current_blocks,
        all_rounds=state.all_rounds,
        resolved_files=state.resolved_files,
        resolved_commands=state.resolved_commands,
    )
