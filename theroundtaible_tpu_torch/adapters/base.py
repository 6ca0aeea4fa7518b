"""The knight boundary — abstract adapter contract.

Parity with reference src/adapters/base.ts:10-29 plus the one TPU-build
extension from SURVEY.md §7.1: a batched ``execute_round`` entry point that
lets the in-tree engine collapse a round's N-knight fan-out into a single
device program. Serial ``execute`` stays the contract for cloud/CLI adapters.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Optional

from ..core.consensus import parse_consensus_from_response
from ..core.types import ConsensusBlock

DEFAULT_TIMEOUT_MS = 120_000


@dataclass
class KnightTurn:
    """One prompt in a batched round dispatch."""

    knight_name: str
    prompt: str


class BaseAdapter(ABC):
    """4-method contract (reference base.ts:10-29)."""

    # True when execute_round/execute_for accept a `budget` keyword (an
    # engine/deadlines.Budget node). The orchestrator only passes one to
    # adapters that opt in, so third-party/test subclasses overriding
    # execute_round with the legacy (turns, timeout_ms) signature keep
    # working unchanged.
    accepts_budget = False

    def __init__(self, name: str):
        self.name = name

    @abstractmethod
    def execute(self, prompt: str, timeout_ms: int = DEFAULT_TIMEOUT_MS) -> str:
        """Run one prompt to completion and return the raw response text."""

    def execute_for(self, knight_name: str, prompt: str,
                    timeout_ms: int = DEFAULT_TIMEOUT_MS,
                    budget=None) -> str:
        """Execute one turn attributed to `knight_name`. Cloud/CLI
        adapters ignore the name (and the budget — their own process
        timeouts bound the turn); engine-backed adapters override so the
        knight keeps its own KV slot and per-knight sampling even when a
        round degrades from the batched path to serial turns."""
        return self.execute(prompt, timeout_ms)

    @abstractmethod
    def is_available(self) -> bool:
        """Probe whether this backend can serve requests right now."""

    def get_max_source_chars(self) -> Optional[int]:
        """Context-budget hook: max source chars this knight can carry.

        None means "no special limit" → orchestrator default 200KB
        (reference base.ts:22-24, orchestrator.ts:281-292).
        """
        return None

    def parse_consensus(self, response: str, round_num: int
                        ) -> Optional[ConsensusBlock]:
        """Default delegates to the consensus engine (reference base.ts:26-28)."""
        return parse_consensus_from_response(response, self.name, round_num)

    # --- TPU-build extension ---

    def supports_batched_rounds(self) -> bool:
        """True when execute_round is a genuine batched dispatch."""
        return False

    def known_unhealthy(self) -> bool:
        """Cheap, NON-constructive health check: True only when this
        adapter already knows it cannot serve (open circuit breaker,
        memoized dead engine). Unlike is_available() it must never
        trigger lazy engine construction — the orchestrator calls it
        synchronously while forming batch groups."""
        return False

    def last_stats(self) -> Optional[dict]:
        """Engine-side numbers for the most recent execute/execute_round
        (token counts, prefill/decode tok/s) — None for backends that
        don't measure. Consumed by the session metrics (utils/metrics.py)."""
        return None

    def execute_round(self, turns: list[KnightTurn],
                      timeout_ms: int = DEFAULT_TIMEOUT_MS,
                      budget=None) -> list[str]:
        """Execute N same-round prompts. Default: serial loop over execute().

        The tpu-llm adapter overrides this with one batched forward pass over
        N persistent KV slots (SURVEY.md §2.3 parallelism table) and
        splits `budget` (a round-rung deadlines.Budget) across the
        batched attempt and any serial retries.
        """
        return [self.execute_for(t.knight_name, t.prompt, timeout_ms)
                for t in turns]
