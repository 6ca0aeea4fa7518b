"""The knight boundary - abstract adapter contract (counterpart of
theroundtaible_tpu/adapters/base.py). Consensus parsing comes with the
orchestrator slice."""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Optional

DEFAULT_TIMEOUT_MS = 120_000


@dataclass
class KnightTurn:
    """One prompt in a batched round dispatch."""

    knight_name: str
    prompt: str


class BaseAdapter(ABC):
    """execute / is_available / get_max_source_chars, plus the batched
    `execute_round` extension engine-backed adapters override."""

    # True when execute_round/execute_for accept a `budget` keyword.
    accepts_budget = False

    def __init__(self, name: str):
        self.name = name

    @abstractmethod
    def execute(self, prompt: str, timeout_ms: int = DEFAULT_TIMEOUT_MS) -> str:
        """Run one prompt to completion and return the raw response text."""

    def execute_for(self, knight_name: str, prompt: str,
                    timeout_ms: int = DEFAULT_TIMEOUT_MS,
                    budget=None) -> str:
        """Execute one turn attributed to `knight_name`; engine-backed
        adapters override so the knight keeps its own KV slot."""
        return self.execute(prompt, timeout_ms)

    @abstractmethod
    def is_available(self) -> bool:
        """Probe whether this backend can serve requests right now."""

    def get_max_source_chars(self) -> Optional[int]:
        """Context-budget hook: max source chars this knight can carry
        (None = no special limit)."""
        return None

    def supports_batched_rounds(self) -> bool:
        """True when execute_round is a genuine batched dispatch."""
        return False

    def known_unhealthy(self) -> bool:
        """Cheap, non-constructive health check."""
        return False

    def last_stats(self) -> Optional[dict]:
        """Engine-side numbers for the most recent call, or None."""
        return None

    def execute_round(self, turns: list[KnightTurn],
                      timeout_ms: int = DEFAULT_TIMEOUT_MS,
                      budget=None) -> list[str]:
        """Execute N same-round prompts. Default: serial execute_for."""
        return [self.execute_for(t.knight_name, t.prompt, timeout_ms)
                for t in turns]
