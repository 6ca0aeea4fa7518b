"""Scripted FakeAdapter — the hermetic test seam.

No reference counterpart (the reference has no fakes, SURVEY.md §4); this is
the harness its BaseAdapter seam was designed to enable: a deterministic
knight whose responses are scripted per call, driving full discuss flows
without any external process.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

from .base import BaseAdapter, DEFAULT_TIMEOUT_MS, KnightTurn

ScriptItem = Union[str, Exception]


class FakeAdapter(BaseAdapter):
    """Returns scripted responses in order; repeats the last one when the
    script runs out. An Exception in the script is raised instead."""

    def __init__(self, name: str = "Fake",
                 script: Optional[list[ScriptItem]] = None,
                 available: bool = True,
                 max_source_chars: Optional[int] = None,
                 on_execute: Optional[Callable[[str], None]] = None):
        super().__init__(name)
        self.script = list(script or [])
        self.available = available
        self.max_source_chars = max_source_chars
        self.on_execute = on_execute
        self.calls: list[str] = []
        self.batched_calls: list[list[str]] = []

    def is_available(self) -> bool:
        return self.available

    def get_max_source_chars(self) -> Optional[int]:
        return self.max_source_chars

    def execute(self, prompt: str, timeout_ms: int = DEFAULT_TIMEOUT_MS) -> str:
        self.calls.append(prompt)
        if self.on_execute:
            self.on_execute(prompt)
        if not self.script:
            return self._consensus_response(9)
        idx = min(len(self.calls) - 1, len(self.script) - 1)
        item = self.script[idx]
        if isinstance(item, Exception):
            raise item
        return item

    def execute_round(self, turns: list[KnightTurn],
                      timeout_ms: int = DEFAULT_TIMEOUT_MS) -> list[str]:
        self.batched_calls.append([t.prompt for t in turns])
        return super().execute_round(turns, timeout_ms)

    @staticmethod
    def _consensus_response(score: int, files: Optional[list[str]] = None,
                            text: str = "Sounds good.") -> str:
        import json
        block = {"consensus_score": score, "agrees_with": [],
                 "pending_issues": []}
        if files:
            block["files_to_modify"] = files
        return f"{text}\n```json\n{json.dumps(block)}\n```"


def scripted_response(score: int, text: str = "My analysis.",
                      files: Optional[list[str]] = None,
                      file_requests: Optional[list[str]] = None,
                      verify_commands: Optional[list[str]] = None,
                      pending: Optional[list[str]] = None,
                      proposal: Optional[str] = None) -> str:
    """Build a well-formed knight response for scripting tests."""
    import json
    block: dict = {"consensus_score": score, "agrees_with": [],
                   "pending_issues": pending or []}
    if files is not None:
        block["files_to_modify"] = files
    if file_requests is not None:
        block["file_requests"] = file_requests
    if verify_commands is not None:
        block["verify_commands"] = verify_commands
    if proposal is not None:
        block["proposal"] = proposal
    return f"{text}\n```json\n{json.dumps(block)}\n```"
