"""CLI-spawn adapters: Claude, Gemini, Codex (OpenAI).

Parity with reference src/adapters/{claude-cli,gemini-cli,openai-cli}.ts.
Each spawns the vendor CLI with the prompt on stdin, read-only tool settings,
and a per-turn timeout; availability is a `--version` probe.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Optional

from ..core.errors import AdapterError, classify_error
from .base import BaseAdapter, DEFAULT_TIMEOUT_MS


def _probe_version(command: str) -> bool:
    try:
        proc = subprocess.run([command, "--version"], capture_output=True,
                              timeout=15)
        return proc.returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False


def _spawn(command: str, args: list[str], prompt: str, timeout_ms: int,
           env: Optional[dict[str, str]] = None) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(
            [command, *args], input=prompt, capture_output=True, text=True,
            timeout=timeout_ms / 1000, env=env, errors="replace",
        )
    except subprocess.TimeoutExpired as e:
        raise AdapterError(f"{command} timed out after {timeout_ms // 1000}s",
                           kind="timeout", cause=e)
    except OSError as e:
        raise AdapterError(f"{command} not found: {e}", kind="not_installed",
                           cause=e)


class ClaudeCliAdapter(BaseAdapter):
    """`claude --print` with write tools disabled (reference claude-cli.ts:5-58)."""

    DISALLOWED_TOOLS = ("Edit,Write,Bash,Read,Glob,Grep,NotebookEdit,"
                        "WebFetch,WebSearch,Task")

    def __init__(self, command: str = "claude",
                 timeout_ms: int = DEFAULT_TIMEOUT_MS):
        super().__init__("Claude")
        self.command = command
        self.default_timeout = timeout_ms

    def is_available(self) -> bool:
        return _probe_version(self.command)

    def execute(self, prompt: str, timeout_ms: int = DEFAULT_TIMEOUT_MS) -> str:
        # Drop CLAUDECODE so the CLI also runs nested inside another claude
        # session (reference claude-cli.ts:33-34 — empty string is not
        # enough).
        env = dict(os.environ)
        env.pop("CLAUDECODE", None)
        result = _spawn(self.command, [
            "--print", "--output-format", "text",
            "--disallowedTools", self.DISALLOWED_TOOLS,
        ], prompt, timeout_ms or self.default_timeout, env=env)
        if result.returncode != 0:
            msg = result.stderr or result.stdout or "Unknown error"
            raise AdapterError(
                f"Claude CLI failed (exit {result.returncode}): {msg}",
                kind=classify_error(RuntimeError(msg)))
        return result.stdout


class GeminiCliAdapter(BaseAdapter):
    """`gemini -p "" --approval-mode plan` (reference gemini-cli.ts:5-77)."""

    # The CLI's own default model often 429s for free accounts; pin a stable
    # one unless config overrides (reference gemini-cli.ts:8-11).
    DEFAULT_MODEL = "gemini-2.5-pro"

    def __init__(self, command: str = "gemini", model: Optional[str] = None,
                 timeout_ms: int = DEFAULT_TIMEOUT_MS):
        super().__init__("Gemini")
        self.command = command
        self.model = model or self.DEFAULT_MODEL
        self.default_timeout = timeout_ms

    def is_available(self) -> bool:
        return _probe_version(self.command)

    def execute(self, prompt: str, timeout_ms: int = DEFAULT_TIMEOUT_MS) -> str:
        timeout = timeout_ms or self.default_timeout
        base_args = ["-p", "", "--approval-mode", "plan", "-o", "text",
                     "-m", self.model]
        result = _spawn(self.command, base_args, prompt, timeout)
        # plan mode needs experimental.plan in gemini config — retry without
        # (reference gemini-cli.ts:53-59).
        if result.returncode != 0 and "approval-mode" in (result.stderr or ""):
            result = _spawn(self.command,
                            ["-p", "", "-o", "text", "-m", self.model],
                            prompt, timeout)
        # Non-zero exits with usable stdout happen on tool denials in plan
        # mode; accept output > 50 chars (reference gemini-cli.ts:62-65).
        if result.stdout and len(result.stdout.strip()) > 50:
            return result.stdout
        if result.returncode != 0:
            msg = result.stderr or result.stdout or "Unknown error"
            raise AdapterError(
                f"Gemini CLI failed (exit {result.returncode}): {msg}",
                kind=classify_error(RuntimeError(msg)))
        return result.stdout


class OpenAICliAdapter(BaseAdapter):
    """`codex exec - --json` JSONL stream parsing (reference openai-cli.ts:5-94)."""

    def __init__(self, command: str = "codex",
                 timeout_ms: int = DEFAULT_TIMEOUT_MS):
        super().__init__("GPT")
        self.command = command
        self.default_timeout = timeout_ms

    def is_available(self) -> bool:
        return _probe_version(self.command)

    @staticmethod
    def _inside_git_repo() -> bool:
        try:
            proc = subprocess.run(
                ["git", "rev-parse", "--is-inside-work-tree"],
                capture_output=True, timeout=10)
            return proc.returncode == 0
        except (OSError, subprocess.TimeoutExpired):
            return False

    @staticmethod
    def extract_agent_message(jsonl: str) -> str:
        """Collect text from item.completed/agent_message events; ignore
        non-JSON log lines (reference openai-cli.ts:41-56)."""
        parts: list[str] = []
        for line in jsonl.splitlines():
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                evt = json.loads(line)
            except json.JSONDecodeError:
                continue
            item = evt.get("item") or {}
            if (evt.get("type") == "item.completed"
                    and item.get("type") == "agent_message"
                    and isinstance(item.get("text"), str)):
                parts.append(item["text"])
        return "\n".join(parts).strip()

    def execute(self, prompt: str, timeout_ms: int = DEFAULT_TIMEOUT_MS) -> str:
        args = ["exec", "-", "--sandbox", "read-only", "--json",
                "--color", "never"]
        if not self._inside_git_repo():
            args.append("--skip-git-repo-check")
        result = _spawn(self.command, args, prompt,
                        timeout_ms or self.default_timeout)
        if result.returncode != 0:
            msg = result.stderr or result.stdout or "Unknown error"
            raise AdapterError(
                f"Codex CLI failed (exit {result.returncode}): {msg}",
                kind=classify_error(RuntimeError(msg)))
        message = self.extract_agent_message(result.stdout)
        if not message:
            raise AdapterError("Codex CLI returned no agent_message events",
                               kind="api")
        return message
