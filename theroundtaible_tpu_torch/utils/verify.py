"""Sandboxed read-only execution of knight `verify_commands`.

Parity with reference src/utils/verify.ts:1-174: a 14-command whitelist,
forbidden-pattern and forbidden-command checks, redirect checks after
stripping safe stderr redirects, escaped-pipe-aware pipe-segment validation,
sensitive-env stripping, `bash -c` execution with 5s timeout / 1MB buffer /
5000-char output truncation, max 4 commands per invocation.
"""

from __future__ import annotations

import os
import re
import subprocess
from typing import Callable, Optional

WHITELISTED_COMMANDS = frozenset({
    "ls", "cat", "head", "tail", "grep", "find", "wc",
    "file", "stat", "sort", "uniq", "basename", "dirname",
})

# (pattern, human label) — command chaining/substitution/write hazards.
# Tighter than the reference's list (verify.ts:18-28): we additionally reject
# lone '&' (background chaining), newlines/CR (bash command separators), and
# find's file-writing actions (-fprint/-fprintf/-fls) — all of which slip
# through the reference's checks but reach `bash -c`.
_FORBIDDEN_PATTERNS: list[tuple[re.Pattern, str]] = [
    (re.compile(r";"), ";"),
    (re.compile(r"[\n\r]"), "newline"),
    (re.compile(r"`"), "`"),
    (re.compile(r"\$\("), r"\$\("),
    (re.compile(r"\$\{"), r"\$\{"),
    (re.compile(r"&"), "&"),
    (re.compile(r"\|\|"), r"\|\|"),
    (re.compile(r"-exec\b"), r"-exec\b"),
    (re.compile(r"-execdir\b"), r"-execdir\b"),
    (re.compile(r"-delete\b"), r"-delete\b"),
    (re.compile(r"-ok\b"), r"-ok\b"),
    (re.compile(r"-okdir\b"), r"-okdir\b"),
    (re.compile(r"-fprint\w*\b"), r"-fprint*"),
    (re.compile(r"-fls\b"), r"-fls\b"),
]

FORBIDDEN_COMMANDS = frozenset({
    "rm", "mv", "cp", "chmod", "chown", "chgrp",
    "curl", "wget", "eval", "source", "node", "python",
    "python3", "ruby", "perl", "php", "bash", "sh", "zsh",
    "npm", "npx", "yarn", "pnpm", "pip", "apt", "brew",
    "dd", "mkfs", "mount", "umount", "kill", "pkill",
    "ssh", "scp", "rsync", "nc", "ncat", "telnet",
})

SENSITIVE_ENV_KEYS = (
    "OPENAI_API_KEY", "ANTHROPIC_API_KEY", "GEMINI_API_KEY",
    "GOOGLE_API_KEY", "AWS_SECRET_ACCESS_KEY", "AWS_ACCESS_KEY_ID",
    "GITHUB_TOKEN", "GH_TOKEN", "NPM_TOKEN", "CLAUDECODE",
)

MAX_COMMANDS = 4
TIMEOUT_SECONDS = 5
MAX_BUFFER_BYTES = 1024 * 1024
OUTPUT_TRUNCATE_CHARS = 5000

_ESCAPED_PIPE_SENTINEL = "\x00ESCAPED_PIPE\x00"


def validate_command(command: str) -> Optional[str]:
    """Return None if the command is allowed, else a rejection reason
    (reference verify.ts:55-101)."""
    trimmed = command.strip()
    if not trimmed:
        return "empty command"

    # Strip safe stderr redirects (2>/dev/null, 2>&1) BEFORE all pattern
    # checks so the '&' in 2>&1 and the '>' in both are not misflagged.
    without_safe = re.sub(r"2>\s*/dev/null", "", trimmed)
    without_safe = without_safe.replace("2>&1", "")

    for pattern, label in _FORBIDDEN_PATTERNS:
        if pattern.search(without_safe):
            return f"forbidden pattern: {label}"

    if ">>" in without_safe:
        return "forbidden pattern: append redirect (>>)"
    if ">" in without_safe:
        return "forbidden pattern: output redirect (>)"
    if "<" in without_safe:
        return "forbidden pattern: input redirect (<)"

    # Split on real pipes only — grep's escaped \| alternation is preserved.
    segments = [
        s.replace(_ESCAPED_PIPE_SENTINEL, r"\|").strip()
        for s in trimmed.replace(r"\|", _ESCAPED_PIPE_SENTINEL).split("|")
    ]
    for segment in segments:
        if not segment:
            return "empty pipe segment"
        base = segment.split()[0]
        if base in FORBIDDEN_COMMANDS:
            return f"forbidden command: {base}"
        if base not in WHITELISTED_COMMANDS:
            return f"command not whitelisted: {base}"
        # Per-command write-capable flags of otherwise read-only commands.
        if base == "sort" and re.search(r"(^|\s)(-o\b|--output)", segment):
            return "forbidden flag: sort -o/--output writes files"
    return None


def sanitized_env() -> dict[str, str]:
    env = dict(os.environ)
    for key in SENSITIVE_ENV_KEYS:
        env.pop(key, None)
    return env


def _execute_command(command: str, project_root: str, env: dict[str, str]) -> str:
    try:
        proc = subprocess.run(
            ["bash", "-c", command],
            cwd=project_root, env=env, capture_output=True, text=True,
            timeout=TIMEOUT_SECONDS, errors="replace",
        )
    except subprocess.TimeoutExpired:
        return f"### VERIFY: {command}\n```\n[TIMEOUT after {TIMEOUT_SECONDS}s]\n```"
    except OSError as e:
        return f"### VERIFY: {command}\n```\n[ERROR] {e}\n```"

    output = (proc.stdout or "")[:MAX_BUFFER_BYTES].strip()
    err_output = (proc.stderr or "")[:MAX_BUFFER_BYTES].strip()
    truncated = (output[:OUTPUT_TRUNCATE_CHARS] + "\n...(truncated)"
                 if len(output) > OUTPUT_TRUNCATE_CHARS else output)
    if proc.returncode != 0:
        # Show output even on non-zero exit (e.g. grep with no match).
        combined = truncated or err_output or f"exit code {proc.returncode}"
        return f"### VERIFY: {command}\n```\n{combined}\n```"
    return f"### VERIFY: {command}\n```\n{truncated or '(empty output)'}\n```"


def resolve_verify_commands(
    commands: list[str], project_root: str,
    on_event: Optional[Callable[[str, str], None]] = None,
) -> str:
    """Validate + execute up to 4 commands, return the combined report
    (reference verify.ts:148-174). ``on_event(kind, message)`` receives
    "denied"/"running" notifications for the CLI layer to display.
    """
    results: list[str] = []
    env = sanitized_env()
    for command in commands[:MAX_COMMANDS]:
        error = validate_command(command)
        if error:
            results.append(f"### VERIFY: {command}\n```\n[DENIED] {error}\n```")
            if on_event:
                on_event("denied", f"[DENIED] {command} — {error}")
            continue
        if on_event:
            on_event("running", f"Running: {command}")
        results.append(_execute_command(command, project_root, env))
    return "\n\n".join(results)
