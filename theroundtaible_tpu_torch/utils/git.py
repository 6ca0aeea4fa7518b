"""Git context helpers — branch, diff, recent commits.

Parity with reference src/utils/git.ts:1-41: every helper is failure-tolerant
and returns None when git is absent or the cwd is not a repository.
"""

from __future__ import annotations

import subprocess
from typing import Optional


def _run_git(args: list[str], cwd: Optional[str] = None) -> Optional[str]:
    try:
        proc = subprocess.run(
            ["git", *args], capture_output=True, text=True, timeout=15, cwd=cwd,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    return proc.stdout


def get_git_branch(cwd: Optional[str] = None) -> Optional[str]:
    out = _run_git(["rev-parse", "--abbrev-ref", "HEAD"], cwd)
    return out.strip() if out else None


def get_git_diff(cwd: Optional[str] = None) -> Optional[str]:
    """Staged + unstaged diff concatenated (reference git.ts:18-27)."""
    staged = _run_git(["diff", "--cached"], cwd)
    unstaged = _run_git(["diff"], cwd)
    parts = [p for p in (staged, unstaged) if p]
    combined = "\n".join(parts)
    return combined or None


def get_recent_commits(n: int = 5, cwd: Optional[str] = None) -> Optional[str]:
    out = _run_git(["log", "--oneline", f"-{n}"], cwd)
    if out is None:
        return None
    return out.strip() or None
