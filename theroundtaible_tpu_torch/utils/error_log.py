"""Code-red error log — `.roundtable/error-log.md` with CR-XXX entries.

Reference behavior: "Error log management (CR-XXX, OPEN/RESOLVED/PARKED)"
(reference TODO.md:60; README.md:159-175). Markdown, append-plus-status-
update: new incidents append an OPEN entry; outcomes flip the status line.
"""

from __future__ import annotations

import re
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

ERROR_LOG_RELPATH = Path(".roundtable") / "error-log.md"

_HEADER = "# Code-Red Error Log\n\n"
_ID_RE = re.compile(r"^## (CR-\d{3})\b", re.MULTILINE)
_STATUS_VALUES = ("OPEN", "RESOLVED", "PARKED")


def _log_path(project_root: str | Path) -> Path:
    return Path(project_root) / ERROR_LOG_RELPATH


def read_error_log(project_root: str | Path) -> str:
    p = _log_path(project_root)
    return p.read_text(encoding="utf-8") if p.exists() else ""


def next_cr_id(project_root: str | Path) -> str:
    content = read_error_log(project_root)
    nums = [int(m[3:]) for m in _ID_RE.findall(content)]
    return f"CR-{(max(nums) + 1 if nums else 1):03d}"


def add_error_entry(project_root: str | Path, symptoms: str,
                    diagnosis: Optional[str], status: str = "OPEN",
                    session: str = "") -> str:
    """Append one CR entry; returns its id."""
    assert status in _STATUS_VALUES
    cr_id = next_cr_id(project_root)
    date = datetime.now(timezone.utc).strftime("%Y-%m-%d")
    lines = [
        f"## {cr_id} — {date}",
        f"**Status:** {status}",
        f"**Symptoms:** {symptoms}",
    ]
    if session:
        lines.append(f"**Session:** {session}")
    if diagnosis:
        lines.append(f"\n{diagnosis}")
    lines.append("\n---\n")
    p = _log_path(project_root)
    p.parent.mkdir(parents=True, exist_ok=True)
    existing = read_error_log(project_root) or _HEADER
    p.write_text(existing + "\n".join(lines) + "\n", encoding="utf-8")
    return cr_id


def set_entry_status(project_root: str | Path, cr_id: str,
                     status: str) -> bool:
    """Flip one entry's **Status:** line (OPEN → RESOLVED/PARKED)."""
    assert status in _STATUS_VALUES
    content = read_error_log(project_root)
    if f"## {cr_id}" not in content:
        return False
    pattern = re.compile(
        rf"(## {re.escape(cr_id)}[^\n]*\n\*\*Status:\*\* )\w+")
    new = pattern.sub(rf"\g<1>{status}", content)
    _log_path(project_root).write_text(new, encoding="utf-8")
    return True


def count_by_status(project_root: str | Path) -> dict[str, int]:
    content = read_error_log(project_root)
    counts = {s: 0 for s in _STATUS_VALUES}
    for m in re.finditer(r"^\*\*Status:\*\* (\w+)", content, re.MULTILINE):
        if m.group(1) in counts:
            counts[m.group(1)] += 1
    return counts
