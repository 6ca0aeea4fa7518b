"""King's Decree Log — append-only record of rejected/deferred decisions.

Parity with reference src/utils/decree-log.ts:1-103. Decrees are injected into
knight prompts so rejected ideas are not re-proposed without addressing the
rejection reason.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Optional

from ..core.types import DecreeEntry, DecreeLog
from .session import now_iso

DECREE_LOG_RELPATH = Path(".roundtable") / "decree-log.json"

_ID_RE = re.compile(r"^decree-(\d+)$")


def read_decree_log(project_root: str | Path) -> DecreeLog:
    log_path = Path(project_root) / DECREE_LOG_RELPATH
    if not log_path.exists():
        return DecreeLog()
    try:
        parsed = json.loads(log_path.read_text(encoding="utf-8"))
        if parsed.get("version") == "1.0" and isinstance(parsed.get("entries"), list):
            return DecreeLog.from_dict(parsed)
    except (json.JSONDecodeError, OSError):
        pass
    return DecreeLog()


def _next_decree_id(log: DecreeLog) -> str:
    max_num = 0
    for e in log.entries:
        m = _ID_RE.match(e.id)
        if m:
            max_num = max(max_num, int(m.group(1)))
    return f"decree-{max_num + 1:03d}"


def add_decree_entry(project_root: str | Path, type_: str, session: str,
                     topic: str, reason: Optional[str] = None) -> DecreeEntry:
    """Append one decree (reference decree-log.ts:48-73). The read-
    modify-write runs under a PID-stale-aware lock (utils/lock.py) and
    the write is atomic (a crash mid-write must not truncate the log)."""
    from .lock import FileLock
    from .session import atomic_write_text

    log_path = Path(project_root) / DECREE_LOG_RELPATH
    log_path.parent.mkdir(parents=True, exist_ok=True)
    with FileLock(log_path):
        log = read_decree_log(project_root)
        entry = DecreeEntry(
            id=_next_decree_id(log),
            type=type_,
            session=session,
            topic=topic,
            reason=(reason or "").strip() or "No reason provided",
            revoked=False,
            date=now_iso(),
        )
        log.entries.append(entry)
        atomic_write_text(log_path,
                          json.dumps(log.to_dict(), indent=2) + "\n")
    return entry


def revoke_decree(project_root: str | Path, decree_id: str) -> bool:
    """Mark a decree revoked so it stops being injected into prompts.
    Same lock as add_decree_entry — an advisory lock only serializes
    writers that all take it."""
    from .lock import FileLock
    from .session import atomic_write_text

    log_path = Path(project_root) / DECREE_LOG_RELPATH
    with FileLock(log_path):
        log = read_decree_log(project_root)
        for e in log.entries:
            if e.id == decree_id:
                e.revoked = True
                atomic_write_text(
                    log_path, json.dumps(log.to_dict(), indent=2) + "\n")
                return True
    return False


def get_active_decrees(log: DecreeLog, max_entries: int = 5) -> list[DecreeEntry]:
    """Last `max_entries` non-revoked decrees (reference decree-log.ts:79-83)."""
    active = [e for e in log.entries if not e.revoked]
    return active[-max_entries:]


def format_decrees_for_prompt(decrees: list[DecreeEntry],
                              language: str = "en") -> str:
    """Prompt injection block (reference decree-log.ts:89-103; its
    banner is Dutch — ours localizes with the session language)."""
    if not decrees:
        return ""
    from ..core.prompt import scaffold_strings
    lines = []
    for d in decrees:
        date_short = d.date[:10]
        topic_short = d.topic[:47] + "..." if len(d.topic) > 50 else d.topic
        lines.append(f'- [{d.id}] {d.type.upper()} — "{topic_short}": '
                     f'"{d.reason}" ({date_short})')
    return "\n".join([scaffold_strings(language)["decrees_banner"],
                      *lines])
