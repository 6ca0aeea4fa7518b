"""Session store — `.roundtable/sessions/<date>-<time>-<slug>/`.

Byte-compatible with reference src/utils/session.ts:21-212: each session dir
holds topic.md, discussion.md (full rewrite per round), decisions.md (terminal
states), status.json (read-merge-write).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Optional

from ..core.types import RoundEntry, SessionStatus, format_score

SESSIONS_SUBDIR = Path(".roundtable") / "sessions"


def atomic_write_text(path: str | Path, text: str) -> None:
    """Write-to-temp + os.replace so a crash mid-write can never leave a
    truncated file — crash resume (`discuss --continue`) reads these files,
    so in-place write_text would undercut the very thing it enables."""
    path = Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def now_iso() -> str:
    """UTC ISO-8601 with milliseconds + Z, matching JS Date.toISOString()."""
    now = datetime.now(timezone.utc)
    return now.strftime("%Y-%m-%dT%H:%M:%S.") + f"{now.microsecond // 1000:03d}Z"


def slugify(text: str, max_len: int = 50) -> str:
    """Topic → folder slug (reference session.ts:9-15)."""
    slug = re.sub(r"[^a-z0-9]+", "-", text.lower()).strip("-")
    return slug[:max_len]


def create_session(project_root: str | Path, topic: str) -> Path:
    """Create a session dir with topic.md + initial status.json
    (reference session.ts:21-57)."""
    now = datetime.now(timezone.utc)
    name = f"{now.strftime('%Y-%m-%d')}-{now.strftime('%H%M')}-{slugify(topic)}"
    session_path = Path(project_root) / SESSIONS_SUBDIR / name
    session_path.mkdir(parents=True, exist_ok=True)

    (session_path / "topic.md").write_text(f"# Topic\n\n{topic}\n", encoding="utf-8")

    status = SessionStatus(
        phase="discussing",
        current_knight=None,
        round=0,
        consensus_reached=False,
        started_at=now_iso(),
        updated_at=now_iso(),
    )
    _write_status(session_path, status)
    return session_path


def _write_status(session_path: Path, status: SessionStatus) -> None:
    atomic_write_text(session_path / "status.json",
                      json.dumps(status.to_dict(), indent=2))


def write_transcript(session_path: str | Path,
                     rounds: list[RoundEntry]) -> None:
    """Machine-readable twin of discussion.md, rewritten per round.

    This is what makes crash resume (`discuss --continue`) possible — the
    reference persists only display markdown, so a dead process loses the
    structured transcript (TODO.md:179 future work). Schema: a JSON list
    of RoundEntry dicts with the consensus block inlined."""
    payload = []
    for e in rounds:
        payload.append({
            "knight": e.knight,
            "round": e.round,
            "response": e.response,
            "timestamp": e.timestamp,
            "consensus": e.consensus.to_dict() if e.consensus else None,
        })
    atomic_write_text(Path(session_path) / "transcript.json",
                      json.dumps(payload, indent=1))


def read_transcript(session_path: str | Path) -> list[RoundEntry]:
    """Rebuild RoundEntries from transcript.json (empty if absent)."""
    from ..core.types import ConsensusBlock

    path = Path(session_path) / "transcript.json"
    if not path.exists():
        return []
    try:
        payload = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return []
    entries = []
    for d in payload:
        block = None
        if d.get("consensus"):
            c = d["consensus"]
            block = ConsensusBlock(
                knight=c.get("knight", d.get("knight", "")),
                round=int(c.get("round", d.get("round", 1))),
                consensus_score=float(c.get("consensus_score", 0)),
                agrees_with=list(c.get("agrees_with", [])),
                pending_issues=list(c.get("pending_issues", [])),
                proposal=c.get("proposal"),
                files_to_modify=list(c.get("files_to_modify", [])),
                file_requests=list(c.get("file_requests", [])),
                verify_commands=list(c.get("verify_commands", [])),
            )
        entries.append(RoundEntry(
            knight=d.get("knight", ""), round=int(d.get("round", 1)),
            response=d.get("response", ""),
            timestamp=d.get("timestamp", ""), consensus=block))
    return entries


def write_discussion(session_path: str | Path, rounds: list[RoundEntry]) -> None:
    """Full rewrite of discussion.md (reference session.ts:62-89)."""
    lines: list[str] = ["# Discussion\n"]
    for entry in rounds:
        lines.append(f"## Round {entry.round} — {entry.knight}")
        lines.append(f"*{entry.timestamp}*\n")
        lines.append(entry.response)
        lines.append("")
        if entry.consensus:
            c = entry.consensus
            lines.append("**Consensus:**")
            lines.append(f"- Score: {format_score(c.consensus_score)}/10")
            if c.agrees_with:
                lines.append(f"- Agrees with: {', '.join(c.agrees_with)}")
            if c.pending_issues:
                lines.append(f"- Pending: {', '.join(c.pending_issues)}")
        lines.append("\n---\n")
    (Path(session_path) / "discussion.md").write_text(
        "\n".join(lines), encoding="utf-8"
    )


def write_decisions(session_path: str | Path, topic: str, decision: str,
                    rounds: list[RoundEntry]) -> None:
    """Write final decisions.md (reference session.ts:94-115)."""
    knights = list(dict.fromkeys(r.knight for r in rounds))
    # entries are per knight-turn; the header counts discussion rounds
    num_rounds = len({r.round for r in rounds})
    lines = [
        "# Decision\n",
        f"**Topic:** {topic}",
        f"**Knights:** {', '.join(knights)}",
        f"**Rounds:** {num_rounds}",
        f"**Date:** {datetime.now(timezone.utc).strftime('%Y-%m-%d')}",
        "",
        "---\n",
        decision,
        "",
    ]
    (Path(session_path) / "decisions.md").write_text(
        "\n".join(lines), encoding="utf-8"
    )


def update_status(session_path: str | Path, **updates: Any) -> None:
    """Read-merge-write status.json (reference session.ts:120-149).

    Keyword names match SessionStatus fields; updated_at always refreshed.
    """
    session_path = Path(session_path)
    status_path = session_path / "status.json"
    if status_path.exists():
        try:
            current = json.loads(status_path.read_text(encoding="utf-8"))
        except (json.JSONDecodeError, OSError):
            current = {}
    else:
        current = {
            "phase": "discussing",
            "current_knight": None,
            "round": 0,
            "consensus_reached": False,
            "started_at": now_iso(),
        }
    current.update({k: v for k, v in updates.items() if v is not ...})
    current["updated_at"] = now_iso()
    atomic_write_text(status_path, json.dumps(current, indent=2))


def read_status(session_path: str | Path) -> Optional[SessionStatus]:
    status_path = Path(session_path) / "status.json"
    if not status_path.exists():
        return None
    try:
        return SessionStatus.from_dict(
            json.loads(status_path.read_text(encoding="utf-8")))
    except (json.JSONDecodeError, OSError):
        return None


@dataclass
class SessionInfo:
    name: str
    path: str
    status: Optional[SessionStatus]
    topic: Optional[str]


_TOPIC_RE = re.compile(r"^# Topic\s*\n\n(.+)", re.MULTILINE)


def list_sessions(project_root: str | Path) -> list[SessionInfo]:
    """All sessions newest-first via name sort (reference session.ts:176-204)."""
    sessions_dir = Path(project_root) / SESSIONS_SUBDIR
    if not sessions_dir.exists():
        return []
    sessions: list[SessionInfo] = []
    for entry in sessions_dir.iterdir():
        if not entry.is_dir():
            continue
        topic: Optional[str] = None
        topic_path = entry / "topic.md"
        if topic_path.exists():
            raw = topic_path.read_text(encoding="utf-8")
            m = _TOPIC_RE.search(raw)
            topic = (m.group(1).strip() if m else raw.strip()) or None
        sessions.append(SessionInfo(
            name=entry.name, path=str(entry),
            status=read_status(entry), topic=topic,
        ))
    sessions.sort(key=lambda s: s.name, reverse=True)
    return sessions


def find_latest_session(project_root: str | Path) -> Optional[SessionInfo]:
    sessions = list_sessions(project_root)
    return sessions[0] if sessions else None
