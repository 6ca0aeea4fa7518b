"""Chronicle — the project's append-only decision log (markdown).

Parity with reference src/utils/chronicle.ts:1-54.
"""

from __future__ import annotations

from pathlib import Path

CHRONICLE_HEADER = (
    "# Chronicle - TheRoundtAIble\n\nBeslissingen log van dit project.\n\n---\n\n"
)


def read_chronicle(project_root: str | Path, chronicle_path: str) -> str:
    full_path = Path(project_root) / chronicle_path
    if not full_path.exists():
        return ""
    return full_path.read_text(encoding="utf-8")


def append_to_chronicle(project_root: str | Path, chronicle_path: str, *,
                        topic: str, outcome: str, knights: list[str],
                        date: str) -> None:
    """Append a `## <date> — <topic>` entry (reference chronicle.ts:21-54).

    The read-modify-write runs under a PID-stale-aware lock: the
    reference interleaves concurrent appends (its acknowledged race,
    SURVEY.md §5.2 / reference TODO.md:188)."""
    from .lock import FileLock

    full_path = Path(project_root) / chronicle_path
    full_path.parent.mkdir(parents=True, exist_ok=True)
    entry = "\n".join([
        f"## {date} — {topic}",
        "",
        f"**Knights:** {', '.join(knights)}",
        "",
        outcome,
        "",
        "---",
        "",
    ])
    from .session import atomic_write_text

    with FileLock(full_path):
        if full_path.exists():
            content = full_path.read_text(encoding="utf-8")
        else:
            content = CHRONICLE_HEADER
        # atomic replace: a crash mid-write must not truncate the history
        atomic_write_text(full_path, content + entry)
