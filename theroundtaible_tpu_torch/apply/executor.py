"""Apply executor — materialize validated edits, with backups.

Backups before any write (reference TODO.md:137 "Backup system — creates
backups before any write"): every touched file's pre-image is copied to
`.roundtable/backups/<session>-<timestamp>/<relpath>` so a bad apply is a
`cp -r` away from undone.
"""

from __future__ import annotations

import shutil
from dataclasses import dataclass, field
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

from .blocks import TOP_ANCHOR, scan_blocks
from .rtdiff import FileEdit


@dataclass
class ApplyOutcome:
    written: list[str] = field(default_factory=list)
    skipped: list[str] = field(default_factory=list)   # parley rejections
    backup_dir: Optional[str] = None


def materialize_edit(edit: FileEdit, current_text: Optional[str]) -> str:
    """Produce the file's new full text from its validated ops."""
    creates = [op for op in edit.ops if op.op == "FILE_CREATE"]
    if creates:
        content = creates[0].content or ""
        return content if content.endswith("\n") else content + "\n"

    assert current_text is not None
    legacy = [op for op in edit.ops if op.op == "SEARCH_REPLACE"]
    if legacy:
        text = current_text
        for op in legacy:
            text = text.replace(op.search or "", op.content or "", 1)
        return text

    lines = current_text.splitlines()
    had_trailing_nl = current_text.endswith("\n")
    blocks = {b.id: b for b in scan_blocks(current_text)}

    # Apply bottom-up so earlier ops don't shift later line ranges.
    def sort_key(op):
        if op.block_id == TOP_ANCHOR:
            return 0
        return blocks[op.block_id].start

    for op in sorted(edit.ops, key=sort_key, reverse=True):
        if op.block_id == TOP_ANCHOR:
            lines[0:0] = (op.content or "").splitlines()
            continue
        b = blocks[op.block_id]
        if op.op == "BLOCK_REPLACE":
            lines[b.start - 1:b.end] = (op.content or "").splitlines()
        elif op.op == "BLOCK_DELETE":
            del lines[b.start - 1:b.end]
            # A block ends where the next begins; eat ONE leading blank
            # line left behind so deletes don't accumulate gaps.
            if b.start - 1 < len(lines) and not lines[b.start - 1].strip():
                del lines[b.start - 1]
        elif op.op == "BLOCK_INSERT_AFTER":
            # A blank separator keeps the inserted block from gluing onto
            # the previous one.
            lines[b.end:b.end] = [""] + (op.content or "").splitlines()
    out = "\n".join(lines)
    if had_trailing_nl and not out.endswith("\n"):
        out += "\n"
    return out


def apply_edits(
    edits: list[FileEdit],
    project_root: str | Path,
    session_name: str,
    approve=None,
    dry_run: bool = False,
) -> ApplyOutcome:
    """Write every edit (unless dry_run), backing up pre-images first.

    approve(path, new_text) -> bool is the parley hook; None approves all
    (--noparley). Skipped files land in outcome.skipped → manifest status
    "partial" (reference README.md:190-193).
    """
    root = Path(project_root)
    outcome = ApplyOutcome()
    stamp = datetime.now(timezone.utc).strftime("%Y%m%d-%H%M%S")
    backup_dir = root / ".roundtable" / "backups" / f"{session_name}-{stamp}"

    plans: list[tuple[FileEdit, str]] = []
    for edit in edits:
        path = root / edit.clean_path
        current = (path.read_text(encoding="utf-8", errors="replace")
                   if path.is_file() else None)
        plans.append((edit, materialize_edit(edit, current)))

    for edit, new_text in plans:
        rel = edit.clean_path
        if approve is not None and not approve(rel, new_text):
            outcome.skipped.append(rel)
            continue
        if dry_run:
            outcome.written.append(rel)
            continue
        target = root / rel
        if target.is_file():
            backup_target = backup_dir / rel
            backup_target.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(target, backup_target)
            outcome.backup_dir = str(backup_dir)
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(new_text, encoding="utf-8")
        outcome.written.append(rel)
    return outcome
