"""Apply validation pipeline — blocks bad knight output before any write.

The reference's single most-tested subsystem ("157/157 — block-scanner 34,
diff-parser 66, validation 57", reference TODO.md:121; "bad output is
blocked by validation but nothing gets written", TODO.md:141-143).
Validation is all-or-nothing per apply run: a single hard issue anywhere
aborts the whole write set (single attempt, no retry loop — "hard fail >
infinite retry", reference TODO.md:144).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from .blocks import TOP_ANCHOR, scan_blocks
from .rtdiff import FileEdit, ParsedApply

MAX_CONTENT_BYTES = 200_000  # per-file new-content cap


@dataclass(frozen=True)
class ValidationIssue:
    path: str
    message: str
    fatal: bool = True


def sha256_text(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def _path_issues(path: str) -> Optional[str]:
    if not path or path.strip() != path:
        return "empty or whitespace-padded path"
    p = Path(path)
    if p.is_absolute():
        return "absolute paths are not allowed"
    if ".." in p.parts:
        return "path traversal ('..') is not allowed"
    if path.startswith("~"):
        return "home-relative paths are not allowed"
    return None


def validate_edits(
    parsed: ParsedApply,
    project_root: str | Path,
    allowed_files: Optional[list[str]],
    source_hashes: Optional[dict[str, str]] = None,
    override_scope: bool = False,
) -> list[ValidationIssue]:
    """Run every check; returns ALL issues (not just the first) so the
    King sees the complete damage report before deciding anything.

    - scope: every touched path must appear in allowed_files (NEW: entries
      match either form); skipped entirely when allowed_files is None
      (old sessions without scope data work normally, reference
      README.md:207) or override_scope is set
    - paths: relative, no traversal, inside the project
    - existence: block ops need an existing file; FILE_CREATE needs a
      NEW: path that does not exist yet
    - blocks: ids must exist in the CURRENT scan of the file; at most one
      op per block; deletes conflict with other ops on the same block
    - integrity: when the apply prompt embedded a sha256 per source file,
      the file on disk must still hash the same (someone edited it
      between context build and write)
    - size: new content capped at MAX_CONTENT_BYTES per file
    """
    root = Path(project_root).resolve()
    issues: list[ValidationIssue] = []

    allowed_lookup: Optional[set[str]] = None
    if allowed_files is not None and not override_scope:
        allowed_lookup = set()
        for f in allowed_files:
            clean = f[4:].strip() if f.upper().startswith("NEW:") else f
            allowed_lookup.add(clean)

    seen_paths: set[str] = set()
    for edit in parsed.edits:
        path = edit.clean_path
        perr = _path_issues(path)
        if perr:
            issues.append(ValidationIssue(edit.path, perr))
            continue
        full = (root / path).resolve()
        if root not in full.parents and full != root:
            issues.append(ValidationIssue(path, "escapes the project root"))
            continue
        if path in seen_paths:
            issues.append(ValidationIssue(
                path, "file appears in multiple FILE: sections"))
            continue
        seen_paths.add(path)

        if allowed_lookup is not None and path not in allowed_lookup:
            issues.append(ValidationIssue(
                path,
                "outside the agreed scope (files_to_modify) — "
                "use --override-scope to force", fatal=True))

        creates = [op for op in edit.ops if op.op == "FILE_CREATE"]
        block_ops = [op for op in edit.ops if op.op.startswith("BLOCK_")]
        legacy_ops = [op for op in edit.ops if op.op == "SEARCH_REPLACE"]

        if creates:
            if block_ops or legacy_ops or len(creates) > 1:
                issues.append(ValidationIssue(
                    path, "FILE_CREATE cannot be combined with other ops"))
            if not edit.is_new:
                issues.append(ValidationIssue(
                    path, "FILE_CREATE requires the NEW: path prefix"))
            if full.exists():
                issues.append(ValidationIssue(
                    path, "NEW: file already exists on disk"))
            content = creates[0].content or ""
            if not content.strip():
                issues.append(ValidationIssue(
                    path, "FILE_CREATE with empty content"))
            if len(content.encode("utf-8")) > MAX_CONTENT_BYTES:
                issues.append(ValidationIssue(
                    path, f"new file exceeds {MAX_CONTENT_BYTES} bytes"))
            continue

        if edit.is_new:
            issues.append(ValidationIssue(
                path, "NEW: path without a FILE_CREATE op"))
            continue
        if not full.is_file():
            issues.append(ValidationIssue(path, "file does not exist"))
            continue

        text = full.read_text(encoding="utf-8", errors="replace")
        if source_hashes and path in source_hashes:
            if sha256_text(text) != source_hashes[path]:
                issues.append(ValidationIssue(
                    path,
                    "file changed on disk since the apply context was "
                    "built (sha256 mismatch) — rerun apply"))

        if legacy_ops:
            for op in legacy_ops:
                if not (op.search or "").strip():
                    issues.append(ValidationIssue(
                        path, "EDIT: with empty SEARCH block"))
                elif text.count(op.search) == 0:
                    issues.append(ValidationIssue(
                        path, "EDIT: SEARCH text not found in file"))
                elif text.count(op.search) > 1:
                    issues.append(ValidationIssue(
                        path,
                        f"EDIT: SEARCH text matches "
                        f"{text.count(op.search)} times — ambiguous"))
            continue

        ids = {b.id for b in scan_blocks(text)}
        touched: set[str] = set()
        for op in block_ops:
            bid = op.block_id or ""
            if bid == TOP_ANCHOR:
                if op.op != "BLOCK_INSERT_AFTER":
                    issues.append(ValidationIssue(
                        path, f"{op.op} on the {TOP_ANCHOR} anchor "
                        "(only BLOCK_INSERT_AFTER is valid)"))
                    continue
            elif bid not in ids:
                issues.append(ValidationIssue(
                    path, f"{op.op} references unknown block {bid} "
                    "(ids come from the BLOCK_MAP of the current file)"))
                continue
            if bid in touched:
                issues.append(ValidationIssue(
                    path, f"multiple ops address block {bid}"))
                continue
            touched.add(bid)
            if op.op in ("BLOCK_REPLACE", "BLOCK_INSERT_AFTER"):
                if not (op.content or "").strip():
                    issues.append(ValidationIssue(
                        path, f"{op.op} {bid} with empty content"))
                elif len((op.content or "").encode("utf-8")) \
                        > MAX_CONTENT_BYTES:
                    issues.append(ValidationIssue(
                        path,
                        f"{op.op} {bid} exceeds {MAX_CONTENT_BYTES} bytes"))

    return issues
