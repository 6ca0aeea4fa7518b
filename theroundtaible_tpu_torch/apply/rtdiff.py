"""RTDIFF/1 parser — the block-level edit format knights emit at apply time.

Format (our concrete spec for the reference's documented-but-absent RTDIFF/1
block system, TODO.md:88,130-137):

    RTDIFF/1
    FILE: src/auth.py
    BLOCK_REPLACE B004
    <<<
    def login(user):
        ...
    >>>
    BLOCK_INSERT_AFTER B007
    <<<
    def logout(user):
        ...
    >>>
    BLOCK_DELETE B009
    FILE: NEW:src/session.py
    FILE_CREATE
    <<<
    ...entire file...
    >>>

Rules: one header line `RTDIFF/1`; `FILE:` opens a per-file section; ops
address block ids from the BLOCK_MAP the knight was shown; content sits
between `<<<` and `>>>` fence lines. `BLOCK_INSERT_AFTER B000` inserts at
the top of the file. New files use the `NEW:` scope prefix and FILE_CREATE.
The parser tolerates surrounding prose and markdown code fences — LLM
output is never clean (cf. the consensus parser's repair ladder,
reference src/consensus.ts:118-145).

The legacy `EDIT:` search/replace format (reference TODO.md:138) is parsed
too, with a deprecation warning attached to the result.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

OPS = ("BLOCK_REPLACE", "BLOCK_INSERT_AFTER", "BLOCK_DELETE", "FILE_CREATE")

_BLOCK_ID_RE = re.compile(r"^B\d{3,}$")
_OP_RE = re.compile(
    r"^(BLOCK_REPLACE|BLOCK_INSERT_AFTER|BLOCK_DELETE)\s+(\S+)\s*$")


class ParseError(Exception):
    """RTDIFF text was structurally unusable (nothing gets written)."""


@dataclass
class ApplyOp:
    op: str                       # one of OPS, or legacy SEARCH_REPLACE
    block_id: Optional[str] = None
    content: Optional[str] = None  # lines, no trailing newline
    search: Optional[str] = None   # legacy SEARCH_REPLACE only


@dataclass
class FileEdit:
    path: str                     # as emitted, may carry NEW: prefix
    ops: list[ApplyOp] = field(default_factory=list)

    @property
    def is_new(self) -> bool:
        return self.path.upper().startswith("NEW:")

    @property
    def clean_path(self) -> str:
        return self.path[4:].strip() if self.is_new else self.path


@dataclass
class ParsedApply:
    edits: list[FileEdit]
    legacy: bool = False          # parsed via deprecated EDIT: format
    warnings: list[str] = field(default_factory=list)


def _strip_md_fences(text: str) -> str:
    # Drop ``` fence lines wholesale; they never carry RTDIFF content.
    return "\n".join(l for l in text.splitlines()
                     if not l.strip().startswith("```"))


def _read_fenced(lines: list[str], i: int) -> tuple[str, int]:
    """Read a <<< ... >>> body starting at lines[i]. Returns (body, next)."""
    if i >= len(lines) or lines[i].strip() != "<<<":
        raise ParseError(f"expected '<<<' fence at line {i + 1}")
    body: list[str] = []
    i += 1
    while i < len(lines):
        if lines[i].strip() == ">>>":
            return "\n".join(body), i + 1
        body.append(lines[i])
        i += 1
    raise ParseError("unterminated '<<<' fence (no matching '>>>')")


def parse_rtdiff(text: str) -> ParsedApply:
    """Parse RTDIFF/1 output into FileEdits. Raises ParseError if the
    header is present but the structure is broken."""
    cleaned = _strip_md_fences(text)
    lines = cleaned.splitlines()
    try:
        start = next(i for i, l in enumerate(lines)
                     if l.strip() == "RTDIFF/1")
    except StopIteration:
        raise ParseError("no RTDIFF/1 header found")

    edits: list[FileEdit] = []
    warnings: list[str] = []
    current: Optional[FileEdit] = None
    i = start + 1
    while i < len(lines):
        line = lines[i].strip()
        if not line:
            i += 1
            continue
        if line.startswith("FILE:"):
            path = line[5:].strip()
            if not path:
                raise ParseError(f"empty FILE: path at line {i + 1}")
            current = FileEdit(path=path)
            edits.append(current)
            i += 1
            continue
        m = _OP_RE.match(line)
        if m:
            if current is None:
                raise ParseError(f"op before any FILE: at line {i + 1}")
            op, block_id = m.group(1), m.group(2)
            if not _BLOCK_ID_RE.match(block_id):
                raise ParseError(
                    f"bad block id {block_id!r} at line {i + 1}")
            if op == "BLOCK_DELETE":
                current.ops.append(ApplyOp(op=op, block_id=block_id))
                i += 1
            else:
                content, i = _read_fenced(lines, i + 1)
                current.ops.append(
                    ApplyOp(op=op, block_id=block_id, content=content))
            continue
        if line == "FILE_CREATE":
            if current is None:
                raise ParseError(f"FILE_CREATE before FILE: at line {i + 1}")
            content, i = _read_fenced(lines, i + 1)
            current.ops.append(ApplyOp(op="FILE_CREATE", content=content))
            continue
        # Prose around/inside the diff is tolerated but recorded, so
        # silently-dropped content is visible during parley.
        warnings.append(f"ignored non-RTDIFF line {i + 1}: {line[:60]}")
        i += 1

    edits = [e for e in edits if e.ops]
    if not edits:
        raise ParseError("RTDIFF/1 header present but no complete ops found")
    return ParsedApply(edits=edits, warnings=warnings)


# --- legacy EDIT: format (deprecated) ---

_EDIT_HEADER_RE = re.compile(r"^EDIT:\s*(\S+)\s*$")


def parse_legacy_edit(text: str) -> ParsedApply:
    """Parse the deprecated EDIT: search/replace format:

        EDIT: path/to/file.py
        SEARCH:
        <<<
        old lines
        >>>
        REPLACE:
        <<<
        new lines
        >>>
    """
    cleaned = _strip_md_fences(text)
    lines = cleaned.splitlines()
    edits: list[FileEdit] = []
    i = 0
    while i < len(lines):
        m = _EDIT_HEADER_RE.match(lines[i].strip())
        if not m:
            i += 1
            continue
        path = m.group(1)
        i += 1
        while i < len(lines) and not lines[i].strip():
            i += 1
        if i >= len(lines) or lines[i].strip() != "SEARCH:":
            raise ParseError(f"EDIT: {path} missing SEARCH: section")
        search, i = _read_fenced(lines, i + 1)
        while i < len(lines) and not lines[i].strip():
            i += 1
        if i >= len(lines) or lines[i].strip() != "REPLACE:":
            raise ParseError(f"EDIT: {path} missing REPLACE: section")
        replace, i = _read_fenced(lines, i + 1)
        edit = FileEdit(path=path)
        edit.ops.append(ApplyOp(op="SEARCH_REPLACE", content=replace,
                                search=search))
        edits.append(edit)
    if not edits:
        raise ParseError("no EDIT: sections found")
    return ParsedApply(
        edits=edits, legacy=True,
        warnings=["EDIT: format is deprecated — knights should emit "
                  "RTDIFF/1 block edits"])


def parse_knight_output(text: str) -> ParsedApply:
    """RTDIFF/1 first; fall back to legacy EDIT: with a deprecation
    warning (reference TODO.md:138)."""
    if "RTDIFF/1" in text:
        return parse_rtdiff(text)
    if re.search(r"^EDIT:\s*\S+", text, re.MULTILINE):
        return parse_legacy_edit(text)
    raise ParseError(
        "knight output contains neither RTDIFF/1 nor EDIT: sections")
