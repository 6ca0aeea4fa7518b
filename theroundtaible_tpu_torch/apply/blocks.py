"""Block scanner — split source files into stable, addressable blocks.

The RTDIFF/1 system (reference TODO.md:88,130-137: "block-scanner +
diff-parser + BLOCK_MAP prompt") exists because search-and-replace editing
was unreliable on large files (reference TODO.md:126-128). Instead, the
knight is shown a BLOCK_MAP — every block's id, line range, and signature —
and addresses edits to block ids, never to line numbers or search strings.

The scanner is language-agnostic: a new block starts at every non-indented,
non-blank line that follows a blank line or closes a previous top-level
unit. Decorators/attributes/comments directly above a block attach to it.
Oversized blocks are split so a single BLOCK_REPLACE never forces the
knight to re-emit hundreds of lines (the failure mode block editing fixes).
"""

from __future__ import annotations

from dataclasses import dataclass

MAX_BLOCK_LINES = 60

# Lines that glue themselves to the NEXT block (decorators, comments).
_ATTACH_PREFIXES = ("@", "#", "//", "/*", "*", "--")

# The virtual anchor for BLOCK_INSERT_AFTER at the very top of a file.
TOP_ANCHOR = "B000"


@dataclass(frozen=True)
class Block:
    """One addressable unit of a file. Lines are 1-based inclusive."""

    id: str
    start: int
    end: int
    text: str

    @property
    def signature(self) -> str:
        for line in self.text.splitlines():
            if line.strip():
                return line.strip()[:80]
        return "(blank)"


def _is_boundary(line: str, prev_blank: bool) -> bool:
    if not line.strip():
        return False
    if line[0] in (" ", "\t"):
        return False
    return prev_blank


def scan_blocks(text: str) -> list[Block]:
    """Scan file text into blocks covering every line exactly once."""
    lines = text.splitlines()
    if not lines:
        return []

    starts: list[int] = [0]
    prev_blank = False
    for i, line in enumerate(lines):
        if i > 0 and _is_boundary(line, prev_blank):
            # Walk back over attached decorator/comment lines so they move
            # with the block they annotate.
            start = i
            j = i - 1
            while j > starts[-1] and lines[j].strip() and \
                    lines[j].lstrip().startswith(_ATTACH_PREFIXES) and \
                    lines[j][0] not in (" ", "\t"):
                start = j
                j -= 1
            if start > starts[-1]:
                starts.append(start)
        prev_blank = not line.strip()

    # Split oversized blocks at blank lines (or hard-chop as last resort).
    bounded: list[int] = []
    for idx, start in enumerate(starts):
        end = starts[idx + 1] if idx + 1 < len(starts) else len(lines)
        bounded.append(start)
        cursor = start
        while end - cursor > MAX_BLOCK_LINES:
            window = lines[cursor + MAX_BLOCK_LINES // 2:
                           cursor + MAX_BLOCK_LINES]
            split = None
            for off, line in enumerate(window):
                if not line.strip():
                    split = cursor + MAX_BLOCK_LINES // 2 + off + 1
            if split is None or split <= cursor:
                split = cursor + MAX_BLOCK_LINES
            if split >= end:
                break
            bounded.append(split)
            cursor = split

    blocks = []
    for idx, start in enumerate(bounded):
        end = bounded[idx + 1] if idx + 1 < len(bounded) else len(lines)
        blocks.append(Block(
            id=f"B{idx + 1:03d}",
            start=start + 1,
            end=end,
            text="\n".join(lines[start:end]),
        ))
    return blocks


def render_block_map(path: str, blocks: list[Block]) -> str:
    """The BLOCK_MAP section injected into the apply prompt."""
    lines = [f"BLOCK_MAP {path} ({len(blocks)} blocks)"]
    lines.append(f"  {TOP_ANCHOR} [top-of-file anchor — "
                 "BLOCK_INSERT_AFTER B000 inserts at line 1]")
    for b in blocks:
        lines.append(f"  {b.id} [L{b.start}-{b.end}] {b.signature}")
    return "\n".join(lines)
