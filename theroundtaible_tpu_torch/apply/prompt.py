"""Apply prompt builder — decision + source context + BLOCK_MAPs + rules.

Source-context injection per the reference's documented pipeline
(TODO.md:89-93,122): every in-scope file's content with a sha256 integrity
hash, a 500KB total limit with actionable error, 80KB per-file truncation,
and the "EDIT, DON'T REWRITE" mandatory editing rules.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from ..core.errors import FileWriteError
from .blocks import render_block_map, scan_blocks
from .validate import sha256_text

MAX_TOTAL_SOURCE = 500_000   # reference TODO.md:122 (150KB → 500KB)
MAX_PER_FILE = 80_000        # reference TODO.md:122 per-file truncation

EDITING_RULES = """MANDATORY EDITING RULES (violations are rejected by validation):
1. EDIT, DON'T REWRITE — change only the blocks the decision requires;
   never re-emit a whole file that already exists.
2. Address blocks ONLY by the ids in the BLOCK_MAP below. Never invent
   ids, never address line numbers.
3. Emit COMPLETE blocks — a BLOCK_REPLACE body replaces the entire block,
   so include every line the block should contain afterwards.
4. One op per block. Do not touch the same block twice.
5. Only files in the agreed scope. New files need the NEW: prefix and a
   FILE_CREATE op.
6. Match the file's existing style (indentation, quotes, naming).
7. Output ONLY the RTDIFF/1 document — no prose before the header, no
   commentary between ops.

OUTPUT FORMAT:
RTDIFF/1
FILE: path/to/existing.py
BLOCK_REPLACE B004
<<<
...new lines for the whole block...
>>>
BLOCK_INSERT_AFTER B007
<<<
...lines inserted after block B007...
>>>
BLOCK_DELETE B009
FILE: NEW:path/to/new_file.py
FILE_CREATE
<<<
...entire new file...
>>>

(BLOCK_INSERT_AFTER B000 inserts at the very top of a file.)"""


@dataclass
class ApplyContext:
    prompt: str
    source_hashes: dict[str, str] = field(default_factory=dict)
    truncated: list[str] = field(default_factory=list)


def build_apply_prompt(
    project_root: str | Path,
    topic: str,
    decision: str,
    allowed_files: list[str],
) -> ApplyContext:
    """Assemble the Lead Knight's apply prompt. Raises FileWriteError when
    the in-scope sources blow the 500KB limit (actionable: shrink scope)."""
    root = Path(project_root)
    hashes: dict[str, str] = {}
    truncated: list[str] = []
    sections: list[str] = []
    total = 0

    for raw in allowed_files:
        is_new = raw.upper().startswith("NEW:")
        rel = raw[4:].strip() if is_new else raw
        full = root / rel
        if is_new or not full.is_file():
            sections.append(f"FILE {raw} — does not exist yet "
                            "(create with FILE_CREATE)")
            continue
        text = full.read_text(encoding="utf-8", errors="replace")
        hashes[rel] = sha256_text(text)
        shown = text
        if len(shown) > MAX_PER_FILE:
            shown = shown[:MAX_PER_FILE]
            truncated.append(rel)
        total += len(shown)
        if total > MAX_TOTAL_SOURCE:
            raise FileWriteError(
                f"apply source context exceeds {MAX_TOTAL_SOURCE // 1000}KB "
                f"at {rel} — narrow files_to_modify or apply in stages",
                hint="re-run discuss with a smaller scope, or deprecate "
                     "files from the scope before applying")
        block_map = render_block_map(rel, scan_blocks(text))
        trunc_note = ("\n(TRUNCATED at 80KB — edit only blocks you can "
                      "see)" if rel in truncated else "")
        sections.append(
            f"FILE {rel} (sha256 {hashes[rel][:16]}…){trunc_note}\n"
            f"{block_map}\n"
            f"--- content ---\n{shown}\n--- end {rel} ---")

    prompt = "\n\n".join([
        "You are the Lead Knight of TheRoundtAIble. The council reached "
        "consensus; you now EXECUTE the decision by emitting RTDIFF/1 "
        "block edits.",
        f"TOPIC:\n{topic}",
        f"THE DECISION (from decisions.md):\n{decision}",
        f"AGREED SCOPE (the only files you may touch):\n"
        + "\n".join(f"- {f}" for f in allowed_files),
        EDITING_RULES,
        "SOURCE FILES:\n\n" + "\n\n".join(sections),
    ])
    return ApplyContext(prompt=prompt, source_hashes=hashes,
                        truncated=truncated)
