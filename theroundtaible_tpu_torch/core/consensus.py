"""Consensus engine: parse, repair, validate and score knight responses.

Pure string→struct logic with zero I/O (unit-testable in isolation), with
behavioral parity to reference src/consensus.ts:1-292:

- fenced ```json block → plain fenced block → balanced-brace extraction
  (string-aware state machine, reference :71-112)
- JSON repair for LLM artifacts: // comments, trailing commas, single quotes
  (reference :287-292) — our repair pass is string-aware so it never corrupts
  apostrophes inside values (a strict superset of inputs parsed)
- "none"-style pending_issues sanitization incl. Dutch variants (reference
  :154-169)
- files_to_modify path validation with NEW: prefix (reference :10-49)
- positive check: ALL scores >= threshold; pending_issues are deliberately
  NON-blocking (reference :211-223 — docs claim otherwise, code wins)
- negative check: >= 2 knights, all scores <= 3 (reference :230-239)
"""

from __future__ import annotations

import json
import re
from typing import Any, Optional

from .types import (
    ConsensusBlock,
    format_score,
    MAX_FILE_REQUESTS_PER_ROUND,
    MAX_VERIFY_COMMANDS_PER_ROUND,
)

# LLMs write ["none"], ["n/a"], ["geen"] instead of [] (reference :154-169).
_MEANINGLESS_ISSUES = {
    "", "none", "no", "n/a", "na", "nil", "null", "-",
    "no issues", "no open issues", "no pending issues",
    "geen", "geen issues", "geen open issues",
    "all resolved", "all issues resolved", "resolved",
    "nothing", "no concerns", "no remaining issues",
}

_FENCED_JSON_RE = re.compile(r"```json\s*\n?(.*?)\n?\s*```", re.DOTALL)
_FENCED_ANY_RE = re.compile(r"```\s*\n?(.*?)\n?\s*```", re.DOTALL)


def validate_files_to_modify(raw: Any) -> list[str]:
    """Normalize a files_to_modify list (reference src/consensus.ts:10-49).

    Relative forward-slash paths only, no traversal, NEW: prefix normalized,
    deduped; invalid entries silently dropped.
    """
    if not isinstance(raw, list):
        return []
    seen: set[str] = set()
    result: list[str] = []
    for item in raw:
        if not isinstance(item, str):
            continue
        path = item.strip()
        if not path:
            continue
        is_new = path.upper().startswith("NEW:")
        if is_new:
            path = path[4:].strip()
        path = path.replace("\\", "/")
        if path.startswith("./"):
            path = path[2:]
        if not path or path.startswith("/") or ".." in path:
            continue
        normalized = f"NEW:{path}" if is_new else path
        if normalized in seen:
            continue
        seen.add(normalized)
        result.append(normalized)
    return result


def sanitize_pending_issues(raw: Any) -> list[str]:
    if not isinstance(raw, list):
        return []
    out = []
    for item in raw:
        if not isinstance(item, str):
            continue
        s = item.strip()
        if s.lower() in _MEANINGLESS_ISSUES:
            continue
        out.append(s)
    return out


def extract_balanced_json(text: str, key: str) -> list[str]:
    """Extract top-level balanced ``{...}`` candidates containing ``"key"``.

    String-aware brace matching (reference src/consensus.ts:71-112): braces
    inside JSON strings, including escaped quotes, do not affect depth.
    """
    key_token = f'"{key}"'
    candidates: list[str] = []
    depth = 0
    start = -1
    in_string = False
    escaped = False
    for i, ch in enumerate(text):
        if in_string:
            if escaped:
                escaped = False
            elif ch == "\\":
                escaped = True
            elif ch == '"':
                in_string = False
            continue
        if ch == '"':
            in_string = True
        elif ch == "{":
            if depth == 0:
                start = i
            depth += 1
        elif ch == "}":
            if depth == 0:
                continue
            depth -= 1
            if depth == 0 and start >= 0:
                candidate = text[start:i + 1]
                if key_token in candidate:
                    candidates.append(candidate)
                start = -1
    return candidates


def repair_json(raw: str) -> str:
    """Best-effort repair of LLM-broken JSON (reference src/consensus.ts:287-292).

    String-aware single pass: outside strings, strip ``// comments``, drop
    trailing commas before ``}``/``]``, and promote single-quoted strings to
    double-quoted (escaping embedded double quotes).
    """
    out: list[str] = []
    i = 0
    n = len(raw)
    in_dq = False  # inside a double-quoted string
    while i < n:
        ch = raw[i]
        if in_dq:
            out.append(ch)
            if ch == "\\" and i + 1 < n:
                out.append(raw[i + 1])
                i += 2
                continue
            if ch == '"':
                in_dq = False
            i += 1
            continue
        if ch == '"':
            in_dq = True
            out.append(ch)
            i += 1
            continue
        if ch == "'":
            # single-quoted string → double-quoted
            j = i + 1
            buf: list[str] = []
            while j < n and raw[j] != "'":
                if raw[j] == "\\" and j + 1 < n:
                    buf.append(raw[j:j + 2])
                    j += 2
                    continue
                buf.append(raw[j])
                j += 1
            inner = "".join(buf).replace('"', '\\"')
            out.append(f'"{inner}"')
            i = j + 1
            continue
        if ch == "/" and i + 1 < n and raw[i + 1] == "/":
            while i < n and raw[i] != "\n":
                i += 1
            continue
        if ch == ",":
            # trailing comma? peek past whitespace
            j = i + 1
            while j < n and raw[j] in " \t\r\n":
                j += 1
            if j < n and raw[j] in "}]":
                i += 1  # drop the comma
                continue
        out.append(ch)
        i += 1
    return "".join(out)


def _parse_consensus_json(text: str, knight_name: str, round_num: int
                          ) -> Optional[ConsensusBlock]:
    try:
        parsed = json.loads(text)
    except (json.JSONDecodeError, RecursionError):
        return None
    if not isinstance(parsed, dict):
        return None
    score = parsed.get("consensus_score")
    if not isinstance(score, (int, float)) or isinstance(score, bool):
        return None
    agrees = parsed.get("agrees_with")
    file_requests = parsed.get("file_requests")
    verify_commands = parsed.get("verify_commands")
    return ConsensusBlock(
        knight=parsed.get("knight") or knight_name,
        round=parsed.get("round") or round_num,
        consensus_score=score,
        agrees_with=[a for a in agrees if isinstance(a, str)]
        if isinstance(agrees, list) else [],
        pending_issues=sanitize_pending_issues(parsed.get("pending_issues")),
        proposal=parsed.get("proposal")
        if isinstance(parsed.get("proposal"), str) else None,
        files_to_modify=validate_files_to_modify(parsed.get("files_to_modify")),
        file_requests=[f for f in file_requests if isinstance(f, str)]
        [:MAX_FILE_REQUESTS_PER_ROUND]
        if isinstance(file_requests, list) else [],
        verify_commands=[c for c in verify_commands if isinstance(c, str)]
        [:MAX_VERIFY_COMMANDS_PER_ROUND]
        if isinstance(verify_commands, list) else [],
    )


def try_parse_consensus(text: str, knight_name: str, round_num: int
                        ) -> Optional[ConsensusBlock]:
    """Raw parse first, then repaired (reference src/consensus.ts:171-181)."""
    for attempt in (text, repair_json(text)):
        block = _parse_consensus_json(attempt, knight_name, round_num)
        if block is not None:
            return block
    return None


def parse_consensus_from_response(response: str, knight_name: str,
                                  round_num: int) -> Optional[ConsensusBlock]:
    """Find + parse the consensus block in a free-text LLM response.

    Fenced ```json → any fenced block → balanced-brace fallback (reference
    src/consensus.ts:118-145).
    """
    for pattern in (_FENCED_JSON_RE, _FENCED_ANY_RE):
        for m in pattern.finditer(response):
            if not m.group(1):
                continue
            block = try_parse_consensus(m.group(1).strip(), knight_name, round_num)
            if block is not None:
                return block
    for candidate in extract_balanced_json(response, "consensus_score"):
        block = try_parse_consensus(candidate, knight_name, round_num)
        if block is not None:
            return block
    return None


def strip_consensus_json(response: str) -> str:
    """Remove the consensus JSON from a response for display purposes
    (reference src/orchestrator.ts:79-109 behavior)."""
    text = response
    for pattern in (_FENCED_JSON_RE, _FENCED_ANY_RE):
        for m in pattern.finditer(text):
            if "consensus_score" in m.group(0):
                return (text[:m.start()] + text[m.end():]).strip()
    for candidate in extract_balanced_json(text, "consensus_score"):
        text = text.replace(candidate, "")
    return text.strip()


def check_consensus(blocks: list[ConsensusBlock], threshold: float) -> bool:
    """Positive consensus: every knight's score >= threshold.

    pending_issues are informational, NOT blocking — knights put notes there
    even at 10/10 (reference src/consensus.ts:211-223; the docs' claim that
    pending_issues must be empty is deliberately not implemented).
    """
    if not blocks:
        return False
    return all(b.consensus_score >= threshold for b in blocks)


def check_negative_consensus(blocks: list[ConsensusBlock],
                             rejection_threshold: float = 3) -> bool:
    """Unanimous rejection: >= 2 knights, all scores <= rejection_threshold
    (reference src/consensus.ts:230-239)."""
    if len(blocks) < 2:
        return False
    return all(b.consensus_score <= rejection_threshold for b in blocks)


def summarize_consensus(blocks: list[ConsensusBlock]) -> str:
    """Human-readable consensus state (reference src/consensus.ts:244-279)."""
    if not blocks:
        return "No consensus data yet."
    lines: list[str] = []
    for b in blocks:
        status = ("AGREES" if b.consensus_score >= 9
                  else "PARTIAL" if b.consensus_score >= 6
                  else "DISAGREES")
        lines.append(f"- **{b.knight}** (Round {b.round}): "
                     f"Score {format_score(b.consensus_score)}/10 [{status}]")
        if b.agrees_with:
            lines.append(f"  Agrees with: {', '.join(b.agrees_with)}")
        if b.pending_issues:
            lines.append(f"  Pending: {', '.join(b.pending_issues)}")
        if b.files_to_modify:
            lines.append(f"  Scope: {', '.join(b.files_to_modify)}")
    avg = sum(b.consensus_score for b in blocks) / len(blocks)
    lines.append(f"\nAverage score: {avg:.1f}/10")
    return "\n".join(lines)


def warn_missing_scope_at_consensus(block: ConsensusBlock) -> Optional[str]:
    """Return a warning string when a knight agreed without naming scope
    (reference src/consensus.ts:54-66). Caller decides how to display it."""
    if block.consensus_score >= 9 and not block.files_to_modify:
        return (f"Warning: {block.knight} agreed (score "
                f"{block.consensus_score}) but didn't specify files_to_modify. "
                f"Scope enforcement will be skipped for this knight.")
    return None
