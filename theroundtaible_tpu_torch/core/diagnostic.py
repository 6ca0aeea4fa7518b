"""Code-red diagnostic engine — doctor blocks, fuzzy keys, convergence.

The reference's diagnostic system (architecture-docs.md:154-167): each
doctor ends a turn with

    {"confidence_score": 8, "root_cause_key": "stale-auth-token",
     "evidence": [...], "rules_out": [...], "confirms": [...],
     "file_requests": [...], "next_test": "..."}

Convergence = 2+ doctors agree on the root_cause_key (exact or fuzzy) with
confidence >= 8 (architecture-docs.md:166). Pure logic, zero I/O — same
testability stance as the consensus engine.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Optional

from .consensus import extract_balanced_json, repair_json

CONVERGENCE_CONFIDENCE = 8
CONVERGENCE_DOCTORS = 2
MAX_FILE_REQUESTS = 4


@dataclass
class DiagnosticBlock:
    """One doctor's structured diagnosis."""

    doctor: str
    round: int
    confidence_score: float
    root_cause_key: str
    evidence: list[str] = field(default_factory=list)
    rules_out: list[str] = field(default_factory=list)
    confirms: list[str] = field(default_factory=list)
    file_requests: list[str] = field(default_factory=list)
    next_test: Optional[str] = None


def _as_str_list(raw: Any) -> list[str]:
    if not isinstance(raw, list):
        return []
    return [str(x).strip() for x in raw if str(x).strip()]


def _from_dict(d: dict[str, Any], doctor: str, round_num: int
               ) -> Optional[DiagnosticBlock]:
    if "confidence_score" not in d and "root_cause_key" not in d:
        return None
    try:
        confidence = float(d.get("confidence_score", 0))
    except (TypeError, ValueError):
        confidence = 0.0
    confidence = max(0.0, min(10.0, confidence))
    return DiagnosticBlock(
        doctor=doctor,
        round=round_num,
        confidence_score=confidence,
        root_cause_key=str(d.get("root_cause_key", "")).strip(),
        evidence=_as_str_list(d.get("evidence")),
        rules_out=_as_str_list(d.get("rules_out")),
        confirms=_as_str_list(d.get("confirms")),
        file_requests=_as_str_list(
            d.get("file_requests"))[:MAX_FILE_REQUESTS],
        next_test=(str(d["next_test"]).strip()
                   if d.get("next_test") else None),
    )


def parse_diagnostic_from_response(response: str, doctor: str,
                                   round_num: int
                                   ) -> Optional[DiagnosticBlock]:
    """Same repair ladder as the consensus parser: fenced ```json block
    first, then balanced-brace extraction, then repair_json retry."""
    fenced = re.findall(r"```(?:json)?\s*([\s\S]*?)```", response)
    candidates = [c for c in fenced if "confidence_score" in c
                  or "root_cause_key" in c]
    candidates += extract_balanced_json(response, "confidence_score")
    candidates += extract_balanced_json(response, "root_cause_key")
    for raw in candidates:
        for attempt in (raw, repair_json(raw)):
            try:
                d = json.loads(attempt)
            except (json.JSONDecodeError, ValueError):
                continue
            if isinstance(d, dict):
                block = _from_dict(d, doctor, round_num)
                if block is not None:
                    return block
    return None


# --- fuzzy key matching ---

_STOPWORDS = {"the", "a", "an", "in", "on", "of", "is", "not", "bug",
              "issue", "error", "problem"}


def _key_tokens(key: str) -> set[str]:
    tokens = re.split(r"[\s\-_/.:]+", key.lower())
    return {t for t in tokens if t and t not in _STOPWORDS}


def keys_match(a: str, b: str) -> bool:
    """Exact or fuzzy equality of root-cause keys. Fuzzy = token-set
    Jaccard >= 0.5 or one side's tokens contained in the other (doctors
    phrase the same cause at different verbosity)."""
    if not a or not b:
        return False
    if a.strip().lower() == b.strip().lower():
        return True
    ta, tb = _key_tokens(a), _key_tokens(b)
    if not ta or not tb:
        return False
    if ta <= tb or tb <= ta:
        return True
    overlap = len(ta & tb)
    return overlap / len(ta | tb) >= 0.5


def check_convergence(blocks: list[DiagnosticBlock]
                      ) -> Optional[tuple[str, list[DiagnosticBlock]]]:
    """Largest fuzzy-matching group with >= CONVERGENCE_DOCTORS members,
    every member confident (>= CONVERGENCE_CONFIDENCE). Returns
    (representative_key, group) or None."""
    confident = [b for b in blocks
                 if b.confidence_score >= CONVERGENCE_CONFIDENCE
                 and b.root_cause_key]
    best: Optional[tuple[str, list[DiagnosticBlock]]] = None
    for anchor in confident:
        group = [b for b in confident
                 if keys_match(anchor.root_cause_key, b.root_cause_key)]
        # one block per doctor (latest wins)
        by_doctor: dict[str, DiagnosticBlock] = {}
        for b in group:
            by_doctor[b.doctor] = b
        group = list(by_doctor.values())
        if len(group) >= CONVERGENCE_DOCTORS and (
                best is None or len(group) > len(best[1])):
            best = (anchor.root_cause_key, group)
    return best


def summarize_diagnosis(key: str, group: list[DiagnosticBlock]) -> str:
    """Human-readable convergence report for decisions.md / error-log."""
    lines = [f"ROOT CAUSE: {key}", ""]
    for b in sorted(group, key=lambda x: -x.confidence_score):
        lines.append(f"- **{b.doctor}** (confidence "
                     f"{b.confidence_score:g}/10): {b.root_cause_key}")
        for e in b.evidence[:3]:
            lines.append(f"  - evidence: {e}")
        if b.next_test:
            lines.append(f"  - next test: {b.next_test}")
    return "\n".join(lines)


def strip_diagnostic_json(response: str) -> str:
    """Remove the trailing diagnostic JSON for display purposes."""
    out = re.sub(
        r"```(?:json)?\s*\{[\s\S]*?(?:confidence_score|root_cause_key)"
        r"[\s\S]*?\}\s*```", "", response)
    for raw in extract_balanced_json(out, "confidence_score"):
        out = out.replace(raw, "")
    for raw in extract_balanced_json(out, "root_cause_key"):
        out = out.replace(raw, "")
    return out.strip()
