"""Implementation manifest — what has actually been built.

Parity with reference src/utils/manifest.ts:1-183. The manifest summary is
injected into knight prompts ("don't re-propose what exists").
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Optional

from ..core.types import Manifest, ManifestEntry
from .session import now_iso

MANIFEST_RELPATH = Path(".roundtable") / "manifest.json"

_STATUS_ICONS = {"implemented": "+", "partial": "~", "deprecated": "x"}


def read_manifest(project_root: str | Path) -> Manifest:
    full_path = Path(project_root) / MANIFEST_RELPATH
    if not full_path.exists():
        return Manifest(last_updated=now_iso())
    try:
        return Manifest.from_dict(json.loads(full_path.read_text(encoding="utf-8")))
    except (json.JSONDecodeError, OSError):
        return Manifest(last_updated=now_iso())


def write_manifest(project_root: str | Path, manifest: Manifest) -> None:
    full_path = Path(project_root) / MANIFEST_RELPATH
    full_path.parent.mkdir(parents=True, exist_ok=True)
    manifest.last_updated = now_iso()
    full_path.write_text(json.dumps(manifest.to_dict(), indent=2),
                         encoding="utf-8")


def add_manifest_entry(project_root: str | Path, entry: ManifestEntry) -> None:
    """Add, or update by id (reference manifest.ts:57-72)."""
    manifest = read_manifest(project_root)
    for i, f in enumerate(manifest.features):
        if f.id == entry.id:
            manifest.features[i] = entry
            break
    else:
        manifest.features.append(entry)
    write_manifest(project_root, manifest)


def deprecate_feature(project_root: str | Path, feature_id: str,
                      replaced_by: Optional[str] = None) -> bool:
    manifest = read_manifest(project_root)
    for f in manifest.features:
        if f.id == feature_id:
            f.status = "deprecated"
            if replaced_by:
                f.replaced_by = replaced_by
            write_manifest(project_root, manifest)
            return True
    return False


def check_manifest(project_root: str | Path) -> list[str]:
    """Stale-file warnings (reference manifest.ts:98-118)."""
    manifest = read_manifest(project_root)
    warnings: list[str] = []
    for feature in manifest.features:
        if feature.status == "deprecated":
            continue
        for file in feature.files:
            if not (Path(project_root) / file).exists():
                warnings.append(
                    f'{feature.id}: "{file}" no longer exists on disk '
                    f"(stale entry)")
    return warnings


def get_manifest_summary(manifest: Manifest, language: str = "en") -> str:
    """Compact prompt summary: last 15 features, newest first
    (reference manifest.ts:124-144). The empty-history fallback is
    localized with the prompt scaffolding (an nl session must not get
    an English IMPLEMENTATIESTATUS body)."""
    if not manifest.features:
        from ..core.prompt import scaffold_strings
        return scaffold_strings(language)["no_manifest"]
    recent = list(reversed(manifest.features[-15:]))
    lines = []
    for f in recent:
        icon = _STATUS_ICONS.get(f.status, "?")
        files_short = ", ".join(f.files[:3])
        more = f" +{len(f.files) - 3} more" if len(f.files) > 3 else ""
        lines.append(f"- [{icon}] {f.id} — {f.summary} ({files_short}{more})")
    return "\n".join(lines)


def topic_to_feature_id(topic: str) -> str:
    """Kebab-case feature id, max 40 chars (reference manifest.ts:150-158)."""
    s = re.sub(r"[^a-z0-9\s-]", "", topic.lower()).strip()
    s = re.sub(r"\s+", "-", s)[:40]
    return s.rstrip("-")


def get_feature_summary(session_path: str | Path, topic: str) -> str:
    """decisions.md first meaningful paragraph, else topic; 140-char cap
    (reference manifest.ts:164-183)."""
    decisions_path = Path(session_path) / "decisions.md"
    try:
        content = decisions_path.read_text(encoding="utf-8")
        lines = [l for l in content.split("\n")
                 if l.strip() and not l.startswith("#") and not l.startswith("---")]
        first = lines[0].strip() if lines else ""
        if len(first) > 10:
            return first[:137] + "..." if len(first) > 140 else first
    except OSError:
        pass
    return topic[:137] + "..." if len(topic) > 140 else topic
