"""`roundtable manifest list|add|deprecate|check`.

Parity with reference src/commands/manifest.ts:13-118.
"""

from __future__ import annotations

import os
from typing import Optional

from ..core.types import ManifestEntry
from ..utils.manifest import (
    add_manifest_entry,
    check_manifest,
    deprecate_feature,
    read_manifest,
)
from ..utils.session import find_latest_session, now_iso
from ..utils.ui import ask, style

STATUS_DISPLAY = {
    "implemented": ("✓", style.green),
    "partial": ("~", style.yellow),
    "deprecated": ("✗", style.dim),
}


def run(args) -> int:
    sub = getattr(args, "manifest_command", None) or "list"
    if sub == "list":
        return manifest_list_command()
    if sub == "add":
        return manifest_add_command(args.feature_id, args.files, args.status)
    if sub == "deprecate":
        return manifest_deprecate_command(args.feature_id, args.replaced_by)
    if sub == "check":
        return manifest_check_command()
    return manifest_list_command()


def manifest_list_command(project_root: Optional[str] = None) -> int:
    project_root = project_root or os.getcwd()
    manifest = read_manifest(project_root)
    if not manifest.features:
        print(style.dim("\n  The manifest is empty. Nothing has been built "
                        "(or recorded) yet.\n"))
        return 0
    print(style.bold(f"\n  Implementation manifest — "
                     f"{len(manifest.features)} feature(s)\n"))
    for f in manifest.features:
        icon, color = STATUS_DISPLAY.get(f.status, ("?", style.white))
        print(f"  {color(icon)} {style.bold(f.id)} — {f.summary}")
        files = ", ".join(f.files[:4])
        more = f" +{len(f.files) - 4} more" if len(f.files) > 4 else ""
        print(style.dim(f"    {files}{more}"))
        if f.replaced_by:
            print(style.dim(f"    replaced by: {f.replaced_by}"))
        print("")
    return 0


def manifest_add_command(feature_id: Optional[str], files_csv: str,
                         status: str,
                         project_root: Optional[str] = None) -> int:
    project_root = project_root or os.getcwd()
    if not feature_id:
        feature_id = ask("  Feature id (kebab-case): ")
        if not feature_id:
            print(style.yellow("  No id given — aborted."))
            return 1
    summary = ask("  One-line summary: ") or feature_id
    files = [f.strip() for f in files_csv.split(",") if f.strip()]
    latest = find_latest_session(project_root)
    entry = ManifestEntry(
        id=feature_id,
        session=latest.name if latest else "",
        status=status if status in STATUS_DISPLAY else "implemented",
        files=files,
        summary=summary,
        applied_at=now_iso(),
        lead_knight="King",
    )
    add_manifest_entry(project_root, entry)
    print(style.green(f"  Added {feature_id} to the manifest."))
    return 0


def manifest_deprecate_command(feature_id: str,
                               replaced_by: Optional[str],
                               project_root: Optional[str] = None) -> int:
    project_root = project_root or os.getcwd()
    if deprecate_feature(project_root, feature_id, replaced_by):
        print(style.green(f"  Deprecated {feature_id}."))
        return 0
    print(style.yellow(f"  No feature with id {feature_id}."))
    return 1


def manifest_check_command(project_root: Optional[str] = None) -> int:
    project_root = project_root or os.getcwd()
    warnings = check_manifest(project_root)
    if not warnings:
        print(style.green("\n  Manifest is clean — all files exist.\n"))
        return 0
    print(style.yellow(f"\n  {len(warnings)} stale manifest entr"
                       f"{'y' if len(warnings) == 1 else 'ies'}:\n"))
    for w in warnings:
        print(style.yellow(f"  ! {w}"))
    print("")
    return 0
