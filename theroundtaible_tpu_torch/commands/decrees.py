"""`roundtable decrees` — the King's Decree Log display.

Parity with reference src/commands/decrees.ts:8-43.
"""

from __future__ import annotations

import os
from typing import Optional

from ..utils.decree_log import read_decree_log
from ..utils.ui import style

TYPE_LABELS = {
    "rejected_no_apply": "REJECTED (not applied)",
    "deferred": "DEFERRED",
}


def decrees_command(project_root: Optional[str] = None) -> int:
    project_root = project_root or os.getcwd()
    log = read_decree_log(project_root)
    if not log.entries:
        print(style.dim("\n  No decrees yet. The King has been lenient.\n"))
        return 0

    active = [e for e in log.entries if not e.revoked]
    revoked = [e for e in log.entries if e.revoked]
    print(style.bold(f"\n  King's Decree Log — {len(active)} active, "
                     f"{len(revoked)} revoked\n"))
    for e in log.entries:
        marker = style.dim("✗ revoked") if e.revoked else style.green("● active")
        label = TYPE_LABELS.get(e.type, e.type)
        print(f"  {style.bold(e.id)} {marker} — {style.yellow(label)}")
        print(f"    Topic: {e.topic}")
        print(f"    Reason: {e.reason}")
        print(style.dim(f"    Session: {e.session} — {e.date[:10]}"))
        print("")
    return 0
