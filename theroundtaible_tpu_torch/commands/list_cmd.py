"""`roundtable list` — all sessions, newest first.

Parity with reference src/commands/list.ts:4-64.
"""

from __future__ import annotations

import os
from typing import Optional

from ..utils.session import list_sessions
from ..utils.ui import style
from .status import phase_display


def list_command(project_root: Optional[str] = None) -> int:
    project_root = project_root or os.getcwd()
    sessions = list_sessions(project_root)
    if not sessions:
        print(style.dim("\n  No sessions yet. "
                        'Start one with "roundtable discuss".\n'))
        return 0

    print(style.bold(f"\n  {len(sessions)} session(s):\n"))
    for s in sessions:
        if s.status:
            icon, label, color = phase_display(s.status)
        else:
            icon, label, color = "?", "?", style.white
        rounds = s.status.round if s.status else 0
        topic = s.topic or "(no topic)"
        if len(topic) > 60:
            topic = topic[:57] + "..."
        print(f"  {color(icon)} {style.bold(s.name)}")
        print(f"    {topic}")
        print(style.dim(f"    {label} — {rounds} round(s)"))
        print("")
    return 0
