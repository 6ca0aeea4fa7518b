"""`roundtable status` — show the latest session (counterpart of
theroundtaible_tpu/commands/status.py).

Parity with reference src/commands/status.ts:11-77. The JAX command's
observability views (`--telemetry`, `--perf`, `--kv`, `--health`,
`--gateway`, `--fleet`, `--capacity`, `--slo`) read telemetry, tracing,
the perf model, the fleet, the router, the gateway and the load generator,
none of which the port has yet: each flag raises NotImplementedError naming
its ROADMAP item, and prints no empty view.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from ..core.errors import ITEM_7C, ITEM_7D, not_ported
from ..utils.session import find_latest_session
from ..utils.ui import style

PHASE_DISPLAY = {
    "discussing": ("⚔️", "The knights are discussing", style.blue),
    "consensus_reached": ("✓", "Consensus reached", style.green),
    "escalated": ("!", "Escalated to the King", style.yellow),
    "applying": ("…", "The Lead Knight is applying the decision", style.cyan),
    "completed": ("✓", "Completed", style.green),
}

DECISIONS_PREVIEW_LINES = 10

# Each observability flag of the JAX command, with the ROADMAP item that
# brings what it reads.
VIEW_ITEMS = {
    "telemetry": ITEM_7C, "perf": ITEM_7C, "kv": ITEM_7C, "health": ITEM_7C,
    "gateway": ITEM_7D, "fleet": ITEM_7D, "capacity": ITEM_7D,
    "slo": ITEM_7D,
}


def phase_display(status) -> tuple[str, str, object]:
    """(icon, label, color) for a SessionStatus, rejection-aware.

    The reference writes phase "consensus_reached" for unanimous rejection
    too (orchestrator.ts:616) and can't distinguish them afterward; we
    persist `unanimous_rejection` in status.json so the session lists
    don't misreport a rejected idea as an agreed decision.
    """
    if status.phase == "consensus_reached" and status.unanimous_rejection:
        return ("✗", "Unanimously rejected", style.red)
    return PHASE_DISPLAY.get(status.phase, ("?", status.phase, style.white))


def status_command(project_root: Optional[str] = None,
                   telemetry_view: bool = False,
                   perf_view: bool = False,
                   kv_view: bool = False,
                   health_view: bool = False,
                   gateway_view: bool = False,
                   fleet_view: bool = False,
                   capacity_view: bool = False,
                   slo_view: bool = False) -> int:
    views = {"telemetry": telemetry_view, "perf": perf_view,
             "kv": kv_view, "health": health_view,
             "gateway": gateway_view, "fleet": fleet_view,
             "capacity": capacity_view, "slo": slo_view}
    for view, asked in views.items():
        if asked:
            raise not_ported(f"`roundtable status --{view}`",
                             VIEW_ITEMS[view])
    project_root = project_root or os.getcwd()
    session = find_latest_session(project_root)
    if session is None:
        print(style.dim("\n  No sessions yet. "
                        'Start one with "roundtable discuss".\n'))
        return 0

    print(style.bold(f"\n  Latest session: {session.name}"))
    if session.topic:
        print(f"  Topic: {session.topic}")
    if session.status:
        s = session.status
        icon, label, color = phase_display(s)
        print(f"  Phase: {color(f'{icon} {label}')}")
        print(f"  Round: {s.round}")
        # consensus_reached is True for unanimous rejection too (schema
        # parity with the reference) — the display must not contradict
        # the rejection phase line above it
        consensus = ("unanimous rejection" if s.unanimous_rejection
                     else "yes" if s.consensus_reached else "no")
        print(f"  Consensus: {consensus}")
        if s.current_knight:
            print(f"  Current knight: {s.current_knight}")
        if s.lead_knight:
            print(f"  Lead knight: {s.lead_knight}")
        print(style.dim(f"  Started: {s.started_at}"))
        print(style.dim(f"  Updated: {s.updated_at}"))

    decisions = Path(session.path) / "decisions.md"
    if decisions.exists():
        lines = decisions.read_text(encoding="utf-8").split("\n")
        print(style.bold("\n  Decision preview:"))
        for line in lines[:DECISIONS_PREVIEW_LINES]:
            print(style.dim(f"    {line}"))
        if len(lines) > DECISIONS_PREVIEW_LINES:
            print(style.dim("    ..."))
    print("")
    return 0
