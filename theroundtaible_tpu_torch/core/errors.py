"""Error hierarchy, classification and exit codes (counterpart of
theroundtaible_tpu/core/errors.py).

Parity with reference src/utils/errors.ts:1-151: a typed error tree with exit
codes, message-sniffing classification into actionable kinds, and a single
formatting helper. ``process.exit`` discipline (only the CLI entry exits —
reference src/index.ts:29-46) is preserved: nothing in this module exits.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Optional


class ExitCode(IntEnum):
    """Reference src/utils/errors.ts:7-16."""

    OK = 0
    GENERAL = 1
    CONFIG = 2
    ADAPTER = 3
    SESSION = 4
    FILE_WRITE = 5
    CONSENSUS = 6
    UNEXPECTED = 99


class RoundtableError(Exception):
    """Base of the tree (reference src/utils/errors.ts:23-80)."""

    exit_code: ExitCode = ExitCode.GENERAL

    def __init__(self, message: str, hint: Optional[str] = None,
                 cause: Optional[BaseException] = None):
        super().__init__(message)
        self.message = message
        self.hint = hint
        self.cause = cause


class ConfigError(RoundtableError):
    exit_code = ExitCode.CONFIG


class AdapterError(RoundtableError):
    exit_code = ExitCode.ADAPTER

    def __init__(self, message: str, kind: str = "unknown",
                 hint: Optional[str] = None, cause: Optional[BaseException] = None):
        super().__init__(message, hint=hint, cause=cause)
        # not_installed | timeout | auth | api | oom | hang |
        # device_lost | unknown
        self.kind = kind


class SessionError(RoundtableError):
    exit_code = ExitCode.SESSION


class FileWriteError(RoundtableError):
    exit_code = ExitCode.FILE_WRITE


class ConsensusError(RoundtableError):
    exit_code = ExitCode.CONSENSUS


# --- classification (reference src/utils/errors.ts:86-126) ---

_KIND_HINTS = {
    "not_installed": "Is the tool installed and on PATH? Try running it by hand.",
    "timeout": "The knight ran out of time. Raise rules.timeout_per_turn_seconds "
               "or pick a faster model.",
    "auth": "Check your API key (env var or ~/.theroundtaible/keys.json).",
    "api": "The backend returned an error. Check its status page / server logs.",
    "oom": "The device ran out of memory. Use a smaller model, shorter context, "
           "or a larger mesh.",
    "hang": "A device wait exceeded its watchdog budget — the program is "
            "presumed wedged. Check device health, or raise the rung budget "
            "(ROUNDTABLE_RUNG_BUDGETS) if the wait was legitimate.",
    "device_lost": "The accelerator itself failed or disappeared — no "
                   "retry on this engine can succeed. The engine "
                   "supervisor rebuilds it (engine/supervisor.py); if "
                   "this persists past the restart budget, check "
                   "device health / the platform runtime.",
    "deadline_expired": "The request's SLO budget was already spent at "
                        "submission — it never ran. Raise the client "
                        "deadline, or shed load upstream so requests "
                        "arrive with budget to spare.",
    "unknown": None,
}

_NOT_INSTALLED_MARKERS = (
    "enoent", "not found", "command not found", "no such file",
    "is not recognized",
)
_TIMEOUT_MARKERS = ("timed out", "timeout", "etimedout", "abort", "deadline")
_AUTH_MARKERS = (
    "401", "403", "unauthorized", "forbidden", "invalid api key",
    "invalid x-api-key", "authentication", "permission denied",
)
_API_MARKERS = ("429", "500", "502", "503", "529", "overloaded",
                "rate limit", "econnrefused", "fetch failed", "bad gateway")
# TPU-engine-specific kinds (no reference counterpart; SURVEY.md §5.3 calls for
# HBM OOM classification mapped onto the taxonomy).
_OOM_MARKERS = ("resource_exhausted", "out of memory", "hbm", "oom",
                "allocation failure")
# Watchdog hang detection (engine/deadlines.py): a wait that exceeded
# its rung budget is a WEDGED program, not a polite timeout — it must
# classify ahead of the timeout markers so the ladder treats it like a
# crash (no blind retry, revive + re-seat). Markers are whole words the
# watchdog/fault messages carry ("hang" alone would match "change").
_HANG_MARKERS = ("watchdog", "wedged", "hang detected", "(hang)")
# Device loss: the accelerator itself died or vanished — the
# strongest failure kind, classified FIRST: neither a retry nor a
# revive on the same engine can succeed, only the supervisor's
# tear-down/rebuild (engine/supervisor.py) helps. Markers match the
# real runtime messages ("DATA_LOSS: ...", "device is lost", libtpu
# halt strings) and the deterministic fault injection.
_DEVICE_LOST_MARKERS = ("device lost", "device is lost", "data_loss",
                        "device halted", "chip reboot",
                        "(device_lost)")


# Declarative class -> kind classification for the IN-TREE exception
# classes the serving engine raises. Message sniffing stays
# the primary classifier — fault injection deliberately crafts messages
# that classify like their real counterparts ("hbm" -> oom), and that
# must keep winning — but a class whose message carries no marker used
# to fall through to "unknown" and take the wrong recovery ladder (the
# device_lost ordering bug class). This table is consulted LAST,
# by class name up the MRO, and is also the registration the static
# analyzer checks: `roundtable lint` (RT-ERROR-KIND) fails when engine
# code raises an in-tree class that neither descends from
# RoundtableError nor appears here. AdapterError subclasses (EngineDead)
# carry their kind directly and need no entry.
ERROR_KIND_TABLE: dict[str, str] = {
    # engine/deadlines.py — the time ladder
    "HangDetected": "hang",          # wedged program, not a polite timeout
    "StaleWait": "hang",             # watchdog-abandoned wait completed late
    "BudgetExceeded": "timeout",     # the rung's deadline authority fired
    "Cancelled": "timeout",          # cooperative cancel at a rung boundary
    "DrainingError": "draining",     # admission gate closed, not a failure
    # engine/faults.py — chaos injection (plain-message injections only;
    # kind-mimicking messages classify by their markers above)
    "FaultInjected": "fault_injected",
    # engine/scheduler.py — admission verdicts
    "SchedulerRefused": "refused",   # never-fits: actionable config change
    "SchedulerClosed": "closed",
    # SLO budget spent at submit — failed fast before any prefill
    # dispatch (gateway deadline propagation). Its own kind,
    # not "timeout": the request never ran, so the timeout ladder's
    # retry/raise-budget hints would mislead.
    "DeadlineExpired": "deadline_expired",
    # engine/compile_watch.py — the steady-state sentinel
    "RecompileInSteadyState": "recompile",
    # engine/spec_decode.py — benign capacity pressure, drafting skipped
    "DraftUnavailable": "draft_unavailable",
}


def classify_error(err: BaseException) -> str:
    """Map a raw exception onto an actionable kind: message sniffing
    first (fault injections mimic real kinds by message), then the
    declarative in-tree class table for marker-less classes."""
    if isinstance(err, AdapterError):
        return err.kind
    msg = str(err).lower()
    if any(m in msg for m in _DEVICE_LOST_MARKERS):
        return "device_lost"
    if any(m in msg for m in _NOT_INSTALLED_MARKERS):
        return "not_installed"
    if any(m in msg for m in _OOM_MARKERS):
        return "oom"
    if any(m in msg for m in _HANG_MARKERS):
        return "hang"
    if any(m in msg for m in _TIMEOUT_MARKERS):
        return "timeout"
    if any(m in msg for m in _AUTH_MARKERS):
        return "auth"
    if any(m in msg for m in _API_MARKERS):
        return "api"
    for cls in type(err).__mro__:
        kind = ERROR_KIND_TABLE.get(cls.__name__)
        if kind is not None:
            return kind
    return "unknown"


def hint_for_kind(kind: str) -> Optional[str]:
    return _KIND_HINTS.get(kind)


def format_error(err: BaseException) -> str:
    """Human-facing one/two-liner (reference src/utils/errors.ts:131-140)."""
    lines = [str(err)]
    hint = getattr(err, "hint", None) or hint_for_kind(classify_error(err))
    if hint:
        lines.append(f"  hint: {hint}")
    cause = getattr(err, "cause", None)
    if cause:
        lines.append(f"  cause: {cause}")
    return "\n".join(lines)


# --- the port's not-yet-ported seams ---

ITEM_7C = "item 7c: supervision and observability"
ITEM_7D = "item 7d: the serving tier"
ITEM_7E_II = "item 7e-ii: the rest of multi-device"


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a command, adapter or option of the JAX package that the
    port does not serve yet raises, naming the ROADMAP item that brings
    it."""
    return NotImplementedError(
        f"{what} is not ported to the PyTorch port yet (ROADMAP, {item})")
