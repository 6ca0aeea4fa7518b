"""Hierarchical time budgets, hang detection, cooperative cancellation -
the parts of theroundtaible_tpu/engine/deadlines.py the serving path calls.

- Budget tree: one `Budget` node per rung (`discussion -> round -> turn ->
  prefill|decode -> dispatch`); a child's deadline is the MIN of its
  parent's, its own timeout and the rung's configured cap
  (`ROUNDTABLE_RUNG_BUDGETS="dispatch:120,prefill:300"` or
  `configure_rungs({...})`), and a `CancelToken` rides the tree. Engines
  check it between prefill chunks and decode segments.
- Watchdog: `watched_wait(fn, budget, rung)` runs a blocking device wait in
  a worker thread when armed (`arm_watchdog()`); a wait that outlives its
  budget raises `HangDetected` and the worker is abandoned. A late
  completion must not commit stale state: engines wrap their KV-state
  commit in `with commit_guard():`. Unarmed, both are a flag check.
- Drain gate: `check_admission()` refuses new turns while DRAINING.

Host-only: no torch import.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

ACTIVE = False     # watchdog armed
DRAINING = False   # drain in progress: refuse new admissions

RUNGS = ("discussion", "round", "turn", "prefill", "decode", "dispatch")

_INF = float("inf")

# Per-rung wall-clock caps in seconds (absent = no cap beyond the parent).
_rung_caps: dict[str, float] = {}


class BudgetExceeded(TimeoutError):
    """A rung's deadline passed (cooperative check, not a hang)."""

    def __init__(self, message: str, rung: str = ""):
        super().__init__(message)
        self.rung = rung


class Cancelled(RuntimeError):
    """The budget's CancelToken was cancelled (drain/abort)."""

    def __init__(self, message: str, reason: str = ""):
        super().__init__(message)
        self.reason = reason


class HangDetected(RuntimeError):
    """A blocking device wait exceeded its budget - the program is treated
    as wedged. The message carries the markers core/errors.classify_error
    maps to the `hang` kind."""

    def __init__(self, rung: str, waited_s: float):
        super().__init__(
            f"watchdog: device wait at rung '{rung}' still blocked after "
            f"{waited_s:.1f}s budget - program presumed wedged (hang)")
        self.rung = rung
        self.waited_s = waited_s


class StaleWait(RuntimeError):
    """Raised by commit_guard inside an ABANDONED watched wait: its late
    result must be discarded, not committed."""


class DrainingError(RuntimeError):
    """New turn refused because the engine is draining."""


class CancelToken:
    """Cooperative cancellation; cancelling a parent cancels every
    descendant token (never the reverse)."""

    __slots__ = ("_event", "reason", "_children", "_lock")

    def __init__(self):
        self._event = threading.Event()
        self.reason = ""
        self._children: list["CancelToken"] = []
        self._lock = threading.Lock()

    def child(self) -> "CancelToken":
        tok = CancelToken()
        with self._lock:
            self._children.append(tok)
            if self._event.is_set():
                tok.cancel(self.reason)
        return tok

    def cancel(self, reason: str = "") -> None:
        with self._lock:
            if self._event.is_set():
                return
            self.reason = reason
            self._event.set()
            children = list(self._children)
        for c in children:
            c.cancel(reason)

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def check(self) -> None:
        if self._event.is_set():
            raise Cancelled(
                f"cancelled{': ' + self.reason if self.reason else ''}",
                reason=self.reason)


class Budget:
    """One node of the time-budget tree. `deadline` is an absolute
    time.monotonic() value (inf = unbounded), always <= every
    ancestor's."""

    __slots__ = ("rung", "deadline", "parent", "token")

    def __init__(self, rung: str, deadline: float = _INF,
                 parent: Optional["Budget"] = None,
                 token: Optional[CancelToken] = None):
        self.rung = rung
        self.deadline = deadline
        self.parent = parent
        self.token = token or CancelToken()

    @classmethod
    def root(cls, timeout_s: Optional[float] = None,
             rung: str = "discussion",
             token: Optional[CancelToken] = None) -> "Budget":
        """A tree root: `timeout_s` None means unbounded (the rung cap,
        if configured, still applies); 0 is born expired."""
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else _INF)
        cap = _rung_caps.get(rung)
        if cap:
            deadline = min(deadline, time.monotonic() + cap)
        return cls(rung, deadline, token=token)

    def child(self, rung: str,
              timeout_s: Optional[float] = None) -> "Budget":
        """Sub-budget: deadline = min(parent, own timeout, rung cap), with
        a linked CancelToken."""
        deadline = self.deadline
        now = time.monotonic()
        if timeout_s is not None and timeout_s >= 0:
            deadline = min(deadline, now + timeout_s)
        cap = _rung_caps.get(rung)
        if cap:
            deadline = min(deadline, now + cap)
        return Budget(rung, deadline, parent=self, token=self.token.child())

    def remaining(self) -> float:
        return max(self.deadline - time.monotonic(), 0.0) \
            if self.deadline != _INF else _INF

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.deadline

    def check(self) -> None:
        """Cooperative cancellation + deadline check at a program
        boundary."""
        self.token.check()
        if time.monotonic() >= self.deadline:
            raise BudgetExceeded(
                f"{self.rung} budget exhausted (deadline passed)",
                rung=self.rung)


def rung_cap(rung: str) -> Optional[float]:
    return _rung_caps.get(rung)


def configure_rungs(caps: dict[str, float]) -> None:
    """Set per-rung wall-clock caps (seconds); None/0 removes a cap."""
    for rung, cap in caps.items():
        if rung not in RUNGS:
            raise ValueError(f"unknown rung {rung!r} "
                             f"(known: {', '.join(RUNGS)})")
        if cap:
            _rung_caps[rung] = float(cap)
        else:
            _rung_caps.pop(rung, None)


def _configure_from_env() -> None:
    """ROUNDTABLE_RUNG_BUDGETS="rung:seconds,..." parsed at import.
    Malformed entries warn and are skipped: the knob must never itself
    take serving down with an import-time crash."""
    raw = os.environ.get("ROUNDTABLE_RUNG_BUDGETS", "")
    for entry in filter(None, (p.strip() for p in raw.split(","))):
        try:
            rung, sec = entry.rsplit(":", 1)
            configure_rungs({rung.strip(): float(sec)})
        except ValueError as e:
            import warnings
            warnings.warn(
                f"ignoring malformed ROUNDTABLE_RUNG_BUDGETS entry "
                f"{entry!r}: {e}")


# --- watchdog ---

_local = threading.local()


class _WatchTicket:
    """State shared between a watched wait's caller and its worker; the
    lock orders the abandon decision against the worker's commit."""

    __slots__ = ("abandoned", "rung", "lock")

    def __init__(self, rung: str):
        self.abandoned = False
        self.rung = rung
        self.lock = threading.Lock()


def arm_watchdog() -> None:
    global ACTIVE
    ACTIVE = True


def disarm_watchdog() -> None:
    global ACTIVE
    ACTIVE = False


class _CommitGuard:
    """`with commit_guard(): <commit cache state>` - raises StaleWait in an
    abandoned watched wait; holds the ticket lock across the commit."""

    __slots__ = ("_ticket",)

    def __enter__(self):
        ticket = getattr(_local, "ticket", None) if ACTIVE else None
        self._ticket = ticket
        if ticket is not None:
            ticket.lock.acquire()
            if ticket.abandoned:
                ticket.lock.release()
                self._ticket = None
                raise StaleWait(
                    f"watched wait at rung '{ticket.rung}' was abandoned by "
                    "the watchdog - discarding its late result")
        return self

    def __exit__(self, *exc) -> bool:
        if self._ticket is not None:
            self._ticket.lock.release()
        return False


def commit_guard() -> _CommitGuard:
    return _CommitGuard()


def watched_wait(fn: Callable, budget: Optional[Budget],
                 rung: str = "dispatch"):
    """The deadline seam for blocking device waits: a direct call when
    unarmed or unbudgeted; armed, `fn` runs in a worker thread and the
    caller waits at most the budget's remaining time, then raises
    HangDetected and abandons the worker."""
    if not ACTIVE or budget is None:
        return fn()
    bound = budget.remaining()
    if bound == _INF:
        return fn()
    if bound <= 0:
        raise BudgetExceeded(
            f"{rung} wait admitted with no remaining budget", rung=rung)
    done = threading.Event()
    box: dict = {}
    ticket = _WatchTicket(rung)

    def work():
        _local.ticket = ticket
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised in caller
            box["error"] = e
        finally:
            done.set()

    threading.Thread(target=work, daemon=True,
                     name=f"watchdog-{rung}").start()
    if not done.wait(timeout=bound):
        with ticket.lock:
            ticket.abandoned = True
        raise HangDetected(rung, bound)
    if "error" in box:
        raise box["error"]
    return box["value"]


# --- drain gate ---


def begin_drain() -> None:
    global DRAINING
    DRAINING = True


def end_drain() -> None:
    global DRAINING
    DRAINING = False


def check_admission() -> None:
    """Raise DrainingError while draining."""
    if DRAINING:
        raise DrainingError("engine is draining: new turns are not admitted")


_configure_from_env()
