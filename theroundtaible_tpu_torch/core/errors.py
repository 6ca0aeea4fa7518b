"""Adapter errors and their classification into actionable kinds (the
parts of theroundtaible_tpu/core/errors.py the port raises and reads)."""

from __future__ import annotations

from typing import Optional


class RoundtableError(Exception):
    """Base of the error tree."""

    def __init__(self, message: str, hint: Optional[str] = None,
                 cause: Optional[BaseException] = None):
        super().__init__(message)
        self.message = message
        self.hint = hint
        self.cause = cause


class AdapterError(RoundtableError):
    def __init__(self, message: str, kind: str = "unknown",
                 hint: Optional[str] = None,
                 cause: Optional[BaseException] = None):
        super().__init__(message, hint=hint, cause=cause)
        # not_installed | timeout | auth | api | oom | hang |
        # device_lost | unknown
        self.kind = kind


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
# Device memory exhaustion ("CUDA out of memory" included).
_OOM_MARKERS = ("resource_exhausted", "out of memory", "hbm", "oom",
                "allocation failure")
_HANG_MARKERS = ("watchdog", "wedged", "hang detected", "(hang)")
_DEVICE_LOST_MARKERS = ("device lost", "device is lost", "data_loss",
                        "device halted", "chip reboot", "(device_lost)")

# Marker-less in-tree classes the serving path raises, by class name.
ERROR_KIND_TABLE: dict[str, str] = {
    "HangDetected": "hang",
    "StaleWait": "hang",
    "BudgetExceeded": "timeout",
    "Cancelled": "timeout",
    "DrainingError": "draining",
}


def classify_error(err: BaseException) -> str:
    """Map a raw exception onto an actionable kind: message sniffing
    first, then the class table for marker-less classes."""
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
