"""Dispatch retry and circuit breaking - the parts of
theroundtaible_tpu/engine/faults.py the serving path calls. Fault
injection is not ported."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core.errors import classify_error

# Kinds where an immediate identical retry cannot succeed.
_NO_RETRY_KINDS = ("timeout", "oom", "auth", "not_installed", "hang",
                   "device_lost")


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff for device dispatches."""

    max_retries: int = 1
    backoff_s: float = 0.05
    backoff_mult: float = 2.0

    def backoff(self, attempt: int) -> float:
        """Sleep before retry `attempt` (0-based)."""
        return self.backoff_s * (self.backoff_mult ** attempt)

    def retryable(self, err: BaseException) -> bool:
        if isinstance(err, (KeyboardInterrupt, SystemExit, TimeoutError)):
            return False
        return classify_error(err) not in _NO_RETRY_KINDS

    def run(self, fn: Callable, deadline: float = float("inf")):
        """fn() with up to max_retries retries on retryable failures,
        never sleeping past `deadline`."""
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 - policy decides
                if (attempt >= self.max_retries or not self.retryable(e)
                        or time.monotonic() >= deadline):
                    raise
                pause = min(self.backoff(attempt),
                            max(deadline - time.monotonic(), 0.0))
                if pause > 0:
                    time.sleep(pause)


DEFAULT_RETRY = RetryPolicy()


@dataclass
class CircuitBreaker:
    """Consecutive-failure counter with a trip threshold. Open => the owner
    reports itself unavailable (with `reason`) until a success closes it;
    while open, every `threshold` fast-failed calls admit one half-open
    probe. Thread-safe: adapters sharing one engine share its breaker."""

    threshold: int = 3
    name: str = ""
    failures: int = 0
    total_failures: int = 0
    last_error: str = ""
    _probes: int = field(default=0, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def record_failure(self, err: Optional[BaseException] = None) -> None:
        with self._lock:
            self.failures += 1
            self.total_failures += 1
            if err is not None:
                self.last_error = str(err)

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            self._probes = 0

    def trip(self, err: Optional[BaseException] = None) -> None:
        """Force-open for failures known to be permanent (engine
        construction)."""
        with self._lock:
            self.failures = max(self.failures, self.threshold)
            self.total_failures += 1
            if err is not None:
                self.last_error = str(err)

    @property
    def is_open(self) -> bool:
        return self.failures >= self.threshold

    def should_attempt(self) -> bool:
        """False => fail fast; while open, one probe per `threshold`
        fast-failed calls is admitted."""
        with self._lock:
            if self.failures < self.threshold:
                return True
            self._probes += 1
            if self._probes > self.threshold:
                self._probes = 0
                return True
            return False

    @property
    def reason(self) -> Optional[str]:
        if not self.is_open:
            return None
        return (f"circuit open after {self.failures} consecutive "
                f"failure(s) (threshold {self.threshold})"
                + (f": {self.last_error}" if self.last_error else ""))
