"""Telemetry, trimmed (counterpart of theroundtaible_tpu/utils/telemetry.py).

The names the orchestrator, the session metrics and the adapters call:
`ACTIVE`, `span`, `session_sink`, `current_context`, `attached`, `inc`,
`set_gauge`, `remove_gauge`, `observe`, `set_profiling` and `REGISTRY`. The span tracer, its JSONL
sinks and the flight recorder are not ported (ROADMAP item 7c), so
`ACTIVE` is always False: `span()` is the no-op singleton, `attached` a
no-op, `current_context()` None. What arms telemetry in the JAX package
(`arm()`, `ROUNDTABLE_TELEMETRY` in the environment) raises
NotImplementedError here, rather than recording nothing in silence.

The metrics registry stays on, as in the JAX package: counters, gauges
and histograms fire per event (a turn, a verify dispatch), never per
token.
"""

from __future__ import annotations

import bisect
import os
import threading
from typing import Any, Optional

from ..core.errors import ITEM_7C, not_ported

ACTIVE = False


def arm() -> None:
    raise not_ported("telemetry (span tracing and flight recorder)",
                     ITEM_7C)


def set_profiling(on: bool) -> None:
    """maybe_profile's seam. In the JAX package armed spans mirror into
    the device profile while it is on; with no span tracer (item 7c)
    there is nothing to mirror, so this does nothing."""


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

# Wall-clock-ish histogram buckets (seconds), the JAX package's.
HIST_BUCKETS = (0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0,
                60.0, 120.0, 300.0)


def _label_key(labels: dict[str, Any]) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Process-wide label-aware counters, gauges and histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, dict] = {}

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._gauges[key] = float(value)

    def remove_gauge(self, name: str, **labels) -> None:
        """Drop one labeled gauge series: a per-entity series whose entity
        retires (a row) must not stay behind for every entity ever
        served."""
        key = (name, _label_key(labels))
        with self._lock:
            self._gauges.pop(key, None)

    def observe(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = {
                    "buckets": [0] * (len(HIST_BUCKETS) + 1),
                    "count": 0, "sum": 0.0}
            h["buckets"][bisect.bisect_left(HIST_BUCKETS, value)] += 1
            h["count"] += 1
            h["sum"] += float(value)

    def prometheus_text(self) -> str:
        """Prometheus exposition-format snapshot."""
        def fmt(lkey, extra=()):
            pairs = list(lkey) + list(extra)
            if not pairs:
                return ""
            return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"

        lines: list[str] = []
        with self._lock:
            for (name, lkey), v in sorted(self._counters.items()):
                lines.append(f"{name}{fmt(lkey)} {v}")
            for (name, lkey), v in sorted(self._gauges.items()):
                lines.append(f"{name}{fmt(lkey)} {v}")
            for (name, lkey), h in sorted(self._hists.items()):
                cum = 0
                for bound, n in zip(HIST_BUCKETS + (float("inf"),),
                                    h["buckets"]):
                    cum += n
                    le = "+Inf" if bound == float("inf") else bound
                    lines.append(f"{name}_bucket"
                                 f"{fmt(lkey, [('le', le)])} {cum}")
                lines.append(f"{name}_count{fmt(lkey)} {h['count']}")
                lines.append(f"{name}_sum{fmt(lkey)} {h['sum']}")
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()


def inc(name: str, value: float = 1.0, **labels) -> None:
    REGISTRY.inc(name, value, **labels)


def set_gauge(name: str, value: float, **labels) -> None:
    REGISTRY.set_gauge(name, value, **labels)


def remove_gauge(name: str, **labels) -> None:
    REGISTRY.remove_gauge(name, **labels)


def observe(name: str, value: float, **labels) -> None:
    REGISTRY.observe(name, value, **labels)


# ---------------------------------------------------------------------------
# spans (disarmed: no-ops)
# ---------------------------------------------------------------------------


class _NullSpan:
    """The disarmed singleton: every operation a no-op."""

    __slots__ = ()
    rung = ""
    trace_id = span_id = parent_id = ""
    sink = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, key, value):
        pass

    def end(self, status=None):
        pass


_NULL_SPAN = _NullSpan()


def span(rung: str, sink=None, parent: Optional[dict] = None, **attrs):
    """The no-op span (telemetry is never armed in the port)."""
    return _NULL_SPAN


def session_sink(session_path):
    """The per-session JSONL span sink: only reached when ACTIVE."""
    raise not_ported("the span JSONL sink", ITEM_7C)


def current_context() -> Optional[dict]:
    return None


class attached:
    """No-op: there is no span context to hand across threads."""

    def __init__(self, ctx: Optional[dict]):
        self._ctx = ctx

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


if os.environ.get("ROUNDTABLE_TELEMETRY"):
    arm()
