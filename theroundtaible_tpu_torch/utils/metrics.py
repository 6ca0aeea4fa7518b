"""Per-session metrics + optional device profiling (counterpart of
theroundtaible_tpu/utils/metrics.py).

The reference has no metrics at all — console chalk output only
(SURVEY.md §5.1/§5.5: "no structured logs, no metrics files"). This module
adds the quantities BASELINE.md measures: per-round wall-clock, per-knight
turn latency, and the engine's token counts and prefill/decode throughput,
written crash-safe to `<session>/metrics.json` after every round.

Profiling: set ROUNDTABLE_PROFILE=1 (trace into `<session>/profile/`) or
ROUNDTABLE_PROFILE=/some/dir to capture a torch.profiler host+CUDA trace of
the whole discussion (`trace.json`, viewable in Perfetto or
chrome://tracing).
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Optional


@dataclass
class TurnMetric:
    knight: str
    round: int
    wall_s: float
    chars_in: int = 0
    chars_out: int = 0
    # engine-side numbers, present only for engine (torch-llm) turns
    engine: Optional[dict[str, Any]] = None
    # Scheduler numbers, present only for turns served through
    # the continuous-batching session scheduler: how long the round sat
    # in the admission queue, and the mean decode-batch row count while
    # this round's rows were live (occupancy > len(own rows) means the
    # engine genuinely co-served other sessions during this turn).
    queue_wait_s: Optional[float] = None
    batch_occupancy: Optional[float] = None


@dataclass
class RoundMetric:
    round: int
    wall_s: float = 0.0
    turns: list[TurnMetric] = field(default_factory=list)


class SessionMetrics:
    """Collects and persists metrics.json; every mutation rewrites the file
    (same crash-safety stance as status.json, reference session.ts:120-149).

    Concurrency: each discussion session owns its OWN
    SessionMetrics over its OWN session directory — there is no shared
    mutable state between concurrent sessions — and WITHIN a session the
    orchestrator's batch-group thread pool records turns concurrently,
    so every mutation and the rewrite serialize on an instance lock.
    """

    def __init__(self, session_path: str | Path):
        self.path = Path(session_path) / "metrics.json"
        self.rounds: list[RoundMetric] = []
        self.outcome: Optional[str] = None
        self._started = time.monotonic()
        self._round_started = self._started
        self._prior_wall = 0.0
        import threading
        self._mu = threading.RLock()
        self._load_existing()

    def _load_existing(self) -> None:
        """A resumed session ("King sends back", ContinueOptions) reuses the
        session dir — earlier rounds' metrics must survive the rewrite."""
        try:
            data = json.loads(self.path.read_text(encoding="utf-8"))
            for r in data.get("rounds", []):
                self.rounds.append(RoundMetric(
                    round=r["round"], wall_s=r.get("wall_s", 0.0),
                    turns=[TurnMetric(**t) for t in r.get("turns", [])]))
            self._prior_wall = data.get("totals", {}).get("wall_s", 0.0)
        except (OSError, ValueError, KeyError, TypeError):
            pass

    # --- recording ---

    def start_round(self, round_num: int) -> None:
        with self._mu:
            self.rounds.append(RoundMetric(round=round_num))
            self._round_started = time.monotonic()

    def record_turn(self, knight: str, round_num: int, wall_s: float,
                    chars_in: int = 0, chars_out: int = 0,
                    engine: Optional[dict[str, Any]] = None,
                    queue_wait_s: Optional[float] = None,
                    batch_occupancy: Optional[float] = None) -> None:
        # Scheduler provenance defaults from the engine stats dict when
        # the caller doesn't pass it explicitly — every surface that
        # already forwards adapter last_stats() gets the fields free.
        sched = (engine or {}).get("sched") or {}
        if queue_wait_s is None:
            queue_wait_s = sched.get("queue_wait_s")
        if batch_occupancy is None:
            batch_occupancy = sched.get("occupancy_mean")
        with self._mu:
            if not self.rounds or self.rounds[-1].round != round_num:
                self.start_round(round_num)
            self.rounds[-1].turns.append(TurnMetric(
                knight=knight, round=round_num, wall_s=round(wall_s, 3),
                chars_in=chars_in, chars_out=chars_out, engine=engine,
                queue_wait_s=queue_wait_s,
                batch_occupancy=batch_occupancy))
        # Unified-registry publish: turn counts and latency
        # distributions land in the same store the engine/scheduler
        # series live in, so metrics.json is a per-session VIEW of it
        # rather than a fourth parallel truth. Token counters are NOT
        # re-published here — the engines already count them.
        from . import telemetry
        telemetry.inc("roundtable_turns_total", knight=knight)
        telemetry.observe("roundtable_turn_wall_seconds", wall_s)

    def end_round(self) -> None:
        with self._mu:
            if self.rounds:
                self.rounds[-1].wall_s = round(
                    time.monotonic() - self._round_started, 3)
        self.write()

    def finish(self, outcome: str) -> None:
        self.outcome = outcome
        self.write()

    # --- aggregation ---

    def totals(self) -> dict[str, Any]:
        agg = aggregate_engine_stats(
            t for r in self.rounds for t in r.turns)
        chars_in = sum(t.chars_in for r in self.rounds for t in r.turns)
        chars_out = sum(t.chars_out for r in self.rounds for t in r.turns)
        return {
            "wall_s": round(
                self._prior_wall + time.monotonic() - self._started, 3),
            "rounds": len(self.rounds),
            "turns": sum(len(r.turns) for r in self.rounds),
            "chars_in": chars_in,
            "chars_out": chars_out,
            "engine_prefill_tokens": agg["prefill_tokens"],
            "engine_reused_tokens": agg["reused_tokens"],
            "engine_decode_tokens": agg["decode_tokens"],
            "engine_decode_tps": agg["decode_tps"],
        }

    def write(self) -> None:
        with self._mu:
            payload = {
                "outcome": self.outcome,
                "totals": self.totals(),
                "rounds": [asdict(r) for r in self.rounds],
            }
        try:
            from .session import atomic_write_text
            atomic_write_text(self.path,
                              json.dumps(payload, indent=2, default=str))
        except (OSError, TypeError, ValueError):
            pass  # metrics must never kill a discussion
        # With telemetry armed, every metrics.json rewrite also drops a
        # Prometheus-text registry snapshot next to the spans file —
        # the store `roundtable status --telemetry` renders (a separate
        # process can't read this process's registry live; the per-round
        # rewrite cadence is the freshness contract).
        from . import telemetry
        if telemetry.ACTIVE:
            try:
                from .session import atomic_write_text
                tdir = self.path.parent / "telemetry"
                tdir.mkdir(parents=True, exist_ok=True)
                atomic_write_text(tdir / "metrics.prom",
                                  telemetry.REGISTRY.prometheus_text())
            except (OSError, TypeError, ValueError):
                pass


def aggregate_engine_stats(turns) -> dict[str, Any]:
    """Sum engine-side numbers over TurnMetrics (shared by totals() and the
    console round footer so the two can't drift)."""
    prefill = reused = decode = 0
    decode_time = 0.0
    for t in turns:
        if t.engine:
            prefill += t.engine.get("prefill_tokens", 0)
            reused += t.engine.get("reused_tokens", 0)
            decode += t.engine.get("decode_tokens", 0)
            decode_time += t.engine.get("decode_seconds", 0.0)
    return {
        "prefill_tokens": prefill,
        "reused_tokens": reused,
        "decode_tokens": decode,
        "decode_seconds": decode_time,
        "decode_tps": round(decode / decode_time, 2) if decode_time else 0.0,
    }


@contextmanager
def maybe_profile(session_path: str | Path):
    """torch.profiler trace of the block when ROUNDTABLE_PROFILE is set:
    host activity, and CUDA activity when a card is present, exported as
    a Chrome trace to `<trace dir>/trace.json` when the block ends.

    Profiling must never kill a discussion: a profiler that cannot start
    degrades to a styled ui.warn + no trace. While it runs, telemetry
    .set_profiling is told so and the block runs under a root "profile"
    span (both no-ops until span tracing is ported).
    """
    from . import telemetry
    target = os.environ.get("ROUNDTABLE_PROFILE")
    if not target:
        yield
        return
    trace_dir = (Path(session_path) / "profile" if target == "1"
                 else Path(target))
    profiler = None
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
    except Exception as e:  # noqa: BLE001 — opt-in feature, degrade loudly
        profiler = None
        from .ui import warn
        warn(f"  (ROUNDTABLE_PROFILE set but tracing unavailable: {e})")
    telemetry.set_profiling(profiler is not None)
    try:
        sink = (telemetry.session_sink(session_path)
                if telemetry.ACTIVE else None)
        with telemetry.span("profile", sink=sink,
                            trace_dir=str(trace_dir),
                            device_trace=profiler is not None):
            yield
    finally:
        telemetry.set_profiling(False)
        if profiler is not None:
            try:
                profiler.stop()
                trace_dir.mkdir(parents=True, exist_ok=True)
                profiler.export_chrome_trace(str(trace_dir / "trace.json"))
            except Exception as e:  # noqa: BLE001
                from .ui import warn
                warn(f"  (ROUNDTABLE_PROFILE trace could not be written: "
                     f"{e})")
