"""Continuous-batching session scheduler - many discussions, one engine
(counterpart of theroundtaible_tpu/engine/scheduler.py, trimmed to one
engine on one device, contiguous or paged).

`generate_batch` owns the engine's serve lock end to end, so a second
session's round serializes behind the first. This module batches sessions
continuously instead:

- **Decode batch = the live row set, recomposed at segment boundaries.**
  One decode segment runs up to DECODE_SEGMENT single-token steps; between
  segments the host owns every row's (last, valid, done, budget) state, so
  rows retire and join there. The batch pads to a power-of-two bucket
  (capped at max_rows) with masked pad rows (done from step 0, zero budget,
  writing a throwaway slot or the paged scratch page), which keeps the set
  of decode shapes small for a later CUDA-graph capture.
- **Join = admission into freed capacity.** A queued round admits at a
  segment boundary through the engine's own _prepare_batch (reuse plan,
  intra-session prefix sharing, prefill), with every live row pinned
  against eviction. While rows are decoding and the engine's ragged path
  is on (the paged pool's default; the contiguous layout has none and
  admits through the blocking prologue), the join's prefill is deferred:
  its prompt tokens ride the live decode rows' ragged mixed dispatches
  (forward_ragged through K3) as chunks, so admission never stalls the
  batch. A deferred leader span is
  aliased into the round's laggards once the leader's chunks have written
  it.
- **Retire = drop out of the next segment.** A row at eos or out of budget
  stops being dispatched; its round completes when all its rows are done,
  committing each slot's tokens for next-round prefix reuse.
- **Admission queue with capacity-aware backpressure.** A round whose rows
  (or, on the paged pool, pages) cannot fit next to the pinned live rows
  stays queued; a round that could never fit is refused
  (SchedulerRefused). All knights of a round join together.
- **Sessions are isolation domains.** Slot names are session-scoped, and a
  failed dispatch is preempted into per-session dispatches: the sick
  session fails into its adapter's ladder while every other session's rows
  continue from their host-side state.
- **Multi-LoRA personas.** `adapters_per_turn` names each knight's
  persona on a LoRA engine: a request's adapters are acquired at admission
  and released at retirement or failure, a request naming more distinct
  personas than the store holds is refused, and one that cannot load now
  waits (backpressure). Rows of different personas share one decode
  segment (one adapter slot per row) and one ragged dispatch (one per
  token).

Not ported here (each parameter that asks for one raises, naming its
ROADMAP item): speculative decoding, host-RAM spill, the
session journal, the supervisor, streaming `on_commit`, replica labels,
and the telemetry registry series and spans. The engine's pools are
updated in place and never donated, so no dispatch failure takes the
whole pool down with it: the JAX scheduler's revive-and-fail-all rung has
nothing to do here.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from . import deadlines
from .kvcache import scoped_slot
from .paging import SCRATCH_PAGE
from .sampling import SamplingParams, sampling_arrays
from .serving_loop import (DECODE_SEGMENT, RAGGED_BLOCK_Q, RaggedSeq,
                           build_ragged_batch, clamp_max_new, eos_trim,
                           host_sync, pow2_bucket, prompt_budget,
                           ragged_pick_shape, run_dispatch)

# How many recent per-segment occupancy samples / decision events
# describe() keeps.
_OCCUPANCY_LOG_CAP = 256
_EVENT_LOG_CAP = 64

# Test-visibility counter: the maximum number of live rows any scheduler
# dispatched in one segment since the last reset (a test that sees < 2
# knows the scheduler degenerated to serial serving).
_test_max_rows = 0
_test_lock = threading.Lock()


def reset_test_counters() -> None:
    global _test_max_rows
    with _test_lock:
        _test_max_rows = 0


def max_rows_seen() -> int:
    return _test_max_rows


def _note_rows(n: int) -> None:
    global _test_max_rows
    with _test_lock:
        if n > _test_max_rows:
            _test_max_rows = n


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch scheduler yet (ROADMAP, "
        f"{item})")


class SchedulerRefused(RuntimeError):
    """The request can never fit this engine (more knights than rows, or
    more pages than the whole pool, or more distinct LoRA personas than the
    store holds): refused at submission, not queued to deadlock. `reason`
    is the machine-readable refusal tag ("rows_never_fit",
    "adapters_never_fit", "pages_never_fit")."""

    def __init__(self, message: str, reason: Optional[str] = None):
        super().__init__(message)
        self.reason = reason


class SchedulerClosed(RuntimeError):
    """submit() after close()."""


class DeadlineExpired(RuntimeError):
    """The request's budget was already spent at submission: it fails at
    the queue mouth, before any slot acquisition or prefill."""


@dataclass(eq=False)
class _Row:
    """One knight's decode row: host-side state between segments. Identity
    equality (eq=False): rows are tracked by membership in their request's
    list, and two rows can hold identical field values."""

    name: str                    # session-scoped slot name
    tokens: list[int]            # truncated prompt ids (committed base)
    sampling: SamplingParams
    max_new: int                 # per-row token cap (<= request cap)
    slot_id: int = -1            # contiguous layouts only (paged: -1)
    produced: list[int] = field(default_factory=list)  # [first, ...]
    last: int = 0
    valid: int = 0
    done: bool = False
    # Ragged chunk-interleaved admission: prompt tokens not yet prefilled,
    # fed as chunks of the live rows' ragged dispatches; `pos` is the next
    # write position. A row with pending tokens is FILLING, never
    # dispatched for decode; its first sampled token arrives with the
    # dispatch that consumes its last chunk. A `blocked` filling row is a
    # deferred-share laggard: its chunks wait until the round's leader has
    # written the common span (_apply_share_plans).
    pending: list[int] = field(default_factory=list)
    pos: int = 0
    blocked: bool = False
    # LoRA adapter slot of this row (0 = base): a value, so rows of
    # different personas share one segment.
    adapter_slot: int = 0


class _Request:
    """One session round: queued -> active -> done|failed."""

    __slots__ = ("session", "turns", "sampling_per_turn", "max_new",
                 "timeout_s", "budget", "event", "result", "error",
                 "enqueued", "admitted_at", "rows", "stats", "deadline",
                 "turn_budget", "dec_budget", "abandoned", "seg_count",
                 "occ_sum", "occ_max", "sess_max", "requeues",
                 "fits_below", "first_token_at", "share_plans",
                 "adapters", "adapters_held")

    def __init__(self, session, turns, sampling_per_turn, max_new,
                 timeout_s, budget, stats, adapters=None):
        self.session = session
        self.turns = turns
        self.sampling_per_turn = sampling_per_turn
        self.max_new = max_new
        self.timeout_s = timeout_s
        self.budget = budget
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.enqueued = time.monotonic()
        self.admitted_at: Optional[float] = None
        self.rows: list[_Row] = []
        self.stats = stats
        self.deadline = float("inf")
        self.turn_budget = None
        self.dec_budget = None
        self.abandoned = False
        self.seg_count = 0
        self.occ_sum = 0
        self.occ_max = 0
        self.sess_max = 0
        self.requeues = 0        # admissions undone on pool exhaustion
        self.fits_below = None   # re-admit only once active rows < this
        # TTFT: when the last of this request's rows got its first sampled
        # token; reported against `enqueued`.
        self.first_token_at: Optional[float] = None
        # Deferred leader-span share plans: [{"leader": _Row, "hi": int,
        # "followers": [(_Row, lo), ...]}].
        self.share_plans: list[dict] = []
        # Per-turn LoRA persona ids (None = base); adapters_held flips once
        # acquire() took the residency refs, so release runs exactly once.
        self.adapters = adapters
        self.adapters_held = False


class SessionScheduler:
    """Admits concurrent discussion sessions onto one InferenceEngine and
    continuously batches their decode segments.

    One scheduler per engine: `scheduler_for(engine)` returns the attached
    instance or builds one. Threads call `submit(session, turns, ...)`
    (TorchLlmAdapter routes through it when attached); a dedicated thread
    owns the engine's serve lock while any session is active, so direct
    generate_batch callers still serialize correctly against it."""

    def __init__(self, engine, *, admit_hold_s: float = 0.0,
                 max_rows: Optional[int] = None,
                 idle_spill_s: Optional[float] = None,
                 journal=None):
        # The loop recomposes rows at the decode-segment seam and admits
        # through the engine's own prefill/share seams; either decode seam
        # serves (paged pool or contiguous slots).
        for attr in ("_prefill", "_share_prefixes"):
            if not hasattr(engine, attr):
                raise TypeError(
                    "SessionScheduler requires the port's InferenceEngine "
                    f"(missing {attr!r})")
        if not (hasattr(engine, "_decode_dispatch_paged")
                or hasattr(engine, "_decode_dispatch_slots")):
            raise TypeError("SessionScheduler requires the port's "
                            "InferenceEngine (no decode seam)")
        if idle_spill_s is not None:
            raise _not_ported("idle_spill_s (host-RAM spill)",
                              "slice 7: prefix cache and host-RAM offload")
        if journal is not None:
            raise _not_ported("the session journal",
                              "slice 7: supervision")
        if getattr(engine, "mesh", None) is not None:
            # Admission decisions come from threads: the ranks of a mesh
            # would need rank 0's plan broadcast at every dispatch.
            raise _not_ported("the SessionScheduler on a mesh",
                              "slice 7: the scheduler on a mesh")
        self.engine = engine
        self.admit_hold_s = admit_hold_s
        self.max_rows = min(max_rows or engine.kv.num_slots,
                            engine.kv.num_slots)
        self._queue: deque[_Request] = deque()
        self._active: list[_Row] = []         # rows, admission order
        self._active_reqs: list[_Request] = []
        self._row_req: dict[int, _Request] = {}  # id(row) -> request
        # Condition() holds an RLock: _event may run under it already.
        self._cv = threading.Condition()
        self._stop = False
        self.closed = False
        self._lock_held = False
        # Decision provenance.
        self.admitted = 0
        self.refused = 0
        self.completed = 0
        self.failed = 0
        self.rejected_draining = 0
        self.rejected_other = 0       # close()/loop-error rejections
        self.deadline_expired = 0     # budget-spent submits failed fast
        self.preemptions = 0          # fault-isolation preempts
        self.segments = 0
        self.max_occupancy = 0
        self.queued_peak = 0
        # Ragged admission: mixed dispatches issued, joins that prefilled
        # through them, and the per-phase token split of every segment.
        self.ragged_segments = 0
        self.ragged_joins = 0
        self.segment_prefill_tokens = 0
        self.segment_decode_tokens = 0
        self._occupancy: deque[int] = deque(maxlen=_OCCUPANCY_LOG_CAP)
        self._events: deque[dict] = deque(maxlen=_EVENT_LOG_CAP)
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"session-scheduler-{getattr(engine.cfg, 'name', '?')}")
        engine._scheduler = self           # describe() provenance
        self._thread.start()

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def submit(self, session: str, turns: list[tuple[str, Any]], *,
               max_new_tokens: Optional[int] = None,
               timeout_s: float = 600.0,
               sampling_per_turn: Optional[list[SamplingParams]] = None,
               budget=None, adapters_per_turn=None):
        """Serve one session round through the shared batch. Blocks the
        calling (session) thread until the round completes; returns
        (responses, GenStats) - the generate_batch_with_stats contract, so
        the adapter ladder above is unchanged. `adapters_per_turn`:
        per-knight LoRA persona ids (None = base); rows of different
        personas share one decode segment."""
        req = self.submit_async(
            session, turns, max_new_tokens=max_new_tokens,
            timeout_s=timeout_s, sampling_per_turn=sampling_per_turn,
            budget=budget, adapters_per_turn=adapters_per_turn)
        return self.wait(req)

    def submit_async(self, session, turns, *, max_new_tokens=None,
                     timeout_s: float = 600.0, sampling_per_turn=None,
                     budget=None, adapters_per_turn=None,
                     on_commit=None) -> _Request:
        if on_commit is not None:
            raise _not_ported("on_commit (committed-token streaming)",
                              "slice 7: serving tier")
        if self.closed:
            raise SchedulerClosed("scheduler is closed")
        if not turns:
            raise ValueError("submit() needs at least one turn")
        # Drain gate at the queue mouth.
        deadlines.check_admission()
        if budget is not None and budget.expired:
            with self._cv:  # submitter threads race each other here
                self.deadline_expired += 1
            self._event("deadline_expired", session=session)
            raise DeadlineExpired(
                f"session {session!r} submitted with its budget already "
                "spent - refused before any prefill dispatch")
        engine = self.engine
        # Against max_rows, not num_slots: a request wider than the batch
        # would sit at the FIFO head forever and starve every later one.
        if len(turns) > self.max_rows:
            with self._cv:
                self.refused += 1
            self._event("refuse", session=session,
                        reason=f"{len(turns)} rows > max_rows "
                               f"{self.max_rows}")
            raise SchedulerRefused(
                f"session {session!r} needs {len(turns)} rows but this "
                f"scheduler batches at most {self.max_rows} (num_slots "
                f"{engine.kv.num_slots}) - raise num_slots / max_rows",
                reason="rows_never_fit")
        max_new = max_new_tokens or engine.sampling.max_new_tokens
        store = getattr(engine, "lora", None)
        if store is None:
            adapters_per_turn = None
        elif adapters_per_turn is not None:
            # Validated at the queue mouth: more distinct personas than the
            # store can ever hold would deadlock the FIFO head (a refusal,
            # counted); the rest is LoraStore.validate, shared with the
            # direct generate path.
            distinct = {a for a in adapters_per_turn if a is not None}
            if (len(adapters_per_turn) == len(turns)
                    and len(distinct) > store.max_adapters):
                with self._cv:
                    self.refused += 1
                self._event("refuse", session=session,
                            reason=f"{len(distinct)} adapters > store "
                                   f"{store.max_adapters}")
                raise SchedulerRefused(
                    f"session {session!r} names {len(distinct)} distinct "
                    f"lora adapters but the store holds at most "
                    f"{store.max_adapters} - raise lora.max_adapters",
                    reason="adapters_never_fit")
            store.validate(adapters_per_turn, len(turns))
        # Never-fits is a LOWER bound (1-token prompts): a request
        # generate_batch could serve is never refused here. Paged only:
        # contiguous slots hold any prompt within max_seq_len.
        need = (self._pages_needed(turns, max_new, minimal=True)
                if engine.kv_layout == "paged" else 0)
        if need and need > engine.kv.usable_pages():
            with self._cv:
                self.refused += 1
            self._event("refuse", session=session,
                        reason=f"{need} pages > pool "
                               f"{engine.kv.usable_pages()}")
            raise SchedulerRefused(
                f"session {session!r} needs at least {need} KV pages but "
                f"the pool holds {engine.kv.usable_pages()} - raise "
                "num_pages or lower max_new_tokens",
                reason="pages_never_fit")
        req = _Request(session, list(turns), sampling_per_turn, max_new,
                       timeout_s, budget, self._fresh_stats(),
                       adapters=adapters_per_turn)
        with self._cv:
            # Re-checked under the lock: close() flips `closed` and drains
            # the queue under it, so no request lands in a dead queue.
            if self.closed or self._stop:
                raise SchedulerClosed("scheduler is closed")
            self._queue.append(req)
            self.queued_peak = max(self.queued_peak, len(self._queue))
            self._cv.notify_all()
        return req

    def wait(self, req: _Request):
        """Block until `req` resolves; re-raise its failure. The outer
        bound (admitted_at + timeout_s + grace, re-read each slice) only
        catches a wedged scheduler: a healthy one resolves every budget
        and deadline failure itself."""
        grace = 60.0
        while not req.event.is_set():
            base = (req.admitted_at if req.admitted_at is not None
                    else req.enqueued)
            slice_s = base + req.timeout_s + grace - time.monotonic()
            if slice_s <= 0:
                req.abandoned = True
                with self._cv:
                    self._cv.notify_all()
                raise TimeoutError(
                    f"scheduler did not resolve session {req.session!r} "
                    f"within {req.timeout_s + grace:.0f}s of admission "
                    "(scheduler wedged?)")
            req.event.wait(timeout=min(slice_s, 5.0))
        if req.error is not None:
            raise req.error
        return req.result

    def _fresh_stats(self):
        from .engine import GenStats
        return GenStats()

    def _pages_needed(self, turns, max_new: int,
                      minimal: bool = False) -> int:
        """Page-demand estimate of a request, max_new clamped as the
        serving paths clamp it. `minimal=True` is the never-fits lower
        bound (1-token prompts); otherwise prompt lengths are estimated
        from the inputs (exact for token lists, chars/token for strings,
        capped at the prompt budget) for queue backpressure."""
        engine = self.engine
        kv = engine.kv
        max_new, max_new_padded = clamp_max_new(max_new,
                                                engine.max_seq_len)
        budget_tok = prompt_budget(engine.max_seq_len, max_new_padded)
        total = 0
        for _name, prompt in turns:
            if minimal:
                est = 1
            elif isinstance(prompt, list):
                est = min(len(prompt), budget_tok)
            else:
                cpt = max(engine.chars_per_token(), 0.25)
                est = min(int(len(prompt) / cpt * 1.25) + 1, budget_tok)
            total += -(-(est + max_new_padded) // kv.page_size)
        return total

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def _event(self, kind: str, **fields) -> None:
        e = {"event": kind, "at": round(time.monotonic(), 3)}
        e.update(fields)
        with self._cv:
            self._events.append(e)

    def describe(self) -> dict[str, Any]:
        """Scheduler provenance for engine.describe(): the JAX
        scheduler's keys. Keys of unported parts (spill, journal,
        speculation) read 0 or None."""
        with self._cv:
            occ = list(self._occupancy)
            events = list(self._events)
        return {
            "admitted": self.admitted,
            "refused": self.refused,
            "completed": self.completed,
            "failed": self.failed,
            "rejected_draining": self.rejected_draining,
            "rejected_other": self.rejected_other,
            "deadline_expired": self.deadline_expired,
            "preemptions": self.preemptions,
            "segments": self.segments,
            "ragged_segments": self.ragged_segments,
            "ragged_joins": self.ragged_joins,
            "spec_segments": 0,
            "segment_prefill_tokens": self.segment_prefill_tokens,
            "segment_decode_tokens": self.segment_decode_tokens,
            "queued": len(self._queue),
            "queued_peak": self.queued_peak,
            "active_rows": len(self._active),
            "max_occupancy": self.max_occupancy,
            "occupancy_mean": (round(sum(occ) / len(occ), 2)
                               if occ else 0.0),
            "occupancy_recent": occ[-32:],
            "spills": 0,
            "spilled_sessions": 0,
            "paused": None,
            "admission": {"paused": None, "open": not self.closed,
                          "queued": len(self._queue)},
            "journal_turns": 0,
            "journal_errors": 0,
            "events": events,
        }

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def reject_queued(self, error: Optional[BaseException] = None) -> int:
        """Fail every queued-but-unadmitted request now (a drain gives a
        clean DrainingError instead of a wait). Active requests finish
        their rounds. Returns the count."""
        error = error or deadlines.DrainingError(
            "engine is draining: queued session was never admitted")
        draining = isinstance(error, deadlines.DrainingError)
        rejected: list[_Request] = []
        with self._cv:
            while self._queue:
                rejected.append(self._queue.popleft())
        for req in rejected:
            req.error = error
            req.event.set()
            with self._cv:  # drain/close threads race the loop thread
                if draining:
                    self.rejected_draining += 1
                else:
                    self.rejected_other += 1
            self._event("reject_drain" if draining else "reject",
                        session=req.session, reason=type(error).__name__)
        return len(rejected)

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop the loop: queued requests are rejected, active requests
        get `timeout_s` to finish, then the thread exits."""
        self.closed = True
        self.reject_queued(SchedulerClosed(
            "scheduler closed before this session was admitted"))
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout_s)

    # ------------------------------------------------------------------
    # the scheduler loop
    # ------------------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._active and not self._stop \
                        and not self._queue:
                    self._cv.wait(timeout=0.25)
                if self._stop and not self._active and not self._queue:
                    break
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 - the loop must survive
                # A scheduler bug must not wedge every submitter: fail all
                # in-flight work with the error.
                self._event("loop_error", error=str(e))
                for req in list(self._active_reqs):
                    self._fail_request(req, e)
                self.reject_queued(e)
            if not self._active:
                self._release_engine()
        self._release_engine()

    def _tick(self) -> None:
        if deadlines.DRAINING:
            self.reject_queued()
        if self._stop:
            self.reject_queued(SchedulerClosed("scheduler closed"))
        self._check_request_health()
        self._sweep_queue()
        self._admit_queued()
        live = [r for r in self._active if not r.done and not r.pending]
        filling = [r for r in self._active if not r.done and r.pending]
        if filling:
            # While any row is still prefilling, segments are ragged mixed
            # dispatches: every live row decodes one token while the
            # filling rows' chunks ride the same dispatch.
            self._run_ragged_segment(live, filling)
        elif live:
            self._run_segment(live)
        self._retire_finished()
        self._check_request_health()

    def _acquire_engine(self) -> None:
        if not self._lock_held:
            self.engine._serve_lock.acquire()
            self._lock_held = True

    def _release_engine(self) -> None:
        if self._lock_held:
            self._lock_held = False
            self.engine._serve_lock.release()

    # --- admission ---

    def _sweep_queue(self) -> None:
        """Fail expired/abandoned requests anywhere in the queue, not only
        at its head: a request stuck behind a non-fitting head still dies
        at its own deadline."""
        now = time.monotonic()
        expired: list[_Request] = []
        with self._cv:
            keep: deque[_Request] = deque()
            for req in self._queue:
                if req.abandoned:
                    continue  # the waiter is gone: drop silently
                if ((req.budget is not None and req.budget.expired)
                        or now - req.enqueued > req.timeout_s):
                    expired.append(req)
                else:
                    keep.append(req)
            self._queue = keep
        for req in expired:
            self._fail_request(req, TimeoutError(
                f"session {req.session!r} timed out in the admission "
                "queue before any capacity freed"))

    def _admit_queued(self) -> None:
        while True:
            with self._cv:
                if not self._queue:
                    return
                req = self._queue[0]
                # Batch-formation hold: with an empty batch, wait up to
                # admit_hold_s since the head enqueued so co-arriving
                # sessions join the same first segment.
                if self.admit_hold_s and not self._active:
                    remaining = (req.enqueued + self.admit_hold_s
                                 - time.monotonic())
                    if remaining > 0:
                        self._cv.wait(timeout=remaining)
                        continue
                if not self._fits_now(req):
                    # Backpressure: keep it queued - retirement frees
                    # capacity (never-fits was refused at submit).
                    self._event("queue_wait", session=req.session,
                                queued=len(self._queue))
                    return
                self._queue.popleft()
            self._acquire_engine()
            try:
                self._start_request(req)
            except Exception as e:  # noqa: BLE001 - per-request contain
                if self._requeue_on_exhaustion(req, e):
                    return
                # _prepare_batch may have acquired slots/pages before
                # raising; req.rows is still empty, so undo explicitly.
                self._release_request_slots(req)
                self._fail_request(req, e)

    def _release_request_slots(self, req: _Request) -> None:
        """Undo a partial admission: release every slot this request's
        turns may have acquired (loop thread only)."""
        for name, _prompt in req.turns:
            self.engine.kv.release(scoped_slot(req.session, name))

    def _requeue_on_exhaustion(self, req: _Request,
                               err: BaseException) -> bool:
        """The page estimate under-counted and admission hit real pool
        exhaustion while other sessions hold pages: that is backpressure,
        not a failure. Undo the partial admission and requeue at the
        head, gated on the batch shrinking first."""
        if (not self._active or req.requeues >= 8
                or not isinstance(err, RuntimeError)
                or "pool exhausted" not in str(err).lower()):
            return False
        self._release_request_slots(req)
        self._release_adapters(req)
        req.requeues += 1
        req.fits_below = len(self._active)
        req.admitted_at = None
        with self._cv:
            self._queue.appendleft(req)
        self._event("requeue", session=req.session,
                    reason="page pool exhausted",
                    fits_below=req.fits_below)
        return True

    def _fits_now(self, req: _Request) -> bool:
        engine = self.engine
        if len(self._active) + len(req.turns) > self.max_rows:
            return False
        if (req.fits_below is not None
                and len(self._active) >= req.fits_below):
            # An earlier admission of this request hit real pool
            # exhaustion at this batch size: wait for retirement.
            return False
        store = getattr(engine, "lora", None)
        if (store is not None and req.adapters
                and not store.can_admit(req.adapters)):
            # Adapter-residency backpressure: every store slot is held by
            # live rows; retirement frees refs, then the LRU evicts.
            return False
        if engine.kv_layout == "paged" and self._active:
            # Pages the live rows pin are untouchable; the rest (free, or
            # held by idle evictable slots) is what a join can claim.
            kv = engine.kv
            pinned = kv.pages_held([r.name for r in self._active])
            if self._pages_needed(req.turns, req.max_new) \
                    > kv.usable_pages() - pinned:
                return False
        return True

    def _start_request(self, req: _Request) -> None:
        """Admission: the engine's own pre-decode phase (_prepare_batch -
        one definition, so scheduled admission cannot drift from
        generate_batch on token parity), with every live row pinned
        against eviction. Loop thread only."""
        engine = self.engine
        # Admission starts the request's clock (queue time is bounded
        # separately in _sweep_queue).
        req.admitted_at = time.monotonic()
        t0 = time.monotonic()
        stats = req.stats
        turn_budget = req.budget if req.budget is not None \
            else deadlines.Budget.root(req.timeout_s, rung="turn")
        deadline = min(turn_budget.deadline,
                       time.monotonic() + req.timeout_s)
        pre_budget = turn_budget.child("prefill")
        max_new, max_new_padded = clamp_max_new(req.max_new,
                                                engine.max_seq_len)
        # Adapter residency, taken on the loop thread under the serve lock
        # (a load's slot write never races a dispatch) for the request's
        # lifetime; released at retirement or failure.
        store = getattr(engine, "lora", None)
        row_slots = None
        if store is not None:
            ads = req.adapters or [None] * len(req.turns)
            row_slots = store.acquire(ads)
            req.adapters = ads
            req.adapters_held = True
        active_names = tuple(r.name for r in self._active)
        scoped_turns = [(scoped_slot(req.session, n), p)
                        for n, p in req.turns]
        # Chunk-interleaved admission: with live rows decoding and the
        # ragged path on, the prefill is deferred onto the ragged
        # dispatches. An empty batch keeps the prologue (nothing to
        # interleave with, and the bucketed chunks are bigger).
        deferred = engine.ragged_enabled and bool(self._active)
        prep = engine._prepare_batch(
            scoped_turns, max_new_padded, deadline, pre_budget,
            req.sampling_per_turn, extra_pinned=active_names,
            defer_prefill=deferred, adapters=req.adapters)
        # The engine may resolve a warm join back to the prologue (suffix
        # below ragged_defer_min); first_np says which mode served.
        deferred = prep["first_np"] is None
        stats.prefill_tokens = prep["prefill_tokens"]
        stats.reused_tokens = prep["reused_tokens"]
        stats.prefix_reused_tokens = prep["prefix_reused_tokens"]
        stats.prefill_seconds = time.monotonic() - t0
        if row_slots and any(row_slots) and not deferred:
            engine.note_lora_tokens(sum(
                len(t) - o for t, o, sl in zip(prep["all_tokens"],
                                               prep["offsets"],
                                               row_slots) if sl))

        eos = engine.tokenizer.eos_id
        per_row = prep["per_row"]
        rows = []
        for i, scoped in enumerate(prep["names"]):
            # Only an explicit sampling_per_turn carries per-row caps (the
            # serving_loop.row_budget_fn rule).
            row_cap = (min(per_row[i].max_new_tokens, max_new)
                       if req.sampling_per_turn else max_new)
            toks = prep["all_tokens"][i]
            if deferred:
                off = prep["offsets"][i]
                if off >= len(toks):
                    # Full-prefix hit: re-feed the last prompt token (the
                    # same K/V bytes at its own position) so the join
                    # still samples a first token; COW the rewritten cell
                    # out of any shared page first.
                    off = len(toks) - 1
                    engine.kv.ensure_capacity(
                        scoped, len(toks), write_from=off,
                        pinned=tuple(prep["names"]) + active_names)
                rows.append(_Row(
                    name=scoped, tokens=toks, sampling=per_row[i],
                    max_new=row_cap, slot_id=prep["slot_ids"][i],
                    pending=list(toks[off:]), pos=off, valid=off,
                    adapter_slot=(row_slots[i] if row_slots else 0)))
            else:
                tok = int(prep["first_np"][i])
                rows.append(_Row(
                    name=scoped, tokens=toks, sampling=per_row[i],
                    max_new=row_cap, slot_id=prep["slot_ids"][i],
                    produced=[tok], last=tok, valid=len(toks),
                    done=(tok == eos),
                    adapter_slot=(row_slots[i] if row_slots else 0)))
        req.rows = rows
        if deferred:
            # Laggard rows block until the leader's chunks have written
            # the common span, then alias it in (_apply_share_plans).
            req.share_plans = [
                {"leader": rows[p["leader"]], "hi": p["hi"],
                 "followers": [(rows[i], lo) for i, lo in p["followers"]]}
                for p in prep["share_plan"]]
            for plan in req.share_plans:
                for f, _lo in plan["followers"]:
                    f.blocked = True
        req.turn_budget = turn_budget
        req.dec_budget = turn_budget.child("decode")
        req.deadline = deadline
        if not deferred:
            req.first_token_at = time.monotonic()
        self._active.extend(rows)
        self._active_reqs.append(req)
        for r in rows:
            self._row_req[id(r)] = req
        self.admitted += 1
        if deferred:
            self.ragged_joins += 1
        self._event("admit", session=req.session, rows=len(rows),
                    queue_wait_s=round(req.admitted_at - req.enqueued, 3),
                    reused_tokens=stats.reused_tokens,
                    ragged_join=deferred)

    # --- the decode segment ---

    def _run_segment(self, live: list[_Row]) -> None:
        """One or more decode segments over the live rows, pipelined like
        serving_loop.decode_segments: while the composition cannot change
        (no queued session, nobody about to retire, work remaining), the
        next segment starts from the previous one's device outputs before
        the host reads them. The port's segment syncs on the all-done flag
        every step, so the carry saves little here; it keeps the JAX
        structure for a later CUDA-graph segment."""
        ctx = self._build_batch(live)
        t_prev = time.monotonic()
        try:
            handles = self._dispatch(ctx)
        except Exception as e:  # noqa: BLE001 - preempt-isolate ladder
            self._handle_segment_failure(live, e)
            return
        while True:
            next_ctx = next_handles = next_err = None
            if self._may_continue(ctx):
                next_ctx = self._advance(ctx, handles)
                try:
                    next_handles = self._dispatch(next_ctx)
                except Exception as e:  # noqa: BLE001 - handled below
                    # Read the in-flight segment first so host state is
                    # consistent, then ladder the next one's failure.
                    next_err = e
            alive = [r for r in ctx["rows"] if not r.done]
            counts = self._account_segment(alive)
            try:
                steps = self._read_segment(ctx, handles)
            except Exception as e:  # noqa: BLE001 - preempt-isolate
                self._handle_segment_failure(alive, e)
                return
            now = time.monotonic()
            self._attribute_wall(counts, now - t_prev)
            # A while-loop segment is pure decode, counted into the same
            # split the ragged segments use.
            self._note_segment_tokens(0, steps * len(alive))
            t_prev = now
            if next_err is not None:
                still = [r for r in alive
                         if not r.done and id(r) in self._row_req]
                if still:
                    self._handle_segment_failure(still, next_err)
                return
            if next_handles is None:
                return
            ctx, handles = next_ctx, next_handles

    def _may_continue(self, ctx: dict) -> bool:
        """Queue the next segment before reading this one only when the
        composition is certain to survive it: no queued session, no
        request whose rows are all done, work plausibly remaining, nothing
        cancelled, the deadline not passed."""
        if self._stop or deadlines.DRAINING:
            return False
        if any(r.pending for r in self._active):
            # Ragged fills are waiting: another whole segment would starve
            # their chunks.
            return False
        if ctx["budgets_max"] <= DECODE_SEGMENT:
            return False  # this segment may finish everything
        if time.monotonic() >= ctx["deadline"]:
            return False
        with self._cv:
            if self._queue:
                return False
        for req in ctx["reqs"]:
            if req not in self._active_reqs or req.abandoned:
                return False
            if req.rows and all(r.done for r in req.rows):
                return False
            if req.turn_budget.token.cancelled or req.turn_budget.expired:
                return False
        return True

    # --- the ragged mixed segment ---

    def _note_segment_tokens(self, prefill: int, decode: int) -> None:
        self.segment_prefill_tokens += prefill
        self.segment_decode_tokens += decode

    def _apply_share_plans(self) -> None:
        """Alias deferred leader spans whose leader chunks have written the
        common span: the laggards' tables take the leader's span pages
        (whole pages alias, boundary pages copy) and the rows unblock,
        their pending already trimmed to the post-span tail."""
        for req in list(self._active_reqs):
            if not req.share_plans:
                continue
            remaining = []
            failed: Optional[BaseException] = None
            for plan in req.share_plans:
                leader = plan["leader"]
                if leader.pos < plan["hi"]:
                    remaining.append(plan)
                    continue
                pinned = tuple(r.name for r in self._active)
                _max_new, padded = clamp_max_new(
                    req.max_new, self.engine.max_seq_len)
                try:
                    for f, lo in plan["followers"]:
                        self.engine.kv.alias_span(
                            leader.name, f.name, lo, plan["hi"], pinned)
                        # Tail capacity, deferred from admission so the
                        # span pages arrive shared, not as transient
                        # exclusive pages the alias would replace.
                        self.engine.kv.ensure_capacity(
                            f.name, len(f.tokens) + padded,
                            write_from=plan["hi"], pinned=pinned)
                        f.blocked = False
                except Exception as e:  # noqa: BLE001 - contain per req
                    # Pool exhaustion mid-join fails only this request.
                    failed = e
                    break
                self._event("share_alias", session=req.session,
                            hi=plan["hi"],
                            followers=len(plan["followers"]))
            if failed is not None:
                self._fail_request(req, failed)
                continue
            req.share_plans = remaining

    def _run_ragged_segment(self, live: list[_Row],
                            filling: list[_Row]) -> None:
        """One ragged mixed dispatch: every live decode row advances one
        token while the filling rows' next prefill chunks ride the same
        dispatch. The flat buffer is token-budgeted; the smallest shape of
        the engine's grid that fits the real work is used. One dispatch
        per tick, so joins, retires and admissions interleave at every
        boundary."""
        engine = self.engine
        budget_slots = engine.ragged_tokens
        # A leader that finished its span in the previous dispatch
        # unblocks its laggards before packing, so their chunks join now.
        self._apply_share_plans()
        filling = [r for r in filling if not r.done and r.pending
                   and not r.blocked]
        if not filling:
            if live:
                self._run_segment(live)
            return
        # A decode row costs one RAGGED_BLOCK_Q block; keep at least one
        # block of chunk room or the mix degenerates.
        if RAGGED_BLOCK_Q * (len(live) + 1) > budget_slots:
            self._event("ragged_overflow", rows=len(live))
            if live:
                self._run_segment(live)
            return
        reqs = self._reqs_of(live + filling)
        remaining = min((req.turn_budget.remaining() for req in reqs),
                        default=float("inf"))
        seg_budget = deadlines.Budget.root(
            None if remaining == float("inf") else remaining,
            rung="decode")
        deadline = min((req.deadline for req in reqs),
                       default=float("inf"))
        want = RAGGED_BLOCK_Q * len(live) + sum(
            -(-len(r.pending) // RAGGED_BLOCK_Q) * RAGGED_BLOCK_Q
            for r in filling)
        shape = ragged_pick_shape(engine.ragged_shapes,
                                  min(want, budget_slots))
        seqs: list[RaggedSeq] = []
        rows_in: list[tuple[str, _Row, int]] = []
        for r in live:
            seqs.append(RaggedSeq(
                [r.last], r.valid, engine.kv.table_for([r.name])[0],
                temperature=r.sampling.temperature,
                top_k=r.sampling.top_k, top_p=r.sampling.top_p,
                adapter=r.adapter_slot))
            rows_in.append(("decode", r, 1))
        slots_left = shape - RAGGED_BLOCK_Q * len(live)
        for r in filling:
            if slots_left < RAGGED_BLOCK_Q:
                break
            take = min(len(r.pending), slots_left)
            seqs.append(RaggedSeq(
                list(r.pending[:take]), r.pos,
                engine.kv.table_for([r.name])[0],
                temperature=r.sampling.temperature,
                top_k=r.sampling.top_k, top_p=r.sampling.top_p,
                adapter=r.adapter_slot))
            rows_in.append(("prefill", r, take))
            slots_left -= -(-take // RAGGED_BLOCK_Q) * RAGGED_BLOCK_Q
        batch = build_ragged_batch(
            seqs, t_budget=shape, s_max=engine.kv.num_slots + 1,
            pages_per_seq=engine.kv.pages_per_seq,
            scratch_page=SCRATCH_PAGE, pad_id=engine.tokenizer.pad_id,
            page_size=engine.kv.page_size)

        t0 = time.monotonic()
        try:
            handles = run_dispatch(lambda: engine._ragged_dispatch(batch),
                                   engine.retry, deadline,
                                   budget=seg_budget)
            nxt = host_sync(lambda: handles.cpu().numpy(), seg_budget,
                            "decode")
        except Exception as e:  # noqa: BLE001 - preempt-isolate ladder
            self._handle_ragged_failure(live, filling, e)
            return
        wall = time.monotonic() - t0

        eos = engine.tokenizer.eos_id
        now = time.monotonic()
        n_prefill = n_decode = lora_toks = 0
        for i, (kind, r, take) in enumerate(rows_in):
            tok = int(nxt[i])
            req = self._row_req.get(id(r))
            if r.adapter_slot:
                lora_toks += take
            if kind == "decode":
                r.produced.append(tok)
                r.last = tok
                r.valid += 1
                r.done = (tok == eos) or len(r.produced) >= r.max_new
                n_decode += 1
            else:
                del r.pending[:take]
                r.pos += take
                n_prefill += take
                if not r.pending:
                    # Join complete: the chunk that finished the prompt
                    # also sampled the row's first token.
                    r.produced = [tok]
                    r.last = tok
                    r.valid = r.pos
                    r.done = (tok == eos) or len(r.produced) >= r.max_new
                    if (req is not None and req.first_token_at is None
                            and all(not rr.pending for rr in req.rows)):
                        req.first_token_at = now
                        self._event(
                            "join_complete", session=req.session,
                            ttft_s=round(now - req.enqueued, 3))

        # Provenance + attribution: the mixed dispatch splits its wall by
        # per-row token counts - decode rows' share lands in their
        # requests' decode_seconds, chunk tokens in prefill_seconds.
        engine.note_lora_tokens(lora_toks)
        self.ragged_segments += 1
        self._note_segment_tokens(n_prefill, n_decode)
        occ = len(seqs)
        self.max_occupancy = max(self.max_occupancy, occ)
        with self._cv:
            self._occupancy.append(occ)
        _note_rows(occ)
        total = max(n_prefill + n_decode, 1)
        sessions = len(reqs)
        for kind, r, take in rows_in:
            req = self._row_req.get(id(r))
            if req is None:
                continue
            share = wall * take / total
            if kind == "decode":
                req.stats.decode_seconds += share
            else:
                req.stats.prefill_seconds += share
        for req in reqs:
            req.seg_count += 1
            req.occ_sum += occ
            req.occ_max = max(req.occ_max, occ)
            req.sess_max = max(req.sess_max, sessions)

    def _handle_ragged_failure(self, live: list[_Row],
                               filling: list[_Row],
                               err: BaseException) -> None:
        """A ragged mixed dispatch failed: preempt. Requests with rows
        mid-prefill fail alone (their pages hold a half-written chunk; the
        adapter ladder re-prefills from the prompt), while decode-only
        sessions re-dispatch through the decode segment from intact host
        and KV state. Loop thread only."""
        self.preemptions += 1
        self._event("preempt_isolate", error=str(err)[:200], ragged=True,
                    sessions=[req.session
                              for req in self._reqs_of(live + filling)])
        for req in self._reqs_of(live + filling):
            if req not in self._active_reqs:
                continue
            if any(r.pending for r in req.rows):
                self._fail_request(req, err)
                continue
            mine = [r for r in live if r in req.rows and not r.done]
            if not mine:
                continue
            t0 = time.monotonic()
            try:
                self._dispatch_rows(mine)
            except Exception as e:  # noqa: BLE001 - per-session contain
                self._fail_request(req, e)
                continue
            req.stats.decode_seconds += time.monotonic() - t0

    # --- decode batches ---

    def _reqs_of(self, rows: list[_Row]) -> list[_Request]:
        seen: dict[int, _Request] = {}
        for r in rows:
            req = self._row_req.get(id(r))
            if req is not None:
                seen.setdefault(id(req), req)
        return list(seen.values())

    def _account_segment(self, alive: list[_Row]) -> dict:
        """Occupancy provenance of one consumed segment; returns the
        per-request live-row counts ({id: (req, n)}) the wall attribution
        reuses."""
        counts: dict[int, tuple[_Request, int]] = {}
        for r in alive:
            req = self._row_req.get(id(r))
            if req is None:
                continue
            prev = counts.get(id(req))
            counts[id(req)] = (req, (prev[1] + 1) if prev else 1)
        occ = len(alive)
        sessions = len(counts)
        self.segments += 1
        self.max_occupancy = max(self.max_occupancy, occ)
        with self._cv:
            self._occupancy.append(occ)
        _note_rows(occ)
        for req, _n in counts.values():
            req.seg_count += 1
            req.occ_sum += occ
            req.occ_max = max(req.occ_max, occ)
            req.sess_max = max(req.sess_max, sessions)
        return counts

    def _attribute_wall(self, counts: dict, wall: float) -> None:
        """A segment's wall goes to its sessions by live-row share, so the
        sums over requests equal the real wall."""
        total = sum(n for _req, n in counts.values())
        for req, n in counts.values():
            req.stats.decode_seconds += wall * n / max(total, 1)

    def _row_bucket(self, n: int) -> int:
        """Decode batch sizes round up to powers of two (capped at
        max_rows): {1, 2, 4, ..., max_rows}."""
        return min(pow2_bucket(n), self.max_rows)

    def _dispatch_rows(self, rows: list[_Row]) -> None:
        """One unpipelined decode segment over `rows` - the fault-isolation
        re-dispatch path."""
        ctx = self._build_batch(rows)
        self._read_segment(ctx, self._dispatch(ctx))

    def _build_batch(self, rows: list[_Row]) -> dict:
        """Device inputs of one decode segment over `rows`, padded to
        _row_bucket with masked pad rows (done from step 0, zero budget).
        Paged pad rows point every table entry at the scratch page;
        contiguous pad rows all point at kv.scratch_slot (a free slot, or
        the LRU unpinned one), writing identical bytes at one position,
        or the dispatch runs at its exact size when every slot is
        pinned."""
        engine = self.engine
        dev = engine.device
        eos = engine.tokenizer.eos_id
        reqs = self._reqs_of(rows)
        remaining = min((req.turn_budget.remaining() for req in reqs),
                        default=float("inf"))
        seg_budget = deadlines.Budget.root(
            None if remaining == float("inf") else remaining,
            rung="decode")
        deadline = min((req.deadline for req in reqs),
                       default=float("inf"))
        pad = self._row_bucket(len(rows)) - len(rows)
        if engine.kv_layout == "paged":
            index = engine.kv.table_for([r.name for r in rows])
            index = np.concatenate([index, np.full(
                (pad, index.shape[1]), SCRATCH_PAGE, index.dtype)])
        else:
            index = np.asarray([r.slot_id for r in rows], np.int32)
            pad_slot = (engine.kv.scratch_slot(
                pinned=tuple(r.name for r in self._active)) if pad else None)
            if pad_slot is None:
                pad = 0
            index = np.concatenate([index, np.full(pad, pad_slot or 0,
                                                   np.int32)])
        last = [r.last for r in rows] + [eos] * pad
        valid = [r.valid for r in rows] + [1] * pad
        done0 = [False] * len(rows) + [True] * pad
        budgets = [max(r.max_new - len(r.produced), 0)
                   for r in rows] + [0] * pad
        params = [r.sampling for r in rows] + [
            SamplingParams(temperature=1.0)] * pad
        temps, top_ks, top_ps = sampling_arrays(params, dev)
        # Per-row adapter slots; pad rows take the base (zero) adapter,
        # their outputs are masked anyway.
        lora = engine._lora_args([r.adapter_slot for r in rows] + [0] * pad)
        return {
            "rows": rows, "reqs": reqs,
            "index": torch.as_tensor(index, device=dev),
            "last_d": engine._ints(last), "valid_d": engine._ints(valid),
            "done_d": torch.tensor(done0, device=dev),
            "budgets_d": engine._ints(budgets), "temps": temps,
            "top_ks": top_ks, "top_ps": top_ps,
            "greedy": all(r.sampling.temperature <= 0.0 for r in rows),
            "seg_budget": seg_budget, "deadline": deadline,
            "budgets_max": max(budgets) if budgets else 0, "lora": lora,
        }

    def _dispatch(self, ctx: dict):
        """One segment for `ctx` through the engine's decode seam (the
        same commit_guard as generate_batch) and the run_dispatch
        retry/watchdog seam. Returns (out, steps, last, valid, done) with
        device tensors."""
        engine = self.engine
        seam = (engine._decode_dispatch_paged
                if engine.kv_layout == "paged"
                else engine._decode_dispatch_slots)
        return run_dispatch(
            lambda: seam(
                ctx["index"], ctx["last_d"], ctx["valid_d"],
                DECODE_SEGMENT, ctx["temps"], ctx["top_ks"], ctx["top_ps"],
                ctx["budgets_d"], ctx["done_d"], greedy=ctx["greedy"],
                lora=ctx["lora"]),
            engine.retry, ctx["deadline"], budget=ctx["seg_budget"])

    def _advance(self, ctx: dict, handles) -> dict:
        """The next segment's ctx from this segment's device outputs:
        done/valid/last carry, per-row budgets drop by the steps taken."""
        _out, steps, last, valid, done = handles
        nxt = dict(ctx)
        nxt["last_d"], nxt["valid_d"], nxt["done_d"] = last, valid, done
        nxt["budgets_d"] = torch.clamp(ctx["budgets_d"] - steps, min=0)
        # Upper-bound estimate for _may_continue: a segment consumes at
        # most DECODE_SEGMENT of every row's budget.
        nxt["budgets_max"] = ctx["budgets_max"] - DECODE_SEGMENT
        return nxt

    def _read_segment(self, ctx: dict, handles) -> int:
        """Host-read one segment's results (through the watchdog seam) and
        fold them into the rows' host state. Returns the steps taken."""
        out, steps, last, valid, done = handles

        def read():
            return (out[:, :steps].cpu().numpy(), last.cpu().numpy(),
                    valid.cpu().numpy(), done.cpu().numpy())

        out_np, last_np, valid_np, done_np = host_sync(
            read, ctx["seg_budget"], "decode")
        eos = self.engine.tokenizer.eos_id
        lora_toks = 0
        for i, r in enumerate(ctx["rows"]):
            if r.done:
                continue  # masked rows emit eos filler - not output
            row = [int(x) for x in out_np[i]]
            r.produced.extend(row)
            r.last = int(last_np[i])
            r.valid = int(valid_np[i])
            r.done = bool(done_np[i]) or len(r.produced) >= r.max_new
            if r.adapter_slot:
                # Tokens up to and including the row's eos: the filler
                # after it is not served work.
                lora_toks += (row.index(eos) + 1 if eos in row
                              else len(row))
        self.engine.note_lora_tokens(lora_toks)
        return steps

    # --- failure containment ---

    def _handle_segment_failure(self, live: list[_Row],
                                err: BaseException) -> None:
        """The shared decode dispatch failed: preempt the batch into
        per-session dispatches. The session the fault follows fails alone;
        everyone else's rows re-run their segment from intact host and KV
        state. Loop thread only."""
        self.preemptions += 1
        self._event("preempt_isolate", error=str(err)[:200],
                    sessions=[req.session for req in self._reqs_of(live)])
        for req in self._reqs_of(live):
            mine = [r for r in live if r in req.rows]
            t0 = time.monotonic()
            try:
                self._dispatch_rows(mine)
            except Exception as e:  # noqa: BLE001 - per-session contain
                self._fail_request(req, e)
                continue
            req.stats.decode_seconds += time.monotonic() - t0

    def _release_adapters(self, req: _Request) -> None:
        store = getattr(self.engine, "lora", None)
        if store is not None and req.adapters_held:
            req.adapters_held = False
            store.release(req.adapters or [])

    def _fail_request(self, req: _Request, err: BaseException) -> None:
        """Fail one request into its submitter, releasing its slots and
        adapters. Loop thread only."""
        self._release_adapters(req)
        for r in req.rows:
            self.engine.kv.release(r.name)
        self._drop_request(req)
        req.error = err
        self.failed += 1
        self._event("fail", session=req.session, error=str(err)[:200])
        req.event.set()

    def _drop_request(self, req: _Request) -> None:
        if req in self._active_reqs:
            self._active_reqs.remove(req)
        for r in req.rows:
            self._row_req.pop(id(r), None)
        self._active = [r for r in self._active if r not in req.rows]

    # --- retirement ---

    def _retire_finished(self) -> None:
        """Retire every all-done request: eos-trim, commit each slot's
        tokens for next-round reuse, stats. Loop thread only."""
        engine = self.engine
        eos = engine.tokenizer.eos_id
        for req in list(self._active_reqs):
            if not req.rows or not all(r.done for r in req.rows):
                continue
            max_new, _padded = clamp_max_new(req.max_new,
                                             engine.max_seq_len)
            texts = []
            for r in req.rows:
                ids = eos_trim(list(r.produced), eos, max_new)
                req.stats.decode_tokens += len(ids)
                # Commit prompt + every fed token (all but the last
                # sampled one) - the finalize_outputs contract.
                fed = ids[:-1] if ids else []
                engine.kv.commit(r.name, r.tokens + fed)
                texts.append(engine.tokenizer.decode(ids))
            self._release_adapters(req)
            req.stats.sched = {
                "queue_wait_s": round(
                    (req.admitted_at or req.enqueued) - req.enqueued, 3),
                "segments": req.seg_count,
                "occupancy_mean": (round(req.occ_sum / req.seg_count, 2)
                                   if req.seg_count else 0.0),
                "occupancy_max": req.occ_max,
                "sessions_max": req.sess_max,
            }
            if req.first_token_at is not None:
                # TTFT: submit -> every row of the round has its first
                # sampled token.
                req.stats.sched["ttft_s"] = round(
                    req.first_token_at - req.enqueued, 3)
            if req.adapters and any(a is not None for a in req.adapters):
                # Which persona served each knight of the round.
                req.stats.sched["lora_adapters"] = list(req.adapters)
            self._drop_request(req)
            req.result = (texts, req.stats)
            self.completed += 1
            self._event("retire", session=req.session,
                        decode_tokens=req.stats.decode_tokens,
                        occupancy_max=req.occ_max)
            req.event.set()

    # --- per-request health (budgets / cancellation / abandonment) ---

    def _check_request_health(self) -> None:
        now = time.monotonic()
        for req in list(self._active_reqs):
            if req.abandoned:
                self._fail_request(req, TimeoutError(
                    f"session {req.session!r} abandoned by its waiter"))
                continue
            try:
                req.turn_budget.token.check()
            except deadlines.Cancelled as e:
                self._fail_request(req, e)
                continue
            if now > req.deadline or req.turn_budget.expired:
                produced = sum(
                    max(len(r.produced) - 1, 0) for r in req.rows)
                self._fail_request(req, TimeoutError(
                    f"generation timed out after {req.timeout_s:.0f}s "
                    f"({produced} decode tokens across the session's "
                    "rows)"))


_scheduler_for_lock = threading.Lock()


def acquire_scheduler(engine, **opts) -> tuple[SessionScheduler, bool]:
    """(scheduler, created): the engine's attached scheduler, building one
    on first use - every session sharing an engine must share its
    scheduler, or two would fight over the serve lock. `created` is
    decided inside the lock, so a caller never closes a scheduler another
    thread created."""
    with _scheduler_for_lock:
        existing = getattr(engine, "_scheduler", None)
        if existing is not None and not existing.closed:
            return existing, False
        return SessionScheduler(engine, **opts), True


def scheduler_for(engine, **opts) -> SessionScheduler:
    """acquire_scheduler for callers that do not track ownership."""
    return acquire_scheduler(engine, **opts)[0]
