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
- **Speculative decoding.** On a speculating engine each row carries a
  RowSpec (engine/spec_decode.py). With no row filling and some row
  drafting, a tick is one verify dispatch: every row's ``[last,
  drafts...]`` run (tree rows: one run per candidate path, on loaned
  pages) is scored in one ragged forward and each row commits its
  accepted prefix plus one token; otherwise the plain segments serve. The
  adaptive throttle stops a row whose drafts are rarely accepted.
- **Host-RAM spill.** On an engine with the offload tier
  (engine/kv_offload.py), an admission whose new-page demand exceeds the
  free pages first spills idle sessions (least recently active first) to
  host RAM instead of letting the allocator evict their slots, and with
  `idle_spill_s` a session idle that long spills on a tick. A spilled
  session restores at its next submit (the engine's _prepare_batch) and
  prefills only its delta. Speculative draft slots are never spilled, and
  persona rows never feed the cross-session prefix cache.

- **Supervision.** A dispatch failure that classifies `device_lost` (on a
  card: every error that ends the CUDA context), or repeated hangs, goes
  to the EngineSupervisor (engine/supervisor.py) before the preempt
  ladder: it pauses admission, fails the active requests into their
  ladders, evacuates the idle sessions to host RAM, rebuilds the engine
  and re-attaches this scheduler (`reattach_engine`). A dead engine fails
  every later submit fast with EngineDead. `quiesce`, `pause_admission`,
  `reopen_admission`, `fail_active_requests` and `force_fail_active` are
  the supervisor's and fleet.drain's seams.
- **Durable journal.** With a SessionJournal attached, every retired round
  appends one fsynced committed-turn record (engine/session_journal.py),
  so `serve --resume` survives a kill -9.
- **Telemetry.** Every decision counter moves with its registry series
  (`_bump`), every event lands in the flight recorder, and armed telemetry
  emits a `turn` span per request and a `segment` span per dispatch.

- **Committed-token streaming.** `submit_async(on_commit=...)` calls the
  callback on the loop thread with `tokens` events (each row's new
  eos-trimmed tokens, so the stream equals the journal's `produced`)
  after every segment fold - ragged, speculative and each plain segment
  (a streaming request ends a pipelined run of plain segments at each
  one) - then `retired` once the turn is journaled, or `failed`. The
  tokens are the Python ints the segment's own read already brought to
  the host: a flush adds no device read. A raising callback costs only
  its stream.
- **Perf samples.** Each segment publishes its roofline sample
  (engine.perf: `publish_decode_sample`, `publish_mixed_sample` with the
  speculative accepted-vs-dispatch split) and per-session KV footprints;
  retirement publishes the round's GenStats and the memory ledger.

Replica labels: a session router names each replica's scheduler
(`set_replica`), and every registry series it writes then carries
`replica=` beside `engine=`.

- **On a mesh.** The engine spans one process per rank, and every rank's
  engine must take the same calls in the same order. The scheduler on
  rank 0 owns admission and every clock-bound decision and reaches its
  engine through engine/mesh_plan.PlanEngine, which broadcasts each
  state-changing call (admission, decode segment from host inputs,
  ragged dispatch, slot and adapter bookkeeping, spills) to the other
  ranks before making it; on those ranks the scheduler's thread follows
  the plans (`submit` raises there) and ends when rank 0 closes. A
  deadline or a cancellation takes effect between plans, never inside a
  planned call; if the ranks ever leave lockstep (mesh_plan.MeshDesync),
  rank 0 fails every request with it and stops, and a follower's close()
  raises it. On a
  data axis the decode batch is ReplicaGroupPlan's padded layout
  (bucket_group, as in JAX) and joins take the blocking prologue (the
  ragged seam declines `mesh:data-axis`). Segments are not pipelined on a
  mesh, and a device drafter, the supervisor's rebuild and a router over
  a mesh engine are not served there.

The engine's pools are updated in place
and never donated, so no dispatch failure takes the whole pool down with
it: the JAX scheduler's revive-and-fail-all rung has nothing to do here.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..core.errors import ITEM_7E_II, not_ported
from ..utils import telemetry
from . import deadlines, faults, trace_hooks
from .kvcache import scoped_slot, session_of
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


# Registry of live schedulers (weak - a dropped scheduler must not be kept
# alive by observability): fleet_health() and fleet.drain() walk it.
_registry_lock = threading.Lock()
_instances: list = []


def _register(sched: "SessionScheduler") -> None:
    with _registry_lock:
        _instances.append(weakref.ref(sched))


def schedulers() -> list["SessionScheduler"]:
    """Every live SessionScheduler (fleet_health / fleet.drain)."""
    out = []
    with _registry_lock:
        alive = []
        for ref in _instances:
            s = ref()
            if s is not None:
                alive.append(ref)
                out.append(s)
        _instances[:] = alive
    return out


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
    # Speculative decoding: the row's drafter and throttle
    # (spec_decode.RowSpec); None on engines without speculation.
    spec: Optional[Any] = None
    # Committed-token streaming: how many eos-trimmed tokens of this row
    # the request's on_commit callback has had. eos_trim is prefix-stable
    # as `produced` grows, so ids[streamed:] is exactly the new span.
    streamed: int = 0


class _Request:
    """One session round: queued -> active -> done|failed."""

    __slots__ = ("session", "turns", "sampling_per_turn", "max_new",
                 "timeout_s", "budget", "event", "result", "error",
                 "enqueued", "admitted_at", "rows", "stats", "deadline",
                 "turn_budget", "dec_budget", "abandoned", "seg_count",
                 "occ_sum", "occ_max", "sess_max", "requeues",
                 "fits_below", "first_token_at", "share_plans",
                 "adapters", "adapters_held", "spec_drafted",
                 "spec_accepted", "tele_ctx", "tele", "on_commit")

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
        # This request's drafted / accepted totals (stats.sched["spec"]).
        self.spec_drafted = 0
        self.spec_accepted = 0
        # The submitter thread's span context, so this request's "turn"
        # span parents into ITS discussion trace although the scheduler
        # thread emits it; `tele` is that span while the request is
        # active.
        self.tele_ctx = telemetry.current_context() \
            if telemetry.ACTIVE else None
        self.tele = None
        # Committed-token streaming: called on the loop thread with
        # {"type": "tokens"|"retired"|"failed", ...} events at segment
        # boundaries. A raising callback is disabled (set to None): a
        # broken consumer never wedges serving.
        self.on_commit = None


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
                    "SessionScheduler requires the port's single-program "
                    f"InferenceEngine (missing {attr!r}); pipe-mesh engines "
                    "serve round-level batches - use session-namespaced "
                    "generate_batch calls instead")
        if not (hasattr(engine, "_decode_dispatch_paged")
                or hasattr(engine, "_decode_dispatch_slots")):
            raise TypeError("SessionScheduler requires the port's "
                            "InferenceEngine (no decode seam)")
        # On a mesh rank 0 schedules and the other ranks follow its plans
        # (engine/mesh_plan.py).
        self._channel = None
        self._channel_closed = False
        self.follower = False
        self.follow_counts: Optional[dict] = None
        self.follow_error: Optional[BaseException] = None
        if getattr(engine, "mesh", None) is not None:
            from .mesh_plan import PlanChannel, PlanEngine, kv_digest
            if getattr(engine, "spec_device_drafter", None) is not None:
                raise not_ported("a device drafter under the scheduler on "
                                 "a mesh", ITEM_7E_II)
            kv = engine.kv
            self._channel = PlanChannel(engine.mesh,
                                        digest=lambda: kv_digest(kv))
            self.follower = self._channel.rank != 0
            if not self.follower:
                engine = PlanEngine(engine, self._channel)
        self.engine = engine
        self.admit_hold_s = admit_hold_s
        self.max_rows = min(max_rows or engine.kv.num_slots,
                            engine.kv.num_slots)
        # Host-RAM offload policy: per-session last activity drives the
        # spills - under page pressure at admission (always, with the
        # engine's tier) and, with idle_spill_s set, of sessions idle that
        # long on each tick. None = pressure-driven only.
        self.idle_spill_s = idle_spill_s
        self._last_active: dict[str, float] = {}
        self.spills = 0
        self._queue: deque[_Request] = deque()
        self._active: list[_Row] = []         # rows, admission order
        self._active_reqs: list[_Request] = []
        self._row_req: dict[int, _Request] = {}  # id(row) -> request
        # Condition() holds an RLock: _event may run under it already.
        self._cv = threading.Condition()
        self._stop = False
        self.closed = False
        self._lock_held = False
        # The lock OBJECT held: a supervised rebuild swaps self.engine
        # mid-lifetime, and releasing the new engine's (unheld) lock would
        # leak the old one's.
        self._held_lock: Optional[threading.Lock] = None
        # Admission gate: while set, queued requests stay QUEUED (the
        # supervisor's quiesce, fleet.drain); reopen_admission (or
        # fleet.resume) lifts it. A reason string, None = open.
        self._paused: Optional[str] = None
        # Thread-safe preempt mailbox: force_fail_active posts an error
        # here; the loop thread consumes it at its next health check.
        self._force_fail: Optional[BaseException] = None
        # Durable session journal: when attached, every retired round
        # appends one fsynced committed-turn record.
        self._journal = journal
        # THIS scheduler's share of the (possibly shared) journal's
        # records and errors.
        self.journal_turns = 0
        self.journal_errors = 0
        # Decision provenance: every counter moves with its registry
        # series (_bump).
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
        # Speculative verify dispatches issued.
        self.spec_segments = 0
        self._occupancy: deque[int] = deque(maxlen=_OCCUPANCY_LOG_CAP)
        self._events: deque[dict] = deque(maxlen=_EVENT_LOG_CAP)
        # Registry label of this scheduler's series.
        self._tname = getattr(engine.cfg, "name", "engine")
        # Fleet replica name, set by the session router when this scheduler
        # serves one replica of a data-parallel fleet. N replicas of one
        # model share `_tname`, so every registry series carries `replica=`
        # once it is set, and the router removes the labelled series when
        # the replica retires.
        self.replica: Optional[str] = None
        # Attaching a scheduler adds work to an engine whose warmup() may
        # have declared steady state: reopen the warmup phase until the
        # caller re-declares (declare_warmup_complete).
        from . import compile_watch
        compile_watch.reopen_warmup(self._tname)
        self._thread = threading.Thread(
            target=self._follow if self.follower else self._loop,
            daemon=True,
            name=f"session-scheduler-{getattr(engine.cfg, 'name', '?')}")
        engine._scheduler = self           # describe() provenance
        _register(self)
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
                     on_commit=None,
                     queue_when_paused: bool = True) -> _Request:
        """Queue one session round and return its handle (`wait` resolves
        it). `on_commit(event)` streams the round's committed tokens (see
        the module docstring). `queue_when_paused=False` refuses while
        admission is paused - SchedulerRefused carrying the pause reason
        verbatim - for callers that shed instead of queueing (the
        gateway)."""
        if self.follower:
            raise RuntimeError(
                f"submit runs on rank 0 of a mesh: rank "
                f"{self._channel.rank} follows rank 0's plans")
        if self.closed:
            raise SchedulerClosed("scheduler is closed")
        if not turns:
            raise ValueError("submit() needs at least one turn")
        # Drain gate at the queue mouth.
        deadlines.check_admission()
        if budget is not None and budget.expired:
            with self._cv:  # submitter threads race each other here
                self._bump("deadline_expired")
            self._event("deadline_expired", session=session)
            raise DeadlineExpired(
                f"session {session!r} submitted with its budget already "
                "spent - refused before any prefill dispatch")
        if not queue_when_paused:
            paused = self._paused
            if paused is not None:
                with self._cv:
                    self._bump("refused")
                self._event("refuse", session=session,
                            reason=f"admission paused: {paused}")
                raise SchedulerRefused(
                    f"session {session!r} refused while admission is "
                    f"paused ({paused}) - caller sheds instead of "
                    "queueing behind a closed gate", reason=paused)
        engine = self.engine
        # Dead-engine gate: the supervisor exhausted this engine's restart
        # budget - every submit fails fast with the same classified reason
        # instead of queueing into a corpse.
        from ..core.errors import classify_error
        from .supervisor import EngineDead, engine_dead_reason
        dead = engine_dead_reason(engine)
        if dead is not None:
            # The reason carries the terminal cause, so the kind survives
            # into the adapter ladder (device_lost stays device_lost).
            raise EngineDead(
                f"engine {self._tname!r} is dead: {dead}",
                kind=classify_error(RuntimeError(dead)))
        # Against max_rows, not num_slots: a request wider than the batch
        # would sit at the FIFO head forever and starve every later one.
        if len(turns) > self.max_rows:
            with self._cv:
                self._bump("refused")
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
                    self._bump("refused")
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
                self._bump("refused")
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
        req.on_commit = on_commit
        with self._cv:
            # Re-checked under the lock: close() flips `closed` and drains
            # the queue under it, so no request lands in a dead queue.
            if self.closed or self._stop:
                raise SchedulerClosed("scheduler is closed")
            self._queue.append(req)
            self.queued_peak = max(self.queued_peak, len(self._queue))
            self._last_active[session] = time.monotonic()
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

    def _series_labels(self) -> dict[str, str]:
        """Labels of this scheduler's registry series: engine-keyed, plus
        `replica=` once a router names this scheduler a replica."""
        if self.replica is not None:
            return {"engine": self._tname, "replica": self.replica}
        return {"engine": self._tname}

    def set_replica(self, name: Optional[str]) -> None:
        """Name this scheduler's fleet replica. The router calls this once
        at fleet build; None detaches (no replica label)."""
        self.replica = name

    def _bump(self, counter: str, n: int = 1) -> None:
        """Increment a decision counter AND its registry series in one
        place: no counter moves without the registry seeing it."""
        setattr(self, counter, getattr(self, counter) + n)
        telemetry.inc(f"roundtable_sched_{counter}_total", n,
                      **self._series_labels())

    def _event(self, kind: str, **fields) -> None:
        e = {"event": kind, "at": round(time.monotonic(), 3)}
        e.update(fields)
        with self._cv:  # RLock - safe from paths already holding it
            self._events.append(e)
        # Mirrored into the flight recorder: a hang/trip/restart dump then
        # carries the scheduler's recent decisions beside the spans.
        telemetry.recorder().record(f"sched_{kind}", engine=self._tname,
                                    **{k: v for k, v in fields.items()
                                       if k not in ("kind", "at")})
        telemetry.set_gauge("roundtable_sched_queue_depth",
                            len(self._queue), **self._series_labels())
        telemetry.set_gauge("roundtable_sched_active_rows",
                            len(self._active), **self._series_labels())

    def describe(self) -> dict[str, Any]:
        """Scheduler provenance for engine.describe(): the JAX
        scheduler's keys."""
        with self._cv:
            occ = list(self._occupancy)
            events = list(self._events)
        tier = getattr(self.engine, "kv_offload", None)
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
            "spec_segments": self.spec_segments,
            "segment_prefill_tokens": self.segment_prefill_tokens,
            "segment_decode_tokens": self.segment_decode_tokens,
            "queued": len(self._queue),
            "queued_peak": self.queued_peak,
            "active_rows": len(self._active),
            "max_occupancy": self.max_occupancy,
            "occupancy_mean": (round(sum(occ) / len(occ), 2)
                               if occ else 0.0),
            "occupancy_recent": occ[-32:],
            "spills": self.spills,
            "spilled_sessions": (len(tier.spilled_sessions())
                                 if tier is not None else 0),
            "paused": self._paused,
            "admission": {
                "paused": self._paused,
                "open": self._paused is None and not self.closed,
                "queued": len(self._queue),
            },
            "journal_turns": self.journal_turns,
            "journal_errors": self.journal_errors,
            "events": events,
        }

    def snapshot(self) -> dict[str, Any]:
        """Cheap roll-up: queue depth and each session's state (queued,
        active with its live rows, or spilled to host RAM). A closed
        scheduler reports no spilled sessions: its engine may outlive it
        and serves them through no scheduler."""
        sessions: dict[str, str] = {}
        with self._cv:
            for req in self._queue:
                sessions.setdefault(req.session, "queued")
        for req in list(self._active_reqs):
            live = sum(1 for r in req.rows if not r.done)
            sessions[req.session] = f"active({live} live rows)"
        tier = getattr(self.engine, "kv_offload", None)
        if tier is not None and not self.closed:
            for s in tier.spilled_sessions():
                sessions.setdefault(s, "spilled(host RAM)")
        return {
            "engine": getattr(self.engine.cfg, "name", "?"),
            "queued": len(self._queue),
            "active_rows": len(self._active),
            "sessions": sessions,
            "paused": self._paused,
            "closed": self.closed,
        }

    def declare_warmup_complete(self) -> None:
        """Declare this scheduler's build set closed: any later kernel
        build attributable to its engine is a steady-state violation -
        counted and flight-dumped always, fatal under
        ROUNDTABLE_RECOMPILE_STRICT=1 (engine/compile_watch.py)."""
        from . import compile_watch
        compile_watch.warmup_complete(self._tname)

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
                    self._bump("rejected_draining")
                else:
                    self._bump("rejected_other")
            if draining:
                self._event("reject_drain", session=req.session)
            else:
                self._event("reject", session=req.session,
                            reason=type(error).__name__)
        return len(rejected)

    def pause_admission(self, reason: str = "paused") -> None:
        """Close the admission gate: queued and newly submitted requests
        WAIT (nothing is rejected); active requests keep serving. The
        supervisor's quiesce and fleet.drain use it; reopen_admission (or
        fleet.resume) lifts it."""
        with self._cv:
            if self._paused is None:
                self._paused = reason
        self._event("pause_admission", reason=reason)

    def reopen_admission(self) -> None:
        """Re-open the admission gate and wake the loop."""
        with self._cv:
            was = self._paused
            self._paused = None
            self._cv.notify_all()
        if was is not None:
            self._event("reopen_admission", was=was)

    @property
    def paused(self) -> Optional[str]:
        return self._paused

    def quiesce(self, timeout_s: float = 30.0) -> bool:
        """Pause admission and wait (from a non-loop thread) for every
        ACTIVE request to retire or fail - the supervisor's step 2.
        Returns True when the batch drained clean within `timeout_s`
        (queued requests stay queued; they serve after the restart)."""
        self.pause_admission("quiesce")
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._active_reqs and time.monotonic() < deadline:
                # Retirement doesn't notify the cv: the timeout doubles
                # as the poll cadence.
                self._cv.wait(timeout=0.05)
        return not self._active_reqs

    def fail_active_requests(self, err: BaseException) -> int:
        """Fail every active request with `err` - LOOP THREAD ONLY (the
        supervisor's crash path runs on this thread inside the failed
        dispatch's tick). Returns the count."""
        reqs = list(self._active_reqs)
        for req in reqs:
            self._fail_request(req, err)
        return len(reqs)

    def force_fail_active(self, err: BaseException,
                          timeout_s: float = 5.0) -> int:
        """Thread-safe preempt: ask the loop to fail every active request
        with `err` at its next health check, then wait for it (request
        state is single-writer). Returns the requests failed (best effort:
        a loop wedged in a device wait is the watchdog's to unwedge)."""
        with self._cv:
            n = len(self._active_reqs)
            if n == 0:
                return 0
            self._force_fail = err
            self._cv.notify_all()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if not self._active_reqs:
                return n
            time.sleep(0.02)
        return n - len(self._active_reqs)

    def reattach_engine(self, new_engine) -> None:
        """Point this scheduler at a REBUILT engine (the supervisor's step
        5). Caller contract: admission is paused, no requests are active,
        and this scheduler holds no serve lock of the old engine. The
        rebuilt engine re-enters warmup (reopen_warmup); the caller
        re-declares via declare_warmup_complete()."""
        from . import compile_watch
        self.engine = new_engine
        new_engine._scheduler = self
        self.max_rows = min(self.max_rows, new_engine.kv.num_slots)
        compile_watch.reopen_warmup(self._tname)
        self._event("reattach_engine")

    def attach_journal(self, journal) -> None:
        """Attach a durable session journal (engine/session_journal): every
        retired round appends one fsynced committed-turn record."""
        self._journal = journal

    @property
    def journal(self):
        return self._journal

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop the loop: queued requests are rejected, active requests
        get `timeout_s` to finish, then the thread exits. On rank 0 of a
        mesh the followers' channel closes after it; a follower waits up
        to `timeout_s` for that, and raises the MeshDesync that ended its
        loop, if one did."""
        if self.follower:
            self._thread.join(timeout=timeout_s)
            if self.follow_error is not None:
                raise self.follow_error
            return
        self.closed = True
        self.reject_queued(SchedulerClosed(
            "scheduler closed before this session was admitted"))
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout_s)
        if self._channel is not None and not self._channel_closed:
            # Once only: a second close has no follower left to receive.
            self._channel_closed = True
            self._channel.send(None)

    def plan_counts(self) -> Optional[dict]:
        """On a mesh: this rank's role and the plans and device dispatches
        it sent (rank 0) or made (a follower); None on one device."""
        if self._channel is None:
            return None
        if self.follower:
            return {"role": "follower", **(self.follow_counts or {})}
        return {"role": "rank0", "plans": self._channel.sent,
                "dispatches": self._channel.dispatches}

    def _follow(self) -> None:
        """A follower rank's thread: rank 0's plans on this engine until
        rank 0 closes (engine/mesh_plan.follow)."""
        from .mesh_plan import follow
        self.follow_counts = {"plans": 0, "dispatches": 0, "errors": 0}
        try:
            follow(self.engine, self._channel, self.follow_counts)
        except Exception as e:  # noqa: BLE001 - raised again by close()
            self.follow_error = e
        finally:
            self.closed = True

    # ------------------------------------------------------------------
    # the scheduler loop
    # ------------------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                # A paused scheduler with only queued work sleeps: the
                # queue cannot be admitted until reopen_admission notifies.
                while (not self._active and not self._stop
                       and not self._idle_spill_due()
                       and (not self._queue or self._paused)):
                    self._cv.wait(timeout=0.25)
                    if self._queue and self._paused:
                        # Tick at the wait cadence anyway, so a queued
                        # request still dies at ITS timeout while the
                        # gate is closed.
                        break
                if self._stop and not self._active and not self._queue:
                    break
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 - the loop must survive
                if self._mesh_broken():
                    self._abort_on_desync()
                    continue
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
        self._prune_last_active()
        self._spill_idle_by_age()
        self._admit_queued()
        live = [r for r in self._active if not r.done and not r.pending]
        filling = [r for r in self._active if not r.done and r.pending]
        if filling:
            # While any row is still prefilling, segments are ragged mixed
            # dispatches: every live row decodes one token while the
            # filling rows' chunks ride the same dispatch.
            self._run_ragged_segment(live, filling)
        elif live:
            # With no fills pending and drafts available, one verify
            # dispatch advances every row by 1..spec_max_draft+1 tokens;
            # otherwise the plain segments serve.
            if not self._run_spec_segment(live):
                self._run_segment(live)
        self._flush_streams()
        self._retire_finished()
        self._check_request_health()

    def _mesh_broken(self) -> bool:
        return self._channel is not None and self._channel.broken is not None

    def _abort_on_desync(self) -> None:
        """The mesh's ranks left lockstep, and its engine can take no
        more calls: fail every active and queued request with MeshDesync,
        touching no engine state, and stop admitting. Loop thread only."""
        from ..core.errors import classify_error
        from .mesh_plan import MeshDesync
        err = MeshDesync(self._channel.broken)
        self.closed = True
        with self._cv:
            queued = list(self._queue)
            self._queue.clear()
            self._stop = True
        self._event("mesh_desync", error=str(err)[:200])
        for req in list(self._active_reqs) + queued:
            if req.on_commit is not None:
                self._stream_notify(req, {"type": "failed",
                                          "error": str(err)[:200],
                                          "kind": classify_error(err)})
            self._drop_request(req)
            req.error = err
            self._bump("failed")
            req.event.set()

    def _acquire_engine(self) -> None:
        if not self._lock_held:
            lock = self.engine._serve_lock
            lock.acquire()
            self._held_lock = lock
            self._lock_held = True

    def _release_engine(self) -> None:
        if self._lock_held:
            self._lock_held = False
            lock, self._held_lock = self._held_lock, None
            lock.release()

    # --- admission ---

    def _sweep_queue(self) -> None:
        """Fail expired/abandoned requests anywhere in the queue, not only
        at its head: a request stuck behind a non-fitting head still dies
        at its own deadline."""
        now = time.monotonic()
        expired: list[_Request] = []
        abandoned: list[_Request] = []
        with self._cv:
            keep: deque[_Request] = deque()
            for req in self._queue:
                if req.abandoned:
                    # A blocking waiter is gone: drop silently. A streaming
                    # submitter still needs the terminal event, or its
                    # stream never finishes.
                    if req.on_commit is not None:
                        abandoned.append(req)
                    continue
                if ((req.budget is not None and req.budget.expired)
                        or now - req.enqueued > req.timeout_s):
                    expired.append(req)
                else:
                    keep.append(req)
            self._queue = keep
        for req in abandoned:
            self._fail_request(req, TimeoutError(
                f"session {req.session!r} abandoned by its waiter "
                "while queued"))
        for req in expired:
            self._fail_request(req, TimeoutError(
                f"session {req.session!r} timed out in the admission "
                "queue before any capacity freed"))

    def _admit_queued(self) -> None:
        while True:
            with self._cv:
                if not self._queue or self._paused:
                    # Paused (supervisor quiesce / fleet drain): queued
                    # requests WAIT, never rejected here.
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
                if self._mesh_broken():
                    # The engine takes no more calls: the loop fails the
                    # request with every other (_abort_on_desync).
                    with self._cv:
                        self._queue.appendleft(req)
                    raise
                if self._requeue_on_exhaustion(req, e):
                    return
                # _prepare_batch may have acquired slots/pages before
                # raising; req.rows is still empty, so undo explicitly.
                self._release_request_slots(req)
                self._release_adapters(req)
                self._fail_request(req, e)
                # Engine-fatal triage runs on the admission path too: a
                # device_lost during the admission prefill must reach the
                # supervisor, not leave a sick engine serving the rest.
                if self._supervisor_intervened(e):
                    return

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
        telemetry.inc("roundtable_sched_requeues_total",
                      engine=self._tname)
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

    # --- host-RAM offload policy ---

    def _spillable_sessions(self, exclude: set[str]) -> list[str]:
        """Sessions whose slots sit idle in the pool: namespaced, not
        decoding, not queued, not excluded, and not the speculative draft
        slots' scope - least recently active first."""
        from .spec_decode import DRAFT_SCOPE
        busy = {session_of(r.name) for r in self._active}
        with self._cv:
            busy |= {r.session for r in self._queue}
        busy |= exclude
        busy.add(DRAFT_SCOPE)
        seen: dict[str, None] = {}
        for n in self.engine.kv.slot_names():
            s = session_of(n)
            if s and s not in busy:
                seen.setdefault(s)
        return sorted(seen, key=lambda s: self._last_active.get(s, 0.0))

    def _spill_sessions(self, sessions: list[str], reason: str,
                        want_pages: Optional[int] = None) -> int:
        tier = getattr(self.engine, "kv_offload", None)
        if tier is None:
            return 0
        kv = self.engine.kv
        spilled = 0
        for s in sessions:
            free0 = kv.free_pages()
            n = tier.spill_session(s)
            if n:
                spilled += 1
                with self._cv:
                    self._bump("spills")
                self._event("spill", session=s, reason=reason, slots=n,
                            pages_freed=kv.free_pages() - free0)
            if want_pages is not None and kv.free_pages() >= want_pages:
                break
        return spilled

    _LAST_ACTIVE_PRUNE_AT = 1024

    def _prune_last_active(self) -> None:
        """Bound the last-activity map: once it outgrows the threshold,
        drop the sessions that hold no pool slot and no spill record and
        are neither active nor queued."""
        if len(self._last_active) <= self._LAST_ACTIVE_PRUNE_AT:
            return
        keep = {session_of(n) for n in self.engine.kv.slot_names()}
        tier = getattr(self.engine, "kv_offload", None)
        if tier is not None:
            keep |= set(tier.spilled_sessions())
        keep |= {r.session for r in self._active_reqs}
        # Under the cv: submit() threads insert into this dict.
        with self._cv:
            keep |= {r.session for r in self._queue}
            for s in [s for s in self._last_active if s not in keep]:
                del self._last_active[s]

    def _idle_spill_due(self) -> bool:
        """True when the idle policy has work: the loop's idle wait wakes
        for it, or a quiet scheduler would never run the spill tick."""
        if (self.idle_spill_s is None
                or getattr(self.engine, "kv_offload", None) is None):
            return False
        now = time.monotonic()
        return any(now - self._last_active.get(s, now) >= self.idle_spill_s
                   for s in self._spillable_sessions(set()))

    def _spill_idle_by_age(self) -> None:
        """Proactive idle spill (idle_spill_s set): a session that has not
        submitted for idle_spill_s moves its pages to host RAM."""
        if (self.idle_spill_s is None
                or getattr(self.engine, "kv_offload", None) is None):
            return
        now = time.monotonic()
        idle = [s for s in self._spillable_sessions(set())
                if now - self._last_active.get(s, now) >= self.idle_spill_s]
        if not idle:
            return
        self._acquire_engine()
        try:
            self._spill_sessions(idle, reason="idle")
        finally:
            if not self._active:
                self._release_engine()

    def _spill_for_pressure(self, req: _Request) -> None:
        """Admission-time pressure valve: when the free pages cannot cover
        the request's new-page demand, spill idle sessions (least recently
        active first) before _prepare_batch runs, instead of letting the
        allocator's LRU eviction destroy their caches. The demand is new
        pages only: a session's next turn is mostly its own committed
        transcript, already paged in under its scoped slots."""
        engine = self.engine
        if (getattr(engine, "kv_offload", None) is None
                or engine.kv_layout != "paged"):
            return
        scoped = [scoped_slot(req.session, n) for n, _ in req.turns]
        need = (self._pages_needed(req.turns, req.max_new)
                - engine.kv.pages_held(scoped))
        if need <= engine.kv.free_pages():
            return
        self._spill_sessions(
            self._spillable_sessions(exclude={req.session}),
            reason="pressure", want_pages=need)

    def _start_request(self, req: _Request) -> None:
        """Admission: the engine's own pre-decode phase (_prepare_batch -
        one definition, so scheduled admission cannot drift from
        generate_batch on token parity), with every live row pinned
        against eviction. Loop thread only."""
        engine = self.engine
        # Admission starts the request's clock (queue time is bounded
        # separately in _sweep_queue).
        req.admitted_at = time.monotonic()
        if faults.ARMED and len(req.turns) > 1:
            # The engine's batched-path chaos point: a corrupt-KV fault
            # fails the fan-out before slot bookkeeping mutates.
            faults.maybe_inject("kv_corrupt")
        t0 = time.monotonic()
        stats = req.stats
        turn_budget = req.budget if req.budget is not None \
            else deadlines.Budget.root(req.timeout_s, rung="turn")
        deadline = min(turn_budget.deadline,
                       time.monotonic() + req.timeout_s)
        pre_budget = turn_budget.child("prefill")
        max_new, max_new_padded = clamp_max_new(req.max_new,
                                                engine.max_seq_len)
        self._spill_for_pressure(req)
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
        if getattr(engine, "spec_decode", False):
            # Per-row drafters: the n-gram corpus is the row's own prompt,
            # extended as output tokens commit. Device drafters keep their
            # state in the draft slots instead (a later hot swap to ngram
            # builds the index lazily in _spec_drafts).
            from .spec_decode import RowSpec
            kind = getattr(engine, "spec_drafter", None) or "ngram"
            for r in rows:
                r.spec = RowSpec(
                    list(r.tokens) if kind == "ngram" else None, kind=kind)
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
        self._bump("admitted")
        if deferred:
            self._bump("ragged_joins")
        if telemetry.ACTIVE:
            # The request's "turn" span: lives across segments (ended at
            # retire/fail), parented to the SUBMITTER's trace.
            req.tele = telemetry.start_span(
                "turn", parent=req.tele_ctx, session=req.session,
                engine=self._tname, rows=len(rows), scheduled=True,
                queue_wait_s=round(req.admitted_at - req.enqueued, 3))
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
        structure for a later CUDA-graph segment, and the decisions the
        JAX scheduler takes at segment exits (when a verify tick may
        start) stay the same.

        Because the seam blocks, a segment's device work happens inside
        its own dispatch call: its roofline sample is timed over that
        call and its read, not from the previous read (which in a
        pipelined run would hold two segments, then only a read)."""
        ctx = self._build_batch(live)
        t_prev = time.monotonic()
        try:
            handles = self._dispatch(ctx)
        except Exception as e:  # noqa: BLE001 - preempt-isolate ladder
            self._handle_segment_failure(live, e)
            return
        run_s = time.monotonic() - t_prev
        while True:
            next_ctx = next_handles = next_err = None
            next_run_s = 0.0
            if self._may_continue(ctx):
                next_ctx = self._advance(ctx, handles)
                t_next = time.monotonic()
                try:
                    next_handles = self._dispatch(next_ctx)
                except Exception as e:  # noqa: BLE001 - handled below
                    # Read the in-flight segment first so host state is
                    # consistent, then ladder the next one's failure.
                    next_err = e
                next_run_s = time.monotonic() - t_next
            alive = [r for r in ctx["rows"] if not r.done]
            counts = self._account_segment(alive)
            t_read = time.monotonic()
            try:
                # Scheduler-side "segment" span (sink-less: it spans
                # several sessions' traces, so it lands in the flight
                # recorder ring rather than any one session's JSONL).
                with telemetry.span("segment", engine=self._tname,
                                    rows=len(alive), scheduled=True):
                    steps = self._read_segment(ctx, handles)
            except Exception as e:  # noqa: BLE001 - preempt-isolate
                self._handle_segment_failure(alive, e)
                return
            now = time.monotonic()
            run_s += now - t_read
            # The run's wall, contiguous from one read to the next, goes
            # to the sessions: their sums cover the whole run.
            self._attribute_wall(counts, now - t_prev)
            # A while-loop segment is pure decode, counted into the same
            # split the ragged segments use.
            self._note_segment_tokens(0, steps * len(alive))
            # The segment's roofline sample: its decode rate over its own
            # dispatch and read against the engine's weight-streaming
            # ceiling.
            perf = getattr(self.engine, "perf", None)
            if perf is not None:
                perf.publish_decode_sample(
                    steps * len(alive), run_s,
                    lora_bytes_per_token=self._lora_bytes_per_token(alive))
            t_prev, run_s = now, next_run_s
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
        if self._stop or deadlines.DRAINING or self._channel is not None:
            # (On a mesh each segment is planned from host state.)
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
        if self._spec_drafts([r for r in ctx["rows"] if not r.done],
                             probe=True) is not None:
            # A verify tick is available: another whole segment would
            # decode past it at one token per forward, so exit and let
            # _tick run the speculative phase.
            return False
        for req in ctx["reqs"]:
            if req not in self._active_reqs or req.abandoned:
                return False
            if req.rows and all(r.done for r in req.rows):
                return False
            if req.turn_budget.token.cancelled or req.turn_budget.expired:
                return False
            if req.on_commit is not None:
                # A stream's tokens flush at the tick: the port's segment
                # seam returns only once its segment has run, so queueing
                # the next one first would hold this segment's tokens back
                # a whole segment and gain no overlap.
                return False
        return True

    # --- the ragged mixed segment ---

    def _note_segment_tokens(self, prefill: int, decode: int) -> None:
        """Per-phase token split of a consumed segment: the counters and
        their registry series move together."""
        if prefill:
            self.segment_prefill_tokens += prefill
            telemetry.inc("roundtable_segment_prefill_tokens_total",
                          prefill, engine=self._tname)
        if decode:
            self.segment_decode_tokens += decode
            telemetry.inc("roundtable_segment_decode_tokens_total",
                          decode, engine=self._tname)

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
            with telemetry.span("segment", engine=self._tname,
                                rows=len(seqs), scheduled=True,
                                ragged=True):
                handles = run_dispatch(
                    lambda: engine._ragged_dispatch(batch),
                    engine.retry, deadline, budget=seg_budget)
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
        telemetry.inc("roundtable_sched_ragged_segments_total",
                      engine=self._tname)
        self._note_segment_tokens(n_prefill, n_decode)
        occ = len(seqs)
        self.max_occupancy = max(self.max_occupancy, occ)
        with self._cv:
            self._occupancy.append(occ)
        telemetry.set_gauge("roundtable_sched_occupancy", occ,
                            engine=self._tname)
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
        perf = getattr(engine, "perf", None)
        if perf is not None:
            perf.publish_mixed_sample(
                n_prefill, n_decode, wall,
                lora_bytes_per_token=self._lora_bytes_per_token(
                    [r for _k, r, _t in rows_in]))
            for req in reqs:
                perf.publish_session_kv(
                    req.session, sum(r.valid for r in req.rows))

    def _handle_ragged_failure(self, live: list[_Row],
                               filling: list[_Row],
                               err: BaseException) -> None:
        """A ragged mixed dispatch failed: preempt. Requests with rows
        mid-prefill fail alone (their pages hold a half-written chunk; the
        adapter ladder re-prefills from the prompt), while decode-only
        sessions re-dispatch through the decode segment from intact host
        and KV state. An engine-fatal failure goes to the supervisor first.
        Loop thread only."""
        if self._supervisor_intervened(err):
            return
        self._bump("preemptions")
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

    # --- the speculative verify segment ---

    def _spec_drafts(self, live: list[_Row], probe: bool = False,
                     dispatch=None, read=None) -> Optional[dict]:
        """Per-row draft proposals for one verify dispatch: each row whose
        RowSpec should_draft (unthrottled, or throttled and re-probing)
        proposes up to `branch` candidate paths (chain: one), capped by
        its remaining budget (a verify commits up to depth+1 tokens, so a
        row with <= 1 remaining never drafts). The n-gram drafter proposes
        on the host per row; model/LoRA drafters batch every row through
        the engine's DeviceDrafter. Returns {id(row): [path, ...]}, or None
        when no row drafts: the tick then serves the plain segments.
        `probe` only asks whether some row drafts."""
        engine = self.engine
        if (not getattr(engine, "spec_decode", False)
                or not engine.ragged_enabled):
            return None
        if RAGGED_BLOCK_Q * len(live) > engine.ragged_tokens:
            return None  # the flat buffer cannot carry every live row
        tree = engine.spec_tree
        branch = engine.spec_branch if tree else 1
        depth = (min(tree["depth"], engine.spec_max_draft) if tree
                 else engine.spec_max_draft)
        dd = engine.spec_device_drafter

        def cap_of(r: _Row) -> int:
            if r.spec is None or not r.spec.should_draft(len(r.produced)):
                return 0
            return min(depth, r.max_new - len(r.produced) - 1)

        if dd is not None:
            from .spec_decode import DraftUnavailable
            if probe:
                # Eligibility alone answers the probe: a device drafter
                # proposes >= 1 token for an eligible row, and a probe
                # must cost no draft dispatch.
                return ({"__probe__": True}
                        if any(cap_of(r) >= 1 for r in live) else None)
            rows = []
            for r in live:
                c = cap_of(r)
                if c >= 1:
                    # The row's context cache grows by the newly committed
                    # tokens only.
                    cc = r.spec.ctx
                    if cc is None:
                        cc = r.spec.ctx = list(r.tokens)
                    need = len(r.tokens) + len(r.produced)
                    if len(cc) < need:
                        cc.extend(r.produced[len(cc) - len(r.tokens):])
                    rows.append((id(r), r.name, cc, c, branch))
            if not rows:
                return None
            pinned = tuple(r.name for r in self._active)
            try:
                proposals = dd.propose(engine, rows, pinned=pinned,
                                       dispatch=dispatch, read=read)
            except DraftUnavailable as e:
                # Slot or page pressure only: serve plain decode this tick
                # (never evict live rows to draft for them). Device
                # failures propagate to _run_spec_segment's ladder.
                self._event("spec_draft_unavailable", error=str(e)[:160])
                return None
            drafts = {id(r): proposals.get(id(r), []) for r in live}
            return drafts if any(drafts.values()) else None

        drafts: dict[int, list[list[int]]] = {}
        any_draft = False
        for r in live:
            paths: list[list[int]] = []
            cap = cap_of(r)
            if cap >= 1:
                if r.spec.drafter is None:
                    # Hot-swapped from a device drafter to ngram: build this
                    # row's index now.
                    from .spec_decode import NGramDrafter
                    r.spec.drafter = NGramDrafter(list(r.tokens))
                    r.spec.kind = "ngram"
                r.spec.drafter.sync_parts(r.tokens, r.produced)
                if branch > 1:
                    paths = r.spec.drafter.draft_paths(cap, branch)
                else:
                    d = r.spec.drafter.draft(cap)
                    paths = [d] if d else []
                if not paths and not probe:
                    # The drafter proposed nothing: a probing row waits a
                    # whole interval again (no-op for unthrottled rows).
                    r.spec.probe_failed(len(r.produced))
            drafts[id(r)] = paths
            if paths:
                any_draft = True
                if probe:
                    return drafts
        return drafts if any_draft else None

    def _run_spec_segment(self, live: list[_Row]) -> bool:
        """One speculative verify dispatch over the live rows: every
        speculating row packs its candidate paths as short multi-token runs
        of the flat buffer (draftless or throttled rows ride as 1-token
        runs), forward_ragged scores every draft position in one forward,
        and the host walks the accepted chain or tree path and commits it
        plus the correction/bonus token.

        Tree rows: path 0 (the main chain) writes through the row's own
        page table; each extra root branch becomes one more sequence whose
        table swaps the touched pages for pages loaned from the free list
        (take_free_pages - never evicting; a short free list degrades the
        row to the chain), the partly committed frontier page copied into
        the loan in the dispatch (copy_pairs) so every path's reads see the
        committed cells. When the walk ends on a non-trunk path its loaned
        pages hold the committed K/V: swap_in_page adopts them and the
        trunk's pages go back; every other loan returns untouched.

        Returns False without dispatching when no row drafts. A dispatch
        failure returns every loan and takes the ragged failure ladder
        (host state is untouched)."""
        engine = self.engine
        reqs = self._reqs_of(live)
        remaining = min((req.turn_budget.remaining() for req in reqs),
                        default=float("inf"))
        seg_budget = deadlines.Budget.root(
            None if remaining == float("inf") else remaining,
            rung="decode")
        deadline = min((req.deadline for req in reqs),
                       default=float("inf"))

        def draft_dispatch(b):
            # Draft dispatches ride the verify's watchdog/retry/budget
            # seams: a hang mid-propose hits the deadline ladder.
            return run_dispatch(lambda: engine._ragged_dispatch(b),
                                engine.retry, deadline, budget=seg_budget)

        def draft_read(h):
            from .spec_decode import to_host
            return host_sync(lambda: to_host(h), seg_budget, "decode")

        try:
            drafts_of = self._spec_drafts(live, dispatch=draft_dispatch,
                                          read=draft_read)
        except Exception as e:  # noqa: BLE001 - preempt-isolate ladder
            # A device failure while drafting is a decode failure.
            self._handle_ragged_failure(live, [], e)
            return True
        if drafts_of is None:
            return False

        kv = engine.kv
        ps = kv.page_size
        # Main runs first, then extra tree paths while the flat buffer, the
        # copy slots and the free list allow.
        seqs: list[RaggedSeq] = []
        entries: list[dict] = []
        copy_pairs: list[tuple[int, int]] = []
        blocks_budget = engine.ragged_tokens // RAGGED_BLOCK_Q
        copy_budget = engine.spec_copy_slots
        for r in live:
            paths = drafts_of.get(id(r)) or []
            main = list(paths[0]) if paths else []
            entries.append({"row": r, "used": ([main] if paths else []),
                            "rows_idx": [len(seqs)], "loans": []})
            seqs.append(RaggedSeq(
                [r.last] + main, r.valid, kv.table_for([r.name])[0],
                temperature=r.sampling.temperature,
                top_k=r.sampling.top_k, top_p=r.sampling.top_p,
                n_scores=len(main) + 1, adapter=r.adapter_slot))
        for e in entries:
            r = e["row"]
            paths = drafts_of.get(id(r)) or []
            if len(paths) <= 1:
                continue
            base_table = kv.table_for([r.name])[0]
            for p in paths[1:]:
                if len(seqs) >= blocks_budget or copy_budget <= 0:
                    break
                lo = r.valid // ps
                hi = (r.valid + len(p)) // ps
                loan = kv.take_free_pages(hi - lo + 1)
                if loan is None:
                    break  # free list short: this row degrades to chain
                ptable = np.array(base_table, copy=True)
                ptable[lo:hi + 1] = loan
                # Only the frontier page holds committed cells the path
                # reads; deeper pages start past `valid`.
                copy_pairs.append((int(base_table[lo]), loan[0]))
                copy_budget -= 1
                e["rows_idx"].append(len(seqs))
                e["loans"].append((lo, loan))
                e["used"].append(list(p))
                seqs.append(RaggedSeq(
                    [r.last] + list(p), r.valid, ptable,
                    temperature=r.sampling.temperature,
                    top_k=r.sampling.top_k, top_p=r.sampling.top_p,
                    n_scores=len(p) + 1, adapter=r.adapter_slot))

        def return_all_loans():
            for e in entries:
                for _lo, loan in e["loans"]:
                    kv.give_back_pages(loan)

        shape = ragged_pick_shape(
            engine.ragged_shapes,
            min(RAGGED_BLOCK_Q * len(seqs), engine.ragged_tokens))
        batch = build_ragged_batch(
            seqs, t_budget=shape, s_max=engine.spec_s_max,
            pages_per_seq=kv.pages_per_seq, scratch_page=SCRATCH_PAGE,
            pad_id=engine.tokenizer.pad_id, page_size=ps,
            score_width=engine.spec_max_draft + 1,
            copy_pairs=copy_pairs, copy_slots=engine.spec_copy_slots)

        t0 = time.monotonic()
        try:
            with telemetry.span("segment", engine=self._tname,
                                rows=len(seqs), scheduled=True, spec=True):
                handles = run_dispatch(
                    lambda: engine._ragged_dispatch(batch),
                    engine.retry, deadline, budget=seg_budget)
                nxt = host_sync(lambda: handles.cpu().numpy(), seg_budget,
                                "decode")
        except Exception as e:  # noqa: BLE001 - preempt-isolate ladder
            # Host state is untouched (the drafts go with the dispatch and
            # the loans back to the free list).
            return_all_loans()
            self._handle_ragged_failure(live, [], e)
            return True
        wall = time.monotonic() - t0

        from .spec_decode import accept_prefix, accept_tree, note_tree_row
        eos = engine.tokenizer.eos_id
        n_emit = lora_toks = 0
        drafted_tot = accepted_tot = 0
        tree_nodes_tot = tree_rows_tot = 0
        emits: dict[int, tuple[_Request, int]] = {}
        for e in entries:
            r = e["row"]
            used = e["used"]
            if len(used) <= 1:
                d = used[0] if used else []
                props = [int(x) for x in nxt[e["rows_idx"][0], :len(d) + 1]]
                emit, a = accept_prefix(d, props)
                winner = 0
                drafted_row = len(d)
            else:
                props_list = [[int(x) for x in nxt[si, :len(used[k]) + 1]]
                              for k, si in enumerate(e["rows_idx"])]
                emit, a, winner = accept_tree(used, props_list)
                drafted_row = sum(len(p) for p in used)
            # EOS inside an accepted prefix truncates as eos_trim does, and
            # the row's budget caps the rest.
            if eos in emit:
                emit = emit[:emit.index(eos) + 1]
            room = r.max_new - len(r.produced)
            if len(emit) > room:
                emit = emit[:room]
            r.produced.extend(emit)
            if emit:
                r.last = emit[-1]
            r.valid += len(emit)
            r.done = (r.last == eos) or len(r.produced) >= r.max_new
            if r.adapter_slot:
                lora_toks += len(emit)
            # Accepted = drafts actually committed (eos or budget
            # truncation can drop matched drafts).
            acc = min(a, len(emit))
            if e["loans"]:
                # The winner path's pages over the committed span adopt
                # into the row's table; everything else returns. Winner 0
                # is the trunk, whose writes went through the real table.
                for m, (lo, loan) in enumerate(e["loans"]):
                    if m == winner - 1:
                        keep_hi = (r.valid - 1) // ps
                        for k, j in enumerate(range(lo, lo + len(loan))):
                            if j <= keep_hi:
                                kv.swap_in_page(r.name, j, loan[k])
                            else:
                                kv.give_back_pages([loan[k]])
                    else:
                        kv.give_back_pages(loan)
            if len(used) > 1:
                tree_nodes_tot += drafted_row
                tree_rows_tot += 1
                note_tree_row(drafted_row, acc)
            req = self._row_req.get(id(r))
            if req is not None:
                prev = emits.get(id(req))
                emits[id(req)] = (req,
                                  (prev[1] if prev else 0) + len(emit))
                if drafted_row:
                    req.spec_drafted += drafted_row
                    req.spec_accepted += acc
            n_emit += len(emit)
            if drafted_row and r.spec is not None:
                drafted_tot += drafted_row
                accepted_tot += acc
                tripped = r.spec.note(drafted_row, acc)
                if r.spec.disabled:
                    # Throttled (now or still): restart the re-probe
                    # interval from the row's committed length.
                    r.spec.mark_idle(len(r.produced))
                telemetry.set_gauge(
                    "roundtable_spec_row_acceptance_rate",
                    round(r.spec.rate(), 4), engine=engine.cfg.name,
                    row=r.name)
                if tripped:
                    # The adaptive throttle tripped: this row decodes one
                    # token a forward (with periodic re-probes) from here.
                    engine.note_spec_throttle()
                    telemetry.recorder().record(
                        "spec_throttle", engine=self._tname,
                        session=req.session if req else "",
                        row=r.name, rate=round(r.spec.rate(), 3))
                    self._event("spec_throttle", row=r.name,
                                rate=round(r.spec.rate(), 3))
        engine.note_lora_tokens(lora_toks)
        engine.note_spec_dispatch(drafted_tot, accepted_tot, rows=len(live),
                                  tree_nodes=tree_nodes_tot,
                                  tree_rows=tree_rows_tot)

        self.spec_segments += 1
        telemetry.inc("roundtable_sched_spec_segments_total",
                      engine=self._tname)
        self._note_segment_tokens(0, n_emit)
        occ = len(seqs)
        self.max_occupancy = max(self.max_occupancy, occ)
        with self._cv:
            self._occupancy.append(occ)
        telemetry.set_gauge("roundtable_sched_occupancy", occ,
                            engine=self._tname)
        _note_rows(occ)
        sessions = len(reqs)
        for req, n in emits.values():
            req.stats.decode_seconds += wall * n / max(n_emit, 1)
        for req in reqs:
            req.seg_count += 1
            req.occ_sum += occ
            req.occ_max = max(req.occ_max, occ)
            req.sess_max = max(req.sess_max, sessions)
        perf = getattr(engine, "perf", None)
        if perf is not None:
            # The forward streamed the weights once for len(live) rows:
            # that is the roofline count; the accepted total is the rate a
            # user sees and publishes on its own.
            perf.publish_mixed_sample(
                0, n_emit, wall, decode_dispatch_tokens=len(live),
                lora_bytes_per_token=self._lora_bytes_per_token(live))
            for req in reqs:
                perf.publish_session_kv(
                    req.session, sum(r.valid for r in req.rows))
        return True

    def _lora_bytes_per_token(self, rows: list[_Row]):
        """This sample's mean adapter bytes streamed per decoded token (the
        exact persona mix of its rows); None on engines without a LoRA
        store (the perf model's default applies)."""
        store = getattr(self.engine, "lora", None)
        if store is None or not rows:
            return None
        n_ad = sum(1 for r in rows if r.adapter_slot)
        return store.streamed_bytes_per_token() * n_ad / len(rows)

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
        reuses. Loop-thread only (single-writer counter bumps need no
        cv)."""
        counts: dict[int, tuple[_Request, int]] = {}
        for r in alive:
            req = self._row_req.get(id(r))
            if req is None:
                continue
            prev = counts.get(id(req))
            counts[id(req)] = (req, (prev[1] + 1) if prev else 1)
        occ = len(alive)
        sessions = len(counts)
        self._bump("segments")
        self.max_occupancy = max(self.max_occupancy, occ)
        with self._cv:
            self._occupancy.append(occ)
        telemetry.set_gauge("roundtable_sched_occupancy", occ,
                            engine=self._tname)
        _note_rows(occ)
        perf = getattr(self.engine, "perf", None)
        for req, _n in counts.values():
            req.seg_count += 1
            req.occ_sum += occ
            req.occ_max = max(req.occ_max, occ)
            req.sess_max = max(req.sess_max, sessions)
            if perf is not None:
                # The memory ledger's session dimension: cached tokens
                # across the session's live rows, priced at KV bytes.
                perf.publish_session_kv(
                    req.session, sum(r.valid for r in req.rows))
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
        plan = engine._replica_plan([r.name for r in rows],
                                    bucket_group=True)
        if plan is not None:
            # Data replicas: each row in its replica's block, the block
            # padded to a power of two (JAX scheduler.py:2363-2375); a
            # contiguous pad row is slot -1 (it runs nowhere).
            if engine.kv_layout == "paged":
                index = plan.pad_table(
                    engine.kv.table_for([r.name for r in rows]),
                    engine.kv.scratch_page)
            else:
                index = np.asarray(plan.scatter_list(
                    [r.slot_id for r in rows], -1), np.int32)
            pad = 0
        elif engine.kv_layout == "paged":
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
        # Per-row adapter slots; pad rows take the base (zero) adapter,
        # their outputs are masked anyway.
        ids = [r.adapter_slot for r in rows] + [0] * pad
        if plan is not None:
            last = plan.scatter_list(last, eos)
            valid = plan.scatter_list(valid, 1)
            done0 = plan.scatter_list(done0, True)
            budgets = plan.scatter_list(budgets, 0)
            params = plan.scatter_list(params,
                                       SamplingParams(temperature=1.0))
            ids = plan.scatter_list(ids, 0)
        greedy = all(r.sampling.temperature <= 0.0 for r in rows)
        ctx = {"rows": rows, "reqs": reqs, "seg_budget": seg_budget,
               "deadline": deadline,
               "budgets_max": max(budgets) if budgets else 0,
               "pos": plan.pos if plan is not None else None}
        if self._channel is not None:
            # A mesh's segment travels as host inputs (_segment_from_host).
            ctx["host"] = {
                "index": np.asarray(index), "last": last, "valid": valid,
                "done": done0, "budgets": budgets, "greedy": greedy,
                "sampling": [(p.temperature, p.top_k, p.top_p)
                             for p in params],
                "lora": ids if engine.lora is not None else None}
            return ctx
        temps, top_ks, top_ps = sampling_arrays(params, dev)
        lora = engine._lora_args(ids)
        return {
            **ctx,
            "index": torch.as_tensor(index, device=dev),
            "last_d": engine._ints(last), "valid_d": engine._ints(valid),
            "done_d": torch.tensor(done0, device=dev),
            "budgets_d": engine._ints(budgets), "temps": temps,
            "top_ks": top_ks, "top_ps": top_ps, "greedy": greedy,
            "lora": lora,
        }

    def _dispatch(self, ctx: dict):
        """One segment for `ctx` through the engine's decode seam (the
        same commit_guard as generate_batch) and the run_dispatch
        retry/watchdog seam. Returns (out, steps, last, valid, done) with
        device tensors."""
        engine = self.engine
        if "host" in ctx:
            return run_dispatch(
                lambda: engine._segment_from_host(ctx["host"]),
                engine.retry, ctx["deadline"], budget=ctx["seg_budget"])
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
        pos = ctx["pos"]
        for j, r in enumerate(ctx["rows"]):
            # (a row's place in a replica-grouped batch)
            i = int(pos[j]) if pos is not None else j
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
        state. An engine-fatal failure goes to the supervisor first.
        Loop-thread only (single-writer counter bumps need no cv)."""
        if self._supervisor_intervened(err):
            return
        self._bump("preemptions")
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

    def _supervisor_intervened(self, err: BaseException) -> bool:
        """Engine-fatal triage BEFORE the dispatch ladder: device_lost
        failures, repeated hangs past the ladder and already-dead engines
        route to the EngineSupervisor, which tears the engine down,
        rebuilds it and restores the evacuated sessions - inline on this
        (the loop) thread. Returns True when the supervisor took over (the
        active requests were failed into their ladders); False lets the
        preempt ladder handle it."""
        if self._channel is not None:
            # The supervisor rebuilds one process's engine: a mesh's ranks
            # are not rebuilt together (item 7e-ii), so its failures take
            # the preempt ladder.
            return False
        try:
            from .supervisor import supervisor
            return supervisor().handle_dispatch_failure(self, err)
        except Exception as e:  # noqa: BLE001 - triage must not mask err
            self._event("supervisor_error", error=str(e)[:200])
            return False

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
            try:
                self.engine.kv.release(r.name)
            except Exception:  # noqa: BLE001 - the error wins
                pass
        if req.on_commit is not None:
            from ..core.errors import classify_error
            self._stream_notify(req, {
                "type": "failed", "error": str(err)[:200],
                "kind": classify_error(err)})
        self._drop_request(req)
        self._last_active[req.session] = time.monotonic()
        req.error = err
        self._bump("failed")
        perf = getattr(self.engine, "perf", None)
        if perf is not None:
            perf.publish_session_kv(req.session, 0)
        if req.tele is not None:
            req.tele.end(status=f"error:{type(err).__name__}")
            req.tele = None
        self._event("fail", session=req.session, error=str(err)[:200])
        req.event.set()

    def _drop_request(self, req: _Request) -> None:
        if req in self._active_reqs:
            self._active_reqs.remove(req)
        dd = getattr(self.engine, "spec_device_drafter", None)
        for r in req.rows:
            self._row_req.pop(id(r), None)
            if dd is not None:
                # The row's draft slot dies with it: its pages free, and a
                # later session reusing the name starts its drafter cold.
                dd.end_row(self.engine, r.name)
            if r.spec is not None and r.spec.drafted:
                # A retired row's gauge series goes with it.
                telemetry.remove_gauge(
                    "roundtable_spec_row_acceptance_rate",
                    engine=self.engine.cfg.name, row=r.name)
        self._active = [r for r in self._active if r not in req.rows]

    # --- committed-token streaming ---

    def _stream_notify(self, req: _Request, event: dict) -> None:
        """Deliver one stream event to req.on_commit, on the loop thread. A
        raising callback is disabled for the rest of the request (counted,
        with a `stream_error` event): a broken consumer costs its stream,
        never the batch."""
        cb = req.on_commit
        if cb is None:
            return
        try:
            cb(event)
        except Exception as e:  # noqa: BLE001 - consumer must not wedge serving
            req.on_commit = None
            telemetry.inc("roundtable_sched_stream_errors_total",
                          engine=self._tname)
            self._event("stream_error", session=req.session,
                        error=str(e)[:200])

    def _stream_flush(self, req: _Request) -> None:
        """Push each row's new committed tokens to the request's on_commit
        callback, eos-trimmed, so the stream never carries post-eos filler
        and equals the journal's `produced`. Host ints only."""
        if req.on_commit is None:
            return
        engine = self.engine
        eos = engine.tokenizer.eos_id
        max_new, _padded = clamp_max_new(req.max_new, engine.max_seq_len)
        for i, r in enumerate(req.rows):
            ids = eos_trim(list(r.produced), eos, max_new)
            if len(ids) <= r.streamed:
                continue
            new = ids[r.streamed:]
            # queue_wait_s rides every tokens event: the gateway's trace
            # carves the scheduler's queue wait out of its submit-to-first-
            # token lump.
            self._stream_notify(req, {
                "type": "tokens", "row": i, "knight": req.turns[i][0],
                "tokens": new, "done": r.done,
                "queue_wait_s": round(
                    (req.admitted_at or req.enqueued) - req.enqueued, 3)})
            if req.on_commit is None:
                return  # the callback died mid-flush
            r.streamed = len(ids)

    def _flush_streams(self) -> None:
        """Flush every streaming request's newly committed span. Called
        after every segment fold (ragged, speculative, each plain segment):
        a streamed token is always a committed one."""
        for req in list(self._active_reqs):
            if req.on_commit is not None:
                self._stream_flush(req)

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
                # sampled one) - the finalize_outputs contract. Persona
                # rows never feed the cross-session prefix cache: their
                # pages hold adapter-tinted K/V.
                fed = ids[:-1] if ids else []
                engine.kv.commit(r.name, r.tokens + fed,
                                 index=not r.adapter_slot)
                texts.append(engine.tokenizer.decode(ids))
            self._release_adapters(req)
            if self._journal is not None:
                # Durable commit point: the round's results are about to
                # be handed back - journal them fsynced FIRST, so the
                # record on disk never claims less than the submitter saw.
                self._journal_retired(req, eos, max_new)
            req.stats.int4_paths = engine.int4_path_report()
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
            if req.spec_drafted:
                req.stats.sched["spec"] = {
                    "drafted": req.spec_drafted,
                    "accepted": req.spec_accepted,
                    "acceptance_rate": round(
                        req.spec_accepted / req.spec_drafted, 3),
                }
            if req.adapters and any(a is not None for a in req.adapters):
                # Which persona served each knight of the round.
                req.stats.sched["lora_adapters"] = list(req.adapters)
            if req.on_commit is not None:
                # The journal record is fsynced above, so "retired" tells
                # the stream the turn is durable.
                self._stream_flush(req)
                self._stream_notify(req, {"type": "retired"})
            self._drop_request(req)
            self._last_active[req.session] = time.monotonic()
            req.result = (texts, req.stats)
            self._bump("completed")
            if req.tele is not None:
                req.tele.set_attr("decode_tokens", req.stats.decode_tokens)
                req.tele.set_attr("occupancy_max", req.occ_max)
                req.tele.end()
                req.tele = None
            perf = getattr(engine, "perf", None)
            trace_hooks.publish_gen_stats(req.stats, self._tname, perf=perf)
            if perf is not None:
                # A retired session's KV series reads empty, not stale.
                perf.publish_session_kv(req.session, 0)
            trace_hooks.publish_memory_ledger(engine)
            self._event("retire", session=req.session,
                        decode_tokens=req.stats.decode_tokens,
                        occupancy_max=req.occ_max)
            req.event.set()

    def _journal_retired(self, req: _Request, eos: int,
                         max_new: int) -> None:
        """Append this retired round's committed-turn record to the session
        journal. Guarded end to end: a journal failure costs durability,
        never availability (record_turn itself degrades OSErrors to a
        counter)."""
        try:
            ads = req.adapters or [None] * len(req.rows)
            rows = []
            for (knight, prompt), r, adapter in zip(req.turns, req.rows,
                                                    ads):
                rows.append({
                    "knight": knight,
                    "prompt": prompt,
                    "prompt_tokens": list(r.tokens),
                    "produced": eos_trim(list(r.produced), eos, max_new),
                    "adapter": adapter,
                })
            rec = self._journal.record_turn(req.session, rows,
                                            engine=self._tname,
                                            replica=self.replica)
            if rec is not None:
                self.journal_turns += 1
            elif not self._journal.suspended(req.session):
                # record_turn degraded an OSError to None (a suspended
                # replay also returns None, but that is no error).
                self.journal_errors += 1
        except Exception as e:  # noqa: BLE001 - durability < availability
            self.journal_errors += 1
            self._event("journal_error", session=req.session,
                        error=str(e)[:200])

    # --- per-request health (budgets / cancellation / abandonment) ---

    def _check_request_health(self) -> None:
        forced = self._force_fail
        if forced is not None:
            # force_fail_active's mailbox: every active request fails with
            # it HERE, on the loop thread (request state is single-writer).
            self._force_fail = None
            for req in list(self._active_reqs):
                self._fail_request(req, forced)
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
