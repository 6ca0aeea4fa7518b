"""Rank 0's plans for the other ranks of a mesh: how one SessionScheduler
serves an engine that spans several processes.

The JAX package runs one controller, so its scheduler needs no broadcast.
The port runs one process per rank, every rank's engine taking the same
calls in the same order (the forward's collectives and the cross-replica
page copies meet only then). So on a mesh the scheduler runs on rank 0
alone - it owns admission, the clock (admit_hold_s, deadlines, idle
spills), fault injection and every decision - and reaches its engine
through `PlanEngine`: each call that changes engine state (an admission's
prefill, a decode segment from host inputs, a ragged dispatch, a slot
release or commit, a spill, an adapter's residency) is first broadcast
over the mesh's gloo `plan_group`, then run. The other ranks run
`follow`: they receive each plan and make the same call on their own
engine. Rank 0's plan is the only source of truth: an engine's host
bookkeeping and its sampled tokens depend only on the calls it gets, and
an exception a plan raises on rank 0 raises the same way on every
follower.

A plan is (target, method, args, kwargs): target "engine", "kv",
"kv_offload" or "lora". `None` closes the channel; `PING` keeps a
follower's wait for the next plan inside the plan group's timeout while
rank 0 idles.

Every rank makes a planned call whole. Inside one (`inside_plan`), a
dispatch runs bare on every rank: no fault is injected, no watchdog
abandons it and no retry repeats it, and an admission's prefill carries
no deadline or budget (rank 0 checks its budget before the plan and
enforces its deadline and cancellation at the next boundary, the
scheduler's health check). Whatever could make one rank leave a call
early - the clock, a client's cancellation, an injected fault - is decided
by rank 0 between plans, so no rank ever waits in a collective the others
left. After each call the ranks exchange its outcome and a digest of the
pool's bookkeeping; a difference is a `MeshDesync` on every rank, and the
channel stays broken.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from typing import Any, Callable, Optional

# The state-changing calls of each engine part the scheduler makes. The
# engine's are its device dispatches (the followers' dispatch count).
DISPATCHES = frozenset({"_prepare_batch", "_ragged_dispatch",
                        "_segment_from_host", "_generate_planned"})
_PARTS = {"kv": frozenset({"ensure_capacity", "alias_span", "commit",
                           "release", "take_free_pages", "give_back_pages",
                           "swap_in_page", "scratch_slot"}),
          "kv_offload": frozenset({"spill_session"}),
          "lora": frozenset({"acquire", "release"})}

# The plan group's timeout (sharding.build_mesh): the longest a rank waits
# in one of its collectives. Rank 0 sends PING after KEEPALIVE_S without a
# plan, so a follower waiting for the next plan never comes near it.
PLAN_TIMEOUT_S = 600.0
KEEPALIVE_S = 30.0
PING = ("ping",)

_local = threading.local()


class MeshDesync(RuntimeError):
    """The ranks of a mesh left lockstep: a planned call's outcome, or the
    pool's bookkeeping after it, differs between ranks."""


def inside_plan() -> bool:
    """Whether this thread is making a planned call (every rank makes it
    whole: serving_loop.run_dispatch and faults.maybe_inject read this)."""
    return getattr(_local, "depth", 0) > 0


@contextlib.contextmanager
def lockstep():
    """The context of a call every rank makes whole: a planned call, or a
    pipeline engine's generate (engine/pp_serving.py), whose own
    collectives carry rank 0's decisions. Dispatches inside run bare."""
    from . import deadlines
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        with deadlines.unwatched():
            yield
    finally:
        _local.depth -= 1


def kv_digest(kv) -> str:
    """A digest of the pool's host bookkeeping: each slot's tokens count,
    replica and pages, the per-replica free lists and the page refs. Equal
    on every rank while the ranks are in lockstep."""
    slots = sorted((name, len(s.tokens), getattr(s, "replica", 0),
                    tuple(getattr(s, "pages", ())))
                   for name, s in getattr(kv, "_slots", {}).items())
    free = [len(f) for f in getattr(kv, "_free_by_replica", ())]
    refs = sorted(getattr(kv, "_refs", {}).items())
    return hashlib.blake2b(repr((slots, free, refs)).encode(),
                           digest_size=8).hexdigest()


class PlanChannel:
    """Broadcasts rank 0's plans over the mesh's plan group, in order, and
    settles each planned call's outcome across the ranks."""

    def __init__(self, mesh, digest: Callable[[], str] = lambda: ""):
        import torch.distributed as dist
        self._dist = dist
        self.group = mesh.plan_group
        self.rank = dist.get_rank()
        self.world = dist.get_world_size(self.group)
        self._digest = digest
        # Held from a plan's broadcast to the end of its call on rank 0,
        # so rank 0 makes its calls in the order the followers get them,
        # whichever thread makes one.
        self._lock = threading.RLock()
        self.sent = 0
        self.dispatches = 0
        # Why the ranks left lockstep (MeshDesync), once they have.
        self.broken: Optional[str] = None
        self._last_send = time.monotonic()
        self._closed = threading.Event()
        if self.rank == 0:
            threading.Thread(target=self._keepalive, daemon=True,
                             name="plan-keepalive").start()

    def send(self, plan) -> None:
        with self._lock:
            if self.broken is not None:
                if plan is None:
                    return  # the followers left at the desync
                raise MeshDesync(self.broken)
            self._dist.broadcast_object_list([plan], src=0,
                                             group=self.group)
            self._last_send = time.monotonic()
            if plan is None:
                self._closed.set()
            elif plan != PING:
                self.sent += 1
                self.dispatches += plan[1] in DISPATCHES

    def call(self, plan, fn: Callable):
        """Broadcast `plan`, make rank 0's own call `fn(*args, **kwargs)`
        with the plan's arguments, and settle its outcome."""
        _target, _attr, args, kwargs = plan
        with self._lock:
            self.send(plan)
            with lockstep():
                try:
                    out = fn(*args, **kwargs)
                except Exception as e:
                    self.settle(type(e).__name__)
                    raise
            self.settle(None)
            return out

    def settle(self, outcome: Optional[str]) -> None:
        """Every rank's outcome of the call just made (None or the
        exception's type) and pool digest, gathered on every rank; any
        difference breaks the channel with MeshDesync."""
        mine = (outcome, self._digest())
        seen: list[Any] = [None] * self.world
        self._dist.all_gather_object(seen, mine, group=self.group)
        if any(s != seen[0] for s in seen):
            self.broken = ("the mesh's ranks left lockstep: (outcome, "
                           f"pool digest) per rank {seen}")
            raise MeshDesync(self.broken)

    def recv(self):
        box: list[Any] = [None]
        self._dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def _keepalive(self) -> None:
        while not self._closed.wait(KEEPALIVE_S / 4):
            if time.monotonic() - self._last_send < KEEPALIVE_S:
                continue
            if not self._lock.acquire(blocking=False):
                continue  # a call is in flight: the followers are in it
            try:
                if self._closed.is_set() or self.broken is not None:
                    return
                self.send(PING)
            except Exception:  # noqa: BLE001 - the next plan reports it
                return
            finally:
                self._lock.release()


class _PlanPart:
    """One engine part (pool, offload tier, LoRA store) whose
    state-changing calls are broadcast before they run; reads pass
    through."""

    def __init__(self, name: str, target, channel: PlanChannel):
        self._name = name
        self._target = target
        self._channel = channel

    def __getattr__(self, attr):
        value = getattr(self._target, attr)
        if attr not in _PARTS[self._name]:
            return value

        def planned(*args, **kwargs):
            return self._channel.call((self._name, attr, args, kwargs),
                                      value)
        return planned


class PlanEngine:
    """Rank 0's view of a mesh engine for its scheduler: every attribute
    of the engine, with the state-changing calls of the engine and its
    parts broadcast first."""

    def __init__(self, engine, channel: PlanChannel):
        self._engine = engine
        self._channel = channel

    def __getattr__(self, attr):
        value = getattr(self._engine, attr)
        if attr in _PARTS and value is not None:
            return _PlanPart(attr, value, self._channel)
        if attr not in DISPATCHES:
            return value

        def planned(*args, **kwargs):
            if attr == "_prepare_batch" and args[3] is not None:
                args[3].check()  # the prefill's budget, at the boundary
            return self._channel.call(
                ("engine", attr, *_portable(attr, args, kwargs)), value)
        return planned

    def __setattr__(self, attr, value):
        if attr in ("_engine", "_channel"):
            object.__setattr__(self, attr, value)
        else:
            setattr(self._engine, attr, value)


def _portable(attr: str, args: tuple, kwargs: dict) -> tuple:
    """The plan's copy of a call's arguments, which every rank makes: an
    admission's prefill runs with no deadline and no budget (rank 0
    enforces both between plans)."""
    if attr == "_prepare_batch":
        args = list(args)
        args[2], args[3] = float("inf"), None
        return tuple(args), dict(kwargs)
    return args, kwargs


def follow(engine, channel: PlanChannel, counts: dict) -> dict:
    """A follower rank's loop: make each of rank 0's plans on `engine`
    until the channel closes, settling each call's outcome with rank 0's
    (a call that raises here raised on rank 0 too; it is counted and the
    loop goes on). Raises MeshDesync when the ranks left lockstep. Counts
    into `counts` ("plans", "dispatches", "errors") and returns it."""
    parts = {"engine": engine, "kv": engine.kv,
             "kv_offload": getattr(engine, "kv_offload", None),
             "lora": getattr(engine, "lora", None)}
    while True:
        plan = channel.recv()
        if plan is None:
            break
        if plan == PING:
            continue
        target, attr, args, kwargs = plan
        counts["plans"] += 1
        if attr in DISPATCHES:
            counts["dispatches"] += 1
        outcome = None
        try:
            with engine._serve_lock, lockstep():
                getattr(parts[target], attr)(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - settled with rank 0's
            outcome = type(e).__name__
            counts["errors"] += 1
        channel.settle(outcome)
    return counts


def follower_process() -> bool:
    """Whether this process is a rank > 0 of the group its environment
    describes (torchrun or the ROUNDTABLE_* variables): under `roundtable
    serve` / `gateway` on a mesh such a rank follows rank 0."""
    from .distributed import _group_env
    found = _group_env()
    return found is not None and found[2] > 0


def follow_config(config, device="cuda") -> list[dict]:
    """A follower rank's `serve` / `gateway`: seat the config's knights as
    rank 0 does, build each torch-llm seat's engine (the same engines, in
    the same order, so their collectives meet), follow each engine's
    scheduler - or, for a pipe mesh's PPEngine, which has none, its
    planned calls (PPEngine.follow_plans) - until rank 0 closes it, and
    write nothing. Returns each engine's plan counts."""
    from ..adapters.factory import initialize_adapters
    from .scheduler import scheduler_for
    engines: list = []
    for adapter in initialize_adapters(config, device=device).values():
        if hasattr(adapter, "attach_scheduler"):
            engine = adapter._get_engine()
            if all(e is not engine for e in engines):
                engines.append(engine)
    counts: list = [None] * len(engines)
    errors: list = []

    def follow_pp(i, engine):
        try:
            counts[i] = engine.follow_plans()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads, scheds = [], {}
    for i, engine in enumerate(engines):
        if hasattr(engine, "follow_plans"):
            th = threading.Thread(target=follow_pp, args=(i, engine),
                                  daemon=True, name=f"pp-follow-{i}")
            th.start()
            threads.append(th)
        else:
            scheds[i] = scheduler_for(engine)
    for sched in scheds.values():
        sched.close(timeout_s=None)
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    for i, sched in scheds.items():
        counts[i] = sched.plan_counts()
    return counts
