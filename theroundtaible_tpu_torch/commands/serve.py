"""`roundtable serve` — K concurrent discussions on one shared engine
(counterpart of theroundtaible_tpu/commands/serve.py).

The discuss command serves exactly one session; this command drives MANY:
each topic gets its own discussion thread with its own session directory,
metrics file and adapter instances, while every torch-llm adapter routes
its rounds through the per-engine continuous-batching SessionScheduler
(engine/scheduler.py) — so the sessions' decode work genuinely
interleaves on the shared engine, a session arriving while another
decodes joining it through ragged dispatches, instead of serializing
behind one serve lock.

Programmatic surface: `serve_discussions(topics, config, project_root)`
returns per-session results plus each scheduler's decision provenance.
`--journal DIR` fsyncs every committed turn (engine/session_journal.py);
`--resume DIR` replays a crashed process's journal onto a fresh engine
(engine/recovery.py) and keeps journaling into the same directory.
`--replicas N>1` serves the sessions on N engines behind a session router
(router/core.py): each session is placed on one replica by affinity and
load score, and every replica's scheduler shares the one journal.

On a mesh (knights whose engine config has a `mesh`), every rank runs the
same `roundtable serve` under torchrun or the ROUNDTABLE_* variables
(engine/distributed.py): rank 0 runs the sessions and writes
`.roundtable/` and the journal; every other rank builds the same engine,
follows rank 0's scheduler plans (engine/mesh_plan.py) and writes nothing.
A pipe mesh's PPEngine has no scheduler (as in the JAX package): its
sessions are namespaced generate_batch calls, which rank 0 broadcasts as
plans (with each slot release) and the other ranks make in the same order
(PPEngine.lead / follow_plans). A router over a mesh engine (`--replicas
N>1` there) is not served.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Optional

from ..adapters.factory import initialize_adapters
from ..core.config import load_config
from ..core.errors import ConfigError
from ..core.orchestrator import run_discussion
from ..utils.ui import style


def _dedupe_topics(topics: list[str]) -> list[str]:
    """Session dirs are named date-HHMM-slug(topic): concurrent sessions
    whose topics slug identically would share (and corrupt) one session
    directory. Duplicates get a "(session N)" PREFIX — slugify truncates
    at 50 chars, so a suffix on any sentence-length topic would land
    past the cut and the slugs would still collide."""
    from ..utils.session import slugify
    seen: set = set()
    out = []
    for t in topics:
        cand, n = t, 1
        while slugify(cand) in seen:
            n += 1
            cand = f"(session {n}) {t}"
        seen.add(slugify(cand))
        out.append(cand)
    return out


def _attach_schedulers(adapters: dict, session_id: str,
                       admit_hold_s: float,
                       journal=None, router=None,
                       led: Optional[list] = None) -> tuple[list, list]:
    """Bind every torch-llm adapter in this session's seat map to its
    session id and to the SHARED per-engine scheduler (acquire_scheduler:
    one scheduler per resident engine, however many sessions share it) -
    or, under a session router, to the scheduler of the replica the
    router placed this session on (affinity and load score).
    Returns (schedulers touched, schedulers CREATED here) — the caller
    must only close the latter: a scheduler that pre-existed this serve
    call belongs to someone else's sessions too, and closing it would
    kill their in-flight rounds with SchedulerClosed. A pipe-mesh engine
    (no scheduler) leads its mesh's plans from here on and is appended to
    `led`."""
    scheds, owned = [], []
    for adapter in adapters.values():
        attach = getattr(adapter, "attach_scheduler", None)
        if attach is None:
            continue
        if router is not None:
            # The router owns the replicas' schedulers; the adapter's own
            # engine handle is only a tokenizer and config source.
            sched = router.scheduler_for(session_id)
            attach(sched, session=session_id)
            if sched not in scheds:
                scheds.append(sched)
            continue
        try:
            engine = adapter._get_engine()
        except Exception:  # noqa: BLE001 — seat probes already warned
            # The engine may still come up later (execute_round retries
            # construction on the breaker's probe) — the session
            # NAMESPACE must be bound regardless, or two sessions'
            # same-named knights would collide on the recovered engine.
            adapter.session = session_id
            continue
        # On a mesh this is rank 0's scheduler: the other ranks follow it.
        from ..engine.scheduler import acquire_scheduler
        try:
            sched, created = acquire_scheduler(engine,
                                               admit_hold_s=admit_hold_s)
        except TypeError:
            # A PPEngine has no segment seam to schedule at: its sessions
            # keep their namespace (adapter.session) and serve round-level
            # batches, planned for the pipe mesh's other ranks.
            adapter.session = session_id
            if hasattr(engine, "lead"):
                engine.lead()
                if led is not None and engine not in led:
                    led.append(engine)
            continue
        if journal is not None and sched.journal is not journal:
            # One journal per serve root, shared by every scheduler:
            # committed turns fsync at retire so `serve --resume` survives
            # a kill -9. A different already-attached journal is REPLACED
            # (`--resume DIR1 --journal DIR2` journals new turns in DIR2).
            sched.attach_journal(journal)
        attach(sched, session=session_id)
        if sched not in scheds:
            scheds.append(sched)
        if created and sched not in owned:
            owned.append(sched)
    return scheds, owned


def serve_discussions(
    topics: list[str],
    config,
    project_root: str,
    *,
    read_source_code: bool = False,
    admit_hold_s: float = 0.25,
    journal_dir: Optional[str] = None,
    replicas: int = 1,
    device="cuda",
) -> dict[str, Any]:
    """Run one discussion per topic, all concurrently, on shared engines
    on `device` (the card unless the caller asks for the CPU).

    Each session gets its OWN adapter instances (adapter state —
    last_stats, degradation markers, the fallback cache — is per
    session) seated from the same config; the engine cache underneath
    dedups the resident models, and acquire_scheduler dedups the
    scheduler per engine, so N sessions share one model + one continuous
    batch.

    Returns {"sessions": [{topic, session_id, ok, result|error,
    wall_s, session_path}], "schedulers": [describe()...],
    "wall_s": total}.
    """
    topics = _dedupe_topics(list(topics))
    journal = None
    if journal_dir is not None:
        from ..engine.session_journal import SessionJournal
        journal = SessionJournal(journal_dir)
    router = None
    if replicas > 1:
        # One engine per replica behind a session router. `--replicas 1`
        # (and every caller that does not pass it) takes the single-engine
        # path below unchanged.
        from ..router import SessionRouter, build_replicas, \
            set_active_router
        engine = None
        for adapter in initialize_adapters(config, device=device).values():
            if hasattr(adapter, "attach_scheduler"):
                try:
                    engine = adapter._get_engine()
                    break
                except Exception:  # noqa: BLE001 — try the next seat
                    continue
        if engine is None:
            raise ConfigError(
                "--replicas needs at least one torch-llm knight whose "
                "engine can be built")
        if getattr(engine, "mesh", None) is not None:
            from ..core.errors import ITEM_7E_II, not_ported
            raise not_ported("a session router over a mesh engine "
                             "(--replicas with a mesh)", ITEM_7E_II)
        reps = build_replicas(engine, replicas, journal=journal,
                              admit_hold_s=admit_hold_s)
        router = SessionRouter(reps, journal=journal)
        set_active_router(router)
    all_scheds: list = []
    owned_scheds: list = []
    led_engines: list = []
    # Session ids carry a per-CALL unique component: two concurrent
    # serve_discussions calls share the resident engine (by design), so
    # plain "s0"/"s1" ids would merge unrelated discussions into one
    # KV isolation domain.
    import uuid
    call_tag = uuid.uuid4().hex[:6]
    session_entries: list[dict[str, Any]] = [
        {"topic": t, "session_id": f"{call_tag}-s{i}"}
        for i, t in enumerate(topics)]
    threads = []
    t0 = time.monotonic()

    def run_one(entry: dict[str, Any]) -> None:
        ts = time.monotonic()
        try:
            adapters = initialize_adapters(config, device=device)
            if not adapters:
                raise ConfigError(
                    "A roundtable with no knights is just a table.")
            # Plain appends from session threads; deduped by identity
            # when the report is built.
            scheds, owned = _attach_schedulers(
                adapters, entry["session_id"], admit_hold_s,
                journal=journal, router=router, led=led_engines)
            all_scheds.extend(scheds)
            owned_scheds.extend(owned)
            result = run_discussion(
                entry["topic"], config, adapters, project_root,
                read_source_code=read_source_code)
            entry["ok"] = True
            entry["result"] = result
            entry["session_path"] = result.session_path
        except Exception as e:  # noqa: BLE001 — per-session containment
            entry["ok"] = False
            entry["error"] = e
        entry["wall_s"] = round(time.monotonic() - ts, 3)

    for entry in session_entries:
        th = threading.Thread(target=run_one, args=(entry,),
                              name=f"serve-{entry['session_id']}",
                              daemon=True)
        threads.append(th)
        th.start()
    for th in threads:
        th.join()
    uniq = list({id(s): s for s in all_scheds}.values())
    report = {
        "sessions": session_entries,
        "schedulers": [s.describe() for s in uniq],
        "wall_s": round(time.monotonic() - t0, 3),
    }
    if router is not None:
        report["router"] = router.describe()
    # Only schedulers CREATED by this call — a pre-existing one is
    # shared with sessions outside this call and must keep running.
    for s in {id(s): s for s in owned_scheds}.values():
        s.close()
    for engine in {id(e): e for e in led_engines}.values():
        # the pipe mesh's followers leave with the channel
        engine.close_plans()
    if router is not None:
        router.close()
        for rep in router.replicas:
            if getattr(rep, "owned_scheduler", False):
                rep.scheduler.close()
    return report


# The library seam of crash recovery, re-exported so `serve --resume` runs
# exactly what an embedding caller runs.
from ..engine.recovery import resume_from_journal  # noqa: E402,F401


def serve_command(topics: list[str], sessions: Optional[int] = None,
                  read_code: Optional[bool] = None,
                  project_root: Optional[str] = None,
                  journal_dir: Optional[str] = None,
                  resume_dir: Optional[str] = None,
                  replicas: int = 1, device="cuda") -> int:
    """CLI: `roundtable serve "topic" --sessions 4` (one topic fanned
    into K concurrent discussions), `roundtable serve "t1" "t2" "t3"`
    (one discussion each), `--journal DIR` for crash-durable turn
    records, `--resume DIR` to replay a crashed process's journal."""
    project_root = project_root or os.getcwd()
    config = load_config(project_root)
    if not topics and not resume_dir:
        raise ConfigError(
            "serve needs topics to discuss (or --resume DIR)")
    from ..engine.mesh_plan import follow_config, follower_process
    if follower_process():
        # A rank > 0 of a mesh: rank 0 serves; this rank follows its plans
        # on its own engine and writes nothing.
        counts = follow_config(config, device)
        print(style.dim(f"  followed rank 0's plans: {counts}"))
        return 0
    if resume_dir:
        print(style.bold(f"\n  Resuming sessions from journal "
                         f"{resume_dir}..."))
        r = resume_from_journal(resume_dir, config=config,
                                project_root=project_root, device=device)
        print(style.dim(
            f"  replayed {r['turns']} committed turn(s) across "
            f"{r['sessions']} session(s) — KV restored at the last "
            "committed turn"))
        # A resumed serve keeps journaling into the same directory unless
        # the operator pointed --journal elsewhere.
        journal_dir = journal_dir or resume_dir
        if not topics:
            # Nothing to serve: the replay VALIDATED the journal (every
            # committed turn re-prefilled cleanly), but the restored KV
            # lives only in this process - continuing the work needs
            # topics in the same invocation.
            from ..engine.session_journal import SessionJournal
            j = SessionJournal(resume_dir)
            for session in j.sessions():
                last = j.last_turn(session)
                print(style.dim(
                    f"    {session}: resumed at committed turn {last}"))
            print(style.dim(
                "\n  journal validated — no topics given, so this "
                "process exits. To continue serving after a crash, "
                "pass the next topics in the same invocation:\n"
                "    roundtable serve --resume DIR \"next topic\"\n"))
            return 0
    if sessions and len(topics) == 1:
        topics = topics * sessions
    elif sessions and len(topics) != sessions:
        raise ConfigError(
            f"--sessions {sessions} with {len(topics)} topics — give ONE "
            "topic to replicate, or one topic per session")

    print(style.bold(f"\n  Serving {len(topics)} concurrent "
                     "discussion(s) on the shared fleet...\n"))
    report = serve_discussions(topics, config, project_root,
                               read_source_code=bool(read_code),
                               journal_dir=journal_dir,
                               replicas=replicas, device=device)

    failed = 0
    for entry in report["sessions"]:
        if entry.get("ok"):
            r = entry["result"]
            verdict = ("consensus" if r.consensus
                       and not r.unanimous_rejection
                       else "rejection" if r.consensus else "escalated")
            print(f"  {style.green(entry['session_id'])} "
                  f"{verdict} in {r.rounds} round(s), "
                  f"{entry['wall_s']:.1f}s — {entry['session_path']}")
        else:
            failed += 1
            print(f"  {style.red(entry['session_id'])} failed: "
                  f"{entry.get('error')}")
    for sched in report["schedulers"]:
        print(style.dim(
            f"\n  scheduler: admitted {sched['admitted']}, "
            f"completed {sched['completed']}, "
            f"max occupancy {sched['max_occupancy']} rows, "
            f"mean {sched['occupancy_mean']} over "
            f"{sched['segments']} segment(s), "
            f"queue peak {sched['queued_peak']}"))
    if report.get("router"):
        rt = report["router"]
        print(style.dim(
            f"  router: {len(rt['replicas'])} replica(s), "
            f"{rt['sessions']} session(s) placed, "
            f"{rt['migrations']} migration(s), "
            f"{rt['failovers']} failover(s)"))
    print(style.dim(f"  total wall: {report['wall_s']:.1f}s\n"))
    return 1 if failed else 0
