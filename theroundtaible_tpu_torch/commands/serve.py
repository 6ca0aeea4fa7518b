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
The JAX command's session journal (`--journal`, `--resume`) and replica
router (`--replicas N>1`) are not ported: each raises NotImplementedError
naming its ROADMAP item before any engine is built.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Optional

from ..adapters.factory import initialize_adapters
from ..core.config import load_config
from ..core.errors import ITEM_7C, ITEM_7D, ConfigError, not_ported
from ..core.orchestrator import run_discussion
from ..utils.ui import style


def _check_ported(journal_dir: Optional[str], resume_dir: Optional[str],
                  replicas: int) -> None:
    """Refuse the options whose machinery the port lacks, before any
    engine is built: nothing serves without an option it was asked for."""
    if journal_dir is not None:
        raise not_ported("`serve --journal` (the session journal)", ITEM_7C)
    if resume_dir is not None:
        raise not_ported("`serve --resume` (engine recovery)", ITEM_7C)
    if replicas > 1:
        raise not_ported("`serve --replicas N` (the session router)",
                         ITEM_7D)


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
                       admit_hold_s: float) -> tuple[list, list]:
    """Bind every torch-llm adapter in this session's seat map to its
    session id and to the SHARED per-engine scheduler (acquire_scheduler:
    one scheduler per resident engine, however many sessions share it).
    Returns (schedulers touched, schedulers CREATED here) — the caller
    must only close the latter: a scheduler that pre-existed this serve
    call belongs to someone else's sessions too, and closing it would
    kill their in-flight rounds with SchedulerClosed."""
    scheds, owned = [], []
    for adapter in adapters.values():
        attach = getattr(adapter, "attach_scheduler", None)
        if attach is None:
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
        # An engine on a mesh raises here, naming its ROADMAP item: the
        # session fails rather than quietly serving unscheduled.
        from ..engine.scheduler import acquire_scheduler
        sched, created = acquire_scheduler(engine, admit_hold_s=admit_hold_s)
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
    _check_ported(journal_dir, None, replicas)
    topics = _dedupe_topics(list(topics))
    all_scheds: list = []
    owned_scheds: list = []
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
                adapters, entry["session_id"], admit_hold_s)
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
    # Only schedulers CREATED by this call — a pre-existing one is
    # shared with sessions outside this call and must keep running.
    for s in {id(s): s for s in owned_scheds}.values():
        s.close()
    return report


def serve_command(topics: list[str], sessions: Optional[int] = None,
                  read_code: Optional[bool] = None,
                  project_root: Optional[str] = None,
                  journal_dir: Optional[str] = None,
                  resume_dir: Optional[str] = None,
                  replicas: int = 1, device="cuda") -> int:
    """CLI: `roundtable serve "topic" --sessions 4` (one topic fanned
    into K concurrent discussions), `roundtable serve "t1" "t2" "t3"`
    (one discussion each)."""
    _check_ported(journal_dir, resume_dir, replicas)
    project_root = project_root or os.getcwd()
    config = load_config(project_root)
    if not topics:
        raise ConfigError(
            "serve needs topics to discuss (or --resume DIR)")
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
                               device=device)

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
    print(style.dim(f"  total wall: {report['wall_s']:.1f}s\n"))
    return 1 if failed else 0
