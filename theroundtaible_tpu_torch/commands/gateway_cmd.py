"""`roundtable gateway` — serve the streaming HTTP/SSE front door
(counterpart of theroundtaible_tpu/commands/gateway_cmd.py).

Seats the configured adapters, acquires the first torch-llm engine's
shared SessionScheduler (the same seam `serve --resume` uses), wires the
durable journals, optionally replays a crashed process's committed turns,
and serves HTTP until interrupted. The listening line names the bound
port, so `--port 0` (an ephemeral port) can be read from it. `--replicas
N>1` serves N engines behind a session router (router/core.py): placement,
migration, rolls (`POST /v1/admin/roll`) and failover, with admission over
the fleet's signals. On a mesh every rank runs the same `roundtable
gateway`: rank 0 binds the port and serves; the other ranks follow its
scheduler's plans (engine/mesh_plan.py) and write nothing. A pipe mesh's
PPEngine has no scheduler, and the gateway refuses it with the JAX
package's ConfigError (rank 0 releases the followers first).
"""

from __future__ import annotations

import os
from typing import Optional

from ..core.config import load_config
from ..core.errors import ConfigError
from ..utils.ui import style


def _build_scheduler(config, journal_dir: Optional[str], device="cuda"):
    """First torch-llm engine's shared scheduler (+ attached journal)."""
    from ..adapters.factory import initialize_adapters
    from ..engine.scheduler import acquire_scheduler

    adapters = initialize_adapters(config, device=device)
    sched = None
    for adapter in adapters.values():
        if not hasattr(adapter, "attach_scheduler"):
            continue
        engine = None
        try:
            engine = adapter._get_engine()
            sched, _created = acquire_scheduler(engine)
            break
        except Exception:  # noqa: BLE001 - try the next seat
            if hasattr(engine, "lead"):
                # A pipe mesh's PPEngine has no scheduler to serve (as in
                # the JAX package): its followers leave with rank 0.
                engine.lead()
                engine.close_plans()
            continue
    if sched is None:
        raise ConfigError(
            "gateway needs at least one torch-llm knight whose engine "
            "can be built - no scheduler available to serve")
    if journal_dir is not None and sched.journal is None:
        from ..engine.session_journal import SessionJournal
        sched.attach_journal(SessionJournal(journal_dir))
    return sched


def _build_router(sched, replicas: int):
    """N-replica fleet around the scheduler's engine: the router owns
    session placement, migration, rolls and failover; admission reads the
    fleet's signals through router.signals()."""
    from ..router import SessionRouter, build_replicas, set_active_router
    if getattr(sched.engine, "mesh", None) is not None:
        from ..core.errors import ITEM_7E_II, not_ported
        raise not_ported("a session router over a mesh engine "
                         "(--replicas with a mesh)", ITEM_7E_II)
    reps = build_replicas(sched.engine, replicas, journal=sched.journal)
    router = SessionRouter(reps, journal=sched.journal)
    set_active_router(router)
    return router


def gateway_command(host: Optional[str] = None,
                    port: Optional[int] = None,
                    journal_dir: Optional[str] = None,
                    resume_dir: Optional[str] = None,
                    replicas: int = 1,
                    project_root: Optional[str] = None,
                    device="cuda") -> int:
    project_root = project_root or os.getcwd()
    config = load_config(project_root)
    from ..engine.mesh_plan import follow_config, follower_process
    if follower_process():
        counts = follow_config(config, device)
        print(style.dim(f"  followed rank 0's plans: {counts}"),
              flush=True)
        return 0
    from ..gateway import Gateway

    if resume_dir is not None:
        # Boot-time recovery through the library seam (engine/recovery.py,
        # the `serve --resume` path): committed turns replay into KV
        # BEFORE the socket opens, so the first Last-Event-ID reconnect
        # finds its session restored.
        print(style.bold(f"\n  Resuming sessions from journal "
                         f"{resume_dir}..."), flush=True)
        from ..engine.recovery import resume_from_journal
        r = resume_from_journal(resume_dir, config=config,
                                project_root=project_root, device=device)
        sched = r["scheduler"]
        print(style.dim(
            f"  replayed {r['turns']} committed turn(s) across "
            f"{r['sessions']} session(s)"), flush=True)
        journal_dir = journal_dir or resume_dir
        if journal_dir != str(sched.journal.root):
            from ..engine.session_journal import SessionJournal
            sched.attach_journal(SessionJournal(journal_dir))
    else:
        sched = _build_scheduler(config, journal_dir, device)

    router = _build_router(sched, replicas) if replicas > 1 else None
    gw = Gateway(sched, host=host, port=port, intent_dir=journal_dir,
                 router=router)
    gw.start_in_thread()
    if router is not None:
        print(style.dim(f"  serving across {replicas} replicas "
                        f"({', '.join(r.name for r in router.replicas)})"),
              flush=True)
    print(style.bold(f"\n  Gateway listening on "
                     f"http://{gw.host}:{gw.port}"), flush=True)
    print(style.dim(
        "    POST /v1/chat/completions   (OpenAI-compatible, SSE)\n"
        "    POST /v1/discussions        (native multi-knight, SSE)\n"
        "    GET  /v1/streams/<id>       (Last-Event-ID reconnect)\n"
        "    POST /v1/admin/roll         (rolling restart, fleets)\n"
        "    GET  /healthz · GET /metrics\n"), flush=True)
    try:
        while gw._thread is not None and gw._thread.is_alive():
            gw._thread.join(0.5)
    except KeyboardInterrupt:
        pass
    gw.stop()
    if router is not None:
        router.close()
    if sched._channel is not None:
        # On a mesh: closing rank 0's scheduler ends the followers.
        sched.close()
    return 0
