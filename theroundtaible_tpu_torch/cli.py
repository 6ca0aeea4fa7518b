"""CLI entry point — `python -m theroundtaible_tpu_torch` (counterpart of
theroundtaible_tpu/cli.py).

Equivalent of reference src/index.ts:29-187: the JAX CLI's whole argparse
surface, a single central error handler that is the ONLY place the process
exits with a nonzero code. `discuss` runs on the port's engine; every other
command raises NotImplementedError naming the ROADMAP item that brings it,
which the handler turns into a nonzero exit. The JAX CLI's update check
(a request to PyPI on every command) comes with the other network-facing
host code, ROADMAP item 1b.
"""

from __future__ import annotations

import os
import sys

from . import __version__
from .core.errors import (ITEM_1B, ITEM_7D, ITEM_7E_II, ExitCode,
                          RoundtableError, format_error, not_ported)


def handle_cli_error(err: BaseException) -> int:
    """Central error handler — the only exit-code authority
    (reference src/index.ts:29-46)."""
    if isinstance(err, KeyboardInterrupt):
        print("\nInterrupted.", file=sys.stderr)
        return int(ExitCode.GENERAL)
    print(format_error(err), file=sys.stderr)
    if os.environ.get("DEBUG"):
        import traceback
        traceback.print_exception(err)
    if isinstance(err, RoundtableError):
        return int(err.exit_code)
    return int(ExitCode.UNEXPECTED)


def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog="roundtable",
        description="TheRoundtAIble-TPU — multi-LLM consensus discussions, "
                    "served from an NVIDIA card (PyTorch/CUDA port).")
    p.add_argument("--version", action="version", version=__version__)
    sub = p.add_subparsers(dest="command")

    sub.add_parser("init", help="Interactive setup wizard")

    d = sub.add_parser("discuss", help="Start a roundtable discussion")
    dgroup = d.add_mutually_exclusive_group(required=True)
    dgroup.add_argument("topic", nargs="?", help="The question to discuss")
    dgroup.add_argument("--continue", dest="continue_session",
                        action="store_true",
                        help="Resume the latest unfinished session "
                             "(crash recovery)")
    d.add_argument("--read-code", action="store_true", default=None,
                   help="Read source code into context without asking")
    d.add_argument("--no-read-code", dest="read_code", action="store_false",
                   help="Skip reading source code without asking")

    v = sub.add_parser(
        "serve",
        help="Serve K concurrent discussions on one shared engine fleet")
    v.add_argument("topics", nargs="*",
                   help="Topics (one concurrent discussion each)")
    v.add_argument("--sessions", type=int, default=None,
                   help="Fan ONE topic into K concurrent discussions")
    v.add_argument("--journal", default=None, metavar="DIR",
                   help="Journal every committed turn to DIR (fsynced "
                        "JSONL per session) so a crashed process can "
                        "resume with --resume DIR")
    v.add_argument("--resume", dest="resume_dir", default=None,
                   metavar="DIR",
                   help="Replay the session journal at DIR through the "
                        "normal submit path (re-prefill; the prefix "
                        "cache makes it cheap), restoring every "
                        "session's KV at its last committed turn — "
                        "then serve the given topics (if any)")
    v.add_argument("--replicas", type=int, default=1, metavar="N",
                   help="Serve across N data-parallel engine replicas "
                        "behind the session router (default 1 — "
                        "byte-identical to single-engine serving)")
    v.add_argument("--read-code", action="store_true", default=None,
                   help="Read source code into context without asking")
    v.add_argument("--no-read-code", dest="read_code",
                   action="store_false",
                   help="Skip reading source code without asking")

    g = sub.add_parser(
        "gateway",
        help="Serve the streaming HTTP/SSE front door: OpenAI-"
             "compatible /v1/chat/completions + native /v1/discussions "
             "over the shared engine, with SLO-driven admission, load "
             "shedding and crash-consistent mid-stream resume")
    g.add_argument("--host", default=None,
                   help="Bind address (default ROUNDTABLE_GATEWAY_HOST "
                        "or 127.0.0.1)")
    g.add_argument("--port", type=int, default=None,
                   help="Bind port (default ROUNDTABLE_GATEWAY_PORT "
                        "or 8080; 0 = ephemeral)")
    g.add_argument("--journal", default=None, metavar="DIR",
                   help="Journal every committed turn + stream intent "
                        "to DIR so a kill -9'd gateway resumes with "
                        "--resume DIR")
    g.add_argument("--resume", dest="resume_dir", default=None,
                   metavar="DIR",
                   help="Replay DIR's session journal on boot (library "
                        "seam shared with `serve --resume`), restoring "
                        "every session's KV at its last committed turn "
                        "so clients reconnect via Last-Event-ID with "
                        "no token loss or duplication")
    g.add_argument("--replicas", type=int, default=1, metavar="N",
                   help="Serve across N data-parallel engine replicas: "
                        "the session router places cold sessions by "
                        "live load score, keeps returning sessions on "
                        "the replica holding their KV, migrates "
                        "sessions across replicas over the host-RAM "
                        "tier, and rolls replicas one at a time with "
                        "zero lost sessions (default 1)")

    s = sub.add_parser("summon", help="Review the current git diff")
    s.add_argument("--read-code", action="store_true", default=None,
                   help="Read source code into context without asking")
    s.add_argument("--no-read-code", dest="read_code", action="store_false",
                   help="Skip reading source code without asking")

    lg = sub.add_parser(
        "loadgen",
        help="Offered-load capacity sweep: open-loop arrivals ramped "
             "to the shed point, knee fit, and derived admission "
             "thresholds (writes CAPACITY_r19.json in full mode)")
    lg.add_argument("--smoke", action="store_true",
                    help="Tiny ~30s sweep, no artifact")
    lg.add_argument("--seed", type=int, default=7)
    lg.add_argument("--arrival", default="poisson",
                    choices=["poisson", "diurnal", "mmpp"],
                    help="Arrival process for the sweep")
    lg.add_argument("--duration", type=float, default=None,
                    help="Seconds per sweep point")
    lg.add_argument("--rates", default=None, metavar="R,R,...",
                    help="Comma-separated offered rates "
                         "(default: geometric ramp)")
    lg.add_argument("--out", default=None,
                    help="Capacity-record path "
                         "(default ./CAPACITY_r19.json)")

    st = sub.add_parser("status", help="Show the latest session")
    st.add_argument("--telemetry", action="store_true",
                    help="Render the session's telemetry view: registry "
                         "snapshot, span summary, flight-recorder dumps")
    st.add_argument("--perf", action="store_true",
                    help="Render live performance attribution: roofline "
                         "table, compile observatory, memory ledger, "
                         "span-tree overhead breakdown")
    st.add_argument("--kv", action="store_true",
                    help="Render the KV-tier view: memory ledger with "
                         "the cross-session sharing split, prefix-cache "
                         "hit/miss series, host-RAM offload state")
    st.add_argument("--health", action="store_true",
                    help="Render fleet health: breakers, admission "
                         "gates, scheduler queues, and the supervisor's "
                         "engine-restart history")
    st.add_argument("--gateway", action="store_true",
                    help="Render the serving gateway's admission/shed "
                         "ledger: admitted/shed/expired counters by "
                         "reason, inflight streams, drop-to-summary "
                         "and resume counts")
    st.add_argument("--capacity", action="store_true",
                    help="Render the measured capacity frontier "
                         "(latest CAPACITY_r19.json or "
                         "ROUNDTABLE_GATEWAY_CAPACITY_FILE) against "
                         "the live gateway gauges: predicted vs "
                         "measured, knee, derived thresholds")
    st.add_argument("--fleet", action="store_true",
                    help="Render the multi-replica serving view: "
                         "per-replica liveness, session assignment, "
                         "queue/row gauges, and the router's "
                         "migration / failover / roll history")
    st.add_argument("--slo", action="store_true",
                    help="Render the SLO burn-rate view: the p95 TTFT "
                         "SLO from the capacity record, live fast/slow "
                         "burn-rate gauges against the error budget, "
                         "breach + flight-dump counters, and trace "
                         "retention")

    tr = sub.add_parser(
        "trace",
        help="Inspect retained request traces: per-request critical-"
             "path waterfalls (admission → queue → placement → prefill "
             "→ first flush → decode) stitched across reconnects, "
             "gateway restarts and replica failovers")
    tr.add_argument("action", choices=["list", "show", "stages"],
                    help="list = every retained trace; show <id> = one "
                         "stitched trace's per-leg waterfall; stages = "
                         "the aggregate critical-path table")
    tr.add_argument("trace_id", nargs="?", default=None,
                    help="Trace id (or unique prefix) for `show`")
    tr.add_argument("--dir", dest="trace_dir", default=None,
                    help="Trace directory (default ROUNDTABLE_TRACE_DIR "
                         "or <telemetry dumps>/traces)")

    sub.add_parser("list", help="List all sessions")
    sub.add_parser("chronicle", help="Show the decision chronicle")
    sub.add_parser("decrees", help="Show the King's Decree Log")

    m = sub.add_parser("manifest", help="Implementation manifest")
    msub = m.add_subparsers(dest="manifest_command")
    msub.add_parser("list", help="List manifest features")
    ma = msub.add_parser("add", help="Add a feature entry")
    ma.add_argument("--id", dest="feature_id")
    ma.add_argument("--files", default="")
    ma.add_argument("--status", default="implemented")
    md = msub.add_parser("deprecate", help="Deprecate a feature")
    md.add_argument("feature_id")
    md.add_argument("--replaced-by", default=None)
    msub.add_parser("check", help="Warn about stale manifest entries")

    a = sub.add_parser("apply", help="Let the Lead Knight execute the decision")
    a.add_argument("--noparley", action="store_true",
                   help="Skip per-file approval")
    a.add_argument("--dry-run", action="store_true",
                   help="Show planned edits without writing")
    a.add_argument("--override-scope", action="store_true",
                   help="Allow edits outside the consensus scope (audited)")
    a.add_argument("--session", default=None,
                   help="Apply a specific session instead of the latest")

    c = sub.add_parser("code-red", help="Diagnostic mode for a bug/incident")
    c.add_argument("description", help="What is broken")

    sub.add_parser("warmup",
                   help="Pre-compile the TPU serving programs so the "
                        "first discuss starts hot")

    li = sub.add_parser(
        "lint",
        help="Static serving-invariant analyzer: AST rules + "
             "device-free jaxpr audit (CI / tunnel preflight)")
    li.add_argument("--rules", default=None, metavar="ID,ID",
                    help="Comma-separated rule ids to run "
                         "(default: all)")
    li.add_argument("--jaxpr", action="store_true",
                    help="Also audit every registered serving program "
                         "(prefill/decode/ragged/spec/LoRA-setter) "
                         "device-free on CPU: donation safety, "
                         "callback-free hot loops, warmed-variant "
                         "count across the shape grid")
    li.add_argument("--json", dest="as_json", action="store_true",
                    help="Machine-readable findings (the preflight "
                         "step consumes this)")
    li.add_argument("--root", default=None,
                    help="Tree to lint (default: this checkout)")

    return p


def main(argv: list[str] | None = None, device="cuda") -> int:
    """Parse `argv` and run the command. Engine knights run on `device`:
    the card unless an in-process caller asks for the CPU."""
    args = build_parser().parse_args(argv)
    if args.command is None:
        build_parser().print_help()
        return 0

    try:
        return dispatch(args, device) or 0
    except BaseException as err:  # noqa: BLE001 — single central handler
        return handle_cli_error(err)


# Commands of the JAX CLI the port does not serve yet, with the ROADMAP
# item that brings each.
_NOT_PORTED = {
    "init": ITEM_1B, "serve": ITEM_1B, "summon": ITEM_1B,
    "status": ITEM_1B, "list": ITEM_1B, "chronicle": ITEM_1B,
    "decrees": ITEM_1B, "manifest": ITEM_1B, "apply": ITEM_1B,
    "code-red": ITEM_1B, "warmup": ITEM_1B,
    "gateway": ITEM_7D, "loadgen": ITEM_7D, "trace": ITEM_7D,
    "lint": ITEM_7E_II,
}


def dispatch(args, device="cuda") -> int:
    """Route to command modules (imported lazily to keep startup instant)."""
    if args.command == "discuss":
        if getattr(args, "continue_session", False):
            from .commands.discuss import continue_command
            return continue_command(read_code=args.read_code, device=device)
        from .commands.discuss import discuss_command
        return discuss_command(args.topic, read_code=args.read_code,
                               device=device)
    if args.command in _NOT_PORTED:
        raise not_ported(f"`roundtable {args.command}`",
                         _NOT_PORTED[args.command])
    raise RoundtableError(f"Unknown command: {args.command}")


if __name__ == "__main__":
    sys.exit(main())
