"""Heterogeneous multi-model fleet planning, fleet health, drain and
resume, and the closed-form engine size estimates (counterpart of
theroundtaible_tpu/engine/fleet.py).

`plan_fleet` runs at adapter-initialization time (before any engine is
built, adapters/factory._plan_engine_fleet): it groups the knights'
engine configs by model identity, sizes each group's device group
(power-of-two growth, weighted by parameter bytes, `partition_devices`),
checks every device's estimated resident bytes against its plannable
memory (`check_fleet_fits`: unpinned configs degrade bf16 -> int8 -> int4
with a warning, `"_quant_auto_degraded"` marks them, and a fleet that
still does not fit raises with the breakdown) and writes the chosen
device indices into each config. On one card every group is [0]: the
plan is the fit check, and each engine's `devices: [0]` selects that
card. A group of several indices (a machine with several cards) is
refused by the engine (`_pinned_device`) until Queue 1 slice 6. The JAX
package joins a multi-host process group first (maybe_init_distributed);
the port has no multi-host group until slice 6.

The estimates also back the memory ledger's
`roundtable_hbm_bytes_estimated` where no card reports its memory
(engine/trace_hooks.py). `fleet_health`'s `router` key is the active
session router's `describe()` (router/core.py), None when no router is
active.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def estimate_param_count(cfg) -> int:
    """Closed-form parameter count of a ModelConfig (no tensor built)."""
    e, h, k, d, f = (cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim, cfg.mlp_dim)
    mlp = 3 * e * f
    if cfg.num_experts:
        mlp = cfg.num_experts * 3 * e * f + e * cfg.num_experts  # + router
    per_layer = 2 * e * h * d + 2 * e * k * d + mlp + 2 * e
    if cfg.attn_bias:  # Qwen2: q/k/v projection biases
        per_layer += h * d + 2 * k * d
    total = cfg.num_layers * per_layer + cfg.vocab_size * e + e
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * e
    return total


def estimate_engine_hbm_bytes(engine_cfg: dict[str, Any],
                              model_cfg=None) -> int:
    """Closed-form resident device bytes of one engine (no tensor built):
    weights (quant-aware), the KV pool, the LoRA stacks and an
    activation/workspace margin. Approximate by design; margins err
    high."""
    if model_cfg is None:
        from .models.registry import get_model_config
        model_cfg = get_model_config(engine_cfg.get("model", "tiny-gemma"))
    max_seq = int(engine_cfg.get("max_seq_len") or model_cfg.max_seq_len)
    n_params = estimate_param_count(model_cfg)
    dtype_b = _DTYPE_BYTES.get(engine_cfg.get("dtype", "bfloat16"), 2)
    # int8: 1 byte per weight plus per-channel scales; int4: packed
    # nibbles plus per-group scales and the leaves kept at int8.
    quant = engine_cfg.get("quant")
    w_bytes = int(n_params * (1.05 if quant == "int8"
                              else 0.58 if quant == "int4"
                              else dtype_b))
    num_slots = int(engine_cfg.get("num_slots", 4))
    kv_bytes = (num_slots * max_seq * model_cfg.num_layers * 2
                * model_cfg.num_kv_heads * model_cfg.head_dim * dtype_b)
    if engine_cfg.get("kv_layout") == "paged":
        # The default pool halves the contiguous budget. With an explicit
        # num_pages the pool's bytes follow the (quantized) cell; the
        # default pool keeps the bf16 byte budget.
        kv_bytes //= 2
        num_pages = engine_cfg.get("num_pages")
        if num_pages is not None:
            from .kv_quant import cell_bytes_per_token, resolve_spec
            kvq = engine_cfg.get("kv_quant")
            spec = (resolve_spec(kvq)[0] if kvq and kvq != "none"
                    else None)
            page_size = int(engine_cfg.get("page_size", 128))
            kv_bytes = int(int(num_pages) * page_size
                           * cell_bytes_per_token(model_cfg, spec,
                                                  dtype_b))
    lora_bytes = 0
    lora_cfg = engine_cfg.get("lora")
    if lora_cfg:
        from .lora import stack_bytes_for
        lora_bytes = stack_bytes_for(model_cfg, lora_cfg,
                                     dtype_bytes=dtype_b)
    # Activations and workspace: small next to 7B-class weights; floored
    # for tiny models.
    margin = max(256 << 20, w_bytes // 16)
    return w_bytes + kv_bytes + lora_bytes + margin


# Fraction of a card's memory treated as plannable: the runtime reserves a
# slice and serving needs workspace for concurrently dispatched prefills
# (the JAX package's calibration, kept as it is).
_HBM_UTILIZATION = 0.75


def device_memory_bytes(device="cuda") -> Optional[int]:
    """Plannable per-device bytes: the card's total memory (device 0 of a
    CUDA `device` without an index) times _HBM_UTILIZATION. None - no
    check - on the CPU, as the JAX package's CPU backend reports no
    limit. Without a card a CUDA device raises (engine/device.py)."""
    import torch
    from .device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    total = torch.cuda.get_device_properties(dev.index or 0).total_memory
    return int(total * _HBM_UTILIZATION)


def device_count(device="cuda") -> int:
    """The devices a fleet partitions: the cards on a CUDA `device`, 1 on
    the CPU (never 0: partition_devices divides by it)."""
    import torch
    from .device import resolve_device
    dev = resolve_device(device)
    return max(torch.cuda.device_count(), 1) if dev.type == "cuda" else 1


def partition_devices(weights: list[int], n_devices: int) -> list[list[int]]:
    """Split device indices 0..n-1 into one contiguous group per weight.

    Every group starts at 1 device; remaining devices are granted by
    repeated DOUBLING (each group a power of two, so model-axis sizes
    divide heads and hidden cleanly), always to the group with the highest
    bytes-per-device. Leftover devices (when no group can double) stay
    idle. With more models than devices the groups share: model i gets
    device i % n_devices (every model resident, one card's memory shared -
    what the fit check charges)."""
    m = len(weights)
    if m == 0:
        return []
    if n_devices < m:
        return [[i % n_devices] for i in range(m)]

    sizes = [1] * m
    remaining = n_devices - m
    while True:
        # candidate: the most memory-pressured group whose doubling fits
        best, best_load = None, -1.0
        for i in range(m):
            if sizes[i] <= remaining:
                load = weights[i] / sizes[i]
                if load > best_load:
                    best, best_load = i, load
        if best is None:
            break
        remaining -= sizes[best]
        sizes[best] *= 2

    groups: list[list[int]] = []
    start = 0
    for size in sizes:
        groups.append(list(range(start, start + size)))
        start += size
    return groups


def _engine_identity(cfg: dict[str, Any]) -> str:
    """Two configs with the same identity share one engine (and device
    group)."""
    return f"{cfg.get('model', 'tiny-gemma')}|{cfg.get('checkpoint', '')}"


def check_fleet_fits(identities: dict[str, list[dict[str, Any]]],
                     groups: list[list[int]],
                     budget_bytes: int) -> None:
    """Validate every device's resident-bytes total against its plannable
    memory (the JAX package's check, word for word in its warnings and
    error).

    A group's bytes per device are its engines' estimates divided by its
    group size, each distinct engine config (`_cache_key`) charged once;
    groups sharing a device accumulate. An over-budget device degrades the
    largest offending group whose configs are all unpinned (no explicit
    `quant` but an earlier auto-degrade to int8, and not float32): bf16 ->
    int8, then int8 -> int4, each with a warning and
    `"_quant_auto_degraded": True`; with nothing left to flip it raises
    ValueError with the breakdown - a plan-time error instead of an
    allocation failure minutes into the engine builds."""
    items = list(identities.items())

    def per_device_totals():
        from . import _cache_key
        totals: dict[int, float] = {}
        contrib = []  # (ident, cfgs, group, per_dev_bytes)
        for (ident, cfgs), group in zip(items, groups):
            # One identity can still build several resident engines (the
            # engine cache keys on more than model and checkpoint), so
            # each distinct engine config is charged.
            distinct = {_cache_key(c): c for c in cfgs}
            per_dev = 0.0
            for c in distinct.values():
                try:
                    per_dev += (estimate_engine_hbm_bytes(c)
                                / max(len(group), 1))
                except ValueError:
                    pass  # unknown model: the allocator is the backstop
            contrib.append((ident, cfgs, group, per_dev))
            for dev in group:
                totals[dev] = totals.get(dev, 0.0) + per_dev
        return totals, contrib

    while True:
        totals, contrib = per_device_totals()
        over = {d: t for d, t in totals.items() if t > budget_bytes}
        if not over:
            return
        worst_dev = max(over, key=over.get)
        # Two degrade tiers: bf16 -> int8, then int8 -> int4. Only an
        # auto-degraded int8 re-flips: an operator's explicit quant or
        # dtype is never rewritten.
        flippable = [(ident, cfgs, per_dev)
                     for ident, cfgs, group, per_dev in contrib
                     if worst_dev in group
                     and all((("quant" not in c)
                              or (c.get("_quant_auto_degraded")
                                  and c.get("quant") == "int8"))
                             and c.get("dtype", "bfloat16") != "float32"
                             for c in cfgs)]
        if not flippable:
            def gib(x): return f"{x / (1 << 30):.1f} GiB"
            lines = "; ".join(
                f"{ident.split('|')[0]}: {gib(per_dev)}/device over "
                f"{len(group)} device(s)"
                for ident, _c, group, per_dev in contrib)
            raise ValueError(
                f"Fleet does not fit: device {worst_dev} needs "
                f"{gib(over[worst_dev])} of {gib(budget_bytes)} HBM "
                f"({lines}). Fix: quant='int8'/'int4' on the big models, "
                "fewer models per chip, smaller max_seq_len/num_slots, "
                "or more devices.")
        ident, cfgs, per_dev = max(flippable, key=lambda x: x[2])
        next_quant = ("int4" if cfgs[0].get("quant") == "int8"
                      else "int8")
        warnings.warn(
            f"Fleet over HBM budget on device {worst_dev}: quantizing "
            f"{ident.split('|')[0]} to {next_quant} to fit; set "
            "quant explicitly to override", stacklevel=3)
        for c in cfgs:
            c["quant"] = next_quant
            # describe()["quant"] reads e.g. "int8 (auto-degraded)"
            c["_quant_auto_degraded"] = True


def plan_fleet(engine_configs: list[dict[str, Any]],
               n_devices: Optional[int] = None,
               budget_bytes: Optional[int] = None,
               device="cuda") -> None:
    """Assign device groups to heterogeneous engine configs.

    Mutates each config dict, setting "devices" (device indices) - and,
    when a group would overflow its devices' memory, degrading unpinned
    configs or raising (check_fleet_fits). No-ops when fewer than two
    distinct models are configured or any config already pins "devices"
    or "mesh" (an explicit layout wins). `n_devices` defaults to the
    devices of `device` (device_count), `budget_bytes` to its plannable
    memory (device_memory_bytes: None on the CPU, no check)."""
    configs = [c for c in engine_configs if c is not None]
    if any(c.get("devices") or c.get("mesh") for c in configs):
        return
    identities: dict[str, list[dict[str, Any]]] = {}
    for c in configs:
        identities.setdefault(_engine_identity(c), []).append(c)
    if len(identities) < 2:
        return

    if n_devices is None:
        n_devices = device_count(device)

    from .models.registry import get_model_config
    weights = []
    for ident, cfgs in identities.items():
        model_name = cfgs[0].get("model", "tiny-gemma")
        try:
            weights.append(estimate_param_count(get_model_config(model_name)))
        except ValueError:
            weights.append(1)
    groups = partition_devices(weights, n_devices)
    if budget_bytes is None:
        budget_bytes = device_memory_bytes(device)
    if budget_bytes:
        check_fleet_fits(identities, groups, budget_bytes)
    for (ident, cfgs), group in zip(identities.items(), groups):
        for c in cfgs:
            c["devices"] = list(group)


def fleet_health() -> dict[str, Any]:
    """Health roll-up of every resident engine's circuit breaker: per-engine
    snapshots keyed like the engine cache, open/total counts, `degraded`
    (recent consecutive failures below the trip), `draining` (the admission
    gate), `hangs` (the watchdog's recent hang detections), `schedulers`
    (every live session scheduler's queue and per-session state), the
    registry's view, the build watch's roll-up (`perf`) and the
    supervisor's restart history. Host-side counters only, no device work,
    so status surfaces can poll it per round."""
    from . import breaker_snapshots, deadlines
    from ..utils import telemetry
    from .scheduler import schedulers
    snaps = breaker_snapshots()
    sched_snaps = [s.snapshot() for s in schedulers()]
    return {
        "engines": snaps,
        "total": len(snaps),
        "open": sum(1 for s in snaps if s["open"]),
        "degraded": sum(1 for s in snaps
                        if s["failures"] > 0 and not s["open"]),
        "draining": deadlines.DRAINING,
        "hangs": len(deadlines.hang_log()),
        "schedulers": sched_snaps,
        "queued_sessions": sum(s["queued"] for s in sched_snaps),
        "telemetry": telemetry.registry_view(),
        "perf": _perf_rollup(),
        "supervisor": _supervisor_rollup(),
        "router": _router_rollup(),
    }


def _perf_rollup() -> dict[str, Any]:
    from .compile_watch import summary
    s = summary()
    return {"compile_mode": s["mode"], "compiles": s["compiles"],
            "steady_state": s["steady_state"],
            "steady_state_compiles": s["steady_state_compiles"],
            "strict": s["strict"]}


def _supervisor_rollup() -> dict[str, Any]:
    from .supervisor import supervisor_snapshot
    return supervisor_snapshot()


def _router_rollup() -> Optional[dict[str, Any]]:
    """The active session router's fleet view: per-replica liveness and
    assignment counts, migration/failover/roll history. None without one."""
    from ..router.core import active_router
    r = active_router()
    return r.describe() if r is not None else None


def drain(timeout_s: float = 30.0, flush_kv: bool = True) -> dict[str, Any]:
    """Graceful drain: stop admitting turns, let every in-flight generation
    finish its rung, then flush per-knight KV state.

    1. Flip the module-level admission gate (deadlines.begin_drain): every
       later generate_batch call on any resident engine raises
       DrainingError; calls already past the gate complete normally.
    1b. Close every attached scheduler's admission gate and reject its
       QUEUED requests now with a clean DrainingError; its ACTIVE sessions
       finish their rounds like any in-flight turn.
    2. For each resident engine, acquire its serve lock within `timeout_s`
       (acquisition IS the proof that in-flight work finished) and, holding
       it, flush every per-knight slot (paged pools unref their pages, the
       prefix cache's index included; contiguous slots return to the free
       list), then evacuate the offload tier's kept-resident pages to host
       RAM, so a drained pool reads zero pages in use while spilled
       sessions still resume without re-prefill. An engine whose in-flight
       turn outlives the timeout reports `in_flight_drained: False` and
       stays unflushed.

    Admission stays closed after drain() returns; `resume()` re-opens it.
    Returns a report: per-engine flush counts and whether the drain was
    clean."""
    import time
    from . import _engines, _lock, deadlines
    from ..utils import telemetry
    from .scheduler import schedulers
    deadlines.begin_drain()
    # The drain is itself a postmortem trigger.
    telemetry.recorder().record("drain_begin", timeout_s=timeout_s)
    dump_path = telemetry.flight_dump("drain")
    deadline = time.monotonic() + timeout_s
    for s in schedulers():
        s.pause_admission("fleet.drain")
    rejected = sum(s.reject_queued() for s in schedulers())
    with _lock:
        engines = list(_engines.items())
    report: dict[str, Any] = {"draining": True, "clean": True,
                              "engines": [],
                              "queued_sessions_rejected": rejected,
                              "telemetry_dump": dump_path}
    for key, eng in engines:
        entry: dict[str, Any] = {
            "engine": getattr(getattr(eng, "cfg", None), "name", key)}
        lock = getattr(eng, "_serve_lock", None)
        acquired = True
        if lock is not None:
            acquired = lock.acquire(
                timeout=max(deadline - time.monotonic(), 0.0))
        entry["in_flight_drained"] = acquired
        if acquired:
            try:
                if flush_kv:
                    # Best-effort per engine: one cache's flush failure
                    # must not abandon the remaining engines mid-drain.
                    try:
                        entry["flushed_slots"] = eng.kv.flush()
                        tier = getattr(eng, "kv_offload", None)
                        if tier is not None:
                            manifest = tier.evacuate()
                            entry["evacuated_pages"] = \
                                manifest["pages_moved"]
                    except Exception as e:  # noqa: BLE001
                        entry["flush_error"] = str(e)
                        report["clean"] = False
            finally:
                if lock is not None:
                    lock.release()
        else:
            report["clean"] = False
        report["engines"].append(entry)
    return report


def resume() -> None:
    """Re-open admission after a drain: the module flag, and every attached
    scheduler's gate (a drained scheduler's queue must admit again, not
    stay paused)."""
    from . import deadlines
    from .scheduler import schedulers
    deadlines.end_drain()
    for s in schedulers():
        s.reopen_admission()
