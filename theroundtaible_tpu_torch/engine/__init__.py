"""The PyTorch/CUDA inference engine (counterpart of
theroundtaible_tpu/engine/__init__.py).

`get_engine(config, device=...)` is the construction seam the torch-llm
adapter uses: it caches engines by every serving-relevant config key (and
the device), so knights with identical configs share one resident model
while differing ones never silently collide. A config with a mesh joins
the process group its environment describes first (torchrun or the
ROUNDTABLE_* variables, engine/distributed.py); a mesh whose "pipe" entry
is truthy builds the pipeline-parallel PPEngine (engine/pp_serving.py),
every other config the main InferenceEngine, as in the JAX package; a mesh
axis the port does not serve ("seq") raises before anything is built.
Per-call settings such as knight_sampling are deliberately NOT in the key.
"""

from __future__ import annotations

import json
import threading
from typing import Any

_engines: dict[str, Any] = {}
_breakers: dict[str, Any] = {}
_lock = threading.Lock()


def _cache_key(config: dict[str, Any], device="cuda") -> str:
    relevant = {k: config.get(k) for k in
                ("model", "checkpoint", "max_seq_len", "dtype", "mesh",
                 "seq_parallel", "long_scheme", "long_threshold",
                 "devices", "attn", "num_slots", "sampling", "seed",
                 "kv_layout", "page_size", "num_pages", "n_micro",
                 "quant", "dcn_axis", "prefix_cache",
                 "prefix_cache_pages", "kv_offload", "ragged_attn",
                 "spec_decode", "spec_max_draft", "lora", "kv_quant")}
    relevant["device"] = str(device)
    return json.dumps(relevant, sort_keys=True)


def get_engine(config: dict[str, Any], device="cuda"):
    """Build (or reuse) an engine for this adapter config on `device`: a
    PPEngine for a mesh with a truthy "pipe" entry, else an
    InferenceEngine."""
    key = _cache_key(config, device)
    with _lock:
        if key not in _engines:
            from .sharding import check_mesh_axes, is_pipe_mesh, mesh_size
            check_mesh_axes(config.get("mesh"))
            if mesh_size(config.get("mesh")) > 1:
                # A mesh's ranks: join the group the environment describes
                # (torchrun or the ROUNDTABLE_* variables), as the JAX
                # package's get_engine joins its own.
                from .distributed import initialize_from_env
                initialize_from_env(device)
            if is_pipe_mesh(config.get("mesh")):
                from .pp_serving import PPEngine
                eng = PPEngine.from_config(config, device=device)
            else:
                from .engine import InferenceEngine
                eng = InferenceEngine.from_config(config, device=device)
            # Supervision identity + rebuild recipe: the EngineSupervisor
            # rebuilds a dead engine from exactly this config (on the
            # engine's device) and keys its restart budget by this key.
            eng._engine_cache_key = key
            eng._engine_config = dict(config)
            _engines[key] = eng
        return _engines[key]


def replace_engine(old, new) -> bool:
    """Swap a rebuilt engine into the cache in place of the instance it
    supersedes (engine/supervisor.py restart cycle): every later
    get_engine with the same config serves the fresh engine. Returns
    whether a cache entry was replaced (False for engines constructed
    outside the cache)."""
    with _lock:
        for k, v in list(_engines.items()):
            if v is old:
                _engines[k] = new
                return True
    return False


def get_breaker(config: dict[str, Any], device="cuda"):
    """The circuit breaker for this engine config - keyed exactly like the
    engine cache, so every adapter sharing a resident engine shares its
    failure history. `breaker_threshold` (default 3) is set by the FIRST
    caller; a later caller asking for another gets the shared breaker
    as-is, with a warning."""
    key = _cache_key(config, device)
    threshold = max(1, int(config.get("breaker_threshold", 3)))
    with _lock:
        breaker = _breakers.get(key)
        if breaker is None:
            from .faults import CircuitBreaker
            breaker = _breakers[key] = CircuitBreaker(
                threshold=threshold, name=config.get("model", "engine"))
        elif (breaker.threshold != threshold
              and "breaker_threshold" in config):
            import warnings
            warnings.warn(
                f"breaker_threshold {threshold} ignored: this engine's "
                f"shared breaker was created with threshold "
                f"{breaker.threshold} (first caller wins)")
        return breaker


def breaker_snapshots() -> list[dict[str, Any]]:
    """Health snapshot of every engine breaker (fleet.fleet_health)."""
    with _lock:
        return [b.snapshot() for b in _breakers.values()]


def reset_engines() -> None:
    """Drop all cached engines and their breakers (tests)."""
    with _lock:
        _engines.clear()
        _breakers.clear()


# The multi-LoRA surface: `from theroundtaible_tpu_torch.engine import
# LoraStore` without deep paths (loaded on first use, as in the JAX
# package).
_LORA_EXPORTS = ("LoraStore", "lora_enabled", "lora_dims",
                 "save_pair_tree")


# The supervision surface: the supervisor singleton's accessors, the
# classified dead-engine error and the durable session journal, loaded on
# first use like the LoRA surface. The singleton itself is reached as
# engine.supervisor.supervisor() - the bare name would shadow the
# submodule.
_SUPERVISION_EXPORTS = ("EngineSupervisor", "EngineDead",
                        "set_supervisor", "supervisor_snapshot")
_JOURNAL_EXPORTS = ("SessionJournal", "replay_turns",
                    "replay_turn_prompt")


def __getattr__(name: str):
    if name in _LORA_EXPORTS:
        from . import lora as _lora
        return getattr(_lora, name)
    if name in _SUPERVISION_EXPORTS:
        from . import supervisor as _sup
        return getattr(_sup, name)
    if name in _JOURNAL_EXPORTS:
        from . import session_journal as _sj
        return getattr(_sj, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
