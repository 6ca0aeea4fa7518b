"""The PyTorch/CUDA inference engine (counterpart of
theroundtaible_tpu/engine/__init__.py).

`get_engine(config, device=...)` is the construction seam the torch-llm
adapter uses: it caches engines by every serving-relevant config key (and
the device), so knights with identical configs share one resident model
while differing ones never silently collide. Per-call settings such as
knight_sampling are deliberately NOT in the key.
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
    """Build (or reuse) an engine for this adapter config on `device`."""
    key = _cache_key(config, device)
    with _lock:
        if key not in _engines:
            from .engine import InferenceEngine
            _engines[key] = InferenceEngine.from_config(config,
                                                        device=device)
        return _engines[key]


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


def __getattr__(name: str):
    if name in _LORA_EXPORTS:
        from . import lora as _lora
        return getattr(_lora, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
