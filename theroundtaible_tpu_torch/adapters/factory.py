"""Adapter factory + initialization (counterpart of
theroundtaible_tpu/adapters/factory.py).

Parity with reference src/utils/adapters.ts:15-106: `create_adapter` switches
over the static adapter ids plus dynamic prefix ids; `initialize_adapters`
probes availability per knight and runs context-window detection for local
adapters (the JAX package's init-time CLI -> API fallback comes with those
adapters, ROADMAP item 1b). The map is keyed by **adapter id**, not knight name.

Engine knights: the `torch-llm` / `torch-llm-<model>` ids and the JAX
package's `tpu-llm` / `tpu-llm-<model>` ids both seat a TorchLlmAdapter
(it reads the same config keys), so a project's `.roundtable/config.json`
seats its engine knights on the port unchanged. The engines run on
`device`: the card unless the caller asks for the CPU. The `fake` id is
the hermetic test seam. The CLI, API and local-llm knights are not ported
yet and raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..core.errors import ITEM_1B, ITEM_7E_II, not_ported
from ..core.types import RoundtableConfig
from .base import BaseAdapter, DEFAULT_TIMEOUT_MS

_EXTERNAL_IDS = ("claude-cli", "gemini-cli", "openai-cli", "claude-api",
                 "gemini-api", "openai-api")


def is_engine_adapter(adapter_id: str) -> bool:
    """The ids a TorchLlmAdapter serves."""
    return adapter_id.startswith(("torch-llm", "tpu-llm"))


def create_adapter(adapter_id: str, config: RoundtableConfig,
                   timeout_ms: int = DEFAULT_TIMEOUT_MS,
                   device="cuda") -> Optional[BaseAdapter]:
    """Instantiate one adapter by id (reference adapters.ts:15-56)."""
    cfg: dict[str, Any] = config.adapter_config.get(adapter_id, {})

    if adapter_id in _EXTERNAL_IDS or adapter_id.startswith("local-llm"):
        raise not_ported(f"the {adapter_id!r} adapter", ITEM_1B)
    if is_engine_adapter(adapter_id):
        from .torch_llm import TorchLlmAdapter
        return TorchLlmAdapter.from_config(adapter_id, cfg, timeout_ms,
                                           device=device)
    if adapter_id == "fake":
        from .fake import FakeAdapter
        return FakeAdapter(name=cfg.get("name", "Fake"))
    return None


def initialize_adapters(
    config: RoundtableConfig,
    on_event: Optional[Callable[[str, str], None]] = None,
    device="cuda",
) -> dict[str, BaseAdapter]:
    """Probe + seat every knight's adapter (reference adapters.ts:62-106).

    on_event(kind, message): "seated" | "unavailable" notices
    for the command layer to display. Engine knights run on `device`.
    """
    timeout_ms = config.rules.timeout_per_turn_seconds * 1000
    adapters: dict[str, BaseAdapter] = {}

    _plan_engine_fleet(config, on_event)

    for knight in config.knights:
        adapter_id = knight.adapter
        if adapter_id in adapters:
            continue
        adapter = create_adapter(adapter_id, config, timeout_ms, device)
        if adapter is not None and adapter.is_available():
            _post_init(adapter)
            adapters[adapter_id] = adapter
            if on_event:
                on_event("seated", f"{knight.name} ({adapter_id}) is at the table")
            continue
        if on_event:
            on_event("unavailable",
                     f"{knight.name} ({adapter_id}) is unavailable")
    return adapters


def _plan_engine_fleet(config: RoundtableConfig,
                       on_event: Optional[Callable[[str, str], None]]
                       ) -> None:
    """Heterogeneous serving: several engine knights with DIFFERENT
    configs. The JAX package partitions the chips into per-model submeshes
    here (engine/fleet.py); that planner is not ported, so the engines
    share the card, and the operator hears it through the same
    "unavailable" notice the JAX factory gives when planning fails.
    Homogeneous setups are untouched."""
    engine_cfgs = []
    for knight in config.knights:
        if is_engine_adapter(knight.adapter):
            cfg = config.adapter_config.setdefault(knight.adapter, {})
            if isinstance(cfg, dict) and cfg not in engine_cfgs:
                engine_cfgs.append(cfg)
    if len(engine_cfgs) < 2:
        return
    if on_event:
        on_event("unavailable",
                 f"fleet planning failed ({not_ported('fleet planning', ITEM_7E_II)}); "
                 f"engines will share the card")


def _post_init(adapter: BaseAdapter) -> None:
    """Context-window detection for adapters that support it
    (reference adapters.ts:78-83)."""
    detect = getattr(adapter, "detect_context_window", None)
    if callable(detect):
        try:
            detect()
        except Exception:
            pass
