"""Adapter factory + initialization (counterpart of
theroundtaible_tpu/adapters/factory.py).

Parity with reference src/utils/adapters.ts:15-106: `create_adapter` switches
over the static adapter ids plus dynamic prefix ids; `initialize_adapters`
probes availability per knight, substitutes the API adapter when a CLI is
missing (init-time fallback), and runs context-window detection for local
adapters. The map is keyed by **adapter id**, not knight name.

Engine knights: the `torch-llm` / `torch-llm-<model>` ids and the JAX
package's `tpu-llm` / `tpu-llm-<model>` ids both seat a TorchLlmAdapter
(it reads the same config keys), so a project's `.roundtable/config.json`
seats its engine knights on the port unchanged. The engines run on
`device`: the card unless the caller asks for the CPU. The `fake` id is
the hermetic test seam. The CLI, API and local-llm knights are the JAX
package's, with the same commands, requests and defaults.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..core.types import RoundtableConfig
from .base import BaseAdapter, DEFAULT_TIMEOUT_MS

# CLI id → API id used for init-time fallback (reference adapters.ts:89-100).
_CLI_TO_API = {
    "claude-cli": "claude-api",
    "gemini-cli": "gemini-api",
    "openai-cli": "openai-api",
}


def is_engine_adapter(adapter_id: str) -> bool:
    """The ids a TorchLlmAdapter serves."""
    return adapter_id.startswith(("torch-llm", "tpu-llm"))


def create_adapter(adapter_id: str, config: RoundtableConfig,
                   timeout_ms: int = DEFAULT_TIMEOUT_MS,
                   device="cuda") -> Optional[BaseAdapter]:
    """Instantiate one adapter by id (reference adapters.ts:15-56)."""
    cfg: dict[str, Any] = config.adapter_config.get(adapter_id, {})

    if adapter_id == "claude-cli":
        from .cli_adapters import ClaudeCliAdapter
        return ClaudeCliAdapter(cfg.get("command", "claude"), timeout_ms)
    if adapter_id == "gemini-cli":
        from .cli_adapters import GeminiCliAdapter
        return GeminiCliAdapter(cfg.get("command", "gemini"),
                                cfg.get("model"), timeout_ms)
    if adapter_id == "openai-cli":
        from .cli_adapters import OpenAICliAdapter
        return OpenAICliAdapter(cfg.get("command", "codex"), timeout_ms)
    if adapter_id == "claude-api":
        from .api_adapters import ClaudeApiAdapter
        return ClaudeApiAdapter(cfg.get("model", "claude-sonnet-4-6"),
                                cfg.get("env_key", "ANTHROPIC_API_KEY"),
                                timeout_ms)
    if adapter_id == "gemini-api":
        from .api_adapters import GeminiApiAdapter
        return GeminiApiAdapter(cfg.get("model", "gemini-2.5-flash"),
                                cfg.get("env_key", "GEMINI_API_KEY"),
                                timeout_ms)
    if adapter_id == "openai-api":
        from .api_adapters import OpenAIApiAdapter
        return OpenAIApiAdapter(cfg.get("model", "gpt-5.2"),
                                cfg.get("env_key", "OPENAI_API_KEY"),
                                timeout_ms)
    if adapter_id.startswith("local-llm"):
        from .local_llm import LocalLlmAdapter
        if not cfg.get("endpoint") or not cfg.get("model"):
            return None
        return LocalLlmAdapter(
            endpoint=cfg["endpoint"], model=cfg["model"],
            name=cfg.get("name", adapter_id), source=cfg.get("source"),
            timeout_ms=timeout_ms)
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

    on_event(kind, message): "seated" | "fallback" | "unavailable" notices
    for the command layer to display. Engine knights run on `device`.
    """
    timeout_ms = config.rules.timeout_per_turn_seconds * 1000
    adapters: dict[str, BaseAdapter] = {}

    _plan_engine_fleet(config, on_event, device)

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

        # Init-time CLI→API fallback (reference adapters.ts:89-100).
        api_id = _CLI_TO_API.get(adapter_id)
        if api_id:
            api_adapter = create_adapter(api_id, config, timeout_ms, device)
            if api_adapter is not None and api_adapter.is_available():
                adapters[adapter_id] = api_adapter
                if on_event:
                    on_event("fallback",
                             f"{knight.name}: {adapter_id} unavailable, "
                             f"seated via {api_id}")
                continue
        if on_event:
            on_event("unavailable",
                     f"{knight.name} ({adapter_id}) is unavailable")
    return adapters


def _plan_engine_fleet(config: RoundtableConfig,
                       on_event: Optional[Callable[[str, str], None]],
                       device="cuda") -> None:
    """Heterogeneous serving (the JAX package's _plan_tpu_fleet): when
    several engine knights use DIFFERENT models, plan their device groups
    and fit before any engine is built (engine/fleet.plan_fleet, against
    `device`'s memory). Unconfigured engine ids get a dict inserted into
    the config map, so the plan reaches their adapters. Homogeneous setups
    and configs with an explicit mesh or devices are untouched. A planning
    failure is a notice, not an error: the engines then share the
    devices unplanned, and the operator hears why."""
    engine_cfgs = []
    for knight in config.knights:
        if is_engine_adapter(knight.adapter):
            cfg = config.adapter_config.setdefault(knight.adapter, {})
            if isinstance(cfg, dict):
                engine_cfgs.append(cfg)
    if len(engine_cfgs) < 2:
        return
    try:
        from ..engine.fleet import plan_fleet
        plan_fleet(engine_cfgs, device=device)
    except Exception as e:  # noqa: BLE001 - the engines still run, but the
        # operator must hear that planning failed: otherwise the symptom is
        # an unexplained out-of-memory at weight load.
        if on_event:
            on_event("unavailable",
                     f"fleet planning failed ({e}); engines will share "
                     f"the full device mesh")


def _post_init(adapter: BaseAdapter) -> None:
    """Context-window detection for adapters that support it
    (reference adapters.ts:78-83)."""
    detect = getattr(adapter, "detect_context_window", None)
    if callable(detect):
        try:
            detect()
        except Exception:
            pass
