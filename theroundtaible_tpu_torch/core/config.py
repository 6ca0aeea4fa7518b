"""Project config load + validation — `.roundtable/config.json`.

Parity with reference src/utils/config.ts:13-86.
"""

from __future__ import annotations

import json
from pathlib import Path

from .errors import ConfigError
from .types import RoundtableConfig


def config_path(project_root: str | Path) -> Path:
    return Path(project_root) / ".roundtable" / "config.json"


def load_config(project_root: str | Path) -> RoundtableConfig:
    path = config_path(project_root)
    if not path.exists():
        raise ConfigError("No .roundtable/config.json found.",
                          hint='Run "roundtable init" first.')
    try:
        raw = json.loads(path.read_text(encoding="utf-8"))
    except json.JSONDecodeError:
        raise ConfigError("Invalid config.json — could not parse JSON.",
                          hint="Check for syntax errors in .roundtable/config.json")
    validate_config_dict(raw)
    return RoundtableConfig.from_dict(raw)


def save_config(project_root: str | Path, config: RoundtableConfig) -> None:
    path = config_path(project_root)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(config.to_dict(), indent=2), encoding="utf-8")


def validate_config_dict(config: dict) -> None:
    """Field/range validation on the raw dict (reference config.ts:41-86)."""
    if not config.get("version"):
        raise ConfigError("config.json missing 'version' field.")

    knights = config.get("knights")
    if not isinstance(knights, list) or not knights:
        raise ConfigError("config.json must have at least one knight.")
    for knight in knights:
        if not knight.get("name") or not knight.get("adapter"):
            raise ConfigError(
                f"Knight missing required fields (name, adapter): "
                f"{json.dumps(knight)}")
        if not isinstance(knight.get("capabilities"), list):
            raise ConfigError(
                f"Knight \"{knight['name']}\" missing capabilities array.")
        if not isinstance(knight.get("priority"), (int, float)) \
                or isinstance(knight.get("priority"), bool):
            raise ConfigError(
                f"Knight \"{knight['name']}\" missing numeric priority.")

    rules = config.get("rules")
    if not rules:
        raise ConfigError("config.json missing 'rules' section.")
    max_rounds = rules.get("max_rounds")
    if not isinstance(max_rounds, (int, float)) or max_rounds < 1:
        raise ConfigError("rules.max_rounds must be a positive number.")
    threshold = rules.get("consensus_threshold")
    if not isinstance(threshold, (int, float)) or not 0 <= threshold <= 10:
        raise ConfigError("rules.consensus_threshold must be between 0 and 10.")
    timeout = rules.get("timeout_per_turn_seconds")
    if not isinstance(timeout, (int, float)) or timeout < 1:
        raise ConfigError("rules.timeout_per_turn_seconds must be a positive number.")
    # Time-ladder roots (optional — engine/deadlines.py): when present
    # they must be positive numbers, and a round budget must not exceed
    # the discussion budget it nests inside (the tree min()s them anyway,
    # but a config that says otherwise is a mistake worth naming).
    for key in ("discussion_budget_seconds", "round_budget_seconds"):
        value = rules.get(key)
        if value is not None and (
                not isinstance(value, (int, float))
                or isinstance(value, bool) or value <= 0):
            raise ConfigError(f"rules.{key} must be a positive number.")
    disc = rules.get("discussion_budget_seconds")
    rnd = rules.get("round_budget_seconds")
    if disc is not None and rnd is not None and rnd > disc:
        raise ConfigError(
            "rules.round_budget_seconds must not exceed "
            "rules.discussion_budget_seconds (round budgets nest inside "
            "the discussion budget).")

    if not config.get("adapter_config"):
        raise ConfigError("config.json missing 'adapter_config' section.")
