"""`roundtable init` — interactive setup wizard (counterpart of
theroundtaible_tpu/commands/init.py).

Parity with reference src/commands/init.ts:225-439: reinit guard, CLI tool
detection via --version, local-model detection, per-knight seat confirmation
with fallback API-key capture (masked input, saved to the chmod-600
keystore), default rules/capabilities/adapter_config, and the `.roundtable/`
scaffold. Engine addition: when torch sees a CUDA card, the wizard offers
a `torch-llm` knight named after the card, served by the in-tree engine
(where the JAX package offers `tpu-llm` knights on a TPU).
"""

from __future__ import annotations

import json
import os
import subprocess
from pathlib import Path
from typing import Optional

from ..utils.keys import save_key
from ..utils.local_detect import detect_local_models
from ..utils.session import now_iso
from ..utils.ui import ask, ask_secret, ask_yes_no, style

# Per-tool seat definitions: (adapter id, knight name, CLI command,
# API adapter id, API env key).
CLI_TOOLS = [
    ("claude-cli", "Claude", "claude", "claude-api", "ANTHROPIC_API_KEY"),
    ("gemini-cli", "Gemini", "gemini", "gemini-api", "GEMINI_API_KEY"),
    ("openai-cli", "GPT", "codex", "openai-api", "OPENAI_API_KEY"),
]

DEFAULT_CAPABILITIES = {
    "Claude": ["architecture", "code-quality", "refactoring"],
    "Gemini": ["planning", "big-picture", "research"],
    "GPT": ["implementation", "pragmatism", "shipping"],
}

DEFAULT_RULES = {
    "max_rounds": 5,
    "consensus_threshold": 9,
    "timeout_per_turn_seconds": 120,
    "escalate_to_user_after": 3,
    "auto_execute": False,
    "ignore": [".git", "node_modules", "dist", "build", ".next"],
}


def detect_tools() -> dict[str, bool]:
    """--version probes for claude/gemini/codex (reference init.ts:96-113)."""
    available = {}
    for _, _, command, _, _ in CLI_TOOLS:
        try:
            proc = subprocess.run([command, "--version"], capture_output=True,
                                  timeout=15)
            available[command] = proc.returncode == 0
        except (OSError, subprocess.TimeoutExpired):
            available[command] = False
    return available


def _slug(model_id: str) -> str:
    import re
    return re.sub(r"[^a-z0-9]+", "-", model_id.lower()).strip("-")[:40]


def _card_knight_name(engine_name: str) -> str:
    """The engine knight's name, after the card the probe reported:
    "In-tree torch engine (NVIDIA H100 80GB HBM3 ×1)" → "H100 Sage"."""
    import re
    m = re.search(r"\((.*) ×\d+\)", engine_name)
    words = (m.group(1) if m else "").replace("NVIDIA", "").split()
    return f"{words[0] if words else 'GPU'} Sage"


def init_command(version: str, project_root: Optional[str] = None,
                 interactive: Optional[bool] = None) -> int:
    project_root = Path(project_root or os.getcwd())
    rt_dir = project_root / ".roundtable"
    if interactive is None:
        import sys
        interactive = sys.stdin.isatty()

    # Reinit guard (reference init.ts:230-239).
    if (rt_dir / "config.json").exists():
        print(style.yellow("\n  A roundtable already exists in this project."))
        if interactive and not ask_yes_no("  Re-initialize (config will be "
                                          "overwritten)?", default=False):
            print(style.dim("  Kept the existing roundtable.\n"))
            return 0
        if not interactive:
            print(style.dim("  Non-interactive: keeping existing config.\n"))
            return 0

    print(style.bold("\n  ⚔️  Welcome to TheRoundtAIble (CUDA edition)\n"))
    project_name = (ask(f"  Project name [{project_root.name}]: ",
                        project_root.name)
                    if interactive else project_root.name)
    language = (ask("  Discussion language [en]: ", "en")
                if interactive else "en")

    print(style.dim("\n  Scouting for knights...\n"))
    tools = detect_tools()
    local_models = detect_local_models()

    knights: list[dict] = []
    adapter_config: dict[str, dict] = {}
    priority = 1

    # CLI/API knights (reference init.ts:296-356).
    for adapter_id, knight_name, command, api_id, env_key in CLI_TOOLS:
        if tools.get(command):
            seat = (not interactive) or ask_yes_no(
                f"  {knight_name} ({command} CLI) is available. Seat them?",
                default=True)
            if not seat:
                continue
            knights.append({
                "name": knight_name, "adapter": adapter_id,
                "capabilities": DEFAULT_CAPABILITIES.get(knight_name, []),
                "priority": priority, "fallback": api_id,
            })
            adapter_config[adapter_id] = {"command": command, "args": []}
            adapter_config.setdefault(api_id, {"env_key": env_key})
            priority += 1
        elif interactive:
            if ask_yes_no(f"  {knight_name} CLI not found. Seat them via "
                          "API key instead?", default=False):
                key = ask_secret(f"  {env_key}: ")
                if key:
                    save_key(env_key, key)
                    print(style.dim("  Key saved to the royal keystore "
                                    "(chmod 600)."))
                knights.append({
                    "name": knight_name, "adapter": api_id,
                    "capabilities": DEFAULT_CAPABILITIES.get(knight_name, []),
                    "priority": priority,
                })
                adapter_config[api_id] = {"env_key": env_key}
                priority += 1

    # Local + engine knights (reference init.ts:359-384; the engine is our
    # addition).
    for model in local_models:
        if model.source == "cuda":
            seat = (not interactive) or ask_yes_no(
                f"  {model.name} detected. Seat an engine knight?",
                default=True)
            if not seat:
                continue
            adapter_id = "torch-llm"
            name = _card_knight_name(model.name)
            knights.append({
                "name": name, "adapter": adapter_id,
                "capabilities": ["local-inference", "cuda"],
                "priority": priority,
            })
            adapter_config[adapter_id] = {
                "name": name,
                "model": "gemma-2b-it",
                "checkpoint": "",
                "max_seq_len": 8192,
                "dtype": "bfloat16",
                "mesh": {"data": 1, "model": 1},
            }
            priority += 1
            continue
        seat = (not interactive) or ask_yes_no(
            f"  Local model {model.name} ({model.source}) detected. "
            "Seat them?", default=True)
        if not seat:
            continue
        adapter_id = f"local-llm-{_slug(model.id)}"
        knights.append({
            "name": model.name, "adapter": adapter_id,
            "capabilities": ["local-inference"],
            "priority": priority,
        })
        adapter_config[adapter_id] = {
            "endpoint": model.endpoint, "model": model.id,
            "name": model.name, "source": model.source,
        }
        priority += 1
        if model.source == "LM Studio":
            print(style.yellow(
                "  Note: set a generous Context Length in LM Studio "
                "(Developer → Model Settings) — it cannot be detected."))

    if not knights:
        print(style.yellow(
            "\n  No knights could be seated. Install claude/gemini/codex, "
            "start Ollama/LM Studio, or run on a CUDA host.\n"))
        print(style.dim("  You can edit .roundtable/config.json by hand "
                        "later — writing a config scaffold anyway.\n"))

    config = {
        "version": version,
        "project": project_name,
        "language": language,
        "knights": knights or [{
            "name": "Claude", "adapter": "claude-cli",
            "capabilities": DEFAULT_CAPABILITIES["Claude"],
            "priority": 1, "fallback": "claude-api",
        }],
        "rules": DEFAULT_RULES,
        "chronicle": ".roundtable/chronicle.md",
        "adapter_config": adapter_config or {
            "claude-cli": {"command": "claude", "args": []},
            "claude-api": {"env_key": "ANTHROPIC_API_KEY"},
        },
    }

    # Scaffold (reference init.ts:396-418).
    (rt_dir / "sessions").mkdir(parents=True, exist_ok=True)
    (rt_dir / "config.json").write_text(json.dumps(config, indent=2),
                                        encoding="utf-8")
    chronicle = rt_dir / "chronicle.md"
    if not chronicle.exists():
        chronicle.write_text(
            "# Chronicle - TheRoundtAIble\n\nBeslissingen log van dit "
            "project.\n\n---\n\n", encoding="utf-8")
    manifest = rt_dir / "manifest.json"
    if not manifest.exists():
        manifest.write_text(json.dumps(
            {"version": "1.0", "last_updated": now_iso(), "features": []},
            indent=2), encoding="utf-8")

    print(style.green(f"\n  The roundtable is ready — {len(knights)} "
                      "knight(s) seated."))
    print(style.dim(f"  Config: {rt_dir / 'config.json'}"))
    print(style.dim('  Start a discussion: roundtable discuss "your topic"\n'))
    return 0
