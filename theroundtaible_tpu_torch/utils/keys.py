"""Secure API key storage — `~/.theroundtaible/keys.json`, chmod 600.

Parity with reference src/utils/keys.ts:1-69. Lookup order: env var first,
then keystore.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional


def keys_dir() -> Path:
    return Path(os.environ.get("ROUNDTABLE_KEYS_DIR",
                               Path.home() / ".theroundtaible"))


def keys_file() -> Path:
    return keys_dir() / "keys.json"


def load_keys() -> dict[str, str]:
    f = keys_file()
    if not f.exists():
        return {}
    try:
        parsed = json.loads(f.read_text(encoding="utf-8"))
        return {k: v for k, v in parsed.items() if isinstance(v, str)}
    except (json.JSONDecodeError, OSError):
        return {}


def save_key(name: str, value: str) -> None:
    d = keys_dir()
    d.mkdir(parents=True, exist_ok=True)
    keys = load_keys()
    keys[name] = value
    # Create with 0600 atomically — never let the secret exist world-readable,
    # even for an instant (os.open mode applies at creation, unlike chmod-after).
    fd = os.open(keys_file(), os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w", encoding="utf-8") as fh:
        fh.write(json.dumps(keys, indent=2))
    try:
        os.chmod(keys_file(), 0o600)  # tighten pre-existing files too
        os.chmod(d, 0o700)
    except OSError:
        pass  # non-POSIX filesystems


def get_key(env_var: str) -> Optional[str]:
    """Env var wins, else keystore (reference keys.ts:54-62)."""
    from_env = os.environ.get(env_var)
    if from_env:
        return from_env
    return load_keys().get(env_var)
