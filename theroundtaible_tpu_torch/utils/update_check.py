"""Non-blocking package-update check, silent on any failure.

Parity with reference src/utils/update-check.ts:8-51 (npm registry check with
a 3s abort): we query PyPI for the latest published version and compare.
Runs in a daemon thread so CLI startup is never delayed; result is delivered
via callback only if a newer version exists.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Callable, Optional

from .. import __version__

CHECK_TIMEOUT_SECONDS = 3
PYPI_URL = "https://pypi.org/pypi/theroundtaible-tpu/json"


def _parse_version(v: str) -> tuple[int, ...]:
    parts = []
    for piece in v.split("."):
        digits = "".join(ch for ch in piece if ch.isdigit())
        parts.append(int(digits) if digits else 0)
    return tuple(parts)


def _is_newer(latest: str, current: str) -> bool:
    return _parse_version(latest) > _parse_version(current)


def _check(on_update: Callable[[str, str], None]) -> None:
    try:
        with urllib.request.urlopen(PYPI_URL,
                                    timeout=CHECK_TIMEOUT_SECONDS) as resp:
            data = json.loads(resp.read().decode("utf-8"))
        latest = data.get("info", {}).get("version", "")
        if latest and _is_newer(latest, __version__):
            on_update(__version__, latest)
    except Exception:
        pass  # silent by design — never disturb the CLI


def check_for_update(on_update: Callable[[str, str], None]
                     ) -> Optional[threading.Thread]:
    """Fire-and-forget update check (reference update-check.ts:8-39)."""
    t = threading.Thread(target=_check, args=(on_update,), daemon=True)
    t.start()
    return t
