"""Detection of local OpenAI-compatible inference servers (counterpart of
theroundtaible_tpu/utils/local_detect.py).

Parity with reference src/utils/local-detect.ts:1-134: probe LM Studio
(localhost:1234) and Ollama (localhost:11434) `/v1/models` in parallel,
filter non-chat models, prettify ids, with an `ollama list` CLI fallback.
The port adds detection of the in-process `torch-llm` engine (a CUDA card
present) so `init` can seat an engine knight automatically, where the JAX
package probes `jax.devices()` for a TPU.
"""

from __future__ import annotations

import json
import re
import subprocess
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

LM_STUDIO_ENDPOINT = "http://localhost:1234"
OLLAMA_ENDPOINT = "http://localhost:11434"
PROBE_TIMEOUT_SECONDS = 3

# Models that are not chat models (reference local-detect.ts:35-38).
_NON_CHAT_RE = re.compile(r"embed|embedding|tts|whisper|rerank|bge-|e5-",
                          re.IGNORECASE)


@dataclass
class LocalModel:
    id: str
    name: str       # prettified display name
    endpoint: str
    source: str     # "Ollama" | "LM Studio" | "cuda"


def prettify_model_id(model_id: str) -> str:
    """qwen/qwen2.5-coder-14b → Qwen2.5 Coder 14b (reference :23-30)."""
    base = model_id.split("/")[-1]
    base = re.sub(r":latest$", "", base)
    words = re.split(r"[-_]", base)
    return " ".join(w.capitalize() if w and w[0].isalpha() else w
                    for w in words if w)


def _probe_endpoint(endpoint: str, source: str) -> list[LocalModel]:
    try:
        with urllib.request.urlopen(f"{endpoint}/v1/models",
                                    timeout=PROBE_TIMEOUT_SECONDS) as resp:
            data = json.loads(resp.read().decode("utf-8"))
    except Exception:
        return []
    models = []
    for m in data.get("data", []):
        mid = m.get("id", "")
        if not mid or _NON_CHAT_RE.search(mid):
            continue
        models.append(LocalModel(id=mid, name=prettify_model_id(mid),
                                 endpoint=endpoint, source=source))
    return models


def _ollama_cli_fallback() -> list[LocalModel]:
    """`ollama list` when the HTTP endpoint is down (reference :77-97)."""
    try:
        proc = subprocess.run(["ollama", "list"], capture_output=True,
                              text=True, timeout=PROBE_TIMEOUT_SECONDS)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if proc.returncode != 0:
        return []
    models = []
    for line in proc.stdout.splitlines()[1:]:  # skip header row
        parts = line.split()
        if not parts:
            continue
        mid = parts[0]
        if _NON_CHAT_RE.search(mid):
            continue
        models.append(LocalModel(id=mid, name=prettify_model_id(mid),
                                 endpoint=OLLAMA_ENDPOINT, source="Ollama"))
    return models


def detect_tpu_engine(timeout_s: float = 5.0) -> list[LocalModel]:
    """Report the in-tree engine as a seat-able backend when torch sees a
    CUDA card (the JAX package's probe of `jax.devices()` for a TPU; the
    name is the JAX package's).

    The first CUDA call initializes the driver, which can block on a
    wedged card, so the probe runs in a daemon thread under a timeout; on
    timeout or hosts without a card nothing is reported. The JAX package's
    switches hold: ROUNDTABLE_DISABLE_TPU_DETECT=1 skips the probe
    entirely (tests, CI), ROUNDTABLE_FORCE_TPU_DETECT=1 reports the CPU
    when there is no card."""
    import os
    import threading

    if os.environ.get("ROUNDTABLE_DISABLE_TPU_DETECT"):
        return []

    result: list[LocalModel] = []

    def probe() -> None:
        try:
            import torch
            count = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            kind = torch.cuda.get_device_name(0) if count else "CPU"
        except Exception:
            return
        if not count and not os.environ.get("ROUNDTABLE_FORCE_TPU_DETECT"):
            return  # the engine runs on CPU too, but don't auto-seat there
        result.append(LocalModel(
            id="torch-llm",
            name=f"In-tree torch engine ({kind} ×{max(count, 1)})",
            endpoint="in-process", source="cuda"))

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    return list(result)


def detect_local_models(include_tpu: bool = True) -> list[LocalModel]:
    """Parallel probe of both endpoints (reference :103-134)."""
    with ThreadPoolExecutor(max_workers=3) as pool:
        lm_f = pool.submit(_probe_endpoint, LM_STUDIO_ENDPOINT, "LM Studio")
        ol_f = pool.submit(_probe_endpoint, OLLAMA_ENDPOINT, "Ollama")
        tpu_f = pool.submit(detect_tpu_engine) if include_tpu else None
        lm = lm_f.result()
        ol = ol_f.result()
        tpu = tpu_f.result() if tpu_f else []
    if not ol:
        ol = _ollama_cli_fallback()
    return tpu + lm + ol
