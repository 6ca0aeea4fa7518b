"""Local inference-server adapter (Ollama / LM Studio).

Parity with reference src/adapters/local-llm.ts:1-249 — kept so existing
local-GPU users can run unchanged next to `torch-llm` knights:

- Ollama native /api/chat with dynamic num_ctx = est. prompt tokens + 4096
  response + 512 margin, clamped to the detected max (:95-144)
- OpenAI-compat /v1/chat/completions for LM Studio, deliberately without
  max_tokens (:150-199)
- context detection via Ollama /api/show → "*.context_length" (:205-235)
- source budget = (ctx − 4096 − 3000) × 4 chars/token, floor 2000 tokens;
  LM Studio assumed 16384 (:58-70)
- one retry after 3s on "Model reloaded" (:79-88)
- LM Studio context-overflow detection with an actionable message (:170-180)
"""

from __future__ import annotations

import math
import time
from typing import Optional

from ..core.errors import AdapterError, classify_error
from .base import BaseAdapter, DEFAULT_TIMEOUT_MS
from .httpx import HttpError, get_ok, post_json

RESPONSE_RESERVE_TOKENS = 4096
OVERHEAD_RESERVE_TOKENS = 3000
SAFETY_MARGIN_TOKENS = 512
MIN_AVAILABLE_TOKENS = 2000
LM_STUDIO_ASSUMED_CTX = 16384
CHARS_PER_TOKEN_ESTIMATE = 4


def _is_context_window_error(body: str) -> bool:
    lower = body.lower()
    return (("n_keep" in lower and "n_ctx" in lower)
            or "context length exceeded" in lower
            or "maximum context length" in lower
            or "too many tokens" in lower)


class LocalLlmAdapter(BaseAdapter):
    def __init__(self, endpoint: str, model: str, name: str,
                 source: Optional[str] = None,
                 timeout_ms: int = DEFAULT_TIMEOUT_MS):
        super().__init__(name)
        self.endpoint = endpoint.rstrip("/")
        self.model = model
        self.source = source  # "Ollama" | "LM Studio" | None
        self.default_timeout = timeout_ms
        self.detected_context_tokens: Optional[int] = None

    def is_available(self) -> bool:
        return get_ok(f"{self.endpoint}/v1/models", timeout_s=3)

    def detect_context_window(self) -> Optional[int]:
        if self.source == "Ollama":
            self.detected_context_tokens = self._detect_ollama_context()
        return self.detected_context_tokens

    def get_max_source_chars(self) -> Optional[int]:
        ctx = self.detected_context_tokens or (
            LM_STUDIO_ASSUMED_CTX if self.source == "LM Studio" else None)
        if not ctx:
            return None
        available = max(ctx - RESPONSE_RESERVE_TOKENS - OVERHEAD_RESERVE_TOKENS,
                        MIN_AVAILABLE_TOKENS)
        return available * CHARS_PER_TOKEN_ESTIMATE

    def execute(self, prompt: str, timeout_ms: int = DEFAULT_TIMEOUT_MS) -> str:
        run = (self._execute_ollama if self.source == "Ollama"
               else self._execute_openai_compat)
        try:
            return run(prompt, timeout_ms or self.default_timeout)
        except AdapterError as e:
            if "Model reloaded" in e.message:
                time.sleep(3)
                return run(prompt, timeout_ms or self.default_timeout)
            raise

    def _execute_ollama(self, prompt: str, timeout_ms: int) -> str:
        num_ctx = (math.ceil(len(prompt) / CHARS_PER_TOKEN_ESTIMATE)
                   + RESPONSE_RESERVE_TOKENS + SAFETY_MARGIN_TOKENS)
        if self.detected_context_tokens:
            num_ctx = min(num_ctx, self.detected_context_tokens)
        try:
            data = post_json(f"{self.endpoint}/api/chat", {
                "model": self.model,
                "messages": [{"role": "user", "content": prompt}],
                "stream": False,
                "options": {"num_ctx": num_ctx},
            }, timeout_s=timeout_ms / 1000)
        except HttpError as e:
            raise AdapterError(f"Ollama error ({e.status}): {e.body}",
                               kind=classify_error(e))
        except Exception as e:
            raise AdapterError(str(e), kind=classify_error(e), cause=e)
        content = (data.get("message") or {}).get("content")
        if not content:
            raise AdapterError("Ollama returned empty response", kind="api")
        return content

    def _execute_openai_compat(self, prompt: str, timeout_ms: int) -> str:
        try:
            # No max_tokens: prompt + max_tokens > ctx gets rejected outright
            # by LM Studio; let the server size the response itself.
            data = post_json(f"{self.endpoint}/v1/chat/completions", {
                "model": self.model,
                "messages": [{"role": "user", "content": prompt}],
            }, timeout_s=timeout_ms / 1000)
        except HttpError as e:
            if self.source == "LM Studio" and _is_context_window_error(e.body):
                est = math.ceil(len(prompt) / CHARS_PER_TOKEN_ESTIMATE)
                raise AdapterError(
                    f"LM Studio context window too small (prompt needs "
                    f"~{est} tokens).\n"
                    "  Fix: In LM Studio → Developer → Model Settings → "
                    "increase Context Length.\n"
                    "  Also uncheck the Response Limit, or set it higher.\n"
                    "  Note: higher context = more VRAM. Find the sweet spot "
                    "for your GPU.", kind="api")
            raise AdapterError(f"Local LLM error ({e.status}): {e.body}",
                               kind=classify_error(e))
        except Exception as e:
            raise AdapterError(str(e), kind=classify_error(e), cause=e)
        try:
            content = data["choices"][0]["message"]["content"]
        except (KeyError, IndexError, TypeError):
            content = None
        if not content:
            raise AdapterError("Local LLM returned empty response", kind="api")
        return content

    def _detect_ollama_context(self) -> Optional[int]:
        try:
            data = post_json(f"{self.endpoint}/api/show",
                             {"name": self.model}, timeout_s=5)
        except Exception:
            return None
        model_info = data.get("model_info") or {}
        for key, value in model_info.items():
            if key.endswith(".context_length") and isinstance(value, int):
                return value
        return None
