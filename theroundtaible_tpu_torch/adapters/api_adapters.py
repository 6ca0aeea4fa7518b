"""Cloud HTTPS API adapters: Anthropic, Google, OpenAI.

Parity with reference src/adapters/{claude-api,gemini-api,openai-api}.ts:
key lookup via env-var-then-keystore, 16384 max output tokens, per-turn
timeout, availability = key presence.
"""

from __future__ import annotations

from ..core.errors import AdapterError, classify_error
from ..utils.keys import get_key
from .base import BaseAdapter, DEFAULT_TIMEOUT_MS
from .httpx import HttpError, post_json

MAX_OUTPUT_TOKENS = 16384


class _ApiAdapter(BaseAdapter):
    def __init__(self, name: str, model: str, env_key: str,
                 timeout_ms: int = DEFAULT_TIMEOUT_MS):
        super().__init__(name)
        self.model = model
        self.env_key = env_key
        self.default_timeout = timeout_ms

    def is_available(self) -> bool:
        key = get_key(self.env_key)
        return bool(key)

    def _require_key(self) -> str:
        key = get_key(self.env_key)
        if not key:
            raise AdapterError(
                f"{self.name} API key not set. Set {self.env_key} or run "
                f"'roundtable init'.", kind="auth")
        return key

    def _request(self, prompt: str, timeout_ms: int) -> str:
        raise NotImplementedError

    def execute(self, prompt: str, timeout_ms: int = DEFAULT_TIMEOUT_MS) -> str:
        try:
            return self._request(prompt, timeout_ms or self.default_timeout)
        except AdapterError:
            raise
        except Exception as e:
            raise AdapterError(str(e), kind=classify_error(e), cause=e)


class ClaudeApiAdapter(_ApiAdapter):
    """POST api.anthropic.com/v1/messages (reference claude-api.ts:5-74)."""

    def __init__(self, model: str = "claude-sonnet-4-6",
                 env_key: str = "ANTHROPIC_API_KEY",
                 timeout_ms: int = DEFAULT_TIMEOUT_MS):
        super().__init__("Claude", model, env_key, timeout_ms)

    def _request(self, prompt: str, timeout_ms: int) -> str:
        key = self._require_key()
        try:
            data = post_json(
                "https://api.anthropic.com/v1/messages",
                {
                    "model": self.model,
                    "max_tokens": MAX_OUTPUT_TOKENS,
                    "messages": [{"role": "user", "content": prompt}],
                },
                headers={"x-api-key": key,
                         "anthropic-version": "2023-06-01"},
                timeout_s=timeout_ms / 1000)
        except HttpError as e:
            raise AdapterError(f"Anthropic API error ({e.status}): {e.body}",
                               kind=classify_error(e))
        for part in data.get("content", []):
            if part.get("type") == "text" and part.get("text"):
                return part["text"]
        raise AdapterError("Anthropic API returned empty response", kind="api")


class GeminiApiAdapter(_ApiAdapter):
    """POST generativelanguage.googleapis.com generateContent
    (reference gemini-api.ts:5-70)."""

    def __init__(self, model: str = "gemini-2.5-flash",
                 env_key: str = "GEMINI_API_KEY",
                 timeout_ms: int = DEFAULT_TIMEOUT_MS):
        super().__init__("Gemini", model, env_key, timeout_ms)

    def _request(self, prompt: str, timeout_ms: int) -> str:
        key = self._require_key()
        url = ("https://generativelanguage.googleapis.com/v1beta/models/"
               f"{self.model}:generateContent?key={key}")
        try:
            data = post_json(url, {
                "contents": [{"parts": [{"text": prompt}]}],
                "generationConfig": {"maxOutputTokens": MAX_OUTPUT_TOKENS},
            }, timeout_s=timeout_ms / 1000)
        except HttpError as e:
            raise AdapterError(f"Gemini API error ({e.status}): {e.body}",
                               kind=classify_error(e))
        try:
            text = data["candidates"][0]["content"]["parts"][0]["text"]
        except (KeyError, IndexError, TypeError):
            text = None
        if not text:
            raise AdapterError("Gemini API returned empty response", kind="api")
        return text


class OpenAIApiAdapter(_ApiAdapter):
    """POST api.openai.com/v1/chat/completions (reference openai-api.ts:5-73)."""

    def __init__(self, model: str = "gpt-5.2",
                 env_key: str = "OPENAI_API_KEY",
                 timeout_ms: int = DEFAULT_TIMEOUT_MS):
        super().__init__("GPT", model, env_key, timeout_ms)

    def _request(self, prompt: str, timeout_ms: int) -> str:
        key = self._require_key()
        try:
            data = post_json(
                "https://api.openai.com/v1/chat/completions",
                {
                    "model": self.model,
                    "max_completion_tokens": MAX_OUTPUT_TOKENS,
                    "messages": [{"role": "user", "content": prompt}],
                },
                headers={"Authorization": f"Bearer {key}"},
                timeout_s=timeout_ms / 1000)
        except HttpError as e:
            raise AdapterError(f"OpenAI API error ({e.status}): {e.body}",
                               kind=classify_error(e))
        try:
            text = data["choices"][0]["message"]["content"]
        except (KeyError, IndexError, TypeError):
            text = None
        if not text:
            raise AdapterError("OpenAI API returned empty response", kind="api")
        return text
