"""Terminal UI helpers — colors, spinners, knight theming.

Covers the reference's chalk/ora usage (src/orchestrator.ts:225-265, 428-491):
personality round headers, per-knight colors and thinking messages, score
bars. ANSI codes are emitted only when stdout is a TTY (or FORCE_COLOR is
set), so logs and tests stay clean.
"""

from __future__ import annotations

import os
import random
import sys
import threading
import time
from typing import Optional


def _want_color() -> bool:
    if os.environ.get("NO_COLOR"):
        return False
    if os.environ.get("FORCE_COLOR"):
        return True
    return sys.stdout.isatty()


class _Style:
    def __init__(self, enabled: bool):
        self.enabled = enabled

    def _wrap(self, code: str, text: str) -> str:
        if not self.enabled:
            return text
        return f"\x1b[{code}m{text}\x1b[0m"

    def bold(self, t: str) -> str: return self._wrap("1", t)
    def dim(self, t: str) -> str: return self._wrap("2", t)
    def red(self, t: str) -> str: return self._wrap("31", t)
    def green(self, t: str) -> str: return self._wrap("32", t)
    def yellow(self, t: str) -> str: return self._wrap("33", t)
    def blue(self, t: str) -> str: return self._wrap("34", t)
    def cyan(self, t: str) -> str: return self._wrap("36", t)
    def white(self, t: str) -> str: return self._wrap("37", t)

    def rgb(self, hexcode: str, t: str) -> str:
        if not self.enabled:
            return t
        r, g, b = (int(hexcode[i:i + 2], 16) for i in (1, 3, 5))
        return f"\x1b[38;2;{r};{g};{b}m{t}\x1b[0m"


style = _Style(_want_color())

# Per-knight theming (reference orchestrator.ts:428-434).
KNIGHT_COLORS = {"Claude": "#D97706", "Gemini": "#3B82F6", "GPT": "#10B981"}

# Thinking messages (reference orchestrator.ts:225-252) — my own phrasing.
THINKING_MESSAGES: dict[str, list[str]] = {
    "Claude": [
        "polishes an elegant rebuttal...",
        "is refactoring the argument itself...",
        "sighs at the proposed shortcut...",
        "sketches the clean abstraction...",
    ],
    "Gemini": [
        "zooms out to the bigger picture...",
        "drafts a roadmap for the roadmap...",
        "aligns the strategy...",
        "plans three moves ahead...",
    ],
    "GPT": [
        "wants to ship it already...",
        "trims the fat off the plan...",
        "is losing patience gracefully...",
        "reaches for the deploy button...",
    ],
}
DEFAULT_THINKING = ["is thinking...", "prepares a response..."]

ROUND_HEADERS = [
    "ROUND {n} — KNIGHTS, DRAW YOUR KEYBOARDS!",
    "ROUND {n} — SPEAK NOW, OR THE CODE SUFFERS!",
    "ROUND {n} — EGOS CLASH, COMPILERS WEEP!",
    "ROUND {n} — ONE MORE PLEA FOR SANITY!",
    "ROUND {n} — SPEAK NOW OR FOREVER HOLD YOUR MERGE CONFLICTS!",
]


def warn(text: str) -> None:
    """Styled degrade/advisory line on stderr — the ONE warning surface
    for opt-in features that must not kill a run (profiling, telemetry):
    bare print() would interleave with round output and lose the
    styling contract every other surface honors."""
    print(style.yellow(text), file=sys.stderr)


def knight_color(name: str, text: str) -> str:
    hexcode = KNIGHT_COLORS.get(name)
    return style.rgb(hexcode, text) if hexcode else style.white(text)


def thinking_message(name: str) -> str:
    msgs = THINKING_MESSAGES.get(name, DEFAULT_THINKING)
    return random.choice(msgs)


def round_header(round_num: int) -> str:
    if round_num <= len(ROUND_HEADERS):
        return ROUND_HEADERS[round_num - 1].format(n=round_num)
    return f"ROUND {round_num} — FOR KING AND CODE!"


def score_bar(score: float) -> str:
    """██████░░░░ 6/10 with traffic-light coloring (reference :475-485)."""
    filled = max(0, min(10, int(score)))
    bar = "█" * filled + "░" * (10 - filled)
    from ..core.types import format_score
    text = f"{bar} {format_score(score)}/10"
    if score >= 9:
        return style.green(text)
    if score >= 6:
        return style.yellow(text)
    return style.red(text)


class Spinner:
    """Minimal ora-equivalent: animated only on TTY, silent otherwise."""

    FRAMES = "⠋⠙⠹⠸⠼⠴⠦⠧⠇⠏"

    def __init__(self, text: str, stream=None):
        self.text = text
        self.stream = stream or sys.stdout
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._animated = self.stream.isatty()

    def __enter__(self) -> "Spinner":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def start(self) -> "Spinner":
        if self._animated:
            self._thread = threading.Thread(target=self._spin, daemon=True)
            self._thread.start()
        return self

    def _spin(self) -> None:
        i = 0
        while not self._stop.is_set():
            frame = self.FRAMES[i % len(self.FRAMES)]
            self.stream.write(f"\r{frame} {self.text}\x1b[K")
            self.stream.flush()
            i += 1
            time.sleep(0.08)

    def _clear_line(self) -> None:
        if self._animated:
            self.stream.write("\r\x1b[K")
            self.stream.flush()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1)
        self._clear_line()

    def succeed(self, text: str) -> None:
        self.stop()
        print(style.green("✔") + f" {text}")

    def fail(self, text: str) -> None:
        self.stop()
        print(style.red("✖") + f" {text}")


def ask(prompt_text: str, default: str = "") -> str:
    """Blocking stdin prompt (readline equivalent)."""
    try:
        answer = input(prompt_text).strip()
    except EOFError:
        return default
    return answer or default


def ask_yes_no(prompt_text: str, default: bool = True) -> bool:
    suffix = " [Y/n] " if default else " [y/N] "
    answer = ask(prompt_text + suffix).lower()
    if not answer:
        return default
    return answer in ("y", "yes", "j", "ja")


def ask_secret(prompt_text: str) -> str:
    """Masked secret input (reference init.ts:49-91)."""
    import getpass
    try:
        return getpass.getpass(prompt_text).strip()
    except EOFError:
        return ""
