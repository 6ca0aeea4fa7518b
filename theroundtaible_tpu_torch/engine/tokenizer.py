"""Tokenizer layer for the engine (counterpart of
theroundtaible_tpu/engine/tokenizer.py).

- HfTokenizer: any HuggingFace tokenizer loaded from a local path via
  `transformers` - used when serving real checkpoints.
- ByteTokenizer: self-contained byte-level fallback (no downloads, exact
  round-trip) - used for random-weight runs, tests, and the chip smoke.
"""

from __future__ import annotations

from typing import Optional, Protocol


class Tokenizer(Protocol):
    bos_id: int
    eos_id: int
    pad_id: int
    vocab_size: int

    def encode(self, text: str, add_bos: bool = True) -> list[int]: ...
    def decode(self, ids: list[int]) -> str: ...


class ByteTokenizer:
    """Bytes 0-255 mapped to ids 3-258; specials pad=0, bos=1, eos=2."""

    SPECIALS = 3

    def __init__(self):
        self.pad_id = 0
        self.bos_id = 1
        self.eos_id = 2
        self.vocab_size = 256 + self.SPECIALS

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [b + self.SPECIALS for b in text.encode("utf-8")]
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: list[int]) -> str:
        # Models may carry vocab > 259; ids beyond the byte range decode to
        # nothing rather than crashing.
        data = bytes(i - self.SPECIALS for i in ids
                     if self.SPECIALS <= i < self.SPECIALS + 256)
        return data.decode("utf-8", errors="replace")


class HfTokenizer:
    """transformers-backed tokenizer from a local checkpoint directory."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer
        self._tok = AutoTokenizer.from_pretrained(path)

        # `x if x is not None` - id 0 is a legitimate special-token id in
        # several SentencePiece vocabs; `or` would silently replace it.
        def _id(value, default):
            return value if value is not None else default
        self.bos_id = _id(self._tok.bos_token_id, 1)
        self.eos_id = _id(self._tok.eos_token_id, 2)
        self.pad_id = _id(self._tok.pad_token_id, 0)
        self.vocab_size = len(self._tok)

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


_TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model",
                    "tokenizer_config.json", "spiece.model")


def load_tokenizer(checkpoint_path: Optional[str]) -> Tokenizer:
    """HF tokenizer when the checkpoint dir ships one, else byte-level.

    A checkpoint WITH tokenizer files that fail to load raises - silently
    serving a large-vocab model through the byte tokenizer would produce
    garbage with no indication why."""
    if checkpoint_path:
        from pathlib import Path
        has_files = any((Path(checkpoint_path) / f).exists()
                        for f in _TOKENIZER_FILES)
        if has_files:
            try:
                return HfTokenizer(checkpoint_path)
            except Exception as e:
                raise RuntimeError(
                    f"Checkpoint {checkpoint_path} has tokenizer files but "
                    f"they failed to load: {e}") from e
    return ByteTokenizer()
