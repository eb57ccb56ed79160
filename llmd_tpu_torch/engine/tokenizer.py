"""Tokenizers (copy of ``llmd_tpu/engine/tokenizer.py``): an offline-safe
byte-level default, and an HF tokenizer from a LOCAL path, imported only when a
path is given (``transformers`` is not a dependency of the port)."""

from __future__ import annotations

import os
from typing import Optional, Protocol


class Tokenizer(Protocol):
    bos_id: int
    eos_id: int
    vocab_size: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: list[int]) -> str: ...


class ByteTokenizer:
    """ids 0..255 = raw bytes; 256 = BOS; 257 = EOS."""

    bos_id = 256
    eos_id = 257
    vocab_size = 258

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: list[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")


class HFTokenizer:
    """transformers tokenizer loaded from a LOCAL path only."""

    def __init__(self, path: str) -> None:
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.bos_id = self._tok.bos_token_id or 0
        self.eos_id = self._tok.eos_token_id or 0
        self.vocab_size = len(self._tok)

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


def load_tokenizer(path: Optional[str] = None) -> Tokenizer:
    """The HF tokenizer at ``path`` when one is given, else the byte tokenizer."""
    if path:
        if not os.path.isdir(path):
            raise FileNotFoundError(f"tokenizer path {path!r} is not a directory")
        return HFTokenizer(path)
    return ByteTokenizer()
