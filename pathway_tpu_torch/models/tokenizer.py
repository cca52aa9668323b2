"""Self-contained word-level hash tokenizer (no downloaded vocab files);
gives the same ids as ``pathway_tpu.models.tokenizer.HashTokenizer``.
``HFTokenizer`` wraps a HuggingFace tokenizer saved on the machine, for
real subword vocabularies."""

from __future__ import annotations

import re

from ..internals.value import hash_values

_WORD = re.compile(r"\w+|[^\w\s]")
_CACHE_SIZE = 1 << 18


class HashTokenizer:
    def __init__(self, vocab_size: int = 32768, lowercase: bool = True):
        self.vocab_size = vocab_size
        self.lowercase = lowercase
        # word frequency is zipfian: a bounded word->id cache removes
        # nearly all stable-hash calls on the hot path
        self._cache: dict[str, int] = {}

    def tokenize(self, text: str) -> list[str]:
        if self.lowercase:
            text = text.lower()
        return _WORD.findall(text or "")

    def _id(self, w: str) -> int:
        tid = self._cache.get(w)
        if tid is None:
            # ids 0..3 reserved (pad/unk/cls/sep)
            tid = 4 + (hash_values("#tok", w) % (self.vocab_size - 4))
            if len(self._cache) < _CACHE_SIZE:
                self._cache[w] = tid
        return tid

    def encode(self, text: str) -> list[int]:
        return [self._id(w) for w in self.tokenize(text)]

    def count_tokens(self, text: str) -> int:
        return len(self.tokenize(text))


class HFTokenizer:
    """Wrap a locally-available HuggingFace tokenizer."""

    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(name_or_path)
        self.vocab_size = self._tok.vocab_size

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def count_tokens(self, text: str) -> int:
        return len(self.encode(text))
