"""A frozen copy of the word-level hash tokenizer that the MiniLM
configuration assumes in place of WordPiece: lower-cased words and single
punctuation marks, each hashed with BLAKE2b (16-byte digest) into ids
4 .. vocab - 1 (0 .. 3 are reserved).  Written from its definition, so the
reference tokenizes without the program."""

from __future__ import annotations

import hashlib
import re

_WORD = re.compile(r"\w+|[^\w\s]")


def _ser_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return b"S" + len(b).to_bytes(8, "little") + b


def token_id(word: str, vocab_size: int) -> int:
    d = hashlib.blake2b(_ser_str("#tok") + _ser_str(word),
                        digest_size=16).digest()
    return 4 + int.from_bytes(d, "little") % (vocab_size - 4)


def encode(text: str, vocab_size: int) -> list[int]:
    return [token_id(w, vocab_size) for w in _WORD.findall(text.lower())]
