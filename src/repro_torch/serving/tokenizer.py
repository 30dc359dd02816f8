"""Byte-level tokenizer with a deterministic pair-merge vocabulary.

Real enough to drive the serving engine end-to-end on CPU: reversible,
vocab-size aware (fits every assigned architecture's vocab), no external
files. ids 0..255 = bytes; 256.. = greedy merges of frequent ASCII pairs;
last ids reserved for specials.
"""
from __future__ import annotations

import itertools
from typing import List

PAD, BOS, EOS = 0x100, 0x101, 0x102  # raw special points remapped per vocab

_COMMON_PAIRS = [
    "e ", " t", "th", "he", "s ", " a", "in", "d ", "er", "an", "re", "on",
    " s", "t ", "or", "en", " c", " o", "es", " p", "ar", "al", " m", "te",
    "st", " i", "ti", "at", "ng", "to", "is", " f", "ed", "it", "ou", " b",
    "ro", "ur", "ll", "ra", "el", "nd", " w", "as", "ion", "ent", "the ",
    "and ", "ing ", "tion", " of ", " in ", " to ",
]


class ByteTokenizer:
    def __init__(self, vocab_size: int):
        assert vocab_size >= 260, vocab_size
        self.vocab_size = vocab_size
        n_merges = min(len(_COMMON_PAIRS), vocab_size - 256 - 3)
        self.merges = {p: 256 + i for i, p in enumerate(_COMMON_PAIRS[:n_merges])}
        self.pad_id = vocab_size - 3
        self.bos_id = vocab_size - 2
        self.eos_id = vocab_size - 1
        # longest-first matching
        self._ordered = sorted(self.merges, key=len, reverse=True)

    def encode(self, text: str, *, bos: bool = True) -> List[int]:
        ids: List[int] = [self.bos_id] if bos else []
        i = 0
        while i < len(text):
            for p in self._ordered:
                if text.startswith(p, i):
                    ids.append(self.merges[p])
                    i += len(p)
                    break
            else:
                b = text[i].encode("utf-8", errors="replace")
                ids.extend(b if len(b) > 0 else [ord("?")])
                i += 1
        return ids

    def decode(self, ids) -> str:
        inv = {v: k for k, v in self.merges.items()}
        out: List[str] = []
        byte_run: List[int] = []

        def flush():
            if byte_run:
                out.append(bytes(byte_run).decode("utf-8", errors="replace"))
                byte_run.clear()

        for t in ids:
            t = int(t)
            if t in (self.pad_id, self.bos_id, self.eos_id):
                continue
            if t < 256:
                byte_run.append(t)
            elif t in inv:
                flush()
                out.append(inv[t])
            # unknown ids (model samples beyond mapped range): skip
        flush()
        return "".join(out)
