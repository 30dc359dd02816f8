"""Crash-safe session journal: the durable-state half of the fault layer.

A session's retained tail (partial KV tail page / end-of-generation state
snapshot, serving/scheduler.py) is device state and dies with the engine. The
journal keeps the *token-level* description of every session — the exact
conversation token stream plus its text — which is all a fresh ``LLMServer``
needs to rebuild the tail bit-identically: ``restore_sessions()`` replays the
stream through the existing ``enqueue(token_ids=)`` path, re-prefilling
``all_tokens[:-1]`` and re-capturing the tail at the exact end-of-generation
boundary. This is the paper's DynamoDB-memory analogue: conversation state
outlives the process serving it.

The journal is in-memory by default (one small record per session, updated
at each turn's finalize). Give it a ``path`` to spill JSON after every
update; ``SessionJournal.load(path)`` recovers it after a crash:

    old = SessionJournal.load("/tmp/sessions.json")
    server = LLMServer(cfg, journal_path="/tmp/sessions.json")
    sessions = server.restore_sessions(old)     # old sid -> live Session
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, List, Optional

__all__ = ["JournalEntry", "SessionJournal"]


@dataclasses.dataclass
class JournalEntry:
    """One session's replayable state as of its last finished turn.

    ``all_tokens`` is the exact (truncation-adjusted) conversation token
    stream — prompt + generated, stop-trimmed; its first ``len - 1`` tokens
    are the processed prefix, the final token the sampled-but-unconsumed
    continuation. ``text`` is the matching conversation text the next
    turn's prompt must extend.
    """
    sid: int
    text: str
    all_tokens: List[int]
    turns: int


class SessionJournal:
    """Latest-state-per-session journal with optional JSON spill.

    Records are idempotent per sid (each turn's finalize overwrites the
    session's entry); ``drop`` removes a closed session. Spill writes are
    atomic (temp file + rename) so a crash mid-spill leaves the previous
    consistent journal on disk. All mutation and the spill run under one
    re-entrant lock: the pump thread finalizes turns while caller threads
    close sessions / dump, and two concurrent atomic renames of the same
    temp file would otherwise race.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._entries: Dict[int, JournalEntry] = {}
        self._lock = threading.RLock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def record(self, sid: int, text: str, all_tokens: List[int], turns: int):
        with self._lock:
            self._entries[sid] = JournalEntry(sid, text, list(all_tokens),
                                              turns)
            if self.path:
                self._spill()

    def drop(self, sid: int):
        with self._lock:
            if self._entries.pop(sid, None) is not None and self.path:
                self._spill()

    def get(self, sid: int) -> Optional[JournalEntry]:
        with self._lock:
            return self._entries.get(sid)

    def entries(self) -> List[JournalEntry]:
        """Stable snapshot (by sid) — safe to iterate while restoring into
        a journal-keeping server."""
        with self._lock:
            return [self._entries[k] for k in sorted(self._entries)]

    # ---- persistence -------------------------------------------------------
    def _spill(self):
        self.dump(self.path)

    def dump(self, path: str):
        with self._lock:
            tmp = path + ".tmp"
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(tmp, "w") as f:
                json.dump([dataclasses.asdict(e) for e in self.entries()], f)
            os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "SessionJournal":
        j = cls()
        with open(path) as f:
            for rec in json.load(f):
                j._entries[rec["sid"]] = JournalEntry(
                    rec["sid"], rec["text"], list(rec["all_tokens"]),
                    rec["turns"])
        return j
