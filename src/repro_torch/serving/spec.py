"""Drafter-free speculative decoding: prompt n-gram lookup drafter.

The FAME workloads (research-paper summarization, log analytics) decode
outputs that heavily *copy spans from the prompt* — tool results, fetched
paper text, log lines re-surfaced in the agent's answer — so a draft model
is overkill: the next tokens are usually sitting in the context already.
``NgramDrafter`` indexes every n-gram of the request's context (truncated
prompt + generated tokens) in a host-side hash map and proposes the
continuation of the most recent earlier occurrence of the current suffix —
the "prompt lookup decoding" idiom, O(n_max) work per committed token and
zero device work.

The proposals are verified by one batched model forward
(``models.transformer.verify`` / ``extend`` for stateful archs) and accepted
by ``sampler.accept_batched`` (greedy exact-match; rejection sampling for
temperature slots, so stochastic outputs stay distribution-correct). The
engine (serving/engine.py) owns the per-slot lifecycle, including disabling
a slot's drafter when its acceptance rate drops below
``EngineConfig.spec_min_accept``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


class NgramDrafter:
    """Suffix n-gram -> continuation index over one request's token stream.

    ``_map`` keys are n-gram tuples (n in [n_min, n_max], n implicit in the
    tuple length); the value is the END index (exclusive) of the most recent
    occurrence that HAS a continuation token. The n-gram ending at the
    current stream tip is deliberately left unindexed until a further token
    arrives, so a lookup never matches itself.
    """

    def __init__(self, tokens: Sequence[int], *, n_min: int = 2,
                 n_max: int = 4):
        if not (1 <= n_min <= n_max):
            raise ValueError(f"bad ngram range [{n_min}, {n_max}]")
        self.n_min = n_min
        self.n_max = n_max
        self.toks: List[int] = []
        self._map: Dict[Tuple[int, ...], int] = {}
        self._done = 0              # n-gram endings <= _done are indexed
        self.extend(tokens)

    def extend(self, new_tokens: Sequence[int]):
        """Append committed tokens and index the n-grams they complete."""
        self.toks.extend(new_tokens)
        T = len(self.toks)
        # index endings e <= T-1 only: each indexed n-gram is guaranteed a
        # continuation token at self.toks[e]
        for e in range(max(self._done + 1, self.n_min), T):
            for n in range(self.n_min, min(self.n_max, e) + 1):
                self._map[tuple(self.toks[e - n:e])] = e
        self._done = max(self._done, T - 1)

    def draft(self, max_len: int) -> List[int]:
        """Up to ``max_len`` proposed continuation tokens (may be empty).

        Longest-suffix match first: an (n_max)-gram hit is a stronger signal
        than a shorter one, so n walks down from n_max to n_min. The most
        recent occurrence can sit near the stream tip with little lookahead
        left (a period-1 loop matches one token back), so the draft
        SELF-EXTENDS: the proposed tokens are appended to a hypothetical
        suffix and looked up again until ``max_len`` is reached or the chain
        breaks.
        """
        if max_len <= 0:
            # a clamped draft budget (tight remaining/capacity window) must
            # not index with an empty suffix below
            return []
        out: List[int] = []
        tail = list(self.toks[-self.n_max:])
        while len(out) < max_len:
            e = None
            for n in range(min(self.n_max, len(tail)), self.n_min - 1, -1):
                e = self._map.get(tuple(tail[-n:]))
                if e is not None:
                    break
            if e is None:
                break
            span = self.toks[e:e + max_len - len(out)]
            if not span:
                break
            out.extend(span)
            tail = (tail + span)[-self.n_max:]
        return out
