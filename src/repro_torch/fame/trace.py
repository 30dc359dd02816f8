"""Serving-side accounting for the FAME workflow runtime.

The simulated-clock telemetry in ``core/telemetry.py`` keeps working unchanged
(agent handlers still emit ``faas``/``mcp``/``llm`` spans); this module adds
the *real-server* side of the story: one ``TurnRecord`` per request submitted
to the ``LLMServer`` — agent turns and tool-stream injections alike — plus
stat-snapshot deltas so a benchmark cell can attribute server counters
(turn_prefix_hits, prefix_hit_tokens, …) to itself even when many cells share
one warm server.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

TERMINAL = ("completed", "failed", "timed_out", "cancelled", "shed")


@dataclasses.dataclass
class TurnRecord:
    kind: str                   # "turn" (agent call) | "inject" (tool stream)
    role: str                   # planner/actor/evaluator or tool name
    chain_id: str
    rid: int
    status: str                 # terminal RequestStatus value
    error_type: str = ""        # taxonomy class name when failed/timed_out
    prompt_tokens: int = 0      # tokens the engine saw for this request
    billed_tokens: int = 0      # client-billed input tokens (delta for
                                # session continuations, full prompt else)
    prefix_hit_tokens: int = 0  # served from radix pages / session tail
    output_tokens: int = 0
    wall_s: float = 0.0
    session_turn: int = 0       # 1-based turn index within the chain session
                                # (0 for sessionless submits)
    continuation: bool = False  # prompt extended the retained session tail
    cache_hit: Optional[bool] = None   # injections only

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL


class ServingMeter:
    """Collects TurnRecords and exposes the invariants the CI gate asserts."""

    def __init__(self, server=None):
        self.server = server
        self.records: List[TurnRecord] = []

    def record(self, rec: TurnRecord):
        self.records.append(rec)

    # ---- snapshots ---------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        return dict(self.server.stats()) if self.server else {}

    @staticmethod
    def delta(before: Dict[str, float], after: Dict[str, float]
              ) -> Dict[str, float]:
        out = {}
        for k, v in after.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                prev = before.get(k, 0)
                out[k] = v - prev if isinstance(prev, (int, float)) else v
        return out

    # ---- invariants --------------------------------------------------------
    def all_terminal(self) -> bool:
        return all(r.terminal for r in self.records)

    def turns(self, kind: str = "turn") -> List[TurnRecord]:
        return [r for r in self.records if r.kind == kind]

    def billed_in_tokens(self) -> int:
        return sum(r.billed_tokens for r in self.records)

    def continuation_turns(self) -> List[TurnRecord]:
        return [r for r in self.turns() if r.continuation]

    def tail_reuse_ok(self, slack: int = 2) -> bool:
        """Every session-continuation turn was admitted off reused state:
        the engine re-prefilled only (about) the delta, never the history.
        prefix_hit_tokens covers tail restore + radix, so a continuation
        that re-prefilled its history would show hits << prompt - billed."""
        for r in self.continuation_turns():
            if r.prefix_hit_tokens < r.prompt_tokens - r.billed_tokens - slack:
                return False
        return True

    def injection_radix_ok(self, page_size: int, suffix_slack: int = 16
                           ) -> bool:
        """Every cache-hit tool injection radix-hit its earlier stream
        instead of re-prefilling: hits reach within ~2 pages + the ack
        suffix of the full prompt (radix matches whole pages only)."""
        for r in self.records:
            if r.kind == "inject" and r.cache_hit:
                floor = r.prompt_tokens - 2 * page_size - suffix_slack
                if r.prefix_hit_tokens < floor or r.prefix_hit_tokens <= 0:
                    return False
        return True

    def summary(self) -> dict:
        turns = self.turns()
        injects = self.turns("inject")
        return {
            "turns": len(turns),
            "injections": len(injects),
            "cache_hit_injections": sum(1 for r in injects if r.cache_hit),
            "continuation_turns": len(self.continuation_turns()),
            "billed_in_tokens": self.billed_in_tokens(),
            "prompt_tokens": sum(r.prompt_tokens for r in self.records),
            "prefix_hit_tokens": sum(r.prefix_hit_tokens
                                     for r in self.records),
            "output_tokens": sum(r.output_tokens for r in self.records),
            "wall_s": sum(r.wall_s for r in self.records),
            "statuses": sorted({r.status for r in self.records}),
            "error_types": sorted({r.error_type for r in self.records
                                   if r.error_type}),
            "all_terminal": self.all_terminal(),
        }


def write_artifact(path: str, payload: dict):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True, default=str)
    print(f"wrote {path}")
