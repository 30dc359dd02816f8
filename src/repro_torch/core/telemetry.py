"""Telemetry: spans, counters and per-run metric aggregation.

Every FaaS invocation, MCP call and LLM call emits a span onto the active
``Trace``; benchmarks aggregate them into the paper's figures (latency
breakdowns, token counts, cost decomposition, cache hits, tool-call counts).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Span:
    kind: str                 # faas | mcp | llm | workflow | cache | store
    name: str
    t_start: float
    t_end: float
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


@dataclasses.dataclass
class Trace:
    spans: List[Span] = dataclasses.field(default_factory=list)

    def add(self, kind, name, t_start, t_end, **attrs):
        s = Span(kind, name, t_start, t_end, attrs)
        self.spans.append(s)
        return s

    # ---- aggregations used by benchmarks -------------------------------
    def total(self, kind: str, attr: str) -> float:
        return sum(s.attrs.get(attr, 0) for s in self.spans if s.kind == kind)

    def count(self, kind: str, name_prefix: str = "") -> int:
        return sum(1 for s in self.spans
                   if s.kind == kind and s.name.startswith(name_prefix))

    def duration_of(self, kind: str, name_prefix: str = "") -> float:
        return sum(s.duration for s in self.spans
                   if s.kind == kind and s.name.startswith(name_prefix))

    def llm_tokens(self):
        i = self.total("llm", "input_tokens")
        o = self.total("llm", "output_tokens")
        return int(i), int(o)

    def cost_breakdown(self) -> Dict[str, float]:
        return {
            "llm_cents": self.total("llm", "cost_cents"),
            "faas_agent_cents": sum(s.attrs.get("cost_cents", 0) for s in self.spans
                                    if s.kind == "faas" and s.attrs.get("role") == "agent"),
            "faas_mcp_cents": sum(s.attrs.get("cost_cents", 0) for s in self.spans
                                  if s.kind == "faas" and s.attrs.get("role") == "mcp"),
            "workflow_cents": self.total("workflow", "cost_cents"),
            "store_cents": self.total("store", "cost_cents"),
        }


_tls = threading.local()


def current_trace() -> Optional[Trace]:
    return getattr(_tls, "trace", None)


@contextlib.contextmanager
def use_trace(trace: Trace):
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace
    try:
        yield trace
    finally:
        _tls.trace = prev


def emit(kind, name, t_start, t_end, **attrs):
    tr = current_trace()
    if tr is not None:
        tr.add(kind, name, t_start, t_end, **attrs)
