"""LangGraph-like agent graph runtime (§2 Agentic Frameworks).

Nodes are functions over a shared mutable state dict; edges connect them,
conditional edges route on a predicate; execution runs supersteps until END
or the LangGraph default limit (25). Each FAME agent (Planner / Actor /
Evaluator) is one small graph executed inside one FaaS function invocation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

END = "__end__"
START = "__start__"

SUPERSTEP_LIMIT = 25      # LangGraph's default recursion limit


class GraphRecursionError(RuntimeError):
    pass


@dataclasses.dataclass
class AgentGraph:
    name: str
    nodes: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    edges: Dict[str, str] = dataclasses.field(default_factory=dict)
    cond_edges: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    entry: Optional[str] = None

    def add_node(self, name: str, fn: Callable):
        self.nodes[name] = fn
        if self.entry is None:
            self.entry = name
        return self

    def add_edge(self, src: str, dst: str):
        if src == START:
            self.entry = dst
        else:
            self.edges[src] = dst
        return self

    def add_conditional_edge(self, src: str, router: Callable):
        """router(state) -> next node name (or END)."""
        self.cond_edges[src] = router
        return self

    def run(self, state: Dict[str, Any], ctx=None) -> Dict[str, Any]:
        node = self.entry
        steps = 0
        while node != END:
            if node is None or node not in self.nodes:
                raise KeyError(f"graph {self.name}: missing node {node!r}")
            steps += 1
            if steps > SUPERSTEP_LIMIT:
                raise GraphRecursionError(
                    f"graph {self.name} exceeded {SUPERSTEP_LIMIT} supersteps")
            updates = self.nodes[node](state, ctx) or {}
            state.update(updates)
            if node in self.cond_edges:
                node = self.cond_edges[node](state)
            else:
                node = self.edges.get(node, END)
        return state
