"""Step-Functions-style workflow orchestration (§3.1).

A state machine of Task / Choice / Succeed / Fail states executed over the
FaaS platform, with per-state retry policies (exponential backoff) and the
ReAct cycle: Planner → Actor → Evaluator → (Choice) → Succeed | Planner.
Per-transition billing matches the Step Functions pricing model.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.pricing import PRICING
from repro_torch.core.telemetry import emit


@dataclasses.dataclass
class Retry:
    max_attempts: int = 2
    backoff_s: float = 1.0
    backoff_rate: float = 2.0


@dataclasses.dataclass
class TaskState:
    name: str
    function: str                       # FaaS function name
    next: Optional[str] = None
    retry: Retry = dataclasses.field(default_factory=Retry)


@dataclasses.dataclass
class ChoiceState:
    name: str
    router: Callable[[dict], str]       # payload -> next state name


@dataclasses.dataclass
class SucceedState:
    name: str = "Succeed"


@dataclasses.dataclass
class FailState:
    name: str = "Fail"
    error: str = "WorkflowFailed"


class StateMachine:
    def __init__(self, name: str, platform, states: List[Any], start: str):
        self.name = name
        self.platform = platform
        self.states = {s.name: s for s in states}
        self.start = start

    def execute(self, payload: dict, t: float = 0.0):
        """Run to completion. Returns (payload, t_end, status)."""
        state_name = self.start
        transitions = 0
        t0 = t
        while True:
            state = self.states[state_name]
            transitions += 1
            if isinstance(state, SucceedState):
                status = "SUCCEEDED"
                break
            if isinstance(state, FailState):
                status = "FAILED"
                break
            if isinstance(state, ChoiceState):
                state_name = state.router(payload)
                continue
            # TaskState with retry policy
            attempt, backoff = 0, state.retry.backoff_s
            while True:
                try:
                    payload, t = self.platform.invoke(state.function, payload, t)
                    break
                except Exception:  # noqa: BLE001 — retry per policy, then DLQ
                    attempt += 1
                    if attempt > state.retry.max_attempts:
                        emit("workflow", f"{self.name}:{state.name}", t0, t,
                             dlq=True, cost_cents=transitions * PRICING.stepfn_transition_cents)
                        return payload, t, "FAILED"
                    t += backoff
                    backoff *= state.retry.backoff_rate
            state_name = state.next
        cost = transitions * PRICING.stepfn_transition_cents
        emit("workflow", self.name, t0, t, transitions=transitions,
             cost_cents=cost, status=status)
        return payload, t, status


def build_react_machine(platform, *, planner_fn: str, actor_fn: str,
                        evaluator_fn: str, max_iterations: int = 3) -> StateMachine:
    """The cyclic ReAct workflow of Fig. 2."""

    def route(payload: dict) -> str:
        verdict = payload.get("verdict", {})
        if verdict.get("success"):
            return "Succeed"
        if verdict.get("needs_retry") and payload.get("iteration", 1) < max_iterations:
            payload["iteration"] = payload.get("iteration", 1) + 1
            return "Planner"
        return "Fail"

    return StateMachine(
        "fame-react", platform,
        states=[
            TaskState("Planner", planner_fn, next="Actor"),
            TaskState("Actor", actor_fn, next="Evaluator"),
            TaskState("Evaluator", evaluator_fn, next="Decide"),
            ChoiceState("Decide", route),
            SucceedState(),
            FailState(),
        ],
        start="Planner")
