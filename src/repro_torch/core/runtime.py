"""FameRuntime: the assembled FAME stack (Fig. 2).

Wires the FaaS platform, object/KV stores, agent memory, MCP cache, LLM
backends, the three ReAct agent functions and the Step-Functions machine; and
runs multi-turn client sessions under any Table-1 memory configuration.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core import config as cfg_mod
from repro_torch.core.agents import ReActAgents
from repro_torch.core.faas import FaaSPlatform, FunctionDef
from repro_torch.core.fusion import DeploymentPlan, plan_consolidated, plan_singleton
from repro_torch.core.kvstore import KVStore
from repro_torch.core.llm import LLMBackend, ScriptedOracle
from repro_torch.core.memory import AgentMemory
from repro_torch.core.objectstore import ObjectStore
from repro_torch.core.telemetry import Trace, use_trace
from repro_torch.core.toolcache import CacheManager
from repro_torch.core.workflow import build_react_machine
from repro_torch.core.wrapper import WrappedServer, wrap_server


@dataclasses.dataclass
class SessionResult:
    responses: List[str]
    statuses: List[str]
    traces: List[Trace]
    t_end: float

    @property
    def dnf(self) -> bool:
        return any(s != "SUCCEEDED" for s in self.statuses)


class FameRuntime:
    def __init__(self, *, config: cfg_mod.MemoryConfig,
                 llm_backends: Optional[Dict[str, LLMBackend]] = None,
                 fusion_mode: str = "singleton",
                 max_iterations: int = 3,
                 agent_memory_mb: int = 512):
        self.config = config
        self.platform = FaaSPlatform()
        self.objects = ObjectStore()
        self.kv = KVStore()
        self.memory = AgentMemory(self.kv, enabled=config.agentic_memory)
        self.cache = CacheManager(self.objects, enabled=config.mcp_caching)
        self.fusion_mode = fusion_mode
        self.max_iterations = max_iterations
        self._llms = llm_backends or {}
        self._default_llm = ScriptedOracle()
        self.mcp_plan: Optional[DeploymentPlan] = None
        self._wrapped: List[WrappedServer] = []
        self._invocation_counter = itertools.count(1)

        agents = ReActAgents(self)
        for name, handler in [("fame-planner", agents.planner_handler),
                              ("fame-actor", agents.actor_handler),
                              ("fame-evaluator", agents.evaluator_handler)]:
            self.platform.deploy(FunctionDef(name=name, handler=handler,
                                             memory_mb=agent_memory_mb,
                                             role="agent"))
        self.machine = build_react_machine(
            self.platform, planner_fn="fame-planner", actor_fn="fame-actor",
            evaluator_fn="fame-evaluator", max_iterations=max_iterations)

    # ---- LLM backends ------------------------------------------------------
    def llm(self, role: str) -> LLMBackend:
        return self._llms.get(role, self._default_llm)

    def set_llm(self, role: str, backend: LLMBackend):
        self._llms[role] = backend

    # ---- MCP deployment (§3.3) ---------------------------------------------
    def deploy_mcp(self, servers: Sequence, sources: Optional[Dict[str, str]] = None):
        """Wrap (FAME automation) + deploy per the fusion mode."""
        self._wrapped = [
            wrap_server(s, source=(sources or {}).get(s.name),
                        cache=self.cache, fame_runtime=self)
            for s in servers]
        if self.fusion_mode == "consolidated":
            self.mcp_plan = plan_consolidated(self._wrapped, "mcp-consolidated")
        else:
            self.mcp_plan = plan_singleton(self._wrapped)
        for fn in self.mcp_plan.functions:
            self.platform.deploy(fn)

    def mcp_function_names(self) -> List[str]:
        return [f.name for f in (self.mcp_plan.functions if self.mcp_plan else [])]

    def resolve_tool_function(self, tool: str) -> str:
        return self.mcp_plan.tool_to_function[tool]

    # ---- client sessions (multi-turn, §3.2 / Fig. 3) -------------------------
    def run_session(self, session_id: str, queries: Sequence[str],
                    t: float = 0.0) -> SessionResult:
        responses, statuses, traces = [], [], []
        client_history = ""
        for qi, query in enumerate(queries):
            invocation_id = f"inv{next(self._invocation_counter):04d}"
            payload = {
                "session_id": session_id,
                "invocation_id": invocation_id,
                "user_request": query,
                "iteration": 1,
                "max_iterations": self.max_iterations,
                "client_history": client_history if self.config.client_memory else "",
                "messages": [],
            }
            trace = Trace()
            with use_trace(trace):
                payload, t, status = self.machine.execute(payload, t)
            response = payload.get("result_json", "")
            responses.append(response)
            statuses.append(status)
            traces.append(trace)
            if self.config.client_memory:
                # naive cumulative transcript (config N and richer)
                client_history += f"\n[user] {query}\n[assistant] {response}"
        return SessionResult(responses, statuses, traces, t)
