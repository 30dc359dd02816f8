"""WorkflowServingRuntime: the FAME stack executed on the real serving stack.

Same assembly as ``core/runtime.FameRuntime`` — FaaS platform, object/KV
stores, agent memory, MCP cache, the Step-Functions machine — but the three
agent functions are ``fame.bindings.ServingAgents``: every agent LLM call is
a real ``LLMServer`` request driven through a fusion driver, memory configs
run on persistent sessions (tail reuse), and tool results flow through
``fame.toolflow`` (cache × radix composition). Per-state ``Retry`` policies
catch the serving fault taxonomy raised by failed turns; exhausted retries
dead-letter the invocation exactly like oracle mode.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

from repro_torch.core import config as cfg_mod
from repro_torch.core.faas import FaaSPlatform, FunctionDef
from repro_torch.core.kvstore import KVStore
from repro_torch.core.llm import ScriptedOracle
from repro_torch.core.memory import AgentMemory
from repro_torch.core.objectstore import ObjectStore
from repro_torch.core.runtime import SessionResult
from repro_torch.core.telemetry import Trace, use_trace
from repro_torch.core.toolcache import CacheManager
from repro_torch.core.workflow import Retry, TaskState, build_react_machine
from repro_torch.core.wrapper import WrappedServer, wrap_server
from repro_torch.core.fusion import DeploymentPlan, plan_consolidated, plan_singleton
from repro_torch.fame.bindings import ChainBinding, ServingAgents
from repro_torch.fame.fusion import SerialDriver
from repro_torch.fame.toolflow import ToolFlow
from repro_torch.fame.trace import ServingMeter


class WorkflowServingRuntime:
    def __init__(self, *, config: cfg_mod.MemoryConfig, server,
                 driver=None, meter: Optional[ServingMeter] = None,
                 params=None, state_deadline_s: Optional[float] = None,
                 state_retry: Optional[Retry] = None,
                 fusion_mode: str = "singleton",
                 max_iterations: int = 3,
                 agent_memory_mb: int = 512,
                 stream_clip: int = 400):
        from repro_torch.serving.scheduler import SamplingParams
        self.config = config
        self.server = server
        self.driver = driver or SerialDriver(server)
        self.meter = meter or ServingMeter(server)
        self.params = params or SamplingParams(max_new_tokens=8)
        self.state_deadline_s = state_deadline_s
        self.stream_clip = stream_clip

        self.platform = FaaSPlatform()
        self.objects = ObjectStore()
        self.kv = KVStore()
        self.memory = AgentMemory(self.kv, enabled=config.agentic_memory)
        self.cache = CacheManager(self.objects, enabled=config.mcp_caching)
        self.toolflow = ToolFlow(self.driver, enabled=config.mcp_caching,
                                 meter=self.meter, clip=stream_clip)
        self.fusion_mode = fusion_mode
        self.max_iterations = max_iterations
        self._oracles: Dict[str, ScriptedOracle] = {}
        self._default_oracle = ScriptedOracle()
        self.mcp_plan: Optional[DeploymentPlan] = None
        self._wrapped: List[WrappedServer] = []
        self._invocation_counter = itertools.count(1)
        self._chains: Dict[str, ChainBinding] = {}

        agents = ServingAgents(self)
        for name, handler in [("fame-planner", agents.planner_handler),
                              ("fame-actor", agents.actor_handler),
                              ("fame-evaluator", agents.evaluator_handler)]:
            self.platform.deploy(FunctionDef(name=name, handler=handler,
                                             memory_mb=agent_memory_mb,
                                             role="agent"))
        self.machine = build_react_machine(
            self.platform, planner_fn="fame-planner", actor_fn="fame-actor",
            evaluator_fn="fame-evaluator", max_iterations=max_iterations)
        if state_retry is not None:
            for st in self.machine.states.values():
                if isinstance(st, TaskState):
                    st.retry = state_retry

    # ---- decisions (oracle-guided; see bindings docstring) -----------------
    def decide(self, role: str, system: str, context: str) -> str:
        return self._oracles.get(role, self._default_oracle)._generate(
            system, context)

    def set_llm(self, role: str, backend):
        """Accepts the apps' ScriptedOracle builders (FameRuntime parity)."""
        self._oracles[role] = backend

    def turn_params(self):
        if self.state_deadline_s is None:
            return self.params
        return dataclasses.replace(self.params,
                                   deadline_s=self.state_deadline_s)

    # ---- chains ------------------------------------------------------------
    @property
    def persistent_chains(self) -> bool:
        """§3.2 memory persistence == session tail reuse: agentic-memory
        configs (M, M+C) keep one server session per invocation chain."""
        return self.config.agentic_memory

    def chain_for(self, payload: dict) -> ChainBinding:
        chain_id = payload["session_id"]
        chain = self._chains.get(chain_id)
        if chain is None:
            chain = ChainBinding(self, chain_id,
                                 persistent=self.persistent_chains)
            self._chains[chain_id] = chain
        return chain

    def close(self):
        for chain in self._chains.values():
            chain.close()
        self._chains.clear()

    # ---- MCP deployment (§3.3) — FameRuntime parity ------------------------
    def deploy_mcp(self, servers: Sequence,
                   sources: Optional[Dict[str, str]] = None):
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
        return [f.name for f in (self.mcp_plan.functions if self.mcp_plan
                                 else [])]

    def resolve_tool_function(self, tool: str) -> str:
        return self.mcp_plan.tool_to_function[tool]

    # ---- client sessions (multi-turn, §3.2 / Fig. 3) -----------------------
    def run_session(self, session_id: str, queries: Sequence[str],
                    t: float = 0.0, close: bool = True) -> SessionResult:
        responses, statuses, traces = [], [], []
        client_history = ""
        try:
            for query in queries:
                invocation_id = f"inv{next(self._invocation_counter):04d}"
                payload = {
                    "session_id": session_id,
                    "invocation_id": invocation_id,
                    "user_request": query,
                    "iteration": 1,
                    "max_iterations": self.max_iterations,
                    "client_history": (client_history
                                       if self.config.client_memory else ""),
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
                    client_history += f"\n[user] {query}\n[assistant] {response}"
        finally:
            if close:
                self.close()
        return SessionResult(responses, statuses, traces, t)
