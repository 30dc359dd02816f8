"""FaaS platform runtime (AWS-Lambda-like), on a deterministic simulated clock.

Function bodies are REAL Python callables; the platform models the serverless
control plane around them: micro-VM instance pools, cold starts, retention
reclaim, per-GB-ms billing, the 15-minute timeout, concurrency autoscaling and
straggler mitigation (speculative re-execution past a latency deadline).

Time model: ``invoke(fn, payload, t)`` executes the handler immediately in
wall time but advances *simulated* time by cold-start + declared/derived
handler durations (handlers charge work via ``Ctx.charge(seconds)``).
Recursive invokes compose causally; concurrent workloads (e.g. the §5.3.2
1-RPS consolidation experiment) share instance pools across chains.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.pricing import PRICING
from repro_torch.core.telemetry import emit


class FaaSTimeout(Exception):
    pass


@dataclasses.dataclass
class FunctionDef:
    name: str
    handler: Callable                       # handler(payload: dict, ctx: Ctx) -> dict
    memory_mb: int = 512
    timeout_s: float = 900.0                # the 15-minute Lambda cap (§3.1)
    cold_start_s: float = 1.2               # micro-VM boot + runtime import
    init_extra_s: float = 0.0               # package-size-dependent init (fusion!)
    retention_s: float = 600.0              # warm-container retention period
    role: str = "generic"                   # agent | mcp | generic (for billing split)


@dataclasses.dataclass
class _Instance:
    busy_until: float
    last_used: float


class Ctx:
    """Execution context passed to handlers."""

    def __init__(self, platform: "FaaSPlatform", fn: FunctionDef, t_start: float):
        self.platform = platform
        self.fn = fn
        self.t = t_start                    # simulated time cursor
        self.charged = 0.0

    def charge(self, seconds: float):
        """Advance simulated execution time inside the handler."""
        self.t += max(0.0, seconds)
        self.charged += max(0.0, seconds)

    def now(self) -> float:
        return self.t

    def invoke(self, fn_name: str, payload: dict) -> dict:
        """Synchronous downstream invocation (network hop included)."""
        self.t += self.platform.network_hop_s
        result, t_end = self.platform.invoke(fn_name, payload, self.t)
        self.t = t_end + self.platform.network_hop_s
        return result


class FaaSPlatform:
    def __init__(self, *, network_hop_s: float = 0.015,
                 straggler_deadline_s: Optional[float] = None,
                 straggler_slowdown: float = 1.0):
        self.functions: Dict[str, FunctionDef] = {}
        self.instances: Dict[str, List[_Instance]] = {}
        self.network_hop_s = network_hop_s
        self.stats: Dict[str, Dict[str, float]] = {}
        # fault-injection knobs for tests / straggler-mitigation demo
        self.straggler_deadline_s = straggler_deadline_s
        self.straggler_slowdown = straggler_slowdown
        self._fail_next: Dict[str, int] = {}

    # ---- deployment ------------------------------------------------------
    def deploy(self, fn: FunctionDef):
        if fn.name in self.functions:
            raise ValueError(f"function {fn.name!r} already deployed")
        self.functions[fn.name] = fn
        self.instances[fn.name] = []
        self.stats[fn.name] = {"invocations": 0, "cold_starts": 0,
                               "gb_s": 0.0, "cost_cents": 0.0, "errors": 0,
                               "speculative_retries": 0}

    def undeploy(self, name: str):
        self.functions.pop(name, None)
        self.instances.pop(name, None)

    # ---- fault injection (tests) -----------------------------------------
    def inject_failures(self, fn_name: str, count: int):
        self._fail_next[fn_name] = self._fail_next.get(fn_name, 0) + count

    # ---- invocation -------------------------------------------------------
    def _acquire_instance(self, fn: FunctionDef, t: float):
        """Returns (instance, is_cold, t_ready)."""
        pool = self.instances[fn.name]
        # reclaim expired containers
        pool[:] = [i for i in pool if t - i.last_used <= fn.retention_s]
        for inst in pool:
            if inst.busy_until <= t:
                return inst, False, t
        inst = _Instance(busy_until=t, last_used=t)
        pool.append(inst)
        return inst, True, t + fn.cold_start_s + fn.init_extra_s

    def invoke(self, fn_name: str, payload: dict, t: float,
               _speculative: bool = False) -> tuple:
        """Returns (result_dict, t_end)."""
        fn = self.functions.get(fn_name)
        if fn is None:
            raise KeyError(f"no function {fn_name!r} deployed")
        st = self.stats[fn_name]
        st["invocations"] += 1

        inst, cold, t_ready = self._acquire_instance(fn, t)
        if cold:
            st["cold_starts"] += 1

        if self._fail_next.get(fn_name, 0) > 0:
            self._fail_next[fn_name] -= 1
            st["errors"] += 1
            # platform-level retry after backoff (fault tolerance)
            emit("faas", fn_name, t, t_ready + 0.1, role=fn.role, error=True,
                 cold_start=cold)
            return self.invoke(fn_name, payload, t_ready + 0.2)

        ctx = Ctx(self, fn, t_ready)
        result = fn.handler(payload, ctx)
        duration = ctx.t - t_ready
        if duration > fn.timeout_s:
            st["errors"] += 1
            emit("faas", fn_name, t, t_ready + fn.timeout_s, role=fn.role,
                 timeout=True, cold_start=cold)
            raise FaaSTimeout(f"{fn_name} exceeded {fn.timeout_s}s "
                              f"(ran {duration:.1f}s simulated)")

        # straggler mitigation: if this invocation ran past the deadline,
        # launch a speculative duplicate and take the earlier finisher.
        if (self.straggler_deadline_s is not None and not _speculative
                and duration > self.straggler_deadline_s):
            st["speculative_retries"] += 1
            spec_result, spec_end = self.invoke(
                fn_name, payload, t + self.straggler_deadline_s, _speculative=True)
            if spec_end < ctx.t:
                result, ctx.t = spec_result, spec_end

        inst.busy_until = ctx.t
        inst.last_used = ctx.t
        exec_s = ctx.t - t_ready
        cost = PRICING.lambda_cost(fn.memory_mb, exec_s)
        st["gb_s"] += fn.memory_mb / 1024.0 * exec_s
        st["cost_cents"] += cost
        emit("faas", fn_name, t, ctx.t, role=fn.role, cold_start=cold,
             exec_s=exec_s, cost_cents=cost, memory_mb=fn.memory_mb)
        return result, ctx.t
