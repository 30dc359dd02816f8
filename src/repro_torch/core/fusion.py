"""MCP deployment planning: singleton vs consolidated functions (§3.3.2/5.3.2).

* singleton  — every MCP server gets its own Lambda with its own (minimal)
  memory setting; more cold starts, cheaper per-invocation GB-ms.
* consolidated — all servers an application uses are fused into ONE Lambda
  exposing every tool; memory = max over constituents; one warm container
  serves every tool (fewer cold starts), init is heavier (bigger package).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from repro_torch.core.faas import FunctionDef
from repro_torch.core.wrapper import WrappedServer


@dataclasses.dataclass
class DeploymentPlan:
    mode: str                              # "singleton" | "consolidated"
    functions: List[FunctionDef]
    tool_to_function: Dict[str, str]


def plan_singleton(wrapped: Sequence[WrappedServer], *,
                   cold_start_s: float = 1.2) -> DeploymentPlan:
    fns, mapping = [], {}
    for w in wrapped:
        fn = w.function_def(cold_start_s=cold_start_s)
        fns.append(fn)
        for tool in w.server.tools:
            mapping[tool] = fn.name
    return DeploymentPlan("singleton", fns, mapping)


def plan_consolidated(wrapped: Sequence[WrappedServer], name: str, *,
                      cold_start_s: float = 1.2,
                      init_extra_per_server_s: float = 0.25) -> DeploymentPlan:
    """Fuse all servers into one function; memory = max of constituents."""
    memory = max(w.server.memory_mb for w in wrapped)
    by_tool = {}
    for w in wrapped:
        for tool in w.server.tools:
            by_tool[tool] = w

    def handler(payload: dict, ctx) -> dict:
        request = payload["body"] if isinstance(payload.get("body"), dict) else payload
        method = request.get("method")
        if method == "tools/call":
            tool = (request.get("params") or {}).get("name", "")
            w = by_tool.get(tool)
            if w is None:
                return {"statusCode": 200, "body": {
                    "jsonrpc": "2.0", "id": request.get("id"),
                    "error": {"code": -32601, "message": f"unknown tool {tool!r}"}}}
            return w.lambda_handler(payload, ctx)
        # tools/list & initialize: merge across constituents
        if method == "tools/list":
            tools = []
            for w in wrapped:
                tools.extend(t.schema() for t in w.server.tools.values())
            return {"statusCode": 200, "body": {
                "jsonrpc": "2.0", "id": request.get("id"),
                "result": {"tools": tools}}}
        return wrapped[0].lambda_handler(payload, ctx)

    fn = FunctionDef(name=name, handler=handler, memory_mb=memory,
                     cold_start_s=cold_start_s,
                     init_extra_s=init_extra_per_server_s * (len(wrapped) - 1),
                     role="mcp")
    mapping = {tool: name for tool in by_tool}
    return DeploymentPlan("consolidated", [fn], mapping)
