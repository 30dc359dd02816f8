"""MCP data layer: FastMCP-style server + JSON-RPC 2.0 envelopes.

Mirrors Anthropic's python-sdk surface that the paper builds on: developers
declare tools with ``@mcp.tool()``; the server answers ``initialize``,
``tools/list`` and ``tools/call`` JSON-RPC requests. Transport here is the
FaaS invoke path (the paper wraps servers in Lambda Function URLs).
"""
from __future__ import annotations

import dataclasses
import inspect
import typing
from typing import Any, Callable, Dict, List, Optional

MCP_PROTOCOL_VERSION = "2025-06-18"


@dataclasses.dataclass
class ToolDef:
    name: str
    fn: Callable
    description: str
    params: Dict[str, str]                   # name -> type string
    is_async: bool = False
    # deterministic latency model: base + per-byte scan cost (simulated)
    base_latency_s: float = 0.05
    per_kb_s: float = 0.0
    cacheable: bool = True
    ttl_s: float = -1.0                      # -1 = infinite TTL; 0 = no caching

    def schema(self) -> dict:
        return {"name": self.name, "description": self.description,
                "inputSchema": {"type": "object", "properties": {
                    k: {"type": v} for k, v in self.params.items()}}}


class FastMCP:
    """Minimal FastMCP-compatible server interface."""

    def __init__(self, name: str, *, memory_mb: int = 512):
        self.name = name
        self.memory_mb = memory_mb
        self.tools: Dict[str, ToolDef] = {}

    def tool(self, *, description: str = "", base_latency_s: float = 0.05,
             per_kb_s: float = 0.0, cacheable: bool = True, ttl_s: float = -1.0):
        def deco(fn):
            hints = typing.get_type_hints(fn)
            params = {p: getattr(hints.get(p, str), "__name__", "string")
                      for p in inspect.signature(fn).parameters if p != "ctx"}
            self.tools[fn.__name__] = ToolDef(
                name=fn.__name__, fn=fn,
                description=description or (fn.__doc__ or "").strip().split("\n")[0],
                params=params, is_async=inspect.iscoroutinefunction(fn),
                base_latency_s=base_latency_s, per_kb_s=per_kb_s,
                cacheable=cacheable, ttl_s=ttl_s)
            return fn
        return deco

    # ---- JSON-RPC 2.0 data layer ----------------------------------------
    def handle_rpc(self, request: dict, runtime=None) -> dict:
        rid = request.get("id")
        method = request.get("method")
        try:
            if method == "initialize":
                result = {"protocolVersion": MCP_PROTOCOL_VERSION,
                          "serverInfo": {"name": self.name, "version": "1.0"},
                          "capabilities": {"tools": {}}}
            elif method == "tools/list":
                result = {"tools": [t.schema() for t in self.tools.values()]}
            elif method == "tools/call":
                params = request.get("params", {})
                tool = self.tools.get(params.get("name", ""))
                if tool is None:
                    raise KeyError(f"unknown tool {params.get('name')!r}")
                args = params.get("arguments", {})
                out = _run_tool(tool, args, runtime)
                result = {"content": [{"type": "text", "text": str(out)}],
                          "structuredContent": out if isinstance(out, dict) else None,
                          "isError": False}
            else:
                raise ValueError(f"unknown method {method!r}")
            return {"jsonrpc": "2.0", "id": rid, "result": result}
        except Exception as e:  # noqa: BLE001 — JSON-RPC error envelope
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": -32000, "message": f"{type(e).__name__}: {e}"}}


def _run_tool(tool: ToolDef, args: dict, runtime) -> Any:
    """Execute a tool, resolving async and injecting the runtime ctx."""
    kwargs = dict(args)
    if "ctx" in inspect.signature(tool.fn).parameters:
        kwargs["ctx"] = runtime
    if tool.is_async:
        import asyncio
        return asyncio.get_event_loop().run_until_complete(tool.fn(**kwargs))
    return tool.fn(**kwargs)


def rpc_call(name: str, arguments: dict, rid: int = 1) -> dict:
    return {"jsonrpc": "2.0", "id": rid, "method": "tools/call",
            "params": {"name": name, "arguments": arguments}}


def rpc_tools_list(rid: int = 1) -> dict:
    return {"jsonrpc": "2.0", "id": rid, "method": "tools/list"}
