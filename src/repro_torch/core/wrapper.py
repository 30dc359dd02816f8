"""FAME's automated FaaS wrapper for MCP servers (§3.3.1).

``@fame.wrapper()`` + ``wrap_server(source)``: parses a FastMCP ``server.py``
module with ``ast``, detects ``@mcp.tool()``-decorated functions (sync and
async), and GENERATES the Lambda-compatible wrapper module: a
``lambda_handler`` entry point that routes MCP JSON-RPC over the function URL
to the embedded server, plus telemetry and cache-manager hooks. The generated
source is real, inspectable code (``WrappedServer.wrapper_source``), mirroring
the paper's codegen around ``aws.mcp-lambda-handler``.
"""
from __future__ import annotations

import ast
import dataclasses
import textwrap
from typing import Dict, List, Optional

from repro_torch.core import mcp as mcp_mod
from repro_torch.core.faas import FunctionDef
from repro_torch.core.mcp import FastMCP
from repro_torch.core.telemetry import emit
from repro_torch.core.toolcache import CacheManager


def fame_wrapper():
    """The ``@fame.wrapper()`` marker decorator (no-op at definition time)."""
    def deco(fn):
        fn.__fame_wrapped__ = True
        return fn
    return deco


@dataclasses.dataclass
class ParsedServer:
    imports: List[str]
    constants: List[str]
    tool_names: List[str]
    async_tools: List[str]
    helper_functions: List[str]
    server_var: str


def parse_server_source(source: str) -> ParsedServer:
    """AST pass: find imports, constants, tool functions and helpers."""
    tree = ast.parse(source)
    imports, constants, helpers, tools, async_tools = [], [], [], [], []
    server_var = "mcp"
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            imports.append(ast.unparse(node))
        elif isinstance(node, ast.Assign):
            src = ast.unparse(node)
            if "FastMCP(" in src:
                server_var = node.targets[0].id  # type: ignore[attr-defined]
            else:
                constants.append(src)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            decos = [ast.unparse(d) for d in node.decorator_list]
            if any(".tool(" in d or d.endswith(".tool") for d in decos):
                tools.append(node.name)
                if isinstance(node, ast.AsyncFunctionDef):
                    async_tools.append(node.name)
            else:
                helpers.append(node.name)
    return ParsedServer(imports, constants, tools, async_tools, helpers, server_var)


WRAPPER_TEMPLATE = '''\
# --- generated by FAME (do not edit) ---------------------------------------
# Lambda entry point wrapping MCP server {server_name!r}
# tools: {tool_names}   (async: {async_tools})
def lambda_handler(event, context):
    """Route an MCP JSON-RPC request (HTTP POST body) to the server."""
    import json
    request = event["body"] if isinstance(event.get("body"), dict) \\
        else json.loads(event.get("body", "{{}}"))
    t0 = context.now()
    response = __fame_dispatch__(request, context)
    context.telemetry("mcp_rpc", t0, context.now(),
                      method=request.get("method"),
                      tool=(request.get("params") or {{}}).get("name"))
    return {{"statusCode": 200, "body": response}}
'''


@dataclasses.dataclass
class WrappedServer:
    server: FastMCP
    parsed: Optional[ParsedServer]
    wrapper_source: str
    cache: Optional[CacheManager]
    fame_runtime: Optional[object] = None

    def function_def(self, name: Optional[str] = None, *,
                     memory_mb: Optional[int] = None,
                     cold_start_s: float = 1.2, init_extra_s: float = 0.0) -> FunctionDef:
        return FunctionDef(
            name=name or f"mcp-{self.server.name}",
            handler=self.lambda_handler,
            memory_mb=memory_mb or self.server.memory_mb,
            cold_start_s=cold_start_s,
            init_extra_s=init_extra_s,
            role="mcp")

    # The executable equivalent of the generated `lambda_handler` above.
    def lambda_handler(self, payload: dict, ctx) -> dict:
        request = payload["body"] if isinstance(payload.get("body"), dict) else payload
        method = request.get("method")
        t0 = ctx.now()
        if method == "tools/call":
            params = request.get("params", {})
            tool = self.server.tools.get(params.get("name", ""))
            args = params.get("arguments", {})
            if tool is not None and self.cache is not None and tool.cacheable \
                    and tool.ttl_s != 0:
                hit, cached = self.cache.lookup(tool.name, args, tool.ttl_s, t=ctx.now())
                if hit:
                    emit("mcp", f"{self.server.name}.{tool.name}", t0, ctx.now(),
                         cache_hit=True)
                    return {"statusCode": 200,
                            "body": {"jsonrpc": "2.0", "id": request.get("id"),
                                     "result": cached}}
            if tool is not None:
                # simulated tool latency: base + per-KB scan of inputs
                in_kb = sum(len(str(v)) for v in args.values()) / 1024.0
                ctx.charge(tool.base_latency_s + tool.per_kb_s * in_kb)
        response = self.server.handle_rpc(request, runtime=self.fame_runtime)
        if method == "tools/call" and "result" in response and self.cache is not None:
            params = request.get("params", {})
            tool = self.server.tools.get(params.get("name", ""))
            if tool is not None and tool.cacheable and tool.ttl_s != 0:
                self.cache.put(tool.name, params.get("arguments", {}),
                               response["result"], tool.ttl_s, t=ctx.now())
        name = (request.get("params") or {}).get("name", method)
        emit("mcp", f"{self.server.name}.{name}", t0, ctx.now(), cache_hit=False,
             method=method)
        return {"statusCode": 200, "body": response}


def wrap_server(server: FastMCP, *, source: Optional[str] = None,
                cache: Optional[CacheManager] = None,
                fame_runtime=None) -> WrappedServer:
    """FAME automation: AST-parse (when source given) + generate wrapper."""
    parsed = parse_server_source(source) if source else None
    tool_names = parsed.tool_names if parsed else list(server.tools)
    async_tools = parsed.async_tools if parsed else [
        t.name for t in server.tools.values() if t.is_async]
    wrapper_source = WRAPPER_TEMPLATE.format(
        server_name=server.name, tool_names=tool_names, async_tools=async_tools)
    if parsed is not None:
        missing = set(parsed.tool_names) - set(server.tools)
        if missing:
            raise ValueError(f"source declares tools not registered: {missing}")
    return WrappedServer(server=server, parsed=parsed,
                         wrapper_source=wrapper_source, cache=cache,
                         fame_runtime=fame_runtime)
