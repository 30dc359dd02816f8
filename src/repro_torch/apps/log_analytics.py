"""Log Analytics application (§4.1).

Three MCP servers — Log Analyzer, Calculator, Visualization — plus oracle
rules. Session (per log file):
  Q1: Count the occurrences of error states <STATE> in the log file <FILE>
  Q2: Find the mean and standard deviation of timestamps for the most frequent error
  Q3: Find the min/max/mean/median timestamps with visualization and comparison
      between error states
"""
from __future__ import annotations

import json
import re
import statistics
from typing import Dict, List

from repro_torch.apps import data
from repro_torch.apps.common import (AppSpec, extract_plan, memory_prompt_active,
                               parse_tool_messages, user_request_of, visible)
from repro_torch.core.llm import ScriptedOracle
from repro_torch.core.mcp import FastMCP

TS_BUCKET = "fame-timestamps"
PLOTS_BUCKET = "fame-plots"

LOG_SOURCE = '''\
from repro_torch.core.mcp import FastMCP

mcp = FastMCP("log_analyzer", memory_mb=200)

@mcp.tool(description="List error types with counts in a log file")
@fame.wrapper()
def list_error_types(file: str, ctx=None):
    ...

@mcp.tool(description="Extract timestamps of lines matching a keyword")
@fame.wrapper()
def filter_by_keyword(file: str, keyword: str, ctx=None):
    ...

@mcp.tool(description="Count occurrences of a keyword in a log file")
@fame.wrapper()
def count_occurrences(file: str, keyword: str, ctx=None):
    ...

@mcp.tool(description="Return the raw log file content")
@fame.wrapper()
def read_log(file: str, ctx=None):
    ...
'''

CALC_SOURCE = '''\
from repro_torch.core.mcp import FastMCP

mcp = FastMCP("calculator", memory_mb=400)

@mcp.tool()
@fame.wrapper()
def min_list(values, ctx=None): ...

@mcp.tool()
@fame.wrapper()
def max_list(values, ctx=None): ...

@mcp.tool()
@fame.wrapper()
def mean(values, ctx=None): ...

@mcp.tool()
@fame.wrapper()
def median(values, ctx=None): ...

@mcp.tool()
@fame.wrapper()
def std(values, ctx=None): ...
'''

VIZ_SOURCE = '''\
from repro_torch.core.mcp import FastMCP

mcp = FastMCP("visualization", memory_mb=400)

@mcp.tool(description="Render a bar chart; returns an S3 PNG path")
@fame.wrapper()
def bar_chart(data, title: str = "", ctx=None): ...

@mcp.tool(description="Render a line plot; returns an S3 PNG path")
@fame.wrapper()
def line_plot(data, title: str = "", ctx=None): ...

@mcp.tool(description="Render a scatter plot; returns an S3 PNG path")
@fame.wrapper()
def scatter_plot(data, title: str = "", ctx=None): ...
'''


def _resolve_values(values, ctx) -> List[float]:
    if isinstance(values, str) and values.startswith("s3://") and ctx is not None:
        text = ctx.objects.fetch_text(values) or "[]"
        return json.loads(text)
    if isinstance(values, str):
        return json.loads(values)
    return list(values)


def build_servers() -> List[FastMCP]:
    logs = FastMCP("log_analyzer", memory_mb=200)
    calc = FastMCP("calculator", memory_mb=400)
    viz = FastMCP("visualization", memory_mb=400)

    @logs.tool(description="List error types with counts in a log file",
               base_latency_s=0.4, per_kb_s=0.004)
    def list_error_types(file: str, ctx=None):
        lid = data.lid_by_path(file)             # raises on unknown path
        return json.dumps(data.LOGS[lid]["errors"])

    @logs.tool(description="Extract timestamps of lines matching a keyword",
               base_latency_s=0.5, per_kb_s=0.004)
    def filter_by_keyword(file: str, keyword: str, ctx=None):
        lid = data.lid_by_path(file)
        ts = [l.ts for l in data.log_lines(lid) if l.error == keyword]
        if not ts:
            return f"ERROR: no lines matching {keyword!r}"
        payload = json.dumps(ts)
        if ctx is not None and ctx.config.s3_files:
            url = ctx.objects.stash(TS_BUCKET, f"{lid}-{keyword}.json", payload)
            return f"Found {len(ts)} timestamps for {keyword}. s3_url={url}"
        return f"Found {len(ts)} timestamps for {keyword}.\nTIMESTAMPS:\n{payload}"

    @logs.tool(description="Count occurrences of a keyword in a log file",
               base_latency_s=0.4, per_kb_s=0.004)
    def count_occurrences(file: str, keyword: str, ctx=None):
        lid = data.lid_by_path(file)
        return f"count({keyword})={data.LOGS[lid]['errors'].get(keyword, 0)}"

    @logs.tool(description="Return the raw log file content",
               base_latency_s=0.6, per_kb_s=0.004)
    def read_log(file: str, ctx=None):
        lid = data.lid_by_path(file)
        text = data.log_text(lid)
        if ctx is not None and ctx.config.s3_files:
            url = ctx.objects.stash(TS_BUCKET, f"{lid}-raw.log", text)
            return f"Read {len(text)} bytes. s3_url={url}"
        return text

    def _calc(fn_name, fn):
        def tool(values, ctx=None):
            vals = _resolve_values(values, ctx)
            return f"{fn_name}={fn(vals):.3f}"
        tool.__name__ = fn_name
        return tool

    for fn_name, fn in [("min_list", min), ("max_list", max),
                        ("mean", statistics.fmean), ("median", statistics.median),
                        ("std", lambda v: statistics.pstdev(v))]:
        calc.tool(description=f"{fn_name} of a list of numbers",
                  base_latency_s=0.05)(_calc(fn_name, fn))

    def _plot(kind):
        def tool(data, title: str = "", ctx=None):
            vals = _resolve_values(data, ctx) if data else []
            png = f"PNG:{kind}:{title}:{len(vals)}points".encode()
            if ctx is not None:
                import hashlib
                tag = hashlib.sha1(f"{kind}{title}".encode()).hexdigest()[:8]
                url = ctx.objects.put(PLOTS_BUCKET, f"{kind}-{tag}.png", png)
                return f"PLOT saved: {url} ({kind}, {len(vals)} points)"
            return f"PLOT rendered in-line ({kind}, {len(vals)} points)"
        tool.__name__ = kind
        return tool

    for kind in ("bar_chart", "line_plot", "scatter_plot"):
        viz.tool(description=f"Render a {kind.replace('_', ' ')}; returns an S3 PNG path",
                 base_latency_s=0.7)(_plot(kind))

    return [logs, calc, viz]


def queries(lid: str) -> List[str]:
    meta = data.LOGS[lid]
    state = sorted(meta["errors"])[0]
    return [
        f"Count the occurrences of error states '{state}' in the log file "
        f"'{meta['path']}'",
        "Find the mean and standard deviation of timestamps for the most "
        "frequent error",
        "Find the min/max/mean/median timestamps with visualization and "
        "comparison between error states",
    ]


def _resolve_file(context: str):
    m = re.findall(r"log file '([^']+)'", context)
    if m:
        return m[-1]
    m = re.findall(r"\"file\": \"([^\"]+)\"", context)
    return m[-1] if m else None


def _kind_of(q: str) -> str:
    ql = q.lower()
    if "count" in ql:
        return "count"
    if "standard deviation" in ql or "std" in ql:
        return "stats"
    return "full"


def build_oracles(**kw) -> Dict[str, ScriptedOracle]:
    planner, actor, evaluator = ScriptedOracle(name="planner"), \
        ScriptedOracle(name="actor"), ScriptedOracle(name="evaluator")

    # ---- Planner -----------------------------------------------------------
    def is_la_planner(system, context):
        q = user_request_of(context).lower()
        return "planner agent" in system and ("log" in q or "error" in q
                                              or "timestamps" in q)

    def plan_la(system, context, oracle):
        q = user_request_of(context)
        file = _resolve_file(context) or "UNKNOWN-FILE"
        kind = _kind_of(q)
        m = re.search(r"error states '([^']+)'", q)
        state = m.group(1) if m else "$TOP"
        if kind == "count":
            steps = [{"tool": "filter_by_keyword",
                      "arguments": {"file": file, "keyword": state}},
                     {"tool": "count_occurrences",
                      "arguments": {"file": file, "keyword": state}}]
        elif kind == "stats":
            steps = [{"tool": "list_error_types", "arguments": {"file": file}},
                     {"tool": "filter_by_keyword",
                      "arguments": {"file": file, "keyword": "$TOP"}},
                     {"tool": "mean", "arguments": {"values": "$TS"}},
                     {"tool": "std", "arguments": {"values": "$TS"}}]
        else:
            steps = [{"tool": "list_error_types", "arguments": {"file": file}},
                     {"tool": "filter_by_keyword",
                      "arguments": {"file": file, "keyword": "$TOP"}},
                     {"tool": "min_list", "arguments": {"values": "$TS"}},
                     {"tool": "max_list", "arguments": {"values": "$TS"}},
                     {"tool": "mean", "arguments": {"values": "$TS"}},
                     {"tool": "median", "arguments": {"values": "$TS"}},
                     {"tool": "line_plot",
                      "arguments": {"data": "$TS", "title": "error timeline"}}]
        return json.dumps({"tools_to_use": steps,
                           "reasoning": f"Analyze {file} for '{state}' via the log "
                                        f"analyzer, aggregate with the calculator"
                                        + (", then visualize" if kind == "full" else "")})

    planner.add_rule(is_la_planner, plan_la)

    # ---- Actor --------------------------------------------------------------
    def is_la_actor(system, context):
        plan = extract_plan(system)
        tools = {s.get("tool") for s in plan.get("tools_to_use", [])}
        return bool(tools & {"filter_by_keyword", "list_error_types", "read_log"})

    def act_la(system, context, oracle):
        plan = extract_plan(system)
        msgs = parse_tool_messages(context)
        allow_memory = memory_prompt_active(system)
        top_error, ts_ref = None, None
        results = []

        def fill(args):
            out = {}
            for k, v in args.items():
                if v == "$TOP":
                    out[k] = top_error or "UNKNOWN-ERROR"
                elif v == "$TS":
                    out[k] = ts_ref or "[]"
                else:
                    out[k] = v
            return out

        for step in plan.get("tools_to_use", []):
            tool = step["tool"]
            args = fill(step.get("arguments", {}))
            prior = visible(msgs, tool, allow_memory=allow_memory,
                            match=lambda a, want=args: all(
                                a.get(k) == v for k, v in want.items()))
            if prior is not None and prior.content.startswith("ERROR"):
                if not prior.from_memory:
                    return json.dumps({"final": f"ERROR: {tool} failed"})
                prior = None
            if prior is None:
                return json.dumps({"tool_calls": [
                    {"tool": tool, "arguments": args}]})
            # harvest placeholders from the satisfied step
            if tool == "list_error_types":
                counts = json.loads(prior.content)
                top_error = max(counts, key=counts.get)
            if tool == "filter_by_keyword":
                m = re.search(r"s3_url=(\S+)", prior.content)
                if m:
                    ts_ref = m.group(1)
                else:
                    m = re.search(r"TIMESTAMPS:\n(.*)", prior.content, re.S)
                    ts_ref = m.group(1).strip() if m else "[]"
            results.append(f"{tool}: {prior.content[:160]}")
        return json.dumps({"final": "ANALYTICS RESULT — " + " | ".join(results)})

    actor.add_rule(is_la_actor, act_la)

    # ---- Evaluator ------------------------------------------------------------
    def is_la_eval(system, context):
        return "Evaluate if this action" in system and (
            "filter_by_keyword" in system or "log" in system.lower())

    def eval_la(system, context, oracle):
        m = re.search(r"- Result: (.*?)\n- Current Iteration: (\d+)/(\d+)",
                      system, re.S)
        result = m.group(1) if m else ""
        iteration, max_iter = (int(m.group(2)), int(m.group(3))) if m else (1, 3)
        ok = "ANALYTICS RESULT" in result and "ERROR" not in result
        if ok:
            return json.dumps({"success": True, "needs_retry": False,
                               "reason": "aggregates computed for the requested log"})
        return json.dumps({
            "success": False, "needs_retry": iteration < max_iter,
            "reason": "analytics incomplete or a tool failed",
            "feedback": "Verify the log file path and error keyword; pass the "
                        "timestamp list (or its S3 URL) to the calculator tools."})

    evaluator.add_rule(is_la_eval, eval_la)
    return {"planner": planner, "actor": actor, "evaluator": evaluator}


APP = AppSpec(name="log_analytics", servers=[], sources={
    "log_analyzer": LOG_SOURCE, "calculator": CALC_SOURCE,
    "visualization": VIZ_SOURCE},
    inputs=["L1", "L2", "L3"], queries=queries, build_oracles=build_oracles)
APP.servers = build_servers()
