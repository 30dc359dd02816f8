"""Research Paper Summarization application (§4.1).

Two MCP servers — ArXiv (download) and RAG (section summarization) — plus the
deterministic oracle rules that drive the ReAct agents for this app. Session:
  Q1: Summarize the introduction and core contributions of the paper titled <T>
  Q2: Describe its methodology and analysis
  Q3: Summarize its conclusions, implications and future work
"""
from __future__ import annotations

import json
import re
from typing import Dict, List

from repro_torch.apps import data
from repro_torch.apps.common import (AppSpec, extract_plan, memory_prompt_active,
                               parse_tool_messages, user_request_of, visible)
from repro_torch.core.llm import ScriptedOracle
from repro_torch.core.mcp import FastMCP

PAPERS_BUCKET = "fame-papers"

# ---------------------------------------------------------------------------
# MCP servers (the developer-facing FastMCP modules FAME wraps)
# ---------------------------------------------------------------------------

ARXIV_SOURCE = '''\
from repro_torch.core.mcp import FastMCP

mcp = FastMCP("arxiv", memory_mb=128)
ARXIV_API = "https://export.arxiv.org/api"

@mcp.tool(description="Search arXiv for a paper by (partial) title")
@fame.wrapper()
def search_paper(title: str, ctx=None):
    ...

@mcp.tool(description="Download a paper PDF by title; returns extracted text")
@fame.wrapper()
async def download_paper(title: str, ctx=None):
    ...
'''

RAG_SOURCE = '''\
from repro_torch.core.mcp import FastMCP

mcp = FastMCP("rag", memory_mb=400)

@mcp.tool(description="Summarize sections of a document matching a query")
@fame.wrapper()
def summarize_text(query: str, text: str, ctx=None):
    ...

@mcp.tool(description="Answer a question over a document")
@fame.wrapper()
def query_document(query: str, text: str, ctx=None):
    ...

@mcp.tool(description="Extract a named section from a document")
@fame.wrapper()
def extract_sections(text: str, section: str, ctx=None):
    ...
'''


def build_servers() -> List[FastMCP]:
    arxiv = FastMCP("arxiv", memory_mb=128)
    rag = FastMCP("rag", memory_mb=400)

    @arxiv.tool(description="Search arXiv for a paper by (partial) title",
                base_latency_s=0.6)
    def search_paper(title: str, ctx=None):
        pid = data.pid_by_title(title)
        return {"paper_id": pid, "title": data.title_of(pid),
                "pdf_mb": data.PAPERS[pid]["pdf_mb"]}

    @arxiv.tool(description="Download a paper PDF by title; returns extracted text",
                base_latency_s=2.0, per_kb_s=0.030)
    def download_paper(title: str, ctx=None):
        pid = data.pid_by_title(title)        # raises on hallucinated titles
        content = data.paper_content(pid)
        if ctx is not None and ctx.config.s3_files:
            url = ctx.objects.stash(PAPERS_BUCKET, f"{pid}.txt", content,
                                    title=data.title_of(pid))
            return (f"Downloaded '{data.title_of(pid)}' ({len(content)} chars). "
                    f"s3_url={url}")
        return f"Downloaded '{data.title_of(pid)}'.\nCONTENT:\n{content}"

    def _resolve_text(text: str, ctx):
        if text.startswith("s3://") and ctx is not None:
            fetched = ctx.objects.fetch_text(text)
            return fetched or ""
        return text

    def _summarize(query: str, text: str, ctx) -> str:
        doc = _resolve_text(text, ctx)
        sections = re.findall(r"== (\w[\w ]*) ==", doc)
        wanted = [s for s in sections
                  if any(w.lower() in s.lower() for w in query.split())] or sections[:2]
        body = " ".join(
            f"The {s} establishes {doc[200 + 97 * i:360 + 97 * i].strip()}."
            for i, s in enumerate(dict.fromkeys(wanted)))
        return f"SUMMARY ({query}): {body[:1100]}"

    @rag.tool(description="Summarize sections of a document matching a query",
              base_latency_s=0.8, per_kb_s=0.045)
    def summarize_text(query: str, text: str, ctx=None):
        return _summarize(query, text, ctx)

    @rag.tool(description="Answer a question over a document",
              base_latency_s=0.8, per_kb_s=0.045)
    def query_document(query: str, text: str, ctx=None):
        return _summarize(query, text, ctx)

    @rag.tool(description="Extract a named section from a document",
              base_latency_s=0.5, per_kb_s=0.02)
    def extract_sections(text: str, section: str, ctx=None):
        doc = _resolve_text(text, ctx)
        m = re.search(rf"== {re.escape(section)} ==\n(.*?)(?===|\Z)", doc, re.S)
        return f"SECTION {section}: {(m.group(1)[:800] if m else 'not found')}"

    return [arxiv, rag]


# ---------------------------------------------------------------------------
# Queries (three per session)
# ---------------------------------------------------------------------------


def queries(pid: str) -> List[str]:
    return [
        f"Summarize the introduction and core contributions of the paper "
        f"titled '{data.title_of(pid)}'",
        "Describe its methodology and analysis",
        "Summarize its conclusions, implications and future work",
    ]


_QUERY_SECTIONS = {
    "introduction": "Introduction Contributions",
    "methodology": "Methodology Analysis",
    "conclusions": "Conclusions Implications Future",
}


def _query_kind(q: str) -> str:
    ql = q.lower()
    for k in _QUERY_SECTIONS:
        if k in ql:
            return k
    return "introduction"


def _resolve_title(context: str):
    m = re.findall(r"titled '([^']+)'", context)
    if m:
        return m[-1]
    m = re.findall(r"Downloaded '([^']+)'", context)
    if m:
        return m[-1]
    return None


# ---------------------------------------------------------------------------
# Oracle rules
# ---------------------------------------------------------------------------


def build_oracles(**kw) -> Dict[str, ScriptedOracle]:
    planner, actor, evaluator = ScriptedOracle(name="planner"), \
        ScriptedOracle(name="actor"), ScriptedOracle(name="evaluator")

    # ---- Planner ---------------------------------------------------------
    def is_rs_planner(system, context):
        return "planner agent" in system and (
            "paper" in user_request_of(context).lower()
            or "its " in user_request_of(context).lower())

    def plan_rs(system, context, oracle):
        q = user_request_of(context)
        title = _resolve_title(context) or "UNKNOWN-PAPER"
        kind = _query_kind(q)
        steps = [
            {"tool": "download_paper", "arguments": {"title": title}},
            {"tool": "summarize_text",
             "arguments": {"query": f"Summarize {_QUERY_SECTIONS[kind]}",
                           "text": "$DOC"}},
        ]
        return json.dumps({"tools_to_use": steps,
                           "reasoning": f"Retrieve the paper '{title}' via the "
                                        f"arxiv MCP tool, then generate the "
                                        f"{kind} summary with the RAG tool."})

    planner.add_rule(is_rs_planner, plan_rs)

    # ---- Actor ------------------------------------------------------------
    def is_rs_actor(system, context):
        plan = extract_plan(system)
        tools = [s.get("tool") for s in plan.get("tools_to_use", [])]
        return "download_paper" in tools or "summarize_text" in tools

    def act_rs(system, context, oracle):
        plan = extract_plan(system)
        msgs = parse_tool_messages(context)
        allow_memory = memory_prompt_active(system)
        doc_ref = None
        for step in plan.get("tools_to_use", []):
            tool, args = step["tool"], dict(step.get("arguments", {}))
            if tool == "download_paper":
                prior = visible(msgs, "download_paper", allow_memory=allow_memory,
                                match=lambda a: a.get("title") == args["title"])
                if prior is not None and prior.content.startswith("ERROR"):
                    if not prior.from_memory:
                        # this run's download failed — surface the failure
                        return json.dumps({"final": f"ERROR: download failed "
                                           f"for title '{args['title']}'"})
                    prior = None                     # stale memory failure
                if prior is not None:
                    doc_ref = _doc_ref_from(prior.content)
                    continue
                return json.dumps({"tool_calls": [
                    {"tool": "download_paper", "arguments": args}]})
            if tool == "summarize_text":
                if doc_ref is None:
                    dl = visible(msgs, "download_paper", allow_memory=allow_memory)
                    if dl is None or dl.content.startswith("ERROR"):
                        return json.dumps(
                            {"final": "ERROR: no document available to summarize"})
                    doc_ref = _doc_ref_from(dl.content)
                args["text"] = doc_ref
                prior = visible(
                    msgs, "summarize_text", allow_memory=allow_memory,
                    match=lambda a: a.get("query") == args["query"])
                if prior is not None:
                    continue
                return json.dumps({"tool_calls": [
                    {"tool": "summarize_text", "arguments": args}]})
        # all steps satisfied -> final answer from the newest summary
        summ = visible(msgs, "summarize_text", allow_memory=allow_memory)
        body = summ.content if summ else "no summary produced"
        return json.dumps({"final": f"Here is the Summary: {body[:1200]}"})

    actor.add_rule(is_rs_actor, act_rs)

    # ---- Evaluator ---------------------------------------------------------
    def is_rs_eval(system, context):
        return "Evaluate if this action" in system

    def eval_rs(system, context, oracle):
        m = re.search(r"- Result: (.*?)\n- Current Iteration: (\d+)/(\d+)",
                      system, re.S)
        result = m.group(1) if m else ""
        iteration, max_iter = (int(m.group(2)), int(m.group(3))) if m else (1, 3)
        failed = ("ERROR" in result) or ("SUMMARY" not in result) or not result.strip()
        if not failed:
            return json.dumps({"success": True, "needs_retry": False,
                               "reason": "summary produced for requested sections"})
        return json.dumps({
            "success": False, "needs_retry": iteration < max_iter,
            "reason": "tool execution failed or produced no summary",
            "feedback": "The download failed — verify the exact paper title and "
                        "pass the document content to summarize_text."})

    evaluator.add_rule(is_rs_eval, eval_rs)
    return {"planner": planner, "actor": actor, "evaluator": evaluator}


def _doc_ref_from(content: str) -> str:
    m = re.search(r"s3_url=(\S+)", content)
    if m:
        return m.group(1)
    m = re.search(r"CONTENT:\n(.*)", content, re.S)
    return m.group(1) if m else content


APP = AppSpec(name="research_summary", servers=[], sources={
    "arxiv": ARXIV_SOURCE, "rag": RAG_SOURCE},
    inputs=["P1", "P2", "P3"], queries=queries, build_oracles=build_oracles)
APP.servers = build_servers()
