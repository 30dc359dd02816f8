"""The ReAct agents (§3.1): Planner, Actor, Evaluator as FaaS handlers.

Each agent is a small LangGraph (`agent_graph.AgentGraph`) executed inside one
FaaS function invocation; state flows between agents as Step-Function
messages. System prompts are the paper's (Appendix A.1).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from repro_torch.core.agent_graph import END, START, AgentGraph
from repro_torch.core.mcp import rpc_call, rpc_tools_list
from repro_torch.core.memory import MemoryEntry

PLANNER_PROMPT = """\
You are a planner agent. Based on the user's query and available tools, generate a
plan that specifies WHICH TOOLS to use and the SEQUENCE of tool calls.
- Available tools:
{tools_description}
- Return ONLY valid JSON with this structure:
{{"tools_to_use": [ ... ], "reasoning": "Brief explanation of the plan"}}
"""

ACTOR_PROMPT = """\
Based on this plan, execute the specified tools to address the user's query.
- Plan: {plan_json}
Execute the tools in the sequence specified by the plan. Let the tools help you
solve the query.
"""

# §4.2 prompt engineering: make the Actor reuse memory instead of re-calling.
ACTOR_MEMORY_PROMPT = """\
Check previous ToolMessage responses in conversation history before making new
tool calls. Extract data from previous tool outputs instead of calling tools
again with the same parameters. Only make new calls if data is unavailable or
parameters differ.
"""

EVALUATOR_PROMPT = """\
Evaluate if this action successfully addressed the user query:
- Plan: {plan_json}
- Result: {result_json}
- Current Iteration: {iteration_count}/{max_iterations}
- Respond with ONLY valid JSON:
{{"success": bool, "needs_retry": bool, "reason": "Brief explanation",
  "feedback": "If needs_retry=true, provide feedback ..."}}
Notes:
- Set success=true if the action result successfully answers the user query
- Set needs_retry=true if you think another iteration with a different plan would
- Only set needs_retry=true if iteration_count less than max_iterations
- If iteration_count >= max_iterations, set needs_retry=false
- feedback field is only required if needs_retry=true
"""


def render_messages(messages: List[Dict[str, Any]]) -> str:
    out = []
    for m in messages:
        role = m.get("role", "?")
        if role == "tool":
            out.append(f"[ToolMessage tool={m.get('tool')} args="
                       f"{json.dumps(m.get('arguments', {}), sort_keys=True)}]\n"
                       f"{m.get('content', '')}")
        else:
            out.append(f"[{role}] {m.get('content', '')}")
    return "\n".join(out)


def _context(payload: dict, extra: str = "") -> str:
    """Assemble the visible context string for an agent LLM call."""
    parts = []
    if payload.get("client_history"):
        parts.append("[CLIENT HISTORY]\n" + payload["client_history"])
    if payload.get("memory_context"):
        parts.append(payload["memory_context"])
    if payload.get("feedback"):
        parts.append("[EVALUATOR FEEDBACK]\n" + payload["feedback"])
    parts.append("[USER REQUEST]\n" + payload.get("user_request", ""))
    if payload.get("messages"):
        parts.append("[MESSAGES]\n" + render_messages(payload["messages"]))
    if extra:
        parts.append(extra)
    return "\n\n".join(parts)


class ReActAgents:
    """Builds the three agent FaaS handlers bound to a FameRuntime."""

    def __init__(self, runtime):
        self.rt = runtime

    # ------------------------------------------------------------- Planner
    def planner_handler(self, payload: dict, ctx) -> dict:
        rt = self.rt
        # 1. memory bootstrapping (§3.2): inject prior session memory
        memory_context = ""
        if rt.config.agentic_memory:
            ctx.charge(0.012)                                  # DynamoDB query
            memory_context = rt.memory.render_context(
                payload["session_id"], t=ctx.now())
        # 2. query tool descriptions from every MCP server (§3.1)
        tool_descs = []
        for fn_name in rt.mcp_function_names():
            resp = ctx.invoke(fn_name, {"body": rpc_tools_list()})
            for t in resp["body"]["result"]["tools"]:
                tool_descs.append(f"- {t['name']}: {t['description']}")
        payload = dict(payload, memory_context=memory_context)

        graph = AgentGraph("planner")

        def llm_node(state, gctx):
            system = PLANNER_PROMPT.format(tools_description="\n".join(tool_descs))
            resp = rt.llm("planner").chat(system, _context(payload), ctx)
            return {"plan_json": resp.text}

        graph.add_node("llm", llm_node)
        graph.add_edge("llm", END)
        state = graph.run({}, ctx)
        messages = list(payload.get("messages", []))
        messages.append({"role": "planner", "content": state["plan_json"]})
        return dict(payload, plan_json=state["plan_json"], messages=messages,
                    memory_context=memory_context)

    # --------------------------------------------------------------- Actor
    def actor_handler(self, payload: dict, ctx) -> dict:
        rt = self.rt
        graph = AgentGraph("actor")
        system = ACTOR_PROMPT.format(plan_json=payload.get("plan_json", ""))
        if rt.config.agentic_memory:
            system += "\n" + ACTOR_MEMORY_PROMPT

        def llm_node(state, gctx):
            resp = rt.llm("actor").chat(system, _context(
                dict(payload, messages=state["messages"])), ctx)
            try:
                decision = json.loads(resp.text)
            except json.JSONDecodeError:
                decision = {"final": resp.text}
            return {"decision": decision}

        def route(state):
            return "tools" if state["decision"].get("tool_calls") else END

        def tool_node(state, gctx):
            messages = list(state["messages"])
            for call in state["decision"]["tool_calls"]:
                fn_name = rt.resolve_tool_function(call["tool"])
                resp = ctx.invoke(fn_name, {"body": rpc_call(
                    call["tool"], call.get("arguments", {}))})
                body = resp["body"]
                if "error" in body:
                    content = f"ERROR: {body['error']['message']}"
                else:
                    content = body["result"]["content"][0]["text"]
                messages.append({"role": "tool", "tool": call["tool"],
                                 "arguments": call.get("arguments", {}),
                                 "content": content})
            return {"messages": messages}

        graph.add_node("llm", llm_node)
        graph.add_node("tools", tool_node)
        graph.add_conditional_edge("llm", route)
        graph.add_edge("tools", "llm")
        state = graph.run({"messages": list(payload.get("messages", []))}, ctx)
        final = state["decision"].get("final", "")
        messages = state["messages"] + [{"role": "actor", "content": final}]
        return dict(payload, result_json=final, messages=messages)

    # ----------------------------------------------------------- Evaluator
    def evaluator_handler(self, payload: dict, ctx) -> dict:
        rt = self.rt
        system = EVALUATOR_PROMPT.format(
            plan_json=payload.get("plan_json", ""),
            result_json=payload.get("result_json", ""),
            iteration_count=payload.get("iteration", 1),
            max_iterations=payload.get("max_iterations", 3))
        resp = rt.llm("evaluator").chat(system, _context(payload), ctx)
        try:
            verdict = json.loads(resp.text)
        except json.JSONDecodeError:
            verdict = {"success": False, "needs_retry": False,
                       "reason": "unparseable evaluator output"}
        # §3.2: persist THIS invocation's memory delta before returning
        if rt.config.agentic_memory:
            ctx.charge(0.010)                                   # DynamoDB write
            rt.memory.persist(MemoryEntry(
                session_id=payload["session_id"],
                invocation_id=payload["invocation_id"],
                user_request=payload.get("user_request", ""),
                messages=payload.get("messages", []),
                final_response=payload.get("result_json", "")), t=ctx.now())
        return dict(payload, verdict=verdict,
                    feedback=verdict.get("feedback", ""))
