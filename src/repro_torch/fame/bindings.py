"""Serving bindings: the paper's ReAct agents on the real ``LLMServer``.

Mirrors ``core/agents.ReActAgents`` handler-for-handler — same prompts, same
payload mutations, same oracle-rule decisions — but every agent LLM call is
also a *real request* on the serving stack:

* **Memory configs (M, M+C)** get one persistent server session per workflow
  invocation chain. Each agent turn appends only its *delta* (user line, tool
  refs, role tag) to the session tail — memory persistence/injection (§3.2)
  becomes token-level session continuation: the engine restores the retained
  tail instead of re-prefilling the conversation, and the client is billed
  only the delta tokens.
* **Stateless configs (E, N, C)** re-submit the full rendered context every
  call, exactly like a client that re-sends its history (config N's token
  bloat in Fig. 5).

Decisions (plans, tool calls, verdicts) come from the apps' scripted oracle
rules over the *semantic* context — identical strings to oracle mode, so
workflow statuses are deterministic and equal across backends — while the
served stream is a clipped canonical rendering of the same conversation (tiny
untrained checkpoints would otherwise decode garbage into the control flow).
Failures surface as the serving fault taxonomy: a FAILED turn raises ``request.error``
into the state machine's per-state Retry; a TIMED_OUT turn raises
``DeadlineExceeded``; exhausted retries dead-letter the workflow into
``FailState``.
"""
from __future__ import annotations

import json
import time
from typing import Callable, List, Optional, Union

from repro_torch.core.agents import (ACTOR_MEMORY_PROMPT, ACTOR_PROMPT,
                               EVALUATOR_PROMPT, PLANNER_PROMPT, _context)
from repro_torch.core.faas import PRICING
from repro_torch.core.mcp import rpc_call, rpc_tools_list
from repro_torch.core.memory import MemoryEntry
from repro_torch.core.telemetry import emit
from repro_torch.fame.toolflow import canonical_tool_message, clip_content
from repro_torch.fame.trace import TurnRecord
from repro_torch.serving.faults import DeadlineExceeded, RequestFault, ShedError


class ChainBinding:
    """One workflow invocation chain's conversation on the server.

    ``persistent=True`` opens a server session and drives it by token-level
    continuation; ``persistent=False`` submits sessionless full prompts.
    """

    def __init__(self, rt, chain_id: str, *, persistent: bool):
        self.rt = rt
        self.chain_id = chain_id
        self.persistent = persistent
        self.session = rt.server.open_session() if persistent else None
        self.turn_idx = 0

    @property
    def first_turn(self) -> bool:
        return self.persistent and self.turn_idx == 0

    def turn(self, role: str, delta: str,
             full_prompt: Union[str, Callable[[], str]],
             ctx=None) -> TurnRecord:
        """Submit one agent turn; blocks (via the fusion driver) until the
        request is terminal. Raises the taxonomy error on FAILED/TIMED_OUT."""
        rt = self.rt
        server = rt.server
        params = rt.turn_params()
        billed = None
        if self.persistent:
            base = self.session.text
            continuation = bool(base)
            prompt = base + delta
            if continuation:
                # server.tokenizer works on both a single LLMServer and a
                # FleetServer front (which has no single .engine)
                billed = len(server.tokenizer.encode(delta, bos=False))
            sid = self.session.sid
            submit = lambda: server.submit(prompt, params, session=sid)
        else:
            continuation = False
            prompt = full_prompt() if callable(full_prompt) else full_prompt
            submit = lambda: server.submit(prompt, params)
        t0 = time.perf_counter()
        h = rt.driver.call(submit)
        wall = time.perf_counter() - t0
        req = h.request
        self.turn_idx += 1
        if billed is None:
            billed = req.prompt_tokens
        rec = TurnRecord(
            kind="turn", role=role, chain_id=self.chain_id, rid=req.rid,
            status=req.status,
            error_type=type(req.error).__name__ if req.error else "",
            prompt_tokens=req.prompt_tokens, billed_tokens=billed,
            prefix_hit_tokens=req.prefix_hit_tokens,
            output_tokens=req.output_tokens, wall_s=wall,
            session_turn=self.turn_idx if self.persistent else 0,
            continuation=continuation)
        rt.meter.record(rec)
        if ctx is not None:
            ctx.charge(wall)
            emit("llm", f"fame-{role}", ctx.now() - wall, ctx.now(),
                 input_tokens=billed, output_tokens=req.output_tokens,
                 cost_cents=PRICING.llm_cost(billed, req.output_tokens),
                 rid=req.rid, prefix_hit_tokens=req.prefix_hit_tokens,
                 continuation=continuation)
        if req.status == "failed":
            raise req.error if req.error is not None else \
                RequestFault(f"turn rid={req.rid} failed")
        if req.status == "timed_out":
            raise req.error if req.error is not None else \
                DeadlineExceeded(f"turn rid={req.rid} exceeded its deadline")
        if req.status == "shed":
            raise req.error if req.error is not None else \
                ShedError(f"turn rid={req.rid} shed under overload")
        return rec

    def close(self):
        if self.session is not None and not self.session.closed:
            self.session.close()


class ServingAgents:
    """Planner/Actor/Evaluator FaaS handlers bound to a
    ``fame.runtime.WorkflowServingRuntime``."""

    def __init__(self, runtime):
        self.rt = runtime

    # ---- served-view rendering (clipped mirror of agents._context) ---------
    def _served_message(self, m: dict, ctx=None) -> str:
        rt = self.rt
        role = m.get("role", "?")
        if role == "tool":
            if rt.toolflow.enabled:
                return rt.toolflow.ref_line(m.get("tool"),
                                            m.get("arguments", {}))
            return canonical_tool_message(m.get("tool"),
                                          m.get("arguments", {}),
                                          m.get("content", ""),
                                          clip=rt.stream_clip)
        return f"[{role}] {clip_content(m.get('content', ''), rt.stream_clip)}"

    def served_context(self, payload: dict) -> str:
        rt = self.rt
        parts = []
        if payload.get("client_history"):
            parts.append("[CLIENT HISTORY]\n" + payload["client_history"])
        if payload.get("memory_context"):
            parts.append(clip_content(payload["memory_context"],
                                      2 * rt.stream_clip))
        if payload.get("feedback"):
            parts.append("[EVALUATOR FEEDBACK]\n" + payload["feedback"])
        parts.append("[USER REQUEST]\n" + payload.get("user_request", ""))
        if payload.get("messages"):
            parts.append("[MESSAGES]\n" + "\n".join(
                self._served_message(m) for m in payload["messages"]))
        return "\n\n".join(parts)

    # ------------------------------------------------------------- Planner
    def planner_handler(self, payload: dict, ctx) -> dict:
        rt = self.rt
        memory_context = ""
        if rt.config.agentic_memory:
            ctx.charge(0.012)                                  # DynamoDB query
            memory_context = rt.memory.render_context(
                payload["session_id"], t=ctx.now())
        tool_descs: List[str] = []
        for fn_name in rt.mcp_function_names():
            resp = ctx.invoke(fn_name, {"body": rpc_tools_list()})
            for t in resp["body"]["result"]["tools"]:
                tool_descs.append(f"- {t['name']}: {t['description']}")
        payload = dict(payload, memory_context=memory_context)
        system = PLANNER_PROMPT.format(tools_description="\n".join(tool_descs))
        plan_json = rt.decide("planner", system, _context(payload))
        chain = rt.chain_for(payload)
        delta = []
        if chain.first_turn:
            delta.append("[TOOLS]\n" + "\n".join(tool_descs) + "\n")
        if payload.get("feedback"):
            delta.append("[EVALUATOR FEEDBACK]\n"
                         + payload["feedback"] + "\n")
        if payload.get("iteration", 1) == 1:
            delta.append(f"[user] {payload.get('user_request', '')}\n")
        delta.append("[plan]\n")
        chain.turn("planner", "".join(delta),
                   lambda: system + "\n\n" + self.served_context(payload),
                   ctx=ctx)
        messages = list(payload.get("messages", []))
        messages.append({"role": "planner", "content": plan_json})
        return dict(payload, plan_json=plan_json, messages=messages,
                    memory_context=memory_context)

    # --------------------------------------------------------------- Actor
    def actor_handler(self, payload: dict, ctx) -> dict:
        rt = self.rt
        system = ACTOR_PROMPT.format(plan_json=payload.get("plan_json", ""))
        if rt.config.agentic_memory:
            system += "\n" + ACTOR_MEMORY_PROMPT
        chain = rt.chain_for(payload)
        messages = list(payload.get("messages", []))
        pending_delta = "[act]\n"
        while True:
            view = dict(payload, messages=messages)
            text = rt.decide("actor", system, _context(view))
            try:
                decision = json.loads(text)
            except json.JSONDecodeError:
                decision = {"final": text}
            chain.turn("actor", pending_delta,
                       lambda v=view: system + "\n\n" + self.served_context(v),
                       ctx=ctx)
            calls = decision.get("tool_calls")
            if not calls:
                final = decision.get("final", "")
                break
            served_lines = []
            for call in calls:
                tool = call["tool"]
                args = call.get("arguments", {})
                fn_name = rt.resolve_tool_function(tool)
                hits_before = rt.cache.hits
                resp = ctx.invoke(fn_name, {"body": rpc_call(tool, args)})
                body = resp["body"]
                if "error" in body:
                    content = f"ERROR: {body['error']['message']}"
                else:
                    content = body["result"]["content"][0]["text"]
                cache_hit = rt.cache.hits > hits_before
                messages.append({"role": "tool", "tool": tool,
                                 "arguments": args, "content": content})
                if rt.toolflow.enabled:
                    rt.toolflow.inject(tool, args, content,
                                       cache_hit=cache_hit,
                                       chain_id=chain.chain_id, ctx=ctx)
                    served_lines.append(rt.toolflow.ref_line(tool, args))
                else:
                    served_lines.append(canonical_tool_message(
                        tool, args, content, clip=rt.stream_clip))
            pending_delta = "\n".join(served_lines) + "\n[act]\n"
        messages = messages + [{"role": "actor", "content": final}]
        return dict(payload, result_json=final, messages=messages)

    # ----------------------------------------------------------- Evaluator
    def evaluator_handler(self, payload: dict, ctx) -> dict:
        rt = self.rt
        system = EVALUATOR_PROMPT.format(
            plan_json=payload.get("plan_json", ""),
            result_json=payload.get("result_json", ""),
            iteration_count=payload.get("iteration", 1),
            max_iterations=payload.get("max_iterations", 3))
        text = rt.decide("evaluator", system, _context(payload))
        try:
            verdict = json.loads(text)
        except json.JSONDecodeError:
            verdict = {"success": False, "needs_retry": False,
                       "reason": "unparseable evaluator output"}
        chain = rt.chain_for(payload)
        chain.turn("evaluator", "[eval]\n",
                   lambda: system + "\n\n" + self.served_context(payload),
                   ctx=ctx)
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
