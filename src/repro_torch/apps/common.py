"""Shared app plumbing: oracle parsing helpers + AppSpec."""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.mcp import FastMCP

_MARKERS = (r"\n\[ToolMessage |\n\[planner\]|\n\[actor\]|\n\[user\]|\n\[tool\]"
            r"|\n\[assistant\]|\n\[MESSAGES\]|\n\[USER REQUEST\]"
            r"|\n\[EVALUATOR FEEDBACK\]|\n--- invocation|\nfinal:|\Z")
TOOLMSG_RE = re.compile(
    r"\[ToolMessage tool=(\S+) args=(\{.*?\})\]\n(.*?)(?=" + _MARKERS + ")", re.S)


@dataclasses.dataclass
class ToolMsg:
    tool: str
    args: dict
    content: str
    from_memory: bool


def parse_tool_messages(context: str) -> List[ToolMsg]:
    """All visible ToolMessages; flags whether each came from injected memory
    (before the [MESSAGES] section) or the current conversation."""
    idx_msgs = context.find("[MESSAGES]")
    out = []
    for m in TOOLMSG_RE.finditer(context):
        try:
            args = json.loads(m.group(2))
        except json.JSONDecodeError:
            args = {}
        out.append(ToolMsg(m.group(1), args, m.group(3).strip(),
                           from_memory=(idx_msgs < 0 or m.start() < idx_msgs)))
    return out


def visible(msgs: List[ToolMsg], tool: str, *, allow_memory: bool,
            match: Optional[Callable[[dict], bool]] = None) -> Optional[ToolMsg]:
    """Newest visible ToolMessage for `tool` (memory ones only if allowed)."""
    for m in reversed(msgs):
        if m.tool != tool:
            continue
        if m.from_memory and not allow_memory:
            continue
        if match is not None and not match(m.args):
            continue
        return m
    return None


def extract_plan(system: str) -> dict:
    m = re.search(r"- Plan: (\{.*?\})\nExecute", system, re.S)
    if not m:
        m = re.search(r"- Plan: (\{.*\})", system, re.S)
    if not m:
        return {}
    try:
        return json.loads(m.group(1))
    except json.JSONDecodeError:
        return {}


def memory_prompt_active(system: str) -> bool:
    return "Check previous ToolMessage responses" in system


def user_request_of(context: str) -> str:
    m = re.search(r"\[USER REQUEST\]\n(.*?)(?:\n\n|\n\[|\Z)", context, re.S)
    return m.group(1).strip() if m else ""


@dataclasses.dataclass
class AppSpec:
    name: str
    servers: List[FastMCP]
    sources: Dict[str, str]                      # server name -> server.py source
    inputs: List[str]                            # P1..P3 / L1..L3
    queries: Callable[[str], List[str]]          # input id -> 3 session queries
    build_oracles: Callable[..., Dict[str, Any]]  # -> {"planner":.., "actor":.., "evaluator":..}
