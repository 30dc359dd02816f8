"""Durable agent memory (§3.2): automated persistence + injection.

Memory entries are the accumulated agent message state of one workflow
invocation — user request, LLM interactions, tool inputs/outputs, final
response — keyed by ``session_id`` with an ``invocation_id`` field. The
Evaluator persists a NEW entry per invocation (delta only: prior entries
already exist); the Planner's context is bootstrapped by injecting all prior
entries for the session.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from repro_torch.core.kvstore import KVStore

MEMORY_TABLE = "fame-agent-memory"


@dataclasses.dataclass
class MemoryEntry:
    session_id: str
    invocation_id: str
    user_request: str
    messages: List[Dict[str, Any]]          # role/content (+ tool_call metadata)
    final_response: str

    def to_item(self) -> dict:
        return dataclasses.asdict(self)


class AgentMemory:
    def __init__(self, kv: KVStore, enabled: bool = True):
        self.kv = kv
        self.enabled = enabled

    @staticmethod
    def _key(session_id: str, invocation_id: str) -> str:
        return f"{session_id}#{invocation_id}"

    # --- persistence (Evaluator side) -------------------------------------
    def persist(self, entry: MemoryEntry, t: Optional[float] = None):
        if not self.enabled:
            return
        self.kv.put(MEMORY_TABLE, self._key(entry.session_id, entry.invocation_id),
                    entry.to_item(), t=t)

    # --- injection (Planner side) ------------------------------------------
    def recall(self, session_id: str, t: Optional[float] = None) -> List[MemoryEntry]:
        if not self.enabled:
            return []
        items = self.kv.query_prefix(MEMORY_TABLE, f"{session_id}#", t=t)
        return [MemoryEntry(**it) for it in items]

    def render_context(self, session_id: str, t: Optional[float] = None) -> str:
        """Serialize prior memory for injection into the Planner's context."""
        entries = self.recall(session_id, t=t)
        if not entries:
            return ""
        parts = ["[AGENT MEMORY — prior invocations in this session]"]
        for e in entries:
            parts.append(f"--- invocation {e.invocation_id} ---")
            parts.append(f"user: {e.user_request}")
            for m in e.messages:
                content = m.get("content", "")
                role = m.get("role", "?")
                if role == "tool":
                    args = json.dumps(m.get("arguments", {}), sort_keys=True)
                    parts.append(f"[ToolMessage tool={m.get('tool')} args={args}]\n{content}")
                else:
                    parts.append(f"{role}: {content}")
            parts.append(f"final: {e.final_response}")
        return "\n".join(parts)
