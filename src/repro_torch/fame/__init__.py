"""FAME workflow runtime on the real serving stack (docs/fame.md).

``core/`` keeps the paper-faithful simulated FAME layer; this package binds
the same Planner → Actor → Evaluator state machine to the port's
``LLMServer``: persistent sessions as agent memory, canonical tool-stream injection
as cache × radix composition, co-batched handles as function fusion, and the
serving fault taxonomy (serving/faults.py) as Step-Function per-state Retry.
"""
from repro_torch.fame.bindings import ChainBinding, ServingAgents
from repro_torch.fame.fusion import CoBatchDriver, SerialDriver
from repro_torch.fame.runtime import WorkflowServingRuntime
from repro_torch.fame.toolflow import ToolFlow, canonical_tool_message
from repro_torch.fame.trace import ServingMeter, TurnRecord, write_artifact

__all__ = [
    "ChainBinding", "ServingAgents", "CoBatchDriver", "SerialDriver",
    "WorkflowServingRuntime", "ToolFlow", "canonical_tool_message",
    "ServingMeter", "TurnRecord", "write_artifact",
]
