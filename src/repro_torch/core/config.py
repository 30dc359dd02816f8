"""FAME memory/caching configurations (Table 1 of the paper)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    name: str
    client_memory: bool          # naive client-side transcript accumulation
    agentic_memory: bool         # durable agent memory (DynamoDB) + injection
    mcp_caching: bool            # S3 invocation cache
    s3_files: bool               # S3 file handling (URLs instead of payloads)


E = MemoryConfig("E", client_memory=False, agentic_memory=False,
                 mcp_caching=False, s3_files=False)
N = MemoryConfig("N", client_memory=True, agentic_memory=False,
                 mcp_caching=False, s3_files=False)
C = MemoryConfig("C", client_memory=True, agentic_memory=False,
                 mcp_caching=True, s3_files=True)
M = MemoryConfig("M", client_memory=True, agentic_memory=True,
                 mcp_caching=False, s3_files=True)
MC = MemoryConfig("M+C", client_memory=True, agentic_memory=True,
                  mcp_caching=True, s3_files=True)

CONFIGS = {c.name: c for c in (E, N, C, M, MC)}
