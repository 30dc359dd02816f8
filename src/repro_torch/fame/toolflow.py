"""Tool-output caching composed with radix prefix sharing (§3.3.2).

The seed's ``CacheManager`` removes the *tool execution*; this layer removes
the *re-prefill*. Every MCP result enters the serving layer as a standalone
"injection" request whose text is canonical — tool name, cache-key argument
rendering (``toolcache.canonical_args_text``), deterministically clipped
content — so a cached result re-injected later is token-identical from stream
position 0 and radix-hits the pages adopted by the first injection instead of
prefilling again. The Actor's conversation then carries only a short
``[ToolRef …]`` line; the payload bytes live once, in shared KV pages.

Billing follows the composition: a cache-miss injection bills its full prompt
(new content shipped to the model); a cache-hit bills zero (content already
resident server-side).
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.core.telemetry import emit
from repro_torch.core.toolcache import cache_key, canonical_args_text
from repro_torch.fame.trace import ServingMeter, TurnRecord

INJECT_SUFFIX = "\n[ack]\n"


def clip_content(content: str, limit: int) -> str:
    """Deterministic clipping for the served stream (the oracle's semantic
    context keeps the full text). Must be stable across re-injections."""
    if limit <= 0 or len(content) <= limit:
        return content
    return content[:limit] + f"…[clipped {len(content) - limit} chars]"


def canonical_tool_message(tool: str, args: dict, content: str,
                           clip: int = 0) -> str:
    return (f"[ToolMessage tool={tool} args={canonical_args_text(args)}]\n"
            f"{clip_content(content, clip)}")


class ToolFlow:
    """Submits canonical tool streams to the server via a fusion driver."""

    def __init__(self, driver, *, enabled: bool, meter: ServingMeter,
                 params=None, clip: int = 600):
        from repro_torch.serving.scheduler import SamplingParams
        self.driver = driver
        self.enabled = enabled
        self.meter = meter
        self.clip = clip
        self.params = params or SamplingParams(max_new_tokens=1)

    def ref_line(self, tool: str, args: dict) -> str:
        return f"[ToolRef tool={tool} key={cache_key(tool, args)[:12]}]"

    def inject(self, tool: str, args: dict, content: str, *,
               cache_hit: bool, chain_id: str = "",
               ctx=None) -> Optional[TurnRecord]:
        """Push one tool result through the serving layer; returns its
        TurnRecord (None when the flow is disabled for this config)."""
        if not self.enabled:
            return None
        prompt = canonical_tool_message(tool, args, content,
                                        clip=self.clip) + INJECT_SUFFIX
        server = self.driver.server
        t0 = time.perf_counter()
        h = self.driver.call(lambda: server.submit(prompt, self.params))
        wall = time.perf_counter() - t0
        req = h.request
        billed = 0 if cache_hit else req.prompt_tokens
        rec = TurnRecord(
            kind="inject", role=tool, chain_id=chain_id, rid=req.rid,
            status=req.status,
            error_type=type(req.error).__name__ if req.error else "",
            prompt_tokens=req.prompt_tokens, billed_tokens=billed,
            prefix_hit_tokens=req.prefix_hit_tokens,
            output_tokens=req.output_tokens, wall_s=wall,
            cache_hit=cache_hit)
        self.meter.record(rec)
        if ctx is not None:
            ctx.charge(wall)
            emit("llm", f"inject-{tool}", ctx.now() - wall, ctx.now(),
                 input_tokens=billed, output_tokens=0, cost_cents=0.0,
                 rid=req.rid, cache_hit=cache_hit,
                 prefix_hit_tokens=req.prefix_hit_tokens)
        return rec
