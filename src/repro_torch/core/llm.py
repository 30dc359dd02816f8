"""LLM backends for FAME agents.

Two interchangeable backends behind one interface:

* ``ScriptedOracle`` — a deterministic planner/actor/evaluator "LLM" whose
  behaviour is a function of its VISIBLE CONTEXT (exactly the paper's
  methodology for isolating systems effects, §5.3.2): if a needed fact (paper
  title, log path) is absent from context it hallucinates (→ DNF, like config
  E); if prior tool outputs are visible in injected memory it reuses them
  (§4.2 memory prompt), else it re-calls tools. Token counts are computed
  from the ACTUAL prompt strings FAME assembles.

* ``TorchLLM`` — the port's serving engine (repro_torch.serving.server.
  LLMServer) hosting any ported architecture; tokenize → prefill → decode.

Latency model: t = base + in_tokens·prefill_rate + out_tokens·decode_rate.
The rates are the FaaS cost simulation's constants (GPT-4o-mini-like API
figures), not a measurement of any device; ``rates_for_arch`` returns them
for every architecture (see its docstring).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.pricing import PRICING
from repro_torch.core.telemetry import emit


def count_tokens(text: str) -> int:
    """Deterministic token estimate (≈4 chars/token, GPT-family heuristic)."""
    return max(1, math.ceil(len(text) / 4))


@dataclasses.dataclass
class LLMResponse:
    text: str
    input_tokens: int
    output_tokens: int
    latency_s: float
    cost_cents: float


@dataclasses.dataclass
class LatencyModel:
    base_s: float = 0.45
    per_in_tok_s: float = 9e-6          # prefill-bound
    per_out_tok_s: float = 0.018        # decode-bound (~55 tok/s)


def rates_for_arch(arch: Optional[str], results_path: Optional[str] = None):
    """Serving rates for an assigned architecture: the ``LatencyModel``
    defaults, whatever ``arch``. They are constants of the FaaS cost
    simulation (GPT-4o-mini-like API figures) and no device's measurement.
    The JAX package derives per-arch rates from its TPU dry-run roofline
    file; the port carries no TPU numbers, and no measured card rates
    replace them yet. ``results_path`` is accepted for signature parity and
    not read."""
    del arch, results_path
    return LatencyModel()


class LLMBackend:
    """Base: meters tokens/latency/cost; subclasses implement _generate."""

    def __init__(self, latency: Optional[LatencyModel] = None, name: str = "llm"):
        self.latency = latency or LatencyModel()
        self.name = name

    def chat(self, system: str, context: str, ctx=None) -> LLMResponse:
        prompt = system + "\n" + context
        in_tok = count_tokens(prompt)
        text = self._generate(system, context)
        out_tok = count_tokens(text)
        lat = (self.latency.base_s + in_tok * self.latency.per_in_tok_s
               + out_tok * self.latency.per_out_tok_s)
        cost = PRICING.llm_cost(in_tok, out_tok)
        t0 = ctx.now() if ctx is not None else 0.0
        if ctx is not None:
            ctx.charge(lat)
        emit("llm", self.name, t0, t0 + lat, input_tokens=in_tok,
             output_tokens=out_tok, cost_cents=cost)
        return LLMResponse(text, in_tok, out_tok, lat, cost)

    def _generate(self, system: str, context: str) -> str:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Scripted oracle
# ---------------------------------------------------------------------------


class ScriptedOracle(LLMBackend):
    """Deterministic role-conditioned generator.

    The oracle inspects only what a real LLM would see — the system prompt and
    the assembled context string — and emits valid JSON plans / tool calls /
    evaluations. App-specific planning rules are registered by the
    applications (see repro.apps.*), keyed by trigger phrases.
    """

    def __init__(self, latency: Optional[LatencyModel] = None,
                 use_memory_prompt: bool = True, name: str = "oracle"):
        super().__init__(latency, name)
        self.rules: List[Tuple[Any, Any]] = []     # (match_fn, respond_fn)
        self.use_memory_prompt = use_memory_prompt

    def add_rule(self, match_fn, respond_fn):
        self.rules.append((match_fn, respond_fn))

    def _generate(self, system: str, context: str) -> str:
        for match_fn, respond_fn in self.rules:
            if match_fn(system, context):
                return respond_fn(system, context, self)
        return json.dumps({"error": "no rule matched", "hallucination": True})


# ---------------------------------------------------------------------------
# TorchLLM — the port's serving engine backend
# ---------------------------------------------------------------------------


class TorchLLM(LLMBackend):
    """FAME agents on the port's serving engine.

    ``engine`` is a ``repro_torch.serving.server.LLMServer``: each agent
    role gets its own server *session*, keyed by its system prompt, so a
    role's growing conversation reuses its end-of-generation state across
    turns and concurrent roles co-batch through handles. ``temperature`` /
    ``top_k`` ride through to the engine's on-device per-slot sampler;
    ``serving_stats`` exposes the engine's counters (host syncs, decode
    tokens, session/turn reuse, speculative acceptance) so agent
    benchmarks can report serving efficiency alongside workflow metrics.
    """

    def __init__(self, engine, max_new_tokens: int = 48,
                 latency: Optional[LatencyModel] = None,
                 temperature: float = 0.0, top_k: int = 0):
        from repro_torch.serving.server import LLMServer
        if not isinstance(engine, LLMServer):
            raise TypeError(f"TorchLLM needs an LLMServer, got {type(engine).__name__}")
        super().__init__(latency or LatencyModel(base_s=0.02), name="torchllm")
        self.engine = engine
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self._sessions: Dict[str, Any] = {}     # system prompt -> Session

    def _params(self):
        from repro_torch.serving.server import SamplingParams
        return SamplingParams(max_new_tokens=self.max_new_tokens,
                              temperature=self.temperature,
                              top_k=self.top_k)

    def submit(self, system: str, context: str):
        """Non-blocking submission: returns a Handle so N concurrent agent
        calls can co-batch before any result is drained. If the role's
        session already has a turn in flight (two concurrent workflows
        sharing one role prompt), the call falls back to a sessionless
        submit — it still co-batches and radix-shares the prefix, it just
        skips the session-tail reuse."""
        session = self._sessions.get(system)
        if session is None or session.closed:
            session = self.engine.open_session()
            self._sessions[system] = session
        if session.busy:
            return self.engine.submit(system + "\n" + context, self._params())
        return session.submit(system + "\n" + context, self._params())

    def _generate(self, system: str, context: str) -> str:
        return self.submit(system, context).result()

    def serving_stats(self) -> Dict[str, Any]:
        return self.engine.stats()
