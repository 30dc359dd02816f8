"""Deprecated serving façade of the port (``repro.serving.engine``'s
counterpart).

The engine lives in two layers: ``serving/scheduler.py`` (request queue,
slot lifecycle, paged / radix / snapshot bookkeeping, sessions, ``stats()``)
and ``serving/programs.py`` (prefill, extend, the decode and verify steps).
New code should use the session-oriented frontend,
``repro_torch.serving.server.LLMServer`` (``open_session()`` / ``submit()
-> Handle`` / ``handle.stream()`` / ``cancel()``) with per-request
``SamplingParams``. ``ServingEngine`` stays as a thin deprecation shim for
callers of the blocking API: ``submit(prompt, **kwargs)`` forwards to
``Scheduler.enqueue(prompt, SamplingParams(...))`` and warns.
"""
from __future__ import annotations

import warnings

from repro_torch.serving.programs import auto_buckets as _auto_buckets  # noqa: F401
from repro_torch.serving.scheduler import (EngineConfig, Request,  # noqa: F401
                                           SamplingParams, Scheduler)


class ServingEngine(Scheduler):
    """Back-compat engine: the pre-redesign blocking API over the scheduler.

    Everything else (``slots``, ``stats()``, ``run_until_drained()``,
    ``kvpool`` / ``radix`` / ``snaps``, ``device=``, ...) is inherited
    unchanged from ``Scheduler``; only the kwargs-style ``submit`` /
    ``generate`` entry points are deprecated.
    """

    def submit(self, prompt: str, *, max_new_tokens: int = 64,
               temperature: float = 0.0, top_k: int = 0) -> Request:
        warnings.warn(
            "ServingEngine.submit(prompt, **kwargs) is deprecated; use "
            "repro_torch.serving.server.LLMServer with SamplingParams",
            DeprecationWarning, stacklevel=2)
        return self.enqueue(prompt, SamplingParams(
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k))

    def generate(self, prompt: str, *, max_new_tokens: int = 64,
                 temperature: float = 0.0, top_k: int = 0) -> str:
        req = self.submit(prompt, max_new_tokens=max_new_tokens,
                          temperature=temperature, top_k=top_k)
        self.run_until_drained()
        if req.status == "failed":
            # the fault layer dead-letters instead of crashing the loop; the
            # blocking API surfaces the error to its caller directly
            raise req.error
        return req.output_text
