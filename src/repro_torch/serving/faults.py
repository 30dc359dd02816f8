"""Fault-tolerance layer for the serving stack: typed request statuses,
retry policy, fault taxonomy, and a deterministic fault injector.

The FaaS layer the seed models (core/faas.py, core/workflow.py) gives every
stage a timeout, a retry-with-backoff policy, and durable state it can be
replayed from — this module mirrors those semantics onto the real engine so
a device error, a stuck jit step, or a poisoned request fails ONE handle
instead of crashing the pump and stranding every co-batched session.

Taxonomy (all subclasses of ``RuntimeError``):

* ``TransientFault`` — engine-level and plausibly temporary (injected device
  error, pool contention). The jit-dispatch layer (serving/programs.py)
  retries these per ``RetryPolicy`` with exponential backoff + jitter.
* ``RequestFault`` — permanently scoped to one request (bad params that
  escaped validation, a request that can never fit the page pool). Fails
  only the owning handle; co-batched requests are untouched.
* ``CorruptionError`` — a ``RequestFault`` raised when a page / snapshot id
  is detected corrupt at the point it would be consumed.
* ``DeadlineExceeded`` — recorded on handles cancelled by deadline expiry.
* ``DeadLetterError`` — retries exhausted; recorded on the dead-lettered
  handle(s) (``handle.exception()``).
* ``OverloadError`` — admission refused by the overload policy (bounded
  queue full, per-class depth cap, or circuit breaker open). Raised
  synchronously from ``enqueue``/``submit`` — the request never existed.
* ``ShedError`` — an ``OverloadError`` recorded on an *accepted* request
  that the scheduler later shed from the queue (aged out, or its remaining
  deadline can no longer cover the predicted service time). The handle
  terminates with status ``"shed"`` instead of limping to a timeout.
* ``PumpStalledError`` — the background pump (serving/pump.py) stopped
  heartbeating while work was pending; surfaced to waiters instead of a
  silent hang.

Retry safety: injected faults are raised *before* the device dispatch, so a
retried call re-runs bit-identically. A real exception escaping a jit call
is never retried — with buffer donation on, the inputs may already be
consumed — it fails the affected handles instead (the scheduler's
failure-isolation paths) and the pump keeps serving.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import random
import threading
import time
from typing import Dict, Optional

__all__ = ["RequestStatus", "RetryPolicy", "FaultInjector", "FaultError",
           "TransientFault", "RequestFault", "CorruptionError",
           "DeadlineExceeded", "DeadLetterError", "OverloadError",
           "ShedError", "PumpStalledError"]


class RequestStatus(str, enum.Enum):
    """Lifecycle of a request/handle. Every request terminates in exactly
    one of the five terminal states — step-loop exceptions no longer
    propagate to whichever caller happened to be pumping."""
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"       # finalized normally (EOS / budget / stop)
    CANCELLED = "cancelled"       # explicit cancel(); partial output kept
    TIMED_OUT = "timed_out"       # deadline_s expired; partial output kept
    FAILED = "failed"             # dead-lettered; handle.exception() has why
    SHED = "shed"                 # dropped by overload policy before running

    @property
    def terminal(self) -> bool:
        return self in (RequestStatus.COMPLETED, RequestStatus.CANCELLED,
                        RequestStatus.TIMED_OUT, RequestStatus.FAILED,
                        RequestStatus.SHED)


class FaultError(RuntimeError):
    """Base of the serving fault taxonomy."""


class TransientFault(FaultError):
    """Engine-level, plausibly temporary: retried per ``RetryPolicy``."""


class RequestFault(FaultError):
    """Permanently scoped to one request: fails only that handle."""


class CorruptionError(RequestFault):
    """A corrupted page / snapshot id detected before it was consumed."""


class DeadlineExceeded(FaultError):
    """The request's ``deadline_s`` elapsed before it finished."""


class DeadLetterError(FaultError):
    """Bounded retries exhausted; the request is dead-lettered."""


class OverloadError(FaultError):
    """Admission refused by the overload policy (queue/class caps, circuit
    breaker). Raised synchronously from ``enqueue``/``submit``."""


class ShedError(OverloadError):
    """An accepted request shed from the queue by the overload policy
    (queue-age cap, or predicted service time exceeds the remaining
    deadline). Recorded on handles with terminal status ``"shed"``."""


class PumpStalledError(FaultError):
    """The background pump stopped heartbeating (or died) while work was
    pending; raised to blocked waiters instead of hanging them."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter — the ``core/workflow.Retry`` shape
    applied to jit dispatches and paged-admission retries.

    max_attempts: total tries (first attempt included) before dead-letter.
    backoff_s:    delay before the first retry.
    backoff_rate: multiplier per further retry.
    jitter:       fractional random spread added on top (0 = deterministic),
                  decorrelating co-queued retries so they don't re-collide.
    """
    max_attempts: int = 3
    backoff_s: float = 0.02
    backoff_rate: float = 2.0
    jitter: float = 0.25

    def delay(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        d = self.backoff_s * self.backoff_rate ** max(attempt - 1, 0)
        if self.jitter:
            d *= 1.0 + self.jitter * (rng or random).random()
        return d


class FaultInjector:
    """Deterministic chaos hooks for the scheduler / kvpool / jit-program
    layers (tests/test_chaos.py, ``benchmarks/session_bench.py --chaos``).

    Hook sites (strings): the jit dispatches ``"prefill"``, ``"extend"``,
    ``"extend_paged"``, ``"decode"``, ``"verify"``, ``"snap_capture"``,
    ``"snap_restore"`` (checked by ``EnginePrograms`` via :meth:`check`,
    which may raise or stall) and the allocators ``"pool.alloc"`` /
    ``"snap.alloc"`` (checked via :meth:`take`, which denies the allocation
    — simulated exhaustion — instead of raising).

    Two arming modes compose:

    * **counted** — ``fail_next(site, n)`` / ``exhaust_next(site, n)`` /
      ``stall_next(site, n, stall_s)`` arm the next ``n`` hits of a site.
    * **rate** — ``rates={"decode": 0.05}`` fires a ``TransientFault`` on
      ~5% of hits, drawn from a seeded ``random.Random`` so a chaos run is
      reproducible given the seed and the same call sequence.

    ``injected`` counts every fired fault by site (suffix ``.deny`` for
    allocator denials, ``.stall`` for stalls).

    Thread safety: hook sites are hit from the pump thread while tests and
    callers arm faults from their own threads, so every armed-queue pop,
    seeded-RNG draw, and counter bump happens under one lock. (The lock is
    *not* held across a stall sleep — a stall must not serialize unrelated
    sites.) Determinism under concurrency is per-thread-interleaving: a
    single-threaded call sequence replays bit-identically given the seed.
    """

    def __init__(self, seed: int = 0, rates: Optional[Dict[str, float]] = None):
        self._rng = random.Random(seed)
        self.rates: Dict[str, float] = dict(rates or {})
        self._armed: Dict[str, list] = collections.defaultdict(list)
        self._deny: collections.Counter = collections.Counter()
        self.injected: collections.Counter = collections.Counter()
        self._lock = threading.Lock()

    # ---- arming ------------------------------------------------------------
    def fail_next(self, site: str, n: int = 1, *, exc=TransientFault,
                  msg: Optional[str] = None):
        """Arm the next ``n`` dispatches of ``site`` to raise ``exc``."""
        with self._lock:
            for _ in range(n):
                self._armed[site].append(
                    ("raise", exc(msg or f"injected fault at {site!r}")))

    def exhaust_next(self, site: str = "pool.alloc", n: int = 1):
        """Arm the next ``n`` allocations at ``site`` to be denied (the
        allocator behaves as if exhausted)."""
        with self._lock:
            self._deny[site] += n

    def stall_next(self, site: str, n: int = 1, *, stall_s: float = 0.05):
        """Arm the next ``n`` dispatches of ``site`` to stall ``stall_s``
        (a stuck step for the watchdog to notice)."""
        with self._lock:
            for _ in range(n):
                self._armed[site].append(("stall", stall_s))

    # ---- hook points -------------------------------------------------------
    def check(self, site: str):
        """Dispatch hook: consume one armed action (raise / stall) or roll
        the site's rate for a ``TransientFault``."""
        with self._lock:
            q = self._armed.get(site)
            if q:
                kind, val = q.pop(0)
                if kind == "stall":
                    self.injected[site + ".stall"] += 1
                else:
                    self.injected[site] += 1
                    raise val
            else:
                r = self.rates.get(site)
                if not (r and self._rng.random() < r):
                    return
                self.injected[site] += 1
                raise TransientFault(
                    f"injected fault at {site!r} (rate {r})")
        time.sleep(val)  # stall: sleep outside the lock

    def take(self, site: str) -> bool:
        """Allocator hook: True = deny this allocation (simulated
        exhaustion). Never raises — the caller's normal out-of-resource
        path (eviction, admission backoff, skipped capture) must handle it."""
        with self._lock:
            if self._deny.get(site, 0) > 0:
                self._deny[site] -= 1
                self.injected[site + ".deny"] += 1
                return True
            r = self.rates.get(site)
            if r and self._rng.random() < r:
                self.injected[site + ".deny"] += 1
                return True
            return False
