"""Background pump: the always-on serving loop (``LLMServer(pump=True)``).

Without a pump the server is cooperative — nothing advances until some
caller drives ``step()``. The pump makes the server a standing service: a
daemon thread owns the engine loop, and caller threads interact through two
thread-safe surfaces:

* **the command queue** — ``submit`` / ``cancel`` / ``open_session`` /
  ``close_session`` / ``stats`` route their engine work through
  :meth:`call`, which runs the thunk *on the pump thread* between engine
  steps. JAX dispatch is not thread-safe across our program cache
  (fame/fusion.py learned this first), so the pump thread is the only
  thread that ever touches the engine. Every command pending at the top of
  a loop iteration executes before the next ``step()`` — a burst of submits
  from N workflow threads lands in one admission round and co-batches.
* **the progress condition** — handle streams (``Handle.stream()`` /
  ``result()``) and ``wait_idle()`` block on it; the pump notifies after
  every engine step, right after delivering freshly decoded text.

Liveness watchdog: the pump heartbeats every loop iteration. A waiter whose
wait outlives ``stall_timeout_s`` without a heartbeat — the pump is wedged
inside a jit dispatch, or its thread died — raises a typed
``PumpStalledError`` instead of hanging silently. A pump-loop crash
(engine-level exception that escaped the scheduler's failure isolation)
fails every outstanding request with the cause and wakes all waiters, so no
handle is ever stranded.

Shutdown: ``close()`` (or leaving the ``with LLMServer(...)`` block) stops
the loop; outstanding requests are cancelled *on the pump thread* before it
exits, so late waiters see a terminal ``CANCELLED`` status, not a hang.
``close(drain=True)`` finishes all queued/running work first.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Optional

from repro_torch.serving.faults import PumpStalledError

__all__ = ["PumpConfig", "BackgroundPump"]


@dataclasses.dataclass(frozen=True)
class PumpConfig:
    """Pump knobs.

    stall_timeout_s: heartbeat staleness after which waiters raise
                     ``PumpStalledError``. Must exceed the longest honest
                     engine step (a cold jit compile easily takes seconds —
                     keep this generous).
    poll_s:          waiter re-check period; also the idle loop's nap, so it
                     bounds how fast an idle pump notices new commands.
    """
    stall_timeout_s: float = 30.0
    poll_s: float = 0.05


class BackgroundPump:
    """Daemon thread driving ``server._step_impl()``; see module docstring."""

    def __init__(self, server, cfg: Optional[PumpConfig] = None):
        self.server = server
        self.cfg = cfg or PumpConfig()
        self._cv = threading.Condition()
        self._commands: "collections.deque" = collections.deque()
        self._stop = False
        self._crashed: Optional[BaseException] = None
        self._last_beat = time.monotonic()
        self._idle = threading.Event()
        self.steps = 0                  # pump loop iterations that stepped
        self.stall_notices = 0          # waiter-observed stalls (typed raises)
        self.thread = threading.Thread(target=self._loop,
                                       name="llmserver-pump", daemon=True)

    def start(self):
        self.thread.start()

    @property
    def alive(self) -> bool:
        return self.thread.is_alive() and self._crashed is None

    # ---- caller side -------------------------------------------------------
    def call(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` on the pump thread (between engine steps) and return
        its result; exceptions propagate to the caller. Re-entrant: called
        from the pump thread itself it just runs ``fn``."""
        if threading.current_thread() is self.thread:
            return fn()
        box: dict = {}
        done = threading.Event()
        with self._cv:
            if self._stop or not self.alive:
                raise PumpStalledError(
                    "pump is closed" if self._stop else
                    f"pump is dead: {self._crashed!r}")
            self._commands.append((fn, box, done))
            self._cv.notify_all()
        while not done.wait(self.cfg.poll_s):
            self._check_live("a queued command")
        if "exc" in box:
            raise box["exc"]
        return box["result"]

    def wait_progress(self):
        """Block until the pump completes another loop iteration (bounded
        by ``poll_s``); raises ``PumpStalledError`` on a stalled/dead pump.
        Handle streams call this between emptiness checks. A *cleanly*
        closed pump returns instead of raising: close() already cancelled
        every outstanding request on the pump thread, so the waiter's next
        ``request.finished`` check terminates its loop — a handle blocked
        in ``result()`` while another thread calls ``close()`` gets its
        partial CANCELLED output, not a spurious stall error."""
        with self._cv:
            self._cv.wait(self.cfg.poll_s)
        if self._closed_cleanly:
            return
        self._check_live("engine progress")

    def wait_idle(self):
        """Block until the engine is fully drained (no queued requests, no
        active slots, no pending commands). Returns (drained-by-
        cancellation) if the pump closes cleanly mid-wait."""
        while not self._idle.wait(self.cfg.poll_s):
            if self._closed_cleanly:
                return
            self._check_live("the engine to drain")

    def close(self, drain: bool = False, join_timeout_s: Optional[float] = None):
        """Stop the pump. ``drain=True`` finishes all outstanding work
        first; otherwise outstanding requests are cancelled on the pump
        thread before it exits (terminal CANCELLED, never stranded).

        Idempotent and race-safe: a second ``close()`` — sequential or
        racing the first from another thread — just joins the already-
        stopping thread; it never raises and never deadlocks (waiters see
        ``_closed_cleanly`` and unblock, see wait_progress)."""
        if drain and self._crashed is None and not self._stop \
                and self.thread.is_alive():
            try:
                self.wait_idle()
            except PumpStalledError:
                pass                    # crashed/stalled mid-drain: stop anyway
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if not self.thread.is_alive():
            return
        self.thread.join(join_timeout_s if join_timeout_s is not None
                         else self.cfg.stall_timeout_s)

    @property
    def _closed_cleanly(self) -> bool:
        """True once a requested close() has fully stopped the loop (no
        crash): the thread exited after cancelling all outstanding work."""
        return self._stop and self._crashed is None \
            and not self.thread.is_alive()

    def _check_live(self, waiting_for: str):
        if self._crashed is not None:
            raise PumpStalledError(
                f"pump crashed while waiting for {waiting_for}: "
                f"{self._crashed!r}") from self._crashed
        if not self.thread.is_alive():
            raise PumpStalledError(
                f"pump thread died while waiting for {waiting_for}")
        stale = time.monotonic() - self._last_beat
        if stale > self.cfg.stall_timeout_s:
            self.stall_notices += 1
            raise PumpStalledError(
                f"pump heartbeat stale for {stale:.1f}s "
                f"(stall_timeout_s={self.cfg.stall_timeout_s}) while "
                f"waiting for {waiting_for} — a dispatch is likely wedged")

    # ---- pump thread -------------------------------------------------------
    def _loop(self):
        try:
            while True:
                with self._cv:
                    cmds = list(self._commands)
                    self._commands.clear()
                    stop = self._stop
                if cmds:
                    self._idle.clear()
                for fn, box, done in cmds:
                    try:
                        box["result"] = fn()
                    except BaseException as e:
                        box["exc"] = e
                    done.set()
                if stop:
                    self._cancel_outstanding()
                    with self._cv:
                        self._cv.notify_all()
                    return
                outcome = self.server._step_impl()
                self.steps += 1
                with self._cv:
                    self._last_beat = time.monotonic()
                    self._cv.notify_all()
                if outcome:             # PROGRESSED or WAITING (engine step
                    self._idle.clear()  # already back-pressured internally)
                    continue
                self._idle.set()
                with self._cv:
                    if not self._commands and not self._stop:
                        self._cv.wait(self.cfg.poll_s)
        except BaseException as e:      # engine-level crash: fail everything
            self._crashed = e
            self._fail_outstanding(e)
            with self._cv:
                self._cv.notify_all()

    def _cancel_outstanding(self):
        eng = self.server.engine
        for h in list(self.server._handles.values()):
            if not h.request.finished:
                eng.cancel(h.request)
        self.server._deliver()

    def _fail_outstanding(self, exc: BaseException):
        """Best-effort: the engine may be in an arbitrary state — terminate
        every live handle typed so waiters unblock with a cause."""
        try:
            eng = self.server.engine
            for h in list(self.server._handles.values()):
                if not h.request.finished:
                    try:
                        eng._abort(h.request, "failed", PumpStalledError(
                            f"pump crashed mid-serve: {exc!r}"))
                    except BaseException:
                        h.request.status = "failed"
                        h.request.error = exc
                        h.request.finished = True
            self.server._deliver()
        except BaseException:
            pass
