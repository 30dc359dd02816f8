"""Function fusion on the serving side: co-batched handles (§3.3.2).

The paper consolidates MCP servers into one Lambda so co-resident functions
share a container. On the serving stack the analogue is sharing *engine
steps*: agent invocations that would run in one fused container submit their
requests together and decode in the same continuous batch
(``active_slots_per_step > 1``), instead of each invocation draining the
server alone.

Two drivers with one contract — ``call(submit_thunk) -> finished Handle`` and
``run(thunks) -> results``:

* ``SerialDriver`` — the singleton deployment. Each agent turn drains before
  the next submits; one workflow owns the engine at a time.
* ``CoBatchDriver`` — the consolidated deployment. Workflow state machines
  run on worker threads, but **all** device work (submit + ``server.step()``)
  happens on a single pump thread: workers hand over submit thunks and
  block until their request reaches a terminal status. Pump order drains
  every pending submit before stepping, so turns from concurrent workflows
  co-batch inside one engine iteration.

When the server runs its own background pump (``LLMServer(pump=True)``,
serving/pump.py), both drivers ride it instead of stepping: ``submit()`` is
already thread-safe (it routes through the pump's command queue, which
drains every pending submit before the next engine step — the same
co-batching guarantee CoBatchDriver's inline loop provides), so workers
just submit and block on ``Handle.wait()``. CoBatchDriver then degenerates
to plain thread fan-out with the pump doing the driving.

The same ``pumping`` check makes both drivers ride a replica fleet
(``serving/fleet.py``): a ``FleetServer`` exposes ``pumping=True``, its
``submit`` routes each chain's session to its sticky replica, and
concurrent workflow chains co-batch *per replica* — chains placed together
(prefix affinity) share engine steps there, while the fleet spreads
unrelated chains across replicas.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional


class SerialDriver:
    """Drain-per-call driver: the unfused baseline. On a pumping server it
    cannot (and must not) step — it submits and blocks on the handle."""

    def __init__(self, server):
        self.server = server

    def call(self, submit: Callable[[], Any]):
        h = submit()
        if getattr(self.server, "pumping", False):
            return h.wait()
        while not h.request.finished:
            self.server.step()
        return h

    def run(self, thunks: List[Callable[[], Any]]) -> List[Any]:
        return [t() for t in thunks]


class CoBatchDriver:
    """Single-pump-thread co-batching driver.

    The engine is not thread-safe (scheduler state, in-place cache updates), so exactly
    one thread may touch the server. With a cooperative server this driver
    provides that thread itself (``run()`` pumps inline while workers hand
    over submit thunks); with ``LLMServer(pump=True)`` the server's
    background pump already owns the loop and gives the same
    submit-burst-then-step co-batching, so ``call()``/``run()`` just fan
    out workers and block on handles. ``call()`` with neither pump running
    (plain single-threaded use) degrades to SerialDriver behaviour.
    """

    def __init__(self, server):
        self.server = server
        self._cv = threading.Condition()
        self._pending: list = []        # (submit, box, event)
        self._inflight: list = []       # (handle, box, event)
        self._live_workers = 0
        self._pump_thread: Optional[threading.Thread] = None

    # ---- worker side -------------------------------------------------------
    def call(self, submit: Callable[[], Any]):
        if getattr(self.server, "pumping", False):
            return submit().wait()
        if (self._pump_thread is None
                or threading.current_thread() is self._pump_thread):
            h = submit()
            while not h.request.finished:
                self.server.step()
            return h
        box: dict = {}
        ev = threading.Event()
        with self._cv:
            self._pending.append((submit, box, ev))
            self._cv.notify()
        ev.wait()
        if "error" in box:
            raise box["error"]
        return box["handle"]

    # ---- pump side ---------------------------------------------------------
    def run(self, thunks: List[Callable[[], Any]]) -> List[Any]:
        """Run every thunk on its own worker thread while this thread pumps
        the server (or, on a pumping server, while the background pump
        drives); returns thunk results in order."""
        results: List[Any] = [None] * len(thunks)
        errors: List[Any] = [None] * len(thunks)

        def worker(i: int, thunk: Callable[[], Any]):
            try:
                results[i] = thunk()
            except BaseException as e:        # surfaced after join
                errors[i] = e
            finally:
                with self._cv:
                    self._live_workers -= 1
                    self._cv.notify()

        threads = [threading.Thread(target=worker, args=(i, t), daemon=True)
                   for i, t in enumerate(thunks)]
        if getattr(self.server, "pumping", False):
            with self._cv:
                self._live_workers = len(threads)
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            for e in errors:
                if e is not None:
                    raise e
            return results
        with self._cv:
            self._live_workers = len(threads)
        self._pump_thread = threading.current_thread()
        try:
            for th in threads:
                th.start()
            while True:
                with self._cv:
                    if (self._live_workers == 0 and not self._pending
                            and not self._inflight):
                        break
                    pending, self._pending = self._pending, []
                    if not pending and not self._inflight:
                        self._cv.wait(timeout=0.05)
                        continue
                # admit every pending submit before stepping -> co-batch
                for submit, box, ev in pending:
                    try:
                        h = submit()
                    except BaseException as e:
                        box["error"] = e
                        ev.set()
                    else:
                        self._inflight.append((h, box, ev))
                if self._inflight:
                    self.server.step()
                    still = []
                    for h, box, ev in self._inflight:
                        if h.request.finished:
                            box["handle"] = h
                            ev.set()
                        else:
                            still.append((h, box, ev))
                    self._inflight = still
            for th in threads:
                th.join()
        finally:
            self._pump_thread = None
        for e in errors:
            if e is not None:
                raise e
        return results
