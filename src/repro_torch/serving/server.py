"""Session-oriented continuous-batching serving frontend of the port.

A copy of ``repro.serving.server`` with the same public surface
(``LLMServer``, ``Session``, ``Handle``, ``SamplingParams``,
``EngineConfig``); the only addition is ``device=`` (default ``"cuda"``:
without a card the server raises unless the caller passes ``"cpu"``).

``LLMServer`` is the public face of the serving stack (the redesign of the
blocking ``ServingEngine.submit()/run_until_drained()`` loop): requests are
submitted as non-blocking **handles**, conversations live in **sessions**
whose end-of-generation state is retained for the next turn, output streams
incrementally off the engine's per-chunk host sync, and any handle can be
**cancelled** mid-flight.

    server = LLMServer(cfg, num_slots=4, capacity=512,
                       engine_cfg=EngineConfig(cache_mode="paged"))
    sess = server.open_session()
    h = sess.submit(conversation_text, SamplingParams(max_new_tokens=64))
    for piece in h.stream():          # incremental detokenized text
        print(piece, end="")
    text = h.result()                 # or just block for the full output

Concurrency model: by default the server is cooperative. ``submit`` only
queues; ``step()`` runs ONE engine iteration (admission + one decode chunk /
verify pass for every live slot) and distributes freshly decoded text to the
live handles. ``handle.stream()`` / ``handle.result()`` pump ``step()``
until their request completes — so N handles submitted before any of them
is drained co-batch inside the same engine steps, which is exactly how N
concurrent agent workflows share one model (``stats()
["active_slots_per_step"]`` measures it; benchmarks/session_bench.py gates
on it).

Always-on mode: ``LLMServer(cfg, pump=True)`` starts a background pump
(serving/pump.py) — a daemon thread that owns the engine loop. ``submit`` /
``cancel`` / session calls become thread-safe (they route through the
pump's command queue and run on the pump thread), handle streams block on
the pump's progress signal instead of stepping, and a wedged pump surfaces
as a typed ``PumpStalledError`` to whoever is waiting. Shut it down with
``server.close()`` or a ``with LLMServer(...) as server:`` block.

Overload control: pass ``overload=OverloadPolicy(...)`` to bound the
admission queue (typed ``OverloadError`` to submitters), shed queued
requests that cannot meet their deadline (terminal status ``"shed"``), and
preempt running low-priority decodes under admission pressure — preempted
requests resume bit-identically. See scheduler.OverloadPolicy.

Multi-turn reuse: a ``Session`` tracks its conversation; when turn N+1's
prompt extends turn N's text, the engine restores the retained tail state
(partial KV tail page on full-attention archs, end-of-generation state
snapshot on stateful archs — both at exact, non-block-aligned boundaries)
and prefills only the new message. See serving/scheduler.py for the
mechanics and docs/serving.md for the full reference.
"""
from __future__ import annotations

import collections
import enum
from typing import Dict, Iterator, List, Optional, Union

from repro_torch.serving.faults import (CorruptionError, DeadLetterError,
                                  DeadlineExceeded, FaultError, FaultInjector,
                                  OverloadError, PumpStalledError,
                                  RequestFault, RequestStatus, RetryPolicy,
                                  ShedError, TransientFault)
from repro_torch.serving.journal import SessionJournal
from repro_torch.serving.pump import BackgroundPump, PumpConfig
from repro_torch.serving.scheduler import (EngineConfig, OverloadPolicy, Request,
                                     SamplingParams, Scheduler)

__all__ = ["LLMServer", "Session", "Handle", "StepOutcome", "SamplingParams",
           "EngineConfig", "OverloadPolicy", "PumpConfig", "RequestStatus",
           "RetryPolicy", "FaultInjector", "SessionJournal", "FaultError",
           "TransientFault", "RequestFault", "CorruptionError",
           "DeadlineExceeded", "DeadLetterError", "OverloadError",
           "ShedError", "PumpStalledError"]


class StepOutcome(enum.Enum):
    """Tri-state result of ``LLMServer.step()``.

    PROGRESSED — the engine ran work (a decode chunk / verify / admission).
    WAITING    — nothing could advance, but queued work exists (every queued
                 request is in admission backoff; the engine already slept
                 toward the earliest retry, so a ``while server.step():``
                 loop cannot busy-spin).
    IDLE       — no queued and no running work.

    Truthiness preserves the old ``bool`` contract: IDLE is falsy,
    everything else truthy.
    """
    PROGRESSED = "progressed"
    WAITING = "waiting"
    IDLE = "idle"

    def __bool__(self) -> bool:
        return self is not StepOutcome.IDLE


def _utf8_holdback(ids: List[int]) -> int:
    """How many trailing tokens to withhold from an incremental decode:
    raw byte tokens (< 0x100) forming an incomplete UTF-8 sequence decode
    to replacement characters on their own, so the stream holds them back
    until the sequence completes (at most 3 tokens). Merge and special
    tokens are self-contained and never held."""
    n = 0
    i = len(ids) - 1
    while i >= 0 and n < 3 and 0x80 <= ids[i] <= 0xBF:   # continuation bytes
        i -= 1
        n += 1
    if i >= 0 and 0xC2 <= ids[i] <= 0xF4:                # lead byte
        need = 2 if ids[i] < 0xE0 else 3 if ids[i] < 0xF0 else 4
        if 1 + n < need:
            return n + 1                                 # lead + partial tail
    return 0


class Handle:
    """One in-flight (or finished) request.

    ``status()`` is a ``RequestStatus`` (serving/faults.py): ``QUEUED`` or
    ``RUNNING`` while live, then exactly one terminal state — ``COMPLETED``,
    ``CANCELLED``, ``TIMED_OUT`` (deadline elapsed), ``FAILED``
    (dead-lettered after a non-transient fault; ``exception()`` has the
    error), or ``SHED`` (dropped by the overload policy before running).
    ``text`` is everything streamed so far; after completion it equals
    ``result()`` (stop-trimmed). A preempted request transiently reports
    ``QUEUED`` again until its bit-identical resumption.
    """

    def __init__(self, server: "LLMServer", request: Request):
        self._server = server
        self.request = request
        self.text = ""
        self._pending: "collections.deque[str]" = collections.deque()
        self._sent = 0                  # generated tokens already delivered

    def status(self) -> RequestStatus:
        return RequestStatus(self.request.status)

    def exception(self) -> Optional[BaseException]:
        """The error that terminated this request (``FAILED`` /
        ``TIMED_OUT``), else None."""
        return self.request.error

    @property
    def done(self) -> bool:
        return self.request.finished

    def stream(self) -> Iterator[str]:
        """Yield detokenized text increments as they decode (one per engine
        chunk that emitted new text for this request). Cooperative servers
        pump ``step()`` between yields, so concurrently submitted handles
        keep decoding — their increments buffer in their own handles. With
        a background pump this blocks on the pump's progress signal instead
        (and raises ``PumpStalledError`` if the pump wedges or dies)."""
        while True:
            while self._pending:
                yield self._pending.popleft()
            if self.request.finished:
                return
            self._server._advance()

    def wait(self) -> "Handle":
        """Block until the request reaches a terminal status (without
        consuming the stream — increments stay buffered); returns self."""
        while not self.request.finished:
            self._server._advance()
        return self

    def result(self) -> str:
        """Block (cooperatively, or on the pump) until the request
        finishes; returns the full output text. A cancelled or timed-out
        handle returns its partial output (the deadline is a budget, not an
        error; the cause stays on ``exception()``). A FAILED or SHED handle
        re-raises its error."""
        for _ in self.stream():
            pass
        if self.request.status in ("failed", "shed"):
            raise self.request.error
        return self.request.output_text

    def cancel(self) -> bool:
        return self._server.cancel(self)

    # server-side delivery
    def _push(self, piece: str):
        self._pending.append(piece)
        self.text += piece


class Session:
    """One multi-turn conversation on an ``LLMServer``.

    Submit each turn's prompt as the FULL conversation text (what an agent
    frontend naturally re-sends); when it extends the previous turn's
    ``text`` (prompt + generated output), the engine reuses the retained
    end-of-generation state and prefills only the new part. One turn may be
    in flight at a time — turn N+1's prompt depends on turn N's output.
    """

    def __init__(self, server: "LLMServer", sid: int):
        self._server = server
        self.sid = sid
        self.closed = False

    @property
    def text(self) -> str:
        """Conversation so far: last submitted prompt + its generated
        output. Build the next turn's prompt by appending to this."""
        sess = self._server.engine._sessions.get(self.sid)
        return sess.text if sess is not None else ""

    @property
    def turns(self) -> int:
        sess = self._server.engine._sessions.get(self.sid)
        return sess.turns if sess is not None else 0

    @property
    def busy(self) -> bool:
        """True while a turn of this session is still queued or running."""
        sess = self._server.engine._sessions.get(self.sid)
        return (sess is not None and sess.live is not None
                and not sess.live.finished)

    def submit(self, prompt: str,
               params: Optional[SamplingParams] = None) -> Handle:
        if self.closed:
            raise RuntimeError(f"session {self.sid} is closed")
        return self._server.submit(prompt, params, session=self.sid)

    def close(self):
        """Release the session's retained tail state (pages / snapshot /
        radix pins); cancels a still-running turn. Thread-safe under a
        background pump (routed to the pump thread)."""
        if not self.closed:
            self._server._call(
                lambda: self._server.engine.close_session(self.sid))
            self.closed = True


class LLMServer:
    """Session-oriented continuous-batching server over the scheduler.

    ``pump=True`` (or a ``PumpConfig``) starts the background pump: the
    engine loop runs on a daemon thread, the submit/cancel/session surface
    becomes thread-safe, and the server must be shut down via ``close()``
    or a ``with`` block. ``overload=OverloadPolicy(...)`` enables bounded
    admission, load shedding, the dispatch circuit breaker, and priority
    preemption (see scheduler.py). ``device`` selects the card (default)
    or, only when asked, the CPU.
    """

    def __init__(self, cfg, *, num_slots: int = 4, capacity: int = 512,
                 params=None, seed: int = 0,
                 engine_cfg: Optional[EngineConfig] = None,
                 retry: Optional[RetryPolicy] = None,
                 default_deadline_s: Optional[float] = None,
                 injector: Optional[FaultInjector] = None,
                 journal_path: Optional[str] = None,
                 watchdog_s: Optional[float] = None,
                 overload: Optional[OverloadPolicy] = None,
                 pump: Union[bool, PumpConfig, None] = None,
                 device="cuda"):
        self.engine = Scheduler(cfg, num_slots=num_slots, capacity=capacity,
                                params=params, seed=seed,
                                engine_cfg=engine_cfg, retry=retry,
                                default_deadline_s=default_deadline_s,
                                injector=injector, journal_path=journal_path,
                                watchdog_s=watchdog_s, overload=overload,
                                device=device)
        self._handles: "dict[int, Handle]" = {}       # rid -> live handle
        self._pump: Optional[BackgroundPump] = None
        if pump:
            self._pump = BackgroundPump(
                self, pump if isinstance(pump, PumpConfig) else None)
            self._pump.start()

    # ---- pump plumbing -----------------------------------------------------
    @property
    def pumping(self) -> bool:
        """True while the background pump owns the engine loop."""
        return self._pump is not None and self._pump.alive

    def _call(self, fn):
        """Run ``fn`` on whichever thread owns the engine: inline when
        cooperative (or already on the pump thread), else through the
        pump's command queue. A dead pump (crashed) no longer owns the
        engine, so post-mortem reads run inline."""
        if self._pump is not None and self._pump.alive:
            return self._pump.call(fn)
        return fn()

    def _advance(self):
        """Make progress observable to a blocked waiter: one cooperative
        ``step()``, or a bounded wait on the pump's progress signal."""
        if self._pump is not None:
            self._pump.wait_progress()
        else:
            self.step()

    def close(self, drain: bool = False):
        """Shut the server down. With a pump: stop it — outstanding
        requests are cancelled on the pump thread first (``drain=True``
        finishes them instead), so nothing is stranded. Cooperative servers
        just cancel (or drain) outstanding handles."""
        if self._pump is not None:
            self._pump.close(drain=drain)
            self._pump = None
            return
        if drain:
            self.run_until_idle()
        for h in list(self._handles.values()):
            if not h.request.finished:
                self.engine.cancel(h.request)
        self._deliver()

    def __enter__(self) -> "LLMServer":
        return self

    def __exit__(self, *exc_info):
        self.close()

    # convenient passthroughs
    @property
    def params(self):
        return self.engine.params

    @property
    def device(self):
        return self.engine.device

    @property
    def mesh(self):
        """The serving device mesh (``EngineConfig(mesh=...)``; by default
        the degenerate 1x1 mesh of the server's device, unsharded)."""
        return self.engine.mesh

    @property
    def capacity(self) -> int:
        return self.engine.capacity

    @property
    def tokenizer(self):
        """The engine's tokenizer (stateless; safe to share across
        threads). Fleet fronts expose the same property, so callers that
        only encode/decode text — e.g. fame/bindings.py's delta billing —
        need not reach into ``server.engine``."""
        return self.engine.tokenizer

    def radix_digest(self) -> frozenset:
        """The engine's first-block radix keyspace digest (empty in dense
        mode), read on the engine-owning thread. serving/fleet.py routes
        prefix-affine placements with it."""
        return self._call(self.engine.radix_digest)

    def load_score(self) -> float:
        """Racy (lock-free) load heuristic for fleet routing — see
        Scheduler.load_score. Deliberately NOT routed through the pump: a
        router comparing N replicas must not pay N command round-trips per
        placement."""
        return self.engine.load_score()

    def stats(self) -> dict:
        out = self._call(self.engine.stats)
        if self._pump is not None:
            out.update({
                "pump_alive": self._pump.alive,
                "pump_steps": self._pump.steps,
                "pump_stall_notices": self._pump.stall_notices,
            })
        return out

    @property
    def journal(self) -> SessionJournal:
        """The crash-safe session journal (serving/journal.py). Pass
        ``journal_path=`` at construction to spill it to JSON after every
        turn; feed it (or its path) to a fresh server's
        ``restore_sessions()`` after a crash."""
        return self.engine.journal

    # ---- sessions / submission ---------------------------------------------
    def open_session(self) -> Session:
        return Session(self, self._call(self.engine.open_session))

    def restore_sessions(self, journal: Union[SessionJournal, str]
                         ) -> Dict[int, Session]:
        """Rebuild every session in ``journal`` (a ``SessionJournal`` or a
        path to a spilled JSON file) on this server: each journaled token
        stream is replayed through the normal prefill path, re-creating the
        retained tail state at its exact end-of-generation boundary — the
        next turn's greedy output is bit-identical to an uninterrupted
        server. Returns {old session id -> new live Session}."""
        if isinstance(journal, str):
            journal = SessionJournal.load(journal)

        def _restore():
            restored: Dict[int, Session] = {}
            for entry in journal.entries():
                sid = self.engine.restore_session(entry)
                restored[entry.sid] = Session(self, sid)
            return restored
        return self._call(_restore)

    def submit(self, prompt: str, params: Optional[SamplingParams] = None,
               *, session: Optional[int] = None,
               token_ids: Optional[List[int]] = None) -> Handle:
        """Queue a request (non-blocking) and return its handle. On a
        cooperative server nothing runs until someone pumps ``step()`` —
        usually via ``handle.stream()`` / ``handle.result()`` — so handles
        submitted together co-batch. With a background pump the submit is
        thread-safe (it runs on the pump thread between engine steps, so a
        burst of submits from many threads still lands in one admission
        round) and decoding starts immediately. Raises ``OverloadError``
        when the overload policy refuses admission."""
        def _submit():
            req = self.engine.enqueue(prompt, params, session=session,
                                      token_ids=token_ids)
            h = Handle(self, req)
            self._handles[req.rid] = h
            return h
        return self._call(_submit)

    def cancel(self, handle: Handle) -> bool:
        """Cancel a queued or running handle: its slot, private KV pages,
        and radix pins are released immediately; the handle keeps whatever
        partial text was already decoded. Thread-safe under a pump."""
        def _cancel():
            ok = self.engine.cancel(handle.request)
            self._deliver()
            return ok
        return self._call(_cancel)

    # ---- the step loop -----------------------------------------------------
    def step(self) -> StepOutcome:
        """One engine iteration for ALL live requests, then deliver newly
        decoded text to their handles. Returns a ``StepOutcome`` (truthy
        while there is work — see the enum; existing ``while step():``
        loops keep working). With a background pump running, the pump owns
        the loop: calling this from another thread raises."""
        if self.pumping:
            raise RuntimeError(
                "the background pump owns the step loop; wait on handles "
                "(stream()/result()) or run_until_idle() instead")
        return self._step_impl()

    def _step_impl(self) -> StepOutcome:
        progressed = self.engine.step()
        self._deliver()
        if progressed:
            return StepOutcome.PROGRESSED
        # queue non-empty with no progress => every queued request is in
        # admission backoff; engine.step() already slept toward the
        # earliest retry, so WAITING loops are back-pressured, not busy
        return (StepOutcome.WAITING if self.engine._queue
                else StepOutcome.IDLE)

    def run_until_idle(self):
        """Drain everything currently queued or running (blocks on the
        pump when one is running)."""
        if self._pump is not None:
            self._pump.wait_idle()
            return
        while self.step():
            pass

    def _deliver(self):
        """Distribute newly decoded (stop-trimmed) text to live handles —
        the streaming counterpart of the engine's one-host-sync-per-chunk
        contract: at most one delivery per handle per chunk.

        Increments are decoded from the NEW tokens only (O(chunk), not
        O(output so far)), holding back a trailing incomplete UTF-8
        sequence so a multi-byte character split across chunk syncs is
        delivered whole once its last byte lands — the concatenated stream
        always equals ``result()``."""
        eng = self.engine
        by_rid = {s.request.rid: s for s in eng.slots if s.request is not None}
        for rid, h in list(self._handles.items()):
            req = h.request
            if req.finished:
                ids = req.output_ids or []
                tail = eng.tokenizer.decode(ids[h._sent:])
                h._sent = len(ids)
                if tail:
                    h._push(tail)
                    eng._stream_chunks += 1
                del self._handles[rid]
                continue
            slot = by_rid.get(rid)
            if slot is None:
                continue
            avail = len(slot.generated) - _utf8_holdback(slot.generated)
            if avail > h._sent:
                piece = eng.tokenizer.decode(slot.generated[h._sent:avail])
                h._sent = avail
                if piece:                       # all-specials chunks skip
                    h._push(piece)
                    eng._stream_chunks += 1
