"""Replica fleet serving of the port: N independent engines behind one
front door.

A port of ``repro.serving.fleet`` with the same surface (``FleetServer``,
``FleetSession``, ``ReplicaRouter``). What differs: ``device=`` (the card
by default; the CPU only when asked) is handed to every replica, and a
replica's sub-mesh (``meshes=`` / ``add_replica(mesh=)``) must lead on that
device; and on the card each replica's pump thread
captures and replays its own CUDA graphs (serving/programs.py), which take
turns only to capture.

One ``LLMServer`` + ``BackgroundPump`` is a single standing service — its
ceiling is one device's slot count. ``FleetServer`` is the FaaS-shaped next
rung (ROADMAP: "data-parallel replica groups behind one scheduler"): it
fronts N fully independent replicas — each its own ``LLMServer`` with its
own pump, cache pools and radix trie — behind
the same ``open_session`` / ``submit`` / ``stream`` / ``cancel`` surface,
so everything written against ``LLMServer`` (the FAME drivers in
fame/fusion.py included) runs against a fleet unchanged.

Placement (``ReplicaRouter``), in order:

1. **Prefix affinity** — every replica exports a cheap radix *keyspace
   digest*: the hashes of its trie's first-block edge labels
   (``RadixTree.keyspace_digest``). A new prompt whose leading
   ``page_size``-token block appears in a replica's digest lands there —
   where the shared pages / state snapshots already live — because agent
   traffic is prefix-heavy and a radix hit beats an idle replica's cold
   prefill. Digests are cached per replica with a short TTL so routing
   costs no pump round-trip on the hot path.
2. **Least-loaded EWMA fallback** — no digest hit (or dense mode): pick
   the replica minimizing (queued + running) × EWMA per-token decode
   service time (the overload predictor), tie-broken by fewest
   placements so cold replicas spread instead of piling on replica 0.
3. **Overload spill** — a saturated replica (admission queue at its
   ``OverloadPolicy.max_queue_depth``) is skipped while any peer has
   headroom, and a typed ``OverloadError`` from the chosen replica retries
   the remaining candidates in load order — the fleet spills *before* a
   single replica sheds. Only when every replica refuses does the error
   propagate.

Sessions are **sticky**: a ``FleetSession`` pins to a replica at its first
turn (placed by that turn's prompt) and every later turn goes to the same
replica, where its retained tail state lives. Turn submissions never spill
— an ``OverloadError`` on a pinned replica propagates, like a single
server.

Failover: replica death (pump crash / stall-death — ``server.pumping``
goes False, waiters see ``PumpStalledError``) is detected on the next
routing decision (or an explicit ``check_health()``). The dead replica's
in-memory ``SessionJournal`` remains readable post-mortem, and every fleet
session pinned there is **migrated**: its journal entry is replayed onto a
healthy peer via the scheduler's ``restore_session`` — the same
token-level replay ``LLMServer.restore_sessions`` uses — so the next
turn's greedy output is bit-identical to an uninterrupted server. The
in-flight turn at crash time fails typed (the pump already terminated it);
completed turns survive. Elastic scale mirrors this: ``drain(i)``
quiesces a replica, migrates its sessions, and closes it;
``add_replica()`` brings a new engine online sharing the fleet's weights.

All replicas share one ``TransformerParams`` object (reads only — nothing
writes weights; a state dict would go through ``Model.load`` and be copied
once per replica), so an N-replica fleet costs N× cache/activation memory
(and N graph pools on the card) but 1× weights, and greedy outputs are
bit-identical across replicas.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Union

from repro_torch.serving.faults import OverloadError, PumpStalledError
from repro_torch.serving.journal import SessionJournal
from repro_torch.serving.pump import PumpConfig
from repro_torch.serving.scheduler import (EngineConfig, OverloadPolicy,
                                           SamplingParams)
from repro_torch.serving.server import Handle, LLMServer, Session, StepOutcome
from repro_torch.serving.tokenizer import ByteTokenizer

__all__ = ["FleetServer", "FleetSession", "ReplicaRouter"]


@dataclasses.dataclass(eq=False)       # identity semantics: usable in sets
class _Replica:
    """One engine behind the fleet front, plus its routing bookkeeping."""
    idx: int
    server: LLMServer
    pumped: bool                      # replicas built with a background pump
    draining: bool = False            # drain() in progress: no new placements
    failed: bool = False              # pump died; sessions migrated away
    removed: bool = False             # drained + closed (index stays stable)
    routed: int = 0                   # placements landed here (tie-break)
    digest: frozenset = frozenset()   # cached radix keyspace digest
    digest_t: float = -1.0            # monotonic time of the cached digest

    @property
    def healthy(self) -> bool:
        """Eligible for new placements and still able to serve."""
        if self.draining or self.failed or self.removed:
            return False
        return self.server.pumping if self.pumped else True


class ReplicaRouter:
    """Placement policy: prefix affinity, then least-loaded EWMA.

    Stateless beyond the per-replica digest cache it maintains (on the
    ``_Replica`` records); safe to call from many submitter threads — a
    racing double-refresh of one digest is harmless.
    """

    def __init__(self, page_size: int, digest_ttl_s: float = 0.25):
        self.page_size = page_size
        self.digest_ttl_s = digest_ttl_s

    def head_key(self, ids) -> Optional[int]:
        """Hash of the prompt's first radix block (``page_size`` tokens) —
        the unit the keyspace digest indexes. None when the prompt is
        shorter than one block (nothing shareable to route on)."""
        if ids is None or len(ids) < self.page_size:
            return None
        return hash(tuple(ids[:self.page_size]))

    def load(self, r: _Replica):
        return (r.server.load_score(), r.routed, r.idx)

    def digest_of(self, r: _Replica) -> frozenset:
        now = time.monotonic()
        if now - r.digest_t > self.digest_ttl_s:
            try:
                r.digest = r.server.radix_digest()
            except PumpStalledError:
                r.digest = frozenset()          # dying replica: no affinity
            r.digest_t = now
        return r.digest

    def order(self, cands: List[_Replica], ids
              ) -> "tuple[List[_Replica], set]":
        """Candidates in preference order + the affinity subset. Affinity
        matches (digest contains the prompt's first block) come first,
        each group sorted least-loaded."""
        key = self.head_key(ids)
        aff = [r for r in cands
               if key is not None and key in self.digest_of(r)]
        rest = [r for r in cands if r not in aff]
        aff.sort(key=self.load)
        rest.sort(key=self.load)
        return aff + rest, set(aff)


class FleetSession:
    """One multi-turn conversation on the fleet — same contract as
    ``server.Session``, plus replica stickiness and transparent migration.

    The session pins to a replica lazily at its FIRST turn (so placement
    can use that turn's prompt for affinity); every later turn is served by
    the pinned replica, whose retained tail state makes the turn a
    delta-prefill. If the pinned replica dies or drains, the next turn
    transparently lands on a healthy peer with the journaled conversation
    replayed (greedy-bit-identical continuation)."""

    def __init__(self, fleet: "FleetServer", sid: int):
        self._fleet = fleet
        self.sid = sid                      # fleet-level id (router-stable)
        self.closed = False
        self._replica: Optional[_Replica] = None
        self._sess: Optional[Session] = None   # underlying replica session

    @property
    def replica_index(self) -> Optional[int]:
        """Index of the pinned replica (None before the first turn)."""
        return self._replica.idx if self._replica is not None else None

    @property
    def text(self) -> str:
        return self._sess.text if self._sess is not None else ""

    @property
    def turns(self) -> int:
        return self._sess.turns if self._sess is not None else 0

    @property
    def busy(self) -> bool:
        return self._sess.busy if self._sess is not None else False

    def submit(self, prompt: str,
               params: Optional[SamplingParams] = None) -> Handle:
        if self.closed:
            raise RuntimeError(f"fleet session {self.sid} is closed")
        return self._fleet._submit_session(self, prompt, params, None)

    def close(self):
        """Release the pinned replica's retained tail state and forget the
        session fleet-wide. Safe on a dead replica (nothing to release —
        its device state died with it)."""
        if self.closed:
            return
        self.closed = True
        with self._fleet._lock:
            self._fleet._sessions.pop(self.sid, None)
        if (self._sess is not None and self._replica is not None
                and not self._replica.removed):
            try:
                self._sess.close()
            except PumpStalledError:
                pass                        # replica died underneath us


class FleetServer:
    """N independent ``LLMServer`` replicas behind one serving surface.

    Construction mirrors ``LLMServer`` (every per-engine knob, ``device``
    included, is applied to each replica) plus ``num_replicas``. ``meshes``
    gives each replica its own sub-mesh (``EngineConfig.mesh``; one entry a
    replica). ``pump=True`` (default) gives every replica its
    own background pump; ``pump=False`` builds cooperative replicas driven
    by ``FleetServer.step()`` (single-threaded determinism for tests).

    Thread-safety matches a pumping ``LLMServer``: submit / session /
    cancel / stats may be called from any thread. The fleet lock guards
    only routing bookkeeping and the session map — never a pump round-trip
    on the submit hot path — so admission to different replicas proceeds
    concurrently.
    """

    def __init__(self, cfg, *, num_replicas: int = 2, num_slots: int = 4,
                 capacity: int = 512, params=None, seed: int = 0,
                 engine_cfg: Optional[EngineConfig] = None,
                 retry=None, default_deadline_s: Optional[float] = None,
                 injector=None, watchdog_s: Optional[float] = None,
                 overload: Optional[OverloadPolicy] = None,
                 pump: Union[bool, PumpConfig, None] = True,
                 meshes: Optional[list] = None,
                 digest_ttl_s: float = 0.25, device="cuda"):
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        if meshes is not None and len(meshes) != num_replicas:
            raise ValueError(f"meshes has {len(meshes)} entries for "
                             f"{num_replicas} replicas")
        self.cfg = cfg
        self._engine_cfg = engine_cfg or EngineConfig()
        self._server_kw = dict(num_slots=num_slots, capacity=capacity,
                               seed=seed, retry=retry,
                               default_deadline_s=default_deadline_s,
                               injector=injector, watchdog_s=watchdog_s,
                               overload=overload, pump=pump,
                               device=device)
        self._pumped = bool(pump)
        self._lock = threading.RLock()
        self.router = ReplicaRouter(self._engine_cfg.page_size,
                                    digest_ttl_s=digest_ttl_s)
        self.tokenizer = ByteTokenizer(cfg.vocab_size)
        self._replicas: List[_Replica] = []
        self._sessions: Dict[int, FleetSession] = {}
        self._next_fsid = 0
        self._closed = False
        # fleet gauges (see stats())
        self._routed = 0
        self._affinity_hits = 0
        self._spilled = 0
        self._migrated = 0
        self._replicas_failed = 0
        self._replicas_drained = 0
        # replica 0 initializes (or loads) the weights once; every peer
        # gets the same TransformerParams object (reads only) — 1× weight
        # memory, bit-identical greedy; a peer on a sub-mesh lays it out on
        # its mesh (its "model" parts are its own)
        first = self._make_server(params, meshes[0] if meshes else None)
        self._params = first.params
        self._replicas.append(_Replica(0, first, self._pumped))
        for i in range(1, num_replicas):
            self._replicas.append(_Replica(
                i, self._make_server(self._params, meshes[i] if meshes else None),
                self._pumped))

    def _make_server(self, params, mesh) -> LLMServer:
        ecfg = self._engine_cfg
        if mesh is not None:
            ecfg = dataclasses.replace(ecfg, mesh=mesh)
        return LLMServer(self.cfg, params=params, engine_cfg=ecfg,
                         **self._server_kw)

    # ---- introspection -----------------------------------------------------
    @property
    def params(self):
        return self._params

    @property
    def replicas(self) -> List[_Replica]:
        """The replica records (index-stable: removed replicas keep their
        slot, flagged ``removed``). Tests and benches reach through
        ``replicas[i].server`` for chaos injection."""
        return self._replicas

    @property
    def num_replicas(self) -> int:
        """Replicas currently able to take traffic."""
        return sum(1 for r in self._replicas if r.healthy)

    @property
    def pumping(self) -> bool:
        """True while any replica's background pump is alive — the FAME
        drivers key off this exactly as they do for one ``LLMServer``."""
        return any(r.pumped and r.server.pumping for r in self._replicas
                   if not r.removed)

    def stats(self) -> dict:
        """Fleet gauges + a curated cross-replica aggregate + every
        replica's own ``stats()`` under ``per_replica`` (None for removed
        slots). Counters sum; ``queue_age_max_s`` / ``ewma_decode_s_per_tok``
        take the max (a fleet is as slow as its slowest member)."""
        per = [None if r.removed else r.server.stats()
               for r in self._replicas]
        live = [p for p in per if p is not None]
        sum_keys = [
            "decode_tokens", "prompt_tokens", "prefix_hit_tokens",
            "queued_requests", "live_requests", "sessions_opened",
            "session_turns", "turn_prefix_hits", "cancelled_requests",
            "shed_requests", "preemptions", "preempt_resumes",
            "breaker_trips", "timed_out", "dead_lettered",
            "dispatch_retries", "admission_retries", "watchdog_stalls",
            "journaled_sessions", "stream_chunks", "grouped_admissions",
            "engine_steps", "pump_steps", "pump_stall_notices",
        ]
        with self._lock:
            out = {
                "fleet_replicas": self.num_replicas,
                "fleet_replicas_total": len(self._replicas),
                "replicas_failed": self._replicas_failed,
                "replicas_drained": self._replicas_drained,
                "routed_requests": self._routed,
                "affinity_hits": self._affinity_hits,
                "affinity_rate": self._affinity_hits / max(self._routed, 1),
                "spilled_admissions": self._spilled,
                "migrated_sessions": self._migrated,
                "fleet_sessions": len(self._sessions),
            }
        for k in sum_keys:
            out[k] = sum(p.get(k, 0) for p in live)
        out["queue_age_max_s"] = max(
            (p.get("queue_age_max_s", 0.0) for p in live), default=0.0)
        out["ewma_decode_s_per_tok"] = max(
            (p.get("ewma_decode_s_per_tok", 0.0) for p in live), default=0.0)
        out["prefix_hit_rate"] = (out["prefix_hit_tokens"]
                                  / max(out["prompt_tokens"], 1))
        out["per_replica"] = per
        return out

    # ---- health / failover -------------------------------------------------
    def check_health(self) -> List[int]:
        """Detect replicas whose pump died (crash or stall-death) and
        migrate their sessions to healthy peers. Runs implicitly on every
        routing decision; call it directly to force failover without
        traffic. Returns the indices newly marked failed."""
        if not self._pumped:
            return []                   # cooperative replicas cannot crash
        with self._lock:
            newly = [r for r in self._replicas
                     if not (r.removed or r.failed or r.draining)
                     and not r.server.pumping]
            for r in newly:
                self._fail_replica(r)
            return [r.idx for r in newly]

    def _fail_replica(self, r: _Replica):
        """Mark ``r`` dead and journal-replay-migrate its sessions. The
        dead pump no longer owns its engine, so the engine's host-side
        journal is readable inline post-mortem; device-side turn state is
        gone, which is exactly what the token-level replay rebuilds."""
        r.failed = True
        self._replicas_failed += 1
        for fs in [fs for fs in self._sessions.values()
                   if fs._replica is r]:
            try:
                self._migrate_session(fs, close_src=False)
            except PumpStalledError:
                pass    # no healthy peer: surfaced on the session's next turn

    def _migrate_session(self, fs: FleetSession, *, close_src: bool):
        """Re-home ``fs`` onto the least-loaded healthy peer by replaying
        its journal entry (scheduler.restore_session — the crash-recovery
        path, greedy-bit-identical). A session with no journaled turn yet
        has no state to carry; it re-pins fresh."""
        src = fs._replica
        entry = None
        if fs._sess is not None and src is not None:
            entry = src.server.engine.journal.get(fs._sess.sid)
            if close_src:
                try:
                    fs._sess.close()
                except PumpStalledError:
                    pass
        cands = [r for r in self._replicas if r.healthy and r is not src]
        if not cands:
            raise PumpStalledError(
                f"fleet session {fs.sid}: no healthy replica to migrate to")
        target = min(cands, key=self.router.load)
        if entry is not None:
            new_sid = target.server._call(
                lambda: target.server.engine.restore_session(entry))
            fs._sess = Session(target.server, new_sid)
        else:
            fs._sess = target.server.open_session()
        fs._replica = target
        target.routed += 1
        self._migrated += 1

    # ---- elastic scale -----------------------------------------------------
    def drain(self, index: int):
        """Scale-in: quiesce replica ``index`` (no new placements), finish
        its outstanding work, migrate its sessions to peers, and close it.
        Its slot in ``replicas`` stays (flagged ``removed``) so indices
        remain stable. Raises if it is the last healthy replica and it
        still owns sessions (nowhere to migrate)."""
        r = self._replicas[index]
        if r.removed:
            raise ValueError(f"replica {index} already removed")
        r.draining = True
        if not r.failed:
            r.server.run_until_idle()
        with self._lock:
            for fs in [fs for fs in self._sessions.values()
                       if fs._replica is r]:
                self._migrate_session(fs, close_src=not r.failed)
            r.server.close()
            r.removed = True
            self._replicas_drained += 1

    def add_replica(self, *, mesh=None) -> int:
        """Scale-out: bring a new replica online (sharing the fleet's
        weight tensors) and return its index. It starts cold — the router's
        least-loaded tie-break steers new placements toward it, its radix
        digest earns affinity traffic as its cache warms, and on the card it
        captures its own graphs at its first decode chunks."""
        srv = self._make_server(self._params, mesh)
        with self._lock:
            r = _Replica(len(self._replicas), srv, self._pumped)
            self._replicas.append(r)
            return r.idx

    # ---- routing -----------------------------------------------------------
    def _saturated(self, r: _Replica) -> bool:
        """Admission queue at the replica's OverloadPolicy bound — one more
        submit would displace or refuse. Racy read, same caveat as
        load_score."""
        ov = self._server_kw["overload"]
        if ov is None or ov.max_queue_depth is None:
            return False
        return len(r.server.engine._queue) >= ov.max_queue_depth

    def _place(self, ids, do_submit):
        """Route one placement: affinity-first candidate order, saturation
        spill, typed-overload retry across peers. ``do_submit(replica)``
        performs the replica-level action; returns (replica, its result).
        """
        self.check_health()
        with self._lock:
            cands = [r for r in self._replicas if r.healthy]
        if not cands:
            raise PumpStalledError("fleet has no healthy replicas")
        order, aff = self.router.order(cands, ids)
        last_exc = None
        for i, r in enumerate(order):
            # spill BEFORE invoking a saturated replica's shed path, as
            # long as some later candidate still has queue headroom
            if self._saturated(r) and any(not self._saturated(p)
                                          for p in order[i + 1:]):
                last_exc = last_exc or OverloadError(
                    f"replica {r.idx} admission queue full")
                continue
            try:
                res = do_submit(r)
            except OverloadError as e:          # refused: try the next peer
                last_exc = e
                continue
            except PumpStalledError as e:       # died under us: fail + retry
                with self._lock:
                    if not r.failed and not r.removed:
                        self._fail_replica(r)
                last_exc = e
                continue
            with self._lock:
                self._routed += 1
                r.routed += 1
                if r in aff:
                    self._affinity_hits += 1
                if r is not order[0]:
                    self._spilled += 1
            return r, res
        raise last_exc if last_exc is not None else OverloadError(
            "every replica refused admission")

    # ---- the LLMServer surface ---------------------------------------------
    def open_session(self) -> FleetSession:
        with self._lock:
            self._next_fsid += 1
            fs = FleetSession(self, self._next_fsid)
            self._sessions[fs.sid] = fs
        return fs

    def submit(self, prompt: str, params: Optional[SamplingParams] = None,
               *, session: Optional[int] = None,
               token_ids: Optional[List[int]] = None) -> Handle:
        """Queue one request on the best replica and return its handle
        (replica handles stream/cancel exactly like single-server ones).
        ``session=`` takes a FLEET session id — the turn goes to the
        session's pinned replica (sticky), migrating first if that replica
        died. Sessionless submits are placed fresh per request."""
        if session is not None:
            with self._lock:
                fs = self._sessions.get(session)
            if fs is None:
                raise ValueError(f"unknown fleet session id {session}")
            return self._submit_session(fs, prompt, params, token_ids)
        ids = token_ids if token_ids is not None \
            else self.tokenizer.encode(prompt)
        _, h = self._place(ids, lambda r: r.server.submit(
            prompt, params, token_ids=token_ids))
        return h

    def _submit_session(self, fs: FleetSession, prompt, params,
                        token_ids) -> Handle:
        if fs.closed:
            raise RuntimeError(f"fleet session {fs.sid} is closed")
        self.check_health()
        with self._lock:
            if fs._replica is not None and not fs._replica.healthy:
                # pinned replica died or is draining: journal-replay the
                # conversation onto a healthy peer, then continue there
                self._migrate_session(
                    fs, close_src=not (fs._replica.failed
                                       or fs._replica.removed))
        if fs._replica is None:
            # first turn: place by THIS prompt (affinity-aware), pin, and
            # submit on the pinned replica — sticky from here on
            ids = token_ids if token_ids is not None \
                else self.tokenizer.encode(prompt)

            def open_and_pin(r: _Replica):
                sess = r.server.open_session()
                return sess

            r, sess = self._place(ids, open_and_pin)
            fs._replica, fs._sess = r, sess
        # sticky turns do not spill: the retained tail lives here
        return fs._replica.server.submit(prompt, params,
                                         session=fs._sess.sid,
                                         token_ids=token_ids)

    def restore_sessions(self, journal: Union[SessionJournal, str]
                         ) -> Dict[int, FleetSession]:
        """Rebuild every journaled session across the fleet (least-loaded
        placement, one ``restore_session`` replay per entry — greedy
        continuation is bit-identical, as on a single server). Returns
        {old session id -> new FleetSession}."""
        if isinstance(journal, str):
            journal = SessionJournal.load(journal)
        out: Dict[int, FleetSession] = {}
        for entry in journal.entries():
            fs = self.open_session()
            r, sid = self._place(
                list(entry.all_tokens),
                lambda r: r.server._call(
                    lambda: r.server.engine.restore_session(entry)))
            fs._replica, fs._sess = r, Session(r.server, sid)
            out[entry.sid] = fs
        return out

    def cancel(self, handle: Handle) -> bool:
        """Cancel a handle on whichever replica owns it."""
        return handle.cancel()

    # ---- driving / lifecycle -----------------------------------------------
    def step(self) -> StepOutcome:
        """Cooperative fleets only: one engine iteration on EVERY healthy
        replica (the fleet-level analogue of ``LLMServer.step()``)."""
        if self.pumping:
            raise RuntimeError(
                "the background pumps own the step loops; wait on handles "
                "(stream()/result()) or run_until_idle() instead")
        out = StepOutcome.IDLE
        for r in self._replicas:
            if r.removed or r.failed:
                continue
            o = r.server.step()
            if o is StepOutcome.PROGRESSED:
                out = StepOutcome.PROGRESSED
            elif o is StepOutcome.WAITING and out is StepOutcome.IDLE:
                out = StepOutcome.WAITING
        return out

    def run_until_idle(self):
        """Drain every replica (queued + running work fleet-wide)."""
        if not self._pumped:
            while self.step():
                pass
            return
        while True:
            live = [r for r in self._replicas
                    if not r.removed and not r.failed]
            for r in live:
                r.server.run_until_idle()
            if all(len(r.server.engine._queue) == 0
                   and all(s.request is None for s in r.server.engine.slots)
                   for r in live):
                return

    def close(self, drain: bool = False):
        """Shut down every replica (``drain=True`` finishes outstanding
        work first). Idempotent, like the pump close it fans out to."""
        if self._closed:
            return
        self._closed = True
        for r in self._replicas:
            if not r.removed:
                r.server.close(drain=drain)

    def __enter__(self) -> "FleetServer":
        return self

    def __exit__(self, *exc_info):
        self.close()
