"""Scheduler layer of the port's serving engine: continuous batching over
the program set in serving/programs.py.

A copy of ``repro.serving.scheduler`` in which only the JAX sites changed:
keys are the sampler's counter-hash keys, dispatch scalars are Python ints,
inputs are torch tensors on the scheduler's device, and the decode chunk's
outputs come back in one transfer, as do the verify step's. Snapshot mode
and ``EngineConfig.mesh`` raise ``NotImplementedError`` naming the
ROADMAP.md item that ports them. The rest — admission, sessions and tail
pages, stop sequences, cancel, deadlines, overload, journal, counters — is
unchanged.

The scheduler owns everything host-side: the request queue (FIFO within
priority classes), slot lifecycle (admit → decode/verify → finalize), the
paged KV pool / radix trie / snapshot arena bookkeeping, speculative-decode
drafting, stop sequences, cancellation, per-request RNG chains, **sessions**
(multi-turn conversations whose end-of-generation state is kept for the next
turn), and every ``stats()`` counter. All device work is dispatched through
``EnginePrograms``; see programs.py for the fast-path structure (bucketed
prefill, chunked decode, paged/radix sharing, snapshots, spec verify) and
docs/serving.md for the full knob + counter reference.

Public frontends:

* ``repro_torch.serving.server.LLMServer`` — the session-oriented API
  (streaming handles, cancellation, multi-turn reuse). New code starts
  there. (The JAX package's deprecated ``ServingEngine`` shim is not
  ported.)

Sessions and multi-turn reuse
-----------------------------

``open_session()`` returns a session id; every ``enqueue(..., session=sid)``
is one *turn*. At end of turn the engine keeps the conversation's tail state
at its exact (non-block-aligned) end-of-generation boundary, per arch
family:

* **paged** (full-attention archs): the turn's complete KV pages are adopted
  into the radix trie as usual, and the *partial tail page* — the page
  holding the positions past the last block boundary, including the
  generated tokens — stays owned by the session. The next turn's block table
  is ``radix-matched pages + tail page + fresh pages`` and prefill starts at
  the exact token the conversation left off, not at the last page boundary.
* **snapshots** (stateful archs): the slot's complete state is captured into
  a session-owned arena row at the exact end-of-generation length (trie
  snapshots only exist at block boundaries). The next turn restores it and
  prefills only the new message.

Turn N+1 must extend turn N's conversation: the session tracks the
conversation *text* (submitted prompt + generated output) and, when the new
prompt extends it, builds the token stream as ``previous tokens +
encode(delta)`` — exact token-level continuation, immune to tokenizer
round-trip drift. A prompt that rewrites history just resets the tail and
falls back to plain radix sharing. Greedy outputs are bit-identical with and
without session reuse (tests/test_server_api.py).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import math
import random

import torch

from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.serving import kvpool
from repro_torch.serving.faults import (DeadLetterError, DeadlineExceeded,
                                  OverloadError, RequestFault, RetryPolicy,
                                  ShedError)
from repro_torch.serving.journal import JournalEntry, SessionJournal
from repro_torch.serving.programs import EnginePrograms, auto_buckets
from repro_torch.serving.radix import RadixTree
from repro_torch.serving.sampler import fold_in, prng_key
from repro_torch.serving.spec import NgramDrafter
from repro_torch.serving.tokenizer import ByteTokenizer


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request generation parameters (the ``submit()`` kwargs of the
    deprecated API, plus stop / seed / priority).

    max_new_tokens: output token budget (must leave a >= 1 token prompt
                    window: max_new_tokens <= capacity - 2).
    temperature:    0.0 = greedy; > 0 samples on device per slot.
    top_k:          0 = no filter; >= vocab also degenerates to no filter.
    stop:           stop strings, checked host-side at every chunk sync on
                    the decoded text; generation halts at the first token
                    whose decoded prefix contains a stop and tokens after it
                    are trimmed from the result (a stop split across a chunk
                    boundary is still caught — the check sees the full text).
    seed:           per-request RNG seed. Stochastic sampling draws token t
                    from fold_in(PRNGKey(seed), t), so the same seed gives
                    the same output regardless of batch composition or
                    num_slots. None derives a per-request key from the
                    engine seed and request id (still composition-
                    independent, just not caller-chosen). Speculative
                    temperature slots remain distribution-correct but draw
                    from the shared verify key — pin outputs with spec off.
    priority:       admission class; higher admits first, FIFO within a
                    class (radix-aware admission grouping may still pull a
                    prefix-sharing request forward within one engine step).
    deadline_s:     wall-clock budget from submit; checked at every chunk
                    sync, so an expired request terminates TIMED_OUT within
                    one decode chunk of the deadline with all resources
                    freed (partial output kept, like cancel). None falls
                    back to the server-level ``default_deadline_s``.
    """
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    stop: Tuple[str, ...] = ()
    seed: Optional[int] = None
    priority: int = 0
    deadline_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving fast-path knobs.

    prefill_buckets: explicit bucket lengths; None → auto powers-of-two;
                     empty tuple → exact-length prefill (one compile per
                     distinct prompt length — the pre-fast-path behaviour,
                     kept for A/B benchmarking).
    decode_chunk:    decode tokens per jit'd inner loop (1 → one host sync
                     per token, the pre-fast-path behaviour). All-greedy
                     batches additionally compile a sampler-free loop body
                     (no per-step RNG / top-k sort).
    block_w:         decode-attention KV block; cache capacity is rounded up
                     to a multiple of it so the kernel never re-pads.
    donate:          kept for the JAX package's surface; the port always
                     updates the shared cache in place.
    cache_mode:      "dense" (per-slot cache rows) or "paged" (radix
                     prefix sharing). On full-attention archs "paged" means
                     one KV page pool + per-request block tables
                     (kvpool.supports_paged); on stateful archs (recurrent /
                     conv / xLSTM / ring-KV — kvpool.supports_snapshots) it
                     keeps dense rows and shares prefixes through per-prefix
                     recurrent-state snapshots instead.
    page_size:       KV tokens per page in paged mode; capacity is rounded up
                     to a multiple of it. Smaller pages share finer prefixes
                     at more gather overhead. Snapshot mode reuses it as the
                     radix block granularity.
    num_pages:       device pages in the pool (None → auto: trash page +
                     2 × num_slots × pages-per-request, leaving headroom for
                     retained prefixes before LRU eviction kicks in).
    num_snapshots:   snapshot-arena rows in snapshot mode (None → auto:
                     ~num_slots × boundaries-per-request + headroom). Each
                     row holds one complete per-sequence state, so memory is
                     num_snapshots × state-size — size it to taste and let
                     LRU eviction manage the rest.
    snap_stride:     radix blocks between snapshot boundaries (1 = capture at
                     every block, the finest prefix reuse; larger strides
                     trade hit depth for fewer arena rows and fewer prefill
                     chunk splits).
    spec_len:        max draft tokens per speculative verify step (0 = off).
                     A per-slot n-gram lookup drafter (serving/spec.py, no
                     draft model) proposes continuations; one verify forward
                     scores every draft position at once and an accept/
                     rollback step commits the matched prefix. Greedy slots
                     accept by exact match (outputs bit-identical to
                     non-speculative decode); temperature slots use
                     rejection-sampling acceptance (distribution-correct).
    spec_ngram_min/max: suffix n-gram lengths the drafter indexes.
    spec_min_accept: per-slot drafting turns off for the rest of a request
                     once its acceptance rate drops below this (after
                     spec_warmup drafted tokens) — unpredictable outputs
                     then pay zero verify overhead.
    spec_warmup:     drafted tokens per slot before adaptive disable engages.
    mesh:            multi-device serving; must be None in the port (one
                     card) until ROADMAP.md queue 1, item 11 ports it.
    """
    prefill_buckets: Optional[Tuple[int, ...]] = None
    decode_chunk: int = 16
    block_w: int = 256
    donate: Optional[bool] = None
    cache_mode: str = "dense"
    page_size: int = 16
    num_pages: Optional[int] = None
    num_snapshots: Optional[int] = None
    snap_stride: int = 1
    spec_len: int = 0
    spec_ngram_min: int = 2
    spec_ngram_max: int = 4
    spec_min_accept: float = 0.35
    spec_warmup: int = 64
    mesh: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """Bounded-admission / load-shedding / preemption knobs (all off by
    default field-wise; pass an instance to enable overload control).

    max_queue_depth: global queued-request cap. A submit over the cap
                     displaces the *youngest strictly-lower-priority* queued
                     request (shed with ``ShedError``) or, when none exists,
                     raises ``OverloadError`` to the submitter.
    class_depth:     per-priority queued-request caps ({priority: depth}).
                     A full class rejects its own submits with
                     ``OverloadError`` — one tenant class cannot displace
                     its own peers by hammering the queue.
    max_queue_age_s / class_age_s:
                     queued requests older than the cap (per-priority value
                     wins over the global one) are shed at the next step —
                     a request that has already waited past usefulness
                     terminates typed instead of aging into a timeout.
    shed_on_deadline: predictive shedding — a queued request whose remaining
                     deadline cannot cover its predicted service time (EWMA
                     of observed per-token prefill/decode rates) is shed
                     *immediately* rather than admitted to certainly time
                     out. No-op until the engine has observed one completion.
    shed_margin:     safety factor on the prediction (1.0 = shed when
                     remaining < predicted; larger sheds earlier).
    preempt:         under admission pressure, a running strictly-lower-
                     priority decode is preempted at the chunk boundary and
                     re-queued for bit-identical resumption (RNG chain and
                     token stream continue exactly; see ``_preempt_slot``).
    breaker_threshold: consecutive dispatch dead-letters that trip the
                     circuit breaker (0 disables it).
    breaker_cooldown_s: submits are rejected with ``OverloadError`` for this
                     long after the breaker trips; any successful dispatch
                     resets the consecutive-failure count.
    """
    max_queue_depth: Optional[int] = None
    class_depth: Optional[Dict[int, int]] = None
    max_queue_age_s: Optional[float] = None
    class_age_s: Optional[Dict[int, float]] = None
    shed_on_deadline: bool = True
    shed_margin: float = 1.0
    preempt: bool = True
    breaker_threshold: int = 5
    breaker_cooldown_s: float = 1.0


@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    prompt: str
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    stop: Tuple[str, ...] = ()
    priority: int = 0
    # filled by the engine
    prompt_tokens: int = 0
    truncated_tokens: int = 0      # dropped at the hard capacity window
    prefix_hit_tokens: int = 0     # prompt tokens served from shared pages /
                                   # restored snapshots / session tail state
    output_text: str = ""
    output_ids: Optional[List[int]] = None   # generated token ids (trimmed)
    output_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    latency_s: float = 0.0
    admit_index: int = -1
    first_token_s: float = 0.0     # TTFT: submit -> first sampled token
                                   # (set at first activation; preserved
                                   # across preempt/resume)
    preempted: int = 0             # times this request was preempted
    finished: bool = False         # reached a terminal status
    cancelled: bool = False
    status: str = "queued"         # RequestStatus value (serving/faults.py):
                                   # queued/running -> completed | cancelled
                                   # | timed_out | failed | shed
    error: Optional[BaseException] = None    # why FAILED / TIMED_OUT
    deadline_s: Optional[float] = None       # resolved (param or server default)
    _submit_t: float = 0.0
    _retry_at: float = 0.0         # admission backoff: skip until this time
    _admit_attempts: int = 0       # failed admission tries (pool exhaustion)
    _ids: Optional[list] = None    # tokenized prompt, cached across admission
                                   # retries (paged head-of-line waits) and
                                   # pre-built by session turn continuation
    _grouped: bool = False         # moved up the queue by radix-aware
                                   # admission batching (paged mode)
    _key: Optional[int] = None     # per-request key (chain base)
    _key0: Optional[tuple] = None  # (_key, 0): first-token sample key pair
                                   # (re-derived as (_key, k) when a
                                   # preempted request resumes k tokens in)
    _sess: Optional[object] = None # owning _SessionState for session turns
    _pre_gen: Optional[list] = None  # preemption: tokens generated before
                                     # the preempt; re-prefilled on resume
    _orig_plen: int = 0            # admitted prompt length (pre tokens
                                   # excluded) — fixed at first activation


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    cache_len: int = 0
    prompt_len: int = 0
    remaining: int = 0
    generated: Optional[list] = None
    stopped: bool = False                 # device state ran past the kept
                                          # tokens (stop-sequence trim, or a
                                          # spec accept truncated at EOS) —
                                          # tail snapshot capture must skip
    # paged mode bookkeeping
    token_ids: Optional[list] = None      # prompt ids (post-truncation)
    pages_shared: Optional[list] = None   # radix-matched prefix pages (tree-owned)
    pages_priv: Optional[list] = None     # this request's own pages
    node: Optional[object] = None         # pinned radix node
    sess_tail_page: int = -1              # page consumed from the session
                                          # tail (returned to it on cancel)
    # speculative decoding bookkeeping
    drafter: Optional[NgramDrafter] = None
    spec_on: bool = False                 # adaptive per-slot enable
    spec_drafted: int = 0                 # draft tokens proposed for this slot
    spec_accepted: int = 0                # ... of which verify accepted


@dataclasses.dataclass
class _SessionState:
    """One conversation's retained state between turns.

    ``all_tokens`` is the exact token stream of the conversation so far
    (prompt + generated, stop-trimmed); its first ``len - 1`` tokens are
    *processed* (KV / recurrent state exists for them), the final token is
    the sampled-but-unconsumed continuation. ``text`` is the matching
    conversation text — the next turn's prompt must extend it for the tail
    to be reused. Tail resources are owned by the session (never by the
    radix tree or the free lists): ``tail_page`` in paged mode, ``tail_snap``
    in snapshot mode, plus a pin (``node``) on the trie path covering the
    conversation's complete blocks so LRU eviction can't open a gap under
    the tail.
    """
    sid: int
    text: str = ""
    all_tokens: List[int] = dataclasses.field(default_factory=list)
    node: Optional[object] = None
    tail_page: int = -1
    tail_snap: int = -1
    live: Optional[Request] = None
    turns: int = 0

    @property
    def tail_len(self) -> int:
        return max(len(self.all_tokens) - 1, 0)


class Scheduler:
    """Admission / fairness / step-loop layer over ``EnginePrograms``."""

    def __init__(self, cfg, *, num_slots: int = 4, capacity: int = 512,
                 params=None, seed: int = 0,
                 engine_cfg: Optional[EngineConfig] = None,
                 retry: Optional[RetryPolicy] = None,
                 default_deadline_s: Optional[float] = None,
                 injector=None, journal_path: Optional[str] = None,
                 watchdog_s: Optional[float] = None,
                 overload: Optional[OverloadPolicy] = None,
                 device="cuda"):
        self.engine_cfg = engine_cfg or EngineConfig()
        self.device = resolve_device(device)
        if self.engine_cfg.mesh is not None:
            raise NotImplementedError(
                "EngineConfig.mesh: multi-device serving is not ported yet "
                "(ROADMAP.md queue 1, item 11)")
        if cfg.modality != "text":
            raise NotImplementedError(
                f"serving modality {cfg.modality!r} is not ported yet "
                "(ROADMAP.md queue 1, item 9: modality stubs)")
        # fault-tolerance layer (serving/faults.py): bounded retry of
        # transient dispatch faults, deadline default, chaos hooks, and the
        # crash-safe session journal (serving/journal.py)
        self.retry = retry or RetryPolicy()
        self.default_deadline_s = default_deadline_s
        self.injector = injector
        # overload-control layer: None = unbounded admission (the earlier
        # behaviour); see OverloadPolicy for the knobs
        self.overload = overload
        self.journal = SessionJournal(journal_path)
        self._backoff_rng = random.Random(seed ^ 0x5EED)
        if self.engine_cfg.decode_chunk < 1:
            raise ValueError(
                f"decode_chunk must be >= 1, got {self.engine_cfg.decode_chunk} "
                "(a zero-length chunk makes no progress)")
        mode = self.engine_cfg.cache_mode
        if mode not in ("dense", "paged"):
            raise ValueError(f"cache_mode must be 'dense' or 'paged', got {mode!r}")
        # "paged" resolves per arch family: KV page pool for full-attention
        # archs, per-prefix recurrent-state snapshots for stateful archs
        self.paged = self.snapshots = False
        if mode == "paged":
            ok, why = kvpool.supports_paged(cfg)
            if not ok:
                raise NotImplementedError(
                    f"cache_mode='paged' on {cfg.name} ({why}) means "
                    "per-prefix state snapshots, which are not ported yet "
                    "(ROADMAP.md queue 1, item 9)")
            self.paged = True
        if self.engine_cfg.spec_len < 0:
            raise ValueError(
                f"spec_len must be >= 0, got {self.engine_cfg.spec_len}")
        self.spec = self.engine_cfg.spec_len > 0
        bw = max(1, self.engine_cfg.block_w)
        if capacity > bw:
            capacity = -(-capacity // bw) * bw      # align to kernel block
        ps = self.engine_cfg.page_size
        if self.paged or self.snapshots:
            if ps < 1:
                raise ValueError(f"page_size must be >= 1, got {ps}")
        if self.paged:
            capacity = -(-capacity // ps) * ps      # align to page size
        self.cfg = dataclasses.replace(cfg, decode_block_w=bw)
        self.model = Model(self.cfg, device=self.device)
        self.tokenizer = ByteTokenizer(cfg.vocab_size)
        self.num_slots = num_slots
        self.capacity = capacity
        buckets = self.engine_cfg.prefill_buckets
        self.buckets: Tuple[int, ...] = (auto_buckets(capacity)
                                         if buckets is None else
                                         tuple(sorted(buckets)))
        if params is None:
            params = self.model.init(seed)
        elif isinstance(params, dict):          # a state dict (convert.py)
            params = self.model.load(params)
        self.params = params
        if self.paged:
            self._bt_width = capacity // ps
            n_pages = self.engine_cfg.num_pages
            if n_pages is None:
                n_pages = 1 + 2 * num_slots * self._bt_width
            # self.cache IS the page pool in paged mode: same pytree
            # structure, batch axis re-purposed as the page axis
            self.cache = kvpool.init_paged_cache(self.cfg, n_pages, ps,
                                                 self.device)
            self.kvpool = kvpool.PagePool(n_pages)
            self.kvpool.injector = injector
            self.radix = RadixTree(ps)
            self._bt_device = None      # cached decode block table (device)
        else:
            self.cache = self.model.init_cache(num_slots, capacity)
            self.kvpool = None
            self.radix = None
        self.snaps = None               # snapshot mode raises above
        self.snap_arena = None
        self.slots = [_Slot() for _ in range(num_slots)]
        self._queue: "collections.deque[Request]" = collections.deque()
        self._req_key_base = prng_key(seed + 2)
        self._next_rid = 0
        self._next_admit = 0
        self._sessions: Dict[int, _SessionState] = {}
        self._next_sid = 0

        # perf counters (benchmarks/*.py read these)
        self._prefill_shapes: set = set()        # 1 jit compile per entry
        self._extend_shapes: set = set()         # ... for extend chunks
        self._decode_syncs = 0                   # blocking pulls in decode
        self._prefill_syncs = 0                  # blocking pulls at admission
        self._decode_tokens = 0
        self._decode_chunks = 0
        self._extend_chunks = 0
        self._truncated_tokens = 0               # dropped at capacity window
        self._truncated_requests = 0
        self._pad_tokens = 0                     # prefill bucket padding waste
        self._prompt_tokens = 0                  # real (unpadded) prompt tokens
        self._prefix_hit_tokens = 0              # served from shared prefixes
        self._draft_tokens = 0                   # spec: tokens proposed
        self._accepted_tokens = 0                # spec: drafts verify accepted
        self._verify_steps = 0                   # spec: verify forwards run
        self._verify_rows = 0                    # spec: drafted rows verified
        self._grouped_admissions = 0             # paged/snap: radix-grouped
        self._snap_hits = 0                      # snap: admissions restored
        self._snap_misses = 0                    # ... or prefilled from zero
        self._snap_captures = 0                  # snapshots spliced to arena
        self._sessions_opened = 0                # session/stream counters
        self._session_turns = 0
        self._turn_prefix_hits = 0               # turns admitted off the tail
        self._cancelled = 0
        self._stream_chunks = 0                  # bumped by server streaming
        self._steps = 0                          # engine steps with work
        self._active_slot_sum = 0                # co-batching: Σ active slots
        self._admission_retries = 0              # pool-exhaustion backoffs
        self._dead_lettered = 0                  # requests terminated FAILED
        self._timed_out = 0                      # requests terminated TIMED_OUT
        # overload-control counters / state (OverloadPolicy)
        self._shed = 0                           # requests terminated SHED
        self._preempted = 0                      # running slots preempted
        self._preempt_resumes = 0                # preempted requests resumed
        self._breaker_trips = 0                  # circuit-breaker opens
        self._breaker_failures = 0               # consecutive dead-letters
        self._breaker_open_until = 0.0
        # EWMA service-time model for predictive shedding (s per token);
        # None until the first completion is observed
        self._svc_prefill_tok_s: Optional[float] = None
        self._svc_decode_tok_s: Optional[float] = None

        self.progs = EnginePrograms(
            self.model, self.cfg, self.engine_cfg, capacity=self.capacity,
            num_slots=num_slots, eos_id=self.tokenizer.eos_id,
            injector=injector, retry=self.retry, watchdog_s=watchdog_s)
        self._slot_consts = None        # cached (keys, prompt_lens) device
                                        # arrays; rebuilt on membership change

    # ---- public API --------------------------------------------------------
    def enqueue(self, prompt: str, params: Optional[SamplingParams] = None,
                *, session: Optional[int] = None,
                token_ids: Optional[List[int]] = None) -> Request:
        """Queue one request (non-blocking). ``session`` makes it a turn of
        that conversation (one in-flight turn per session); ``token_ids``
        bypasses tokenization (benchmarks replaying exact streams)."""
        p = params or SamplingParams()
        # validate at submit time: a poisoned request must raise a clear
        # ValueError HERE, not fail inside a jit program mid-batch
        if p.max_new_tokens >= self.capacity - 1:
            raise ValueError(
                f"max_new_tokens={p.max_new_tokens} leaves no room for the "
                f"prompt in a capacity-{self.capacity} cache "
                f"(need max_new_tokens <= capacity - 2)")
        if p.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {p.max_new_tokens}")
        if not (p.temperature >= 0.0) or math.isinf(p.temperature):
            raise ValueError(
                f"temperature must be finite and >= 0, got {p.temperature}")
        if p.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {p.top_k}")
        if p.deadline_s is not None and not p.deadline_s > 0:
            raise ValueError(f"deadline_s must be > 0, got {p.deadline_s}")
        if not prompt and token_ids is None:
            raise ValueError(
                "empty prompt (pass token_ids= to replay an exact stream)")
        stop = (p.stop,) if isinstance(p.stop, str) else tuple(p.stop or ())
        self._admission_gate(p)
        self._next_rid += 1
        req = Request(self._next_rid, prompt, p.max_new_tokens, p.temperature,
                      p.top_k, stop=stop, priority=p.priority)
        req.deadline_s = (p.deadline_s if p.deadline_s is not None
                          else self.default_deadline_s)
        req._submit_t = time.perf_counter()
        if token_ids is not None:
            req._ids = list(token_ids)
        # per-request RNG chain: token t of this request samples with the
        # key pair (key, t) — independent of batch composition (sampler.py)
        base = (prng_key(p.seed) if p.seed is not None
                else fold_in(self._req_key_base, req.rid))
        req._key = base
        req._key0 = (base, 0)
        if session is not None:
            sess = self._sessions.get(session)
            if sess is None:
                raise ValueError(f"unknown session id {session}")
            if sess.live is not None and not sess.live.finished:
                raise RuntimeError(
                    f"session {session} already has turn rid={sess.live.rid} "
                    "in flight (one turn at a time: turn N+1's prompt "
                    "depends on turn N's output)")
            if req._ids is None:
                if sess.text and prompt.startswith(sess.text) and sess.all_tokens:
                    # token-level continuation: previous stream + new delta —
                    # exact, immune to tokenizer round-trip drift over the
                    # generated tail
                    delta = prompt[len(sess.text):]
                    req._ids = list(sess.all_tokens) + (
                        self.tokenizer.encode(delta, bos=False) if delta
                        else [])
                elif sess.text or sess.all_tokens:
                    # history rewritten: the retained tail no longer applies
                    self._session_reset_tail(sess)
            req._sess = sess
            sess.live = req
            sess.turns += 1
            self._session_turns += 1
        self._insert_by_priority(req)
        return req

    def _admission_gate(self, p: "SamplingParams"):
        """Bounded admission (OverloadPolicy): reject-or-displace BEFORE a
        request object exists, so a refused submit costs the caller one
        typed ``OverloadError`` and the engine nothing."""
        ov = self.overload
        if ov is None:
            return
        now = time.perf_counter()
        if now < self._breaker_open_until:
            raise OverloadError(
                "circuit breaker open for another "
                f"{self._breaker_open_until - now:.3f}s after "
                f"{ov.breaker_threshold} consecutive dispatch dead-letters")
        cap = (ov.class_depth or {}).get(p.priority)
        if cap is not None and sum(1 for r in self._queue
                                   if r.priority == p.priority) >= cap:
            raise OverloadError(
                f"priority-{p.priority} admission queue full "
                f"(class_depth={cap})")
        if (ov.max_queue_depth is not None
                and len(self._queue) >= ov.max_queue_depth):
            # displace the youngest strictly-lower-priority queued request;
            # an arrival that outranks nothing is the one rejected
            victim = None
            for r in reversed(self._queue):
                if r.priority < p.priority:
                    victim = r
                    break
            if victim is None:
                raise OverloadError(
                    f"admission queue full "
                    f"(max_queue_depth={ov.max_queue_depth})")
            self._abort(victim, "shed", ShedError(
                f"rid={victim.rid}: displaced from a full queue "
                f"(depth {ov.max_queue_depth}) by a priority-{p.priority} "
                f"arrival (own priority {victim.priority})"))

    def _insert_by_priority(self, req: Request, *, resumed: bool = False):
        """FIFO within a priority class: insert before the first queued
        request of strictly lower priority. A preempted request re-queues at
        the *front* of its class (``resumed``) — it was admitted before every
        queued peer, so front-of-class preserves true submit order."""
        q = self._queue
        if resumed:
            for i, r in enumerate(q):
                if r.priority <= req.priority:
                    q.insert(i, req)
                    return
            q.append(req)
            return
        if not q or q[-1].priority >= req.priority:
            q.append(req)
            return
        for i, r in enumerate(q):
            if r.priority < req.priority:
                q.insert(i, req)
                return

    def cancel(self, req: Request) -> bool:
        """Cancel a queued or in-flight request: frees its slot, returns its
        private pages to the pool, unpins its radix node, and (for session
        turns) leaves the session's retained tail intact so the turn can be
        retried. Partial output is kept on the request. Returns False if the
        request already finished."""
        return self._abort(req, "cancelled")

    def _abort(self, req: Request, status: str,
               error: Optional[BaseException] = None) -> bool:
        """Terminate a queued or in-flight request in a non-completed
        terminal status (cancelled / timed_out / failed / shed), releasing
        every resource it holds. Deadline expiry, dead-lettering, and load
        shedding reuse the cancellation path, so the leak invariants cover
        all of them."""
        if req.finished:
            return False
        if req in self._queue:
            self._queue.remove(req)
            self._finish_abort(req, status, error)
            return True
        for si, slot in enumerate(self.slots):
            if slot.request is req:
                self._release_slot(si)
                self._finish_abort(req, status, error)
                return True
        return False

    def _release_slot(self, si: int):
        """Capture slot ``si``'s partial output onto its request and free
        everything the slot holds (private pages — the session tail page
        goes back to its session — radix pins). The shared path under
        cancel, deadline expiry, and failure isolation."""
        slot = self.slots[si]
        req = slot.request
        req.output_ids = list(slot.generated)
        req.output_tokens = len(slot.generated)
        req.output_text = self.tokenizer.decode(slot.generated)
        if self.paged:
            priv = list(slot.pages_priv)
            if slot.sess_tail_page >= 0 and req._sess is not None:
                # the tail page's pre-turn positions are untouched
                # (this turn only wrote at/after the tail) — hand it
                # back so the retried turn can still reuse it
                req._sess.tail_page = slot.sess_tail_page
                priv.remove(slot.sess_tail_page)
            self.kvpool.free(priv)
            self.radix.release(slot.node)
            self._bt_device = None
        elif self.snapshots:
            self.radix.release(slot.node)
        self.slots[si] = _Slot()
        self._slot_consts = None

    def _finish_abort(self, req: Request, status: str,
                      error: Optional[BaseException]):
        req.status = status
        req.error = error
        req.cancelled = status in ("cancelled", "timed_out")
        req.finished = True
        req.latency_s = time.perf_counter() - req._submit_t
        if status == "cancelled":
            self._cancelled += 1
        elif status == "timed_out":
            self._timed_out += 1
        elif status == "failed":
            self._dead_lettered += 1
        elif status == "shed":
            self._shed += 1
        if req._sess is not None and req._sess.live is req:
            req._sess.live = None

    # ---- deadlines ---------------------------------------------------------
    def _expire_deadlines(self):
        """Terminate queued and in-flight requests whose deadline elapsed.
        Called at the top of every ``step()`` — i.e. at every chunk sync —
        so an expired request terminates TIMED_OUT within one chunk of its
        deadline, with all resources freed."""
        now = time.perf_counter()
        expired = [r for r in list(self._queue)
                   + [s.request for s in self.slots if s.request is not None]
                   if r.deadline_s is not None
                   and now >= r._submit_t + r.deadline_s]
        for req in expired:
            self._abort(req, "timed_out", DeadlineExceeded(
                f"rid={req.rid}: deadline_s={req.deadline_s} elapsed "
                f"after {now - req._submit_t:.3f}s"))

    # ---- overload control (OverloadPolicy) ---------------------------------
    def _predict_service_s(self, req: Request) -> Optional[float]:
        """Predicted wall-clock to serve ``req`` from admission to finish,
        from the EWMA per-token prefill/decode rates of observed
        completions. None until the engine has decode-rate data."""
        if self._svc_decode_tok_s is None:
            return None
        n_prompt = (len(req._ids) if req._ids is not None
                    else len(req.prompt))       # ByteTokenizer ~1 tok/char
        n_prompt = min(n_prompt, self.capacity)
        budget = req.max_new_tokens - len(req._pre_gen or [])
        return ((self._svc_prefill_tok_s or 0.0) * n_prompt
                + self._svc_decode_tok_s * budget)

    def _note_service(self, req: Request):
        """Fold one completion into the EWMA service-time model."""
        if req.output_tokens and req.decode_s > 0:
            per = req.decode_s / req.output_tokens
            self._svc_decode_tok_s = (
                per if self._svc_decode_tok_s is None
                else 0.8 * self._svc_decode_tok_s + 0.2 * per)
        if req.prompt_tokens and req.prefill_s > 0:
            per = req.prefill_s / req.prompt_tokens
            self._svc_prefill_tok_s = (
                per if self._svc_prefill_tok_s is None
                else 0.8 * self._svc_prefill_tok_s + 0.2 * per)

    def _shed_sweep(self, now: float):
        """Shed queued requests the overload policy says can't be served
        usefully: past their (per-class) age cap, or — predictively — with
        a remaining deadline the EWMA service model says cannot be met.
        Typed, immediate termination beats limping into a timeout."""
        ov = self.overload
        for r in list(self._queue):
            age = now - r._submit_t
            cap = (ov.class_age_s or {}).get(r.priority, ov.max_queue_age_s)
            if cap is not None and age > cap:
                self._abort(r, "shed", ShedError(
                    f"rid={r.rid}: queued {age:.3f}s > age cap {cap}s "
                    f"(priority {r.priority})"))
                continue
            if not ov.shed_on_deadline or r.deadline_s is None:
                continue
            eta = self._predict_service_s(r)
            if eta is None:
                continue
            left = r._submit_t + r.deadline_s - now
            if left < eta * ov.shed_margin:
                self._abort(r, "shed", ShedError(
                    f"rid={r.rid}: remaining deadline {left:.3f}s cannot "
                    f"cover predicted service time {eta:.3f}s "
                    f"(shed_margin={ov.shed_margin})"))

    def _breaker_note(self, ok: bool):
        """Circuit breaker over dispatch dead-letters: ``breaker_threshold``
        consecutive failures open the breaker (submits rejected) for
        ``breaker_cooldown_s``; any successful dispatch resets the count."""
        ov = self.overload
        if ov is None or ov.breaker_threshold <= 0:
            return
        if ok:
            self._breaker_failures = 0
            return
        self._breaker_failures += 1
        if self._breaker_failures >= ov.breaker_threshold:
            self._breaker_open_until = (time.perf_counter()
                                        + ov.breaker_cooldown_s)
            self._breaker_trips += 1
            self._breaker_failures = 0

    def _preempt_for_priority(self, now: float):
        """Priority preemption at the chunk boundary: when an admittable
        queued request outranks a running one and no free slot can serve it,
        the lowest-priority running slot (most budget left on ties — least
        progress thrown away) is preempted and re-queued for bit-identical
        resumption. Strictly-greater priority only, and a resumed request
        keeps its class, so two classes can't ping-pong one slot."""
        ov = self.overload
        if not ov.preempt or not self._queue:
            return
        free = sum(1 for s in self.slots if s.request is None)
        cands = [r for r in self._queue if r._retry_at <= now][free:]
        eos = self.tokenizer.eos_id
        for cand in cands:
            victim, vkey = None, None
            for si, s in enumerate(self.slots):
                r = s.request
                if (r is None or r.priority >= cand.priority
                        or s.remaining <= 0 or s.stopped
                        or s.generated[-1] == eos):   # finalizes this step
                    continue
                k = (r.priority, -s.remaining)
                if vkey is None or k < vkey:
                    victim, vkey = si, k
            if victim is None:
                return
            self._preempt_slot(victim)

    def _preempt_slot(self, si: int):
        """Preempt slot ``si``: release everything it holds (pages / pins /
        the session tail page — the cancel machinery) and re-queue its
        request so a later admission resumes it *bit-identically*: the
        resumed prefill re-processes prompt + the ``k`` already-generated
        tokens (identical KV/state — same tokens, same positions) and the
        RNG chain continues at ``fold_in(key, k)``, exactly the key token
        ``k`` would have been sampled with uninterrupted."""
        slot = self.slots[si]
        req = slot.request
        pre = list(slot.generated)
        req._pre_gen = pre
        req._ids = (slot.token_ids[:req._orig_plen]
                    if slot.token_ids is not None else []) + pre
        req._key0 = (req._key, len(pre))
        self._release_slot(si)
        req.status = "queued"
        req._retry_at = 0.0
        req._admit_attempts = 0
        req.preempted += 1
        self._preempted += 1
        self._insert_by_priority(req, resumed=True)

    # ---- sessions ----------------------------------------------------------
    def open_session(self) -> int:
        self._next_sid += 1
        self._sessions[self._next_sid] = _SessionState(self._next_sid)
        self._sessions_opened += 1
        return self._next_sid

    def close_session(self, sid: int):
        sess = self._sessions.pop(sid, None)
        if sess is None:
            return
        if sess.live is not None and not sess.live.finished:
            self.cancel(sess.live)
        self._session_reset_tail(sess)
        self.journal.drop(sid)

    def restore_session(self, entry: JournalEntry) -> int:
        """Rebuild one journaled session on THIS engine after a teardown:
        opens a fresh session and replays the journaled token stream through
        the normal ``enqueue(token_ids=)`` path — re-prefilling
        ``all_tokens[:-1]`` (the processed prefix) and letting finalize
        re-capture the tail page / tail snapshot at the exact
        end-of-generation boundary, so the next turn's greedy output is
        bit-identical to an uninterrupted server. Dense mode retains no
        device tail; only the token-level bookkeeping is restored (the next
        turn re-prefills, which is already its steady state). Returns the
        new session id."""
        sid = self.open_session()
        sess = self._sessions[sid]
        toks = list(entry.all_tokens)
        if len(toks) >= 2 and (self.paged or self.snapshots):
            req = self.enqueue("", SamplingParams(max_new_tokens=1),
                               session=sid, token_ids=toks[:-1])
            while not req.finished:
                self.step()
        # the replay's sampled continuation token re-derives greedily; pin
        # the journaled stream + text regardless (a temperature turn's
        # sampled token is not part of the processed tail state)
        sess.all_tokens = toks
        sess.text = entry.text
        sess.turns = entry.turns
        self.journal.record(sid, sess.text, sess.all_tokens, sess.turns)
        return sid

    def _session_reset_tail(self, sess: _SessionState):
        """Release everything a session retains between turns."""
        if sess.tail_page >= 0:
            self.kvpool.free([sess.tail_page])
            sess.tail_page = -1
        if sess.tail_snap >= 0:
            self.snaps.free([sess.tail_snap])
            sess.tail_snap = -1
        if sess.node is not None:
            self.radix.release(sess.node)
            sess.node = None
        sess.text = ""
        sess.all_tokens = []

    def _tail_usable(self, req: Request, ids: List[int]) -> int:
        """Token count of the session tail this request can restore (0 = no
        reuse). The actual (possibly truncated) ids must extend the retained
        stream and leave >= 1 suffix token to recompute for first-token
        logits."""
        sess = req._sess
        if sess is None or not sess.all_tokens:
            return 0
        n = sess.tail_len
        if n < 1 or n > len(ids) - 1 or ids[:n] != sess.all_tokens[:n]:
            return 0
        return n

    # ---- fleet routing surface ---------------------------------------------
    def radix_digest(self) -> frozenset:
        """First-block keyspace digest of the radix trie (see
        radix.RadixTree.keyspace_digest) — what this engine exports to a
        fleet router for prefix-affinity placement. Empty in dense mode
        (nothing is shared across requests, so affinity is meaningless)."""
        if self.radix is None:
            return frozenset()
        return self.radix.keyspace_digest()

    def load_score(self) -> float:
        """Routing load estimate: (queued + running requests) × the EWMA
        per-token decode service time from the overload predictor
        (``_svc_decode_tok_s``; 1.0 until the first completion is observed,
        so cold replicas tie and the router's tie-break spreads them). Read
        racily by the fleet router without a pump round-trip — it is a
        heuristic gauge, never a correctness input."""
        depth = len(self._queue) + sum(1 for s in self.slots
                                       if s.request is not None)
        return float(depth) * (self._svc_decode_tok_s or 1.0)

    # ---- stats -------------------------------------------------------------
    def stats(self) -> dict:
        toks = max(self._decode_tokens, 1)
        out = {
            "cache_mode": self.engine_cfg.cache_mode,
            # mesh layout keys of the JAX package: one device, unsharded
            "mesh_devices": 1,
            "mesh_shape": {"data": 1, "model": 1},
            "sharded": False,
            "prefill_compiles": len(self._prefill_shapes),
            "extend_compiles": len(self._extend_shapes),
            "prefill_buckets": list(self.buckets),
            "decode_chunk": self.engine_cfg.decode_chunk,
            "decode_tokens": self._decode_tokens,
            "decode_chunks": self._decode_chunks,
            "extend_chunks": self._extend_chunks,
            "host_syncs": self._decode_syncs,
            "host_syncs_per_token": self._decode_syncs / toks,
            # admission also pulls the first sampled token (once per request,
            # not per token) — reported separately so the decode-path sync
            # rate above stays honest
            "prefill_syncs": self._prefill_syncs,
            # prompt accounting: hard-window truncation (the seed engine
            # dropped these silently) and bucket padding waste (compute spent
            # on pad rows — the knob for tuning prefill_buckets from bench
            # JSON)
            "truncated_requests": self._truncated_requests,
            "truncated_tokens": self._truncated_tokens,
            "prompt_tokens": self._prompt_tokens,
            "prefill_pad_tokens": self._pad_tokens,
            "prefill_pad_frac": self._pad_tokens /
                max(self._pad_tokens + self._prompt_tokens
                    - self._prefix_hit_tokens, 1),
            # speculative decode (all zero when spec_len == 0): drafted vs
            # verify-accepted tokens, and how many verify forwards ran —
            # acceptance_rate is the knob for tuning spec_len / the n-gram
            # range from bench JSON (benchmarks/spec_bench.py)
            "spec_len": self.engine_cfg.spec_len,
            "draft_tokens": self._draft_tokens,
            "accepted_tokens": self._accepted_tokens,
            "acceptance_rate": self._accepted_tokens /
                max(self._draft_tokens, 1),
            "verify_steps": self._verify_steps,
            # session / stream / scheduling counters (the server frontend):
            # turn_prefix_hits = turns admitted off a retained session tail;
            # active_slots_per_step > 1 means concurrent requests actually
            # co-batch inside one engine step
            "sessions_opened": self._sessions_opened,
            "session_turns": self._session_turns,
            "turn_prefix_hits": self._turn_prefix_hits,
            "cancelled_requests": self._cancelled,
            # fault-tolerance counters (serving/faults.py): admission
            # backoffs under pool pressure, requests terminated FAILED /
            # TIMED_OUT, transient dispatch faults retried away, watchdog-
            # flagged slow dispatches, and journaled (recoverable) sessions
            "admission_retries": self._admission_retries,
            "dead_lettered": self._dead_lettered,
            "timed_out": self._timed_out,
            "dispatch_retries": self.progs.dispatch_retries,
            "watchdog_stalls": self.progs.watchdog_stalls,
            "journaled_sessions": len(self.journal),
            "stream_chunks": self._stream_chunks,
            # overload-control counters (OverloadPolicy; all zero without
            # one): typed sheds, chunk-boundary preemptions and their
            # resumed admissions, and circuit-breaker opens
            "shed_requests": self._shed,
            "preemptions": self._preempted,
            "preempt_resumes": self._preempt_resumes,
            "breaker_trips": self._breaker_trips,
            "breaker_open": time.perf_counter() < self._breaker_open_until,
            # EWMA service-time model feeding predictive shedding (s/token;
            # 0.0 until the first completion is observed)
            "ewma_prefill_s_per_tok": self._svc_prefill_tok_s or 0.0,
            "ewma_decode_s_per_tok": self._svc_decode_tok_s or 0.0,
            # live-work gauges (not counters): a drained server shows 0/0 —
            # the FAME workflow gate asserts every handle reached a terminal
            # status with nothing stranded in the queue or a slot
            "queued_requests": len(self._queue),
            "live_requests": sum(1 for s in self.slots
                                 if s.request is not None),
            # queue-shape gauges: depth per priority class and the oldest
            # queued request's wait so far (overload dashboards / gates)
            "queue_depth_by_priority": dict(collections.Counter(
                r.priority for r in self._queue)),
            "queue_age_max_s": max(
                (time.perf_counter() - r._submit_t for r in self._queue),
                default=0.0),
            "engine_steps": self._steps,
            "active_slots_per_step": self._active_slot_sum /
                max(self._steps, 1),
        }
        if self.paged or self.snapshots:
            out.update({
                "page_size": self.engine_cfg.page_size,
                "radix_nodes": self.radix.num_nodes,
                # the headline: prompt tokens served straight from shared
                # pages / restored state snapshots instead of re-prefilled
                "prefix_hit_tokens": self._prefix_hit_tokens,
                "prefix_hit_rate": self._prefix_hit_tokens /
                    max(self._prompt_tokens, 1),
                # queued requests admitted in the same engine step as an
                # earlier request sharing their first radix block (the
                # shared pages/snapshots are matched while still pinned/hot)
                "grouped_admissions": self._grouped_admissions,
            })
        if self.paged:
            out.update({
                "pages_total": self.kvpool.num_pages,
                "pages_free": self.kvpool.num_free,
                "pages_peak_in_use": self.kvpool.peak_in_use,
                "radix_evicted_pages": self.radix.evicted_pages,
            })
        if self.snapshots:
            out.update({
                # per-prefix recurrent-state snapshot arena: hits restore a
                # boundary state instead of re-prefilling; misses prefill
                # from scratch; evictions are LRU trie leaves reclaimed when
                # the arena fills (tune num_snapshots / snap_stride from
                # these)
                "snapshots_total": self.snaps.num_snaps,
                "snapshots_free": self.snaps.num_free,
                "snapshots_peak_in_use": self.snaps.peak_in_use,
                "snapshot_hits": self._snap_hits,
                "snapshot_misses": self._snap_misses,
                "snapshot_captures": self._snap_captures,
                "snapshot_evictions": self.radix.evicted_snaps,
            })
        return out

    # ---- engine loop: admission --------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return n                        # exact-length (legacy) mode

    def _chunk_plan(self, n: int, start: int) -> List[Tuple[int, int, int]]:
        """Split ``n`` prompt tokens beginning at position ``start`` into
        prefill chunks: (offset, real_len, padded_len) triples. All chunks
        but the last are exactly the largest bucket; the last is bucketed
        (and clamped so the padded write never overruns capacity)."""
        mb = max(self.buckets) if self.buckets else n
        plan = []
        off = 0
        while off < n:
            rest = n - off
            if rest > mb:
                plan.append((off, mb, mb))
            else:
                padded = min(self._bucket_for(rest),
                             self.capacity - (start + off))
                plan.append((off, rest, padded))
            off += plan[-1][1]
        return plan

    def _chunk_batch(self, ids: List[int], start: int, padded: int):
        """Device token/position arrays for one right-padded prefill chunk."""
        padded_ids = ids + [self.tokenizer.pad_id] * (padded - len(ids))
        tokens = torch.tensor([padded_ids], dtype=torch.int64,
                              device=self.device)
        positions = start + torch.arange(padded, device=self.device)[None, :]
        return tokens, positions

    def _req_budget(self, req: Request) -> int:
        """Remaining output budget: max_new_tokens, minus tokens already
        generated before a preemption (they re-prefill, not re-generate)."""
        return req.max_new_tokens - len(req._pre_gen or [])

    def _encode_prompt(self, req: Request) -> List[int]:
        """Tokenize + clamp to the capacity window, counting what was cut
        (the seed engine dropped tokens here with no trace at all). A
        preempted request's window grows by its pre-generated token count,
        so the resume never truncates deeper than the original admission."""
        window = self.capacity - self._req_budget(req) - 1   # >= 1 (enqueue
        if req._ids is None:                                 # guard)
            req._ids = self.tokenizer.encode(req.prompt)
        full = req._ids
        ids = full[-window:]
        req.truncated_tokens = len(full) - len(ids)
        if req.truncated_tokens:
            self._truncated_tokens += req.truncated_tokens
            self._truncated_requests += 1
        req.prompt_tokens = len(ids)
        self._prompt_tokens += len(ids)
        return ids

    def _uncount_prompt(self, req: Request, ids: List[int]):
        """Roll back _encode_prompt's counters when admission fails and the
        request stays at the queue head."""
        self._prompt_tokens -= len(ids)
        if req.truncated_tokens:
            self._truncated_tokens -= req.truncated_tokens
            self._truncated_requests -= 1

    def _prefill_span(self, si: int, req: Request, ids: List[int],
                      start: int, end: int, *, sample: bool):
        """Prefill ``ids[start:end]`` into slot ``si`` in bucketed chunks.

        ``start == 0`` opens with the bucketed prefill (fresh cache row — it
        always unembeds one position and samples; a non-final span discards
        that token); every other chunk is an ``extend`` continuation against
        the already-filled row (restored snapshot / session tail included)
        that unembeds + samples only when it is the last chunk and
        ``sample``. Returns the last chunk's sampled token.
        """
        plan = self._chunk_plan(end - start, start)
        tok = None
        for ci, (off, real, padded) in enumerate(plan):
            o = start + off
            tokens, positions = self._chunk_batch(ids[o:o + real], o, padded)
            self._pad_tokens += padded - real
            last = ci == len(plan) - 1
            if o == 0:
                self._prefill_shapes.add((padded, self.cfg.modality))
                self.cache, t = self.progs.prefill(
                    self.params, self.cache, tokens, positions,
                    si, real, req._key0, req.temperature, req.top_k)
            else:
                self._extend_shapes.add((padded, self.cfg.modality))
                self._extend_chunks += 1
                self.cache, t = self.progs.extend(
                    self.params, self.cache, tokens, positions,
                    si, o, real, req._key0, req.temperature, req.top_k,
                    sample=sample and last)
            if last:
                tok = t
        return tok

    def _activate(self, si: int, slot: _Slot, req: Request, ids: List[int],
                  first) -> None:
        """Common post-prefill slot activation + the one admission sync.

        A preempt-resume (``req._pre_gen``) re-enters here with ``ids`` =
        original prompt + pre-generated tokens; ``prompt_len`` stays the
        *original* prompt length so the in-jit sample-count math
        (``cnts = cache_len - prompt_len + 1``) continues the RNG chain at
        exactly the token index the preemption interrupted."""
        pre = req._pre_gen or []
        slot.request = req
        slot.cache_len = len(ids)
        slot.prompt_len = len(ids) - len(pre)
        slot.remaining = req.max_new_tokens - len(pre) - 1
        slot.generated = list(pre) + [int(first)]         # one host sync
        if pre:
            self._preempt_resumes += 1
        else:
            req._orig_plen = len(ids)
        req._pre_gen = None
        if req.first_token_s == 0.0:
            req.first_token_s = time.perf_counter() - req._submit_t
        req.status = "running"
        self._arm_spec(slot, ids)
        self._slot_consts = None        # slot membership changed
        self._prefill_syncs += 1

    def _admit_dense(self, si: int, slot: _Slot, req: Request):
        ids = self._encode_prompt(req)
        try:
            first = self._prefill_span(si, req, ids, 0, len(ids), sample=True)
        except Exception:
            # failure isolation: nothing allocated yet — the partially
            # written cache row is fully overwritten by the next admission
            self._uncount_prompt(req, ids)
            raise
        self._activate(si, slot, req, ids, first)
        slot.token_ids = ids        # sessions track the exact token stream
                                    # (dense mode reuses nothing, but turn
                                    # continuation must still be token-exact)
        return True

    def _admit_paged(self, si: int, slot: _Slot, req: Request):
        """Paged admission: radix-match the prompt, reserve pages, prefill
        only the un-matched suffix. A session turn that extends its retained
        conversation additionally reuses the session's partial tail page and
        starts at the exact (non-block-aligned) position the conversation
        left off. Returns False (request stays queued) when the pool can't
        supply pages even after LRU eviction."""
        ids = self._encode_prompt(req)
        ps = self.engine_cfg.page_size
        sess = req._sess
        # always recompute at least the last prompt token (its logits seed
        # the first sampled token), so cap the usable match one token short
        shared, node = self.radix.match(ids[:len(ids) - 1])
        tail_len = self._tail_usable(req, ids)
        # the tail page only adjoins gap-free if the radix (pinned by the
        # session since last turn) still covers every complete block below it
        use_tail = (tail_len > len(shared) * ps and sess.tail_page >= 0
                    and len(shared) == tail_len // ps)
        prefix_len = tail_len if use_tail else len(shared) * ps
        total_pages = -(-min(len(ids) + self._req_budget(req) + 1,
                             self.capacity) // ps)
        if total_pages > self.kvpool.num_pages - self.kvpool.reserved:
            # can NEVER fit, even with every page free: dead-letter instead
            # of spinning the admission loop (or crashing the pump)
            self.radix.release(node)
            self._uncount_prompt(req, ids)
            raise RequestFault(
                f"paged KV pool too small: request rid={req.rid} needs "
                f"{total_pages} pages but the pool can ever free at most "
                f"{self.kvpool.num_pages - self.kvpool.reserved} "
                f"(num_pages={self.kvpool.num_pages}, page_size={ps})")
        n_have = len(shared) + (1 if use_tail else 0)
        priv = self.kvpool.alloc(total_pages - n_have)
        if priv is None:
            freed = self.radix.evict(total_pages - n_have
                                     - self.kvpool.num_free)
            self.kvpool.free(freed)
            priv = self.kvpool.alloc(total_pages - n_have)
        if priv is None:
            self.radix.release(node)
            # un-count this attempt; the request stays at the queue head
            self._uncount_prompt(req, ids)
            return False
        if use_tail:
            # the tail page transfers to this request's private chain; on
            # cancel it goes back to the session, on finalize it re-enters
            # the normal adopt-or-retail flow
            slot.sess_tail_page = sess.tail_page
            priv = [sess.tail_page] + priv
            sess.tail_page = -1
        hit_turn = bool(tail_len and prefix_len >= tail_len)
        if hit_turn:
            # the whole retained conversation was served from reuse — the
            # session tail, or a radix path another request drove deeper
            self._turn_prefix_hits += 1
        req.prefix_hit_tokens = prefix_len
        self._prefix_hit_tokens += prefix_len
        bt = kvpool.block_table_array([shared + priv], self._bt_width,
                                      self.device)
        first = None
        plan = self._chunk_plan(len(ids) - prefix_len, prefix_len)
        try:
            for ci, (off, real, padded) in enumerate(plan):
                start = prefix_len + off
                tokens, positions = self._chunk_batch(
                    ids[start:start + real], start, padded)
                self._pad_tokens += padded - real
                self._extend_shapes.add((padded, self.cfg.modality))
                self._extend_chunks += 1
                self.cache, tok = self.progs.extend_paged(
                    self.params, self.cache, tokens, positions, bt,
                    start, real, req._key0, req.temperature, req.top_k,
                    sample=ci == len(plan) - 1)
                if ci == len(plan) - 1:
                    first = tok
        except Exception:
            # failure isolation: this request never activated — give the
            # tail page back to its session, return every reserved page,
            # unpin the trie, and roll the admission counters back so the
            # exactly-once ownership invariant holds on the fault path too
            if slot.sess_tail_page >= 0:
                sess.tail_page = slot.sess_tail_page
                priv.remove(slot.sess_tail_page)
                slot.sess_tail_page = -1
            self.kvpool.free(priv)
            self.radix.release(node)
            if hit_turn:
                self._turn_prefix_hits -= 1
            self._prefix_hit_tokens -= prefix_len
            req.prefix_hit_tokens = 0
            self._uncount_prompt(req, ids)
            raise
        self._activate(si, slot, req, ids, first)
        slot.token_ids = ids
        slot.pages_shared = shared
        slot.pages_priv = priv
        slot.node = node
        self._bt_device = None          # slot membership changed
        self._group_queue(ids, req)
        return True

    def _capture_snapshot(self, si: int) -> int:
        """Splice slot ``si``'s current state into a fresh arena row.
        Returns the slot id, or -1 when the arena stays full even after LRU
        trie eviction (every row backs a pinned path) — the capture is then
        skipped; correctness is untouched, only future hit depth."""
        sid = self.snaps.alloc()
        if sid is None:
            self.snaps.free(self.radix.evict_snaps(1))
            sid = self.snaps.alloc()
        if sid is None:
            return -1
        try:
            self.snap_arena = self.progs.snap_capture(self.snap_arena,
                                                      self.cache, sid, si)
        except Exception:
            self.snaps.free([sid])      # exactly-once: reclaim the fresh row
            raise
        self._snap_captures += 1
        return sid

    def _admit_snap(self, si: int, slot: _Slot, req: Request):
        """Snapshot-mode admission (stateful archs under cache_mode="paged"):
        radix-match the prompt, restore the nearest per-prefix state
        snapshot into the slot — or, for a session turn extending its
        conversation, the session's end-of-generation tail snapshot at its
        exact non-block-aligned length — and prefill only the suffix,
        capturing new snapshots at every ``snap_stride``-block boundary
        along the way and adopting them into the trie immediately, so the
        rest of THIS engine step's grouped admissions already reuse them.
        Never fails: snapshots take no pages, and a full arena only skips
        captures."""
        ids = self._encode_prompt(req)
        ps = self.engine_cfg.page_size
        sess = req._sess
        # always recompute at least the last prompt token (its logits seed
        # the first sampled token), so cap the usable match one token short
        _, node = self.radix.match(ids[:len(ids) - 1])
        new_snaps = {}
        try:
            sid, sblocks = self.radix.nearest_snapshot(node)
            restore = sblocks * ps
            tail_len = self._tail_usable(req, ids)
            if tail_len > restore and sess.tail_snap >= 0:
                # session tail beats the deepest block-aligned trie snapshot
                self.cache = self.progs.snap_restore(
                    self.cache, self.snap_arena, sess.tail_snap, si)
                restore = tail_len
                self._snap_hits += 1
            elif sid >= 0:
                self.cache = self.progs.snap_restore(
                    self.cache, self.snap_arena, sid, si)
                self._snap_hits += 1
            else:
                self._snap_misses += 1
            if tail_len and restore >= tail_len:
                self._turn_prefix_hits += 1
            req.prefix_hit_tokens = restore
            self._prefix_hit_tokens += restore
            stride = ps * max(1, self.engine_cfg.snap_stride)
            bounds = set(range((restore // stride + 1) * stride,
                               len(ids) + 1, stride))
            pos, first = restore, None
            for end in sorted(bounds | {len(ids)}):
                first = self._prefill_span(si, req, ids, pos, end,
                                           sample=end == len(ids))
                if end in bounds:
                    s = self._capture_snapshot(si)
                    if s >= 0:
                        new_snaps[end // ps] = s
                pos = end
            if new_snaps:
                hi = max(new_snaps) * ps
                self.snaps.free(self.radix.insert_snaps(ids[:hi], new_snaps))
        except Exception:
            # failure isolation: unpin the trie, return captured-but-not-
            # yet-inserted snapshots to the arena, roll back the counters —
            # exactly-once snapshot ownership holds on the fault path too
            self.radix.release(node)
            self.snaps.free(list(new_snaps.values()))
            self._prefix_hit_tokens -= req.prefix_hit_tokens
            req.prefix_hit_tokens = 0
            self._uncount_prompt(req, ids)
            raise
        self._activate(si, slot, req, ids, first)
        slot.token_ids = ids
        slot.node = node
        self._group_queue(ids, req)
        return True

    def _arm_spec(self, slot: _Slot, ids: List[int]):
        """Index the request's context for the n-gram drafter (prompt + the
        first sampled token; decode/verify commits extend it)."""
        if not self.spec:
            return
        # ids + the newly sampled token; a preempt-resume's pre-generated
        # tokens are already inside ids, so index only the last sample
        slot.drafter = NgramDrafter(ids + slot.generated[-1:],
                                    n_min=self.engine_cfg.spec_ngram_min,
                                    n_max=self.engine_cfg.spec_ngram_max)
        slot.spec_on = True

    def _group_queue(self, ids: List[int], req: Request):
        """Radix-aware admission batching (paged): stable-move queued
        requests whose (truncated) prompt shares the just-admitted prompt's
        first radix block to the queue front, so the remaining free slots of
        THIS engine step admit them while the shared prefix pages are pinned
        and hot — N agents sharing a system prompt prefill it once and join
        the same decode batch. FIFO order survives within the group and the
        remainder (a grouped request may jump a higher priority class for
        this one step — the shared-prefix locality win is worth it)."""
        ps = self.engine_cfg.page_size
        # ``req`` is the request being admitted right now (still queued until
        # _admit removes it; with admission backoff it need not be the head)
        others = [r for r in self._queue if r is not req]
        if len(ids) < ps or not others:
            return
        head = tuple(ids[:ps])
        grouped, rest = [], []
        for r in others:
            if r._ids is None:
                r._ids = self.tokenizer.encode(r.prompt)
            rids = r._ids[-(self.capacity - r.max_new_tokens - 1):]
            if len(rids) >= ps and tuple(rids[:ps]) == head:
                r._grouped = True
                grouped.append(r)
            else:
                rest.append(r)
        if grouped:
            self._queue = collections.deque([req] + grouped + rest)

    def _next_admittable(self, now: float) -> Optional[Request]:
        """First queued request not sitting out an admission backoff —
        priority/FIFO order is the queue order, so the head-of-line request
        still admits first whenever it is eligible."""
        for r in self._queue:
            if r._retry_at <= now:
                return r
        return None

    def _admit(self):
        """Prefill queued requests into free slots (continuous batching).

        Admission is FIFO within priority classes, with two fault-layer
        behaviours (serving/faults.py):

        * **backoff + starvation guard**: when the paged pool can't cover a
          request even after LRU eviction, the request backs off
          (exponential + jitter per ``RetryPolicy``) instead of blocking the
          whole round — the next admittable candidate gets a shot at the
          slot, so a burst of small requests keeps flowing around a large
          head-of-line request. The backed-off request keeps its queue
          position and admits first again the moment its backoff elapses.
        * **dead-lettering**: a request whose admission *faults* (injected
          ``RequestFault``, a page demand the pool can never satisfy, or —
          with nothing active to ever free pages — retries exhausted) is
          terminated FAILED with the error on the request, instead of
          crashing the engine pump.
        """
        admit = (self._admit_paged if self.paged else
                 self._admit_snap if self.snapshots else
                 self._admit_dense)
        for si, slot in enumerate(self.slots):
            if slot.request is not None:
                continue
            while True:          # candidates until one admits or none left
                now = time.perf_counter()
                req = self._next_admittable(now)
                if req is None:
                    break
                t0 = time.perf_counter()
                try:
                    admitted = admit(si, slot, req)
                except (RequestFault, DeadLetterError) as e:
                    # failure isolation: only this request dies; the slot
                    # is still free for the next candidate
                    self._queue.remove(req)
                    self._finish_abort(req, "failed", e)
                    if isinstance(e, DeadLetterError):
                        self._breaker_note(False)
                    continue
                if not admitted:
                    req._admit_attempts += 1
                    self._admission_retries += 1
                    if (req._admit_attempts >= self.retry.max_attempts
                            and not self._active()):
                        # nothing running will ever free pages for it:
                        # waiting longer cannot help — dead-letter
                        self._queue.remove(req)
                        self._finish_abort(req, "failed", DeadLetterError(
                            f"rid={req.rid}: admission failed "
                            f"{req._admit_attempts} times with no active "
                            f"requests to free pool capacity"))
                        continue
                    req._retry_at = now + self.retry.delay(
                        req._admit_attempts, self._backoff_rng)
                    continue
                self._queue.remove(req)
                if req._grouped:
                    self._grouped_admissions += 1
                    req._grouped = False
                req._admit_attempts = 0
                req.admit_index = self._next_admit
                self._next_admit += 1
                req.prefill_s += time.perf_counter() - t0
                break
        # grouping credit is same-step only: a sharer still queued when the
        # round ends admits later on its own (the pinned pages may be gone)
        for r in self._queue:
            r._grouped = False

    def _active(self):
        return [i for i, s in enumerate(self.slots) if s.request is not None]

    # ---- stop sequences ----------------------------------------------------
    def _apply_stop(self, slot: _Slot) -> bool:
        """Host-side stop-sequence check at the per-chunk sync: halt at the
        first token whose decoded prefix contains a stop string and trim the
        tokens after it from the result (token granularity — the stop may
        end mid-token). The full decoded text is searched, so a stop split
        across a chunk boundary is caught the moment its last piece lands."""
        req = slot.request
        if not req.stop or slot.stopped:
            return slot.stopped
        text = self.tokenizer.decode(slot.generated)
        if not any(s in text for s in req.stop):
            return False
        for n in range(1, len(slot.generated) + 1):
            t = self.tokenizer.decode(slot.generated[:n])
            if any(s in t for s in req.stop):
                slot.generated = slot.generated[:n]
                slot.stopped = True
                return True
        return False                                      # unreachable

    # ---- finalize ----------------------------------------------------------
    def _finalize(self, si: int):
        slot = self.slots[si]
        req = slot.request
        sess = req._sess
        req.output_ids = list(slot.generated)
        req.output_tokens = len(slot.generated)
        req.output_text = self.tokenizer.decode(slot.generated)
        req.latency_s = time.perf_counter() - req._submit_t
        # token_ids[:prompt_len] is the admitted prompt; for a preempt-
        # resumed slot token_ids additionally carries the re-prefilled
        # pre-generated tokens, which slot.generated already repeats
        all_tokens = (slot.token_ids[:slot.prompt_len]
                      if slot.token_ids is not None else []) + slot.generated
        # positions the cache truly covers for the *trimmed* output (the
        # final generated token is sampled but never processed; a stop trim
        # shrinks this below slot.cache_len)
        kv_cover = max(len(all_tokens) - 1, 0)
        if self.paged:
            # donate the finished sequence's complete pages to the radix tree
            # (prompt + generated tokens: the next agent turn's prompt embeds
            # this whole conversation, so it will match deep), free the rest
            ps = self.engine_cfg.page_size
            n_complete = kv_cover // ps
            bt_pages = slot.pages_shared + slot.pages_priv
            rejected = self.radix.insert(all_tokens[:n_complete * ps],
                                         bt_pages[:n_complete])
            if sess is not None and not req.cancelled:
                leftover = rejected + bt_pages[n_complete:]
                tail_page = -1
                if kv_cover % ps and bt_pages[n_complete] not in rejected:
                    # the partial tail page: positions past the last block
                    # boundary, generated tokens included — the session keeps
                    # it so the next turn restores at the exact end of this
                    # one instead of the last page boundary
                    tail_page = bt_pages[n_complete]
                    leftover = [p for p in leftover if p != tail_page]
                self.kvpool.free(leftover)
                # re-pin the trie path under the (possibly deeper) complete
                # prefix so eviction can't open a gap below the tail
                _, new_node = self.radix.match(all_tokens[:n_complete * ps])
                self.radix.release(slot.node)
                if sess.node is not None:
                    self.radix.release(sess.node)
                if sess.tail_page >= 0:          # superseded tail
                    self.kvpool.free([sess.tail_page])
                sess.node = new_node
                sess.tail_page = tail_page
            else:
                self.kvpool.free(rejected + bt_pages[n_complete:])
                self.radix.release(slot.node)
            self._bt_device = None      # slot membership changed
        elif self.snapshots:
            # prefix snapshots were adopted into the trie at admission; a
            # session turn additionally captures the end-of-generation state
            # at its exact (non-block-aligned) length into a session-owned
            # arena row — the trie can't index it, the session can
            if sess is not None and not req.cancelled:
                if slot.stopped:
                    new_snap = -1
                else:
                    try:
                        new_snap = self._capture_snapshot(si)
                    except Exception:
                        # a faulted tail capture degrades to a skipped one
                        # (pure optimization: the next turn re-prefills) —
                        # it must not crash the pump at finalize
                        new_snap = -1
                if sess.tail_snap >= 0:
                    self.snaps.free([sess.tail_snap])
                sess.tail_snap = new_snap
                # transfer the admission pin: it covers the prompt path the
                # next turn will re-match
                if sess.node is not None:
                    self.radix.release(sess.node)
                sess.node = slot.node
            else:
                self.radix.release(slot.node)
        if sess is not None and not req.cancelled:
            # a stop trim / EOS-truncated spec accept leaves device state
            # past the kept tokens: the token stream is still exact
            # (kv_cover shrank with it), but the snapshot capture above is
            # skipped since the state ran ahead (KV pages are per-position,
            # so the paged tail page stays valid either way)
            sess.all_tokens = all_tokens
            sess.text = req.prompt + req.output_text
            if sess.live is req:
                sess.live = None
            # crash-safe journal: the token-level state a fresh server needs
            # to rebuild this session's tail (restore_session)
            self.journal.record(sess.sid, sess.text, sess.all_tokens,
                                sess.turns)
        req.status = "completed"
        req.finished = True
        self._note_service(req)
        self.slots[si] = _Slot()

    # ---- speculative decode pass -------------------------------------------
    def _spec_pass(self, active) -> set:
        """One speculative verify pass, interleaved with the chunked-decode
        loop: slots whose drafter has a proposal verify it this step; the
        returned set sits out the decode chunk. Falls back to plain chunked
        decode (empty set) when no slot has a draft, so non-copyable
        workloads pay nothing but the host-side n-gram lookups."""
        eos = self.tokenizer.eos_id
        live = []
        for i in active:
            s = self.slots[i]
            # same conditions the decode loop's entry done-mask would catch
            if (s.remaining <= 0 or s.cache_len >= self.capacity - 1
                    or s.generated[-1] == eos):
                self._finalize(i)
                continue
            live.append(i)
        if not live:
            return set(active)
        drafts = {}
        for i in live:
            s = self.slots[i]
            d = []
            if s.spec_on:
                # the +1 correction/bonus token must fit the budget and the
                # capacity window, and draft writes must stay in bounds
                cap = min(self.engine_cfg.spec_len, s.remaining - 1,
                          self.capacity - 2 - s.cache_len)
                if cap > 0:
                    d = s.drafter.draft(cap)
            drafts[i] = d
        drafted = [i for i in live if drafts[i]]
        if not drafted:
            return set()
        # only drafted slots verify; the rest keep the chunked decode loop
        # (a disabled or draftless slot must not degrade to one-token steps)
        try:
            self._spec_step_batched(drafted, drafts)
        except Exception as e:
            # failure isolation: only the drafted slots die; undrafted
            # co-batched slots still run their decode chunk this step
            self._fail_slots(drafted, e)
        return set(drafted)

    def _spec_step_batched(self, live, drafts):
        """ONE verify forward scores every drafted slot's proposal at once
        (rows of undrafted slots carry lens=0: dropped or trash-page writes,
        no commits). Rollback: linear full-attention K/V is masked by cache
        position until overwritten. Stochastic rows draw with the key pair
        (request key, token index of the row's first verify column)."""
        t0 = time.perf_counter()
        S = self.engine_cfg.spec_len + 1
        tok_rows = [[0] * S for _ in range(self.num_slots)]
        lens = [0] * self.num_slots
        for i in live:
            s = self.slots[i]
            row = [s.generated[-1]] + drafts[i]
            lens[i] = len(row)
            tok_rows[i][:len(row)] = row
        dev = self._tensor
        tokens = dev(tok_rows)
        lens_a = dev(lens)
        clens = dev([s.cache_len for s in self.slots])
        # the same greedy/temps/top-k static specialization as the decode loop
        sampling = any(self.slots[i].request.temperature > 0.0 for i in live)
        temps = (dev([s.request.temperature if s.request else 0.0
                      for s in self.slots], torch.float32)
                 if sampling else None)
        top_ks = (dev([s.request.top_k if s.request else 0
                       for s in self.slots])
                  if sampling and any(self.slots[i].request.top_k > 0
                                      for i in live)
                  else None)
        # column 0 judges the token at index cache_len - prompt_len + 1, the
        # index the decode loop would give it
        keys = (dev([[s.request._key if s.request else 0,
                      s.cache_len - s.prompt_len + 1] for s in self.slots],
                    torch.int64)
                if sampling else None)
        bt = self._decode_block_tables()
        self.cache, out_tok, out_len = self.progs.verify(
            self.params, self.cache, tokens, clens, lens_a, temps, top_ks,
            keys, bt)
        # the ONE host sync of the verify step
        pulled = torch.cat([out_tok.flatten(), out_len]).cpu().numpy()
        out_tok = pulled[:self.num_slots * S].reshape(self.num_slots, S)
        out_len = pulled[self.num_slots * S:]
        self._breaker_note(True)
        self._decode_syncs += 1
        self._verify_steps += 1
        self._verify_rows += len(live)
        dt = time.perf_counter() - t0
        for i in live:
            self._commit_spec(i, drafts[i], out_tok[i], int(out_len[i]),
                              dt / len(live))

    def _commit_spec(self, si, draft, out_row, n, dt):
        """Commit one slot's verify outcome: n = accepted drafts + 1
        correction/bonus token, truncated at the first EOS."""
        slot = self.slots[si]
        eos = self.tokenizer.eos_id
        emitted = [int(t) for t in out_row[:n]]
        for j, t in enumerate(emitted):
            if t == eos:
                emitted = emitted[:j + 1]
                break
        if len(emitted) < n:
            # accepted drafts past the EOS were already committed into the
            # device state (verify_commit rewinds to the accepted length,
            # not the EOS) — the state now runs ahead of the kept tokens,
            # exactly like a stop trim: a session tail snapshot captured
            # from it would corrupt the next turn, so flag the slot
            slot.stopped = True
        slot.generated.extend(emitted)
        slot.drafter.extend(emitted)
        slot.cache_len += len(emitted)
        slot.remaining -= len(emitted)
        slot.spec_drafted += len(draft)
        slot.spec_accepted += n - 1
        self._draft_tokens += len(draft)
        self._accepted_tokens += n - 1
        self._decode_tokens += len(emitted)
        slot.request.decode_s += dt
        ecfg = self.engine_cfg
        if (slot.spec_on and slot.spec_drafted >= ecfg.spec_warmup
                and slot.spec_accepted <
                ecfg.spec_min_accept * slot.spec_drafted):
            slot.spec_on = False        # this request isn't n-gram-predictable
        stopped = self._apply_stop(slot)
        if (stopped or slot.remaining <= 0 or slot.generated[-1] == eos
                or slot.cache_len >= self.capacity - 1):
            self._finalize(si)

    # ---- engine step --------------------------------------------------------
    def _tensor(self, values, dtype=torch.int32):
        """Host values as a tensor on the scheduler's device."""
        return torch.tensor(values, dtype=dtype, device=self.device)

    def _decode_block_tables(self):
        """Per-slot block tables for the decode/verify jits (paged mode):
        the table only changes when slot membership does — cached on device
        between chunks; empty slots point at the trash page."""
        if not self.paged:
            return None
        if self._bt_device is None:
            self._bt_device = kvpool.block_table_array(
                [(s.pages_shared + s.pages_priv) if s.request else []
                 for s in self.slots], self._bt_width, self.device)
        return self._bt_device

    def _fail_slots(self, indices, exc: BaseException):
        """Failure isolation: terminate the requests in these slots FAILED,
        freeing everything they hold; co-batched requests in other slots are
        untouched. Injected faults raise *before* dispatch (programs._run),
        so the shared cache was not consumed and the survivors' state is
        exactly what it was before the faulted call."""
        for si in indices:
            if self.slots[si].request is None:
                continue
            req = self.slots[si].request
            self._release_slot(si)
            self._finish_abort(req, "failed", exc)
        if isinstance(exc, DeadLetterError):
            self._breaker_note(False)

    def step(self):
        """One engine iteration: expire deadlines, run the overload policy
        (shed sweep + priority preemption at this chunk boundary), admit,
        then one speculative verify pass for slots with drafts (when spec
        is on) and/or one chunked decode for the rest."""
        self._expire_deadlines()
        if self.overload is not None:
            now = time.perf_counter()
            self._shed_sweep(now)
            self._preempt_for_priority(now)
        self._admit()
        active = self._active()
        if not active:
            if self._queue:
                # every queued request is in admission backoff: sleep until
                # the earliest retry so run_until_drained / pump loops don't
                # hot-spin the admission path
                wait = (min(r._retry_at for r in self._queue)
                        - time.perf_counter())
                if wait > 0:
                    time.sleep(min(wait, 0.05))
            return False
        # co-batching telemetry: how many requests actually share this step
        self._steps += 1
        self._active_slot_sum += len(active)
        handled = self._spec_pass(active) if self.spec else set()
        rest = [i for i in self._active() if i not in handled]
        if not rest:
            return True
        t0 = time.perf_counter()
        dev = self._tensor
        last = dev([s.generated[-1] if s.request else 0 for s in self.slots])
        clens = dev([s.cache_len for s in self.slots])
        rem = dev([s.remaining for s in self.slots])
        # spec-handled slots sit this chunk out via the done mask (they
        # already advanced up to spec_len+1 tokens this step)
        done = dev([i in handled or s.request is None
                    or s.remaining <= 0
                    or s.cache_len >= self.capacity - 1
                    or s.generated[-1] == self.tokenizer.eos_id
                    for i, s in enumerate(self.slots)], torch.bool)
        # static specialization: an all-greedy batch (the common agent case)
        # runs a loop body with no noise / top-k sort
        sampling = any(s.request.temperature > 0.0
                       for s in self.slots if s.request)
        temps = (dev([s.request.temperature if s.request else 0.0
                      for s in self.slots], torch.float32)
                 if sampling else None)
        top_ks = (dev([s.request.top_k if s.request else 0
                       for s in self.slots])
                  if sampling and any(s.request.top_k > 0
                                      for s in self.slots if s.request)
                  else None)
        # per-request RNG chains: row b samples its t-th token with the key
        # pair (keys[b], t), t derived on the device from cache_lens and the
        # prompt length — reproducible per request whatever the batch
        # composition. keys/prompt_lens only change with slot membership,
        # so they stay on the device between chunks.
        if self._slot_consts is None:
            self._slot_consts = (
                dev([s.request._key if s.request else 0 for s in self.slots],
                    torch.int64),
                dev([s.prompt_len for s in self.slots]))
        keys, plens = self._slot_consts
        bt = self._decode_block_tables()

        try:
            self.cache, tok_buf, emit_buf, clens, rem, done = \
                self.progs.decode_chunk(self.params, self.cache, last, clens,
                                        rem, done, temps, top_ks, keys, plens,
                                        bt)
            # the ONE host sync of the chunk: pull tokens + masks + slot
            # state in a single transfer
            chunk = tok_buf.shape[0]
            pulled = torch.cat([tok_buf.flatten(), emit_buf.flatten().int(),
                                clens, rem, done.int()]).cpu().numpy()
            n = chunk * self.num_slots
            tok_buf = pulled[:n].reshape(chunk, self.num_slots)
            emit_buf = pulled[n:2 * n].reshape(chunk, self.num_slots) != 0
            clens_h, rem_h, done_h = pulled[2 * n:].reshape(3, self.num_slots)
        except Exception as e:
            # failure isolation: a dead-lettered decode dispatch (retries
            # exhausted / injected corruption) fails only the slots in this
            # chunk — queued requests and the next step's admissions go on
            self._fail_slots(rest, e)
            return True
        self._breaker_note(True)
        self._decode_syncs += 1
        self._decode_chunks += 1
        dt = time.perf_counter() - t0

        emitted = 0
        for i in rest:
            slot = self.slots[i]
            new = tok_buf[:, i][emit_buf[:, i]]
            slot.generated.extend(int(t) for t in new)
            if slot.drafter is not None and new.size:
                slot.drafter.extend([int(t) for t in new])
            emitted += int(new.size)
            slot.cache_len = int(clens_h[i])
            slot.remaining = int(rem_h[i])
            slot.request.decode_s += dt / max(len(rest), 1)
        self._decode_tokens += emitted
        for i in rest:
            stopped = self._apply_stop(self.slots[i])
            if stopped or bool(done_h[i]):
                self._finalize(i)
        return True

    def run_until_drained(self):
        while self.step() or self._queue:
            pass
