"""The port's fault layer (serving/faults.py hooks, failure isolation,
admission backoff, the watchdog, the session journal) in the scenarios of
tests/test_chaos.py, on the CPU.

* transient faults retry away bit-identically; a request fault, a
  dead-lettered decode chunk, a never-fitting request and a corruption
  fail only their own requests, typed, and the engine serves on;
* pool exhaustion backs the head of the line off and a later small request
  admits first (asserted by admission order and retry counts: the
  scheduler's clock moves only by its own backoff sleeps, so no assertion
  depends on elapsed host time);
* a journal spilled after turn 1 restores into a fresh port server whose
  turn 2 equals the uninterrupted server's, dense, paged and snapshot; and
  a journal spilled by the JAX package's ``LLMServer`` restores into the
  port's, whose next greedy turn equals the JAX server's;
* seeded fault schedules (fixed hypothesis examples) leave every handle
  terminal, fault-free completions bit-identical to a fault-free server,
  and page / snapshot ownership exactly-once.

EOS guard (ROADMAP.md queue 3): the EOS logit is pinned at 0, and every
parity test asserts that the reference emitted its whole budget.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serving.server import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.server import LLMServer as JServer  # noqa: E402
from repro.serving.server import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.scheduler import SamplingParams  # noqa: E402
from repro_torch.serving.server import (CorruptionError, DeadLetterError,  # noqa: E402
                                        EngineConfig, FaultInjector,
                                        LLMServer, RequestFault,
                                        RequestStatus, RetryPolicy,
                                        SessionJournal)

from tests._hypothesis_compat import given, settings, st  # noqa: E402

KW = dict(dtype="float32", param_dtype="float32", vocab_size=512)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite runs several
    workers side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MADE = {}


def weights(arch):
    """(JAX config, JAX params, port config, port state dict): the same
    numbers, EOS guarded; made once per arch and worker."""
    if arch not in _MADE:
        jcfg, cfg = JARCHS[arch].reduced(**KW), ARCHS[arch].reduced(**KW)
        jp = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(0)))
        if cfg.tie_embeddings:
            t = jp["embed"]["table"].copy()
            t[cfg.vocab_size - 1] = 0.0
            jp["embed"]["table"] = t
        else:
            t = jp["unembed"]["table"].copy()
            t[:, cfg.vocab_size - 1] = 0.0
            jp["unembed"]["table"] = t
        _MADE[arch] = (jcfg, jax.tree.map(jnp.asarray, jp), cfg,
                       params_from_jax(jp, cfg))
    return _MADE[arch]


def _server(arch="qwen2.5-3b", **kw):
    _, _, cfg, sd = weights(arch)
    return LLMServer(cfg, params=sd, device="cpu", **kw)


def _page_leak_check(srv):
    """Exactly-once page ownership: free list | radix tree | session tail."""
    eng = srv.engine
    assert all(s.request is None for s in eng.slots)
    owned = eng.radix.check_invariants()
    free = set(eng.kvpool._free)
    tails = {s.tail_page for s in eng._sessions.values() if s.tail_page >= 0}
    assert not (owned & free) and not (owned & tails) and not (free & tails)
    assert (len(owned) + len(free) + len(tails)
            == eng.kvpool.num_pages - eng.kvpool.reserved)


def _snap_leak_check(srv):
    """Exactly-once snapshot ownership: free list | radix | session tail."""
    eng = srv.engine
    assert all(s.request is None for s in eng.slots)
    owned = eng.radix.check_invariants(snapshots=True)
    free = set(eng.snaps._free)
    tails = {s.tail_snap for s in eng._sessions.values() if s.tail_snap >= 0}
    assert not (owned & free) and not (owned & tails) and not (free & tails)
    assert len(owned) + len(free) + len(tails) == eng.snaps.num_snaps


class _Clock:
    """The scheduler's clock: it moves only by the scheduler's own
    ``sleep`` (the admission backoff's)."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        self.t += max(s, 0.0)


# ---------------------------------------------------------------------------
# transient faults, isolation, dead-letters
# ---------------------------------------------------------------------------


def test_transient_fault_retried_bit_identical():
    """Transient faults at prefill and decode are retried away: the output
    equals a fault-free server's and the handle COMPLETED."""
    ref = _server(num_slots=2, capacity=96)
    want = ref.submit("the quick brown fox", SamplingParams(max_new_tokens=10))
    want.result()
    assert len(want.request.output_ids) == 10                # EOS guard
    inj = FaultInjector(seed=0)
    srv = _server(num_slots=2, capacity=96, injector=inj,
                  retry=RetryPolicy(max_attempts=3, backoff_s=1e-3))
    inj.fail_next("prefill", 1)
    inj.fail_next("decode", 2)
    h = srv.submit("the quick brown fox", SamplingParams(max_new_tokens=10))
    h.result()
    assert h.request.output_ids == want.request.output_ids
    assert h.status() == RequestStatus.COMPLETED
    st = srv.stats()
    assert st["dispatch_retries"] >= 3 and st["dead_lettered"] == 0
    assert inj.injected["prefill"] == 1 and inj.injected["decode"] == 2


def test_request_fault_isolated_to_one_handle():
    """A RequestFault at admission fails only the poisoned handle; the
    co-batched request equals a fault-free server's; no page leaks."""
    ecfg = EngineConfig(cache_mode="paged", page_size=16)
    ref = _server(num_slots=2, capacity=96, engine_cfg=ecfg)
    want = ref.submit("survivor prompt", SamplingParams(max_new_tokens=10))
    want.result()
    assert len(want.request.output_ids) == 10                # EOS guard
    inj = FaultInjector(seed=0)
    srv = _server(num_slots=2, capacity=96, engine_cfg=ecfg, injector=inj)
    inj.fail_next("extend_paged", 1, exc=RequestFault, msg="poisoned request")
    bad = srv.submit("poisoned prompt", SamplingParams(max_new_tokens=10))
    good = srv.submit("survivor prompt", SamplingParams(max_new_tokens=10))
    good.result()
    assert good.request.output_ids == want.request.output_ids
    assert good.status() == RequestStatus.COMPLETED
    assert bad.status() == RequestStatus.FAILED
    assert isinstance(bad.exception(), RequestFault)
    with pytest.raises(RequestFault):
        bad.result()
    _page_leak_check(srv)


def test_decode_deadletter_terminal_and_pump_survives():
    """Retries exhausted on a decode chunk dead-letter that chunk's slots
    (FAILED, exception kept); the engine serves new requests after."""
    inj = FaultInjector(seed=0)
    srv = _server(num_slots=2, capacity=96,
                  engine_cfg=EngineConfig(cache_mode="paged", page_size=16),
                  injector=inj, retry=RetryPolicy(max_attempts=2, backoff_s=1e-3))
    a = srv.submit("request a text", SamplingParams(max_new_tokens=12))
    b = srv.submit("request b text", SamplingParams(max_new_tokens=12))
    inj.fail_next("decode", 2)              # both attempts of one chunk
    srv.run_until_idle()
    for h in (a, b):
        assert h.status() == RequestStatus.FAILED and h.status().terminal
        assert isinstance(h.exception(), DeadLetterError)
    assert srv.stats()["dead_lettered"] == 2
    c = srv.submit("still serving", SamplingParams(max_new_tokens=4))
    assert c.result() is not None and c.status() == RequestStatus.COMPLETED
    _page_leak_check(srv)


# ---------------------------------------------------------------------------
# admission under pool exhaustion: backoff, starvation guard, never-fit
# ---------------------------------------------------------------------------


def test_pool_exhaustion_backoff_and_starvation_guard(monkeypatch):
    """Injected pool exhaustion backs the head of the line off instead of
    blocking the round: a later small request admits first, the denied
    ones retry, everyone completes. Counts and order only: the scheduler's
    clock moves by its backoff sleeps alone."""
    monkeypatch.setattr(tsched, "time", _Clock())
    inj = FaultInjector(seed=0)
    srv = _server(num_slots=2, capacity=128,
                  engine_cfg=EngineConfig(cache_mode="paged", page_size=16),
                  injector=inj, retry=RetryPolicy(max_attempts=8, backoff_s=5e-3))
    inj.exhaust_next("pool.alloc", 3)
    big = srv.submit("big request " * 8, SamplingParams(max_new_tokens=32))
    smalls = [srv.submit(f"small {i}", SamplingParams(max_new_tokens=4))
              for i in range(3)]
    srv.run_until_idle()
    for h in [big] + smalls:
        assert h.status() == RequestStatus.COMPLETED
    st = srv.stats()
    assert st["admission_retries"] >= 1
    assert st["dead_lettered"] == 0
    # FIFO says big admits first; the denials made a small overtake it
    assert min(h.request.admit_index for h in smalls) < big.request.admit_index
    _page_leak_check(srv)


def test_never_fit_dead_letters_without_crashing():
    """A request that can never fit the pool is dead-lettered with a clear
    error; the engine keeps serving."""
    srv = _server(num_slots=1, capacity=64,
                  engine_cfg=EngineConfig(cache_mode="paged", page_size=16,
                                          num_pages=3))
    h = srv.submit("a prompt that needs more pages than the pool holds",
                   SamplingParams(max_new_tokens=8))
    with pytest.raises(RequestFault):
        h.result()
    assert h.status() == RequestStatus.FAILED
    assert "pool too small" in str(h.exception())
    h2 = srv.submit("ok", SamplingParams(max_new_tokens=2))
    assert h2.result() is not None
    assert h2.status() == RequestStatus.COMPLETED
    _page_leak_check(srv)


# ---------------------------------------------------------------------------
# corruption, the watchdog
# ---------------------------------------------------------------------------


def test_corruption_fails_cleanly_paged():
    inj = FaultInjector(seed=0)
    srv = _server(num_slots=2, capacity=96,
                  engine_cfg=EngineConfig(cache_mode="paged", page_size=16),
                  injector=inj)
    inj.fail_next("extend_paged", 1, exc=CorruptionError, msg="corrupt page id")
    bad = srv.submit("to be corrupted", SamplingParams(max_new_tokens=8))
    with pytest.raises(CorruptionError):
        bad.result()
    assert bad.status() == RequestStatus.FAILED
    good = srv.submit("to be corrupted", SamplingParams(max_new_tokens=8))
    assert good.result() is not None
    assert good.status() == RequestStatus.COMPLETED
    _page_leak_check(srv)


def test_corruption_snapshot_restore_keeps_session_tail():
    """A corrupt snapshot restore fails only that turn; the session's tail
    survives and the retried turn reuses it."""
    inj = FaultInjector(seed=0)
    srv = _server("recurrentgemma-9b", num_slots=2, capacity=128,
                  engine_cfg=EngineConfig(cache_mode="paged", page_size=16),
                  injector=inj)
    sess = srv.open_session()
    sess.submit("sys: agent. turn one:", SamplingParams(max_new_tokens=8)).result()
    tail = srv.engine._sessions[sess.sid].tail_snap
    assert tail >= 0
    inj.fail_next("snap_restore", 1, exc=CorruptionError, msg="corrupt snap")
    bad = sess.submit(sess.text + " turn two:", SamplingParams(max_new_tokens=8))
    with pytest.raises(CorruptionError):
        bad.result()
    assert bad.status() == RequestStatus.FAILED
    assert srv.engine._sessions[sess.sid].tail_snap == tail
    retry = sess.submit(sess.text + " turn two:", SamplingParams(max_new_tokens=8))
    assert retry.result() is not None
    assert retry.request.prefix_hit_tokens > 0
    sess.close()
    _snap_leak_check(srv)


def test_watchdog_flags_stalled_dispatch():
    """An injected 50 ms stall before a decode dispatch, against a 10 ms
    watchdog: counted, not fatal (the injected sleep alone exceeds the
    bound, so the count does not depend on the host's speed)."""
    inj = FaultInjector(seed=0)
    srv = _server(num_slots=1, capacity=96, injector=inj, watchdog_s=0.01)
    inj.stall_next("decode", 1, stall_s=0.05)
    h = srv.submit("stalled but alive", SamplingParams(max_new_tokens=8))
    assert h.result() is not None
    assert h.status() == RequestStatus.COMPLETED
    assert srv.stats()["watchdog_stalls"] >= 1
    assert inj.injected["decode.stall"] == 1


# ---------------------------------------------------------------------------
# crash-safe session recovery
# ---------------------------------------------------------------------------

_T1 = "user: hello there assistant:"
_T2 = " user: and what else? assistant:"
RESTORE_MODES = [("qwen2.5-3b", "dense"), ("qwen2.5-3b", "paged"),
                 ("recurrentgemma-9b", "paged")]


@pytest.mark.parametrize("arch,mode", RESTORE_MODES)
def test_restore_sessions_bit_identical(arch, mode, tmp_path):
    """Kill a server after turn 1, restore its spilled journal on a fresh
    server: turn 2 equals the uninterrupted two-turn server's."""
    ecfg = EngineConfig(cache_mode=mode, page_size=16)
    sp = SamplingParams(max_new_tokens=12)
    ref = _server(arch, num_slots=2, capacity=192, engine_cfg=ecfg)
    s = ref.open_session()
    h1 = s.submit(_T1, sp)
    t1 = h1.result()
    h2 = s.submit(s.text + _T2, sp)
    h2.result()
    assert len(h1.request.output_ids) == len(h2.request.output_ids) == 12

    path = str(tmp_path / "sessions.json")
    crashed = _server(arch, num_slots=2, capacity=192, engine_cfg=ecfg,
                      journal_path=path)
    sa = crashed.open_session()
    assert sa.submit(_T1, sp).result() == t1
    old_sid = sa.sid
    del crashed                                   # the "crash"

    fresh = _server(arch, num_slots=2, capacity=192, engine_cfg=ecfg)
    sb = fresh.restore_sessions(path)[old_sid]
    assert sb.text == _T1 + t1
    h = sb.submit(sb.text + _T2, sp)
    h.result()
    assert h.request.output_ids == h2.request.output_ids, (arch, mode)
    if fresh.engine.paged:
        assert fresh.stats()["turn_prefix_hits"] >= 1
        _page_leak_check(fresh)


@pytest.mark.parametrize("arch,mode", RESTORE_MODES)
def test_jax_journal_restores_into_the_port(arch, mode, tmp_path):
    """A journal spilled by the JAX package's ``LLMServer`` after turn 1
    restores into the port's server, whose greedy turn 2 equals the JAX
    server's uninterrupted turn 2."""
    jcfg, jp, _, _ = weights(arch)
    ecfg = dict(cache_mode=mode, page_size=16, prefill_buckets=(32, 64))
    path = str(tmp_path / "jax_sessions.json")
    jsrv = JServer(jcfg, num_slots=2, capacity=192, params=jp,
                   engine_cfg=JEngineConfig(**ecfg), journal_path=path)
    js = jsrv.open_session()
    js.submit(_T1, JSamplingParams(max_new_tokens=12)).result()
    journal = SessionJournal.load(path)           # before turn 2 rewrites it

    port = _server(arch, num_slots=2, capacity=192, engine_cfg=EngineConfig(**ecfg))
    ps = port.restore_sessions(journal)[js.sid]
    assert ps.text == js.text and ps.turns == js.turns == 1

    jh = js.submit(js.text + _T2, JSamplingParams(max_new_tokens=12))
    jh.result()
    assert len(jh.request.output_ids) == 12                  # EOS guard
    h = ps.submit(ps.text + _T2, SamplingParams(max_new_tokens=12))
    h.result()
    assert h.request.output_ids == list(jh.request.output_ids), (arch, mode)
    assert ps.text == js.text


def test_session_journal_roundtrip(tmp_path):
    """Journal unit semantics: latest state per sid, drop, atomic dump /
    load round trip, spill on record."""
    j = SessionJournal()
    j.record(1, "one", [5, 6, 7], 1)
    j.record(2, "two", [8, 9], 1)
    j.record(1, "one more", [5, 6, 7, 10, 11], 2)   # overwrite, not append
    assert len(j) == 2
    assert j.get(1).all_tokens == [5, 6, 7, 10, 11] and j.get(1).turns == 2
    path = str(tmp_path / "j.json")
    j.dump(path)
    j2 = SessionJournal.load(path)
    assert [e.sid for e in j2.entries()] == [1, 2]
    assert j2.get(1).text == "one more" and j2.get(2).all_tokens == [8, 9]
    j2.drop(1)
    assert len(j2) == 1 and j2.get(1) is None
    j3 = SessionJournal(path=str(tmp_path / "spill.json"))
    j3.record(7, "x", [1, 2], 1)
    assert SessionJournal.load(j3.path).get(7).all_tokens == [1, 2]


# ---------------------------------------------------------------------------
# seeded fault schedules (fixed hypothesis examples)
# ---------------------------------------------------------------------------

CHAOS_PROMPTS = ["sys: agent loop. task alpha",
                 "sys: agent loop. task beta",
                 "sys: agent loop. a rather longer task gamma request",
                 "unrelated short prompt"]
CHAOS_ECFG = dict(cache_mode="paged", page_size=8, num_pages=18, decode_chunk=4)


@pytest.fixture(scope="module")
def chaos():
    """Shared paged chaos server (tiny pool, spec on, chunks of 4, bounded
    retry), its injector, and a cache of fault-free references (spec off:
    bit-identity is the non-spec contract)."""
    inj = FaultInjector(seed=0)
    srv = _server(num_slots=2, capacity=64,
                  engine_cfg=EngineConfig(spec_len=4, **CHAOS_ECFG),
                  injector=inj, retry=RetryPolicy(max_attempts=3, backoff_s=1e-3))
    ref = _server(num_slots=2, capacity=64, engine_cfg=EngineConfig(**CHAOS_ECFG))
    return srv, inj, ref, {}


def _ref_output(chaos, prompt, budget):
    _, _, ref, cache = chaos
    if (prompt, budget) not in cache:
        cache[prompt, budget] = ref.submit(
            prompt, SamplingParams(max_new_tokens=budget)).result()
    return cache[prompt, budget]


@given(st.integers(0, 2 ** 16 - 1),
       st.lists(st.tuples(st.integers(0, 3), st.integers(2, 10)),
                min_size=2, max_size=6))
@settings(max_examples=15, deadline=None, derandomize=True)
def test_chaos_paged_terminal_and_exactly_once(chaos, seed, ops):
    """Seeded fault rates on every paged site (extend, decode, verify, pool
    alloc): every handle terminal, completions equal the fault-free
    reference, page ownership exactly-once."""
    srv, inj, _, _ = chaos
    inj._rng.seed(seed)
    inj.rates.update({"extend_paged": 0.08, "decode": 0.08, "verify": 0.05,
                      "pool.alloc": 0.05})
    try:
        handles = []
        for variant, budget in ops:
            handles.append(srv.submit(CHAOS_PROMPTS[variant],
                                      SamplingParams(max_new_tokens=budget)))
            srv.step()
        srv.run_until_idle()
    finally:
        inj.rates.clear()
        srv.run_until_idle()
    for h in handles:
        assert h.status() in (RequestStatus.COMPLETED, RequestStatus.FAILED)
        if h.status() == RequestStatus.COMPLETED:
            assert h.text == _ref_output(chaos, h.request.prompt,
                                         h.request.max_new_tokens)
        else:
            assert h.exception() is not None
    _page_leak_check(srv)


@pytest.fixture(scope="module")
def snap_chaos():
    inj = FaultInjector(seed=0)
    srv = _server("recurrentgemma-9b", num_slots=2, capacity=96,
                  engine_cfg=EngineConfig(cache_mode="paged", page_size=8,
                                          num_snapshots=8, decode_chunk=4),
                  injector=inj, retry=RetryPolicy(max_attempts=3, backoff_s=1e-3))
    return srv, inj


@given(st.integers(0, 2 ** 16 - 1),
       st.lists(st.tuples(st.integers(0, 2), st.integers(2, 8)),
                min_size=2, max_size=5))
@settings(max_examples=10, deadline=None, derandomize=True)
def test_chaos_snapshots_terminal_and_exactly_once(snap_chaos, seed, ops):
    """Snapshot-mode chaos on recurrentgemma (faults on prefill, extend,
    decode, snapshot restore, arena exhaustion; session turns in the mix):
    every handle terminal, snapshot ownership exactly-once."""
    srv, inj = snap_chaos
    inj._rng.seed(seed)
    inj.rates.update({"prefill": 0.04, "extend": 0.06, "decode": 0.06,
                      "snap_restore": 0.08, "snap.alloc": 0.15})
    sess = srv.open_session()
    try:
        handles = []
        for variant, budget in ops:
            if variant == 2 and not sess.busy:
                prompt = (sess.text or CHAOS_PROMPTS[0]) + " next:"
                handles.append(sess.submit(prompt,
                                           SamplingParams(max_new_tokens=budget)))
            else:
                handles.append(srv.submit(CHAOS_PROMPTS[variant % len(CHAOS_PROMPTS)],
                                          SamplingParams(max_new_tokens=budget)))
            srv.step()
        srv.run_until_idle()
    finally:
        inj.rates.clear()
        srv.run_until_idle()
        sess.close()
    for h in handles:
        assert h.status() in (RequestStatus.COMPLETED, RequestStatus.FAILED)
    _snap_leak_check(srv)
