"""Overload control on the port's scheduler (OverloadPolicy) in the
scenarios of tests/test_overload.py, on the CPU.

* bounded admission: depth and per-class caps refuse typed, a
  higher-priority arrival displaces the youngest lower-priority request,
  stale and deadline-doomed queued requests are shed typed;
* the circuit breaker over dispatch dead-letters opens and cools;
* priority preemption at the chunk boundary resumes bit-identically in
  qwen dense, qwen paged and recurrentgemma snapshot mode: a sampled
  request equals the port's uninterrupted output, a greedy one also the
  JAX package's; equal priority never preempts; a stream stays monotonic;
* racing submit / cancel / preempt threads against a pumping server keep
  page and snapshot ownership exactly-once (fixed hypothesis examples).

Time: the scheduler's clock is replaced by one that moves only when a
test (or the scheduler's own backoff sleep) moves it, so the age cap and
the breaker's cooldown are asserted by order of events, never by elapsed
host time.

EOS guard (ROADMAP.md queue 3): the EOS logit is pinned at 0, and every
parity test asserts that the reference emitted its whole budget.
"""
import threading

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
from repro_torch.serving.faults import OverloadError, ShedError  # noqa: E402
from repro_torch.serving.scheduler import OverloadPolicy  # noqa: E402
from repro_torch.serving.server import (EngineConfig, FaultInjector,  # noqa: E402
                                        LLMServer, RetryPolicy, SamplingParams)

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


def _sp(max_new=8, priority=0, **kw):
    return SamplingParams(max_new_tokens=max_new, priority=priority, **kw)


class _Clock:
    """The scheduler's clock: it moves only by ``advance`` and by the
    scheduler's own ``sleep`` (the admission backoff's)."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        self.t += max(s, 0.0)

    def advance(self, s):
        self.t += s


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(tsched, "time", c)
    return c


# ---------------------------------------------------------------------------
# bounded admission: depth caps, displacement, age caps, predictive shed
# ---------------------------------------------------------------------------

def test_queue_depth_cap_and_priority_displacement():
    """A full queue refuses an equal-priority arrival typed; a higher one
    displaces the youngest lower-priority request (ShedError on it)."""
    srv = _server(num_slots=1, capacity=64,
                  overload=OverloadPolicy(max_queue_depth=3))
    lows = [srv.submit(f"low {i}", _sp()) for i in range(3)]
    with pytest.raises(OverloadError, match="queue full"):
        srv.submit("low overflow", _sp())
    hi = srv.submit("urgent", _sp(priority=2))
    victim = lows[-1]
    assert victim.status().value == "shed"
    assert isinstance(victim.request.error, ShedError)
    assert victim.request.finished
    srv.run_until_idle()
    assert hi.status().value == "completed"
    assert all(h.request.finished for h in lows)
    st = srv.stats()
    assert st["shed_requests"] == 1
    assert st["queued_requests"] == 0 and st["live_requests"] == 0


def test_per_class_depth_cap():
    """class_depth bounds one priority class and leaves the others."""
    srv = _server(num_slots=1, capacity=64,
                  overload=OverloadPolicy(class_depth={0: 2}))
    for i in range(2):
        srv.submit(f"batch {i}", _sp())
    with pytest.raises(OverloadError, match="class"):
        srv.submit("batch 2", _sp())
    hi = srv.submit("interactive", _sp(priority=1))
    srv.run_until_idle()
    assert hi.status().value == "completed"


def test_queue_age_cap_sheds_stale_requests(clock):
    """A request queued past the age cap is shed typed at the next step;
    the running request completes."""
    srv = _server(num_slots=1, capacity=128,
                  engine_cfg=EngineConfig(decode_chunk=2),
                  overload=OverloadPolicy(max_queue_age_s=0.05))
    runner = srv.submit("long running job " * 3, _sp(max_new=32))
    while runner.status().value != "running":
        srv.step()
    stale = srv.submit("will go stale", _sp())
    srv.step()
    assert stale.status().value == "queued"          # not yet past the cap
    clock.advance(0.06)
    srv.step()                                       # the sweep runs first
    assert stale.status().value == "shed"
    assert isinstance(stale.request.error, ShedError)
    assert "age cap" in str(stale.request.error)
    srv.run_until_idle()
    assert runner.status().value == "completed"


def test_predictive_deadline_shed():
    """With EWMA service data, a queued request whose deadline cannot cover
    its predicted service time is shed at once, typed."""
    srv = _server(num_slots=1, capacity=128,
                  engine_cfg=EngineConfig(decode_chunk=2),
                  overload=OverloadPolicy(shed_on_deadline=True))
    srv.engine._svc_decode_tok_s = 10.0              # 8 tokens -> eta 80 s
    runner = srv.submit("long running job " * 3, _sp(max_new=32))
    while runner.status().value != "running":
        srv.step()
    doomed = srv.submit("tight deadline", _sp(deadline_s=5.0))
    srv.step()
    assert doomed.status().value == "shed"
    assert "predicted service time" in str(doomed.request.error)
    srv.run_until_idle()
    assert runner.status().value == "completed"


# ---------------------------------------------------------------------------
# circuit breaker over dispatch dead-letters
# ---------------------------------------------------------------------------

def test_breaker_opens_after_consecutive_dead_letters_and_cools(clock):
    srv = _server(num_slots=1, capacity=64,
                  overload=OverloadPolicy(breaker_threshold=3,
                                          breaker_cooldown_s=0.1))
    eng = srv.engine
    for _ in range(2):
        eng._breaker_note(False)
    eng._breaker_note(True)                          # success resets streak
    for _ in range(3):
        eng._breaker_note(False)                     # threshold -> open
    assert srv.stats()["breaker_trips"] == 1
    assert srv.stats()["breaker_open"] is True
    with pytest.raises(OverloadError, match="breaker"):
        srv.submit("refused", _sp())
    clock.advance(0.05)
    with pytest.raises(OverloadError, match="breaker"):
        srv.submit("still refused", _sp())
    clock.advance(0.06)                              # the cooldown is over
    h = srv.submit("admitted again", _sp())
    srv.run_until_idle()
    assert h.status().value == "completed"


def test_breaker_integration_with_injected_dead_letters():
    """Real dead-letters (a FaultInjector, no retry headroom) open the
    breaker; submits during the cooldown are refused typed."""
    inj = FaultInjector(seed=0)
    srv = _server(num_slots=1, capacity=64, injector=inj,
                  retry=RetryPolicy(max_attempts=1),
                  overload=OverloadPolicy(breaker_threshold=2,
                                          breaker_cooldown_s=3600.0))
    inj.fail_next("decode", 2)
    h1 = srv.submit("first doomed", _sp())
    srv.run_until_idle()
    h2 = srv.submit("second doomed", _sp())
    srv.run_until_idle()
    assert h1.status().value == "failed" and h2.status().value == "failed"
    assert srv.stats()["breaker_trips"] == 1
    with pytest.raises(OverloadError, match="breaker"):
        srv.submit("refused while open", _sp())


# ---------------------------------------------------------------------------
# priority preemption: bit-identical resume across cache modes
# ---------------------------------------------------------------------------

MODES = [("qwen2.5-3b", "dense"), ("qwen2.5-3b", "paged"),
         ("recurrentgemma-9b", "paged")]
LOW = "a long low priority ramble "


def _preempted(arch, ecfg, sp):
    """``LOW`` preempted by a priority-5 arrival after one decode chunk,
    then resumed; returns its handle and the server."""
    srv = _server(arch, num_slots=1, capacity=128, seed=7, engine_cfg=ecfg,
                  overload=OverloadPolicy(preempt=True))
    lo = srv.submit(LOW, sp)
    while lo.status().value != "running":
        srv.step()
    srv.step()
    hi = srv.submit("urgent", _sp(priority=5, temperature=0.7))
    srv.run_until_idle()
    assert hi.status().value == "completed"
    assert lo.status().value == "completed"
    assert lo.request.preempted >= 1
    return lo, srv


@pytest.mark.parametrize("arch,mode", MODES)
def test_preempt_resume_bit_identical(arch, mode):
    """A running low-priority decode preempted at the chunk boundary and
    resumed emits exactly the uninterrupted output: sampled (the RNG chain
    continues at the resumed token's index) against the port's own
    uninterrupted server, greedy against it and the JAX package's."""
    ecfg = dict(cache_mode=mode, page_size=8, decode_chunk=2,
                prefill_buckets=(32, 64))
    sampled, greedy = _sp(max_new=24, temperature=0.7), _sp(max_new=24)
    ref = {}
    for name, sp in (("sampled", sampled), ("greedy", greedy)):
        srv = _server(arch, num_slots=1, capacity=128, seed=7,
                      engine_cfg=EngineConfig(**ecfg))
        h = srv.submit(LOW, sp)
        srv.run_until_idle()
        ref[name] = h.request.output_ids
    jcfg, jp, _, _ = weights(arch)
    jsrv = JServer(jcfg, num_slots=1, capacity=128, seed=7, params=jp,
                   engine_cfg=JEngineConfig(**ecfg))
    jh = jsrv.submit(LOW, JSamplingParams(max_new_tokens=24))
    jsrv.run_until_idle()
    assert len(jh.request.output_ids) == 24                 # EOS guard
    assert ref["greedy"] == list(jh.request.output_ids)
    assert len(ref["sampled"]) == 24

    for name, sp in (("sampled", sampled), ("greedy", greedy)):
        lo, srv = _preempted(arch, EngineConfig(**ecfg), sp)
        assert lo.request.output_ids == ref[name], (arch, mode, name)
        st = srv.stats()
        assert st["preemptions"] >= 1 and st["preempt_resumes"] >= 1
        assert st["queued_requests"] == 0 and st["live_requests"] == 0
        eng = srv.engine
        if eng.paged:
            owned = eng.radix.check_invariants()
            free = set(eng.kvpool._free)
            assert not (owned & free)
            assert (len(owned) + len(free)
                    == eng.kvpool.num_pages - eng.kvpool.reserved)
        if eng.snapshots:
            owned = eng.radix.check_invariants(snapshots=True)
            free = set(eng.snaps._free)
            assert not (owned & free)
            assert len(owned) + len(free) == eng.snaps.num_snaps


def test_preempt_only_strictly_higher_priority():
    """Equal priority never preempts: FIFO within a class stays FIFO."""
    srv = _server(num_slots=1, capacity=128,
                  engine_cfg=EngineConfig(decode_chunk=2),
                  overload=OverloadPolicy(preempt=True))
    first = srv.submit("first in class " * 2, _sp(max_new=16, priority=1))
    while first.status().value != "running":
        srv.step()
    second = srv.submit("second in class", _sp(priority=1))
    srv.run_until_idle()
    assert first.request.preempted == 0
    assert srv.stats()["preemptions"] == 0
    assert first.status().value == second.status().value == "completed"
    assert first.request.admit_index < second.request.admit_index


def test_preempted_stream_stays_monotonic():
    """A handle streaming across a preempt / resume sees its text grow
    monotonically: the increments concatenate to the final output."""
    srv = _server(num_slots=1, capacity=128,
                  engine_cfg=EngineConfig(decode_chunk=2),
                  overload=OverloadPolicy(preempt=True))
    lo = srv.submit("streaming ramble " * 2, _sp(max_new=24))
    while lo.status().value != "running":
        srv.step()
    srv.step()
    hi = srv.submit("urgent", _sp(priority=5))
    seen = ""
    for chunk in lo.stream():
        seen += chunk
    assert lo.request.preempted >= 1
    assert seen == lo.request.output_text
    assert len(lo.request.output_ids) == 24
    assert hi.status().value == "completed"


# ---------------------------------------------------------------------------
# threaded submit / cancel / preempt interleavings against a pumping server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def load_server():
    """Tiny pool (eviction), spec (rejections), chunks of 2 (many preempt
    windows) and a tight queue (displacement), behind the pump."""
    srv = _server(num_slots=2, capacity=64,
                  engine_cfg=EngineConfig(cache_mode="paged", page_size=8,
                                          num_pages=18, spec_len=4,
                                          decode_chunk=2),
                  overload=OverloadPolicy(max_queue_depth=4, preempt=True),
                  pump=True)
    yield srv
    srv.close()


POOL = ["err 429 err 429 err 429. " + t for t in
        ("", "tail one", "go go go go go", "a longer tail that repeats")]


def _run_threaded_ops(srv, ops):
    """Low / high / submit-then-cancel / pause ops from three racing client
    threads: after the drain every handle is terminal and every page is
    owned exactly once (free list or radix tree)."""
    handles, lock = [], threading.Lock()

    def client(shard):
        for kind, variant, budget in shard:
            try:
                if kind == 0:
                    h = srv.submit(POOL[variant], _sp(max_new=budget))
                elif kind == 1:
                    h = srv.submit(POOL[variant], _sp(max_new=budget, priority=2))
                elif kind == 2:
                    h = srv.submit(POOL[variant], _sp(max_new=budget))
                    srv.cancel(h)
                else:
                    continue
            except OverloadError:
                continue                           # typed refusal is fine
            with lock:
                handles.append(h)

    shards = [[op[1:] for op in ops if op[0] == t] for t in range(3)]
    threads = [threading.Thread(target=client, args=(s,)) for s in shards]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert not any(t.is_alive() for t in threads)
    srv.run_until_idle()
    terminal = {"completed", "cancelled", "timed_out", "failed", "shed"}
    assert all(h.request.finished and h.request.status in terminal
               for h in handles)
    eng = srv.engine
    assert not eng._queue and all(s.request is None for s in eng.slots)
    owned = eng.radix.check_invariants()
    free = set(eng.kvpool._free)
    assert not (owned & free)
    assert len(owned) + len(free) == eng.kvpool.num_pages - eng.kvpool.reserved


@given(st.lists(st.tuples(st.integers(0, 2),      # client thread
                          st.integers(0, 3),      # op kind
                          st.integers(0, 3),      # prompt variant
                          st.integers(2, 12)),    # token budget
                min_size=4, max_size=12))
@settings(max_examples=15, deadline=None, derandomize=True)
def test_threaded_interleavings_exactly_once_ownership(load_server, ops):
    _run_threaded_ops(load_server, ops)


def test_threaded_interleavings_fixed_script(load_server):
    """A fixed script mixing every op kind across the three threads."""
    _run_threaded_ops(load_server, [(t, k, (t + k) % 4, 3 + 2 * k)
                                    for t in range(3) for k in range(4)])


def test_threaded_snapshot_ownership():
    """The snapshot-arena twin on recurrentgemma: racing submits and
    cancels with preemption on never leak or double-free a snapshot."""
    with _server("recurrentgemma-9b", num_slots=2, capacity=64,
                 engine_cfg=EngineConfig(cache_mode="paged", decode_chunk=2),
                 overload=OverloadPolicy(max_queue_depth=4, preempt=True),
                 pump=True) as srv:
        def client(i):
            for j in range(3):
                try:
                    h = srv.submit(f"stateful {i} turn {j} " * 2,
                                   _sp(max_new=6, priority=j % 2))
                except OverloadError:
                    continue
                if (i + j) % 3 == 0:
                    srv.cancel(h)
        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
        srv.run_until_idle()
        eng = srv.engine
        assert not eng._queue and all(s.request is None for s in eng.slots)
        owned = eng.radix.check_invariants(snapshots=True)
        free = set(eng.snaps._free)
        assert not (owned & free)
        assert len(owned) + len(free) == eng.snaps.num_snaps
