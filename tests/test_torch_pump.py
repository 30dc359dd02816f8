"""The port's background pump (repro_torch.serving.pump) in the scenarios
of tests/test_pump.py, on the CPU.

* seeded outputs through a pumping server equal the cooperative ``step()``
  loop's in dense, paged and snapshot modes (temperature > 0, so the
  per-request RNG chains run), and the pump's greedy ids equal the JAX
  package's server on the same weights;
* lifecycle: close cancels, close(drain=True) finishes, close is idempotent
  and race-safe, a waiter blocked across close() gets its partial output,
  step() is refused while the pump owns the loop;
* many submitting threads get the single-threaded outputs;
* a crash on the pump thread surfaces typed, and a wedged pump trips the
  stall watchdog.

EOS guard (ROADMAP.md queue 3): the EOS logit is pinned at 0 (qwen ties
its embeddings: the EOS row is zeroed; recurrentgemma is untied: the EOS
column of ``unembed``), and every parity test asserts that the reference
emitted its whole budget.
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
from repro_torch.serving.server import (EngineConfig, LLMServer,  # noqa: E402
                                        PumpConfig, PumpStalledError,
                                        SamplingParams, StepOutcome)

KW = dict(dtype="float32", param_dtype="float32", vocab_size=512)
MODES = [("qwen2.5-3b", "dense"), ("qwen2.5-3b", "paged"),
         ("recurrentgemma-9b", "paged")]          # paged resolves: pages/snaps
PROMPTS = ["alpha prompt for slot one",
           "a rather longer second prompt that crosses a bucket",
           "third prompt"]


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


@pytest.mark.parametrize("arch,mode", MODES)
def test_pump_bit_identical_to_cooperative(arch, mode):
    """Same weights, same seed, same submits: the pump thread produces
    exactly the cooperative loop's outputs (temperature > 0)."""
    ecfg = EngineConfig(cache_mode=mode, page_size=16)
    sp = SamplingParams(max_new_tokens=8, temperature=0.7)
    coop = _server(arch, num_slots=3, capacity=128, seed=3,
                   engine_cfg=ecfg)
    hs = [coop.submit(p, sp) for p in PROMPTS]
    coop.run_until_idle()
    ref = [h.request.output_ids for h in hs]
    assert all(len(r) == 8 for r in ref)                  # EOS guard
    coop.close()

    with _server(arch, num_slots=3, capacity=128, seed=3,
                 engine_cfg=ecfg, pump=True) as srv:
        assert srv.pumping
        hs2 = [srv.submit(p, sp) for p in PROMPTS]
        for h in hs2:
            h.result()
        assert [h.request.output_ids for h in hs2] == ref, (arch, mode)
        st = srv.stats()
        assert st["pump_alive"] and st["pump_steps"] > 0
        assert st["pump_stall_notices"] == 0


@pytest.mark.parametrize("arch,mode", MODES)
def test_pump_greedy_equals_jax(arch, mode):
    """The pumping port server's greedy ids equal the JAX package's
    cooperative server's on the same weights."""
    jcfg, jp, _, _ = weights(arch)
    sp = dict(max_new_tokens=8)
    ecfg = dict(cache_mode=mode, page_size=16, prefill_buckets=(32, 64))
    jsrv = JServer(jcfg, num_slots=3, capacity=128, params=jp,
                   engine_cfg=JEngineConfig(**ecfg))
    jh = [jsrv.submit(p, JSamplingParams(**sp)) for p in PROMPTS]
    jsrv.run_until_idle()
    want = [list(h.request.output_ids) for h in jh]
    assert all(len(w) == 8 for w in want)                 # EOS guard
    with _server(arch, num_slots=3, capacity=128, pump=True,
                 engine_cfg=EngineConfig(**ecfg)) as srv:
        hs = [srv.submit(p, SamplingParams(**sp)) for p in PROMPTS]
        for h in hs:
            h.result()
        assert [h.request.output_ids for h in hs] == want, (arch, mode)


def test_pump_owns_the_step_loop():
    """step() from another thread while the pump runs is refused typed;
    run_until_idle() delegates to the pump; after close the server is
    cooperative again."""
    with _server(num_slots=2, capacity=64, pump=True) as srv:
        with pytest.raises(RuntimeError, match="pump owns the step loop"):
            srv.step()
        h = srv.submit("hello", SamplingParams(max_new_tokens=4))
        srv.run_until_idle()
        assert h.status().value == "completed"
    assert not srv.pumping
    assert srv.step() is StepOutcome.IDLE


def test_pump_close_cancels_outstanding():
    """close() without drain leaves nothing stranded: outstanding requests
    reach CANCELLED on the pump thread before it exits."""
    srv = _server(num_slots=1, capacity=128,
                  engine_cfg=EngineConfig(decode_chunk=2), pump=True)
    hs = [srv.submit(f"long job {i} " * 4, SamplingParams(max_new_tokens=64))
          for i in range(3)]
    srv.close()
    assert all(h.request.finished for h in hs)
    assert any(h.status().value == "cancelled" for h in hs)
    eng = srv.engine
    assert not eng._queue and all(s.request is None for s in eng.slots)


def test_pump_close_drain_finishes_work():
    srv = _server(num_slots=2, capacity=64, pump=True)
    hs = [srv.submit(p, SamplingParams(max_new_tokens=4)) for p in PROMPTS]
    srv.close(drain=True)
    assert all(h.status().value == "completed" for h in hs)


def test_pump_close_is_idempotent():
    """Double close, on the pump or through the server, with or without
    drain, is a no-op."""
    srv = _server(num_slots=2, capacity=64, pump=True)
    pump = srv._pump
    h = srv.submit("hello", SamplingParams(max_new_tokens=4))
    srv.close(drain=True)
    assert h.status().value == "completed"
    pump.close()
    pump.close(drain=True)
    srv.close()
    assert not pump.thread.is_alive()


def test_pump_close_while_handle_waits():
    """A handle blocked in result() while another thread closes the server
    unblocks with its partial CANCELLED output: no stall error, no
    deadlock."""
    srv = _server(num_slots=1, capacity=256,
                  engine_cfg=EngineConfig(decode_chunk=2), pump=True)
    h = srv.submit("a long job " * 4, SamplingParams(max_new_tokens=128))
    box = {}

    def waiter():
        try:
            box["text"] = h.result()
        except BaseException as e:       # pragma: no cover - the regression
            box["exc"] = e

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    while h.request.status == "queued":  # let it start decoding
        pass
    srv.close()
    t.join(10.0)
    assert not t.is_alive(), "waiter deadlocked across close()"
    assert "exc" not in box, box.get("exc")
    assert h.status().value == "cancelled"
    assert box["text"] == h.request.output_text


def test_pump_concurrent_close_races_are_safe():
    """Two threads racing close(): both return, nothing raises, all
    outstanding work is terminal."""
    srv = _server(num_slots=1, capacity=128,
                  engine_cfg=EngineConfig(decode_chunk=2), pump=True)
    pump = srv._pump
    hs = [srv.submit(f"job {i} " * 4, SamplingParams(max_new_tokens=64))
          for i in range(2)]
    errs = []

    def closer():
        try:
            pump.close()
        except BaseException as e:       # pragma: no cover - the regression
            errs.append(e)

    ts = [threading.Thread(target=closer) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10.0)
    assert not any(t.is_alive() for t in ts)
    assert not errs, errs
    assert all(h.request.finished for h in hs)
    srv.close()


def test_pump_threadsafe_submit_many_threads():
    """Submits racing from four client threads: every request completes
    with the single-threaded cooperative server's output."""
    sp = SamplingParams(max_new_tokens=6)
    prompts = [f"client {i} asks question {i % 3} " for i in range(12)]
    coop = _server(num_slots=4, capacity=128)
    hs = [coop.submit(p, sp) for p in prompts]
    coop.run_until_idle()
    ref = {p: h.request.output_ids for p, h in zip(prompts, hs)}
    assert all(len(r) == 6 for r in ref.values())         # EOS guard
    coop.close()

    with _server(num_slots=4, capacity=128, pump=True) as srv:
        out = {}
        lock = threading.Lock()

        def client(shard):
            for p in shard:
                h = srv.submit(p, sp)
                h.result()
                with lock:
                    out[p] = h.request.output_ids

        threads = [threading.Thread(target=client, args=(prompts[i::4],))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
        assert out == ref


def test_pump_crash_surfaces_typed():
    """An engine-level crash on the pump thread: the pump dies, waits raise
    PumpStalledError, post-mortem stats() still work inline."""
    srv = _server(num_slots=1, capacity=64, pump=True)

    def crash():
        raise RuntimeError("injected engine crash")
    srv._step_impl = crash
    h = srv.submit("doomed", SamplingParams(max_new_tokens=4))
    with pytest.raises(PumpStalledError):
        h.result()
    assert not srv.pumping
    assert h.status().value == "failed"
    assert srv.stats()["pump_alive"] is False
    srv.close()


def test_pump_stall_watchdog():
    """A wedged pump (no heartbeat) surfaces as a typed stall to waiters,
    counted in stats; un-wedged, it shuts down cleanly."""
    srv = _server(num_slots=1, capacity=64,
                  pump=PumpConfig(stall_timeout_s=0.2, poll_s=0.02))
    release = threading.Event()
    real = srv._step_impl

    def wedged():
        release.wait(5.0)       # hold the pump thread well past the timeout
        return real()

    srv._step_impl = wedged
    h = srv.submit("hello", SamplingParams(max_new_tokens=4))
    with pytest.raises(PumpStalledError, match="stale"):
        h.result()
    assert srv._pump.stall_notices >= 1
    release.set()
    srv._step_impl = real
    pump = srv._pump
    srv.close()
    pump.thread.join(30.0)
    assert not pump.thread.is_alive()
