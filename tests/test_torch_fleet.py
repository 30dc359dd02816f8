"""The port's replica fleet (repro_torch.serving.fleet) in the scenarios of
tests/test_fleet.py, on the CPU, and against the JAX package's fleet.

* placement: sessionless traffic is accounted in the gauges; cold traffic
  spreads by the routed-count tie-break; prompts sharing a first block
  land on the replica whose radix holds it; a saturated replica spills to
  a peer before its own shed path, and a fleet with every replica
  saturated refuses typed;
* sessions: sticky to their replica and equal to an uninterrupted single
  server; a replica crash migrates them by journal replay, and the next
  turn equals the uninterrupted server's; a crash without sessions keeps
  serving;
* elasticity: drain migrates and closes, add_replica takes traffic, and
  draining the last replica that still holds sessions refuses;
* the FAME co-batching driver rides the fleet, and one log-analytics M+C
  session through ``WorkflowServingRuntime`` on a pumping fleet gives the
  ScriptedOracle's statuses;
* the journal object of one server replays into a fresh server instance
  in dense, paged and snapshot mode;
* the fleet's greedy ids and placements equal the JAX ``FleetServer``'s on
  the same weights; the replicas share one parameter object; ``meshes``
  is refused.

The saturation cases run cooperative fleets (``pump=False``): a parked
request holds its replica's slot until the test steps that replica, so
they need no slowed pump and no host timing.

EOS guard (ROADMAP.md queue 3): the EOS logit is pinned at 0, and every
parity test asserts that the reference emitted its whole budget.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serving.fleet import FleetServer as JFleet  # noqa: E402
from repro.serving.server import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.server import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.fame.fusion import CoBatchDriver  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.faults import OverloadError, PumpStalledError  # noqa: E402
from repro_torch.serving.fleet import FleetServer  # noqa: E402
from repro_torch.serving.server import (EngineConfig, LLMServer,  # noqa: E402
                                        OverloadPolicy, SamplingParams)

KW = dict(dtype="float32", param_dtype="float32", vocab_size=512)
T1 = "user: hello there assistant:"
DELTA = " user: and what else? assistant:"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite runs several
    workers side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MADE = {}


def weights(arch="qwen2.5-3b"):
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


def _ecfg(mode="paged", page_size=8, **kw):
    return EngineConfig(cache_mode=mode, page_size=page_size, **kw)


def _fleet(**kw):
    _, _, cfg, sd = weights()
    kw.setdefault("num_replicas", 2)
    kw.setdefault("num_slots", 2)
    kw.setdefault("capacity", 128)
    kw.setdefault("engine_cfg", _ecfg())
    kw.setdefault("seed", 3)
    kw.setdefault("digest_ttl_s", 0.0)      # always-fresh digests
    kw.setdefault("params", sd)
    return FleetServer(cfg, device="cpu", **kw)


def _reference_turns(params, ecfg):
    """An uninterrupted single server's two-turn session on the fleet's own
    parameter object: the oracle of every fleet path (greedy)."""
    _, _, cfg, _ = weights()
    srv = LLMServer(cfg, num_slots=2, capacity=128, engine_cfg=ecfg, seed=3,
                    params=params, device="cpu")
    sp = SamplingParams(max_new_tokens=8)
    sess = srv.open_session()
    h1 = sess.submit(T1, sp)
    h1.result()
    h2 = sess.submit(sess.text + DELTA, sp)
    h2.result()
    srv.close()
    assert len(h1.request.output_ids) == len(h2.request.output_ids) == 8
    return h1.request.output_text, h2.request.output_text


def _replica_of(fleet, handle):
    for r in fleet.replicas:
        if handle._server is r.server:
            return r.idx
    raise AssertionError("handle's server is not a fleet replica")


def _crash_replica(fleet, idx, timeout_s=30.0):
    """Kill one replica's pump: its next loop iteration raises."""
    srv = fleet.replicas[idx].server

    def boom():
        raise RuntimeError(f"injected crash on replica {idx}")

    srv._step_impl = boom
    deadline = time.monotonic() + timeout_s
    while srv.pumping and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not srv.pumping, "replica pump did not die"


# ---- routing ---------------------------------------------------------------
def test_fleet_roundtrip_and_gauges():
    with _fleet() as fleet:
        sp = SamplingParams(max_new_tokens=6)
        hs = [fleet.submit(f"request number {i} topic {i % 3} ", sp)
              for i in range(6)]
        assert all(isinstance(h.result(), str) for h in hs)
        st = fleet.stats()
        assert st["fleet_replicas"] == 2
        assert st["routed_requests"] == 6
        assert st["migrated_sessions"] == 0
        assert st["queued_requests"] == 0 and st["live_requests"] == 0
        assert st["decode_tokens"] == sum(p["decode_tokens"]
                                          for p in st["per_replica"])


def test_replicas_share_one_parameter_object():
    """Replica 0 loads the state dict once; every peer (an added one too)
    holds the same TransformerParams, so the fleet holds one set of weight
    tensors."""
    with _fleet(num_replicas=3) as fleet:
        p0 = fleet.replicas[0].server.params
        assert fleet.params is p0
        assert all(r.server.params is p0 for r in fleet.replicas)
        idx = fleet.add_replica()
        assert fleet.replicas[idx].server.params is p0
        ptrs = {t.data_ptr() for r in fleet.replicas
                for t in r.server.params.parameters()}
        assert len(ptrs) == len(list(p0.parameters()))


def test_least_loaded_tiebreak_spreads_cold_traffic():
    with _fleet() as fleet:
        sp = SamplingParams(max_new_tokens=4)
        for i in range(4):
            fleet.submit(f"{i} unrelated prompt {i} " * 3, sp).result()
        assert [r.routed for r in fleet.replicas] == [2, 2]


def test_prefix_affinity_lands_on_the_warm_replica():
    shared = "incident report for region seven: "
    with _fleet() as fleet:
        sp = SamplingParams(max_new_tokens=4)
        warm = fleet.submit(shared + "first occurrence", sp)
        warm.result()
        warm_idx = _replica_of(fleet, warm)
        fleet.run_until_idle()
        hs = [fleet.submit(shared + f"follow-up {i}", sp) for i in range(3)]
        for h in hs:
            h.result()
        assert all(_replica_of(fleet, h) == warm_idx for h in hs)
        st = fleet.stats()
        assert st["affinity_hits"] >= 3
        assert st["per_replica"][warm_idx]["prefix_hit_tokens"] > 0


def _park(server, prompt):
    """Hold ``server``'s only slot with a long decode and fill its queue of
    one behind it (a cooperative replica runs only when stepped)."""
    long_sp = SamplingParams(max_new_tokens=96)
    park = server.submit(prompt + "park", long_sp)
    server.step()                          # admits it and decodes a chunk
    assert park.request.status == "running"
    queued = server.submit(prompt + "queued", long_sp)
    assert len(server.engine._queue) == 1
    return [park, queued]


def test_saturated_replica_spills_to_peer_before_shedding():
    """Affinity prefers the warm replica, but with its admission queue at
    the bound and a peer with headroom the placement spills."""
    shared = "the hot shared prefix everybody re-sends: "
    with _fleet(num_slots=1, pump=False,
                overload=OverloadPolicy(max_queue_depth=1),
                engine_cfg=_ecfg(decode_chunk=2)) as fleet:
        sp = SamplingParams(max_new_tokens=4)
        warm = fleet.submit(shared + "warm", sp)
        warm.result()
        warm_idx = _replica_of(fleet, warm)
        fleet.run_until_idle()
        parked = _park(fleet.replicas[warm_idx].server, shared)
        h = fleet.submit(shared + "spilled arrival", sp)
        assert _replica_of(fleet, h) != warm_idx
        assert h.result() is not None
        assert fleet.stats()["spilled_admissions"] >= 1
        assert parked[0].request.status == "running"
        for p in parked:
            p.cancel()
        fleet.run_until_idle()


def test_all_replicas_saturated_raises_typed_overload():
    with _fleet(num_slots=1, pump=False,
                overload=OverloadPolicy(max_queue_depth=1),
                engine_cfg=_ecfg(decode_chunk=2)) as fleet:
        parked = [p for r in fleet.replicas for p in _park(r.server, "fill " * 4)]
        with pytest.raises(OverloadError):
            fleet.submit("one too many", SamplingParams(max_new_tokens=4))
        for p in parked:
            p.cancel()
        fleet.run_until_idle()
        assert all(p.request.finished for p in parked)


# ---- sessions --------------------------------------------------------------
def test_sessions_sticky_and_bit_identical():
    with _fleet() as fleet:
        ref1, ref2 = _reference_turns(fleet.params, _ecfg())
        sp = SamplingParams(max_new_tokens=8)
        fs = fleet.open_session()
        assert fs.replica_index is None            # pinned lazily
        assert fleet.submit(T1, sp, session=fs.sid).result() == ref1
        pin = fs.replica_index
        assert pin is not None
        assert fs.submit(fs.text + DELTA, sp).result() == ref2
        assert fs.replica_index == pin
        assert fleet.stats()["per_replica"][pin]["turn_prefix_hits"] >= 1
        fs.close()
        assert fleet.stats()["fleet_sessions"] == 0


def test_crash_migrates_sessions_bit_identically():
    """Kill the pinned replica's pump: the next turn of each session
    migrates by journal replay and equals the uninterrupted server's."""
    with _fleet() as fleet:
        ref1, ref2 = _reference_turns(fleet.params, _ecfg())
        sp = SamplingParams(max_new_tokens=8)
        sessions = [fleet.open_session() for _ in range(3)]
        for s in sessions:
            assert s.submit(T1, sp).result() == ref1
        victim = sessions[0].replica_index     # same prompt => all co-pinned
        assert all(s.replica_index == victim for s in sessions)
        _crash_replica(fleet, victim)
        outs = [s.submit(s.text + DELTA, sp).result() for s in sessions]
        assert outs == [ref2] * 3
        st = fleet.stats()
        assert st["replicas_failed"] == 1
        assert st["migrated_sessions"] == 3
        assert st["fleet_replicas"] == 1
        assert all(s.replica_index != victim for s in sessions)


def test_crash_with_no_sessions_keeps_serving():
    with _fleet() as fleet:
        sp = SamplingParams(max_new_tokens=4)
        fleet.submit("before the crash", sp).result()
        _crash_replica(fleet, 0)
        h = fleet.submit("after the crash", sp)
        assert _replica_of(fleet, h) == 1
        h.result()
        assert fleet.stats()["fleet_replicas"] == 1


# ---- elasticity ------------------------------------------------------------
def test_drain_migrates_and_add_replica_takes_traffic():
    with _fleet() as fleet:
        ref1, ref2 = _reference_turns(fleet.params, _ecfg())
        sp = SamplingParams(max_new_tokens=8)
        fs = fleet.open_session()
        assert fs.submit(T1, sp).result() == ref1
        pin = fs.replica_index
        fleet.drain(pin)
        st = fleet.stats()
        assert st["replicas_drained"] == 1 and st["fleet_replicas"] == 1
        assert fleet.replicas[pin].removed
        assert fs.replica_index != pin
        assert fs.submit(fs.text + DELTA, sp).result() == ref2
        idx = fleet.add_replica()
        assert idx == 2 and fleet.stats()["fleet_replicas"] == 2
        h = fleet.submit("fresh arrival for the new replica", sp)
        assert _replica_of(fleet, h) == idx
        h.result()


def test_drain_last_replica_with_sessions_refuses():
    with _fleet() as fleet:
        fs = fleet.open_session()
        fs.submit(T1, SamplingParams(max_new_tokens=4)).result()
        fleet.drain(1 - fs.replica_index)
        with pytest.raises(PumpStalledError):
            fleet.drain(fs.replica_index)


def test_meshes_refused():
    """``meshes=`` and ``add_replica(mesh=)`` are no longer refused: each
    replica serves on its own sub-mesh from the fleet's one set of weights
    (tests/test_torch_mesh_serving.py checks their ids); a ``meshes`` list
    of the wrong length still raises."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.mesh import make_test_mesh
    _, _, cfg, sd = weights()
    with pytest.raises(ValueError, match="entries"):
        FleetServer(cfg, num_replicas=2, params=sd, device="cpu",
                    meshes=[make_test_mesh((1, 2), devices="cpu")])
    meshes = [make_test_mesh((1, 2), devices="cpu"), make_test_mesh((2, 1), devices="cpu")]
    with _fleet(num_replicas=2, pump=False, meshes=meshes) as fleet:
        idx = fleet.add_replica(mesh=make_test_mesh((2, 2), devices="cpu"))
        shapes = [r.server.stats()["mesh_shape"] for r in fleet.replicas]
        assert shapes == [{"data": 1, "model": 2}, {"data": 2, "model": 1},
                          {"data": 2, "model": 2}] and idx == 2
        assert all(shd.source_params(r.server.params) is shd.source_params(fleet.params)
                   for r in fleet.replicas)
        fs = fleet.open_session()
        assert fs.submit(T1, SamplingParams(max_new_tokens=4)).result() is not None


# ---- fame drivers ----------------------------------------------------------
def test_cobatch_driver_rides_the_fleet():
    """CoBatchDriver over a FleetServer (pumping=True): concurrent chains
    complete with the single server's output."""
    with _fleet() as fleet:
        ref1, _ = _reference_turns(fleet.params, _ecfg())
        sp = SamplingParams(max_new_tokens=8)
        driver = CoBatchDriver(fleet)
        sessions = [fleet.open_session() for _ in range(4)]

        def turn(s):
            return driver.call(lambda: fleet.submit(T1, sp, session=s.sid)).request

        reqs = driver.run([lambda s=s: turn(s) for s in sessions])
        assert all(r.status == "completed" for r in reqs)
        assert all(s.text.endswith(ref1) for s in sessions)


# ---- cross-instance journal portability ------------------------------------
@pytest.mark.parametrize("arch,mode", [("qwen2.5-3b", "dense"),
                                       ("qwen2.5-3b", "paged"),
                                       ("recurrentgemma-9b", "paged")])
def test_journal_restores_into_fresh_server_instance(arch, mode):
    """Server A's journal object, replayed into a new server B (the fleet's
    migration path), continues the conversation as A does."""
    _, _, cfg, sd = weights(arch)
    ecfg = EngineConfig(cache_mode=mode, page_size=8)
    sp = SamplingParams(max_new_tokens=8)
    a = LLMServer(cfg, num_slots=2, capacity=128, engine_cfg=ecfg, seed=3,
                  params=sd, device="cpu")
    sess = a.open_session()
    sess.submit(T1, sp).result()
    b = LLMServer(cfg, num_slots=2, capacity=128, engine_cfg=ecfg, seed=3,
                  params=a.params, device="cpu")
    bs = b.restore_sessions(a.journal)[sess.sid]
    assert bs.text == sess.text and bs.turns == sess.turns
    t2 = sess.text + DELTA
    ha = sess.submit(t2, sp)
    ha.result()
    assert len(ha.request.output_ids) == 8                   # EOS guard
    hb = bs.submit(t2, sp)
    hb.result()
    assert hb.request.output_ids == ha.request.output_ids, (arch, mode)
    a.close()
    b.close()


# ---- against the JAX package's fleet --------------------------------------
def test_fleet_greedy_equals_jax_fleet():
    """Cooperative fleets of both packages on the same weights, the same
    submits in the same order: every request lands on the same replica and
    emits the same greedy ids, a two-turn fleet session included."""
    jcfg, jp, _, _ = weights()
    ecfg = dict(cache_mode="paged", page_size=8, prefill_buckets=(32, 64))
    kw = dict(num_replicas=2, num_slots=2, capacity=128, seed=3, pump=False,
              digest_ttl_s=0.0)
    jfleet = JFleet(jcfg, params=jp, engine_cfg=JEngineConfig(**ecfg), **kw)
    fleet = _fleet(engine_cfg=EngineConfig(**ecfg), **kw)
    heads = ["alpha family system prompt, shared: ",
             "beta family system prompt, shared: "]
    waves = [[heads[0] + "first", heads[1] + "first"],
             [heads[0] + "second ask", heads[1] + "second ask",
              heads[0] + "third", heads[1] + "third ask here"]]
    out = {}
    for name, f, sp in (("jax", jfleet, JSamplingParams(max_new_tokens=8)),
                        ("port", fleet, SamplingParams(max_new_tokens=8))):
        got = []
        for wave in waves:
            hs = [f.submit(p, sp) for p in wave]   # placed before any step
            f.run_until_idle()
            got += [(_replica_of(f, h), list(h.request.output_ids)) for h in hs]
        fs = f.open_session()
        h1 = fs.submit(T1, sp)
        f.run_until_idle()
        h2 = fs.submit(fs.text + DELTA, sp)
        f.run_until_idle()
        got += [(fs.replica_index, list(h.request.output_ids)) for h in (h1, h2)]
        st = f.stats()
        out[name] = (got, st["affinity_hits"], st["routed_requests"])
        f.close()
    assert all(len(ids) == 8 for _, ids in out["jax"][0])    # EOS guard
    assert {r for r, _ in out["jax"][0]} == {0, 1}
    assert out["jax"][1] > 0
    assert out["port"] == out["jax"]


def test_fame_session_on_the_fleet():
    """One log-analytics M+C session through the port's
    WorkflowServingRuntime on a pumping two-replica fleet: the statuses
    equal the ScriptedOracle backend's, every turn is terminal, and the
    persistent chain's continuation turns reuse their replica's tail."""
    from repro_torch.apps import log_analytics as la
    from repro_torch.core.config import CONFIGS
    from repro_torch.core.runtime import FameRuntime
    from repro_torch.fame import ServingMeter, WorkflowServingRuntime

    query = la.APP.inputs[0]
    oracle_rt = FameRuntime(config=CONFIGS["M+C"])
    for role, oracle in la.build_oracles().items():
        oracle_rt.set_llm(role, oracle)
    oracle_rt.deploy_mcp(la.APP.servers, la.APP.sources)
    want = oracle_rt.run_session(f"fame-{query}", la.APP.queries(query)).statuses
    with _fleet(num_slots=4, capacity=2048,
                engine_cfg=_ecfg(page_size=16, decode_chunk=8)) as fleet:
        meter = ServingMeter(fleet)
        rt = WorkflowServingRuntime(config=CONFIGS["M+C"], server=fleet,
                                    meter=meter,
                                    params=SamplingParams(max_new_tokens=8))
        for role, oracle in la.build_oracles().items():
            rt.set_llm(role, oracle)
        rt.deploy_mcp(la.APP.servers, la.APP.sources)
        res = rt.run_session(f"fame-{query}", la.APP.queries(query))
        assert res.statuses == want
        assert meter.all_terminal()
        assert meter.continuation_turns() and meter.tail_reuse_ok()
        assert fleet.stats()["routed_requests"] > 0
