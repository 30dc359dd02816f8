"""Mesh-sharded serving of the port (``EngineConfig(mesh=...)``), on a
logical (2, 4) CPU mesh: eight positions of one device, as the reference's
lane runs eight host devices of one CPU (tests/test_mesh_serving.py).

* the reference's matrix: qwen2.5-3b (with 4 KV heads, so that they really
  cut over the 4-way "model" axis), recurrentgemma-9b and mixtral-8x22b,
  each dense and paged (KV pages, or state snapshots for recurrentgemma)
  with spec_len 0 and 4: the mesh server's greedy ids equal the unsharded
  port server's on the same weights, and one cell per arch equals the JAX
  package's unsharded server;
* ``stats()``'s mesh keys, AUTO pools rounded up to the "data" extent,
  preempt-resume on the mesh equal to the uninterrupted server, session
  tails still hit, exactly-once page and snapshot ownership under racing
  client threads on a pumping mesh server;
* ``FleetServer(meshes=)`` and ``add_replica(mesh=)``.

EOS guard (ROADMAP.md queue 3): the EOS logit is pinned at 0, and the
unsharded reference must emit its whole budget.
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
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.mesh import make_test_mesh  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.faults import OverloadError  # noqa: E402
from repro_torch.serving.fleet import FleetServer  # noqa: E402
from repro_torch.serving.scheduler import OverloadPolicy  # noqa: E402
from repro_torch.serving.server import (EngineConfig, LLMServer,  # noqa: E402
                                        SamplingParams)

from tests._hypothesis_compat import given, settings, st  # noqa: E402

PROMPTS = ["the quick brown fox", "the quick brown dog jumps over",
           "err 429 err 429 err 429 err 4"]
MAX_NEW = 12
_MADE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_test_mesh((2, 4), devices="cpu")


def _over(arch):
    return {"num_kv_heads": 4} if arch == "qwen2.5-3b" else {}


def weights(arch):
    """(JAX config, JAX params, port config, port state dict): the same
    numbers, the EOS logit pinned at 0. recurrentgemma's lean toward
    copying their input (unembed = embed^T, block outputs scaled by 0.3,
    as tests/test_torch_stateful_serving.py makes them), so that the n-gram
    drafter proposes and its spec cells really verify."""
    if arch not in _MADE:
        kw = dict(dtype="float32", param_dtype="float32", vocab_size=512, **_over(arch))
        jcfg, cfg = JARCHS[arch].reduced(**kw), ARCHS[arch].reduced(**kw)
        jp = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(0)))
        if arch == "recurrentgemma-9b":
            jp["unembed"]["table"] = jp["embed"]["table"].T.copy()
            jp = jax.tree_util.tree_map_with_path(
                lambda path, x: x * 0.3 if getattr(path[-1], "key", None) == "wo" else x, jp)
        name = "embed" if cfg.tie_embeddings else "unembed"
        t = jp[name]["table"].copy()
        if cfg.tie_embeddings:
            t[cfg.vocab_size - 1] = 0.0
        else:
            t[:, cfg.vocab_size - 1] = 0.0
        jp[name]["table"] = t
        _MADE[arch] = (jcfg, jax.tree.map(jnp.asarray, jp), cfg,
                       params_from_jax(jp, cfg))
    return _MADE[arch]


def _run(arch, ecfg, *, num_slots=2, capacity=96, sd=None):
    _, _, cfg, sd0 = weights(arch)
    srv = LLMServer(cfg, num_slots=num_slots, capacity=capacity, seed=7,
                    params=sd or sd0, engine_cfg=ecfg, device="cpu")
    hs = [srv.submit(p, SamplingParams(max_new_tokens=MAX_NEW)) for p in PROMPTS]
    srv.run_until_idle()
    outs = [h.request.output_ids for h in hs]
    stats = srv.stats()
    srv.close()
    return outs, stats


# ---------------------------------------------------------------------------
# the matrix: cache mode x speculative decode x arch family
# ---------------------------------------------------------------------------
_CELLS = [(a, m, s)
          for a in ("qwen2.5-3b", "recurrentgemma-9b", "mixtral-8x22b")
          for m in ("dense", "paged")
          for s in (0, 4)]


@pytest.mark.parametrize("arch,mode,spec", _CELLS,
                         ids=[f"{a.split('-')[0]}-{m}-spec{s}" for a, m, s in _CELLS])
def test_bit_identical_across_mesh(mesh, arch, mode, spec):
    kw = dict(cache_mode=mode, page_size=8, spec_len=spec, decode_chunk=2)
    ref, ref_stats = _run(arch, EngineConfig(**kw))
    assert all(len(ids) == MAX_NEW for ids in ref), ref      # the EOS guard
    assert not ref_stats["sharded"] and ref_stats["mesh_devices"] == 1
    got, stats = _run(arch, EngineConfig(mesh=mesh, **kw))
    assert stats["sharded"] and stats["mesh_devices"] == 8
    assert stats["mesh_shape"] == {"data": 2, "model": 4}
    assert not stats["step_graphs"]                  # the CPU runs steps eagerly
    if spec:
        assert stats["verify_steps"] > 0
    assert got == ref, f"{arch}/{mode}/spec={spec}: mesh ids diverged"


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-9b", "mixtral-8x22b"])
def test_mesh_equals_jax_server(mesh, arch):
    """One cell per arch (dense, spec 0) against the JAX package's
    unsharded server on the same weights."""
    jcfg, jp, _, _ = weights(arch)
    jsrv = JServer(jcfg, num_slots=2, capacity=96, seed=7, params=jp,
                   engine_cfg=JEngineConfig(cache_mode="dense", page_size=8))
    hs = [jsrv.submit(p, JSamplingParams(max_new_tokens=MAX_NEW)) for p in PROMPTS]
    jsrv.run_until_idle()
    ref = [h.request.output_ids for h in hs]
    jsrv.close()
    got, _ = _run(arch, EngineConfig(mesh=mesh, cache_mode="dense", page_size=8))
    assert got == ref


def test_mesh_lays_out_params_and_pools(mesh):
    """The serve layout as placed: q / KV heads, mlp-up and vocab over
    "model" (parts contiguous), wo whole; the pool's KV heads cut, its page
    axis whole in storage (each data shard's launch reads every page)."""
    _, _, cfg, sd = weights("qwen2.5-3b")
    srv = LLMServer(cfg, num_slots=2, capacity=64, params=sd, device="cpu",
                    engine_cfg=EngineConfig(mesh=mesh, cache_mode="paged", page_size=8))
    try:
        a = srv.params.blocks[0].attn
        assert isinstance(a.wq, shd.Shards) and len(a.wq) == 4
        assert all(p.is_contiguous() for p in a.wq.parts + a.wk.parts)
        assert not isinstance(a.wo, shd.Shards)
        assert isinstance(srv.params.embed.table, shd.Shards)
        k = srv.engine.cache["scan"]["sub0"]["k"]
        assert isinstance(k, shd.Shards) and k.dim == 3
        assert k.shape[1] == srv.engine.kvpool.num_pages
        assert [p.shape[3] for p in k.parts] == [1, 1, 1, 1]
        assert len(srv.engine.progs.rows) == 2
    finally:
        srv.close()


def test_pool_rows_round_up_to_data_axis(mesh):
    _, _, cfg, sd = weights("qwen2.5-3b")
    srv = LLMServer(cfg, num_slots=3, capacity=40, params=sd, device="cpu",
                    engine_cfg=EngineConfig(cache_mode="paged", page_size=8, mesh=mesh))
    try:
        assert srv.engine.kvpool.num_pages % mesh.shape["data"] == 0
        assert len(srv.engine.progs.rows) == 1      # 3 slots stay whole
    finally:
        srv.close()
    _, _, rcfg, rsd = weights("recurrentgemma-9b")
    srv = LLMServer(rcfg, num_slots=3, capacity=40, params=rsd, device="cpu",
                    engine_cfg=EngineConfig(cache_mode="paged", page_size=8, mesh=mesh))
    try:
        assert srv.engine.snaps.num_snaps % mesh.shape["data"] == 0
    finally:
        srv.close()


def test_mesh_must_lead_on_the_server_device():
    with pytest.raises(ValueError, match="leads on"):
        Mesh2 = make_test_mesh((1, 2), devices=["cpu", "cpu"])
        Mesh2.devices.flat[0] = torch.device("meta")
        _run("qwen2.5-3b", EngineConfig(mesh=Mesh2))


# ---------------------------------------------------------------------------
# preemption resumes bit-identically on the mesh; session tails still hit
# ---------------------------------------------------------------------------

def test_preempt_resume_bit_identical_on_mesh(mesh):
    _, _, cfg, sd = weights("qwen2.5-3b")
    kw = dict(cache_mode="paged", page_size=8, decode_chunk=2)
    ref_srv = LLMServer(cfg, num_slots=1, capacity=128, seed=7, params=sd,
                        device="cpu", engine_cfg=EngineConfig(**kw))
    r = ref_srv.submit("a long low priority ramble ", SamplingParams(max_new_tokens=24))
    ref_srv.run_until_idle()
    ref_out = r.request.output_ids
    ref_srv.close()
    assert len(ref_out) == 24

    srv = LLMServer(cfg, num_slots=1, capacity=128, seed=7, params=sd, device="cpu",
                    engine_cfg=EngineConfig(mesh=mesh, **kw),
                    overload=OverloadPolicy(preempt=True))
    with srv:
        lo = srv.submit("a long low priority ramble ", SamplingParams(max_new_tokens=24))
        while lo.status().value != "running":
            srv.step()
        srv.step()
        hi = srv.submit("urgent", SamplingParams(max_new_tokens=8, priority=5))
        srv.run_until_idle()
        assert hi.status().value == "completed"
        assert lo.request.preempted >= 1, "preemption never triggered"
        assert lo.request.output_ids == ref_out


def test_session_tail_reuse_on_mesh(mesh):
    _, _, cfg, sd = weights("qwen2.5-3b")
    srv = LLMServer(cfg, num_slots=1, capacity=128, seed=7, params=sd, device="cpu",
                    engine_cfg=EngineConfig(cache_mode="paged", page_size=8, mesh=mesh))
    with srv:
        sess = srv.open_session()
        h1 = sess.submit("turn one: hello", SamplingParams(max_new_tokens=8))
        srv.run_until_idle()
        t1 = h1.result()
        h2 = sess.submit("turn one: hello" + t1 + " and more",
                         SamplingParams(max_new_tokens=8))
        srv.run_until_idle()
        assert h2.status().value == "completed"
        assert srv.stats()["turn_prefix_hits"] >= 1


# ---------------------------------------------------------------------------
# exactly-once ownership under racing clients, with sharded pools
# ---------------------------------------------------------------------------

_LOAD_SRV = None


def _load_server():
    """One pumping server on the mesh, shared across examples."""
    global _LOAD_SRV
    if _LOAD_SRV is None:
        _, _, cfg, sd = weights("qwen2.5-3b")
        _LOAD_SRV = LLMServer(
            cfg, num_slots=2, capacity=64, params=sd, device="cpu",
            engine_cfg=EngineConfig(cache_mode="paged", page_size=8, num_pages=18,
                                    spec_len=4, decode_chunk=2,
                                    mesh=make_test_mesh((2, 4), devices="cpu")),
            overload=OverloadPolicy(max_queue_depth=4, preempt=True), pump=True)
    return _LOAD_SRV


@pytest.fixture(scope="module", autouse=True)
def _close_load_server():
    yield
    global _LOAD_SRV
    if _LOAD_SRV is not None:
        _LOAD_SRV.close()
        _LOAD_SRV = None


def _run_threaded_ops(ops):
    """Racing submit / priority / cancel ops drain, then every page is
    owned exactly once (free list xor radix tree): the host-side allocator
    never learns that the pool's heads are cut over "model"."""
    srv = _load_server()
    pool = ["err 429 err 429 err 429. " + t for t in
            ("", "tail one", "go go go go go", "a longer tail that repeats")]
    handles, lock = [], threading.Lock()

    def client(shard):
        for kind, variant, budget in shard:
            try:
                if kind == 0:
                    h = srv.submit(pool[variant], SamplingParams(max_new_tokens=budget))
                elif kind == 1:
                    h = srv.submit(pool[variant],
                                   SamplingParams(max_new_tokens=budget, priority=2))
                else:
                    h = srv.submit(pool[variant], SamplingParams(max_new_tokens=budget))
                    srv.cancel(h)
            except OverloadError:
                continue
            with lock:
                handles.append(h)

    shards = [[op[1:] for op in ops if op[0] == t] for t in range(3)]
    threads = [threading.Thread(target=client, args=(s,)) for s in shards]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    srv.run_until_idle()
    assert all(h.request.finished for h in handles)
    eng = srv.engine
    assert not eng._queue and all(s.request is None for s in eng.slots)
    owned = eng.radix.check_invariants()
    free = set(eng.kvpool._free)
    assert not (owned & free)
    assert len(owned) + len(free) == eng.kvpool.num_pages - eng.kvpool.reserved


@given(st.lists(st.tuples(st.integers(0, 2), st.integers(0, 2),
                          st.integers(0, 3), st.integers(2, 12)),
                min_size=4, max_size=10))
@settings(max_examples=10, deadline=None)
def test_threaded_ownership_on_mesh(ops):
    _run_threaded_ops(ops)


def test_threaded_ownership_on_mesh_fixed_script():
    _run_threaded_ops([(t, k, (t + k) % 4, 3 + 2 * k)
                       for t in range(3) for k in range(3)])


def test_threaded_snapshot_ownership_on_mesh(mesh):
    _, _, cfg, sd = weights("recurrentgemma-9b")
    srv = LLMServer(cfg, num_slots=2, capacity=64, params=sd, device="cpu",
                    engine_cfg=EngineConfig(cache_mode="paged", decode_chunk=2, mesh=mesh),
                    overload=OverloadPolicy(max_queue_depth=4, preempt=True), pump=True)
    with srv:
        def client(i):
            for j in range(3):
                try:
                    h = srv.submit(f"stateful {i} turn {j} " * 2,
                                   SamplingParams(max_new_tokens=6, priority=j % 2))
                except OverloadError:
                    continue
                if (i + j) % 3 == 0:
                    srv.cancel(h)
        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        srv.run_until_idle()
        eng = srv.engine
        assert not eng._queue and all(s.request is None for s in eng.slots)
        owned = eng.radix.check_invariants(snapshots=True)
        free = set(eng.snaps._free)
        assert not (owned & free)
        assert len(owned) + len(free) == eng.snaps.num_snaps


# ---------------------------------------------------------------------------
# the fleet: a sub-mesh per replica
# ---------------------------------------------------------------------------

def test_fleet_replicas_on_meshes():
    """``FleetServer(meshes=)``: replica 0 on a (1, 2) mesh, replica 1 on a
    (2, 2) mesh, both from one set of weights; then ``add_replica(mesh=)``
    on a (2, 1) mesh. Every replica's greedy ids equal one unsharded
    server's."""
    _, _, cfg, sd = weights("qwen2.5-3b")
    ecfg = EngineConfig(cache_mode="paged", page_size=8)
    ref, _ = _run("qwen2.5-3b", ecfg)
    meshes = [make_test_mesh((1, 2), devices="cpu"), make_test_mesh((2, 2), devices="cpu")]
    with pytest.raises(ValueError, match="entries"):
        FleetServer(cfg, num_replicas=2, params=sd, device="cpu", meshes=meshes[:1])
    fleet = FleetServer(cfg, num_replicas=2, num_slots=2, capacity=96, seed=7,
                        params=sd, device="cpu", engine_cfg=ecfg, pump=False,
                        meshes=meshes)
    try:
        idx = fleet.add_replica(mesh=make_test_mesh((2, 1), devices="cpu"))
        assert idx == 2
        for r in fleet.replicas:
            srv = r.server
            st_ = srv.stats()
            assert st_["sharded"]
            assert shd.source_params(srv.params) is shd.source_params(fleet.params)
            hs = [srv.submit(p, SamplingParams(max_new_tokens=MAX_NEW)) for p in PROMPTS]
            srv.run_until_idle()
            assert [h.request.output_ids for h in hs] == ref
        assert [r.server.stats()["mesh_shape"] for r in fleet.replicas] == [
            {"data": 1, "model": 2}, {"data": 2, "model": 2}, {"data": 2, "model": 1}]
    finally:
        fleet.close()


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-9b", "mixtral-8x22b"])
def test_mesh_logits_close_to_unsharded(mesh, arch):
    """Teacher-forced logits (two prefills, four decode steps of two rows)
    on the (2, 4) mesh against the unsharded model, float32: within 1e-5.
    They need not be equal on the CPU: the plain decode attention of one
    row and the CPU's vectorised gelu / softplus give other last bits than
    over a longer tensor (the card's kernels compute every row and element
    alike; chip_smoke.py's mesh phase reports the card's difference)."""
    from repro_torch.models import Model
    from repro_torch.serving.programs import slot_extract
    _, _, cfg, sd = weights(arch)
    model = Model(cfg, device="cpu")
    params = model.load(sd)
    rules = shd.rules_for(mesh, "serve")
    placed = shd.place_params(params, rules)
    B, S = 2, 9
    ids = torch.randint(0, 500, (B, S + 4), generator=torch.Generator().manual_seed(0))
    out = []
    for p in (params, placed):
        cache = model.init_cache(B, 32)
        if p is placed:
            cache = shd.shard_put(cache, shd.cache_pspecs(cfg, rules), mesh)
        lg = []
        for b in range(B):
            logits, _ = model.prefill(p, model.make_batch(ids[b:b + 1, :S]),
                                      slot_extract(cache, b))
            lg.append(logits[:, -1])
        clen = torch.full((B,), S, dtype=torch.int32)
        for s in range(4):
            batch = {"tokens": ids[:, S + s:S + s + 1], "positions": clen[:, None].long()}
            with shd.use_rules(rules if p is placed else None):
                logits, _ = model.decode_step(p, batch, cache, clen)
            lg.append(logits[:, 0])
            clen = clen + 1
        out.append(torch.cat([x.reshape(-1) for x in lg]))
    assert float((out[0] - out[1]).abs().max()) <= 1e-5
