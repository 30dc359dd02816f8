"""The kernels' launch counters under concurrent threads
(repro_torch.kernels.launch_counts), on the CPU.

Several servers on one card each run their own pump thread, and one pump
may capture a CUDA graph while another launches kernels eagerly. The
counters must then lose no increment, and a capture must record only its
own thread's launches: another thread's launches during the capture count
once, when they happen, and never again at the graph's replays. The
wrappers' calls of ``count`` are driven directly here (on the CPU a
wrapper runs its plain version and counts nothing), around a stub graph.

The rule the card's serving phases hold the counters to
(``launch_counts.expected``): one launch a layer and step on one device,
and on a mesh one a layer, step and shard that runs the layer's kernel.
Its CPU test counts the calls of the decode wrappers (their plain versions
here) on a (2, 4) mesh server.
"""
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels import paged_decode_attention as kpda  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _diff(before):
    after = launch_counts.snapshot()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.fixture
def fast_switching():
    """Thread switches every microsecond, so lost updates would show."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    yield
    sys.setswitchinterval(old)


def test_capture_records_only_its_own_thread(fast_switching):
    """Twelve threads (more than the cores) bump flash's counters while a
    thirteenth counts paged decode and flash launches inside ``captured``:
    the record holds exactly the capturing thread's launches, the counters
    hold exactly the others', and each replay adds the record once."""
    n, bumpers = 3000, 12
    before = launch_counts.snapshot()
    record = {}
    go = threading.Barrier(bumpers + 1)

    def bump():
        go.wait()
        for _ in range(n):
            launch_counts.count(kfa.__name__, "wgmma")

    def capture():
        go.wait()
        with launch_counts.captured(record):
            for _ in range(n):
                launch_counts.count(kpda.__name__)
                launch_counts.count(kfa.__name__, "simt_f32")

    threads = [threading.Thread(target=bump) for _ in range(bumpers)]
    threads.append(threading.Thread(target=capture))
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert not any(t.is_alive() for t in threads)
    assert record == {("paged_decode_attention", ""): n,
                      ("flash_attention", ""): n,
                      ("flash_attention", "simt_f32"): n}
    eager = {("flash_attention", ""): bumpers * n,
             ("flash_attention", "wgmma"): bumpers * n}
    assert _diff(before) == eager

    graph = _StubGraph()
    replayed = launch_counts.Replayed(graph, record)
    replayed.replay()
    replayed.replay()
    assert graph.replays == 2
    assert _diff(before) == {
        ("flash_attention", ""): bumpers * n + 2 * n,
        ("flash_attention", "wgmma"): bumpers * n,
        ("flash_attention", "simt_f32"): 2 * n,
        ("paged_decode_attention", ""): 2 * n}
    launch_counts.add(_diff(before), -1)
    assert _diff(before) == {}


def test_replays_racing_a_capture_stay_out_of_its_record(fast_switching):
    """One thread replays a graph (its launches added under the lock) while
    another captures: the capture's record holds none of the replays'
    launches, and no replay's launches are lost."""
    before = launch_counts.snapshot()
    other = launch_counts.Replayed(_StubGraph(), {("paged_decode_attention", ""): 3})
    record = {}
    go = threading.Barrier(2)

    def replays():
        go.wait()
        for _ in range(2000):
            other.replay()

    def capture():
        go.wait()
        with launch_counts.captured(record):
            for _ in range(2000):
                launch_counts.count(kfa.__name__, "wgmma")

    ts = [threading.Thread(target=replays), threading.Thread(target=capture)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60.0)
    assert not any(t.is_alive() for t in ts)
    assert record == {("flash_attention", ""): 2000,
                      ("flash_attention", "wgmma"): 2000}
    assert _diff(before) == {("paged_decode_attention", ""): 6000}
    launch_counts.add(_diff(before), -1)


def test_captured_nests_and_restores():
    """A record closes with its block (also on an exception), and an inner
    capture does not leak into the outer one."""
    before = launch_counts.snapshot()
    outer, inner = {}, {}
    with launch_counts.captured(outer):
        launch_counts.count(kfa.__name__, "wgmma")
        with pytest.raises(ValueError):
            with launch_counts.captured(inner):
                launch_counts.count(kpda.__name__)
                raise ValueError("capture failed")
        launch_counts.count(kpda.__name__)
    launch_counts.count(kpda.__name__)
    assert outer == {("flash_attention", ""): 1, ("flash_attention", "wgmma"): 1,
                     ("paged_decode_attention", ""): 1}
    assert inner == {("paged_decode_attention", ""): 1}
    assert _diff(before) == {("paged_decode_attention", ""): 1}
    launch_counts.add(_diff(before), -1)


def test_reset_and_cpu_wrappers_count_nothing():
    """``reset`` zeroes every counter; a wrapper given CPU tensors runs its
    plain version and counts no launch."""
    saved = launch_counts.snapshot()
    launch_counts.count(kfa.__name__, "wgmma")
    launch_counts.reset()
    assert set(launch_counts.snapshot().values()) == {0}
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 2, 16, generator=g) for _ in range(3))
    kfa.flash_attention(q, k, v, q_per_kv=1)
    assert set(launch_counts.snapshot().values()) == {0}
    launch_counts.add(saved)
    assert launch_counts.snapshot() == saved


@pytest.mark.parametrize("mesh_shape,mode,kv,per_layer", [
    (None, "dense", 4, 1),
    ((2, 4), "dense", 4, 8),           # 2 "data" shards x 4 KV-head shards
    ((2, 4), "paged", 4, 8),
    ((2, 4), "paged", 2, 2),           # 2 KV heads on 4: attention stays whole
    ((1, 2), "paged", 2, 2),
])
def test_mesh_rule_counts_each_launching_shard(monkeypatch, mesh_shape, mode, kv,
                                               per_layer):
    """Decode-wrapper calls over a server's decode steps equal
    ``expected(steps, [launch_shards(layer) ...])``, which is ``layers x
    steps x`` the shards that launch."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.server import EngineConfig, LLMServer, SamplingParams

    calls = []
    for name in ("decode_attention", "paged_decode_attention"):
        fn = getattr(tfm, name)
        monkeypatch.setattr(tfm, name, lambda *a, _f=fn, **k: calls.append(1) or _f(*a, **k))
    cfg = ARCHS["qwen2.5-3b"].reduced(dtype="float32", param_dtype="float32",
                                      vocab_size=512, num_kv_heads=kv)
    mesh = make_test_mesh(mesh_shape, devices="cpu") if mesh_shape else None
    srv = LLMServer(cfg, num_slots=2, capacity=64, device="cpu",
                    engine_cfg=EngineConfig(cache_mode=mode, page_size=8,
                                            decode_chunk=4, mesh=mesh))
    try:
        for p in ("first prompt", "second one"):
            srv.submit(p, SamplingParams(max_new_tokens=6))
        srv.run_until_idle()
        progs = srv.engine.progs
        shards = [progs.launch_shards(srv.params, layer) for layer in range(cfg.num_layers)]
        assert shards == [per_layer] * cfg.num_layers
        assert progs.decode_steps > 0
        assert len(calls) == launch_counts.expected(progs.decode_steps, shards)
        assert launch_counts.expected(3, [1, 1]) == 2 * 3
    finally:
        srv.close()
