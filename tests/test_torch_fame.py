"""The port's FAME runtime (repro_torch.{core,fame,apps}) against the JAX
package's, both on their own LLMServer with the same weights.

One log-analytics M+C session (persistent chain + MCP caching) runs
through the port's ``WorkflowServingRuntime`` on a reduced float32 paged
port server and through the JAX one on the JAX server: the workflow
statuses and every turn's billed input tokens must be identical. The
port's runtime must also keep the invariants of tests/test_fame_serving.py
(session tail reuse, cache hit => radix hit, fault => state Retry,
co-batching), and a ``spec_len=4`` server must give the same statuses.

An AST test holds the port's rule that ``src/repro_torch`` and
``chip_smoke.py`` import neither JAX nor the JAX package.

EOS guard (ROADMAP.md queue 3): both servers' weights zero the EOS row,
so every turn generates its whole budget on both sides.
"""
import ast
import pathlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.apps import log_analytics as jla  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.core.config import CONFIGS as JCONFIGS  # noqa: E402
from repro.fame import ServingMeter as JMeter  # noqa: E402
from repro.fame import WorkflowServingRuntime as JRuntime  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serving.scheduler import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.scheduler import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving.server import LLMServer as JServer  # noqa: E402
from repro_torch.apps import log_analytics as la  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core.config import CONFIGS  # noqa: E402
from repro_torch.core.llm import LatencyModel, TorchLLM, rates_for_arch  # noqa: E402
from repro_torch.core.runtime import FameRuntime  # noqa: E402
from repro_torch.core.workflow import Retry  # noqa: E402
from repro_torch.fame import CoBatchDriver, ServingMeter, WorkflowServingRuntime  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.faults import FaultInjector, RequestFault  # noqa: E402
from repro_torch.serving.server import EngineConfig, LLMServer, SamplingParams  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PAGE = 16
KW = dict(dtype="float32", param_dtype="float32", vocab_size=512)
INPUT = la.APP.inputs[0]


@pytest.fixture(scope="module")
def weights():
    """(JAX config, params; the port's config, state dict): same numbers,
    EOS row zeroed."""
    jcfg, cfg = JARCHS["qwen2.5-3b"].reduced(**KW), ARCHS["qwen2.5-3b"].reduced(**KW)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    table = np.asarray(jp["embed"]["table"]).copy()
    table[cfg.vocab_size - 1] = 0.0
    jp["embed"]["table"] = jnp.asarray(table)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def _port_server(weights, decode_chunk=8, **ecfg):
    _, _, cfg, sd = weights
    srv = LLMServer(cfg, num_slots=4, capacity=2048, params=sd, device="cpu",
                    engine_cfg=EngineConfig(cache_mode="paged", page_size=PAGE,
                                            decode_chunk=decode_chunk, **ecfg),
                    injector=FaultInjector(seed=0), seed=0)
    srv.submit("warmup " * 8, SamplingParams(max_new_tokens=8)).result()
    return srv


@pytest.fixture(scope="module")
def server(weights):
    return _port_server(weights)


def build_rt(server, config, app=la, runtime=WorkflowServingRuntime,
             meter_cls=ServingMeter, configs=CONFIGS, sp=SamplingParams, **kw):
    meter = meter_cls(server)
    rt = runtime(config=configs[config], server=server, meter=meter,
                 params=sp(max_new_tokens=8), **kw)
    for role, oracle in app.build_oracles().items():
        rt.set_llm(role, oracle)
    rt.deploy_mcp(app.APP.servers, app.APP.sources)
    return rt, meter


@pytest.fixture(scope="module")
def mc_cell(server):
    rt, meter = build_rt(server, "M+C")
    res = rt.run_session(f"fame-test-{INPUT}", la.APP.queries(INPUT))
    return res, meter


@pytest.fixture(scope="module")
def jax_mc_cell(weights):
    """The same M+C session through the JAX package's runtime and server."""
    jcfg, jp, _, _ = weights
    srv = JServer(jcfg, num_slots=4, capacity=2048, params=jp, seed=0,
                  engine_cfg=JEngineConfig(cache_mode="paged", page_size=PAGE,
                                           decode_chunk=8))
    srv.submit("warmup " * 8, JSamplingParams(max_new_tokens=8)).result()
    rt, meter = build_rt(srv, "M+C", app=jla, runtime=JRuntime, meter_cls=JMeter,
                         configs=JCONFIGS, sp=JSamplingParams)
    res = rt.run_session(f"fame-test-{INPUT}", jla.APP.queries(INPUT))
    return res, meter


def _turns(meter):
    return [(r.kind, r.role, r.status, r.prompt_tokens, r.billed_tokens,
             r.output_tokens, r.session_turn) for r in meter.records]


def test_session_equals_jax_statuses_and_billed_tokens(mc_cell, jax_mc_cell):
    res, meter = mc_cell
    jres, jmeter = jax_mc_cell
    assert res.statuses == jres.statuses
    assert _turns(meter) == _turns(jmeter)
    # the EOS guard: every agent turn generated its whole budget
    assert all(r.output_tokens == 8 for r in jmeter.records if r.kind == "turn")


def test_statuses_identical_to_oracle_backend(mc_cell):
    res, _ = mc_cell
    oracle_rt = FameRuntime(config=CONFIGS["M+C"])
    for role, oracle in la.build_oracles().items():
        oracle_rt.set_llm(role, oracle)
    oracle_rt.deploy_mcp(la.APP.servers, la.APP.sources)
    oracle_res = oracle_rt.run_session(f"fame-test-{INPUT}", la.APP.queries(INPUT))
    assert res.statuses == oracle_res.statuses


def test_memory_config_reuses_session_tail(mc_cell):
    _, meter = mc_cell
    conts = meter.continuation_turns()
    assert conts, "persistent chain recorded no continuation turns"
    assert meter.tail_reuse_ok()
    for r in conts:
        assert 0 < r.billed_tokens < r.prompt_tokens
    assert all(r.prefix_hit_tokens > 0 for r in conts)
    assert meter.all_terminal()


def test_cache_hit_injection_radix_hits(server):
    rt, meter = build_rt(server, "C")
    rt.run_session(f"fame-test-c-{INPUT}", la.APP.queries(INPUT))
    injects = meter.turns("inject")
    hits = [r for r in injects if r.cache_hit]
    misses = [r for r in injects if not r.cache_hit]
    assert hits and misses
    assert meter.injection_radix_ok(PAGE)
    assert all(r.billed_tokens == 0 for r in hits)
    assert all(r.billed_tokens == r.prompt_tokens for r in misses)
    assert rt.cache.hits == len(hits)


def test_injected_fault_absorbed_by_state_retry(server):
    server.engine.injector.fail_next("decode", n=1, exc=RequestFault,
                                     msg="injected chaos")
    rt, meter = build_rt(server, "M+C",
                         state_retry=Retry(max_attempts=2, backoff_s=0.1))
    res = rt.run_session("fame-test-fault", la.APP.queries(INPUT)[:1])
    assert res.statuses == ["SUCCEEDED"]
    assert "RequestFault" in {r.error_type for r in meter.records}
    assert any(r.status == "failed" for r in meter.records)
    assert meter.all_terminal()


def test_cobatch_driver_shares_engine_steps(server):
    driver = CoBatchDriver(server)
    params = SamplingParams(max_new_tokens=8)
    before = server.stats()

    def turn(i):
        return driver.call(
            lambda: server.submit(f"cobatch worker {i} asks a question " * 3,
                                  params))

    handles = driver.run([lambda i=i: turn(i) for i in range(3)])
    assert all(h.request.finished for h in handles)
    after = server.stats()
    steps = after["engine_steps"] - before["engine_steps"]
    slot_sum = (after["active_slots_per_step"] * after["engine_steps"]
                - before["active_slots_per_step"] * before["engine_steps"])
    assert steps > 0
    assert slot_sum / steps > 1.05, "concurrent submits did not co-batch"
    assert threading.active_count() >= 1


def test_spec_server_session_statuses_unchanged(weights, jax_mc_cell):
    """The M+C session on a ``spec_len=4`` port server: the same statuses
    as the JAX session, every turn terminal. Decode chunks of 2 leave the
    drafter turns inside each 8-token turn, so verify steps really run."""
    srv = _port_server(weights, decode_chunk=2, spec_len=4)
    rt, meter = build_rt(srv, "M+C")
    res = rt.run_session(f"fame-test-{INPUT}", la.APP.queries(INPUT))
    assert res.statuses == jax_mc_cell[0].statuses
    assert meter.all_terminal()
    st = srv.stats()
    assert st["verify_steps"] > 0 and st["draft_tokens"] > 0, st


def test_torch_llm_backend_sessions_and_rates(server):
    """TorchLLM serves agent calls through per-role sessions of the port's
    server; rates_for_arch returns the simulation's LatencyModel defaults."""
    llm = TorchLLM(server, max_new_tokens=4)
    r1 = llm.chat("system: planner", "first question")
    r2 = llm.chat("system: planner", "first question\nand a follow-up")
    assert r1.input_tokens > 0 and r2.input_tokens > r1.input_tokens
    assert llm.serving_stats()["session_turns"] >= 2
    assert rates_for_arch("qwen2.5-3b") == LatencyModel()
    with pytest.raises(TypeError):
        TorchLLM(object())


# ---------------------------------------------------------------------------
# the port imports neither JAX nor the JAX package
# ---------------------------------------------------------------------------


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    bad = {}
    for path in _port_files():
        names = list(_imported(ast.parse(path.read_text(), str(path))))
        hit = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
        if hit:
            bad[path.relative_to(ROOT).as_posix()] = hit
    assert len(_port_files()) > 50
    assert not bad, bad


def test_port_app_sources_import_the_port():
    """The MCP server sources the apps deploy are code strings executed at
    run time; they too import the port's FastMCP, never the JAX package's."""
    for spec in (la.APP,):
        for src in spec.sources.values():
            names = list(_imported(ast.parse(src)))
            assert names and all(n.split(".")[0] != "repro" for n in names), names
