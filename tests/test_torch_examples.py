"""The port's FAME entry points (``repro_torch.examples``), the deprecated
``ServingEngine`` shim, ``Model.loss`` and the one-shot ``sample`` against
the JAX package's.

- Oracle mode: each port module prints byte for byte what its JAX script
  in ``examples/`` prints, with the same arguments (plus ``--device cpu``).
- Served mode: ``quickstart --llm torch`` against ``--llm jax`` and
  ``serve_agents`` on both packages, on the same JAX-initialised reduced
  float32 weights: every request's greedy token ids, the statuses and the
  serving counters are equal.
- ``ServingEngine``: it warns, its greedy ``generate()`` equals the JAX
  engine's and the port's ``LLMServer``, it refuses a budget that fills
  the cache, and ``TorchLLM`` serves a FAME session on it.
- ``Model.loss`` equals the JAX ``Model.loss`` (float32, 1e-5); ``sample``
  is the argmax when greedy, masks ``vocab_limit``, keeps top-k draws in
  the top k and draws by the softmax.

EOS guard (ROADMAP.md queue 3): the served comparisons zero the EOS row of
the tied embedding on both sides and check that every JAX request emitted
its whole budget, so no comparison is two sides stopping at EOS.
"""
import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving.server as jserver_mod  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serving import sampler as jsampler  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core.llm import TorchLLM  # noqa: E402
from repro_torch.examples import log_analytics, quickstart, research_summary  # noqa: E402
from repro_torch.examples import serve_agents  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import sampler  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.server import LLMServer, SamplingParams  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(dtype="float32", param_dtype="float32", vocab_size=512)
SERVING_KEYS = ("sessions_opened", "session_turns", "turn_prefix_hits",
                "decode_tokens", "prefix_hit_tokens")


def _jax_script(name):
    """The JAX package's ``examples/<name>.py`` as a module (not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_stdout(name, argv, capsys, monkeypatch):
    mod = _jax_script(name)
    monkeypatch.setattr("sys.argv", [f"{name}.py", *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


# ---------------------------------------------------------------------------
# oracle mode: byte-identical output
# ---------------------------------------------------------------------------

ORACLE_CASES = (
    [("research_summary", ["--paper", p]) for p in ("P1", "P2", "P3")]
    + [("log_analytics", ["--log", lg, "--config", c])
       for lg in ("L1", "L2", "L3") for c in ("M+C", "E")]
    + [("quickstart", ["--app", a, "--fusion", f])
       for a in ("RS", "LA") for f in ("singleton", "consolidated")])
PORT_MODULES = {"research_summary": research_summary,
                "log_analytics": log_analytics, "quickstart": quickstart}


@pytest.mark.parametrize("name,argv", ORACLE_CASES,
                         ids=[f"{n}-{'-'.join(a[1::2])}" for n, a in ORACLE_CASES])
def test_oracle_output_byte_identical(name, argv, capsys, monkeypatch):
    want = _jax_stdout(name, argv, capsys, monkeypatch)
    PORT_MODULES[name].main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert want.count("\n") > 3
    assert got == want


@pytest.mark.parametrize("name", ["quickstart", "serve_agents",
                                  "research_summary", "log_analytics"])
def test_entry_point_runs_as_a_module(name):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}",
                          "--help"], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """The default device is the card; without one every entry point
    raises before it runs anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (research_summary.main, log_analytics.main, quickstart.main,
                 serve_agents.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])


# ---------------------------------------------------------------------------
# served mode: the same weights on both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """(JAX config, params; the port's config, state dict): reduced float32
    qwen2.5-3b by the scripts' rule, the same numbers, EOS row zeroed."""
    jcfg, cfg = JARCHS["qwen2.5-3b"].reduced(**KW), ARCHS["qwen2.5-3b"].reduced(**KW)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    table = np.asarray(jp["embed"]["table"]).copy()
    table[cfg.vocab_size - 1] = 0.0
    jp["embed"]["table"] = jnp.asarray(table)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def _record(engine):
    """Every request the engine queues, in order."""
    reqs, enqueue = [], engine.enqueue

    def recorded(*a, **kw):
        reqs.append(enqueue(*a, **kw))
        return reqs[-1]

    engine.enqueue = recorded
    return reqs


def _jax_server_class(jp, servers):
    """The JAX ``LLMServer`` on ``jp`` whatever params the script passes,
    recording its requests."""
    class Seeded(jserver_mod.LLMServer):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, **{**kw, "params": jp})
            self.recorded = _record(self.engine)
            servers.append(self)
    return Seeded


def _ids(reqs):
    return [list(r.output_ids) for r in reqs]


def _assert_full_budget(reqs):
    """The EOS guard: every request emitted its whole budget."""
    assert reqs and all(len(r.output_ids) == r.max_new_tokens for r in reqs)


def test_served_quickstart_equals_jax(weights, capsys, monkeypatch):
    _, jp, _, sd = weights
    jservers = []
    monkeypatch.setattr(jserver_mod, "LLMServer", _jax_server_class(jp, jservers))
    jout = _jax_stdout("quickstart", ["--app", "LA", "--llm", "jax"], capsys,
                       monkeypatch)
    (jsrv,) = jservers
    _assert_full_budget(jsrv.recorded)

    server, llm = quickstart.build_torch_backend("qwen2.5-3b", "cpu", params=sd)
    reqs = _record(server.engine)
    res, lines = quickstart.run("LA", "M+C", "singleton", llm)
    assert _ids(reqs) == _ids(jsrv.recorded)
    st, jst = server.stats(), jsrv.stats()
    assert {k: st[k] for k in SERVING_KEYS} == {k: jst[k] for k in SERVING_KEYS}
    # after the header the whole printout is the JAX script's: statuses,
    # tokens, answers, serving stats
    assert "\n".join(lines) + "\n" == jout.split("\n", 1)[1]
    assert len(res.statuses) == 3
    assert all(f"status={x} " in jout for x in res.statuses)


def test_served_serve_agents_equals_jax(weights, capsys, monkeypatch):
    _, jp, cfg, sd = weights
    jservers = []
    jmod = _jax_script("serve_agents")
    monkeypatch.setattr(jmod, "LLMServer", _jax_server_class(jp, jservers))
    monkeypatch.setattr("sys.argv", ["serve_agents.py", "--workflows", "2",
                                     "--rounds", "1"])
    capsys.readouterr()
    jmod.main()
    jout = capsys.readouterr().out
    (jsrv,) = jservers
    _assert_full_budget(jsrv.recorded)

    server = serve_agents.make_server(cfg, device="cpu", params=sd)
    reqs = _record(server.engine)
    out = serve_agents.run(server, workflows=2, rounds=1)
    got = capsys.readouterr().out
    assert _ids(reqs) == _ids(jsrv.recorded)
    assert all(h.request.status == "completed" for h in out["handles"])
    assert len(out["handles"]) == 6
    assert f"statuses={out['fame'].statuses}" in jout
    st, jst = server.stats(), jsrv.stats()
    assert {k: st[k] for k in SERVING_KEYS} == {k: jst[k] for k in SERVING_KEYS}
    assert st["turn_prefix_hits"] > 0 and st["prefix_hit_tokens"] > 0
    # every line but the wall-clock one is the JAX script's
    keep = [ln for ln in got.splitlines() if not ln.startswith("co-batched")]
    assert keep == [ln for ln in jout.splitlines() if not ln.startswith("co-batched")]
    assert "tok/s on CPU)" in got


# ---------------------------------------------------------------------------
# the deprecated ServingEngine
# ---------------------------------------------------------------------------

PROMPTS = ["The planner asks the actor for a tool call. ",
           "Summarise the error log: " + "block missing, lease expired. " * 3]


def _engine(weights, **kw):
    _, _, cfg, sd = weights
    return ServingEngine(cfg, num_slots=2, capacity=128, params=sd,
                         device="cpu", **kw)


def test_serving_engine_warns_and_refuses_full_budget(weights):
    eng = _engine(weights)
    with pytest.warns(DeprecationWarning, match="LLMServer"):
        req = eng.submit(PROMPTS[0], max_new_tokens=4)
    eng.run_until_drained()
    assert req.status == "completed" and len(req.output_ids) == 4
    for n in (eng.capacity - 1, eng.capacity):
        with pytest.warns(DeprecationWarning), pytest.raises(ValueError):
            eng.submit(PROMPTS[0], max_new_tokens=n)


def test_serving_engine_generate_equals_jax_and_server(weights):
    jcfg, jp, cfg, sd = weights
    jeng = JEngine(jcfg, num_slots=2, capacity=128, params=jp)
    eng = _engine(weights)
    srv = LLMServer(cfg, num_slots=2, capacity=128, params=sd, device="cpu")
    for p in PROMPTS:
        with pytest.warns(DeprecationWarning):
            want = jeng.generate(p, max_new_tokens=12)
        with pytest.warns(DeprecationWarning):
            got = eng.generate(p, max_new_tokens=12)
        assert got == want
        assert srv.submit(p, SamplingParams(max_new_tokens=12)).result() == got
    assert eng.stats()["decode_tokens"] == jeng.stats()["decode_tokens"]


def test_torch_llm_on_serving_engine_statuses(weights):
    """A FAME session with every role on ``TorchLLM`` over the deprecated
    engine (the blocking path) gives the statuses it gives over an
    ``LLMServer`` (sessions per role)."""
    _, _, cfg, sd = weights
    eng = ServingEngine(cfg, num_slots=4, capacity=512, params=sd, device="cpu",
                        engine_cfg=quickstart.EngineConfig(cache_mode="paged"))
    with pytest.warns(DeprecationWarning):
        res, lines = quickstart.run("LA", "M+C", "singleton",
                                    TorchLLM(eng, max_new_tokens=8))
    server, llm = quickstart.build_torch_backend("qwen2.5-3b", "cpu", params=sd)
    want, _ = quickstart.run("LA", "M+C", "singleton", llm)
    assert res.statuses == want.statuses and len(res.statuses) == 3
    assert lines[-1].startswith("serving stats: {'sessions_opened': 0, "
                                "'session_turns': 0,")
    assert eng.stats()["decode_tokens"] == server.stats()["decode_tokens"]


# ---------------------------------------------------------------------------
# Model.loss and sample
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x22b"])
def test_model_loss_equals_jax(arch):
    jcfg, cfg = JARCHS[arch].reduced(**KW), ARCHS[arch].reduced(**KW)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1                              # masked out
    jloss, jparts = jm.loss(jp, jm.make_batch(jnp.asarray(toks),
                                              labels=jnp.asarray(labels)))
    m = Model(cfg, device="cpu")
    params = m.load(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    with torch.no_grad():
        loss, parts = m.loss(params, m.make_batch(torch.tensor(toks).long(),
                                                  labels=torch.tensor(labels)))
    assert abs(float(loss) - float(jloss)) <= 1e-5
    for k in ("nll", "aux"):
        assert abs(float(parts[k]) - float(jparts[k])) <= 1e-5
    if arch == "mixtral-8x22b":
        assert float(parts["aux"]) > 0


def _logits(B, V, seed=0):
    return np.random.default_rng(seed).normal(0, 2, (B, V)).astype(np.float32)


@pytest.mark.parametrize("vocab_limit", [0, 100])
def test_sample_greedy_equals_jax(vocab_limit):
    lg = _logits(16, 300)
    want = jsampler.sample(jnp.asarray(lg), jax.random.PRNGKey(0),
                           vocab_limit=vocab_limit)
    got = sampler.sample(torch.tensor(lg), None, vocab_limit=vocab_limit)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist()
    if vocab_limit:
        assert int(got.max()) < vocab_limit
        assert (lg.argmax(-1) >= vocab_limit).any()


def test_sample_vocab_limit_and_top_k():
    lg = torch.tensor(np.tile(_logits(1, 64, seed=3), (2000, 1)))
    key = sampler.prng_key(5)
    ids = sampler.sample(lg, key, temperature=1.5, vocab_limit=40)
    assert int(ids.max()) < 40 and len(set(ids.tolist())) > 10
    for k in (1, 5):
        ids = sampler.sample(lg, sampler.fold_in(key, k), temperature=2.0, top_k=k)
        top = set(torch.topk(lg[0], k).indices.tolist())
        assert set(ids.tolist()) == top
    # the same key gives the same draws; another key other draws
    again = sampler.sample(lg, key, temperature=1.5, vocab_limit=40)
    assert torch.equal(again, sampler.sample(lg, key, temperature=1.5,
                                             vocab_limit=40))
    assert not torch.equal(again, sampler.sample(lg, sampler.fold_in(key, 1),
                                                 temperature=1.5, vocab_limit=40))


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_sample_frequencies_follow_softmax(temperature):
    row = _logits(1, 8, seed=11)[0] / 2
    n = 4000
    ids = sampler.sample(torch.tensor(np.tile(row, (n, 1))), sampler.prng_key(7),
                         temperature=temperature)
    freq = np.bincount(ids.numpy(), minlength=8) / n
    p = np.exp(row / temperature - (row / temperature).max())
    p /= p.sum()
    assert np.abs(freq - p).max() < 0.03, (freq, p)
