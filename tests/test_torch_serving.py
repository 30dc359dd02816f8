"""The port's serving stack (repro_torch.serving) against repro.serving.

* the sampler: greedy identical to JAX's ``sample_batched``; ``vocab_limit``
  and top-k edge cases; temperature draws within a chi-square bound of the
  softmax (the port's noise is a counter hash, not JAX's threefry bits);
* ``LLMServer`` greedy output ids equal the JAX package's on the same
  weights, dense and paged, three co-batched prompts;
* the port's own invariants: paged == dense greedy, session multi-turn
  reuse == fresh prefill, cancel leaks no pages, a stop split across a
  chunk boundary is caught, the same seed gives the same output whatever
  ``num_slots`` and co-batched neighbours.

EOS guard (ROADMAP.md queue 3): the random-init reduced qwen emits EOS as
its first token for most prompts, so a comparison where both sides stop at
EOS proves nothing. The weights here zero the EOS row of the tied
embedding (EOS logit 0, below the max of 511 random logits) and every
parity test asserts the reference really emitted its full budget.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serving import sampler as jsampler  # noqa: E402
from repro.serving.server import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.server import LLMServer as JServer  # noqa: E402
from repro.serving.server import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import sampler  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402
from repro_torch.serving.server import (EngineConfig, LLMServer,  # noqa: E402
                                        SamplingParams)

KW = dict(dtype="float32", param_dtype="float32", vocab_size=512)
PROMPTS = ["alpha prompt for slot one",
           "a rather longer second prompt that crosses a bucket boundary",
           "third prompt"]
SYS = "System: cooperating agents share this conversation verbatim. "
TURNS = ["[planner] Plan the next step of the task. ",
         "[actor] Act: call the search tool now. ",
         "[evaluator] Evaluate the tool output please. "]


@pytest.fixture(scope="module")
def cfgs():
    return (JARCHS["qwen2.5-3b"].reduced(**KW), ARCHS["qwen2.5-3b"].reduced(**KW))


@pytest.fixture(scope="module")
def weights(cfgs):
    """(JAX params, the port's state dict) — the same numbers, EOS guarded."""
    jcfg, cfg = cfgs
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    table = np.asarray(jp["embed"]["table"]).copy()
    table[cfg.vocab_size - 1] = 0.0             # ByteTokenizer eos_id
    jp["embed"]["table"] = jnp.asarray(table)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def _server(cfg, sd, **kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("capacity", 128)
    return LLMServer(cfg, params=sd, device="cpu", **kw)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


def test_greedy_identical_to_jax():
    logits = np.random.RandomState(0).standard_normal((5, 300)).astype(np.float32)
    logits[1, 7] = logits[1, 9] = 50.0                  # a tie: first index wins
    for vocab_limit in (0, 200):
        want = jsampler.sample_batched(jnp.asarray(logits), None, temperature=None,
                                       vocab_limit=vocab_limit)
        got = sampler.sample_batched(torch.from_numpy(logits), None,
                                     temperature=None, vocab_limit=vocab_limit)
        assert got.tolist() == np.asarray(want).tolist()
        # temperature 0 rows are greedy too, whatever their keys
        keys = torch.tensor([[3, 0]] * 5)
        got0 = sampler.sample_batched(torch.from_numpy(logits), keys,
                                      temperature=torch.zeros(5),
                                      vocab_limit=vocab_limit)
        assert got0.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("k", [-1, 0, 1, 3, 299, 300, 10_000])
def test_top_k_filter_matches_jax(k):
    """k <= 0 and k >= V mean no filter (never a negative index); the
    kept set equals JAX's for every k."""
    scaled = np.random.RandomState(1).standard_normal((4, 300)).astype(np.float32)
    kk = np.full((4,), k, np.int32)
    want = np.asarray(jsampler._top_k_filter(jnp.asarray(scaled), jnp.asarray(kk)))
    got = sampler._top_k_filter(torch.from_numpy(scaled), torch.from_numpy(kk)).numpy()
    assert np.array_equal(want, got)


def test_vocab_limit_composes_with_top_k():
    """Masked ids are never kept by top-k nor sampled."""
    logits = torch.zeros(64, 50)
    logits[:, 45:] = 100.0                           # outside the limit
    keys = torch.stack([torch.arange(64), torch.zeros(64, dtype=torch.long)], 1)
    out = sampler.sample_batched(logits, keys, temperature=torch.ones(64),
                                 top_k=torch.full((64,), 3), vocab_limit=40)
    assert int(out.max()) < 40
    logits[:, 7] = 5.0                               # the top-1 inside the limit
    out1 = sampler.sample_batched(logits, keys, temperature=torch.ones(64),
                                  top_k=torch.full((64,), 1), vocab_limit=40)
    assert (out1 == 7).all()


def test_temperature_sampling_matches_softmax_distribution():
    """20000 draws from 20000 (key, token index) pairs over an 8-way
    softmax at temperature 0.7, top_k 6: the counts pass a chi-square test
    against the filtered softmax (p > 0.001, 5 degrees of freedom)."""
    V, N = 8, 20_000
    base = torch.tensor([1.0, 0.5, 0.0, -0.3, 0.8, -1.0, 0.2, -2.0])
    logits = base.expand(N, V)
    keys = torch.stack([torch.arange(N) % 97, torch.arange(N) // 97], 1)
    out = sampler.sample_batched(logits, keys, temperature=torch.full((N,), 0.7),
                                 top_k=torch.full((N,), 6))
    counts = np.bincount(out.numpy(), minlength=V).astype(np.float64)
    scaled = (base / 0.7).numpy()
    kept = scaled >= np.sort(scaled)[-6]
    p = np.where(kept, np.exp(scaled - scaled.max()), 0.0)
    p /= p.sum()
    assert counts[~kept].sum() == 0
    exp = N * p[kept]
    chi2 = float(((counts[kept] - exp) ** 2 / exp).sum())
    assert chi2 < 20.5, (chi2, counts, exp)         # chi2(5) at p = 0.001
    # each draw depends on its own key pair only
    again = sampler.sample_batched(logits[:100].flip(0), keys[:100].flip(0),
                                   temperature=torch.full((100,), 0.7),
                                   top_k=torch.full((100,), 6))
    assert again.flip(0).tolist() == out[:100].tolist()


# ---------------------------------------------------------------------------
# LLMServer: greedy parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_outputs(cfgs, weights):
    """The JAX server's greedy output ids, per cache mode (built once)."""
    jcfg, _ = cfgs
    jp, _ = weights
    out = {}
    for mode in ("dense", "paged"):
        srv = JServer(jcfg, num_slots=3, capacity=128, params=jp,
                      engine_cfg=JEngineConfig(cache_mode=mode, page_size=16,
                                               decode_chunk=4))
        hs = [srv.submit(p, JSamplingParams(max_new_tokens=10)) for p in PROMPTS]
        srv.run_until_idle()
        out[mode] = [h.request.output_ids for h in hs]
        out[mode + "_stats"] = sorted(srv.stats())
    return out


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_server_greedy_ids_equal_jax(cfgs, weights, jax_outputs, mode):
    _, cfg = cfgs
    ref = jax_outputs[mode]
    # the EOS guard: the reference really generated its whole budget
    assert all(len(ids) == 10 for ids in ref), ref
    srv = _server(cfg, weights[1], engine_cfg=EngineConfig(
        cache_mode=mode, page_size=16, decode_chunk=4))
    hs = [srv.submit(p, SamplingParams(max_new_tokens=10)) for p in PROMPTS]
    srv.run_until_idle()
    assert [h.request.output_ids for h in hs] == ref
    assert srv.stats()["active_slots_per_step"] > 1.0    # they co-batched
    # stats() reports the JAX server's keys
    assert sorted(srv.stats()) == jax_outputs[mode + "_stats"]


def test_paged_equals_dense_greedy(cfgs, weights):
    _, cfg = cfgs
    outs = {}
    for mode in ("dense", "paged"):
        srv = _server(cfg, weights[1], engine_cfg=EngineConfig(
            cache_mode=mode, page_size=16, decode_chunk=3))
        shared = [SYS + t for t in TURNS]                  # radix sharing
        hs = [srv.submit(p, SamplingParams(max_new_tokens=12)) for p in shared]
        srv.run_until_idle()
        hs += [srv.submit(p, SamplingParams(max_new_tokens=12)) for p in shared]
        srv.run_until_idle()
        outs[mode] = [h.request.output_ids for h in hs]
        if mode == "paged":
            assert srv.stats()["prefix_hit_tokens"] > 0
    assert all(len(o) == 12 for o in outs["dense"])
    assert outs["paged"] == outs["dense"]


def test_session_multi_turn_reuse_bit_identical(cfgs, weights):
    """Turn N+1 restores turn N's partial tail page (non-block-aligned) and
    prefills only the new message; greedy outputs equal a fresh scheduler
    fed the same token stream (the reference's test_server_api.py:75)."""
    _, cfg = cfgs
    ps = 16
    srv = _server(cfg, weights[1], num_slots=2, capacity=192,
                  engine_cfg=EngineConfig(cache_mode="paged", page_size=ps))
    fresh = Scheduler(cfg, num_slots=2, capacity=192, params=srv.params,
                      device="cpu")
    sess = srv.open_session()
    sp = SamplingParams(max_new_tokens=9)
    prompt = SYS
    hits, tails = [], []
    for turn in TURNS:
        prompt = sess.text + turn if sess.text else prompt + turn
        tails.append(srv.engine._sessions[sess.sid].tail_len)
        h = sess.submit(prompt, sp)
        out = h.result()
        assert len(h.request.output_ids) == 9
        r = fresh.enqueue(prompt, sp, token_ids=h.request._ids)
        fresh.run_until_drained()
        assert r.output_ids == h.request.output_ids and r.output_text == out
        hits.append(h.request.prefix_hit_tokens)
    st = srv.stats()
    assert st["session_turns"] == 3 and st["turn_prefix_hits"] >= 2
    assert hits[1:] == tails[1:], (hits, tails)
    assert any(t % ps for t in tails[1:]), tails
    sess.close()


def _leak_check(srv):
    eng = srv.engine
    assert all(s.request is None for s in eng.slots)
    owned = eng.radix.check_invariants()
    free = set(eng.kvpool._free)
    tails = {s.tail_page for s in eng._sessions.values() if s.tail_page >= 0}
    assert not (owned & free) and not (owned & tails) and not (free & tails)
    assert (len(owned) + len(free) + len(tails)
            == eng.kvpool.num_pages - eng.kvpool.reserved)


def test_cancel_leaks_no_pages(cfgs, weights):
    """Cancel queued, mid-prefill-queue and mid-decode requests and a
    session turn: every page ends owned exactly once (free list, radix
    tree or a session tail); the retained tail survives the cancelled turn."""
    _, cfg = cfgs
    srv = _server(cfg, weights[1], num_slots=2, engine_cfg=EngineConfig(
        cache_mode="paged", page_size=16, decode_chunk=2))
    sess = srv.open_session()
    sess.submit(SYS + TURNS[0], SamplingParams(max_new_tokens=6)).result()
    tail = srv.engine._sessions[sess.sid].tail_page
    a = srv.submit(SYS + "request a", SamplingParams(max_new_tokens=20))
    b = srv.submit(SYS + "request b", SamplingParams(max_new_tokens=20))
    c = srv.submit(SYS + "request c", SamplingParams(max_new_tokens=20))
    h = sess.submit(sess.text + TURNS[1], SamplingParams(max_new_tokens=20))
    srv.step()
    assert a.status().value == "running" and c.status().value == "queued"
    assert srv.cancel(c) and srv.cancel(a)
    srv.step()
    assert srv.cancel(h)
    assert srv.engine._sessions[sess.sid].tail_page == tail
    srv.run_until_idle()
    assert b.status().value == "completed" and a.request.output_tokens > 0
    assert srv.stats()["cancelled_requests"] == 3
    _leak_check(srv)
    h2 = sess.submit(sess.text + TURNS[1], SamplingParams(max_new_tokens=4))
    h2.result()
    assert h2.request.prefix_hit_tokens > 0
    _leak_check(srv)


def test_stop_sequence_split_across_chunk_boundary(cfgs, weights):
    """A stop string whose pieces land in different decode chunks is
    caught, and the tokens after it are trimmed (the reference's
    test_server_api.py:547, on EOS-guarded weights)."""
    _, cfg = cfgs
    srv = _server(cfg, weights[1], num_slots=1, capacity=96,
                  engine_cfg=EngineConfig(decode_chunk=4))
    free_h = srv.submit("hello world", SamplingParams(max_new_tokens=16))
    free_text = free_h.result()
    g = free_h.request.output_ids
    assert len(g) == 16
    dec = srv.engine.tokenizer.decode
    # token 0 comes from prefill and chunks are 4 tokens: token i lands in
    # chunk (i + 3) // 4. Take a 3-token stop whose first and last tokens
    # land in different chunks (ids above the tokenizer's merges decode to
    # no text, so pick a span whose end tokens both decode)
    chunk = lambda i: (i + 3) // 4                   # noqa: E731
    for s in range(1, 14):
        stop = dec(g[:s + 3])[len(dec(g[:s])):]
        if (chunk(s) != chunk(s + 2) and dec(g[s:s + 1]) and dec(g[s + 2:s + 3])
                and stop not in dec(g[:s + 2])):
            break
    else:
        pytest.fail(f"no chunk-spanning stop in {g}")
    assert stop in free_text
    h2 = srv.submit("hello world",
                    SamplingParams(max_new_tokens=16, stop=(stop,)))
    out = h2.result()
    assert stop in out
    n = h2.request.output_tokens
    assert n == s + 3                                 # caught where it completes
    assert h2.request.output_ids == g[:n]             # trim, not divergence
    assert stop not in dec(g[:n - 1])


def test_seed_reproducible_across_num_slots(cfgs, weights):
    """Same SamplingParams.seed -> same sampled ids at num_slots 2 and 4,
    with or without co-batched, differently seeded neighbours."""
    _, cfg = cfgs
    sp = SamplingParams(max_new_tokens=10, temperature=0.9, top_k=8, seed=123)
    srv2 = _server(cfg, weights[1], num_slots=2, capacity=96)
    h2 = srv2.submit("sample with a pinned seed", sp)
    h2.result()
    srv4 = _server(cfg, weights[1], num_slots=4, capacity=96)
    h4 = srv4.submit("sample with a pinned seed", sp)
    others = [srv4.submit("noise neighbour %d" % i,
                          SamplingParams(max_new_tokens=10, temperature=1.3,
                                         seed=i)) for i in range(3)]
    srv4.run_until_idle()
    assert len(h2.request.output_ids) == 10
    assert h4.request.output_ids == h2.request.output_ids
    assert len({tuple(o.request.output_ids) for o in others}) == 3
    # sampling really happened: a greedy run differs
    g = _server(cfg, weights[1], num_slots=2, capacity=96).submit(
        "sample with a pinned seed", SamplingParams(max_new_tokens=10))
    g.result()
    assert g.request.output_ids != h2.request.output_ids


# ---------------------------------------------------------------------------
# what the slice refuses, and where it runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ecfg,item", [
    (dict(mesh=(2, 2)), "item 11"),
])
def test_unported_engine_options_raise(cfgs, weights, ecfg, item):
    """The engine option that ROADMAP.md queue 1 ``item`` ported is no
    longer refused: ``EngineConfig(mesh=...)`` serves on a (2, 2) CPU mesh
    with the unsharded server's greedy ids (tests/test_torch_mesh_serving.py
    holds the whole matrix), and only a mesh that does not lead on the
    server's device raises."""
    from repro_torch.distributed.mesh import make_test_mesh
    _, cfg = cfgs
    mesh = make_test_mesh(ecfg["mesh"], devices="cpu")
    outs = []
    for m in (None, mesh):
        srv = _server(cfg, weights[1], engine_cfg=EngineConfig(mesh=m))
        hs = [srv.submit(p, SamplingParams(max_new_tokens=6)) for p in PROMPTS]
        srv.run_until_idle()
        outs.append([h.request.output_ids for h in hs])
        assert srv.stats()["sharded"] == (m is not None)
        srv.close()
    assert outs[0] == outs[1]
    mesh.devices.flat[0] = torch.device("meta")
    with pytest.raises(ValueError, match="leads on"):
        _server(cfg, weights[1], engine_cfg=EngineConfig(mesh=mesh))


def test_spec_len_builds_and_serves(cfgs, weights):
    """``spec_len=4`` (speculative decode) builds and serves on the port:
    a copy-heavy prompt completes its budget through verify steps."""
    _, cfg = cfgs
    srv = _server(cfg, weights[1], engine_cfg=EngineConfig(spec_len=4,
                                                          decode_chunk=2))
    h = srv.submit("err 429 err 429 err 429 err 429 err",
                   SamplingParams(max_new_tokens=12))
    h.result()
    assert h.request.status == "completed" and len(h.request.output_ids) == 12
    assert srv.stats()["verify_steps"] > 0


def test_server_runs_on_the_card_unless_asked_for_cpu(cfgs):
    _, cfg = cfgs
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LLMServer(cfg, num_slots=1, capacity=64)
    srv = LLMServer(cfg, num_slots=1, capacity=64, device="cpu")
    assert srv.device.type == "cpu"
    assert next(srv.params.parameters()).device.type == "cpu"
