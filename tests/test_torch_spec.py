"""The port's speculative decode against the JAX package on the CPU.

* ``accept_len``: the port's plain version == JAX ``accept_len_ref`` ==
  the Pallas kernel (interpret mode) on seeded cases;
* ``accept_batched``: greedy rows identical to JAX (tokens and lengths);
  stochastic rows distribution-correct (the port draws from its counter
  hash, not threefry), reproducible and independent of the batch;
* the verify-mode helpers (dense / paged cache writes, ``spec_attention``)
  == JAX at float32 2e-5; model ``verify`` logits == JAX ``verify`` within
  the reference's model bound 3e-3, and == S successive decode steps;
* ``LLMServer(spec_len=6)`` greedy == ``spec_len=0`` == the JAX server on
  copy-heavy prompts, dense and paged; no page leaks with cancels.

EOS guard (ROADMAP.md queue 3): serving comparisons zero the EOS row of
the tied embedding on both sides and assert the reference emitted its
whole budget.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import spec_scan as jscan  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import sampler as jsampler  # noqa: E402
from repro.serving.server import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.server import LLMServer as JServer  # noqa: E402
from repro.serving.server import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.kernels import spec_scan  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.serving import kvpool as tkv  # noqa: E402
from repro_torch.serving import sampler  # noqa: E402
from repro_torch.serving.server import (EngineConfig, LLMServer,  # noqa: E402
                                        SamplingParams)
from tests.test_torch_model import Pair, _err, _toks  # noqa: E402

F32_TOL = 2e-5          # same math, other reduction order (float32)
MODEL_TOL = 3e-3        # the reference's model-level bound (test_kernels.py)
COPY_PROMPTS = [        # tests/test_spec_decode.py's copy-heavy prompts
    "Tool result: ERROR 429 rate limit exceeded at gateway. " * 2,
    "summarize: the quick brown fox jumps over the lazy dog again and "
    "again and again",
    "log: a=1 b=2; log: a=1 b=2; log: a=1 b=3; what changed?",
]


# ---------------------------------------------------------------------------
# accept_len: plain == JAX reference == Pallas (interpret)
# ---------------------------------------------------------------------------


def _accept_cases(S, n, seed):
    """n seeded (flags [B,S], lens [B]) cases, directed edges first:
    lens 0, lens S-1, all-accept, all-reject."""
    rng = np.random.RandomState(seed)
    cases = [(np.ones((2, S), bool), np.array([0, S - 1])),
             (np.zeros((2, S), bool), np.array([S - 1, 0])),
             (np.ones((1, S), bool), np.array([S - 1])),
             (np.zeros((1, S), bool), np.array([S - 1]))]
    while len(cases) < n:
        B = rng.randint(1, 9)
        flags = rng.rand(B, S) < rng.choice([0.3, 0.7, 0.95])
        lens = rng.randint(0, S, size=B)
        cases.append((flags, lens))
    return [(f, ln.astype(np.int32)) for f, ln in cases]


@pytest.mark.parametrize("S", [1, 2, 5, 7, 32, 33])
def test_accept_len_plain_equals_jax_and_pallas(S):
    """40 cases per S (240 in all); the Pallas kernel runs once per S on
    the cases stacked along the batch (rows are independent)."""
    cases = _accept_cases(S, 40, seed=S)
    got = [spec_scan.accept_len(torch.from_numpy(f), torch.from_numpy(ln))
           for f, ln in cases]
    for (f, ln), g in zip(cases, got):
        want = jscan.accept_len_ref(jnp.asarray(f), jnp.asarray(ln))
        assert g.dtype == torch.int32
        assert g.tolist() == np.asarray(want).tolist(), (f, ln)
    flags = np.concatenate([f for f, _ in cases])
    lens = np.concatenate([ln for _, ln in cases])
    pallas = jscan.accept_len(jnp.asarray(flags), jnp.asarray(lens),
                              interpret=True)
    assert np.asarray(pallas).tolist() == torch.cat(got).tolist()
    # the directed edges
    assert got[0].tolist() == [0, S - 1] and got[1].tolist() == [0, 0]
    assert got[2].tolist() == [S - 1] and got[3].tolist() == [0]


# ---------------------------------------------------------------------------
# accept_batched
# ---------------------------------------------------------------------------


def _verify_inputs(seed, B=6, S=5, V=300):
    """Logits and verify inputs whose drafts match the argmax ~70% of the
    time (so accepted prefixes of every length occur)."""
    rng = np.random.RandomState(seed)
    logits = rng.standard_normal((B, S, V)).astype(np.float32)
    am = logits.argmax(-1)
    inputs = rng.randint(0, V, (B, S)).astype(np.int32)
    hit = rng.rand(B, S - 1) < 0.7
    inputs[:, 1:] = np.where(hit, am[:, :-1], inputs[:, 1:])
    lens = rng.randint(0, S, B).astype(np.int32)
    return logits, inputs, lens


@pytest.mark.parametrize("vocab_limit", [0, 200])
def test_accept_batched_greedy_identical_to_jax(vocab_limit):
    for seed in range(4):
        logits, inputs, lens = _verify_inputs(seed)
        jt, jn = jsampler.accept_batched(jnp.asarray(logits), jnp.asarray(inputs),
                                         jnp.asarray(lens), None, temperature=None,
                                         vocab_limit=vocab_limit)
        tt, tn = sampler.accept_batched(torch.from_numpy(logits),
                                        torch.from_numpy(inputs),
                                        torch.from_numpy(lens), None,
                                        temperature=None, vocab_limit=vocab_limit)
        assert tt.tolist() == np.asarray(jt).tolist()
        assert tn.tolist() == np.asarray(jn).tolist()
        # temperature-0 rows of a sampling batch are greedy too
        temps = np.array([0.0, 0.8, 0.0, 1.2, 0.0, 0.0], np.float32)
        keys = torch.stack([torch.arange(6), torch.full((6,), 9)], 1)
        st, sn = sampler.accept_batched(torch.from_numpy(logits),
                                        torch.from_numpy(inputs),
                                        torch.from_numpy(lens), keys,
                                        temperature=torch.from_numpy(temps),
                                        vocab_limit=vocab_limit)
        greedy = temps == 0.0
        assert st[greedy].tolist() == np.asarray(jt)[greedy].tolist()
        assert sn[greedy].tolist() == np.asarray(jn)[greedy].tolist()
        if vocab_limit:
            assert int(st.max()) < vocab_limit


def _marginal(logits_row, draft_tok, top_k, n=4000):
    """Empirical distribution of the first emitted token when ``draft_tok``
    is proposed against ``logits_row``, over n request keys (one row each)."""
    V = len(logits_row)
    logits = torch.zeros(n, 2, V)
    logits[:, 0] = torch.tensor(logits_row)
    inputs = torch.tensor([[0, draft_tok]]).expand(n, 2)
    keys = torch.stack([torch.arange(n) * 7 + 1, torch.full((n,), 3)], 1)
    ks = None if top_k is None else torch.full((n,), top_k)
    out, _ = sampler.accept_batched(logits, inputs, torch.ones(n, dtype=torch.int32),
                                    keys, temperature=torch.ones(n), top_k=ks)
    return np.bincount(out[:, 0].numpy(), minlength=V) / n, out


def test_rejection_sampling_marginals_match_target():
    """The reference's distribution test (tests/test_spec_decode.py:131) on
    the port: accept-with-prob-p(d) + residual resampling leaves the first
    token's marginal equal to the target softmax, for a likely, an
    unlikely and a top-k-excluded draft; same keys give the same tokens,
    whatever the batch."""
    row = [1.0, 2.0, 0.5, -0.5, 1.5, 0.0, -1.0, 0.7]
    x = np.asarray(row)
    target = np.exp(x - x.max()) / np.exp(x - x.max()).sum()
    kth = np.sort(x)[-3]
    t3 = np.where(x >= kth, np.exp(x - x.max()), 0.0)
    t3 /= t3.sum()
    outs = {}
    for top_k, want in ((None, target), (3, t3)):
        for d in (1, 6):
            emp, outs[top_k, d] = _marginal(row, d, top_k)
            assert float(np.max(np.abs(emp - want))) < 0.03, (d, top_k, emp, want)
    # reproducible, and a row's draws do not depend on its batch
    _, again = _marginal(row, 6, None)
    assert torch.equal(outs[None, 6], again)
    sub = torch.arange(0, 4000, 37)
    logits = torch.zeros(len(sub), 2, 8)
    logits[:, 0] = torch.tensor(row)
    keys = torch.stack([sub * 7 + 1, torch.full((len(sub),), 3)], 1).flip(0)
    part, _ = sampler.accept_batched(logits, torch.tensor([[0, 6]]).expand(len(sub), 2),
                                     torch.ones(len(sub), dtype=torch.int32), keys,
                                     temperature=torch.ones(len(sub)))
    assert part.flip(0)[:, 0].tolist() == again[sub, 0].tolist()


# ---------------------------------------------------------------------------
# verify-mode helpers
# ---------------------------------------------------------------------------


def _kv(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_spec_cache_update_and_attention_match_jax():
    """Dense write-ahead (padded tail and out-of-range positions dropped)
    and spec_attention over the written cache."""
    rng = np.random.RandomState(0)
    B, W, K, hd, S, G = 3, 24, 2, 16, 5, 3
    kc, vc = _kv(rng, B, W, K, hd), _kv(rng, B, W, K, hd)
    kn, vn = _kv(rng, B, S, K, hd), _kv(rng, B, S, K, hd)
    clens = np.array([4, 17, 21], np.int32)           # row 2 runs past W
    valid = np.arange(S)[None, :] < np.array([[5], [2], [5]])
    jk, jv = jattn.spec_cache_update(jnp.asarray(kc), jnp.asarray(vc),
                                     jnp.asarray(kn), jnp.asarray(vn),
                                     jnp.asarray(clens), jnp.asarray(valid))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tattn.spec_cache_update(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                            torch.from_numpy(clens), torch.from_numpy(valid))
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    q = _kv(rng, B, S, K * G, hd)
    jo = jattn.spec_attention(jnp.asarray(q), jk, jv, jnp.asarray(clens), q_per_kv=G)
    to = tattn.spec_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(clens),
                              q_per_kv=G)
    assert _err(to, jo) < F32_TOL


def test_paged_spec_cache_update_and_attention_match_jax():
    """Paged write-ahead (invalid rows to trash page 0) and spec_attention
    over the gathered view, against JAX's update + paged_view."""
    from repro_torch.kernels.paged_spec_decode_attention import \
        paged_spec_attention_ref
    rng = np.random.RandomState(1)
    P, ps, K, hd, S, G = 14, 8, 2, 16, 4, 2
    pk, pv = _kv(rng, P, ps, K, hd), _kv(rng, P, ps, K, hd)
    bt = np.array([[3, 1, 7, 10], [2, 5, 0, 0], [9, 8, 6, 4]], np.int32)
    clens = np.array([13, 7, 30], np.int32)
    valid = np.arange(S)[None, :] < np.array([[4], [3], [0]])
    kn, vn = _kv(rng, 3, S, K, hd), _kv(rng, 3, S, K, hd)
    jk, jv = jattn.paged_spec_cache_update(
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(bt), jnp.asarray(clens), jnp.asarray(valid), ps)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tattn.paged_spec_cache_update(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                                  torch.from_numpy(bt), torch.from_numpy(clens),
                                  torch.from_numpy(valid), ps)
    live = sorted(set(range(1, P)))                   # trash page 0 aside
    assert np.array_equal(tk.numpy()[live], np.asarray(jk)[live])
    assert np.array_equal(tv.numpy()[live], np.asarray(jv)[live])
    q = _kv(rng, 3, S, K * G, hd)
    jo = jattn.spec_attention(jnp.asarray(q), jattn.paged_view(jk, jnp.asarray(bt)),
                              jattn.paged_view(jv, jnp.asarray(bt)),
                              jnp.asarray(clens), q_per_kv=G)
    # trash page 0 takes colliding writes in an unspecified order: attend
    # over the same page contents on both sides
    tk[0], tv[0] = torch.tensor(np.asarray(jk)[0]), torch.tensor(np.asarray(jv)[0])
    to = paged_spec_attention_ref(torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
                                  torch.from_numpy(clens), q_per_kv=G)
    assert _err(to, jo) < F32_TOL


# ---------------------------------------------------------------------------
# model verify
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qpair():
    return Pair("qwen2.5-3b")


def _prefilled(pair, n_rows, P, cap=48):
    toks = _toks(11, n_rows, P)
    jc = pair.jm.init_cache(n_rows, cap)
    _, jc = pair.jm.prefill(pair.jp, pair.jbatch(toks), jc, with_logits=False)
    tc = pair.tm.init_cache(n_rows, cap)
    pair.tm.prefill(pair.tp, pair.tbatch(toks), tc, with_logits=False)
    return jc, tc


def _paged_prefilled(pair, bts, lengths, ps=8, P=14):
    from repro.serving import kvpool as jkv
    jpool = jkv.init_paged_cache(pair.jcfg, P, ps)
    tpool = tkv.init_paged_cache(pair.cfg, P, ps, "cpu")
    for row, n in enumerate(lengths):
        toks = _toks(20 + row, 1, n)
        bt = bts[row:row + 1]
        _, jpool = pair.jm.extend(pair.jp, pair.jbatch(toks), jpool, jnp.int32(0),
                                  length=jnp.int32(n), block_tables=jnp.asarray(bt),
                                  with_logits=False)
        pair.tm.extend(pair.tp, pair.tbatch(toks), tpool, 0, length=n,
                       block_tables=torch.from_numpy(bt), with_logits=False)
    return jpool, tpool


def _verify_batch(clens, S, seed):
    toks = _toks(seed, len(clens), S)
    pos = clens[:, None] + np.arange(S, dtype=np.int32)[None, :]
    return toks, pos


@pytest.mark.parametrize("paged", [False, True])
def test_model_verify_logits_equal_jax(qpair, paged):
    """Per-row cache lengths and valid counts (a padded tail, a row
    sitting out with lens 0), dense and paged."""
    S = 5
    clens = np.array([9, 14, 6], np.int32)
    lens = np.array([5, 3, 0], np.int32)
    if paged:
        bt = np.array([[3, 1, 7], [2, 5, 11], [9, 0, 0]], np.int32)
        jc, tc = _paged_prefilled(qpair, bt, [9, 14, 6])
        jbt, tbt = jnp.asarray(bt), torch.from_numpy(bt)
    else:
        jc, tc = _prefilled(qpair, 3, 16)
        jbt = tbt = None
    toks, pos = _verify_batch(clens, S, 31)
    jl, _ = jtfm.verify(qpair.jp, {"tokens": jnp.asarray(toks),
                                   "positions": jnp.asarray(pos)}, qpair.jcfg, jc,
                        jnp.asarray(clens), lens=jnp.asarray(lens), block_tables=jbt)
    tl, _ = qpair.tm.verify(qpair.tp, {"tokens": torch.from_numpy(toks).long(),
                                       "positions": torch.from_numpy(pos).long()},
                            tc, torch.from_numpy(clens), lens=torch.from_numpy(lens),
                            block_tables=tbt)
    assert tl.shape == jl.shape
    for b, n in enumerate(lens[:2]):              # padded logits are garbage
        assert _err(tl[b, :n], np.asarray(jl)[b, :n]) < MODEL_TOL


@pytest.mark.parametrize("paged", [False, True])
def test_verify_logits_equal_successive_decode_steps(qpair, paged):
    """In the port: one verify forward over S tokens == S decode steps."""
    S = 5
    clens = np.array([9, 14], np.int32)
    toks, pos = _verify_batch(clens, S, 41)
    outs = []
    for how in ("verify", "decode"):
        if paged:
            bt = np.array([[3, 1, 7], [2, 5, 11]], np.int32)
            _, tc = _paged_prefilled(qpair, bt, [9, 14])
            tbt = torch.from_numpy(bt)
        else:
            _, tc = _prefilled(qpair, 2, 16)
            tbt = None
        if how == "verify":
            lg, _ = qpair.tm.verify(qpair.tp, {"tokens": torch.from_numpy(toks).long(),
                                               "positions": torch.from_numpy(pos).long()},
                                    tc, torch.from_numpy(clens),
                                    lens=torch.full((2,), S), block_tables=tbt)
        else:
            steps = []
            for i in range(S):
                b = {"tokens": torch.from_numpy(toks[:, i:i + 1]).long(),
                     "positions": torch.from_numpy(pos[:, i:i + 1]).long()}
                li, _ = qpair.tm.decode_step(qpair.tp, b, tc,
                                             torch.from_numpy(pos[:, i]),
                                             block_tables=tbt)
                steps.append(li[:, 0])
            lg = torch.stack(steps, 1)
        outs.append(lg)
    assert _err(outs[0], outs[1]) < 1e-4


# ---------------------------------------------------------------------------
# serving: spec == non-spec == JAX, greedy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def guarded(qpair):
    """(JAX params, the port's state dict) on the same weights, EOS row
    zeroed (ByteTokenizer eos_id = vocab_size - 1)."""
    jp = jax.tree.map(lambda a: a, qpair.jp)
    table = np.asarray(jp["embed"]["table"]).copy()
    table[qpair.cfg.vocab_size - 1] = 0.0
    jp["embed"]["table"] = jnp.asarray(table)
    sd = {k: v.clone() for k, v in qpair.tp.state_dict().items()}
    sd["embed.table"][qpair.cfg.vocab_size - 1] = 0.0
    return jp, sd


def _ecfg(mode, spec_len, cls=EngineConfig):
    return cls(cache_mode=mode, page_size=16, decode_chunk=4, spec_len=spec_len)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_spec_server_greedy_equals_plain_and_jax(qpair, guarded, mode):
    jp, sd = guarded
    jsrv = JServer(qpair.jcfg, num_slots=3, capacity=160, params=jp,
                   engine_cfg=_ecfg(mode, 0, JEngineConfig))
    jh = [jsrv.submit(p, JSamplingParams(max_new_tokens=40)) for p in COPY_PROMPTS]
    jsrv.run_until_idle()
    ref = [h.request.output_ids for h in jh]
    assert all(len(ids) == 40 for ids in ref), ref      # the EOS guard
    outs, stats = {}, {}
    for spec_len in (0, 6):
        srv = LLMServer(qpair.cfg, num_slots=3, capacity=160, params=sd,
                        device="cpu", engine_cfg=_ecfg(mode, spec_len))
        hs = [srv.submit(p, SamplingParams(max_new_tokens=40)) for p in COPY_PROMPTS]
        srv.run_until_idle()
        outs[spec_len] = [h.request.output_ids for h in hs]
        stats[spec_len] = srv.stats()
    assert outs[6] == outs[0] == ref
    st = stats[6]
    assert st["verify_steps"] > 0 and st["draft_tokens"] > 0
    assert st["accepted_tokens"] > 0 and 0.0 < st["acceptance_rate"] <= 1.0
    assert stats[0]["verify_steps"] == 0 and stats[0]["draft_tokens"] == 0


def test_spec_paged_cancels_leak_no_pages(qpair, guarded):
    """Speculative paged serving on a small pool (LRU eviction pressure),
    with requests cancelled queued and mid-decode: after the drain every
    page is owned exactly once (free list or radix tree), and verify steps
    really ran (the reference's test_spec_decode.py:414-463)."""
    import random
    _, sd = guarded
    srv = LLMServer(qpair.cfg, num_slots=3, capacity=96, params=sd, device="cpu",
                    engine_cfg=EngineConfig(cache_mode="paged", page_size=16,
                                            num_pages=16, spec_len=5,
                                            decode_chunk=4))
    eng = srv.engine
    pool = ["err 429 err 429 err 429. " + t for t in
            ("", "tail one", "go go go go go", "a longer tail that spills "
             "pages and repeats repeats repeats")]
    rng = random.Random(0)
    cancelled = 0
    for _ in range(4):
        hs = [srv.submit(pool[rng.randrange(4)],
                         SamplingParams(max_new_tokens=rng.randint(2, 20)))
              for _ in range(rng.randint(4, 8))]
        srv.step()
        srv.step()
        for h in hs[::3]:
            cancelled += bool(srv.cancel(h))
        srv.run_until_idle()
        assert all(s.request is None for s in eng.slots)
        owned = eng.radix.check_invariants()
        assert len(owned) + eng.kvpool.num_free == \
            eng.kvpool.num_pages - eng.kvpool.reserved
        assert not (owned & set(eng.kvpool._free))
    st = srv.stats()
    assert cancelled > 0 and st["cancelled_requests"] == cancelled
    assert st["verify_steps"] > 0 and st["draft_tokens"] > 0
