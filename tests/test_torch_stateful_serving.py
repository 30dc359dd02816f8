"""The port's serving stack on the stateful archs (xlstm-350m,
recurrentgemma-9b, and mixtral-8x22b: MoE with a sliding-window ring)
against repro.serving, and its own invariants.

* ``LLMServer`` greedy output ids equal the JAX package's on the same
  weights, in dense mode and in ``cache_mode="paged"``, which on these
  archs means per-prefix state snapshots (``kvpool.supports_snapshots``);
* snapshot == dense greedy with snapshot hits; a 2-turn session restores
  its tail state and equals a fresh prefill of the same stream; spec_len=4
  == spec_len=0 greedy through real verify steps; cancels leak no arena
  row; a done row's state stays bit for bit across a decode chunk.

EOS guard (ROADMAP.md queue 3): the EOS logit is pinned at 0 (xlstm ties
its embeddings: the EOS row of the table is zeroed; recurrentgemma and
mixtral are untied: the EOS column of ``unembed``), and every parity test
asserts the reference emitted its whole budget. mixtral's reduced config
routes drop-free (capacity factor 4.0): snapshot == dense, spec ==
non-spec and session reuse == fresh prefill group the tokens otherwise,
and hold only without drops. Small capacities and fixed
``prefill_buckets`` keep the JAX side to a few compiled programs.
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
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402
from repro_torch.serving.server import (EngineConfig, LLMServer,  # noqa: E402
                                        SamplingParams)

KW = dict(dtype="float32", param_dtype="float32", vocab_size=512)
ARCHS_UNDER_TEST = ["xlstm-350m", "recurrentgemma-9b", "mixtral-8x22b"]
SYS = "System: cooperating agents share this conversation verbatim. "
PROMPTS = [SYS + "[planner] plan the next step",
           SYS + "[actor] act: call the search tool now and report back",
           "third prompt"]
TURNS = ["[planner] Plan the next step of the task. ",
         "[actor] Act: call the search tool now. "]
COPY = ["Tool result: ERROR 429 rate limit exceeded at gateway. " * 2,
        "log: a=1 b=2; log: a=1 b=2; log: a=1 b=3; what changed?"]
ECFG = dict(page_size=16, decode_chunk=4, prefill_buckets=(32, 64))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite runs several
    workers side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _guard(jp, cfg, out_scale=1.0):
    """EOS guard (module docstring). ``out_scale`` scales the blocks'
    output projections and unembeds with the embedding's transpose: the
    random model then leans toward repeating its input, so the n-gram
    drafter's proposals are accepted part of the time."""
    jp = jax.tree.map(np.asarray, jp)
    if out_scale != 1.0 and not cfg.tie_embeddings:
        jp["unembed"]["table"] = jp["embed"]["table"].T.copy()
    if cfg.tie_embeddings:
        t = jp["embed"]["table"].copy()
        t[cfg.vocab_size - 1] = 0.0
        jp["embed"]["table"] = t
    else:
        t = jp["unembed"]["table"].copy()
        t[:, cfg.vocab_size - 1] = 0.0
        jp["unembed"]["table"] = t
    if out_scale != 1.0:
        def scale(path, x):
            last = getattr(path[-1], "key", None)
            return x * out_scale if last in ("wo", "w_down") else x
        jp = jax.tree_util.tree_map_with_path(scale, jp)
    return jp


class Arch:
    def __init__(self, name):
        self.jcfg = JARCHS[name].reduced(**KW)
        self.cfg = ARCHS[name].reduced(**KW)
        jp = JModel(self.jcfg).init(jax.random.PRNGKey(0))
        self.jp = jax.tree.map(jnp.asarray, _guard(jp, self.cfg))
        self.sd = params_from_jax(_guard(jp, self.cfg), self.cfg)
        # recurrentgemma's copying variant: partial accepts in verify
        self.sd_copy = params_from_jax(_guard(jp, self.cfg, 0.3), self.cfg)

    def server(self, params=None, **kw):
        kw.setdefault("num_slots", 3)
        kw.setdefault("capacity", 128)
        return LLMServer(self.cfg, params=params or self.sd, device="cpu", **kw)


@pytest.fixture(scope="module", params=ARCHS_UNDER_TEST)
def arch(request):
    return Arch(request.param)


def _serve(srv, prompts, n, sp_cls=SamplingParams):
    hs = [srv.submit(p, sp_cls(max_new_tokens=n)) for p in prompts]
    srv.run_until_idle()
    return [h.request.output_ids for h in hs]


# ---------------------------------------------------------------------------
# greedy parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_server_greedy_ids_equal_jax(arch, mode):
    """Three co-batched prompts, then the two that share the system prompt
    again (a snapshot hit in paged mode): output ids equal the JAX
    server's, and the reference generated its whole budget."""
    jsrv = JServer(arch.jcfg, num_slots=3, capacity=128, params=arch.jp,
                   engine_cfg=JEngineConfig(cache_mode=mode, **ECFG))
    ref = _serve(jsrv, PROMPTS, 10, JSamplingParams)
    ref += _serve(jsrv, PROMPTS[:2], 10, JSamplingParams)
    assert all(len(ids) == 10 for ids in ref), ref       # the EOS guard
    srv = arch.server(engine_cfg=EngineConfig(cache_mode=mode, **ECFG))
    got = _serve(srv, PROMPTS, 10)
    got += _serve(srv, PROMPTS[:2], 10)
    assert got == ref
    st = srv.stats()
    assert st["active_slots_per_step"] > 1.0
    if mode == "paged":
        assert st["snapshot_hits"] > 0 and st["snapshot_captures"] > 0
        assert st["snapshot_hits"] == jsrv.stats()["snapshot_hits"]


def test_snapshot_equals_dense_greedy(arch):
    outs, hits = {}, 0
    for mode in ("dense", "paged"):
        srv = arch.server(engine_cfg=EngineConfig(cache_mode=mode, **ECFG))
        shared = [SYS + t for t in TURNS] + [SYS + "[evaluator] judge it"]
        outs[mode] = _serve(srv, shared, 12) + _serve(srv, shared, 12)
        if mode == "paged":
            hits = srv.stats()["snapshot_hits"]
    assert hits > 0
    assert all(len(o) == 12 for o in outs["dense"])
    assert outs["paged"] == outs["dense"]


def test_session_tail_state_reuse_bit_identical(arch):
    """Turn 2 restores turn 1's end-of-generation tail snapshot and
    prefills only the new message; its output equals a fresh dense
    scheduler fed the same token stream."""
    srv = arch.server(num_slots=2, capacity=192,
                      engine_cfg=EngineConfig(cache_mode="paged", page_size=16))
    fresh = Scheduler(arch.cfg, num_slots=2, capacity=192, params=srv.params,
                      device="cpu")
    sess = srv.open_session()
    sp = SamplingParams(max_new_tokens=9)
    prompt, hits = SYS, []
    for turn in TURNS:
        prompt = sess.text + turn if sess.text else prompt + turn
        h = sess.submit(prompt, sp)
        out = h.result()
        assert len(h.request.output_ids) == 9
        r = fresh.enqueue(prompt, sp, token_ids=h.request._ids)
        fresh.run_until_drained()
        assert r.output_ids == h.request.output_ids and r.output_text == out
        hits.append(h.request.prefix_hit_tokens)
    st = srv.stats()
    assert st["session_turns"] == 2 and st["turn_prefix_hits"] >= 1
    assert hits[1] > 0 and st["snapshot_hits"] > 0
    sess.close()


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_spec_equals_non_spec_greedy(arch, mode):
    """spec_len=4 == spec_len=0, greedy, through real verify steps (the
    rewinds of every stateful block at each row's accepted length). xLSTM
    drafts from unigrams; recurrentgemma runs its copying weights, so
    drafts are partly accepted."""
    rg = arch.cfg.name.startswith("recurrentgemma")
    params = arch.sd_copy if rg else arch.sd
    extra = {} if rg else {"spec_ngram_min": 1}
    outs, st = {}, None
    for sl in (0, 4):
        srv = arch.server(params=params, engine_cfg=EngineConfig(
            cache_mode=mode, spec_len=sl, **ECFG, **extra))
        outs[sl] = _serve(srv, COPY + PROMPTS[:1], 30)
        if sl:
            st = srv.stats()
    assert all(len(o) == 30 for o in outs[0])
    assert outs[4] == outs[0]
    assert st["verify_steps"] > 0 and st["draft_tokens"] > 0
    if rg:
        assert 0 < st["accepted_tokens"] < st["draft_tokens"]


# ---------------------------------------------------------------------------
# arena ownership and the decode chunk's done rows
# ---------------------------------------------------------------------------


def _arena_check(srv):
    eng = srv.engine
    assert all(s.request is None for s in eng.slots)
    owned = eng.radix.check_invariants(snapshots=True)
    free = set(eng.snaps._free)
    tails = {s.tail_snap for s in eng._sessions.values() if s.tail_snap >= 0}
    assert not (owned & free) and not (owned & tails) and not (free & tails)
    assert len(owned) + len(free) + len(tails) == eng.snaps.num_snaps


def test_cancel_leaks_no_arena_rows(arch):
    """Cancel queued and mid-decode requests and a session turn on a small
    arena (LRU eviction pressure), spec on: every arena row ends owned
    exactly once (free list, radix tree or a session tail)."""
    srv = arch.server(num_slots=2, engine_cfg=EngineConfig(
        cache_mode="paged", page_size=8, num_snapshots=6, spec_len=3,
        decode_chunk=2, prefill_buckets=(32, 64)))
    sess = srv.open_session()
    sess.submit(SYS + TURNS[0], SamplingParams(max_new_tokens=6)).result()
    hs = [srv.submit(SYS + f"request {c} " * 2, SamplingParams(max_new_tokens=12))
          for c in "abcd"]
    h = sess.submit(sess.text + TURNS[1], SamplingParams(max_new_tokens=12))
    srv.step()
    assert srv.cancel(hs[3]) and srv.cancel(hs[0])
    srv.step()
    assert srv.cancel(h)
    srv.run_until_idle()
    assert hs[1].status().value == "completed"
    assert srv.stats()["cancelled_requests"] == 3
    _arena_check(srv)
    h2 = sess.submit(sess.text + TURNS[1], SamplingParams(max_new_tokens=4))
    h2.result()
    assert h2.request.prefix_hit_tokens > 0
    _arena_check(srv)
    st = srv.stats()
    assert st["snapshot_captures"] > 0 and st["snapshot_evictions"] > 0


def test_done_row_state_unchanged_across_decode_chunk(arch):
    """Fault 4: a row marked done at the start of a decode chunk (a
    finished slot, or a spec-handled slot sitting the chunk out) keeps
    every state leaf bit for bit while its neighbour decodes 4 steps."""
    srv = arch.server(num_slots=2, engine_cfg=EngineConfig(decode_chunk=4))
    eng = srv.engine
    for p in PROMPTS[:2]:
        srv.submit(p, SamplingParams(max_new_tokens=20))
    srv.step()                                       # admit both, one chunk
    assert all(s.request is not None for s in eng.slots)

    def rows(b):
        return [t.narrow(1 if k == "scan" else 0, b, 1).clone()
                for k in sorted(eng.cache) for t in ttfm.tree_leaves(eng.cache[k])]

    before = [rows(0), rows(1)]
    dev = lambda v, dt=torch.int32: torch.tensor(v, dtype=dt)      # noqa: E731
    last = dev([s.generated[-1] for s in eng.slots])
    clens = dev([s.cache_len for s in eng.slots])
    eng.cache, toks, emit, clens2, _, _ = eng.progs.decode_chunk(
        eng.params, eng.cache, last, clens, dev([9, 9]),
        dev([False, True], torch.bool), None, None, None,
        dev([s.prompt_len for s in eng.slots]))
    assert emit[:, 0].all() and not emit[:, 1].any()
    assert clens2.tolist() == [clens[0].item() + 4, clens[1].item()]
    for a, b in zip(rows(1), before[1]):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(rows(0), before[0]))
