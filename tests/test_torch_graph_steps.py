"""The port's decode and verify steps as static-buffer programs (CPU).

On the card each step is one captured CUDA graph over static buffers
(``repro_torch.serving.programs``), replayed per decode step and per verify
step; the CPU runs the same step functions eagerly. These tests hold them
on reduced float32 configs:

* a decode chunk (inputs staged, ``_decode_step`` run ``steps`` times)
  against the JAX package's ``_decode_chunk_fn`` on the same weights and
  inputs: equal ``tok_buf``, ``emit_buf``, ``clens``, ``rem`` and ``done``
  for a greedy chunk, then a chunk of greedy, sampled and top-k rows, in
  dense, paged and snapshot (xlstm-350m with ``cache_mode="paged"``) mode.
  The sampled rows run at a temperature where the noise cannot move the
  argmax, since the port's noise is a counter hash and not JAX's threefry
  bits; at real temperatures the chunk is held to the Python loop it was
  before it became a step program, on the port's own sampler;
* the staging across chunks: a server whose slot membership, block tables,
  keys and variant change between chunks gives that loop's ids, and the
  packed copy carries float32 by its bits and 32-bit keys whole;
* the verify step's ``out_tok`` / ``out_len`` against JAX's ``_verify_fn``,
  a greedy step and then a sampled one on the committed state;
* the replay accounting of the kernel launch counters, with a stub graph.
"""
import importlib
import pkgutil

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
import repro_torch.kernels as tkernels  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import sampler  # noqa: E402
from repro_torch.serving.server import (EngineConfig, LLMServer,  # noqa: E402
                                        SamplingParams)

KW = dict(dtype="float32", param_dtype="float32", vocab_size=512)
CHUNK = 4
MODES = {"dense": ("qwen2.5-3b", dict(cache_mode="dense")),
         "paged": ("qwen2.5-3b", dict(cache_mode="paged", page_size=16)),
         "snapshot": ("xlstm-350m", dict(cache_mode="paged", page_size=16))}
PROMPTS = ["alpha prompt for slot one",
           "a rather longer second prompt that crosses a bucket boundary",
           "err 429 err 429 err 429 err 429 err"]
BUDGETS = (6, 12, 3)
TINY = 1e-6         # a temperature whose noise cannot move the argmax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_WEIGHTS = {}


def _weights(name):
    """(JAX config, port config, JAX params, port state dict): the same
    numbers, with the EOS logit pinned at 0 so no row stops at EOS."""
    if name not in _WEIGHTS:
        jcfg, cfg = JARCHS[name].reduced(**KW), ARCHS[name].reduced(**KW)
        jp = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(0)))
        if cfg.tie_embeddings:
            t = jp["embed"]["table"].copy()
            t[cfg.vocab_size - 1] = 0.0
            jp["embed"]["table"] = t
        else:
            t = jp["unembed"]["table"].copy()
            t[:, cfg.vocab_size - 1] = 0.0
            jp["unembed"]["table"] = t
        _WEIGHTS[name] = (jcfg, cfg, jax.tree.map(jnp.asarray, jp),
                          params_from_jax(jp, cfg))
    return _WEIGHTS[name]


def _admitted(mode, *, jax_too=True, spec_len=0):
    """Schedulers (JAX, port) with PROMPTS prefilled into their 3 slots and
    nothing decoded yet; the slots agree."""
    name, ecfg = MODES[mode]
    jcfg, cfg, jp, sd = _weights(name)
    ecfg = dict(ecfg, decode_chunk=CHUNK, prefill_buckets=(32, 64),
                spec_len=spec_len)
    tsrv = LLMServer(cfg, num_slots=3, capacity=128, params=sd, device="cpu",
                     engine_cfg=EngineConfig(**ecfg))
    for p, n in zip(PROMPTS, BUDGETS):
        tsrv.submit(p, SamplingParams(max_new_tokens=n))
    tsrv.engine._admit()
    if not jax_too:
        return None, tsrv.engine
    jsrv = JServer(jcfg, num_slots=3, capacity=128, params=jp,
                   engine_cfg=JEngineConfig(**ecfg))
    for p, n in zip(PROMPTS, BUDGETS):
        jsrv.submit(p, JSamplingParams(max_new_tokens=n))
    jsrv.engine._admit()
    for js, ts in zip(jsrv.engine.slots, tsrv.engine.slots):
        assert ts.request is not None
        assert (js.generated, js.cache_len, js.prompt_len, js.remaining) == \
            (ts.generated, ts.cache_len, ts.prompt_len, ts.remaining)
    return jsrv.engine, tsrv.engine


def _carries(eng):
    sl = eng.slots
    return {"last": np.array([s.generated[-1] for s in sl], np.int32),
            "clens": np.array([s.cache_len for s in sl], np.int32),
            "rem": np.array([s.remaining for s in sl], np.int32),
            "done": np.zeros(len(sl), bool),
            "plens": np.array([s.prompt_len for s in sl], np.int32)}


def _steps(eng, x):
    """The scheduler's step bound: the most tokens a live row can emit."""
    return min(CHUNK, max((min(int(r), eng.capacity - 1 - int(c))
                           for r, c, d in zip(x["rem"], x["clens"], x["done"])
                           if not d), default=0))


def _next(x, out):
    """The carries after a chunk: ``out`` = (tok, emit, clens, rem, done)."""
    tok, emit = out[0], out[1]
    last = x["last"].copy()
    for b in range(len(last)):
        if emit[:, b].any():
            last[b] = tok[emit[:, b], b][-1]
    return dict(x, last=last, clens=out[2], rem=out[3], done=out[4])


def _jax_chunk(jeng, x, temps=None, top_ks=None):
    keys = jnp.stack([jax.random.PRNGKey(7 + b) for b in range(len(x["last"]))])
    out = jeng.progs._decode_chunk_jit(
        jeng.params, jeng.cache, jnp.asarray(x["last"]), jnp.asarray(x["clens"]),
        jnp.asarray(x["rem"]), jnp.asarray(x["done"]),
        None if temps is None else jnp.asarray(temps, jnp.float32),
        None if top_ks is None else jnp.asarray(top_ks, jnp.int32), keys,
        jnp.asarray(x["plens"]), jeng._decode_block_tables())
    jeng.cache = out[0]
    return [np.asarray(a) for a in out[1:]]


def _port_args(teng, x, temps=None, top_ks=None):
    keys = torch.tensor([s.request._key for s in teng.slots], dtype=torch.int64)
    t = torch.from_numpy
    return (teng.params, teng.cache, t(x["last"]), t(x["clens"]), t(x["rem"]),
            t(x["done"]),
            None if temps is None else torch.tensor(temps, dtype=torch.float32),
            None if top_ks is None else torch.tensor(top_ks, dtype=torch.int32),
            keys, t(x["plens"]), teng._decode_block_tables(), _steps(teng, x))


def _port_chunk(teng, x, temps=None, top_ks=None):
    out = teng.progs._decode_chunk_fn(*_port_args(teng, x, temps, top_ks))
    teng.cache = out[0]
    return [t.numpy().copy() for t in out[1:]]


def _loop_chunk(progs, params, cache, last, clens, rem, done, temps, top_ks,
                keys, plens, bt=None, steps=None):
    """The decode chunk as it was before it became a step program: a Python
    loop that rebinds its carries."""
    chunk, B = progs.engine_cfg.decode_chunk, progs.num_slots
    tok_buf = torch.zeros((chunk, B), dtype=torch.int32)
    emit_buf = torch.zeros((chunk, B), dtype=torch.bool)
    steps = chunk if steps is None else min(steps, chunk)
    for i in range(steps):
        batch = {"tokens": last[:, None].long(), "positions": clens[:, None].long()}
        logits, cache = progs.model.decode_step(
            params, batch, cache, clens, block_tables=bt,
            keep=~done if progs.freeze_done_rows else None)
        row_keys = None
        if temps is not None:
            row_keys = torch.stack([keys, (clens - plens + 1).long()], dim=-1)
        nxt = sampler.sample_batched(logits[:, 0], row_keys, temperature=temps,
                                     top_k=top_ks, vocab_limit=progs.cfg.vocab_size)
        emit = ~done
        step = emit.to(torch.int32)
        last = torch.where(emit, nxt, last)
        clens, rem = clens + step, rem - step
        done = done | (emit & ((rem <= 0) | (nxt == progs.eos_id)
                               | (clens >= progs.capacity - 1)))
        tok_buf[i] = torch.where(emit, nxt, torch.zeros_like(nxt))
        emit_buf[i] = emit
    return cache, tok_buf, emit_buf, clens, rem, done


def _clone(cache):
    return ttfm.tree_map(lambda t: t.clone(), cache)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# the decode step against the JAX package's decode chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
def test_decode_step_chunks_equal_jax(mode):
    """A greedy chunk, then a chunk of a greedy, a sampled and a top-k row
    (variant "top_k") on the state it left: tok_buf, emit_buf, clens, rem
    and done equal the JAX chunk's; a row's budget ends inside the first
    chunk and it sits the second one out (done)."""
    jeng, teng = _admitted(mode)
    if mode == "paged":
        np.testing.assert_array_equal(np.asarray(jeng._decode_block_tables()),
                                      teng._decode_block_tables().numpy())
    x = _carries(teng)
    want, got = _jax_chunk(jeng, x), _port_chunk(teng, x)
    _same(got, want)
    assert got[1].any() and got[4][2] and not got[4][1]
    x = _next(x, got)
    temps, top_ks = [0.0, TINY, TINY], [0, 0, 5]
    want = _jax_chunk(jeng, x, temps, top_ks)
    got = _port_chunk(teng, x, temps, top_ks)
    _same(got, want)
    assert got[1][:, 1].all() and not got[1][:, 2].any()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_decode_step_equals_the_loop_at_real_temperatures(mode):
    """Sampled rows at real temperatures (top-k, then plain sampling, then
    greedy): the step program's tokens, carries and cache equal the loop's
    on a copy of the same cache, chunk after chunk."""
    _, teng = _admitted(mode, jax_too=False)
    x = _carries(teng)
    for temps, top_ks in (([0.9, 0.0, 1.3], [7, 0, 3]), ([0.7, 1.1, 0.0], None),
                          (None, None)):
        args = _port_args(teng, x, temps, top_ks)
        ref_cache = _clone(teng.cache)
        ref = _loop_chunk(teng.progs, args[0], ref_cache, *args[2:])
        got = _port_chunk(teng, x, temps, top_ks)
        _same(got, [t.numpy() for t in ref[1:]])
        for a, b in zip(ttfm.tree_leaves(teng.cache), ttfm.tree_leaves(ref[0])):
            assert torch.equal(a, b)
        x = _next(x, got)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_chunk_stops_once_every_row_is_done(mode):
    """Rows that stop at different steps, one at EOS: the chunk runs the
    steps of the JAX loop (which exits once every row is done), fewer than
    its step bound, with equal buffers and carries."""
    jeng, teng = _admitted(mode)
    x = dict(_carries(teng), rem=np.full(3, 12, np.int32))
    steps = _steps(teng, x)
    args = _port_args(teng, x)
    probe = _loop_chunk(teng.progs, args[0], _clone(teng.cache), *args[2:])
    tok = probe[1].numpy()
    # a row r whose token k (k >= 1) is new in it stops there at EOS; the
    # other two stop at their budgets after one and two steps
    r, k = next((r, k) for r in range(3) for k in (1, 2)
                if tok[k, r] not in tok[:k, r])
    eos = int(tok[k, r])
    x["rem"] = np.array([1, 2, 2], np.int32)
    x["rem"][r] = 12
    x["rem"][(r + 1) % 3] = 1
    jeng.progs.eos_id = teng.progs.eos_id = eos
    before = teng.progs.decode_steps
    want, got = _jax_chunk(jeng, x), _port_chunk(teng, x)
    _same(got, want)
    ran = teng.progs.decode_steps - before
    assert ran == int(want[1].any(axis=1).sum()) == k + 1 < steps
    assert int(teng.progs.chunk_steps()) == ran
    assert got[4].all() and got[0][k, r] == eos


# ---------------------------------------------------------------------------
# staging across chunks
# ---------------------------------------------------------------------------


def test_staging_packs_bits_and_replaces_block_tables_and_keys():
    """Two chunks with other block tables, keys and temperatures: the static
    buffers hold the second call's values exactly (float32 by its bits,
    32-bit keys whole); CPU tensors and host lists stage alike."""
    _, teng = _admitted("paged", jax_too=False)
    x = _carries(teng)
    progs = teng.progs
    args = list(_port_args(teng, x, [0.1, 1 / 3, 2.5], [0, 4, 9]))
    progs._decode_chunk_fn(*args)
    b = progs._bufs["decode"]
    bt2 = args[10].flip(0).contiguous()
    keys2 = [2 ** 32 - 1, 0, 123456789]
    temps2 = [1e-6, 0.7, 3.0]
    args[0:2] = teng.params, _clone(teng.cache)
    args[6], args[7], args[8], args[10] = temps2, [3, 0, 1], keys2, bt2
    progs._decode_chunk_fn(*args)
    assert progs._bufs["decode"] is b
    assert torch.equal(b["bt"], bt2)
    assert b["keys"].tolist() == keys2
    assert torch.equal(b["temps"], torch.tensor(temps2, dtype=torch.float32))
    assert b["top_ks"].tolist() == [3, 0, 1]


@pytest.mark.parametrize("mode", ["paged", "snapshot"])
def test_restaged_chunks_equal_the_loop(mode):
    """Two slots, five requests (greedy, sampled, top-k, with seeds): slot
    membership, block tables, keys and the variant change between chunks,
    and every request's ids equal those of the same server running the
    loop as its decode chunk."""
    name, ecfg = MODES[mode]
    _, cfg, _, sd = _weights(name)
    params = [SamplingParams(max_new_tokens=7),
              SamplingParams(max_new_tokens=9),
              SamplingParams(max_new_tokens=9, temperature=0.9, seed=3),
              SamplingParams(max_new_tokens=5, temperature=1.1, top_k=5, seed=4),
              SamplingParams(max_new_tokens=6, temperature=0.8, seed=5)]
    prompts = PROMPTS + ["fourth prompt here", "fifth and last prompt"]
    out, variants = {}, set()
    for how in ("step", "loop"):
        srv = LLMServer(cfg, num_slots=2, capacity=128, params=sd, device="cpu",
                        engine_cfg=EngineConfig(decode_chunk=CHUNK,
                                                prefill_buckets=(32, 64), **ecfg))
        progs = srv.engine.progs
        if how == "loop":
            progs._decode_chunk_fn = lambda *a, p=progs: _loop_chunk(p, *a)
        else:
            run = progs._run_steps

            def spy(program, variant, *a, run=run):
                variants.add(variant)
                return run(program, variant, *a)
            progs._run_steps = spy
        hs = [srv.submit(p, sp) for p, sp in zip(prompts, params)]
        srv.run_until_idle()
        out[how] = [h.request.output_ids for h in hs]
        assert [len(o) for o in out[how]] == [sp.max_new_tokens for sp in params]
    assert out["step"] == out["loop"]
    assert variants == {"greedy", "sampled", "top_k"}


# ---------------------------------------------------------------------------
# the verify step against the JAX package's verify
# ---------------------------------------------------------------------------


def _verify_inputs(teng, drafts, lens):
    S = 5
    toks = np.zeros((3, S), np.int32)
    for b, d in enumerate(drafts):
        row = [teng.slots[b].generated[-1]] + list(d)
        toks[b, :len(row)] = row
    clens = np.array([s.cache_len for s in teng.slots], np.int32)
    return toks, clens, np.array(lens, np.int32)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_verify_step_equals_jax(mode):
    """A greedy verify step (a row whose 4 drafts are its greedy
    continuation, one whose third draft is wrong, one sitting out), then a
    sampled one (tiny temperatures, top-k on one row) on the committed
    state: out_tok and out_len equal the JAX verify's."""
    jeng, teng = _admitted(mode, spec_len=4)
    x = _carries(teng)
    args = _port_args(teng, x)
    greedy = _loop_chunk(teng.progs, args[0], _clone(teng.cache), *args[2:10],
                         args[10], 4)[1].numpy().T
    drafts = [greedy[0], list(greedy[1][:2]) + [(greedy[1][2] + 1) % 500,
                                                greedy[1][3]], []]
    bt_j, bt_t = jeng._decode_block_tables(), teng._decode_block_tables()
    for step, (temps, top_ks) in enumerate(((None, None),
                                            ([TINY, TINY, 0.0], [0, 3, 0]))):
        toks, clens, lens = _verify_inputs(teng, drafts, [5, 5, 0])
        jkeys = None if temps is None else jax.random.PRNGKey(5)
        jc, jtok, jlen = jeng.progs._verify_jit(
            jeng.params, jeng.cache, jnp.asarray(toks), jnp.asarray(clens),
            jnp.asarray(lens), None if temps is None else jnp.asarray(temps, jnp.float32),
            None if top_ks is None else jnp.asarray(top_ks, jnp.int32), jkeys, bt_j)
        jeng.cache = jc
        tkeys = None if temps is None else torch.tensor(
            [[s.request._key, s.cache_len - s.prompt_len + 1] for s in teng.slots])
        tc, ttok, tlen = teng.progs._verify_fn(
            teng.params, teng.cache, torch.from_numpy(toks), torch.from_numpy(clens),
            torch.from_numpy(lens), temps, top_ks, tkeys, bt_t)
        teng.cache = tc
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
        if step == 0:
            assert tlen.tolist()[:2] == [5, 3]
        n = tlen.numpy()
        for b, s in enumerate(teng.slots[:2]):      # commit as the scheduler
            s.generated.extend(int(t) for t in ttok[b, :n[b]])
            s.cache_len += int(n[b])
        drafts = [[s.generated[-1]] * 4 for s in teng.slots[:2]] + [[]]
    assert teng.progs.verify_steps == 2


# ---------------------------------------------------------------------------
# launch counters across replays
# ---------------------------------------------------------------------------


def test_replay_counts_the_launches_of_its_capture():
    """What the wrappers count during a capture stays off the counters (no
    launch ran on the device) and goes on at every replay of a stub graph;
    a capture that raises leaves the counters as they were too."""
    from repro_torch.kernels import rglru_scan, spec_scan

    class Stub:
        replays = 0

        def replay(self):
            self.replays += 1

    before = launch_counts.snapshot()
    launches = {}
    with launch_counts.captured(launches):
        launch_counts.count(spec_scan.__name__)
        launch_counts.count(spec_scan.__name__)
        launch_counts.count(rglru_scan.__name__, "sequential")
    assert launch_counts.snapshot() == before
    assert launches == {("spec_scan", ""): 2, ("rglru_scan", ""): 1,
                        ("rglru_scan", "sequential"): 1}
    graph = launch_counts.Replayed(Stub(), launches)
    for _ in range(3):
        graph.replay()
    after = launch_counts.snapshot()
    assert graph.graph.replays == 3
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == \
        {k: 3 * n for k, n in launches.items()}
    launch_counts.add(launches, -3)
    with pytest.raises(RuntimeError):
        with launch_counts.captured({}):
            launch_counts.count(spec_scan.__name__)
            raise RuntimeError("capture failed")
    assert launch_counts.snapshot() == before


def test_every_counting_wrapper_is_accounted():
    """Every kernel module with a ``launches`` counter is in the launch
    accounting's table of modules."""
    counting = set()
    for info in pkgutil.iter_modules(tkernels.__path__):
        m = importlib.import_module(f"repro_torch.kernels.{info.name}")
        if hasattr(m, "launches"):
            counting.add(info.name)
    assert counting == set(launch_counts.NAMES)
