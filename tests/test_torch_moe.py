"""The port's MoE FFN and the MoE archs (mixtral-8x22b, dbrx-132b) against
repro.models / repro.serving on the CPU.

* ``route`` and ``apply_moe`` against ``repro.models.moe`` on the same
  seeded inputs **with capacity drops** (capacity factors 1.0 and 1.25,
  groups of 32 with a zero-padded last group, E 4 / 8, k 2 / 4), float32
  and bf16: dispatch masks equal, combine within 1e-6, outputs within
  2e-5 (float32) and 2e-2 (bf16), aux within 1e-6. A token's output
  depends on the other tokens of its group once a token drops, so the
  groups are the same on both sides;
* a model with drops (reduced mixtral at capacity factor 1.0): padded
  prefill logits equal JAX's, the bucket padding routed as the reference
  routes it;
* the sliding-window ring: decode past the window against one full
  forward (the port's ``test_swa_ring_cache_decode``), and chunked prefill
  == single-shot through ``LLMServer`` (drop-free reduced config,
  capacity factor 4.0: the equality holds only without drops);
* dbrx-132b's verify logits (dense and paged) and ``LLMServer`` greedy
  ids (dense, and paged: KV pages with radix sharing) equal JAX's;
* the MoE leaves' init rules and the parameter count against
  ``ModelConfig.param_count``.

EOS guard as in tests/test_torch_serving.py: the EOS column of the untied
``unembed`` is zeroed and the reference must emit its whole budget.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving.server import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.server import LLMServer as JServer  # noqa: E402
from repro.serving.server import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.server import (EngineConfig, LLMServer,  # noqa: E402
                                        SamplingParams)

KW = dict(dtype="float32", param_dtype="float32", vocab_size=512)
OUT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (experts, top-k): mixtral's 8/2, dbrx's top-4 of 8 and the reduced 4/2
ROUTING = [(4, 2), (8, 2), (8, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite runs several
    workers side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **over):
    kw = dict(KW, **over)
    return JARCHS[arch].reduced(**kw), ARCHS[arch].reduced(**kw)


def _f32(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def _err(a, b):
    return float(np.max(np.abs(_f32(a) - _f32(b))))


def _moe_case(E, k, cf, dtype, seed=0):
    """Configs with groups of 32, one MoE layer's leaves in both packages
    (the same numbers) and an input of 3 x 30 tokens: groups 32, 32 and
    26 + 6 zero rows. The expert leaves are drawn at the JAX init rule's
    scale (fan-in E x D, or E x F) and the tokens at a norm's output
    scale (RMS 1); the router is scaled up and the tokens share one
    direction, so that choices crowd onto a few experts and drop."""
    jcfg, cfg = _cfgs("mixtral-8x22b", num_experts=E, experts_per_token=k,
                      capacity_factor=cf, moe_group_size=32)
    rs = np.random.RandomState(seed)
    D, Fd = cfg.d_model, cfg.d_ff
    leaves = {"router": rs.randn(D, E) * 4.0 / np.sqrt(D),
              "wi": rs.randn(E, D, Fd) / np.sqrt(E * D),
              "wg": rs.randn(E, D, Fd) / np.sqrt(E * D),
              "wo": rs.randn(E, Fd, D) / np.sqrt(E * Fd)}
    x = (rs.randn(3, 30, D) + rs.randn(D)) / np.sqrt(2.0)
    jp = {n: jnp.asarray(v, JDT[dtype]) for n, v in leaves.items()}
    tp = tmoe.MoE(cfg, device="cpu", dtype=TDT[dtype])
    for n, v in leaves.items():
        getattr(tp, n).data.copy_(torch.tensor(np.asarray(jp[n], np.float32)))
    jx = jnp.asarray(x, JDT[dtype])
    tx = torch.tensor(np.asarray(jx, np.float32)).to(TDT[dtype])
    return jcfg, cfg, jp, tp, jx, tx


def test_capacity_equals_jax():
    for E, k in ROUTING:
        for cf in (1.0, 1.25, 4.0):
            jcfg, cfg = _cfgs("mixtral-8x22b", num_experts=E,
                              experts_per_token=k, capacity_factor=cf)
            assert [tmoe.capacity(cfg, g) for g in range(1, 600)] == \
                [jmoe.capacity(jcfg, g) for g in range(1, 600)]
    # the published mixtral config: prefill groups drop, decode rows cannot
    full = ARCHS["mixtral-8x22b"]
    assert tmoe.capacity(full, 512) == 160 and tmoe.capacity(full, 4) == 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.0, 1.25])
@pytest.mark.parametrize("E,k", ROUTING)
def test_route_equals_jax_with_drops(E, k, cf, dtype):
    jcfg, cfg, jp, tp, jx, tx = _moe_case(E, k, cf, dtype)
    G = 32
    jxg = jnp.pad(jx.reshape(90, -1), ((0, 6), (0, 0))).reshape(3, G, -1)
    txg = torch.nn.functional.pad(tx.reshape(90, -1), (0, 0, 0, 6)).reshape(3, G, -1)
    jd, jc, ja = jmoe.route(jp["router"], jxg, jcfg)
    td, tc, ta = tmoe.route(tp.router, txg, cfg)
    assert td.dtype == tc.dtype == torch.bfloat16
    assert tuple(td.shape) == tuple(jd.shape) == (3, G, E, tmoe.capacity(cfg, G))
    assert np.array_equal(_f32(td), _f32(jd))
    kept = int(_f32(td).sum())
    assert kept < 96 * k, "no (token, choice) pair dropped"
    assert _err(tc, jc) < 1e-6
    assert abs(float(ta) - float(ja)) < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.0, 1.25])
@pytest.mark.parametrize("E,k", ROUTING)
def test_apply_moe_equals_jax_with_drops(E, k, cf, dtype):
    jcfg, cfg, jp, tp, jx, tx = _moe_case(E, k, cf, dtype)
    jy, ja = jmoe.apply_moe(jp, jx, jcfg)
    ty, ta = tmoe.apply_moe(tp, tx, cfg)
    assert ty.dtype == tx.dtype and tuple(ty.shape) == tuple(jy.shape)
    assert _err(ty, jy) < OUT_TOL[dtype]
    # and within a few roundings of the output's scale (bf16: 4 ulps)
    assert _err(ty, jy) <= 2.0 ** -6 * float(np.abs(_f32(jy)).max())
    assert abs(float(ta) - float(ja)) < 1e-6
    # two tokens alone: one group of 2, no padding, no drops
    solo, _ = tmoe.apply_moe(tp, tx[:1, :2], cfg)
    jsolo, _ = jmoe.apply_moe(jp, jx[:1, :2], jcfg)
    assert _err(solo, jsolo) < OUT_TOL[dtype]


def test_model_with_drops_prefill_equals_jax():
    """Reduced mixtral at capacity factor 1.0 (groups of 32 drop tokens): a
    29-token prompt right-padded to 40 routes its padding as the reference
    does, so the last real logits and the ring K/V agree."""
    jcfg, cfg = _cfgs("mixtral-8x22b", capacity_factor=1.0)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tm = Model(cfg, device="cpu")
    tp = tm.load(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    toks = np.random.RandomState(4).randint(0, 500, (1, 40)).astype(np.int32)
    jc = jm.init_cache(1, 64)
    jl, jc = jm.prefill(jp, jm.make_batch(jnp.asarray(toks)), jc,
                        length=jnp.int32(29), with_logits="last")
    tc = tm.init_cache(1, 64)
    tl, tc = tm.prefill(tp, tm.make_batch(torch.from_numpy(toks).long()), tc,
                        length=29, with_logits="last")
    assert _err(tl, jl) < 3e-4
    for a, b in zip(jax.tree.leaves(jc), ttfm.tree_leaves(tc)):
        assert _err(a, b) < 1e-4
    # the groups drop here: the router sends more of 32 tokens to one expert
    # than the capacity takes
    xg = tp.embed.table[torch.from_numpy(toks).long()][:, :32]
    d, _, _ = tmoe.route(tp.blocks[0].moe.router, xg, cfg)
    assert int(d.float().sum()) < 32 * cfg.experts_per_token


def test_swa_ring_cache_decode():
    """The port's counterpart of tests/test_arch_smoke.py::
    test_swa_ring_cache_decode: reduced mixtral (window 16) prefills 24
    tokens into a 16-slot ring and decodes one step past the window; the
    step's logits equal one full forward's and JAX's decode logits."""
    jcfg, cfg = _cfgs("mixtral-8x22b")
    assert cfg.sliding_window == 16
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu")
    params = model.load(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    S = 24
    inp = np.random.RandomState(1).randint(0, 500, (1, S + 1)).astype(np.int32)
    t = torch.from_numpy(inp).long()
    full, _, _ = ttfm.forward_logits(params, model.make_batch(t), cfg, mode="train")
    cache = model.init_cache(1, S + 1)
    assert cache["scan"]["sub0"]["k"].shape[2] == 16      # window-capped ring
    model.prefill(params, model.make_batch(t[:, :S]), cache)
    dec, _ = model.decode_step(params, model.make_batch(t[:, S:], start=S), cache,
                               torch.tensor(S, dtype=torch.int32))
    assert float((dec[:, 0] - full[:, S]).abs().max()) < 2e-3
    jc = jm.init_cache(1, S + 1)
    _, jc = jm.prefill(jp, jm.make_batch(jnp.asarray(inp[:, :S])), jc)
    jdec, _ = jm.decode_step(jp, jm.make_batch(jnp.asarray(inp[:, S:]), start=S),
                             jc, jnp.array(S, jnp.int32))
    assert _err(dec, jdec) < 3e-4


def _guard(jp, cfg):
    """EOS guard: the EOS column of the untied unembed is zeroed."""
    jp = jax.tree.map(np.asarray, jp)
    t = jp["unembed"]["table"].copy()
    t[:, cfg.vocab_size - 1] = 0.0
    jp["unembed"]["table"] = t
    return jp


def test_chunked_prefill_exact_for_mixtral():
    """The port's counterpart of tests/test_serving_fastpath.py::
    test_chunked_prefill_exact_for_stateful_archs[mixtral-8x22b]: prompts
    prefilled in 32-token chunks (extend ring-splices the windowed K/V)
    give the single-shot server's greedy ids. Drop-free (capacity factor
    4.0): with drops the groups of a chunk differ from a single shot's."""
    _, cfg = _cfgs("mixtral-8x22b")
    assert tmoe.capacity(cfg, cfg.moe_group_size) >= cfg.moe_group_size
    jp = JModel(_cfgs("mixtral-8x22b")[0]).init(jax.random.PRNGKey(0))
    sd = params_from_jax(_guard(jp, cfg), cfg)
    prompts = ["short one",
               "a much longer prompt crossing the recurrent conv window and "
               "the local attention window and the bucket boundary at once"]
    outs = {}
    for name, buckets in (("single", None), ("chunked", (32,))):
        srv = LLMServer(cfg, num_slots=2, capacity=96, params=sd, device="cpu",
                        engine_cfg=EngineConfig(prefill_buckets=buckets))
        hs = [srv.submit(p, SamplingParams(max_new_tokens=6)) for p in prompts]
        srv.run_until_idle()
        outs[name] = [h.request.output_ids for h in hs]
        if buckets:
            assert srv.stats()["extend_chunks"] >= 1
    assert all(len(o) == 6 for o in outs["single"])
    assert outs["chunked"] == outs["single"]


@pytest.mark.parametrize("paged", [False, True])
def test_dbrx_verify_logits_equal_jax(paged):
    """dbrx's verify forward: S = 5 inputs at per-row cache lengths (9, 14,
    6), a padded tail (lens 3) and a row sitting out (lens 0), dense and
    through block tables; the valid logits equal JAX's within 1e-4, the
    bound of tests/test_torch_model.py's float32 parity."""
    from repro.serving import kvpool as jkv
    from repro_torch.serving import kvpool as tkv
    jcfg, cfg = _cfgs("dbrx-132b")
    jm, tm = JModel(jcfg), Model(cfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tm.load(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    rs = np.random.RandomState(11)
    clens = np.array([9, 14, 6], np.int32)
    lens = np.array([5, 3, 0], np.int32)
    if paged:
        ps, bt = 8, np.array([[3, 1, 7], [2, 5, 11], [9, 0, 0]], np.int32)
        jc = jkv.init_paged_cache(jcfg, 14, ps)
        tc = tkv.init_paged_cache(cfg, 14, ps, "cpu")
        for row, n in enumerate(clens):
            toks = rs.randint(0, 500, (1, n)).astype(np.int32)
            row_bt = bt[row:row + 1]
            _, jc = jm.extend(jp, jm.make_batch(jnp.asarray(toks)), jc, jnp.int32(0),
                              length=jnp.int32(n), block_tables=jnp.asarray(row_bt),
                              with_logits=False)
            tm.extend(tp, tm.make_batch(torch.from_numpy(toks).long()), tc, 0,
                      length=int(n), block_tables=torch.from_numpy(row_bt),
                      with_logits=False)
        jbt, tbt = jnp.asarray(bt), torch.from_numpy(bt)
    else:
        toks = rs.randint(0, 500, (3, 16)).astype(np.int32)
        jc = jm.init_cache(3, 48)
        _, jc = jm.prefill(jp, jm.make_batch(jnp.asarray(toks)), jc, with_logits=False)
        tc = tm.init_cache(3, 48)
        tm.prefill(tp, tm.make_batch(torch.from_numpy(toks).long()), tc,
                   with_logits=False)
        jbt = tbt = None
    toks = rs.randint(0, 500, (3, 5)).astype(np.int32)
    pos = clens[:, None] + np.arange(5, dtype=np.int32)[None, :]
    jl, _ = jtfm.verify(jp, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)},
                        jcfg, jc, jnp.asarray(clens), lens=jnp.asarray(lens),
                        block_tables=jbt)
    tl, _ = tm.verify(tp, {"tokens": torch.from_numpy(toks).long(),
                           "positions": torch.from_numpy(pos).long()},
                      tc, torch.from_numpy(clens), lens=torch.from_numpy(lens),
                      block_tables=tbt)
    assert tl.shape == jl.shape
    for b, n in enumerate(lens[:2]):              # padded logits are garbage
        assert _err(tl[b, :n], np.asarray(jl)[b, :n]) < 1e-4


PROMPTS = ["System: cooperating agents share this conversation. [planner] plan",
           "System: cooperating agents share this conversation. [actor] act now",
           "third prompt"]
ECFG = dict(page_size=16, decode_chunk=4, prefill_buckets=(32, 64))


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_dbrx_server_greedy_ids_equal_jax(mode):
    """dbrx-132b (layernorm, top-k of 4 experts): three co-batched prompts,
    then the two sharing a system prompt again (KV-page prefix hits in
    paged mode); output ids equal the JAX server's."""
    jcfg, cfg = _cfgs("dbrx-132b")
    jp = _guard(JModel(jcfg).init(jax.random.PRNGKey(0)), cfg)
    jsrv = JServer(jcfg, num_slots=3, capacity=128,
                   params=jax.tree.map(jnp.asarray, jp),
                   engine_cfg=JEngineConfig(cache_mode=mode, **ECFG))
    ref = []
    for batch in (PROMPTS, PROMPTS[:2]):
        hs = [jsrv.submit(p, JSamplingParams(max_new_tokens=10)) for p in batch]
        jsrv.run_until_idle()
        ref += [h.request.output_ids for h in hs]
    assert all(len(ids) == 10 for ids in ref), ref       # the EOS guard
    srv = LLMServer(cfg, num_slots=3, capacity=128, params=params_from_jax(jp, cfg),
                    device="cpu", engine_cfg=EngineConfig(cache_mode=mode, **ECFG))
    got = []
    for batch in (PROMPTS, PROMPTS[:2]):
        hs = [srv.submit(p, SamplingParams(max_new_tokens=10)) for p in batch]
        srv.run_until_idle()
        got += [h.request.output_ids for h in hs]
    assert got == ref
    st = srv.stats()
    assert st["active_slots_per_step"] > 1.0
    if mode == "paged":
        assert st["prefix_hit_tokens"] > 0
        assert st["prefix_hit_tokens"] == jsrv.stats()["prefix_hit_tokens"]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def test_moe_init_follows_jax_init_rules():
    """The MoE leaves are "scaled": the fan-in counts E and the scan axis
    (4 scanned layers). Same rules, not the same bits: standard deviations
    within 25%, means near 0."""
    jcfg, cfg = _cfgs("mixtral-8x22b", num_layers=4)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    sd = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    own = Model(cfg, device="cpu").init(seed=0).state_dict()
    assert set(sd) == set(own)
    moe_keys = [k for k in sd if ".moe." in k]
    assert sorted({k.split(".")[-1] for k in moe_keys}) == ["router", "wg", "wi", "wo"]
    for k in moe_keys:
        a, b = sd[k].double(), own[k].double()
        assert tuple(a.shape) == tuple(b.shape), k
        ratio = float(b.std() / a.std())
        assert 0.75 < ratio < 1.33, (k, ratio)
        bound = 5 * float(a.std()) / a.numel() ** 0.5
        assert abs(float(b.mean())) < bound, k


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dbrx-132b"])
def test_param_count_agrees_with_model_config(arch):
    """The port's leaves at full width against the analytic count, which
    leaves out the final norm and the layernorm biases (dbrx): those are
    added here, nothing else differs."""
    cfg = dataclasses.replace(ARCHS[arch])
    n = Model(cfg, device="cpu").param_count()
    norms = cfg.d_model                                   # final_norm.scale
    if cfg.norm_type == "layernorm":
        norms += cfg.d_model * (1 + 2 * cfg.num_layers)   # every bias
    assert n == cfg.param_count() + norms
    assert n == JARCHS[arch].param_count() + norms
