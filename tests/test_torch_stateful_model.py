"""The port's stateful archs (xlstm-350m, recurrentgemma-9b, and
mixtral-8x22b, whose sliding window keeps its K/V in a ring) against
repro.models on the CPU.

Reduced configs: xlstm-350m at 8 layers (one 7 mLSTM + 1 sLSTM period),
recurrentgemma-9b at 5 layers (R R A scanned + an R R tail), mixtral at 2
MoE layers with a 16-slot window (drop-free capacity factor 4.0, so the
verify and decode-step comparisons hold whatever the token grouping),
float32, the JAX init carried over by ``convert.params_from_jax``. Same
numpy inputs through both packages, in every mode: train, right-padded
prefill (logits and every cache leaf: RG-LRU h, conv windows, mLSTM (C, n,
m), sLSTM state, ring K/V), decode, dense extend past the window (the ring
wraps), and verify followed by ``verify_commit`` at per-row accepted
lengths.

Bounds: logits 3e-4 absolute (the JAX package's kernel-vs-XLA model bound
is 3e-3, tests/test_kernels.py:196; float32 allows ten times tighter),
cache leaves 1e-4 relative to the leaf's largest magnitude (sLSTM's
normaliser and stabiliser grow to ~10-20 and move by ~1e-6 relative per
step under another reduction order). mixtral: 2e-3 for both, the JAX
package's own bound for its ring decode (tests/test_arch_smoke.py:
test_swa_ring_cache_decode). The reference rounds the MoE input to bf16
even in float32 (``repro.models.moe``, ``xg.astype(bfloat16)``), so the
~1e-6 float32 difference of the two packages' reduction orders flips one
bf16 rounding now and then (one element of 128 in the decode test), and a
flip moves the next layer's input by ~3e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.programs import slot_extract  # noqa: E402

LOGIT_BOUND, LEAF_BOUND = 3e-4, 1e-4
MOE_BOUND = 2e-3
ARCHS_UNDER_TEST = ["xlstm-350m", "recurrentgemma-9b", "mixtral-8x22b"]
KW = dict(dtype="float32", param_dtype="float32", vocab_size=512)


def _cfgs(arch, **over):
    kw = dict(KW, **over)
    return JARCHS[arch].reduced(**kw), ARCHS[arch].reduced(**kw)


class Pair:
    """One arch in both packages on the same weights."""

    def __init__(self, arch):
        self.jcfg, self.cfg = _cfgs(arch)
        self.jm = JModel(self.jcfg)
        self.jp = self.jm.init(jax.random.PRNGKey(0))
        self.tm = Model(self.cfg, device="cpu")
        self.tp = self.tm.load(params_from_jax(jax.tree.map(np.asarray, self.jp),
                                               self.cfg))
        moe = self.cfg.num_experts > 0
        self.logit_bound = MOE_BOUND if moe else LOGIT_BOUND
        self.leaf_bound = MOE_BOUND if moe else LEAF_BOUND

    def jbatch(self, toks, start=0):
        return self.jm.make_batch(jnp.asarray(toks), start=start)

    def tbatch(self, toks, start=0):
        return self.tm.make_batch(torch.from_numpy(np.asarray(toks)).long(),
                                  start=start)


@pytest.fixture(scope="module", params=ARCHS_UNDER_TEST)
def pair(request):
    return Pair(request.param)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite runs several
    workers side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _toks(seed, *shape):
    return np.random.RandomState(seed).randint(0, 500, shape).astype(np.int32)


def _check_leaves(pair, jc, tc):
    """Every cache leaf, in ``jax.tree.leaves`` order."""
    jl, tl = jax.tree.leaves(jc), ttfm.tree_leaves(tc)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a, b = np.asarray(a, np.float32), b.numpy()
        assert a.shape == b.shape
        scale = max(1.0, float(np.abs(a).max()))
        assert _err(a, b) / scale < pair.leaf_bound, (a.shape, _err(a, b), scale)


def _rows(cache, row):
    """Row ``row`` of every leaf (scan leaves [G, B, ...], tail leaves
    [B, ...]), in ``jax.tree.leaves`` order."""
    return [t.narrow(1 if k == "scan" else 0, row, 1)
            for k in sorted(cache) for t in ttfm.tree_leaves(cache[k])]


def _prefill_both(pair, toks, length, cap=64, with_logits="last"):
    jc = pair.jm.init_cache(toks.shape[0], cap)
    jl, jc = pair.jm.prefill(pair.jp, pair.jbatch(toks), jc,
                             length=None if length is None else jnp.int32(length),
                             with_logits=with_logits)
    tc = pair.tm.init_cache(toks.shape[0], cap)
    tl, tc = pair.tm.prefill(pair.tp, pair.tbatch(toks), tc, length=length,
                             with_logits=with_logits)
    return jl, jc, tl, tc


# ---------------------------------------------------------------------------
# weights, init, cache layout
# ---------------------------------------------------------------------------


def test_params_from_jax_names_and_layouts(pair):
    """Every JAX leaf lands under the port's name with its layout, scanned
    layers sliced out of the stack and tail layers taken as they are."""
    sd = params_from_jax(jax.tree.map(np.asarray, pair.jp), pair.cfg)
    own = pair.tm.init(seed=0).state_dict()
    assert set(sd) == set(own)
    for k in sd:
        assert tuple(sd[k].shape) == tuple(own[k].shape), k
    n_jax = sum(int(np.prod(np.shape(x))) for x in jax.tree.leaves(pair.jp))
    assert sum(v.numel() for v in sd.values()) == n_jax
    if pair.cfg.name.startswith("xlstm"):
        w = np.asarray(pair.jp["scan"]["sub3"]["mlstm"]["wq"])
        assert np.array_equal(sd["blocks.3.mlstm.wq"].numpy(), w[0])
        r = np.asarray(pair.jp["scan"]["sub7"]["slstm"]["r_gates"])
        assert np.array_equal(sd["blocks.7.slstm.r_gates"].numpy(), r[0])
    elif pair.cfg.name.startswith("mixtral"):
        for leaf in ("router", "wi", "wg", "wo"):
            w = np.asarray(pair.jp["scan"]["sub0"]["moe"][leaf])
            assert np.array_equal(sd[f"blocks.1.moe.{leaf}"].numpy(), w[1])
    else:
        a = np.asarray(pair.jp["scan"]["sub1"]["rec"]["a_param"])
        assert np.array_equal(sd["blocks.1.rec.a_param"].numpy(), a[0])
        t = np.asarray(pair.jp["tail1"]["rec"]["wx"])       # layer 4: tail
        assert np.array_equal(sd["blocks.4.rec.wx"].numpy(), t)
        wk = np.asarray(pair.jp["scan"]["sub2"]["attn"]["wk"])
        assert np.array_equal(sd["blocks.2.attn.wk"].numpy(), wk[0])


@pytest.mark.parametrize("arch,layers", [("recurrentgemma-9b", 14),
                                         ("xlstm-350m", 24)])
def test_port_init_follows_jax_init_rules_per_leaf(arch, layers):
    """Per-leaf init rule (fault 1): ones / zeros / normal(0.02) / fan-in
    scaled, with the scan axis counted into the fan-in of scanned layers
    only. 14 recurrentgemma layers = 4 scanned periods + an R R tail, so a
    tail leaf drawn with the scan axis would be 2x too narrow; 24 xlstm
    layers = 3 periods. Same rules, not the same bits: constant leaves
    equal, random leaves' standard deviations within 25% and means near 0."""
    jcfg, cfg = _cfgs(arch, num_layers=layers)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    sd = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    own = Model(cfg, device="cpu").init(seed=0).state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        a, b = v.double(), own[k].double()
        if torch.all(a == a.flatten()[0]):              # constant init
            assert torch.equal(a, b), k
            continue
        ratio = float(b.std() / a.std())
        assert 0.75 < ratio < 1.33, (k, ratio)
        bound = 5 * float(a.std()) / a.numel() ** 0.5
        assert abs(float(a.mean())) < bound and abs(float(b.mean())) < bound, k


def test_cache_layout_matches_jax(pair):
    """The cache pytree: same leaves (mLSTM / sLSTM states as tuples),
    shapes and dtypes as the JAX ``init_cache``, zeros throughout."""
    jc = pair.jm.init_cache(3, 40)
    tc = pair.tm.init_cache(3, 40)
    assert jax.tree.structure(jc) == jax.tree.structure(
        jax.tree.map(lambda x: 0, ttfm.tree_map(lambda t: 0, tc)))
    for a, b in zip(jax.tree.leaves(jc), ttfm.tree_leaves(tc)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert not b.any()


def test_slot_extract_covers_tuple_leaves(pair):
    """slot_extract (fault 2) gives a one-row view of EVERY leaf, tuple
    states included, and writes through it land in that slot only."""
    tc = pair.tm.init_cache(3, 32)
    for i, t in enumerate(ttfm.tree_leaves(tc)):
        t.copy_(torch.arange(t.numel(), dtype=torch.float32).reshape(t.shape) + i)
    rows = [[r.clone() for r in _rows(tc, b)] for b in range(3)]
    view = ttfm.tree_leaves(slot_extract(tc, 1))
    assert len(view) == len(rows[1]) == len(ttfm.tree_leaves(tc))
    for t, want in zip(view, rows[1]):
        assert torch.equal(t, want)
        t.fill_(-7.0)
    for b in range(3):
        for t, old in zip(_rows(tc, b), rows[b]):
            assert torch.equal(t, torch.full_like(old, -7.0) if b == 1 else old)


# ---------------------------------------------------------------------------
# logits and caches per mode
# ---------------------------------------------------------------------------


def test_train_logits(pair):
    toks = _toks(1, 2, 24)
    jl, _, _ = jtfm.forward_logits(pair.jp, pair.jbatch(toks), pair.jcfg,
                                   mode="train")
    tl, _, _ = ttfm.forward_logits(pair.tp, pair.tbatch(toks), pair.cfg,
                                   mode="train")
    assert tl.shape == jl.shape
    assert _err(tl, jl) < pair.logit_bound


@pytest.mark.parametrize("S,length", [(40, 29), (16, 11)])
def test_prefill_padded_logits_and_every_cache_leaf(pair, S, length):
    """A prompt of ``length`` real tokens right-padded to S (fault 3):
    recurrent / conv / xLSTM state stops at the last real token, and the
    ring keeps positions [length - cap, length) (S=40 > ring cap 16)."""
    toks = _toks(2, 1, S)
    jl, jc, tl, tc = _prefill_both(pair, toks, length)
    assert tl.shape == jl.shape == (1, 1, pair.cfg.padded_vocab)
    assert _err(tl, jl) < pair.logit_bound
    _check_leaves(pair, jc, tc)


def test_prefill_starts_from_zero_state(pair):
    """Prefill into a cache row full of another request's state gives the
    logits and the state a fresh cache gives (the port prefills straight
    into the slot's row)."""
    toks = _toks(3, 1, 40)
    tc = pair.tm.init_cache(1, 64)
    for t in ttfm.tree_leaves(tc):
        t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(5)))
    tl, tc = pair.tm.prefill(pair.tp, pair.tbatch(toks), tc, length=33,
                             with_logits="last")
    fresh = pair.tm.init_cache(1, 64)
    fl, fresh = pair.tm.prefill(pair.tp, pair.tbatch(toks), fresh, length=33,
                                with_logits="last")
    assert torch.equal(tl, fl)
    # every leaf, ring K/V included (S = 40 > ring cap 16: rewritten whole)
    for a, b in zip(ttfm.tree_leaves(tc), ttfm.tree_leaves(fresh)):
        assert torch.equal(a, b)


def test_decode_steps(pair):
    """Two decode steps for two rows after a shared prefill that filled
    the ring (24 > 16 positions): logits and every cache leaf."""
    toks = _toks(4, 2, 24)
    _, jc, _, tc = _prefill_both(pair, toks, 24, with_logits=False)
    clen = np.array([24, 24], np.int32)
    for t in range(2):
        nxt = _toks(10 + t, 2, 1)
        jb = {"tokens": jnp.asarray(nxt), "positions": jnp.asarray(clen[:, None])}
        jl, jc = pair.jm.decode_step(pair.jp, jb, jc, jnp.asarray(clen))
        tb = {"tokens": torch.from_numpy(nxt).long(),
              "positions": torch.from_numpy(clen[:, None]).long()}
        tl, tc = pair.tm.decode_step(pair.tp, tb, tc, torch.from_numpy(clen))
        assert _err(tl, jl) < pair.logit_bound
        clen = clen + 1
    _check_leaves(pair, jc, tc)


@pytest.mark.parametrize("with_logits", ["all", "last"])
def test_dense_extend_wraps_the_ring(pair, with_logits):
    """Prefill 12 tokens (the ring of 16 not yet full), then two extend
    chunks at positions [12, 28) and [28, 44) (the second right-padded to
    11 real tokens for "last"): the ring wraps twice; logits and every
    leaf agree."""
    toks = _toks(5, 1, 12)
    _, jc, _, tc = _prefill_both(pair, toks, None, with_logits=False)
    start = 12
    for i, n_real in enumerate((16, 16 if with_logits == "all" else 11)):
        chunk = _toks(6 + i, 1, 16)
        jl, jc = pair.jm.extend(pair.jp, pair.jbatch(chunk, start=start), jc,
                                jnp.int32(start), length=jnp.int32(n_real),
                                with_logits=with_logits)
        tl, tc = pair.tm.extend(pair.tp, pair.tbatch(chunk, start=start), tc,
                                start, length=n_real, with_logits=with_logits)
        assert tl.shape == jl.shape
        if with_logits == "all":
            assert _err(tl[:, :n_real], jl[:, :n_real]) < pair.logit_bound
        else:
            assert _err(tl, jl) < pair.logit_bound
        start += n_real
    _check_leaves(pair, jc, tc)


def test_verify_then_commit_at_per_row_lengths(pair):
    """A verify forward over S=5 draft inputs for three rows (lens 5, 3 and
    0: the last row sits the step out), then verify_commit at accepted
    lengths ns = (2, 3, 0): logits of the valid inputs and the committed
    state of every leaf equal the JAX package's; the idle row keeps its
    state bit for bit."""
    toks = _toks(7, 3, 20)
    _, jc, _, tc = _prefill_both(pair, toks, None, with_logits=False, cap=48)
    before = [t.clone() for t in _rows(tc, 2)]
    S = 5
    drafts = _toks(8, 3, S)
    clens = np.array([20, 20, 20], np.int32)
    lens = np.array([5, 3, 0], np.int32)
    ns = np.array([2, 3, 0], np.int32)
    pos = clens[:, None] + np.arange(S, dtype=np.int32)[None, :]
    jl, staged = jtfm.verify(pair.jp, {"tokens": jnp.asarray(drafts),
                                       "positions": jnp.asarray(pos)},
                             pair.jcfg, jc, jnp.asarray(clens),
                             lens=jnp.asarray(lens))
    jc = jtfm.verify_commit(pair.jcfg, staged, jnp.asarray(clens),
                            jnp.asarray(ns), jnp.asarray(lens))
    tl, tstaged = pair.tm.verify(pair.tp, {"tokens": torch.from_numpy(drafts).long(),
                                           "positions": torch.from_numpy(pos).long()},
                                 tc, torch.from_numpy(clens),
                                 lens=torch.from_numpy(lens))
    for b in range(2):                              # rows with valid inputs
        assert _err(tl[b, :lens[b]], jl[b, :lens[b]]) < pair.logit_bound
    tc = pair.tm.verify_commit(tstaged, torch.from_numpy(clens),
                               torch.from_numpy(ns), torch.from_numpy(lens))
    _check_leaves(pair, jc, tc)
    for t, old in zip(_rows(tc, 2), before):
        assert torch.equal(t, old)


def test_verify_commit_equals_decode_steps(pair):
    """In the port: a verify over 4 inputs committed at ns = 4 leaves the
    state 4 decode steps leave, and its logits are theirs."""
    toks = _toks(9, 1, 20)
    drafts = _toks(11, 1, 4)
    out = []
    for how in ("verify", "decode"):
        tc = pair.tm.init_cache(1, 48)
        pair.tm.prefill(pair.tp, pair.tbatch(toks), tc, with_logits=False)
        if how == "verify":
            pos = torch.arange(20, 24)[None]
            lg, st = pair.tm.verify(pair.tp, {"tokens": torch.from_numpy(drafts).long(),
                                              "positions": pos}, tc,
                                    torch.tensor([20]), lens=torch.tensor([4]))
            pair.tm.verify_commit(st, torch.tensor([20]), torch.tensor([4]),
                                  torch.tensor([4]))
        else:
            steps = []
            for i in range(4):
                b = {"tokens": torch.from_numpy(drafts[:, i:i + 1]).long(),
                     "positions": torch.tensor([[20 + i]])}
                li, _ = pair.tm.decode_step(pair.tp, b, tc, torch.tensor([20 + i]))
                steps.append(li)
            lg = torch.cat(steps, 1)
        out.append((lg, ttfm.tree_leaves(tc)))
    assert _err(out[0][0], out[1][0]) < pair.logit_bound
    for a, b in zip(out[0][1], out[1][1]):
        assert _err(a, b) / max(1.0, float(b.abs().max())) < pair.leaf_bound


def test_decode_keep_freezes_rows(pair):
    """``keep`` (the decode chunk's done mask, fault 4): rows marked False
    come out of a decode step with every cache leaf bit for bit."""
    toks = _toks(12, 2, 20)
    tc = pair.tm.init_cache(2, 48)
    pair.tm.prefill(pair.tp, pair.tbatch(toks), tc, with_logits=False)
    before = [[t.clone() for t in _rows(tc, b)] for b in range(2)]
    b = {"tokens": torch.tensor([[3], [4]]), "positions": torch.tensor([[20], [20]])}
    pair.tm.decode_step(pair.tp, b, tc, torch.tensor([20, 20]),
                        keep=torch.tensor([True, False]))
    for t, old in zip(_rows(tc, 1), before[1]):
        assert torch.equal(t, old)
    assert any(not torch.equal(t, old) for t, old in zip(_rows(tc, 0), before[0]))


# ---------------------------------------------------------------------------
# what the port builds, and where it runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS_UNDER_TEST)
def test_stateful_model_runs_on_the_card_unless_asked_for_cpu(arch):
    _, cfg = _cfgs(arch)
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Model(cfg)
    assert Model(cfg, device="cpu").device.type == "cpu"
    full = dataclasses.replace(ARCHS[arch])
    assert Model(full, device="cpu").param_count() > 0
