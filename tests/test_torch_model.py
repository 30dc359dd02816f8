"""The port's model (repro_torch.models) against repro.models on the CPU.

Same weights (the JAX init carried over by ``convert.params_from_jax``) and
the same numpy inputs through both packages, in every mode of the slice:
train, bucketed prefill (right-padded, ``length``), decode with per-row
cache lengths, dense extend, and paged extend / decode through block
tables. Bound: logits within 1e-4 absolute in float32 — the two packages
run the same math in another reduction order (blocked online softmax in
the XLA path, one softmax in the port's plain versions; other matmul
kernels), which moves float32 logits of these sizes by ~1e-6.
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
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

BOUND = 1e-4
PARITY_ARCHS = ["qwen2.5-3b", "granite-3-2b", "chatglm3-6b", "chameleon-34b"]


def _cfgs(arch):
    kw = dict(dtype="float32", param_dtype="float32", vocab_size=512)
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

    def jbatch(self, toks, start=0):
        return self.jm.make_batch(jnp.asarray(toks), start=start)

    def tbatch(self, toks, start=0):
        return self.tm.make_batch(torch.from_numpy(np.asarray(toks)).long(),
                                  start=start)


@pytest.fixture(scope="module", params=PARITY_ARCHS)
def pair(request):
    return Pair(request.param)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _toks(seed, *shape):
    return np.random.RandomState(seed).randint(0, 500, shape).astype(np.int32)


def _jcache(pair, jc):
    return np.asarray(jc["scan"]["sub0"]["k"]), np.asarray(jc["scan"]["sub0"]["v"])


def _tcache(tc):
    return tc["scan"]["sub0"]["k"].numpy(), tc["scan"]["sub0"]["v"].numpy()


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------


def test_configs_copied_field_for_field():
    assert set(ARCHS) == set(JARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(ARCHS[name]) == dataclasses.asdict(JARCHS[name])
    from repro.configs import base as jbase
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


def test_params_from_jax_names_and_layouts(pair):
    sd = params_from_jax(jax.tree.map(np.asarray, pair.jp), pair.cfg)
    own = pair.tm.init(seed=0).state_dict()
    assert set(sd) == set(own)
    for k in sd:
        assert tuple(sd[k].shape) == tuple(own[k].shape), k
    # layer l of the port is slice l of the JAX scan stack
    wq = np.asarray(pair.jp["scan"]["sub0"]["attn"]["wq"])
    assert np.array_equal(sd["blocks.1.attn.wq"].numpy(), wq[1])


def test_port_init_follows_jax_init_rules():
    """Same rules (not the same bits): ones / zeros / normal(0.02) / fan-in
    scaled, the scanned layer axis counted into the fan-in."""
    jcfg, cfg = _cfgs("qwen2.5-3b")
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = Model(cfg, device="cpu").init(seed=0)
    sd = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    own = tp.state_dict()
    for k, v in sd.items():
        a, b = v.float(), own[k].float()
        if torch.all(a == a.flatten()[0]):          # constant init
            assert torch.equal(a, b), k
        else:
            ratio = float(b.std() / a.std())
            assert 0.7 < ratio < 1.4, (k, ratio)


# ---------------------------------------------------------------------------
# logits parity per mode
# ---------------------------------------------------------------------------


def test_train_logits(pair):
    toks = _toks(1, 2, 24)
    jl, _, _ = jtfm.forward_logits(pair.jp, pair.jbatch(toks), pair.jcfg,
                                   mode="train")
    tl, _, _ = ttfm.forward_logits(pair.tp, pair.tbatch(toks), pair.cfg, mode="train")
    assert tl.shape == jl.shape
    assert _err(tl, jl) < BOUND


def _prefill_both(pair, toks, length, cap=32, with_logits="last"):
    jc = pair.jm.init_cache(toks.shape[0], cap)
    jl, jc = pair.jm.prefill(pair.jp, pair.jbatch(toks), jc,
                             length=None if length is None else jnp.int32(length),
                             with_logits=with_logits)
    tc = pair.tm.init_cache(toks.shape[0], cap)
    tl, tc = pair.tm.prefill(pair.tp, pair.tbatch(toks), tc, length=length,
                             with_logits=with_logits)
    return jl, jc, tl, tc


def test_prefill_padded_logits_and_cache(pair):
    """A prompt of 11 real tokens right-padded to a 16 bucket: the
    ``length`` logits and the cache rows the prompt filled agree."""
    toks = _toks(2, 1, 16)
    jl, jc, tl, tc = _prefill_both(pair, toks, 11)
    assert tl.shape == jl.shape == (1, 1, pair.cfg.padded_vocab)
    assert _err(tl, jl) < BOUND
    (jk, jv), (tk, tv) = _jcache(pair, jc), _tcache(tc)
    assert _err(tk[:, :, :11], jk[:, :, :11]) < BOUND
    assert _err(tv[:, :, :11], jv[:, :, :11]) < BOUND


def test_decode_vector_cache_len(pair):
    """One decode step for two rows at different lengths (vector
    cache_len), after a shared prefill."""
    toks = _toks(3, 2, 16)
    _, jc, _, tc = _prefill_both(pair, toks, None, with_logits=False)
    nxt = _toks(4, 2, 1)
    clen = np.array([9, 15], np.int32)
    jb = {"tokens": jnp.asarray(nxt), "positions": jnp.asarray(clen[:, None])}
    jl, jc = pair.jm.decode_step(pair.jp, jb, jc, jnp.asarray(clen))
    tb = {"tokens": torch.from_numpy(nxt).long(),
          "positions": torch.from_numpy(clen[:, None]).long()}
    tl, tc = pair.tm.decode_step(pair.tp, tb, tc, torch.from_numpy(clen))
    assert _err(tl, jl) < BOUND
    (jk, _), (tk, _) = _jcache(pair, jc), _tcache(tc)
    assert _err(tk, jk) < BOUND


@pytest.mark.parametrize("with_logits", ["all", "last"])
def test_dense_extend(pair, with_logits):
    """A chunk at positions [16, 24) against a prefilled row; "last" with a
    right-padded chunk (5 real tokens of 8)."""
    toks = _toks(5, 1, 16)
    _, jc, _, tc = _prefill_both(pair, toks, None, with_logits=False)
    chunk = _toks(6, 1, 8)
    length = 8 if with_logits == "all" else 5
    jl, jc = pair.jm.extend(pair.jp, pair.jbatch(chunk, start=16), jc,
                            jnp.int32(16), length=jnp.int32(length),
                            with_logits=with_logits)
    tl, tc = pair.tm.extend(pair.tp, pair.tbatch(chunk, start=16), tc, 16,
                            length=length, with_logits=with_logits)
    assert tl.shape == jl.shape
    assert _err(tl, jl) < BOUND
    (jk, _), (tk, _) = _jcache(pair, jc), _tcache(tc)
    assert _err(tk[:, :, :24], jk[:, :, :24]) < BOUND


def test_paged_extend_then_decode(pair):
    """Two sequences prefilled chunk by chunk into their own pages of one
    pool (the second chunk continues at a non-page-aligned start), then one
    batched paged decode step; logits and the pool agree."""
    from repro.serving import kvpool as jkv
    from repro_torch.serving import kvpool as tkv
    ps, P = 8, 12
    jpool = jkv.init_paged_cache(pair.jcfg, P, ps)
    tpool = tkv.init_paged_cache(pair.cfg, P, ps, "cpu")
    bts = np.array([[3, 1, 7, 10], [2, 5, 11, 0]], np.int32)
    for row, n in ((0, 21), (1, 13)):
        toks = _toks(7 + row, 1, n)
        bt = bts[row:row + 1]
        for start, end in ((0, 11), (11, n)):
            c = toks[:, start:end]
            jl, jpool = pair.jm.extend(pair.jp, pair.jbatch(c, start=start), jpool,
                                       jnp.int32(start),
                                       length=jnp.int32(end - start),
                                       block_tables=jnp.asarray(bt),
                                       with_logits="last")
            tl, tpool = pair.tm.extend(pair.tp, pair.tbatch(c, start=start), tpool,
                                       start, length=end - start,
                                       block_tables=torch.from_numpy(bt),
                                       with_logits="last")
            assert _err(tl, jl) < BOUND
    clen = np.array([21, 13], np.int32)
    nxt = _toks(9, 2, 1)
    jb = {"tokens": jnp.asarray(nxt), "positions": jnp.asarray(clen[:, None])}
    jl, jpool = pair.jm.decode_step(pair.jp, jb, jpool, jnp.asarray(clen),
                                    block_tables=jnp.asarray(bts))
    tb = {"tokens": torch.from_numpy(nxt).long(),
          "positions": torch.from_numpy(clen[:, None]).long()}
    tl, tpool = pair.tm.decode_step(pair.tp, tb, tpool, torch.from_numpy(clen),
                                    block_tables=torch.from_numpy(bts))
    assert _err(tl, jl) < BOUND
    (jk, jv), (tk, tv) = _jcache(pair, jpool), _tcache(tpool)
    live = [3, 1, 7, 2, 5]                     # pages holding written positions
    assert _err(tk[:, live], jk[:, live]) < BOUND
    assert _err(tv[:, live], jv[:, live]) < BOUND


# ---------------------------------------------------------------------------
# what the slice refuses, and where it runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,item", [("mixtral-8x22b", "item 8"),
                                       ("recurrentgemma-9b", "item 9"),
                                       ("xlstm-350m", "item 9"),
                                       ("musicgen-large", "item 9")])
def test_unported_archs_raise_naming_roadmap_item(arch, item):
    _, cfg = _cfgs(arch)
    with pytest.raises(NotImplementedError, match=item):
        Model(cfg, device="cpu")


def test_model_runs_on_the_card_unless_asked_for_cpu():
    _, cfg = _cfgs("qwen2.5-3b")
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Model(cfg)
    assert Model(cfg, device="cpu").device.type == "cpu"
