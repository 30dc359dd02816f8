"""The modality families on the port: musicgen-large (audio frames) and
chameleon-34b (early-fusion tokens) against the JAX package on the CPU.

* ``sinusoidal_pos`` and musicgen's forward logits on the same frame
  embeddings equal JAX's ``forward_logits`` within 1e-4 (float32; the
  bound of tests/test_torch_model.py), in train, prefill and decode;
* teacher-forced decode: a prefill then one decode step per frame gives
  the logits of one forward over the whole sequence;
* ``LLMServer`` greedy ids equal the JAX server's for musicgen and
  chameleon, dense and paged (a prefix shared by two prompts: radix
  hits in paged mode). The JAX scheduler builds musicgen's frame stub
  ``one_hot(ids % d_model)`` on the host, the port on the device;
* ``spec_len > 0`` raises ``ValueError`` for both, as in the reference
  (tests/test_spec_decode.py::test_spec_rejects_non_text_modality).

EOS guard as in tests/test_torch_serving.py: both archs have an untied
unembed, whose EOS column is zeroed on both sides, and every parity test
asserts the reference emitted its whole budget.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving.server import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.server import LLMServer as JServer  # noqa: E402
from repro.serving.server import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import programs  # noqa: E402
from repro_torch.serving.server import (EngineConfig, LLMServer,  # noqa: E402
                                        SamplingParams)

BOUND = 1e-4
KW = dict(dtype="float32", param_dtype="float32", vocab_size=512)
ARCH_NAMES = ["musicgen-large", "chameleon-34b"]
PROMPTS = ["System: cooperating agents share this conversation. [planner] plan",
           "System: cooperating agents share this conversation. [actor] act now",
           "third prompt"]
ECFG = dict(page_size=16, decode_chunk=4, prefill_buckets=(32, 64))


def _cfgs(arch):
    return JARCHS[arch].reduced(**KW), ARCHS[arch].reduced(**KW)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.fixture(scope="module", params=ARCH_NAMES)
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def weights(arch):
    """(JAX params, the port's state dict): the same numbers, with the EOS
    column of the untied unembed zeroed."""
    jcfg, cfg = _cfgs(arch)
    jp = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(0)))
    t = jp["unembed"]["table"].copy()
    t[:, cfg.vocab_size - 1] = 0.0
    jp["unembed"]["table"] = t
    return jp, params_from_jax(jp, cfg)


@pytest.fixture(scope="module")
def musicgen():
    """(jcfg, cfg, JAX model, JAX params, port model, port params)."""
    jcfg, cfg = _cfgs("musicgen-large")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = Model(cfg, device="cpu")
    tp = tm.load(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    return jcfg, cfg, jm, jp, tm, tp


def _frames(seed, B, S, D):
    return np.random.RandomState(seed).standard_normal((B, S, D)).astype(np.float32)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_sinusoidal_pos_matches_jax():
    pos = np.random.RandomState(0).randint(0, 4096, (2, 7)).astype(np.int32)
    for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jlayers.sinusoidal_pos(jnp.asarray(pos), 64, dt_j)
        got = tlayers.sinusoidal_pos(torch.from_numpy(pos).long(), 64, dt_t)
        assert got.dtype == dt_t and tuple(got.shape) == (2, 7, 64)
        assert _err(got.float(), np.asarray(want.astype(jnp.float32))) <= (
            1e-5 if dt_t == torch.float32 else 1e-2)


def test_musicgen_forward_logits_match_jax(musicgen):
    jcfg, cfg, jm, jp, tm, tp = musicgen
    fr = _frames(0, 2, 24, cfg.d_model)
    jl, _, _ = jtfm.forward_logits(jp, jm.make_batch(jnp.asarray(fr)), jcfg)
    batch = tm.make_batch(torch.from_numpy(fr))
    assert set(batch) == {"frames", "positions"}
    tl, _, _ = ttfm.forward_logits(tp, batch, cfg)
    assert tl.shape == (2, 24, cfg.padded_vocab)
    assert _err(tl, jl) < BOUND


def test_musicgen_prefill_and_decode_match_jax(musicgen):
    """A right-padded prefill (``length``) then decode steps with per-row
    cache lengths, in both packages."""
    jcfg, cfg, jm, jp, tm, tp = musicgen
    fr = _frames(1, 2, 20, cfg.d_model)
    jc = jm.init_cache(2, 32)
    jl, jc = jm.prefill(jp, jm.make_batch(jnp.asarray(fr[:, :16])), jc, length=12)
    tc = tm.init_cache(2, 32)
    tl, tc = tm.prefill(tp, tm.make_batch(torch.from_numpy(fr[:, :16])), tc,
                        length=12)
    assert _err(tl[:, :12], np.asarray(jl)[:, :12]) < BOUND
    clens = np.array([12, 12], np.int32)
    for s in range(12, 16):
        pos = clens[:, None]
        jl, jc = jm.decode_step(jp, jm.make_batch(jnp.asarray(fr[:, s:s + 1]),
                                                  positions=jnp.asarray(pos)),
                                jc, jnp.asarray(clens))
        tl, tc = tm.decode_step(tp, tm.make_batch(
            torch.from_numpy(fr[:, s:s + 1]),
            positions=torch.from_numpy(pos).long()), tc, torch.from_numpy(clens))
        assert _err(tl, jl) < BOUND
        clens = clens + 1


def test_musicgen_teacher_forced_decode_matches_one_forward(musicgen):
    _, cfg, _, _, tm, tp = musicgen
    fr = torch.from_numpy(_frames(2, 1, 14, cfg.d_model))
    full, _, _ = ttfm.forward_logits(tp, tm.make_batch(fr), cfg)
    cache = tm.init_cache(1, 16)
    lg, cache = tm.prefill(tp, tm.make_batch(fr[:, :6]), cache)
    assert float((lg - full[:, :6]).abs().max()) < BOUND
    for s in range(6, 14):
        lg, cache = tm.decode_step(tp, tm.make_batch(fr[:, s:s + 1], start=s),
                                   cache, torch.tensor([s], dtype=torch.int32))
        assert float((lg[:, 0] - full[:, s]).abs().max()) < BOUND


def test_frame_stub_equals_explicit_one_hot_frames(musicgen):
    """The serving programs' frame stub (``one_hot(ids % d_model)``, built
    on the ids' device) is the frames input the model would be given; a
    text config gets the ids."""
    _, cfg, _, _, _, _ = musicgen
    ids = torch.tensor([[5, 700, 64, 511, 3]])
    pos = torch.arange(5)[None]
    assert programs.model_inputs(_cfgs("chameleon-34b")[1], ids, pos)["tokens"] is ids
    batch = programs.model_inputs(cfg, ids, pos)
    want = torch.nn.functional.one_hot(ids % cfg.d_model, cfg.d_model).float()
    assert torch.equal(batch["frames"], want)
    assert torch.equal(batch["positions"], pos)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _serve(srv, submit):
    out = []
    for batch in (PROMPTS, PROMPTS[:2]):
        hs = [submit(srv, p) for p in batch]
        srv.run_until_idle()
        out += [h.request.output_ids for h in hs]
    return out


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_server_greedy_ids_equal_jax(arch, weights, mode):
    """Three co-batched prompts, then the two sharing a system prompt
    again (KV-page prefix hits in paged mode): the port's greedy ids equal
    the JAX server's."""
    jcfg, cfg = _cfgs(arch)
    jp, sd = weights
    jsrv = JServer(jcfg, num_slots=3, capacity=128,
                   params=jax.tree.map(jnp.asarray, jp),
                   engine_cfg=JEngineConfig(cache_mode=mode, **ECFG))
    ref = _serve(jsrv, lambda s, p: s.submit(p, JSamplingParams(max_new_tokens=10)))
    assert all(len(ids) == 10 for ids in ref), ref       # the EOS guard
    srv = LLMServer(cfg, num_slots=3, capacity=128, params=sd, device="cpu",
                    engine_cfg=EngineConfig(cache_mode=mode, **ECFG))
    got = _serve(srv, lambda s, p: s.submit(p, SamplingParams(max_new_tokens=10)))
    assert got == ref
    st = srv.stats()
    assert st["active_slots_per_step"] > 1.0
    if mode == "paged":
        assert st["prefix_hit_tokens"] > 0


def test_spec_len_raises_for_non_text_modality(arch):
    """As the reference: a non-text modality has no n-gram stream to draft
    from."""
    jcfg, cfg = _cfgs(arch)
    with pytest.raises(ValueError, match="modality"):
        JServer(jcfg, num_slots=1, capacity=64,
                engine_cfg=JEngineConfig(spec_len=4))
    for mode in ("dense", "paged"):
        with pytest.raises(ValueError, match="modality"):
            LLMServer(cfg, num_slots=1, capacity=64, device="cpu",
                      engine_cfg=EngineConfig(spec_len=4, cache_mode=mode))
