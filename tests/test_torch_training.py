"""The port's training path (repro_torch.training, ``train_loss``, the flash
backward, remat) against the JAX package on the CPU.

* ``SyntheticLM`` batches equal JAX's bit for bit (frames included);
* ``schedule``, ``clip_by_global_norm`` and one ``adamw_update`` equal
  JAX's at 1e-6 (relative to each leaf's largest value);
* the int8 gradient round trip equals JAX's and keeps the bound of
  tests/test_serving_training.py:114;
* ``train_loss`` and every gradient leaf equal ``jax.value_and_grad`` of
  ``repro.models.transformer.train_loss`` for one arch of each family, on
  the JAX init carried over by ``convert.params_from_jax``: the loss at
  1e-5 relative, each leaf's gradient at 1e-4 relative to that leaf's
  largest value (float32; the two packages sum in other orders), or at 4x
  the reference's own float32 noise where that is larger (``_spread``);
* one ``make_train_step`` step and a 3-step run (with accumulation) equal
  JAX's losses at 1e-5 and params at 1e-4 relative to each leaf's largest
  value, or at 4x the reference's own spread where AdamW's update turns
  float32 noise into more (``_check_params``);
* the ports of tests/test_serving_training.py:73 (the loss falls by 1.5)
  and :94 (accumulation is equivalent, the same bounds);
* the flash ``autograd.Function``'s written-out backward equals autograd
  of ``flash_attention_ref`` (GQA, ``window``, ``q_start``, several query
  blocks) at 2e-5 in float32 and 2e-2 in bf16, relative to the gradient's
  largest value where that exceeds 1;
* remat "full", "minimal" and "none" give equal gradients, and under
  "full" each attention layer runs its forward twice (the recompute);
* train mode reaches no decode kernel wrapper, and ``build.refuse_grad``
  (which the split-K decode wrappers, forward-only, call) raises under
  autograd.

The recurrent and mLSTM layers' gradients come from the written-out
backwards of ``RGLRUScan`` and ``MLSTMChunk`` (the stateful kernels'
``autograd.Function``s; tests/test_torch_stateful_training.py holds them
to autograd of the plain versions), so the recurrentgemma-9b and
xlstm-350m cases here hold those backwards to ``jax.value_and_grad``.
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
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

FAMILIES = ["granite-3-2b", "qwen2.5-3b", "mixtral-8x22b", "recurrentgemma-9b",
            "xlstm-350m", "musicgen-large", "chameleon-34b"]
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite runs several
    workers side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **over):
    kw = dict(dtype="float32", param_dtype="float32", vocab_size=256)
    kw.update(over)
    return JARCHS[arch].reduced(**kw), ARCHS[arch].reduced(**kw)


def _jparams(jcfg, seed=0):
    return JModel(jcfg).init(jax.random.PRNGKey(seed))


def _tparams(jp, cfg):
    return Model(cfg, device="cpu").load(
        convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg), trainable=True)


def _batches(jcfg, cfg, step, **dkw):
    dcfg = dict(global_batch=2, seq_len=32, vocab_size=cfg.vocab_size)
    dcfg.update(dkw)
    jb = jdata.SyntheticLM(jdata.DataConfig(**dcfg), jcfg).batch_at(step)
    tb = tdata.SyntheticLM(tdata.DataConfig(**dcfg), cfg, device="cpu").batch_at(step)
    return jb, tb


def _rel(got, want):
    """max |got - want| over max(|want|, tiny), in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _leaves(tree, cfg):
    """(path, leaf) of a params-shaped tree in the JAX layout; empty leaves
    skipped."""
    for path, _ in convert.jax_layout(cfg):
        leaf = tree
        for key in path:
            leaf = leaf[key]
        if np.asarray(leaf).size:
            yield "/".join(path), leaf


def _pairs(jtree, sd, cfg):
    """(path, JAX leaf, port leaf) of a JAX params-shaped tree and the
    port's state dict (port names) carried to the JAX layout."""
    port = dict(_leaves(convert.params_to_jax(
        {k: v.detach() for k, v in sd.items()}, cfg), cfg))
    for path, want in _leaves(jtree, cfg):
        yield path, np.asarray(want), port[path].numpy()


def _check_tree(jtree, sd, cfg, tol, what):
    bad = [(p, e) for p, want, got in _pairs(jtree, sd, cfg)
           if not (e := _rel(got, want)) <= tol]
    assert not bad, f"{what}: leaves past {tol}: {bad}"


def _perturbed(jp, seed):
    """The params with every element moved by a random 1e-7 of itself
    (float32 noise)."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: a * (1 + 1e-7 * rs.randn(*a.shape).astype(np.float32)), jp)


def _spread(run, jp, ref, cfg, seeds=(1,)):
    """How far the reference moves itself under float32 noise: leaf by leaf,
    the largest relative change of ``run(params)`` (a params-shaped tree)
    from ``ref`` over runs from ``_perturbed`` params."""
    ref = dict(_leaves(ref, cfg))
    out = {}
    for seed in seeds:
        for path, leaf in _leaves(jax.tree.map(np.asarray, run(_perturbed(jp, seed))), cfg):
            out[path] = max(out.get(path, 0.0), _rel(leaf, ref[path]))
    return out


def _check_params(jparams, spread, sd, cfg, tol=PARAM_TOL):
    """Params after AdamW steps: each leaf at ``tol`` relative to its
    largest value, or at 4x the reference's own spread where that is
    larger. AdamW moves an element by lr·m̂/(√v̂+eps), and where a gradient
    is near 0 (√v̂ near eps) float32 noise moves that ratio by O(1): a
    3-step run of JAX from params moved by 1e-7 lands up to 3.3e-3 (of a
    leaf's largest value) from its own unmoved run."""
    bad = []
    for path, want, got in _pairs(jparams, sd, cfg):
        err, lim = _rel(got, want), max(tol, 4 * spread[path])
        if not err <= lim:
            bad.append((path, err, lim))
    assert not bad, f"params past their bound: {bad}"


# ---------------------------------------------------------------------------
# data and optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,seed,step", [("qwen2.5-3b", 0, 0), ("qwen2.5-3b", 7, 99),
                                            ("musicgen-large", 3, 5)])
def test_synthetic_lm_equals_jax(arch, seed, step):
    jcfg, cfg = _cfgs(arch)
    jb, tb = _batches(jcfg, cfg, step, seed=seed, global_batch=3, seq_len=17)
    assert sorted(jb) == sorted(tb)
    for key in jb:
        want = np.asarray(jb[key].astype(jnp.float32) if key == "frames" else jb[key])
        got = tb[key].float().numpy() if key == "frames" else tb[key].numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), key
    assert tb["labels"].dtype == torch.int32


def test_data_deterministic_and_restartable():
    d1 = tdata.SyntheticLM(tdata.DataConfig(seed=7, global_batch=2, seq_len=16),
                           device="cpu")
    d2 = tdata.SyntheticLM(tdata.DataConfig(seed=7, global_batch=2, seq_len=16),
                           device="cpu")
    for step in (0, 5, 99):
        assert torch.equal(d1.batch_at(step)["tokens"], d2.batch_at(step)["tokens"])
    assert not torch.equal(d1.batch_at(0)["tokens"], d1.batch_at(1)["tokens"])


def test_schedule_equals_jax():
    cfg = topt.AdamWConfig(lr=1e-3, warmup_steps=7, total_steps=40)
    jcfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=7, total_steps=40)
    for step in (0, 1, 3, 7, 8, 20, 39, 40, 55):
        want = float(jopt.schedule(jcfg, jnp.asarray(step, jnp.int32)))
        got = float(topt.schedule(cfg, torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * abs(want) + 1e-12, (step, got, want)


def _random_tree(seed):
    rs = np.random.RandomState(seed)
    return {"a": rs.randn(8, 5).astype(np.float32),
            "b": (rs.randn(17) * 3).astype(np.float32),
            "c": rs.randn(4, 3, 2).astype(np.float32)}


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_clip_and_adamw_update_equal_jax(clip):
    params, grads = _random_tree(0), _random_tree(1)
    m, v = _random_tree(2), {k: np.abs(x) for k, x in _random_tree(3).items()}
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10, grad_clip=clip)
    jstate = jopt.OptState(step=jnp.asarray(4, jnp.int32),
                           m=jax.tree.map(jnp.asarray, m), v=jax.tree.map(jnp.asarray, v))
    jclipped, jgn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), clip)
    tgrads = {k: torch.from_numpy(x.copy()) for k, x in grads.items()}
    tclipped, tgn = topt.clip_by_global_norm(tgrads, clip)
    assert abs(float(tgn) - float(jgn)) <= 1e-6 * float(jgn)
    for k in grads:
        assert _rel(tclipped[k].numpy(), jclipped[k]) <= 1e-6, k
    jp, jst, jmet = jopt.adamw_update(jopt.AdamWConfig(**kw),
                                      jax.tree.map(jnp.asarray, params),
                                      jax.tree.map(jnp.asarray, grads), jstate)
    tp = {k: torch.from_numpy(x.copy()) for k, x in params.items()}
    tstate = topt.OptState(step=torch.tensor(4, dtype=torch.int32),
                           m={k: torch.from_numpy(x.copy()) for k, x in m.items()},
                           v={k: torch.from_numpy(x.copy()) for k, x in v.items()})
    tp, tst, tmet = topt.adamw_update(topt.AdamWConfig(**kw), tp, tgrads, tstate)
    assert int(tst.step) == int(jst.step) == 5
    for name in ("grad_norm", "lr"):
        assert abs(float(tmet[name]) - float(jmet[name])) <= 1e-6 * abs(float(jmet[name]))
    for k in params:
        assert _rel(tp[k].numpy(), jp[k]) <= 1e-6, k
        assert _rel(tst.m[k].numpy(), jst.m[k]) <= 1e-6, k
        assert _rel(tst.v[k].numpy(), jst.v[k]) <= 1e-6, k


def test_int8_roundtrip_equals_jax_and_is_bounded():
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (256, 256)) * 0.01)
    jq, js = jts.compress_int8(jnp.asarray(g))
    tq, ts = tts.compress_int8(torch.from_numpy(g.copy()))
    assert tq.dtype == torch.int8
    assert float(ts) == float(js)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    back = tts.decompress_int8(tq, ts)
    assert float((back - torch.from_numpy(g)).abs().max()) <= float(ts) + 1e-9
    rt = tts.grads_roundtrip_int8({"g": torch.from_numpy(g.copy())})["g"]
    assert np.array_equal(rt.numpy(), np.asarray(jts.grads_roundtrip_int8(jnp.asarray(g))))


# ---------------------------------------------------------------------------
# train_loss and its gradients against jax.value_and_grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_grads_equal_jax(arch):
    """Gradients at 1e-4 relative to each leaf's largest value, or 4x the
    reference's own float32 noise where that is larger: the MoE input's
    bf16 rounding (mixtral) and the mLSTM's exponential gates (xlstm) move
    JAX's own gradients by 1.3e-4 and 8.4e-4 under a 1e-7 change of the
    params (``_spread``); every other family's floor is under 2.5e-5."""
    jcfg, cfg = _cfgs(arch)
    jp = _jparams(jcfg)
    jb, tb = _batches(jcfg, cfg, 0)
    # a label outside the vocab is masked out of the loss in both
    jb = dict(jb, labels=jb["labels"].at[0, 3].set(cfg.vocab_size + 1))
    tb["labels"][0, 3] = cfg.vocab_size + 1
    fn = jax.jit(jax.value_and_grad(lambda p: jtfm.train_loss(p, jb, jcfg),
                                    has_aux=True))
    (jloss, jmet), jgrads = fn(jp)
    tp = _tparams(jp, cfg)
    tloss, tmet, tgrads = tts.loss_and_grads(tp, tb, cfg)
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    assert abs(float(tmet["nll"]) - float(jmet["nll"])) <= LOSS_TOL * abs(float(jmet["nll"]))
    assert abs(float(tmet["aux"]) - float(jmet["aux"])) <= LOSS_TOL * max(abs(float(jmet["aux"])), 1e-6)
    jgrads = jax.tree.map(np.asarray, jgrads)
    floor = max(_spread(lambda p: fn(p)[1], jp, jgrads, cfg).values())
    tol = max(GRAD_TOL, 4 * floor)
    if cfg.num_experts == 0 and cfg.family != "ssm":
        assert tol == GRAD_TOL
    _check_tree(jgrads, tgrads, cfg, tol, arch)


def _jax_run(jcfg, jp, tcfg_kw, steps, accum):
    jstep = jax.jit(jts.make_train_step(jcfg, jts.TrainConfig(
        opt=jopt.AdamWConfig(**tcfg_kw), accum_steps=accum)))
    data = jdata.SyntheticLM(jdata.DataConfig(global_batch=4, seq_len=32,
                                              vocab_size=jcfg.vocab_size), jcfg)
    state, losses = (jp, jopt.init_opt_state(jp)), []
    for i in range(steps):
        p, o, m = jstep(*state, data.batch_at(i))
        state = (p, o)
        losses.append(float(m["loss"]))
    return state, losses


def _port_run(cfg, tp, tcfg_kw, steps, accum):
    step = tts.make_train_step(cfg, tts.TrainConfig(
        opt=topt.AdamWConfig(**tcfg_kw), accum_steps=accum))
    data = tdata.SyntheticLM(tdata.DataConfig(global_batch=4, seq_len=32,
                                              vocab_size=cfg.vocab_size), cfg,
                             device="cpu")
    opt, losses, metrics = topt.init_opt_state(tp), [], None
    for i in range(steps):
        tp, opt, metrics = step(tp, opt, data.batch_at(i))
        losses.append(float(metrics["loss"]))
    return tp, opt, losses, metrics


@pytest.mark.parametrize("steps,accum", [(1, 1), (3, 2)])
def test_train_steps_equal_jax(steps, accum):
    jcfg, cfg = _cfgs("qwen2.5-3b")
    jp = _jparams(jcfg)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    (jp2, jo2), jlosses = _jax_run(jcfg, jp, kw, steps, accum)
    tp, to, tlosses, metrics = _port_run(cfg, _tparams(jp, cfg), kw, steps, accum)
    assert sorted(metrics) == (["aux", "grad_norm", "loss", "lr", "nll"] if accum == 1
                               else ["grad_norm", "loss", "lr", "nll"])
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_TOL)
    assert int(to.step) == int(jo2.step) == steps
    jp2 = jax.tree.map(np.asarray, jp2)
    spread = _spread(lambda p: _jax_run(jcfg, p, kw, steps, accum)[0][0], jp, jp2,
                     cfg, seeds=(1, 2))
    _check_params(jp2, spread, dict(tp.named_parameters()), cfg)
    if steps == 1:
        _check_tree(jax.tree.map(np.asarray, jo2.m), to.m, cfg, GRAD_TOL, "m")


def test_loss_decreases_on_structured_data():
    """tests/test_serving_training.py:73 on the port."""
    _, cfg = _cfgs("granite-3-2b", num_layers=2)
    params = Model(cfg, device="cpu").init(seed=0, trainable=True)
    data = tdata.SyntheticLM(tdata.DataConfig(global_batch=8, seq_len=64,
                                              vocab_size=cfg.vocab_size), cfg,
                             device="cpu")
    step = tts.make_train_step(cfg, tts.TrainConfig(opt=topt.AdamWConfig(
        lr=1e-2, warmup_steps=5, total_steps=80)))
    opt, losses = topt.init_opt_state(params), []
    for i in range(60):
        params, opt, m = step(params, opt, data.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.5, (losses[0], losses[-1])


def test_grad_accumulation_equivalent():
    """tests/test_serving_training.py:94 on the port (its bounds)."""
    _, cfg = _cfgs("qwen2.5-3b", num_layers=2, vocab_size=512)
    init = Model(cfg, device="cpu").init(seed=0, trainable=True).state_dict()
    batch = tdata.SyntheticLM(tdata.DataConfig(global_batch=4, seq_len=32,
                                               vocab_size=cfg.vocab_size), cfg,
                              device="cpu").batch_at(0)
    outs = {}
    for accum in (1, 2, 4):
        params = Model(cfg, device="cpu").load(init, trainable=True)
        step = tts.make_train_step(cfg, tts.TrainConfig(accum_steps=accum))
        p2, _, m = step(params, topt.init_opt_state(params), batch)
        outs[accum] = (float(m["loss"]), p2)
    assert outs[1][0] == pytest.approx(outs[2][0], rel=1e-4)
    deltas = [float((a - b).abs().max()) for a, b in zip(
        outs[1][1].parameters(), outs[4][1].parameters())]
    assert max(deltas) < 5e-3


# ---------------------------------------------------------------------------
# the flash backward, remat, and what train mode launches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,T,H,K,hd,q_start,window,block", [
    (2, 70, 70, 8, 2, 32, 0, None, 128),        # GQA, one block
    (2, 150, 150, 4, 2, 16, 0, None, 64),       # three query blocks
    (1, 37, 100, 4, 2, 16, 63, None, 16),       # q_start: a prefix of keys
    (1, 90, 120, 6, 3, 16, 30, 16, 32),         # window and q_start
    (2, 64, 64, 4, 4, 16, 0, 8, 16),            # MHA, a window of 8
])
def test_flash_backward_equals_plain_autograd(dtype, tol, B, S, T, H, K, hd,
                                              q_start, window, block):
    rs = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)
                   for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd),
                                 (B, S, H, hd)))
    kw = dict(q_per_kv=H // K, window=window, q_start=q_start)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(kfa.flash_attention_ref(q, k, v, **kw), (q, k, v), do)
    o = kfa.flash_attention(q, k, v, **kw)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    got = kfa.flash_attention_bwd(q.detach(), k.detach(), v.detach(), o.detach(),
                                  do, block=block, **kw)
    via = torch.autograd.grad(o, (q, k, v), do)
    for name, g, a, w in zip("qkv", got, via, want):
        assert g.dtype == w.dtype, name
        scale = max(1.0, float(w.float().abs().max()))
        assert float((g.float() - w.float()).abs().max()) <= tol * scale, name
        assert float((a.float() - w.float()).abs().max()) <= tol * scale, name


def test_flash_backward_refuses_rows_that_see_no_key():
    q, k, v = torch.zeros(1, 4, 2, 16), torch.zeros(1, 8, 1, 16), torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError, match="see no key"):
        kfa.flash_attention_bwd(q, k, v, q, q, q_per_kv=2, window=2, q_start=8)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-9b", "mixtral-8x22b"])
def test_remat_policies_give_equal_grads(arch):
    _, cfg = _cfgs(arch)
    params = Model(cfg, device="cpu").init(seed=1, trainable=True)
    batch = tdata.SyntheticLM(tdata.DataConfig(global_batch=2, seq_len=32,
                                               vocab_size=cfg.vocab_size), cfg,
                              device="cpu").batch_at(2)
    out = {}
    for policy in ("full", "minimal", "none"):
        pcfg = dataclasses.replace(cfg, remat_policy=policy)
        loss, _, grads = tts.loss_and_grads(params, batch, pcfg)
        out[policy] = (float(loss), {k: g.clone() for k, g in grads.items()})
    for policy in ("minimal", "none"):
        assert out[policy][0] == pytest.approx(out["full"][0], rel=1e-6)
        for name, g in out["full"][1].items():
            scale = max(float(g.abs().max()), 1e-30)
            assert float((out[policy][1][name] - g).abs().max()) <= 1e-5 * scale, \
                (policy, name)


@pytest.mark.parametrize("policy,forwards", [("full", 2), ("minimal", 2), ("none", 1)])
def test_flash_forward_runs_again_in_the_recompute(monkeypatch, policy, forwards):
    _, cfg = _cfgs("qwen2.5-3b", num_layers=3, remat_policy=policy)
    params = Model(cfg, device="cpu").init(seed=0, trainable=True)
    batch = tdata.SyntheticLM(tdata.DataConfig(global_batch=2, seq_len=16,
                                               vocab_size=cfg.vocab_size), cfg,
                              device="cpu").batch_at(0)
    calls = []
    real = kfa._forward
    monkeypatch.setattr(kfa, "_forward", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tts.loss_and_grads(params, batch, cfg)
    assert len(calls) == forwards * cfg.num_layers


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x22b", "recurrentgemma-9b",
                                  "xlstm-350m"])
def test_train_mode_reaches_no_decode_kernel(monkeypatch, arch):
    """decode_attention, paged_decode_attention, both spec forms and
    accept_len never run in train mode (accept_len takes bool flags,
    which cannot require grad)."""
    from repro_torch.kernels import split_decode
    from repro_torch.kernels import spec_scan

    def boom(*a, **kw):
        raise AssertionError("a serving kernel ran in train mode")

    for mod in (ttfm, split_decode, spec_scan):
        for name in ("decode_attention", "paged_decode_attention",
                     "spec_decode_attention", "paged_spec_decode_attention",
                     "launch_split", "accept_len"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, boom)
    _, cfg = _cfgs(arch)
    params = Model(cfg, device="cpu").init(seed=0, trainable=True)
    batch = tdata.SyntheticLM(tdata.DataConfig(global_batch=2, seq_len=24,
                                               vocab_size=cfg.vocab_size), cfg,
                              device="cpu").batch_at(0)
    loss, _, grads = tts.loss_and_grads(params, batch, cfg)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_refuse_grad_raises_only_under_autograd():
    x = torch.zeros(3, requires_grad=True)
    why = "a serving kernel; train mode never decodes"
    with pytest.raises(NotImplementedError, match="train mode never decodes"):
        build.refuse_grad("decode_attention", why, None, x)
    with torch.no_grad():
        build.refuse_grad("decode_attention", why, x)
    build.refuse_grad("decode_attention", why, x.detach())


def test_serving_forward_builds_no_graph():
    _, cfg = _cfgs("qwen2.5-3b")
    model = Model(cfg, device="cpu")
    params = model.init(seed=0, trainable=True)
    batch = model.make_batch(torch.arange(8)[None, :])
    logits, _ = model.prefill(params, batch, model.init_cache(1, 16))
    assert logits.grad_fn is None and not logits.requires_grad
    assert not any(p.requires_grad for p in model.init(seed=0).parameters())
