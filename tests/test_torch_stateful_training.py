"""Training the stateful families on the port, on the CPU: the gradients
of the two stateful kernels' wrappers and a train run of recurrentgemma-9b
and xlstm-350m against the JAX package.

* ``RGLRUScan``'s gradients (a, bx, h0, through y and h_last) equal
  autograd of ``rglru_scan_ref``: S on both sides of 64 (the card's route
  edge), with and without h0, with masked steps (a = 1, bx = 0); float64 at
  1e-10 and float32 at 2e-5, relative to max(1, the gradient's largest
  value); each gradient comes in its input's dtype (a bf16 bx beside a
  float32 a);
* ``mlstm_chunk_bwd`` equals autograd of ``mlstm_chunk_ref``: S not a
  multiple of the chunk, a chunk longer than S, padded (masked) rows, input
  gates large enough that the stabilisers move and both sides of the
  denominator's max occur, a state in, and a state out that the next
  segment reads; float64 at 1e-9 and float32 at 1e-4, relative as above;
* under autograd the wrappers apply ``RGLRUScan`` and ``MLSTMChunk``
  (``grad_fn`` names), and a state in that requires grad raises;
* under remat "full" (and "minimal") each recurrent and mLSTM layer of a
  scanned period runs its forward twice (the recompute), the tail layers
  once, and the scan's gradient wrapper once a layer;
* a 3-step run with accumulation 2 of recurrentgemma-9b and xlstm-350m
  (reduced) equals JAX's at the bounds of ``test_train_steps_equal_jax``
  (tests/test_torch_training.py): params at 1e-4 relative to each leaf's
  largest value or 4x the reference's own spread, losses at 1e-5
  relative; xlstm at lr 1e-4 (at 1e-2 and 1e-3 JAX moves its own third
  loss by ~1% and ~3e-3 under a 1e-7 change of the params: those lrs are
  chaotic for it; at 1e-4 by ~1e-5).
"""
import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.kernels import mlstm_chunk as kmc  # noqa: E402
from repro_torch.kernels import rglru_scan as krs  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_training as tt  # noqa: E402

TOL = {torch.float64: {"scan": 1e-10, "mlstm": 1e-9},
       torch.float32: {"scan": 2e-5, "mlstm": 1e-4}}
KW = {"recurrentgemma-9b": dict(lr=1e-2, warmup_steps=1, total_steps=10),
      "xlstm-350m": dict(lr=1e-4, warmup_steps=1, total_steps=10)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_grads(got, want, tol, names):
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype, name
        scale = max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        assert err <= tol * scale, (name, err, scale)


# ---------------------------------------------------------------------------
# RGLRUScan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("S,with_h0", [(40, True), (64, False), (65, True), (200, False)])
def test_rglru_scan_grads_equal_plain_autograd(dtype, S, with_h0):
    rs = np.random.RandomState(S)
    B, R = 2, 24
    a = 1.0 / (1.0 + np.exp(-rs.standard_normal((B, S, R))))
    bx = rs.standard_normal((B, S, R))
    a[1, S // 2:], bx[1, S // 2:] = 1.0, 0.0             # masked steps
    a[0, 3], bx[0, 3] = 1.0, 0.0
    t = (lambda x: torch.from_numpy(np.asarray(x)).to(dtype))  # noqa: E731
    ins = [t(a), t(bx)] + ([t(rs.standard_normal((B, R)))] if with_h0 else [])
    dy, dh_last = t(rs.standard_normal((B, S, R))), t(rs.standard_normal((B, R)))
    ins = [x.requires_grad_() for x in ins]
    h0 = ins[2] if with_h0 else None
    y, h = krs.rglru_scan_ref(ins[0], ins[1], h0, out_dtype=dtype)
    want = torch.autograd.grad((y * dy).sum() + (h * dh_last).sum(), ins)
    y, h = krs.rglru_scan(ins[0], ins[1], h0, out_dtype=dtype)
    assert type(y.grad_fn).__name__ == "RGLRUScanBackward"
    got = torch.autograd.grad((y * dy).sum() + (h * dh_last).sum(), ins)
    _check_grads(got, want, TOL[dtype]["scan"], ["a", "bx", "h0"])
    # the backward alone, through y only (dh_last None)
    hh, _ = krs.rglru_scan_ref(*(x.detach() for x in ins[:2]),
                               None if h0 is None else h0.detach(), out_dtype=dtype)
    da, dbx, _ = krs.rglru_scan_bwd(ins[0].detach(), hh, dy,
                                    None if h0 is None else h0.detach())
    y, _ = krs.rglru_scan_ref(ins[0], ins[1], h0, out_dtype=dtype)
    want = torch.autograd.grad((y * dy).sum(), ins[:2])
    _check_grads((da, dbx), want, TOL[dtype]["scan"], ["a", "bx"])


def test_rglru_scan_bf16_output_rounds_the_saved_states():
    """Training passes ``out_dtype=bf16``: y is the float32 states rounded,
    and the gradient of a bf16 y reaches a and bx as float32."""
    rs = np.random.RandomState(3)
    a = torch.from_numpy(1 / (1 + np.exp(-rs.standard_normal((2, 70, 8))))).float()
    bx = torch.from_numpy(rs.standard_normal((2, 70, 8))).float()
    a.requires_grad_()
    bx.requires_grad_()
    y, _ = krs.rglru_scan(a, bx, out_dtype=torch.bfloat16)
    yw, _ = krs.rglru_scan_ref(a, bx, out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.equal(y, yw)
    dy = torch.from_numpy(rs.standard_normal((2, 70, 8))).to(torch.bfloat16)
    got = torch.autograd.grad(y, (a, bx), dy)
    want = torch.autograd.grad(yw, (a, bx), dy)
    _check_grads(got, want, TOL[torch.float32]["scan"], ["a", "bx"])


def test_rglru_scan_grads_come_in_each_inputs_dtype():
    """A bf16 bx beside a float32 a (and h0): each gradient in its own
    input's dtype, at the values autograd of the plain version gives."""
    rs = np.random.RandomState(4)
    a = torch.from_numpy(1 / (1 + np.exp(-rs.standard_normal((2, 30, 8))))).float()
    bx = torch.from_numpy(rs.standard_normal((2, 30, 8))).to(torch.bfloat16)
    h0 = torch.from_numpy(rs.standard_normal((2, 8))).float()
    ins = [x.requires_grad_() for x in (a, bx, h0)]
    dy = torch.from_numpy(rs.standard_normal((2, 30, 8))).float()
    got = torch.autograd.grad(krs.rglru_scan(*ins)[0], ins, dy)
    want = torch.autograd.grad(krs.rglru_scan_ref(*ins)[0], ins, dy)
    assert [g.dtype for g in got] == [torch.float32, torch.bfloat16, torch.float32]
    _check_grads(got, want, TOL[torch.float32]["scan"], ["a", "bx", "h0"])


# ---------------------------------------------------------------------------
# MLSTMChunk / mlstm_chunk_bwd
# ---------------------------------------------------------------------------


def _mlstm_case(seed, B, S, H, hd, ig_scale, dtype, pad=0):
    rs = np.random.RandomState(seed)
    t = (lambda x: torch.from_numpy(np.asarray(x)).to(dtype))  # noqa: E731
    q = t(rs.standard_normal((B, S, H, hd)) * 0.5)
    k = t(rs.standard_normal((B, S, H, hd)) * 0.5)
    v = t(rs.standard_normal((B, S, H, hd)))
    ig = rs.standard_normal((B, S, H)) * ig_scale
    ig[:, :, 0] -= 3 * ig_scale                 # one head with small write weights
    fg = rs.standard_normal((B, S, H)) + 2.0
    if pad:                                     # the model's masked rows
        ig[-1, S - pad:], fg[-1, S - pad:] = kmc.NEG_INF, 30.0
    return q, k, v, t(ig), t(fg), t(rs.standard_normal((B, S, H, hd)))


def _denominator_branches(q, k, ig, fg, L):
    """(rows where |q·n| wins, rows where exp(-mj) wins) of the first chunk
    from the zero state: the denominator ``max(|q·n_j|, exp(-mj))``."""
    hd = q.shape[-1]
    q, k, ig, fg = (x[:, :L].double() for x in (q, k, ig, fg))
    Fc = torch.cumsum(torch.nn.functional.logsigmoid(fg), dim=1)
    logD = Fc[:, :, None] - Fc[:, None] + ig[:, None]
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool))
    logD = logD.masked_fill(~tri[None, :, :, None], kmc.NEG_INF)
    mj = logD.amax(dim=2)
    n = torch.einsum("blmh,bmhd->blhd", torch.exp(logD - mj[:, :, None]), k)
    qn = (q * hd ** -0.5 * n).sum(-1).abs()
    return int((qn > torch.exp(-mj)).sum()), int((qn < torch.exp(-mj)).sum())


MLSTM_CASES = [  # B, S, H, hd, chunk, ig_scale, pad, state_in
    (2, 37, 2, 8, 16, 1.0, 0, False),    # S not a multiple of the chunk
    (1, 10, 2, 8, 32, 1.0, 0, False),    # chunk > S
    (2, 50, 3, 8, 16, 8.0, 7, False),    # large gates, padded rows
    (2, 64, 2, 16, 16, 20.0, 0, True),   # the stabilisers move, a state in
]


def _rel_err(got, want):
    return float((got.double() - want.double()).abs().max()) / max(
        1.0, float(want.double().abs().max()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,S,H,hd,chunk,ig_scale,pad,state_in", MLSTM_CASES)
def test_mlstm_chunk_bwd_equals_plain_autograd(dtype, B, S, H, hd, chunk, ig_scale,
                                               pad, state_in):
    """float64: against autograd of the plain version at 1e-9. float32:
    against the same float64 gradient, at 1e-4 or at twice the distance of
    autograd of the plain version run in float32 from it where that is
    larger (at gates of scale 20 both float32 gradients sit ~1e-3 from the
    float64 one, in different directions)."""
    case = _mlstm_case(S + H, B, S, H, hd, ig_scale, torch.float64, pad)
    names = ["q", "k", "v", "ig", "fg"]

    def plain_grads(dt):
        q, k, v, ig, fg, dh = (x.to(dt) for x in case)
        state = None
        if state_in:
            _, state = kmc.mlstm_chunk_ref(q[:, :9], k[:, :9], v[:, :9], ig[:, :9],
                                           fg[:, :9], chunk=chunk)
        ins = [x.clone().requires_grad_() for x in (q, k, v, ig, fg)]
        h, _ = kmc.mlstm_chunk_ref(*ins, state, chunk=chunk)
        return ins, state, dh, torch.autograd.grad(h, ins, dh)

    _, _, _, want = plain_grads(torch.float64)
    ins, state, dh, own = plain_grads(dtype)
    if ig_scale >= 8.0:
        hit, lo = _denominator_branches(*case[:2], *case[3:5], min(chunk, S))
        assert hit > 0 and lo > 0, (hit, lo)
    got = kmc.mlstm_chunk_bwd(*(x.detach() for x in ins), dh, state, chunk=chunk)
    h, _ = kmc.mlstm_chunk(*ins, state, chunk=chunk)
    assert type(h.grad_fn).__name__ == "MLSTMChunkBackward"
    via = torch.autograd.grad(h, ins, dh)
    for name, g, a, o, w in zip(names, got, via, own, want):
        assert g.dtype == a.dtype == dtype, name
        tol = TOL[dtype]["mlstm"]
        if dtype == torch.float32:
            tol = max(tol, 2 * _rel_err(o, w))
        assert _rel_err(g, w) <= tol, (name, _rel_err(g, w), tol)
        assert _rel_err(a, w) <= tol, (name, _rel_err(a, w), tol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mlstm_state_out_gradient_through_the_next_segment(dtype):
    """The state out's gradient (dC, dn; m's dropped) is exact for a reader
    invariant to the stabiliser's shift: the next segment's plain version,
    differentiated through its state in."""
    q, k, v, ig, fg, dh = _mlstm_case(5, 2, 40, 2, 8, 8.0, dtype)
    q2, k2, v2, ig2, fg2, dh2 = _mlstm_case(6, 2, 9, 2, 8, 8.0, dtype)
    ins = [x.clone().requires_grad_() for x in (q, k, v, ig, fg)]
    grads = {}
    for name, first in (("plain", kmc.mlstm_chunk_ref), ("function", kmc.mlstm_chunk)):
        h, st = first(*ins, chunk=16)
        h2, _ = kmc.mlstm_chunk_ref(q2, k2, v2, ig2, fg2, st, chunk=16)
        grads[name] = torch.autograd.grad((h * dh).sum() + (h2 * dh2).sum(), ins)
    _check_grads(grads["function"], grads["plain"], TOL[dtype]["mlstm"],
                 ["q", "k", "v", "ig", "fg"])


def test_mlstm_state_in_that_requires_grad_raises():
    q, k, v, ig, fg, _ = _mlstm_case(1, 1, 16, 2, 8, 1.0, torch.float32)
    C, n, m = kmc.zero_state(1, 2, 8, "cpu")
    with pytest.raises(NotImplementedError, match="state in"):
        kmc.mlstm_chunk(q, k, v, ig, fg, (C.requires_grad_(), n, m), chunk=8)
    with torch.no_grad():
        kmc.mlstm_chunk(q, k, v, ig, fg, (C, n, m), chunk=8)


# ---------------------------------------------------------------------------
# the model: remat, and a 3-step run against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
@pytest.mark.parametrize("policy", ["full", "minimal", "none"])
def test_stateful_forwards_run_again_in_the_recompute(monkeypatch, arch, policy):
    """Each recurrent / mLSTM layer of a scanned period runs its forward
    twice under remat "full" and "minimal" (the recompute) and once under
    "none"; tail layers (outside the scan) once; the RG-LRU's gradient
    (``rglru_scan_bwd``, its kernel's wrapper) once a layer."""
    _, cfg = tt._cfgs(arch, remat_policy=policy)
    params = Model(cfg, device="cpu").init(seed=0, trainable=True)
    batch = tdata.SyntheticLM(tdata.DataConfig(global_batch=2, seq_len=24,
                                               vocab_size=cfg.vocab_size), cfg,
                              device="cpu").batch_at(0)
    calls = {"rglru_scan": 0, "rglru_scan_bwd": 0, "mlstm_chunk": 0}
    for mod, attr, name in ((krs, "_forward", "rglru_scan"),
                            (krs, "rglru_scan_bwd", "rglru_scan_bwd"),
                            (kmc, "_forward", "mlstm_chunk")):
        real = getattr(mod, attr)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    tts.loss_and_grads(params, batch, cfg)
    scanned = len(cfg.pattern) * cfg.num_scan_groups
    runs = 1 if policy == "none" else 2
    kinds = list(cfg.layer_kinds)
    want = {"rglru_scan": 0, "rglru_scan_bwd": 0, "mlstm_chunk": 0}
    for i, kind in enumerate(kinds):
        fwd = runs if i < scanned else 1
        if kind == "recurrent":
            want["rglru_scan"] += fwd
            want["rglru_scan_bwd"] += 1
        elif kind == "mlstm":
            want["mlstm_chunk"] += fwd
    assert sum(want.values()) > 0
    assert calls == want


@functools.lru_cache(maxsize=None)
def _jax_step(arch, accum):
    jcfg, _ = tt._cfgs(arch)
    return jax.jit(jts.make_train_step(jcfg, jts.TrainConfig(
        opt=jopt.AdamWConfig(**KW[arch]), accum_steps=accum)))


def _jax_run(arch, jp, steps, accum):
    """``tt._jax_run`` on one jitted step per (arch, accum): the spread's
    runs reuse its compilation."""
    jcfg, _ = tt._cfgs(arch)
    step = _jax_step(arch, accum)
    data = jdata.SyntheticLM(jdata.DataConfig(global_batch=4, seq_len=32,
                                              vocab_size=jcfg.vocab_size), jcfg)
    state, losses = (jp, jopt.init_opt_state(jp)), []
    for i in range(steps):
        p, o, m = step(*state, data.batch_at(i))
        state = (p, o)
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
def test_stateful_train_steps_equal_jax(arch):
    steps, accum = 3, 2
    jcfg, cfg = tt._cfgs(arch)
    jp = tt._jparams(jcfg)
    (jp2, jo2), jlosses = _jax_run(arch, jp, steps, accum)
    tp, to, tlosses, metrics = tt._port_run(cfg, tt._tparams(jp, cfg), KW[arch], steps,
                                              accum)
    assert sorted(metrics) == ["grad_norm", "loss", "lr", "nll"]
    assert int(to.step) == int(jo2.step) == steps
    np.testing.assert_allclose(tlosses, jlosses, rtol=tt.LOSS_TOL)
    runs = [_jax_run(arch, tt._perturbed(jp, seed), steps, accum) for seed in (1, 2)]
    jp2 = jax.tree.map(np.asarray, jp2)
    ref, spread = dict(tt._leaves(jp2, cfg)), {}
    for (p, _), _ in runs:
        for path, leaf in tt._leaves(jax.tree.map(np.asarray, p), cfg):
            spread[path] = max(spread.get(path, 0.0), tt._rel(leaf, ref[path]))
    tt._check_params(jp2, spread, dict(tp.named_parameters()), cfg)
