"""The sLSTM scan's contract on the CPU, against the JAX package.

The two kernels (``slstm_scan_fwd`` / ``slstm_scan_bwd`` in
``csrc/slstm_scan.cu``) run only on the card, where tests/test_torch_gpu.py
and chip_smoke.py hold them to their plain versions. Here, on numpy inputs
made with a seed, at reduced widths (hd 16 and 32):

* the port's ``models.xlstm.slstm_scan`` (the input projection, then the
  plain ``slstm_scan_ref``) equals the JAX package's ``slstm_scan``: y, the
  last state and the ``all_states`` stacks in float32 within ``FWD_TOL``
  (2e-5 absolute; the two frameworks' exp / tanh differ by ulps, which the
  recurrence carries), with and without a mask, with a state passed in,
  at S = 1 and S = 5;
* the gradient through ``SLSTMScan`` (the written-out reverse recurrence
  ``slstm_scan_bwd_ref`` plus the dR product ``recurrent_grad``) equals
  ``jax.vjp`` of the reference for x, the input projection, ``r_gates``
  and the state passed in, within ``GRAD_TOL`` (1e-4 of the gradient's
  largest value), unmasked and masked; and equals autograd through the
  plain loop in float64 within 1e-12 (the same arithmetic, another order
  of sums) and in bf16 (d gates_x bit for bit: dg is rounded where
  autograd rounds it; dR within one bf16 rounding of its largest value);
* the C entry points' argument lists equal the wrapper's ctypes
  ``argtypes``; the operators refuse CPU tensors; the CPU counts no
  launch; the dry run's cost counter answers both operators.
"""
import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import xlstm as jxl  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.kernels import slstm_scan as kss  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
SOURCE = (Path(kss.__file__).with_name("csrc") / "slstm_scan.cu").read_text()


def _inputs(seed, B, S, D, H):
    rs = np.random.RandomState(seed)
    hd = D // H
    f = lambda *s, sc=1.0: (sc * rs.standard_normal(s)).astype(np.float32)  # noqa: E731
    p = {"w_gates": f(D, 4, D, sc=D ** -0.5), "b_gates": f(4, D, sc=0.5),
         "r_gates": f(H, 4, hd, hd, sc=hd ** -0.5)}
    x = f(B, S, D)
    state = (f(B, D), np.abs(f(B, D)) + 0.5, f(B, D, sc=0.5), f(B, D))
    mask = rs.uniform(size=(B, S)) > 0.3
    mask[:, 0] = True
    return p, x, state, mask


def _jax(p, x, H, state=None, mask=None, all_states=False):
    cfg = types.SimpleNamespace(slstm_heads=H)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    st = None if state is None else tuple(jnp.asarray(s) for s in state)
    return jxl.slstm_scan(jp, jnp.asarray(x), cfg, st,
                          None if mask is None else jnp.asarray(mask), all_states)


def _torch(p, x, H, state=None, mask=None, all_states=False, grad=False):
    cfg = types.SimpleNamespace(slstm_heads=H)
    tp = types.SimpleNamespace(**{k: torch.from_numpy(v).requires_grad_(grad)
                                  for k, v in p.items()})
    tx = torch.from_numpy(x).requires_grad_(grad)
    st = None if state is None else tuple(torch.from_numpy(s).requires_grad_(grad)
                                          for s in state)
    out = txl.slstm_scan(tp, tx, cfg, st, None if mask is None else torch.from_numpy(mask),
                         all_states)
    return out, tp, tx, st


def _err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))))


def _rel(got, want):
    return _err(got, want) / max(1e-30, float(np.max(np.abs(np.asarray(want)))))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,D,H", [(2, 9, 64, 4), (3, 1, 64, 4), (2, 5, 128, 4),
                                     (1, 40, 128, 4)])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_forward_equals_jax(B, S, D, H, with_state, with_mask):
    p, x, state, mask = _inputs(B * 100 + S, B, S, D, H)
    state = state if with_state else None
    mask = mask if with_mask else None
    before = kss.launches
    (y, st), *_ = _torch(p, x, H, state, mask)
    jy, jst = _jax(p, x, H, state, mask)
    assert y.dtype == torch.float32 and y.shape == (B, S, D)
    assert _err(y.numpy(), jy) <= FWD_TOL
    for a, b in zip(st, jst):
        assert a.shape == (B, D) and _err(a.numpy(), b) <= FWD_TOL
    assert kss.launches == before


@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("with_mask", [False, True])
def test_all_states_equal_jax(S, with_mask):
    """The verify record: the state after every position, carried at the
    masked ones, and y computed from the gates even there."""
    B, D, H = 4, 128, 4
    p, x, state, mask = _inputs(7 + S, B, S, D, H)
    mask = mask if with_mask else None
    (y, stacks), *_ = _torch(p, x, H, state, mask, all_states=True)
    jy, jstacks = _jax(p, x, H, state, mask, all_states=True)
    assert _err(y.numpy(), jy) <= FWD_TOL
    for a, b in zip(stacks, jstacks):
        assert a.shape == (B, S, D) and _err(a.numpy(), b) <= FWD_TOL
    if with_mask:                       # a masked position carries the state
        b, t = np.argwhere(~mask[:, 1:])[0] if (~mask[:, 1:]).any() else (None, None)
        if b is not None:
            assert torch.equal(stacks[0][b, t + 1], stacks[0][b, t])
    (_, last), *_ = _torch(p, x, H, state, mask)
    assert all(torch.equal(s[:, -1], l) for s, l in zip(stacks, last))


def test_state_carry_two_calls_equal_one():
    """An extend resumes the cached state: two calls equal one."""
    B, S, D, H = 2, 12, 64, 4
    p, x, state, mask = _inputs(3, B, S, D, H)
    (y, st), *_ = _torch(p, x, H, state, mask)
    (ya, sa), *_ = _torch(p, np.ascontiguousarray(x[:, :5]), H, state,
                          np.ascontiguousarray(mask[:, :5]))
    (yb, sb), *_ = _torch(p, np.ascontiguousarray(x[:, 5:]), H,
                          tuple(s.numpy() for s in sa), np.ascontiguousarray(mask[:, 5:]))
    assert torch.equal(torch.cat([ya, yb], 1), y)
    assert all(torch.equal(a, b) for a, b in zip(sb, st))


# ---------------------------------------------------------------------------
# gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,D,H", [(2, 9, 64, 4), (2, 6, 128, 4), (1, 1, 64, 4)])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_gradient_equals_jax_vjp(B, S, D, H, with_state, with_mask):
    """d x, d w_gates, d b_gates, d r_gates and d state0 through
    ``SLSTMScan`` against ``jax.vjp`` of the reference, cotangents on y and
    on the last state."""
    p, x, state, mask = _inputs(B * 10 + S + 1, B, S, D, H)
    state = state if with_state else None
    mask = mask if with_mask else None
    rs = np.random.RandomState(S)
    wy = rs.standard_normal((B, S, D)).astype(np.float32)
    wst = tuple(rs.standard_normal((B, D)).astype(np.float32) * s
                for s in (1.0, 0.3, 1.0, 0.1))
    before = dict(kss.launches_by_route)
    (y, st), tp, tx, tst = _torch(p, x, H, state, mask, grad=True)
    ins = [tx, tp.w_gates, tp.b_gates, tp.r_gates] + list(tst or ())
    got = torch.autograd.grad([y, *st], ins,
                              [torch.from_numpy(wy)] + [torch.from_numpy(w) for w in wst])
    assert kss.launches_by_route == before

    cfg = types.SimpleNamespace(slstm_heads=H)

    def f(xx, wg, bg, rg, *s):
        pp = {"w_gates": wg, "b_gates": bg, "r_gates": rg}
        return jxl.slstm_scan(pp, xx, cfg, tuple(s) if s else None,
                              None if mask is None else jnp.asarray(mask))

    primals = [jnp.asarray(v) for v in (x, p["w_gates"], p["b_gates"], p["r_gates"])]
    primals += [jnp.asarray(s) for s in (state or ())]
    _, vjp = jax.vjp(f, *primals)
    want = vjp((jnp.asarray(wy), tuple(jnp.asarray(w) for w in wst)))
    for name, a, b in zip(("x", "w_gates", "b_gates", "r_gates", "c0", "n0", "h0", "m0"),
                          got, want):
        assert _rel(a.numpy(), b) <= GRAD_TOL, name


def _loop_grads(gx, R, state, mask, dy, dlast, through_function):
    ins = [gx.clone().requires_grad_(), R.clone().requires_grad_()]
    st = None if state is None else [s.clone().requires_grad_() for s in state]
    ins += st or []
    fn = kss.slstm_scan if through_function else kss.slstm_scan_ref
    y, last = fn(ins[0], ins[1], st, mask)
    return torch.autograd.grad([y, *last], ins, [dy, *dlast])


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_written_out_backward_equals_autograd_float64(with_state, with_mask):
    """The reverse recurrence is autograd's arithmetic: 1e-12 of the
    largest gradient in float64 (the stabiliser's path, the clamp and the
    masked carries included)."""
    g = torch.Generator().manual_seed(5)
    B, S, H, hd = 3, 11, 2, 8
    D = H * hd
    f64 = dict(dtype=torch.float64, generator=g)
    gx, R = torch.randn(B, S, 4, D, **f64), 0.4 * torch.randn(H, 4, hd, hd, **f64)
    state = None
    if with_state:
        state = [torch.randn(B, D, **f64), torch.rand(B, D, **f64) + 0.5,
                 torch.randn(B, D, **f64), torch.randn(B, D, **f64)]
    mask = (torch.rand(B, S, generator=g) > 0.3) if with_mask else None
    dy = torch.randn(B, S, D, **f64)
    dlast = [torch.randn(B, D, **f64) for _ in range(4)]
    want = _loop_grads(gx, R, state, mask, dy, dlast, False)
    got = _loop_grads(gx, R, state, mask, dy, dlast, True)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_written_out_backward_rounds_where_autograd_does_bf16():
    """bf16: d gates_x bit for bit against autograd through the loop (dg
    rounded once, dh_{t-1} = round(dg · Rᵀ)); dR within one bf16 rounding
    of its largest value (autograd adds each step's bf16 dR in bf16, the
    port forms it in one product)."""
    g = torch.Generator().manual_seed(9)
    B, S, H, hd = 2, 9, 4, 16
    D = H * hd
    bf = torch.bfloat16
    gx = torch.randn(B, S, 4, D, generator=g).to(bf)
    R = (0.3 * torch.randn(H, 4, hd, hd, generator=g)).to(bf)
    mask = torch.rand(B, S, generator=g) > 0.3
    dy = torch.randn(B, S, D, generator=g).to(bf)
    dlast = [torch.zeros(B, D) for _ in range(4)]
    want = _loop_grads(gx, R, None, mask, dy, dlast, False)
    got = _loop_grads(gx, R, None, mask, dy, dlast, True)
    assert torch.equal(got[0], want[0])
    assert float((got[1].float() - want[1].float()).abs().max()) <= \
        2 ** -7 * float(want[1].float().abs().max())


def test_function_keeps_the_gates_and_states():
    """The forward under autograd keeps g (float32, the gates after the
    recurrent term) and the state after every step; y and the last state
    equal the plain call's."""
    B, S, D, H = 2, 7, 64, 4
    rs = np.random.RandomState(1)
    gx = torch.from_numpy(rs.standard_normal((B, S, 4, D)).astype(np.float32))
    R = torch.from_numpy(0.3 * rs.standard_normal((H, 4, D // H, D // H)).astype(np.float32))
    y, states, g = kss._forward(gx, R, keep_gates=True)
    yw, last = kss.slstm_scan_ref(gx, R)
    assert torch.equal(y, yw) and g.shape == (B, S, 4, D) and g.dtype == torch.float32
    assert all(torch.equal(s[:, -1], l) for s, l in zip(states, last))
    y2, last2 = kss.slstm_scan(gx.requires_grad_(), R)
    assert y2.grad_fn is not None and torch.equal(y2, yw)
    assert all(torch.equal(a, b) for a, b in zip(last2, last))


def test_all_states_refuse_a_gradient():
    gx = torch.zeros(1, 2, 4, 32, requires_grad=True)
    with pytest.raises(NotImplementedError, match="all_states"):
        kss.slstm_scan(gx, torch.zeros(2, 4, 16, 16), all_states=True)


# ---------------------------------------------------------------------------
# the C entries, the operators, the cost counter
# ---------------------------------------------------------------------------

_CTYPE = {"void*": "c_void_p", "int": "c_int"}


def _c_signature(name):
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', SOURCE)
    types_ = []
    for x in (a.strip() for a in m.group(1).replace("\n", " ").split(",")):
        t = re.sub(r"\bconst\b", "", x).rsplit(" ", 1)[0].replace(" ", "")
        types_.append(_CTYPE["void*" if t.endswith("*") else t])
    return types_


@pytest.mark.parametrize("name,argtypes", [("slstm_scan_fwd", kss.FWD_ARGTYPES),
                                           ("slstm_scan_bwd", kss.BWD_ARGTYPES)])
def test_c_entry_arguments_are_the_wrapper_argtypes(name, argtypes):
    assert _c_signature(name) == [t.__name__ for t in argtypes]


def test_operators_refuse_cpu_tensors():
    gx, R = torch.zeros(1, 3, 4, 32), torch.zeros(2, 4, 16, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        torch.ops.repro_torch.slstm_scan(gx, R, None, None, None, None, None)
    st = torch.zeros(1, 3, 32)
    with pytest.raises(ValueError, match="unsupported device"):
        torch.ops.repro_torch.slstm_scan_bwd(gx, R, st, st, st, None, None, None, None,
                                             st, None, None, None, None)


def test_cost_counter_answers_both_operators():
    """On meta under autograd: one ``slstm_scan`` keeping its gates and
    states, one ``slstm_scan_bwd``, and dR as the one product (2·N·4·D·hd
    FLOPs over the N = B·S positions)."""
    from repro_torch.launch import cost
    B, S, H, hd = 2, 50, 4, 32
    D = H * hd
    gx = torch.empty(B, S, 4, D, device="meta", dtype=torch.bfloat16, requires_grad=True)
    R = torch.empty(H, 4, hd, hd, device="meta", dtype=torch.bfloat16, requires_grad=True)
    with cost.CostCounter() as counter:
        y, _ = kss.slstm_scan(gx, R)
        torch.autograd.grad(y, (gx, R), torch.empty_like(y))
    res = counter.result()
    assert res["kernels"] == {"slstm_scan": 1, "slstm_scan_bwd": 1}
    fwd, bwd = costs.slstm(B, S, H, hd, 2, False, True), costs.slstm_bwd(B, S, H, hd, 2)
    assert res["kernel_flops_by"]["slstm_scan"] == sum(fwd[0].values()) \
        == 2.0 * B * S * 4 * D * hd
    assert res["kernel_flops_by"]["slstm_scan_bwd"] == sum(bwd[0].values())
    assert res["product_flops"] == 2.0 * B * S * 4 * D * hd
    assert res["peak_bytes"] >= 4 * 8 * B * S * D


def test_bounds_at_the_train_microbatch():
    """xlstm-350m's train microbatch [4, 1024, 4 x 256] in bf16: bytes bound
    both kernels. The forward as training runs it reads gates_x and R and
    writes y, the float32 states after every step and the gates g (42
    bytes a position and channel); the gradient reads g, c, n, m, dy, R and
    the last state's gradient and writes d gates_x (38 bytes)."""
    B, S, H, hd = 4, 1024, 4, 256
    D = H * hd
    ops, nbytes = costs.slstm(B, S, H, hd, 2, False, True)
    assert ops == {"bf16": 2.0 * B * S * 4 * D * hd}
    assert nbytes == 42 * B * S * D + 2 * H * 4 * hd * hd
    assert costs.bound_ms((ops, nbytes))[1] == "bytes"
    ops, nbytes = costs.slstm_bwd(B, S, H, hd, 2)
    assert nbytes == 38 * B * S * D + 2 * H * 4 * hd * hd + 16 * B * D
    assert costs.bound_ms((ops, nbytes))[1] == "bytes"
    assert costs.slstm(B, S, H, hd, 4)[0] == {"f32": 2.0 * B * S * 4 * D * hd}
