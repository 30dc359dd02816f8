"""The RG-LRU gradient's contract on the CPU, against the JAX package.

The gradient kernel (``rglru_scan_bwd`` in ``csrc/rglru_scan.cu``) runs
only on the card, where tests/test_torch_gpu.py holds it to its plain
version. Here, on numpy inputs made with a seed:

* the plain backward ``rglru_scan_bwd_ref`` equals ``jax.vjp`` of the
  reference's ``repro.kernels.ref.rglru_scan`` in float32 at 2e-5 relative
  to max(1, the gradient's largest value): S on both sides of ``SHORT_S``
  and of a tile, with and without h0 and a gradient of h_last, masked
  steps (a = 1, bx = 0), float32 and bf16 dy;
* a numpy model of the kernel's two routes, with the geometry read from
  the source (``T``, ``SEG``, ``CH``, ``SHORT_S``): on the chunked route
  tickets in reverse time order, the reads shifted one row across tile
  edges (a one step later, the state one step earlier), a partial last
  tile, R not a multiple of 32, and each tile's carry taken from its
  predecessor's published state alone, so that any schedule of the tiles
  gives the same bits; it equals the plain backward;
* the C entry points' argument lists equal the wrapper's ctypes
  ``argtypes``; the backward's scan plan; the operator refuses CPU
  tensors; the Function's forward keeps the float32 states (y in the
  output dtype beside them); the dry run's cost counter answers both
  operators (``costs.rglru`` with the kept states, ``costs.rglru_bwd``).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.kernels import rglru_scan as krs  # noqa: E402

TOL = 2e-5
CSRC = Path(krs.__file__).with_name("csrc")
SOURCE = (CSRC / "rglru_scan.cu").read_text()


def _constexpr(name):
    (value,) = re.findall(rf"constexpr int {name} = (\d+);", SOURCE)
    return int(value)


# the kernel's geometry, from its source
SEG, NW, CH, SHORT_S = (_constexpr(n) for n in ("SEG", "NW", "CH", "SHORT_S"))
T = SEG * NW


def _inputs(seed, B, S, R, *, mask=True):
    rs = np.random.RandomState(seed)
    a = (1.0 / (1.0 + np.exp(-rs.standard_normal((B, S, R))))).astype(np.float32)
    bx = (0.5 * rs.standard_normal((B, S, R))).astype(np.float32)
    if mask:                                    # masked (padding) steps
        a[-1, S // 2:], bx[-1, S // 2:] = 1.0, 0.0
        a[0, min(3, S - 1)], bx[0, min(3, S - 1)] = 1.0, 0.0
    h0 = rs.standard_normal((B, R)).astype(np.float32)
    dy = rs.standard_normal((B, S, R)).astype(np.float32)
    dh_last = rs.standard_normal((B, R)).astype(np.float32)
    return a, bx, h0, dy, dh_last


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))


def _states(a, bx, h0):
    hh, _ = krs.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(bx),
                               None if h0 is None else torch.from_numpy(h0))
    return hh.numpy()


# ---------------------------------------------------------------------------
# the plain backward against the reference's autodiff
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_h0,with_dh_last", [(False, False), (True, False),
                                                  (False, True), (True, True)])
@pytest.mark.parametrize("S", [5, 64, 65, 200, 300])
def test_plain_backward_equals_jax_vjp(S, with_h0, with_dh_last):
    a, bx, h0, dy, dh_last = _inputs(S, 2, S, 40)
    h0 = h0 if with_h0 else None
    dh_last = dh_last if with_dh_last else None
    primals = (jnp.asarray(a), jnp.asarray(bx)) + (() if h0 is None else (jnp.asarray(h0),))
    (y, h), vjp = jax.vjp(lambda *p: ref.rglru_scan(*p), *primals)
    want = vjp((jnp.asarray(dy), jnp.zeros_like(h) if dh_last is None
                else jnp.asarray(dh_last)))
    t = (lambda x: None if x is None else torch.from_numpy(x))  # noqa: E731
    da, dbx, dh0 = krs.rglru_scan_bwd_ref(t(a), t(_states(a, bx, h0)), t(dy), t(h0),
                                          t(dh_last))
    assert da.dtype == dbx.dtype == torch.float32
    assert (dh0 is None) == (h0 is None)
    for name, got, w in zip(("a", "bx", "h0"), (da, dbx, dh0), want):
        assert _scaled_err(got, w) <= TOL, name


def test_plain_backward_takes_a_bf16_dy_and_none():
    """A bf16 dy is widened (the reference's cotangent is the same values in
    float32); dy None is a zero gradient of y."""
    a, bx, h0, dy, dh_last = _inputs(7, 2, 150, 33)
    dyb = torch.from_numpy(dy).to(torch.bfloat16)
    (_, h), vjp = jax.vjp(lambda *p: ref.rglru_scan(*p), jnp.asarray(a), jnp.asarray(bx),
                          jnp.asarray(h0))
    hh = torch.from_numpy(_states(a, bx, h0))
    ta, th0 = torch.from_numpy(a), torch.from_numpy(h0)
    want = vjp((jnp.asarray(dyb.float().numpy()), jnp.zeros_like(h)))
    got = krs.rglru_scan_bwd_ref(ta, hh, dyb, th0)
    for name, g, w in zip(("a", "bx", "h0"), got, want):
        assert _scaled_err(g, w) <= TOL, name
    want = vjp((jnp.zeros_like(jnp.asarray(dy)), jnp.asarray(dh_last)))
    got = krs.rglru_scan_bwd_ref(ta, hh, None, th0, torch.from_numpy(dh_last))
    for name, g, w in zip(("a", "bx", "h0"), got, want):
        assert _scaled_err(g, w) <= TOL, name


# ---------------------------------------------------------------------------
# a model of the kernel's two routes
# ---------------------------------------------------------------------------


def _fma(x, y, z):
    """fmaf in float32: the product is exact in float64, one rounding after."""
    return (np.float64(1) * x * y + z).astype(np.float32)


def chunked_bwd_model(a, hh, dy, h0, dh_last, *, schedule=None):
    """The chunked route, tile by tile as the kernel runs it. Ticket t is
    chunk ``nchunks - 1 - t // stride`` (the last chunk first), row and
    channel group from ``t % stride``; a tile's carry-in is the state its
    predecessor (ticket t - stride, the chunk after it) published, one FMA
    of that tile's aggregate on its own carry. ``schedule``: the order the
    tiles run in (any order that runs a predecessor first); the default is
    ticket order. Returns (da, dbx, dh0, the tiles' published states)."""
    B, S, R = a.shape
    nchunks, ngroups = -(-S // T), -(-R // CH)
    stride = B * ngroups
    ntiles = stride * nchunks
    da, dbx = np.zeros((B, S, R), np.float32), np.zeros((B, S, R), np.float32)
    dh0 = np.zeros((B, R), np.float32)
    published = {}
    for t in (range(ntiles) if schedule is None else schedule):
        group, b, chunk = t % ngroups, (t // ngroups) % B, nchunks - 1 - t // stride
        r = group * CH + np.arange(CH)
        rok = r < R
        rc = np.minimum(r, R - 1)
        s = chunk * T + np.arange(T)                       # the tile's steps
        ok = (s < S)[:, None] & rok[None]
        sc = np.minimum(s, S - 1)
        # a one step later (1 past S - 1), the state one step earlier
        ap = np.where(((s + 1 < S)[:, None]) & rok[None],
                      a[b][np.minimum(s + 1, S - 1)][:, rc], np.float32(1))
        g = np.where(ok, dy[b][sc][:, rc], np.float32(0)) if dy is not None \
            else np.zeros((T, CH), np.float32)
        start_h = h0[b, rc] if h0 is not None else np.zeros(CH, np.float32)
        prev = np.where((s > 0)[:, None], hh[b][np.clip(s - 1, 0, S - 1)][:, rc], start_h[None])
        hp = np.where(ok, prev, np.float32(0))
        ap, g = ap.reshape(NW, SEG, CH), g.reshape(NW, SEG, CH)
        A, Bs = np.ones((NW, CH), np.float32), np.zeros((NW, CH), np.float32)
        for u in range(SEG - 1, -1, -1):                   # segments, latest step first
            Bs = _fma(ap[:, u], Bs, g[:, u])
            A = (A * ap[:, u]).astype(np.float32)
        TA, TB = np.ones(CH, np.float32), np.zeros(CH, np.float32)
        for w in range(NW - 1, -1, -1):
            TB = _fma(A[w], TB, Bs[w])
            TA = (TA * A[w]).astype(np.float32)
        if t < stride:
            cin = dh_last[b, rc] if dh_last is not None else np.zeros(CH, np.float32)
        else:
            assert t - stride in published, "a tile ran before its predecessor"
            cin = published[t - stride]
        if chunk > 0:
            published[t] = _fma(TA, cin, TB)
        d_w = np.zeros((NW, CH), np.float32)
        d = cin
        for w in range(NW - 1, -1, -1):
            d_w[w] = d
            d = _fma(A[w], d, Bs[w])
        hp = hp.reshape(NW, SEG, CH)
        for w in range(NW):
            d = d_w[w]
            for u in range(SEG - 1, -1, -1):
                d = _fma(ap[w, u], d, g[w, u])
                step = chunk * T + w * SEG + u
                if step < S:
                    dbx[b, step, r[rok]] = d[rok]
                    da[b, step, r[rok]] = (d * hp[w, u])[rok]
            if chunk == 0 and w == 0 and h0 is not None:
                dh0[b, r[rok]] = (a[b, 0, rc] * d)[rok]
    return da, dbx, dh0 if h0 is not None else None, published


def sequential_bwd_model(a, hh, dy, h0, dh_last):
    """The sequential route: one thread a channel walking t down, a one
    step later in a register; the top S mod kUnroll steps one at a time,
    then groups of kUnroll (the same arithmetic in the same order)."""
    B, S, R = a.shape
    d = dh_last.copy() if dh_last is not None else np.zeros((B, R), np.float32)
    an = np.ones((B, R), np.float32)
    start = h0 if h0 is not None else np.zeros((B, R), np.float32)
    da, dbx = np.zeros_like(a), np.zeros_like(a)
    for t in range(S - 1, -1, -1):
        d = _fma(an, d, dy[:, t] if dy is not None else np.float32(0))
        dbx[:, t] = d
        da[:, t] = d * (hh[:, t - 1] if t > 0 else start)
        an = a[:, t]
    return da, dbx, (an * d).astype(np.float32) if h0 is not None else None


@pytest.mark.parametrize("B,S,R,with_h0,with_dh_last,dy_kind", [
    (1, 65, 32, True, True, "f32"),         # one past SHORT_S: one partial tile
    (2, 300, 40, True, False, "f32"),       # 3 tiles, partial last, R % 32 != 0
    (2, 2 * T, 33, False, True, "bf16"),    # whole tiles, a one-lane group
    (3, 1000, 70, True, True, "none"),      # 8 tiles a chain, 3 groups
    (2, 5, 40, True, True, "f32"),          # the sequential route (verify)
    (1, SHORT_S, 96, False, True, "bf16"),  # SHORT_S itself
])
def test_kernel_model_equals_plain(B, S, R, with_h0, with_dh_last, dy_kind):
    a, bx, h0, dy, dh_last = _inputs(S + R, B, S, R)
    h0 = h0 if with_h0 else None
    dh_last = dh_last if with_dh_last else None
    if dy_kind == "bf16":
        dy = torch.from_numpy(dy).to(torch.bfloat16).float().numpy()
    elif dy_kind == "none":
        dy = None
    hh = _states(a, bx, h0)
    route = krs.scan_plan(B, S, R, backward=True)["route"]
    assert route == ("chunked_bwd" if S > SHORT_S else "sequential_bwd")
    if route == "chunked_bwd":
        got = chunked_bwd_model(a, hh, dy, h0, dh_last)[:3]
    else:
        got = sequential_bwd_model(a, hh, dy, h0, dh_last)
    t = (lambda x: None if x is None else torch.from_numpy(x))  # noqa: E731
    want = krs.rglru_scan_bwd_ref(t(a), t(hh), t(dy), t(h0), t(dh_last))
    for name, g, w in zip(("a", "bx", "h0"), got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert _scaled_err(g, w) <= TOL, name


def test_kernel_model_carry_order_is_fixed():
    """Each tile's carry is its predecessor's published state and nothing
    else: tiles run in any order that keeps a chain's predecessors first
    (here: channel groups and rows interleaved backwards, chains at
    different depths) give the same bits; a tile run before its
    predecessor is caught."""
    B, S, R = 2, 700, 70
    a, bx, h0, dy, dh_last = _inputs(11, B, S, R)
    hh = _states(a, bx, h0)
    first = chunked_bwd_model(a, hh, dy, h0, dh_last)
    stride, nchunks = B * -(-R // CH), -(-S // T)
    order = sorted(range(stride * nchunks), key=lambda t: (t // stride, -(t % stride)))
    order = order[stride:][::2] + order[:stride] + order[stride:][1::2]
    with pytest.raises(AssertionError, match="predecessor"):
        chunked_bwd_model(a, hh, dy, h0, dh_last, schedule=order)
    rs = np.random.RandomState(0)
    ready, done, sched = list(range(stride)), set(), []
    while ready:
        t = ready.pop(rs.randint(len(ready)))
        sched.append(t)
        done.add(t)
        if t + stride < stride * nchunks:
            ready.append(t + stride)
    second = chunked_bwd_model(a, hh, dy, h0, dh_last, schedule=sched)
    assert sched != sorted(sched)
    for x, y in zip(first[:3], second[:3]):
        assert np.array_equal(x, y)
    assert first[3].keys() == second[3].keys()
    assert all(np.array_equal(first[3][k], second[3][k]) for k in first[3])


# ---------------------------------------------------------------------------
# the C entries, the plan, the operators and the Function
# ---------------------------------------------------------------------------

_CTYPE = {"void*": "c_void_p", "int": "c_int"}


def _c_signature(name):
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', SOURCE)
    args = [x.strip() for x in m.group(1).replace("\n", " ").split(",")]
    types = []
    for x in args:
        t = re.sub(r"\bconst\b", "", x).rsplit(" ", 1)[0].replace(" ", "")
        types.append(_CTYPE["void*" if t.endswith("*") else t])
    return types


@pytest.mark.parametrize("name,argtypes", [("rglru_scan_fwd", krs.FWD_ARGTYPES),
                                           ("rglru_scan_bwd", krs.BWD_ARGTYPES)])
def test_c_entry_arguments_are_the_wrapper_argtypes(name, argtypes):
    assert _c_signature(name) == [t.__name__ for t in argtypes]


def test_wrapper_geometry_is_the_source():
    assert (krs.SEG, krs.NW, krs.CH, krs.SHORT_S, krs.T) == (SEG, NW, CH, SHORT_S, T)


@pytest.mark.parametrize("B,S,R,route,ntiles", [
    (2, 2048, 4096, "chunked_bwd", 2 * 128 * 16),   # recurrentgemma-9b's microbatch
    (4, 5, 256, "sequential_bwd", 0),
    (2, 65, 100, "chunked_bwd", 2 * 4),
    (1, 300, 33, "chunked_bwd", 2 * 3),
])
def test_backward_scan_plan(B, S, R, route, ntiles):
    plan = krs.scan_plan(B, S, R, backward=True)
    assert plan["route"] == route and plan["ntiles"] == ntiles
    want = {"carry": (ntiles * CH + 1,)} if ntiles else {}
    assert plan["scratch"] == want


def test_backward_operator_refuses_cpu_tensors():
    a = torch.rand(1, 70, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        torch.ops.repro_torch.rglru_scan_bwd(a, a, a, None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        torch.ops.repro_torch.rglru_scan(a, a, None, torch.bfloat16, True)


def test_function_keeps_the_float32_states():
    """The forward returns y in the output dtype and saves the float32
    states the backward reads: y is those states rounded; the CPU counts
    no launch in either direction."""
    a, bx, h0, dy, _ = _inputs(5, 2, 90, 12)
    ta, tb, th = (torch.from_numpy(x) for x in (a, bx, h0))
    y, h_last, hh = krs._forward(ta, tb, th, out_dtype=torch.bfloat16, with_states=True)
    want, hw = krs.rglru_scan_ref(ta, tb, th)
    assert hh.dtype == torch.float32 and torch.equal(hh, want) and torch.equal(h_last, hw)
    assert torch.equal(y, want.to(torch.bfloat16))
    y32, _, hh32 = krs._forward(ta, tb, th, with_states=True)
    assert hh32 is y32
    before, n = dict(krs.launches_by_route), krs.launches
    ins = [x.clone().requires_grad_() for x in (ta, tb, th)]
    y, _ = krs.rglru_scan(*ins, out_dtype=torch.bfloat16)
    got = torch.autograd.grad(y, ins, torch.from_numpy(dy).to(torch.bfloat16))
    want = krs.rglru_scan_bwd_ref(ta, hh, torch.from_numpy(dy).to(torch.bfloat16), th)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert krs.launches_by_route == before and krs.launches == n


def test_cost_counter_answers_both_operators():
    """On meta: the forward under autograd is one ``rglru_scan`` with its
    float32 states (their bytes counted and held for the backward), the
    backward one ``rglru_scan_bwd`` at ``costs.rglru_bwd``; no product."""
    from repro_torch.launch import cost
    B, S, R = 2, 300, 64
    a, bx = (torch.empty(B, S, R, device="meta", requires_grad=True) for _ in range(2))
    h0 = torch.empty(B, R, device="meta", requires_grad=True)
    with cost.CostCounter() as counter:
        y, _ = krs.rglru_scan(a, bx, h0, out_dtype=torch.bfloat16)
        torch.autograd.grad(y, (a, bx, h0), torch.empty_like(y))
    res = counter.result()
    assert res["kernels"] == {"rglru_scan": 1, "rglru_scan_bwd": 1}
    fwd = costs.rglru(B, S, R, 2, True, True)
    assert fwd[1] == (4 + 4 + 2 + 4) * B * S * R + 8 * B * R
    bwd = costs.rglru_bwd(B, S, R)
    assert res["kernel_flops_by"]["rglru_scan"] == sum(fwd[0].values())
    assert res["kernel_flops_by"]["rglru_scan_bwd"] == sum(bwd[0].values())
    assert res["bytes_min"] >= fwd[1] + bwd[1]
    assert res["peak_bytes"] >= 4 * B * S * R
    assert not res["range_product_flops"]


def test_backward_bound_at_the_train_microbatch():
    """18 bytes an element (a, the states, dy in bf16 read; da, dbx
    written): 0.0901 ms at 3.35 TB/s for [2, 2048, 4096]; the forward with
    its states 14 (0.0701 ms)."""
    ms, by = costs.bound_ms(costs.rglru_bwd(2, 2048, 4096))
    assert by == "bytes" and abs(ms - 18 * 2 * 2048 * 4096 / 3.35e9) < 1e-12
    ms, by = costs.bound_ms(costs.rglru(2, 2048, 4096, 2, False, True))
    assert by == "bytes" and abs(ms - 14 * 2 * 2048 * 4096 / 3.35e9) < 1e-12
    assert costs.rglru(2, 64, 32, 4, False, True) == costs.rglru(2, 64, 32, 4, False)
