"""The mLSTM backward's contract on the CPU, against the JAX package.

The backward kernels (``csrc/mlstm_chunk_bwd_wgmma.cu``, bf16;
``csrc/mlstm_chunk_bwd.cu``, float32, the gate phase and the C entry) run
only on the card, where tests/test_torch_gpu.py holds them to their plain
versions. Here, on numpy inputs made with a seed:

* the plain backward ``mlstm_chunk_bwd`` equals ``jax.vjp`` of the
  reference's ``repro.models.xlstm.mlstm_chunkwise`` (the XLA path the
  reference trains on) in float32, relative to max(1, the gradient's
  largest value): S not a multiple of the chunk, a chunk longer than S, a
  state in, input gates of scale 20, dh with a (dC, dn) of the state out
  (the state out's m gets what a reader invariant to the stabiliser's shift
  gives it, Σ dC·C + Σ dn·n). The reference keeps its state in float32, so
  there is no float64 reference: at gates of scale 1 the two sit within
  ``TOL``; at scale 20 each float32 gradient rounds the stabilised
  exponents its own way (~1e-3 apart, as tests/test_torch_stateful_training.py
  finds against float64), and the port is held to be no further from the
  exact gradient (the plain backward in float64, held to float64 autograd
  there at 1e-9) than twice the reference's float32 vjp is;
* the chunk start states the forward keeps for the backward
  (``with_states``), through their plain version ``chunk_states_ref``, equal
  the reference's state after each prefix of whole chunks;
* the C entry points' argument lists equal the wrapper's ctypes
  ``argtypes``; the backward's plan (grids, scratch) and the constants it
  shares with the sources; the routes; the backward operator refuses CPU
  tensors (the Function takes the plain version there);
* the dry run's cost counter answers the backward's operator with
  ``costs.mlstm_bwd_kernel``, and the forward's kept states count toward
  its peak.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import xlstm as jx  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.kernels import mlstm_chunk as kmc  # noqa: E402

TOL = 1e-5          # float32 against the reference's float32 vjp, gates of scale 1
CSRC = Path(kmc.__file__).with_name("csrc")
NAMES = ("q", "k", "v", "ig", "fg")

# B, S, H, hd, chunk, ig_scale, state_in, dstate
CASES = [
    (2, 37, 2, 8, 16, 1.0, False, True),    # S not a multiple of the chunk
    (1, 10, 2, 8, 32, 1.0, False, True),    # a chunk longer than S
    (2, 45, 2, 16, 16, 1.0, True, True),    # a state in, padded rows
    (2, 64, 3, 8, 16, 20.0, False, False),  # input gates of scale 20
    (2, 64, 2, 16, 16, 20.0, True, True),   # scale 20, a state in and out
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, S, H, hd, ig_scale):
    rs = np.random.RandomState(seed)

    def f(*shape):
        return rs.standard_normal(shape)

    q, k = f(B, S, H, hd) * 0.5, f(B, S, H, hd) * 0.5
    v, ig, fg, dh = f(B, S, H, hd), f(B, S, H) * ig_scale, f(B, S, H) + 2.0, f(B, S, H, hd)
    dC, dn = f(B, H, hd, hd), f(B, H, hd)
    return [x.astype(np.float32) for x in (q, k, v, ig, fg, dh, dC, dn)]


def _jax_vjp(q, k, v, ig, fg, dh, dC, dn, state, chunk):
    """The reference's gradient at (q, k, v, ig, fg); dC, dn None: the state
    out gets no gradient."""
    def fn(*a):
        return jx.mlstm_chunkwise(*a, state, chunk=chunk)

    (_, (C, n, m)), vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v, ig, fg)))
    if dC is None:
        ct = (jnp.asarray(dh), (jnp.zeros_like(C), jnp.zeros_like(n), jnp.zeros_like(m)))
    else:
        dC, dn = jnp.asarray(dC), jnp.asarray(dn)
        dm = (dC * C).sum((-2, -1)) + (dn * n).sum(-1)     # an invariant reader's
        ct = (jnp.asarray(dh), (dC, dn, dm))
    return [np.asarray(g) for g in vjp(ct)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("B,S,H,hd,chunk,ig_scale,state_in,dstate", CASES)
def test_plain_backward_equals_jax_vjp(B, S, H, hd, chunk, ig_scale, state_in, dstate):
    q, k, v, ig, fg, dh, dC, dn = _inputs(S + 7 * hd, B, S, H, hd, ig_scale)
    if not dstate:
        dC = dn = None
    jstate = None
    if state_in:
        _, jstate = jx.mlstm_chunkwise(*(jnp.asarray(x[:, :9]) for x in (q, k, v, ig, fg)),
                                       chunk=chunk)
    want = _jax_vjp(q, k, v, ig, fg, dh, dC, dn, jstate, chunk)
    assert all(np.isfinite(w).all() for w in want)

    def ours(dtype):
        def t(x):
            return None if x is None else torch.from_numpy(np.array(x)).to(dtype)
        state = None if jstate is None else tuple(t(x) for x in jstate)
        dstate_t = None if dC is None else (t(dC), t(dn))
        return kmc.mlstm_chunk_bwd(*(t(x) for x in (q, k, v, ig, fg, dh)), state,
                                   dstate_t, chunk=chunk)

    got, exact = ours(torch.float32), ours(torch.float64)
    for name, g, w, x in zip(NAMES, got, want, exact):
        assert g.dtype == torch.float32, name
        if ig_scale <= 1.0:
            assert _rel(g, w) <= TOL, (name, _rel(g, w))
        else:
            bound = max(TOL, 2 * _rel(w, x))
            assert _rel(g, x) <= bound, (name, _rel(g, x), bound)


def _schedule_model(q, k, v, ig, fg, dh, state, dstate, chunk, tile):
    """The bf16 route's schedule (``csrc/mlstm_chunk_bwd_wgmma.cu`` and the
    gate phase of ``csrc/mlstm_chunk_bwd.cu``) in plain PyTorch at the
    inputs' precision, one (row, head) at a time, from the chunk start
    states the forward keeps (``chunk_states_ref``) and ``tile``-row query
    tiles: (dq, dk, dv, dig, dfg) like ``mlstm_chunk_bwd``.

    * pairs: per chunk, S = q·kᵀ and P = dh·vᵀ give the row scalars (first
      pass); the second pass keeps ds' and w / denom, each row's Σ dlogD
      and each query tile's part of a key's Σ dlogD; dq = ds'·k, dk = ds'ᵀ·q
      and dv = (w / denom)ᵀ·dh read only the kept matrices;
    * carry: every GC_c = qᵀ·(dh ⊙ inter / denom) (c >= 1) at once, then the
      elementwise recurrence dCE_c = dC, dC <- dC decay_c + GC_c (and dn),
      with each chunk's Σ dCE_c ⊙ C_c + dnE_c ⊙ n_c;
    * gates: per chunk each row's star column, its residual's fix (in row
      order), dig and dF before the carry and the chunk's scalars; then per
      chunk the reverse carry of m_next's gradient from the last chunk to
      it, its tail into the last dF, and dfg = revcumsum(dF)·σ(−fg)."""
    B, S, H, hd = q.shape
    L = min(chunk, S)
    nc = -(-S // L)
    Sp = nc * L
    dt = q.dtype
    scale = hd ** -0.5
    CT, nS, mS = kmc.chunk_states_ref(q, k, v, ig, fg, state, chunk=chunk)
    _, (C_end, n_end, _) = kmc.mlstm_chunk_ref(q, k, v, ig, fg, state, chunk=chunk)
    pad = Sp - S
    qs, kp, vp, dhp = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                       for x in (q * scale, k, v, dh))
    igp = torch.nn.functional.pad(ig, (0, 0, 0, pad), value=kmc.NEG_INF)
    fgp = torch.nn.functional.pad(fg, (0, 0, 0, pad), value=30.0)
    dC_out, dn_out = dstate if dstate is not None else (None, None)
    grads = [torch.zeros(B, Sp, H, hd, dtype=dt) for _ in range(3)] + \
        [torch.zeros(B, Sp, H, dtype=dt) for _ in range(2)]
    dq, dk, dv, dig, dfg = grads
    ntile = -(-L // tile)
    tril = torch.tril(torch.ones(L, L, dtype=torch.bool))
    for b in range(B):
        for h in range(H):
            bh = b * H + h
            ch = []     # what each chunk's phases hand on
            for c in range(nc):
                sl = slice(c * L, (c + 1) * L)
                Q, K, V, DH = (x[b, sl, h] for x in (qs, kp, vp, dhp))
                Ig = igp[b, sl, h]
                Fc = torch.cumsum(torch.nn.functional.logsigmoid(fgp[b, sl, h]), 0)
                logD = Fc[:, None] - Fc[None, :] + Ig[None, :]
                mi = logD.masked_fill(~tril, kmc.NEG_INF).amax(1)
                Cc, nc_, m_c = CT[bh, c].T, nS[bh, c], mS[bh, c]
                m_inter = Fc + m_c
                mj = torch.maximum(m_inter, mi)
                inter, lo = torch.exp(m_inter - mj), torch.exp(-mj)
                D = torch.exp(logD - mj[:, None]).masked_fill(~tril, 0.0)
                # phase 0: X = dh·C_cᵀ, each row's q·X and q·n_c
                X = DH @ Cc.T
                hx, qn_c = (Q * X).sum(1), Q @ nc_
                # phase 1, first pass: the row scalars
                Wm, P = (Q @ K.T) * D, DH @ V.T
                qn = inter * qn_c + Wm.sum(1)
                denom = torch.maximum(qn.abs(), lo)
                dhh = inter * hx + (Wm * P).sum(1)
                br = (qn.abs() > lo).to(dt) + 0.5 * (qn.abs() == lo).to(dt)
                dqn = -dhh / denom ** 2 * br * torch.sign(qn)
                lb = (qn.abs() < lo).to(dt) + 0.5 * (qn.abs() == lo).to(dt)
                R, Di = lb * dhh / denom, (hx / denom + dqn * qn_c) * inter
                # second pass: the kept tiles, Σ dlogD by row and by query tile
                T = P / denom[:, None] + dqn[:, None]
                DS, WD, DL = D * T, Wm / denom[:, None], Wm * T
                colp = torch.stack([DL[jt * tile:(jt + 1) * tile].sum(0)
                                    for jt in range(ntile)])
                FL, top = Fc[-1], mi[-1]
                m_next = torch.maximum(FL + m_c, top)
                ch.append(dict(Q=Q, K=K, V=V, DH=DH, Ig=Ig, Fc=Fc, logD=logD, mi=mi,
                               m_inter=m_inter, inter=inter, X=X, denom=denom, dqn=dqn,
                               R=R, Di=Di, DS=DS, WD=WD, rowsum=DL.sum(1), colp=colp,
                               C=Cc, n=nc_, live=state is not None or c > 0, m_c=m_c,
                               FL=FL, top=top, decay=torch.exp(FL + m_c - m_next),
                               sc=torch.exp(FL - Fc + Ig - m_next)))
            # phase 2: every GC_c at once, then the recurrence
            GC = [None] + [x["Q"].T @ (x["DH"] * (x["inter"] / x["denom"])[:, None])
                           for x in ch[1:]]
            Gn = [None] + [x["Q"].T @ (x["dqn"] * x["inter"]) for x in ch[1:]]
            E = torch.zeros(hd, hd, dtype=dt) if dC_out is None else dC_out[b, h]
            En = torch.zeros(hd, dtype=dt) if dn_out is None else dn_out[b, h]
            dm = torch.zeros((), dtype=dt)
            if dstate is not None:
                dm = (E * C_end[b, h]).sum() + (En * n_end[b, h]).sum()
            for c in reversed(range(nc)):
                x = ch[c]
                x["dCE"], x["dnE"] = E, En
                x["ddp"] = (E * x["C"]).sum() * x["live"] + (En * x["n"]).sum()
                if c > 0:
                    E, En = E * x["decay"] + GC[c], En * x["decay"] + Gn[c]
            # phases 3, 4: dq, dk, dv from the kept tiles and phase 0's state terms
            for c, x in enumerate(ch):
                sl = slice(c * L, (c + 1) * L)
                dq[b, sl, h] = (x["DS"] @ x["K"] + (x["inter"] / x["denom"])[:, None] * x["X"]
                                + (x["dqn"] * x["inter"])[:, None] * x["n"]) * scale
                dCv = x["V"] @ x["dCE"].T + x["dnE"]
                x["dlsc"] = x["sc"] * (x["K"] * dCv).sum(1)
                dk[b, sl, h] = x["DS"].T @ x["Q"] + x["sc"][:, None] * dCv
                dv[b, sl, h] = x["WD"].T @ x["DH"] + (x["K"] * x["sc"][:, None]) @ x["dCE"]
            # the gate phase: per chunk, then the cross-chunk carry
            for x in ch:
                res = (x["rowsum"] + x["Di"]) - x["R"]
                fix = torch.zeros(L, dtype=dt)
                for j in range(L):
                    if x["mi"][j] >= x["m_inter"][j]:
                        star = next(i for i in range(j + 1) if x["logD"][j, i] == x["mi"][j])
                        fix[star] += res[j]
                col = x["colp"].sum(0)
                x["dig"] = (col - fix) + x["dlsc"]
                x["dF"] = ((x["R"] - col) + fix) - x["dlsc"]
                base = (x["Di"] - torch.where(x["m_inter"] > x["mi"], res, 0.0)).sum()
                hit = [j for j in range(L) if (x["FL"] - x["Fc"][j]) + x["Ig"][j] == x["top"]]
                x["top_at"] = hit[0] if hit else L - 1
                x["parts"] = x["dlsc"].sum() + x["ddp"] * x["decay"]
                x["base"] = base + x["ddp"] * x["decay"]
                x["carried"] = bool(x["FL"] + x["m_c"] >= x["top"])
            for c in reversed(range(nc)):
                x = ch[c]
                G = dm - x["parts"]
                at = torch.zeros(L, dtype=dt)
                at[x["top_at"]] = 0.0 if x["carried"] else G
                dm = x["base"] + (G if x["carried"] else 0.0)
                dF = x["dF"] - at
                dF[-1] += x["parts"] + G
                sl = slice(c * L, (c + 1) * L)
                dig[b, sl, h] = x["dig"] + at
                dfg[b, sl, h] = torch.flip(torch.cumsum(torch.flip(dF, (0,)), 0), (0,)) \
                    * torch.sigmoid(-fgp[b, sl, h])
    return tuple(g[:, :S] for g in grads)


@pytest.mark.parametrize("B,S,H,hd,chunk,ig_scale,state_in,dstate", CASES)
def test_schedule_model_equals_plain_backward_and_jax_vjp(B, S, H, hd, chunk, ig_scale,
                                                          state_in, dstate):
    """The bf16 route's schedule, modelled in plain PyTorch with 4-row query
    tiles (so a chunk has several): in float64 it equals the plain backward
    (1e-10 relative to max(1, the gradient's largest value)); in float32 it
    sits where the plain backward does against ``jax.vjp`` of the reference
    (``test_plain_backward_equals_jax_vjp``'s bounds)."""
    q, k, v, ig, fg, dh, dC, dn = _inputs(S + 7 * hd, B, S, H, hd, ig_scale)
    if not dstate:
        dC = dn = None
    jstate = None
    if state_in:
        _, jstate = jx.mlstm_chunkwise(*(jnp.asarray(x[:, :9]) for x in (q, k, v, ig, fg)),
                                       chunk=chunk)

    def run(fn, dtype, **kw):
        def t(x):
            return None if x is None else torch.from_numpy(np.array(x)).to(dtype)
        state = None if jstate is None else tuple(t(x) for x in jstate)
        dstate_t = None if dC is None else (t(dC), t(dn))
        return fn(*(t(x) for x in (q, k, v, ig, fg, dh)), state, dstate_t, chunk=chunk, **kw)

    model64 = run(_schedule_model, torch.float64, tile=4)
    exact = run(kmc.mlstm_chunk_bwd, torch.float64)
    for name, g, x in zip(NAMES, model64, exact):
        assert _rel(g, x) <= 1e-10, (name, _rel(g, x))
    want = _jax_vjp(q, k, v, ig, fg, dh, dC, dn, jstate, chunk)
    model32 = run(_schedule_model, torch.float32, tile=4)
    for name, g, w, x in zip(NAMES, model32, want, exact):
        assert g.dtype == torch.float32, name
        if ig_scale <= 1.0:
            assert _rel(g, w) <= TOL, (name, _rel(g, w))
        else:
            bound = max(TOL, 2 * _rel(w, x))
            assert _rel(g, x) <= bound, (name, _rel(g, x), bound)


@pytest.mark.parametrize("S,chunk,state_in", [(64, 16, False), (50, 16, True),
                                              (10, 32, False)])
def test_kept_chunk_states_equal_jax_prefix_states(S, chunk, state_in):
    B, H, hd = 2, 2, 8
    q, k, v, ig, fg = _inputs(S + chunk, B, S, H, hd, 1.0)[:5]
    jstate = None
    if state_in:
        _, jstate = jx.mlstm_chunkwise(*(jnp.asarray(x[:, :7]) for x in (q, k, v, ig, fg)),
                                       chunk=chunk)
    state = None if jstate is None else tuple(torch.from_numpy(np.array(x)) for x in jstate)
    CT, nS, mS = kmc.chunk_states_ref(*(torch.from_numpy(x) for x in (q, k, v, ig, fg)),
                                      state, chunk=chunk)
    L = min(chunk, S)
    nc = -(-S // L)
    plan = kmc.states_plan(B, S, H, hd, chunk, torch.bfloat16)
    assert (tuple(CT.shape), tuple(nS.shape), tuple(mS.shape)) == tuple(
        plan[n][0] for n in ("CT", "nS", "mS"))
    for c in range(nc):
        if c == 0:
            want = jstate if state_in else (np.zeros((B, H, hd, hd)), np.zeros((B, H, hd)),
                                            np.full((B, H), kmc.NEG_INF))
        else:
            _, want = jx.mlstm_chunkwise(*(jnp.asarray(x[:, :c * L])
                                           for x in (q, k, v, ig, fg)), jstate, chunk=L)
        C, n, m = (np.asarray(x, np.float64) for x in want)
        np.testing.assert_allclose(CT[:, c].reshape(B, H, hd, hd).transpose(-1, -2), C,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(nS[:, c].reshape(B, H, hd), n, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mS[:, c].reshape(B, H), m, rtol=1e-5, atol=1e-5)


def test_function_keeps_no_states_on_the_cpu():
    """The CPU's forward is the plain version; its backward recomputes the
    chunk states, so the Function saves none there."""
    q, k, v, ig, fg = (torch.from_numpy(x) for x in _inputs(3, 1, 20, 2, 8, 1.0)[:5])
    h, st, kept = kmc._forward(q, k, v, ig, fg, chunk=8, with_states=True)
    assert kept == ()
    h2, st2 = kmc._forward(q, k, v, ig, fg, chunk=8)
    assert torch.equal(h, h2) and all(torch.equal(a, b) for a, b in zip(st, st2))


def test_backward_operator_refuses_cpu_tensors():
    q, k, v, ig, fg, dh = (torch.from_numpy(x) for x in _inputs(6, 1, 16, 2, 32, 1.0)[:6])
    C, n, _ = kmc.zero_state(1, 2, 32, "cpu")
    e = torch.empty(0)
    with pytest.raises(ValueError, match="unsupported device"):
        torch.ops.repro_torch.mlstm_chunk_bwd(q, k, v, ig, fg, dh, None, None, C, n, e, e,
                                              e, e, False, 16)


# ---------------------------------------------------------------------------
# the C entries, the plan, constants and routes
# ---------------------------------------------------------------------------

_CTYPE = {"void*": "c_void_p", "int": "c_int", "float": "c_float"}


def _c_signature(source, name):
    text = (CSRC / source).read_text()
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
    args = [a.strip() for a in m.group(1).replace("\n", " ").split(",")]
    types = []
    for a in args:
        t = re.sub(r"\bconst\b", "", a).rsplit(" ", 1)[0].replace(" ", "")
        types.append(_CTYPE["void*" if t.endswith("*") else t])
    return types


@pytest.mark.parametrize("source,name,argtypes", [
    ("mlstm_chunk.cu", "mlstm_chunk_fwd", kmc.FWD_ARGTYPES),
    ("mlstm_chunk_bwd.cu", "mlstm_chunk_bwd", kmc.BWD_ARGTYPES),
])
def test_c_entry_arguments_are_the_wrapper_argtypes(source, name, argtypes):
    assert _c_signature(source, name) == [t.__name__ for t in argtypes]


def _constexpr(source, name):
    return re.findall(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())


@pytest.mark.parametrize("source,name,value", [
    ("mlstm_chunk_bwd_wgmma.cu", "TILE", kmc.TILE),
    ("mlstm_chunk_bwd_wgmma.cu", "MAX_L", kmc.MAX_CHUNK),
    ("mlstm_chunk_bwd.cu", "MAX_L", kmc.MAX_CHUNK),
    ("mlstm_chunk_bwd.cu", "CARRY_NT", kmc.CARRY_NT),
    ("mlstm_chunk_bwd.cu", "WNT", 32 * kmc.ROWS_A_BLOCK),
    ("mlstm_chunk_bwd_wgmma.cu", "RT", kmc.REC_TILE),
])
def test_backward_constants_are_the_kernel_sources(source, name, value):
    assert _constexpr(source, name) == [str(value)]


def test_row_scratch_layout_is_one_in_both_sources():
    """Both sources index the row scratch the same way, ``ROW_SCALARS``
    a row."""
    enum = ("enum { kDenom = 0, kDqn = 1, kR = 2, kDi = 3, kRowsum = 4, kColsum = 5, "
            f"NR = {kmc.ROW_SCALARS} }};")
    for source in ("mlstm_chunk_bwd.cu", "mlstm_chunk_bwd_wgmma.cu"):
        assert enum in (CSRC / source).read_text(), source


@pytest.mark.parametrize("B,S,H,hd,chunk,dtype,want", [
    # xlstm-350m's train microbatch: 4 chunks of 4 tiles, 8 column blocks,
    # dq and dk / dv 128 columns a block, the recurrence 256 tiles of dC + dn
    (4, 1024, 4, 512, 256, torch.bfloat16,
     dict(L=256, nc=4, Sp=1024, ntile=4, ncol=8, NP=257, bw=128,
          grids={"slab": (8, 4, 16), "pairs": (256,), "carry": (8, 8, 48),
                 "recurrence": (257, 16), "dq": (1024,), "dkdv": (1024,),
                 "gates": (4, 16), "gate_rows": (4, 16)})),
    # S not a multiple of the chunk, a partial tile, 64 columns a block
    (2, 100, 2, 64, 32, torch.bfloat16,
     dict(L=32, nc=4, Sp=128, ntile=1, ncol=1, NP=5, bw=64,
          grids={"slab": (1, 4, 4), "pairs": (16,), "carry": (1, 1, 12),
                 "recurrence": (5, 4), "dq": (16,), "dkdv": (16,), "gates": (4, 4),
                 "gate_rows": (4, 4)})),
    # float32: a warp a row, the carry a thread per element of dC and dn
    (2, 300, 2, 128, 256, torch.float32,
     dict(L=256, nc=2, Sp=512, ntile=4, ncol=1, NP=65, bw=None,
          grids={"gates64": (2, 4), "rows": (64, 2, 4), "carry": (65, 4),
                 "dq": (64, 2, 4), "dkdv": (64, 2, 4), "gates": (2, 4),
                 "gate_rows": (2, 4)})),
])
def test_backward_plan(B, S, H, hd, chunk, dtype, want):
    plan = kmc.bwd_plan(B, S, H, hd, chunk, dtype)
    assert {k: plan[k] for k in want} == want
    BH, nc, Sp, ncol, NP = B * H, want["nc"], want["Sp"], want["ncol"], want["NP"]
    ntile = want["ntile"]
    scratch = {"rows": (BH, 6, Sp), "dlsc": (BH, ncol, Sp), "dCE": (BH, nc, hd, hd),
               "dnE": (BH, nc, hd), "ddp": (BH, nc, NP), "dmp": (BH, NP),
               "gsc": (BH, 2 * Sp + 4 * nc)}     # float64: each row's dig, dF; 4 a chunk
    if dtype == torch.float32:
        scratch["gates"] = (BH, 3, Sp)       # float64, the route's own gates
    else:
        # the state products a row and their partials; each query tile's part
        # of a key's Σ dlogD; each pair tile's S and P between the two passes;
        # the kept pair tiles (bf16); tiles of the lower triangle
        ntri = ntile * (ntile + 1) // 2
        scratch.update(xs=(2, BH, Sp, hd), xq=(BH, 2, ncol, Sp), cols=(BH, ntile, Sp),
                       sp=(BH, nc, ntri, 2, 64 * 64), pt=(2, BH, nc, ntri, 64 * 64))
    assert plan["scratch"] == scratch
    assert kmc.SCRATCH_DTYPES == {"pt": torch.bfloat16, "gates": torch.float64,
                                  "gsc": torch.float64}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_states_plan(dtype):
    B, S, H, hd, chunk = 2, 100, 2, 64, 32
    plan = kmc.states_plan(B, S, H, hd, chunk, dtype)
    f32, f64 = torch.float32, torch.float64
    if dtype == torch.bfloat16:     # the forward's own scratch
        assert plan == {name: (shape, f32) for name, shape in
                        kmc.wgmma_plan(B, S, H, hd, chunk)["scratch"].items()}
    else:
        assert plan == {"gates": ((0,), f32), "CT": ((4, 4, 64, 64), f32),
                        "nS": ((4, 4, 64), f32), "mS": ((4, 4), f64)}


def test_routes_and_the_plain_version_counts_nothing():
    assert kmc.BWD_ROUTES == {torch.bfloat16: "wgmma_bwd", torch.float32: "simt_f32_bwd"}
    before, n = dict(kmc.launches_by_route), kmc.launches
    for dtype in (torch.float32, torch.bfloat16):
        ins = [torch.from_numpy(x).to(dtype if i < 3 else torch.float32).requires_grad_()
               for i, x in enumerate(_inputs(2, 1, 12, 2, 8, 1.0)[:5])]
        h, _ = kmc.mlstm_chunk(*ins, chunk=8)
        torch.autograd.grad(h, ins, torch.ones_like(h))
    assert kmc.launches_by_route == before and kmc.launches == n


# ---------------------------------------------------------------------------
# the dry run's counter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cost_counter_answers_the_backward_kernel(dtype):
    from repro_torch.launch import cost
    B, S, H, hd, chunk = 2, 300, 2, 64, 128
    x = [torch.empty(B, S, H, hd, dtype=dtype, device="meta", requires_grad=True)
         for _ in range(3)]
    g = [torch.empty(B, S, H, device="meta", requires_grad=True) for _ in range(2)]
    with cost.CostCounter() as counter:
        h, _ = kmc.mlstm_chunk(*x, *g, chunk=chunk)
        torch.autograd.grad(h, x + g, torch.empty_like(h))
    res = counter.result()
    assert res["kernels"] == {"mlstm_chunk": 1, "mlstm_chunk_bwd": 1}
    fwd = costs.mlstm(B, S, H, hd, chunk, x[0].element_size(), False)
    bwd = costs.mlstm_bwd_kernel(B, S, H, hd, min(chunk, S), x[0].element_size())
    assert res["kernel_flops_by"]["mlstm_chunk"] == sum(fwd[0].values())
    assert res["kernel_flops_by"]["mlstm_chunk_bwd"] == sum(bwd[0].values())
    assert not res["range_product_flops"]
    kept = sum(int(np.prod(shape)) * torch.empty(0, dtype=dt).element_size()
               for shape, dt in kmc.states_plan(B, S, H, hd, chunk, dtype).values())
    assert res["peak_bytes"] >= kept


def test_backward_kernel_cost_at_the_train_microbatch():
    """xlstm-350m's train microbatch: ~11 GFLOP in bf16 over the pairs (five
    products), ~34 in TF32 over the state (four: dh·(q C) is q·X, X = dh·Cᵀ
    being dq's term already); bound by operations."""
    ops, nbytes = costs.mlstm_bwd_kernel(4, 1024, 4, 512, 256)
    pairs = 256 * 257 // 2
    assert ops["bf16"] == 5 * 2 * 16 * 4 * pairs * 512
    assert ops["tf32"] == 4 * 2 * 16 * 4 * 256 * 512 * 512
    assert nbytes == 2 * 7 * 4 * 1024 * 4 * 512 + 16 * 4 * 1024 * 4 + 4 * 64 * (512 * 513 + 1)
    ms, by = costs.bound_ms((ops, nbytes))
    assert by == "operations" and 0.05 < ms < 0.15
