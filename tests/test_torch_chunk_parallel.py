"""The redesigned stateful kernels' decompositions, on the CPU.

The CUDA kernels cannot run here, so these tests hold what surrounds them
and the arithmetic they are built on:

* the wrappers' plans (``mlstm_chunk.wgmma_plan``: chunk and tile plan
  and the three phases' scratch shapes; ``rglru_scan.scan_plan``: route by
  S, tiles and scratch) and the constants the wrappers share with the
  ``.cu`` sources;
* a plain-PyTorch model of each kernel's decomposition, in the order the
  kernel computes it: the chunkwise-parallel mLSTM (gates, chunk states,
  all chunks' outputs at once from the states at their starts) and the
  chunked affine scan (segment and tile aggregates, carries by look-back,
  a replay of each tile from its carry), held against the JAX package's
  functions from numpy inputs made with a seed: float32 at 2e-5 (mLSTM)
  and 5e-6 (scan), the bounds of tests/test_kernels.py:101, 139.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan  # noqa: E402
from repro.models.xlstm import mlstm_chunkwise  # noqa: E402
from repro_torch.kernels import mlstm_chunk as kmc  # noqa: E402
from repro_torch.kernels import rglru_scan as krs  # noqa: E402

SCAN_TOL, MLSTM_TOL = 5e-6, 2e-5
NEG_INF = kmc.NEG_INF
CSRC = Path(kmc.__file__).with_name("csrc")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _constexpr(source, name):
    return re.findall(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())


# ---------------------------------------------------------------------------
# plans and constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source,name,value", [
    ("mlstm_chunk_wgmma.cu", "TILE", kmc.TILE),
    ("mlstm_chunk_wgmma.cu", "MAX_BV", kmc.MAX_BV),
    ("mlstm_chunk_wgmma.cu", "MAX_L", kmc.MAX_CHUNK),
    ("rglru_scan.cu", "SHORT_S", krs.SHORT_S), ("rglru_scan.cu", "SEG", krs.SEG),
    ("rglru_scan.cu", "NW", krs.NW), ("rglru_scan.cu", "CH", krs.CH),
])
def test_wrapper_constants_are_the_kernel_sources(source, name, value):
    """The wrappers size the scratch, check the chunk and pick the routes
    with their own copies of the kernels' geometry; the sources fix it as
    constexpr."""
    assert _constexpr(source, name) == [str(value)]


def test_route_names():
    assert kmc.ROUTES == {torch.bfloat16: "wgmma", torch.float32: "simt_f32"}
    assert kmc.BWD_ROUTES == {torch.bfloat16: "wgmma_bwd", torch.float32: "simt_f32_bwd"}
    assert set(kmc.launches_by_route) == {"wgmma", "simt_f32", "wgmma_bwd", "simt_f32_bwd"}
    assert set(krs.launches_by_route) == {"chunked", "sequential", "chunked_bwd",
                                          "sequential_bwd"}
    assert "constexpr int T = SEG * NW;" in (CSRC / "rglru_scan.cu").read_text()
    assert krs.T == krs.SEG * krs.NW


@pytest.mark.parametrize("B,S,H,hd,chunk,want", [
    # xlstm-350m's prefill at its largest bucket: 8 chunks of 4 row tiles,
    # 4 value tiles of 128 columns; 32 MiB of chunk states
    (1, 2048, 4, 512, 256, dict(L=256, nc=8, Sp=2048, ntile=4, bv=128)),
    # an extend shorter than the chunk: L = S, a partial row tile
    (1, 130, 4, 512, 256, dict(L=130, nc=1, Sp=130, ntile=3, bv=128)),
    # S not a multiple of the chunk, B > 1, 64-column value tiles
    (2, 100, 2, 64, 32, dict(L=32, nc=4, Sp=128, ntile=1, bv=64)),
])
def test_wgmma_plan(B, S, H, hd, chunk, want):
    plan = kmc.wgmma_plan(B, S, H, hd, chunk)
    assert {k: plan[k] for k in want} == want
    BH, nc = B * H, want["nc"]
    assert plan["scratch"] == {"gates": (BH, 3, want["Sp"]), "CT": (BH, nc, hd, hd),
                               "nS": (BH, nc, hd), "mS": (BH, nc)}
    if (B, S, hd) == (1, 2048, 512):
        assert 4 * np.prod(plan["scratch"]["CT"]) == 32 * 2 ** 20


@pytest.mark.parametrize("B,S,R,route,ntiles", [
    (1, 4096, 4096, "chunked", 4096),      # recurrentgemma-9b's largest prefill
    (4, 5, 4096, "sequential", 0),         # its verify step (spec_len 4)
    (2, 64, 100, "sequential", 0),         # SHORT_S itself
    (2, 65, 100, "chunked", 2 * 4 * 1),    # one past: a partial tile
    (1, 300, 33, "chunked", 2 * 3),        # a partial channel group
])
def test_scan_plan(B, S, R, route, ntiles):
    plan = krs.scan_plan(B, S, R)
    assert plan["route"] == route and plan["ntiles"] == ntiles
    if route == "chunked":
        assert plan["scratch"] == {"flags": (ntiles + 1,), "agg": (ntiles, 3, krs.CH)}
    else:
        assert plan["scratch"] == {}


# ---------------------------------------------------------------------------
# the chunkwise-parallel mLSTM, phase by phase
# ---------------------------------------------------------------------------


def mlstm_phases(q, k, v, ig, fg, state=None, *, chunk):
    """The bf16 route's decomposition in float32 (no bf16 or TF32 rounding),
    in the kernel's order. Returns (h, state out, the phase-2 scratch: C, n
    and m at every chunk start)."""
    B, S, H, hd = q.shape
    plan = kmc.wgmma_plan(B, S, H, hd, chunk)
    L, nc, Sp = plan["L"], plan["nc"], plan["Sp"]
    scale = hd ** -0.5
    pad = Sp - S
    qf, kf, vf = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
                  for x in (q, k, v))
    igp = torch.nn.functional.pad(ig.float(), (0, 0, 0, pad), value=NEG_INF)
    fgp = torch.nn.functional.pad(fg.float(), (0, 0, 0, pad), value=30.0)
    # [B, H, nc, L(, hd)]
    to_c = lambda x: x.reshape(B, nc, L, H, *x.shape[3:]).movedim(3, 1)  # noqa: E731
    qc, kc, vc, igc, fgc = map(to_c, (qf, kf, vf, igp, fgp))

    # ---- phase 1: F and the intra-chunk stabiliser of every row
    F = torch.cumsum(torch.nn.functional.logsigmoid(fgc), dim=-1)
    pair = (F[..., :, None] - F[..., None, :]) + igc[..., None, :]      # [.., j, i]
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool))
    m_intra = pair.masked_fill(~tri, NEG_INF).amax(dim=-1)

    # ---- phase 2: walk the chunks; the state at every chunk start
    if state is None:
        C, n, m = kmc.zero_state(B, H, hd, q.device)
    else:
        C, n, m = (t.clone() for t in state)
    Cs, ns, ms = [], [], []
    for c in range(nc):
        Cs.append(C)
        ns.append(n)
        ms.append(m)
        FL, g = F[:, :, c, -1], m_intra[:, :, c, -1]
        m_next = torch.maximum(FL + m, g)
        decay = torch.exp((FL + m) - m_next)
        sc = torch.exp(((FL[..., None] - F[:, :, c]) + igc[:, :, c]) - m_next[..., None])
        ks = kc[:, :, c] * sc[..., None]
        C = C * decay[..., None, None] + ks.transpose(-1, -2) @ vc[:, :, c]
        n = n * decay[..., None] + ks.sum(dim=-2)
        m = m_next
    C_at, n_at, m_at = (torch.stack(x, dim=2) for x in (Cs, ns, ms))

    # ---- phase 3: every chunk at once from its starting state
    m_inter = F + m_at[..., None]
    mj = torch.maximum(m_inter, m_intra)
    inter, emj = torch.exp(m_inter - mj), torch.exp(-mj)
    h_inter = (qc @ C_at) * (inter * scale)[..., None]
    if state is None:                    # the kernel skips chunk 0's q·C
        h_inter[:, :, 0] = 0.0
    qn = (qc @ n_at[..., None])[..., 0] * scale
    s = qc @ kc.transpose(-1, -2)
    w = torch.where(tri, s * scale * torch.exp(pair - mj[..., None]), torch.zeros(()))
    num = h_inter + w @ vc
    h = num / torch.maximum((inter * qn + w.sum(dim=-1)).abs(), emj)[..., None]
    h = h.movedim(1, 3).reshape(B, Sp, H, hd)[:, :S].to(q.dtype)
    return h, (C, n, m), (C_at, n_at, m_at)


def _mlstm_inputs(seed, B, S, H, hd, fg_shift=2.0):
    rs = np.random.RandomState(seed)
    q = (rs.standard_normal((B, S, H, hd)) * 0.5).astype(np.float32)
    k = (rs.standard_normal((B, S, H, hd)) * 0.5).astype(np.float32)
    v = rs.standard_normal((B, S, H, hd)).astype(np.float32)
    ig = rs.standard_normal((B, S, H)).astype(np.float32)
    fg = (rs.standard_normal((B, S, H)) + fg_shift).astype(np.float32)
    return q, k, v, ig, fg


@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (1, 64, 1, 64, 16), (2, 100, 2, 64, 32), (1, 130, 2, 128, 256),
    (2, 75, 1, 32, 32), (1, 40, 2, 32, 64),
])
def test_mlstm_phases_match_jax(B, S, H, hd, chunk):
    """Zero start and a carried-in state: h and (C, n, m) of the
    decomposition equal the JAX model's mlstm_chunkwise; with no state, the
    sequential oracle of repro.kernels.ref too."""
    q, k, v, ig, fg = _mlstm_inputs(B * S + hd + chunk, B, S, H, hd)
    x = tuple(torch.from_numpy(a) for a in (q, k, v, ig, fg))
    h, (C, n, m), _ = mlstm_phases(*x, chunk=chunk)
    want, jst = mlstm_chunkwise(*(jnp.asarray(a) for a in (q, k, v, ig, fg)), chunk=chunk)
    assert _err(h, want) < MLSTM_TOL
    for a, b in zip((C, n, m), jst):
        assert _err(a, b) < MLSTM_TOL
    hr, (Cr, nr, mr) = ref.mlstm(*(jnp.asarray(a) for a in (q, k, v, ig, fg)))
    assert _err(h, hr) < MLSTM_TOL and _err(C, Cr) < MLSTM_TOL
    # a state in: the one this call left, over the same inputs again
    h2, st2, _ = mlstm_phases(*x, (C, n, m), chunk=chunk)
    want2, jst2 = mlstm_chunkwise(*(jnp.asarray(a) for a in (q, k, v, ig, fg)),
                                  tuple(jnp.asarray(t.numpy()) for t in (C, n, m)),
                                  chunk=chunk)
    assert _err(h2, want2) < MLSTM_TOL
    for a, b in zip(st2, jst2):
        assert _err(a, b) < MLSTM_TOL


def test_mlstm_phase2_states_are_the_chunk_starts():
    """The scratch phase 2 writes, C, n and m at chunk c's start, is the
    state a call over the first c chunks leaves, in the plan's shapes."""
    B, S, H, hd, chunk = 1, 96, 2, 32, 32
    x = tuple(torch.from_numpy(a) for a in _mlstm_inputs(11, B, S, H, hd))
    _, _, (C_at, n_at, m_at) = mlstm_phases(*x, chunk=chunk)
    plan = kmc.wgmma_plan(B, S, H, hd, chunk)
    BH = B * H
    assert C_at.reshape(BH, *C_at.shape[2:]).shape == plan["scratch"]["CT"]
    assert n_at.reshape(BH, *n_at.shape[2:]).shape == plan["scratch"]["nS"]
    assert m_at.reshape(BH, -1).shape == plan["scratch"]["mS"]
    for c in range(1, plan["nc"]):
        _, (C, n, m) = kmc.mlstm_chunk_ref(*(t[:, :c * chunk] for t in x), chunk=chunk)
        assert _err(C_at[:, :, c], C) < MLSTM_TOL
        assert _err(n_at[:, :, c], n) < MLSTM_TOL
        assert _err(m_at[:, :, c], m) < MLSTM_TOL


# ---------------------------------------------------------------------------
# the chunked affine scan with decoupled look-back
# ---------------------------------------------------------------------------


def chunked_scan(a, bx, h0=None, *, lookback: str):
    """The chunked route in the kernel's order: per tile of T steps, segment
    aggregates of SEG steps composed into the tile's (A, B); the carry-in
    from the predecessor's published state (``lookback="inclusive"``) or
    composed from every earlier tile's aggregate back to the first tile's
    state (``"aggregates"``: the look-back's longest path); then each
    segment replays its steps from its carry."""
    B, S, R = a.shape
    T, SEG = krs.T, krs.SEG
    nt = -(-S // T)
    pad = nt * T - S
    af = torch.nn.functional.pad(a.float(), (0, 0, 0, pad), value=1.0)
    bf = torch.nn.functional.pad(bx.float(), (0, 0, 0, pad))
    h_start = torch.zeros(B, R) if h0 is None else h0.float()
    y = torch.empty(B, nt * T, R)
    seg = lambda x, t: x[:, t * T:(t + 1) * T].reshape(B, krs.NW, SEG, R)  # noqa: E731
    aggs, incl = [], []
    for t in range(nt):
        sa, sb = seg(af, t), seg(bf, t)
        A, Bs = torch.ones(B, krs.NW, R), torch.zeros(B, krs.NW, R)
        for u in range(SEG):
            Bs = sa[:, :, u] * Bs + sb[:, :, u]
            A = A * sa[:, :, u]
        TA, TB = torch.ones(B, R), torch.zeros(B, R)
        for w in range(krs.NW):
            TB = A[:, w] * TB + Bs[:, w]
            TA = TA * A[:, w]
        aggs.append((TA, TB))
        if t == 0:
            carry = h_start
        elif lookback == "inclusive":
            carry = incl[t - 1]
        else:
            RA, RB = torch.ones(B, R), torch.zeros(B, R)
            for j in range(t - 1, 0, -1):
                RB = RA * aggs[j][1] + RB
                RA = RA * aggs[j][0]
            carry = RA * incl[0] + RB
        hc = carry
        for w in range(krs.NW):
            h = hc
            for u in range(SEG):
                h = sa[:, w, u] * h + sb[:, w, u]
                y[:, t * T + w * SEG + u] = h
            hc = A[:, w] * hc + Bs[:, w]
        incl.append(hc)
    return y[:, :S], y[:, S - 1]


def _scan_inputs(seed, B, S, R):
    rs = np.random.RandomState(seed)
    a = 1.0 / (1.0 + np.exp(-rs.standard_normal((B, S, R))))
    return (a.astype(np.float32), rs.standard_normal((B, S, R)).astype(np.float32),
            rs.standard_normal((B, R)).astype(np.float32))


@pytest.mark.parametrize("lookback", ["inclusive", "aggregates"])
@pytest.mark.parametrize("B,S,R", [(1, 65, 40), (2, 300, 33), (1, 1000, 64)])
def test_chunked_scan_matches_jax(lookback, B, S, R):
    """Without h0: against the Pallas kernel (interpret mode) and the
    sequential oracle; with h0: against the oracle. y and h_last."""
    a, bx, h0 = _scan_inputs(S + R, B, S, R)
    ta, tb, th = (torch.from_numpy(x) for x in (a, bx, h0))
    y, h = chunked_scan(ta, tb, lookback=lookback)
    pal, _ = jax_rglru_scan(jnp.asarray(a), jnp.asarray(bx), block_t=32, block_r=32)
    want, hw = ref.rglru_scan(jnp.asarray(a), jnp.asarray(bx))
    assert _err(y, pal) < SCAN_TOL and _err(y, want) < SCAN_TOL
    assert _err(h, hw) < SCAN_TOL
    y0, h0t = chunked_scan(ta, tb, th, lookback=lookback)
    want0, hw0 = ref.rglru_scan(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0))
    assert _err(y0, want0) < SCAN_TOL and _err(h0t, hw0) < SCAN_TOL
    yp, hp = krs.rglru_scan_ref(ta, tb, th)           # the port's plain version
    assert _err(y0, yp) < SCAN_TOL and _err(h0t, hp) < SCAN_TOL
