"""Chunkwise stabilised mLSTM: the plain PyTorch version and its CUDA kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/mlstm_chunk.py::
mlstm_chunk`` (sources: ``csrc/mlstm_chunk.cu``, entry ``mlstm_chunk_fwd``,
and ``csrc/mlstm_chunk_wgmma.cu``).

Contract: ``mlstm_chunk(q, k, v, ig, fg, state=None, *, chunk)`` with
``q, k, v [B, S, H, hd]`` and the log-space gate pre-activations
``ig, fg [B, S, H]`` returns ``(h [B, S, H, hd] in q.dtype, (C [B, H, hd,
hd], n [B, H, hd], m [B, H]) float32)``. Per chunk it does the math of the
Pallas kernel's body; unlike that kernel it takes the state in and gives it
out with the JAX ``mlstm_chunkwise`` semantics (``models/xlstm.py:98-103,
137-148``; ``state=None`` starts from ``C = n = 0, m = -1e30``), so one call
serves prefill and extend. Rows past S pad the last chunk with
``ig = -1e30, fg = 30`` (no write, no decay). The plain version computes in
float32, ``q`` pre-scaled by ``hd ** -0.5`` as in the Pallas kernel; its
weights ``w = (q·kᵀ) ⊙ D`` are not rounded to the value dtype before ``·v``
(the XLA path's ``w.astype(v.dtype)``).

Two routes, chosen by dtype at the C entry point; ``launches_by_route``
counts each. bf16 (``"wgmma"``) runs the chunkwise-parallel form on the
tensor cores in three launches, gates, chunk states and outputs
(``wgmma_plan`` gives their grids and the float32 scratch this wrapper
allocates): bf16 products for ``q·kᵀ`` and ``w·v`` (``w`` as a bf16 value
and its bf16 remainder, so it keeps ~16 bits), TF32 with float32
accumulation for ``q·C`` and the state update. float32 (``"simt_f32"``)
runs a CUDA-core kernel with the plain version's float32 products and its
gates (F, the stabilisers, the exponents) in float64.

``mlstm_chunk`` runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.

Gradients: when autograd is on and q, k, v or a gate requires grad, the
call goes through ``MLSTMChunk`` (a ``torch.autograd.Function``). Its
forward is the same call with each chunk's start state kept
(``with_states``: the bf16 route's gates, ``C_cᵀ``, ``n_c`` and ``m_c``
scratch, which serving drops; the float32 route writes ``C_cᵀ``, ``n_c``
and a float64 ``m_c`` when given the buffers, ``states_plan``). Its
backward is the backward kernel on the card (``csrc/mlstm_chunk_bwd_wgmma.cu``
for bf16: the pair products in bf16 and the state products in TF32 on
wgmma; ``csrc/mlstm_chunk_bwd.cu`` for float32 on the CUDA cores, gates in
float64, and the gate phase both share; routes ``wgmma_bwd`` and
``simt_f32_bwd``; ``bwd_plan`` gives its scratch) and
``mlstm_chunk_bwd``, its plain version, on the CPU. A state input that
requires grad raises: train mode never passes one. The JAX package's
gradient is XLA's autodiff of ``mlstm_chunkwise``, which the backward
kernel replaces. What bounds it: operations, five products over the causal
pairs and four over the state (``costs.mlstm_bwd_kernel``); the design is
in the sources' notes.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, launch_counts
from repro_torch.kernels.flash_attention import DTYPES, aligned16

NEG_INF = -1e30
MAX_HEAD_DIM = 512
MAX_CHUNK = 512

# the bf16 route's geometry (csrc/mlstm_chunk_wgmma.cu's constexpr values)
TILE = 64           # query rows / keys of an output tile; the edge of a C tile
MAX_BV = 128        # value columns of an output block

ROUTES = {torch.bfloat16: "wgmma", torch.float32: "simt_f32"}
BWD_ROUTES = {torch.bfloat16: "wgmma_bwd", torch.float32: "simt_f32_bwd"}

launches = 0            # kernel launches, forward and backward (never the plain version)
launches_by_route = {route: 0 for route in (*ROUTES.values(), *BWD_ROUTES.values())}
_fn = None
_bwd_fn = None

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entry points' arguments (csrc/mlstm_chunk.cu::mlstm_chunk_fwd,
# csrc/mlstm_chunk_bwd.cu::mlstm_chunk_bwd): pointers and the stream as
# c_void_p, ints as c_int
FWD_ARGTYPES = [_P] * 16 + [_I] * 5 + [ctypes.c_float, _I, _P]
BWD_ARGTYPES = [_P] * 31 + [_I] * 5 + [ctypes.c_float, _I, _I, _P]

# the backward's geometry: the float32 route's carry (a thread per element
# of dC and dn, CARRY_NT a block) and its row kernels (a warp a row); the
# bf16 route's recurrence (a REC_TILE x REC_TILE tile of dC a block, one more
# for dn)
CARRY_NT = 256
ROWS_A_BLOCK = 4
REC_TILE = 32
ROW_SCALARS = 6         # denom, dqn, R, dinter·inter, Σ_m dlogD, Σ_l dlogD
GATE_SCALARS = 4        # a chunk's parts, base, carried, largest write
# scratch that is not float32 (the bf16 route's kept pair tiles; the float32
# route's gates and the gate phase's values in float64)
SCRATCH_DTYPES = {"pt": torch.bfloat16, "gates": torch.float64, "gsc": torch.float64}


def wgmma_plan(B: int, S: int, H: int, hd: int, chunk: int) -> dict:
    """The bf16 route's plan for one call: the chunk length ``L``, chunk
    count ``nc``, padded length ``Sp``, 64-row tiles a chunk ``ntile`` and
    value columns an output block ``bv`` (phase 3 runs one block per tile,
    chunk, row and head, and value tile), and the float32 scratch shapes
    (gates: F, the intra-chunk stabiliser and the padded input gate of
    every row; CT: each chunk's starting C, transposed; nS, mS: each
    chunk's starting n and m)."""
    L = min(chunk, S)
    nc = -(-S // L)
    ntile = -(-L // TILE)
    bv = MAX_BV if hd % MAX_BV == 0 else TILE
    BH = B * H
    return dict(
        L=L, nc=nc, Sp=nc * L, ntile=ntile, bv=bv,
        scratch={"gates": (BH, 3, nc * L), "CT": (BH, nc, hd, hd),
                 "nS": (BH, nc, hd), "mS": (BH, nc)})


def states_plan(B: int, S: int, H: int, hd: int, chunk: int, dtype) -> dict:
    """What the forward keeps for the backward with ``with_states``: name ->
    (shape, dtype). bf16: the three phases' scratch (``wgmma_plan``; ``CT``
    rounded to TF32, the backward's operand). float32: ``CT`` and ``nS``
    float32 and ``mS`` float64 (the route's stabilisers), no gates (its
    backward recomputes them in float64)."""
    if dtype == torch.bfloat16:
        return {name: (shape, torch.float32) for name, shape in
                wgmma_plan(B, S, H, hd, chunk)["scratch"].items()}
    L = min(chunk, S)
    nc = -(-S // L)
    BH = B * H
    return {"gates": ((0,), torch.float32), "CT": ((BH, nc, hd, hd), torch.float32),
            "nS": ((BH, nc, hd), torch.float32), "mS": ((BH, nc), torch.float64)}


def bwd_plan(B: int, S: int, H: int, hd: int, chunk: int, dtype) -> dict:
    """The backward kernel's plan for one call: chunk length ``L``, chunk
    count ``nc``, padded length ``Sp``, 64-row tiles a chunk ``ntile``, the
    column blocks whose partial k·dCv a row sums ``ncol``, the partials of a
    chunk's decay gradient ``NP``, every launch's grid, and the scratch
    (name -> shape; float32 but for ``SCRATCH_DTYPES``): ``rows`` the row
    scalars (``ROW_SCALARS``), ``dlsc`` the partials, ``dCE`` / ``dnE``
    each chunk's end-state gradient, ``ddp`` / ``dmp`` the partials of the
    decay's and the state out's m gradient, ``gsc`` the gate phase's (each
    row's dig and dF before the cross-chunk carry, each chunk's
    ``GATE_SCALARS``); bf16 only, ``xs`` the state products a row (X =
    dh·C_cᵀ, then v·dCE_cᵀ; and (k ⊙ sc)·dCE_c), ``xq`` the partials of q·X
    and q·n_c, ``cols`` each query tile's part of a key's Σ dlogD, ``sp``
    each pair tile's S = q·kᵀ and P = dh·vᵀ between the pairs phase's two
    passes and ``pt`` the kept pair tiles (ds' and w / denom, 64 x 64
    each, the lower triangle of a chunk's tiles); float32 only, ``gates``. The bf16 dq and
    dk / dv blocks take ``bw`` columns each (128 where they divide hd)."""
    L = min(chunk, S)
    nc = -(-S // L)
    ntile = -(-L // TILE)
    BH = B * H
    Sp = nc * L
    if dtype == torch.bfloat16:
        ncol = hd // TILE
        NP = (hd // REC_TILE) ** 2 + 1
        bw = 2 * TILE if hd % (2 * TILE) == 0 else TILE
        ntri = ntile * (ntile + 1) // 2
        grids = {"slab": (ncol, nc, BH), "pairs": (ntile * nc * BH,),
                 "carry": (ncol, ncol, (nc - 1) * BH), "recurrence": (NP, BH),
                 "dq": (hd // bw * ntile * nc * BH,), "dkdv": (hd // bw * ntile * nc * BH,),
                 "gates": (nc, BH), "gate_rows": (nc, BH)}
    else:
        ncol, bw = 1, None
        NP = -(-(hd * hd + hd) // CARRY_NT)
        rows = (-(-L // ROWS_A_BLOCK), nc, BH)
        grids = {"gates64": (nc, BH), "rows": rows, "carry": (NP, BH), "dq": rows,
                 "dkdv": rows, "gates": (nc, BH), "gate_rows": (nc, BH)}
    scratch = {"rows": (BH, ROW_SCALARS, Sp), "dlsc": (BH, ncol, Sp),
               "dCE": (BH, nc, hd, hd), "dnE": (BH, nc, hd), "ddp": (BH, nc, NP),
               "dmp": (BH, NP), "gsc": (BH, 2 * Sp + GATE_SCALARS * nc)}
    if dtype == torch.bfloat16:
        scratch["xs"] = (2, BH, Sp, hd)
        scratch["xq"] = (BH, 2, ncol, Sp)
        scratch["cols"] = (BH, ntile, Sp)
        scratch["sp"] = (BH, nc, ntri, 2, TILE * TILE)
        scratch["pt"] = (2, BH, nc, ntri, TILE * TILE)
    else:
        scratch["gates"] = (BH, 3, Sp)
    return dict(L=L, nc=nc, Sp=Sp, ntile=ntile, ncol=ncol, NP=NP, bw=bw, grids=grids,
                scratch=scratch)


def chunk_states_ref(q, k, v, ig, fg, state=None, *, chunk: int = 256):
    """Plain version of what the forward keeps with ``with_states``: each
    chunk's start state, ``CT [B·H, nc, hd, hd]`` (C transposed: [e][d]),
    ``nS [B·H, nc, hd]`` and ``mS [B·H, nc]``, float32 (float64 for float64
    inputs), by ``mlstm_chunk_ref`` over each prefix of whole chunks."""
    B, S, H, hd = q.shape
    L = min(chunk, S)
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    st = zero_state(B, H, hd, q.device, wide) if state is None else \
        tuple(t.to(wide) for t in state)
    Cs, ns, ms = [], [], []
    for c0 in range(0, S, L):
        C, n, m = st
        Cs.append(C.transpose(-1, -2).reshape(B * H, hd, hd))
        ns.append(n.reshape(B * H, hd))
        ms.append(m.reshape(B * H))
        sl = slice(c0, c0 + L)
        _, st = mlstm_chunk_ref(q[:, sl], k[:, sl], v[:, sl], ig[:, sl], fg[:, sl], st,
                                chunk=L)
    return torch.stack(Cs, 1), torch.stack(ns, 1), torch.stack(ms, 1)


def zero_state(B, H, hd, device, dtype=torch.float32):
    """The state before the first token: C = n = 0, m = -1e30."""
    kw = dict(dtype=dtype, device=device)
    return (torch.zeros(B, H, hd, hd, **kw), torch.zeros(B, H, hd, **kw),
            torch.full((B, H), NEG_INF, **kw))


def mlstm_chunk_ref(q, k, v, ig, fg, state=None, *, chunk: int = 256):
    """Plain version: the chunkwise math of ``mlstm_chunkwise`` in float32
    (in float64 for float64 inputs: the reference a float32 result is held
    to where float32 rounding is the question)."""
    B, S, H, hd = q.shape
    L = min(chunk, S)
    Sp = -(-S // L) * L
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.to(wide) * hd ** -0.5
    kf, vf, igf, fgf = k.to(wide), v.to(wide), ig.to(wide), fg.to(wide)
    if Sp != S:
        pad = Sp - S
        qf, kf, vf = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (qf, kf, vf))
        igf = F.pad(igf, (0, 0, 0, pad), value=NEG_INF)
        fgf = F.pad(fgf, (0, 0, 0, pad), value=30.0)
    C, n, m = zero_state(B, H, hd, q.device, wide) if state is None else state
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=q.device))
    hs = []
    for c0 in range(0, Sp, L):
        qj, kj, vj = (x[:, c0:c0 + L] for x in (qf, kf, vf))
        ij, fj = igf[:, c0:c0 + L], fgf[:, c0:c0 + L]
        Fc = torch.cumsum(F.logsigmoid(fj), dim=1)               # [B,L,H]
        FL = Fc[:, -1]
        logD = Fc[:, :, None, :] - Fc[:, None, :, :] + ij[:, None, :, :]
        logD = logD.masked_fill(~tri[None, :, :, None], NEG_INF)  # [B,L,L,H]
        m_intra = logD.amax(dim=2)
        m_inter = Fc + m[:, None, :]
        mj = torch.maximum(m_inter, m_intra)
        d = torch.exp(logD - mj[:, :, None, :])
        inter = torch.exp(m_inter - mj)
        s = torch.einsum("blhd,bmhd->blmh", qj, kj)
        w = s * d
        h_intra = torch.einsum("blmh,bmhd->blhd", w, vj)
        h_inter = torch.einsum("blhd,bhde->blhe", qj, C)
        h_num = h_inter * inter[..., None] + h_intra
        n_j = n[:, None] * inter[..., None] + torch.einsum("blmh,bmhd->blhd", d, kj)
        denom = torch.maximum(torch.einsum("blhd,blhd->blh", qj, n_j).abs(),
                              torch.exp(-mj))
        hs.append(h_num / denom[..., None])
        m_next = torch.maximum(FL + m, (FL[:, None] - Fc + ij).amax(dim=1))
        sc = torch.exp(FL[:, None] - Fc + ij - m_next[:, None])
        decay = torch.exp(FL + m - m_next)
        C = C * decay[..., None, None] + torch.einsum("blh,blhd,blhe->bhde", sc, kj, vj)
        n = n * decay[..., None] + torch.einsum("blh,blhd->bhd", sc, kj)
        m = m_next
    h = torch.cat(hs, dim=1)[:, :S].to(q.dtype)
    return h, (C, n, m)


def _kernel():
    global _fn
    if _fn is None:
        _fn = build.entry("mlstm_chunk_fwd", FWD_ARGTYPES)
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        _bwd_fn = build.entry("mlstm_chunk_bwd", BWD_ARGTYPES)
    return _bwd_fn


def mlstm_chunk_bwd(q, k, v, ig, fg, dh, state=None, dstate=None, *,
                    chunk: int = 256):
    """The gradient of ``mlstm_chunk_ref`` at (q, k, v, ig, fg), given the
    gradient ``dh`` of h (None: 0) and ``dstate`` = (dC, dn) of the state
    out (None, or either None: 0). Returns (dq, dk, dv, dig, dfg) in the
    dtypes of the inputs; float32 throughout (float64 for float64 inputs).
    ``state`` (C, n, m), the state in, is held constant.

    The derivative is taken with every stabiliser held constant: the
    carried ``m``, each row's ``mj`` and each chunk's ``m_next``. That is
    exact, not an approximation. In the unstabilised values (C̃ = C·e^m,
    ñ = n·e^m and the unshifted exponents) a row's output is
    ``h = X / max(|q·Ñ|, 1)``: the stabilised form computes ``e^-mj·X``
    over ``e^-mj·max(|q·Ñ|, 1)``, so h is the same function of the inputs
    for any choice of the m's, ∂h/∂m ≡ 0, and the partials at fixed m are
    the total gradient. The same holds for the state out as long as
    whatever reads it is invariant to the joint shift (C e^-μ, n e^-μ, μ),
    as the mLSTM itself is, so a gradient of m out is dropped.

    The stabilisers' own gradients are zero in exact arithmetic, but in
    float32 they carry something: a row's gradients (or a chunk's state
    write's) sum around one dominant term of weight 1, and autograd's path
    through the stabiliser returns the rounding of that sum to the term
    that made it. Without that path, dig and dfg come out ~40x less
    accurate than autograd's at input gates of scale 20. So it is carried
    here too: each row's computed sum against its exact value R (0 on the
    ``|q·n|`` branch, dh·h on the other) goes to the row's largest weight,
    and each chunk's, through ``m_next``'s reverse carry, to its largest
    write.

    Shape of the computation (B rows, nc chunks of L, H heads):
    a forward pass over the chunks gives each chunk's start state
    (C_j, n_j, m_j): their state updates batched, then a carry of a few
    operations a chunk; every intra-chunk term batched over all chunks at
    once ([B, nc, L, L, H]); a reverse carry of (dC, dn) over the chunks;
    then dig and dfg from ``logD``, ``inter``, ``sc`` and ``decay``, with
    ``dfg = revcumsum(dF)·σ(-fg)``; a reverse carry of one number a
    chunk for ``m_next``. Rows past S pad the last chunk as the forward
    pads it (``ig = -1e30, fg = 30``, zero q, k, v and dh). The
    denominator's ``|q·n|`` branch is taken by its sign; a tie with
    ``e^-mj`` splits the gradient in half, as ``torch.maximum`` does."""
    B, S, H, hd = q.shape
    L = min(chunk, S)
    nc = -(-S // L)
    Sp = nc * L
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = hd ** -0.5
    dev = q.device
    qf = q.to(wide) * scale
    kf, vf, igf, fgf = k.to(wide), v.to(wide), ig.to(wide), fg.to(wide)
    dhf = (torch.zeros(B, S, H, hd, dtype=wide, device=dev) if dh is None
           else dh.to(wide))
    if Sp != S:
        pad = Sp - S
        qf, kf, vf, dhf = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (qf, kf, vf, dhf))
        igf = F.pad(igf, (0, 0, 0, pad), value=NEG_INF)
        fgf = F.pad(fgf, (0, 0, 0, pad), value=30.0)
    qc, kc, vc, dhc = (x.reshape(B, nc, L, H, hd) for x in (qf, kf, vf, dhf))
    ic, fc = (x.reshape(B, nc, L, H) for x in (igf, fgf))
    C0, n0, m0 = (zero_state(B, H, hd, dev, wide) if state is None
                  else tuple(t.detach().to(wide) for t in state))

    # ---- the forward's gates, stabilisers and chunk start states
    Fc = torch.cumsum(F.logsigmoid(fc), dim=2)                   # [B,nc,L,H]
    FL = Fc[:, :, -1]                                            # [B,nc,H]
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=dev))
    logD = Fc[:, :, :, None] - Fc[:, :, None] + ic[:, :, None]   # [B,nc,L,L,H]
    logD = logD.masked_fill(~tri[None, None, :, :, None], NEG_INF)
    m_intra, star = logD.max(dim=3)              # a row's largest weight: d = 1
    top, top_at = (FL[:, :, None] - Fc + ic).max(dim=2)          # [B,nc,H]
    ms = [m0]
    for j in range(nc):
        ms.append(torch.maximum(FL[:, j] + ms[-1], top[:, j]))
    mS, mE = torch.stack(ms[:-1], dim=1), torch.stack(ms[1:], dim=1)
    decay = torch.exp(FL + mS - mE)                              # [B,nc,H]
    sc = torch.exp(FL[:, :, None] - Fc + ic - mE[:, :, None])    # [B,nc,L,H]
    ksc = kc * sc[..., None]
    U = torch.einsum("bclhd,bclhe->bchde", ksc, vc)              # [B,nc,H,hd,hd]
    u = ksc.sum(dim=2)                                           # [B,nc,H,hd]
    C, n, Cs, ns = C0, n0, [], []
    for j in range(nc):
        Cs.append(C)
        ns.append(n)
        C = C * decay[:, j, :, None, None] + U[:, j]
        n = n * decay[:, j, :, None] + u[:, j]
    CS, nS = torch.stack(Cs, dim=1), torch.stack(ns, dim=1)
    C_end, n_end = C, n
    del U, u, Cs, ns

    # ---- each row's output, recomputed
    m_inter = Fc + mS[:, :, None]
    mj = torch.maximum(m_inter, m_intra)
    d = torch.exp(logD - mj[:, :, :, None])                      # [B,nc,L,L,H]
    del logD
    inter = torch.exp(m_inter - mj)                              # [B,nc,L,H]
    s = torch.einsum("bclhd,bcmhd->bclmh", qc, kc)
    w = s * d
    h_inter = torch.einsum("bclhd,bchde->bclhe", qc, CS)
    h_num = h_inter * inter[..., None] + torch.einsum("bclmh,bcmhd->bclhd", w, vc)
    n_j = nS[:, :, None] * inter[..., None] + torch.einsum("bclmh,bcmhd->bclhd", d, kc)
    qn = (qc * n_j).sum(dim=-1)
    lo = torch.exp(-mj)
    denom = torch.maximum(qn.abs(), lo)

    # ---- backward through the output
    dh_num = dhc / denom[..., None]
    ddenom = -(dhc * h_num).sum(dim=-1) / denom ** 2
    branch = (qn.abs() > lo).to(wide) + 0.5 * (qn.abs() == lo).to(wide)
    dqn = ddenom * branch * torch.sign(qn)
    dn_j = dqn[..., None] * qc                                   # [B,nc,L,H,hd]
    dh_inter = dh_num * inter[..., None]
    dq = dqn[..., None] * n_j + torch.einsum("bclhe,bchde->bclhd", dh_inter, CS)
    dinter = (dh_num * h_inter).sum(dim=-1) + (dn_j * nS[:, :, None]).sum(dim=-1)
    GC = torch.einsum("bclhd,bclhe->bchde", qc, dh_inter)        # into dC_j
    Gn = (dn_j * inter[..., None]).sum(dim=2)                    # into dn_j
    dw = torch.einsum("bclhe,bcmhe->bclmh", dh_num, vc)
    dv = torch.einsum("bclmh,bclhe->bcmhe", w, dh_num)
    dd = dw * s + torch.einsum("bclhd,bcmhd->bclmh", dn_j, kc)
    ds = dw * d
    dk = (torch.einsum("bclmh,bclhd->bcmhd", d, dn_j)
          + torch.einsum("bclmh,bclhd->bcmhd", ds, qc))
    dq = dq + torch.einsum("bclmh,bcmhd->bclhd", ds, kc)
    del s, w, dw, ds
    dlogD = dd * d
    del dd, d
    colsum = dlogD.sum(dim=2)                    # by key: into ig and -F
    # A row's weights shifted together (all its logD and log inter) leave h
    # unchanged on the |q·n| branch and scale it on the other: their
    # gradients sum to R exactly. The computed sum's distance from R is
    # rounding of the row's dominant term; it goes back to the entry that
    # carries that term (where autograd's stabiliser path sends it), so
    # float32 keeps the accuracy of the stabilised form's own gradient.
    lo_branch = (qn.abs() < lo).to(wide) + 0.5 * (qn.abs() == lo).to(wide)
    R = lo_branch * (dhc * h_num).sum(dim=-1) / denom
    resid = dlogD.sum(dim=3) + dinter * inter - R
    del dlogD
    fix = torch.zeros_like(colsum).scatter_add_(
        2, star, torch.where(m_intra >= m_inter, resid, torch.zeros_like(resid)))
    dig = colsum - fix
    dFc = R - colsum + fix

    # ---- the reverse carry of (dC, dn) over the chunks: dCE[j] is the
    # gradient of chunk j's end state
    dC, dn = (None, None) if dstate is None else dstate
    dC = (torch.zeros(B, H, hd, hd, dtype=wide, device=dev) if dC is None
          else dC.to(wide))
    dn = (torch.zeros(B, H, hd, dtype=wide, device=dev) if dn is None
          else dn.to(wide))
    dCE, dnE = [None] * nc, [None] * nc
    for j in reversed(range(nc)):
        dCE[j], dnE[j] = dC, dn
        dC = dC * decay[:, j, :, None, None] + GC[:, j]
        dn = dn * decay[:, j, :, None] + Gn[:, j]
    dCE, dnE = torch.stack(dCE, dim=1), torch.stack(dnE, dim=1)
    del GC, Gn

    # ---- backward through each chunk's state update
    ddecay = (dCE * CS).sum(dim=(-2, -1)) + (dnE * nS).sum(dim=-1)    # [B,nc,H]
    dCv = torch.einsum("bchde,bclhe->bclhd", dCE, vc) + dnE[:, :, None]
    dk = dk + sc[..., None] * dCv
    dv = dv + torch.einsum("bchde,bclhd->bclhe", dCE, ksc)
    dlsc = (kc * dCv).sum(dim=-1) * sc                           # [B,nc,L,H]
    # The same for each chunk's state write (its sc and decay shifted
    # together): the rounding of the sum goes to the dominant write through
    # m_next's carry, chunk by chunk in reverse, as autograd's does.
    # The state out's m gets what an invariant reader gives it:
    # Σ dC·C + Σ dn·n.
    parts = dlsc.sum(dim=2) + ddecay * decay                     # [B,nc,H]
    base = ((dinter * inter).sum(dim=2) + ddecay * decay + torch.where(
        m_inter > m_intra, -resid, torch.zeros_like(resid)).sum(dim=2))
    carried = FL + mS >= top
    dm = (dCE[:, -1] * C_end).sum(dim=(-2, -1)) + (dnE[:, -1] * n_end).sum(dim=-1)
    G = [None] * nc
    for j in reversed(range(nc)):
        G[j] = dm - parts[:, j]
        dm = base[:, j] + torch.where(carried[:, j], G[j], torch.zeros_like(dm))
    G = torch.stack(G, dim=1)
    at_key = torch.zeros_like(dlsc).scatter_add_(
        2, top_at[:, :, None], torch.where(carried, torch.zeros_like(G), G)[:, :, None])
    dig = dig + dlsc + at_key
    dFc = dFc - dlsc - at_key
    dFc[:, :, -1] += parts + G
    dfg = torch.flip(torch.cumsum(torch.flip(dFc, (2,)), dim=2), (2,)) \
        * torch.sigmoid(-fc)
    dq = dq * scale

    def out(x, like):
        return x.reshape((B, Sp) + x.shape[3:])[:, :S].to(like.dtype)

    return out(dq, q), out(dk, k), out(dv, v), out(dig, ig), out(dfg, fg)


class MLSTMChunk(torch.autograd.Function):
    """``mlstm_chunk`` with a gradient: the forward is the wrapper's call
    with each chunk's start state kept (the kernel on the card), the backward
    the backward kernel on the very inputs the forward saw and those states
    (``mlstm_chunk_bwd``, the plain version, on the CPU); the state in, if
    any, is held constant."""

    @staticmethod
    def forward(ctx, q, k, v, ig, fg, C0, n0, m0, chunk):
        state = None if C0 is None else (C0, n0, m0)
        h, (C, n, m), saved = _forward(q, k, v, ig, fg, state, chunk=chunk,
                                       with_states=True)
        ctx.save_for_backward(q, k, v, ig, fg, C0, n0, m0, C, n, *saved)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(m)
        return h, C, n, m

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        del dm                      # the stabiliser's: see mlstm_chunk_bwd
        q, k, v, ig, fg, C0, n0, m0, C, n, *saved = ctx.saved_tensors
        if q.device.type == "cpu":
            state = None if C0 is None else (C0, n0, m0)
            with torch.profiler.record_function("mlstm_chunk_bwd"):
                grads = mlstm_chunk_bwd(q, k, v, ig, fg, dh, state, (dC, dn),
                                        chunk=ctx.chunk)
            return grads + (None,) * 4
        dh = torch.zeros_like(q) if dh is None else dh.contiguous()
        dq, dk, dv, dig, dfg = _launch_bwd(
            q, k, v, ig, fg, dh, None if dC is None else dC.contiguous(),
            None if dn is None else dn.contiguous(), C, n, *saved, C0 is not None,
            ctx.chunk)
        return dq, dk, dv, dig.to(ig.dtype), dfg.to(fg.dtype), None, None, None, None


def mlstm_chunk(q, k, v, ig, fg, state=None, *, chunk: int = 256):
    """Chunkwise mLSTM (see the module docstring); same contract as
    ``mlstm_chunk_ref``. Under autograd, with q, k, v or a gate that
    requires grad, it is ``MLSTMChunk`` (the same forward, with a
    backward); a state that requires grad raises there."""
    if torch.is_grad_enabled():
        if state is not None and any(t.requires_grad for t in state):
            raise NotImplementedError(
                "mlstm_chunk: no gradient into the state in (C, n, m); train "
                "mode starts every sequence from the zero state")
        if any(t.requires_grad for t in (q, k, v, ig, fg)):
            st = (None,) * 3 if state is None else tuple(state)
            h, C, n, m = MLSTMChunk.apply(q, k, v, ig, fg, *st, chunk)
            return h, (C, n, m)
    return _forward(q, k, v, ig, fg, state, chunk=chunk)


def _forward(q, k, v, ig, fg, state=None, *, chunk: int = 256, with_states=False):
    """The plain version (CPU tensors), or the kernel's operator: (h, (C, n,
    m)), and with ``with_states`` the chunk start states the backward
    kernel reads (``states_plan``; none from the plain version, whose
    backward recomputes them)."""
    if q.device.type == "cpu":
        out = mlstm_chunk_ref(q, k, v, ig, fg, state, chunk=chunk)
        return out + ((),) if with_states else out
    C0, n0, m0 = (None,) * 3 if state is None else state
    h, C, n, m, *saved = _launch(q, k, v, ig, fg, C0, n0, m0, chunk, with_states)
    return (h, (C, n, m), tuple(saved)) if with_states else (h, (C, n, m))


def _check(name, q, k, v, ig, fg):
    """What both kernels take: one [B, S, H, hd] shape for q, k, v, [B, S, H]
    gates, the dtypes and head dims of the routes, one CUDA device,
    contiguous 16-byte aligned q, k, v."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} must be one [B, S, H, hd] shape")
    B, S, H, hd = q.shape
    if ig.shape != (B, S, H) or fg.shape != (B, S, H):
        raise ValueError(f"{name}: ig {tuple(ig.shape)} / fg {tuple(fg.shape)} "
                         f"must be [{B}, {S}, {H}]")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    step = TILE if q.dtype == torch.bfloat16 else 32
    if hd % step or hd > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {hd} must be a multiple of {step} "
                         f"up to {MAX_HEAD_DIM} for {q.dtype}")
    if any(t.device != q.device for t in (k, v, ig, fg)):
        raise ValueError(f"{name}: tensors on different devices")
    if not (all(t.is_contiguous() for t in (q, k, v)) and aligned16(q, k, v)):
        raise ValueError(f"{name}: q, k, v must be contiguous and 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


@build.op("mlstm_chunk", "(Tensor q, Tensor k, Tensor v, Tensor ig, Tensor fg, "
          "Tensor? C0, Tensor? n0, Tensor? m0, int chunk, bool with_states=False) "
          "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
def _launch(q, k, v, ig, fg, C0, n0, m0, chunk, with_states=False):
    """The kernel on CUDA tensors (``torch.ops.repro_torch.mlstm_chunk``):
    h, the state after the last step (C, n, m), and with ``with_states``
    the chunk start states of ``states_plan`` (gates, CT, nS, mS; each
    empty without it: serving keeps none)."""
    state = None if C0 is None else (C0, n0, m0)
    _check("mlstm_chunk", q, k, v, ig, fg)
    B, S, H, hd = q.shape
    L = min(chunk, S)
    if not 1 <= chunk or L > MAX_CHUNK:
        raise ValueError(f"mlstm_chunk: chunk {chunk} (at most {MAX_CHUNK})")
    if state is not None:
        if (C0.shape != (B, H, hd, hd) or n0.shape != (B, H, hd)
                or m0.shape != (B, H)
                or any(t.dtype != torch.float32 for t in state)):
            raise ValueError("mlstm_chunk: state must be float32 (C [B,H,hd,hd], "
                             "n [B,H,hd], m [B,H])")
        if any(t.device != q.device for t in state):
            raise ValueError("mlstm_chunk: tensors on different devices")
    igc = ig.float().contiguous()
    fgc = fg.float().contiguous()
    st = (None, None, None) if state is None else tuple(t.contiguous() for t in state)
    dev = q.device
    h = torch.empty_like(q)
    C, n, m = (torch.empty(B, H, hd, hd, dtype=torch.float32, device=dev),
               torch.empty(B, H, hd, dtype=torch.float32, device=dev),
               torch.empty(B, H, dtype=torch.float32, device=dev))
    empty = tuple(torch.empty(0, device=dev) for _ in range(4))
    if B == 0 or H == 0:
        return (h, C, n, m) + empty
    if S == 0:
        return (h,) + (zero_state(B, H, hd, dev) if state is None
                       else tuple(t.clone() for t in st)) + empty
    scratch = (None,) * 4
    if q.dtype == torch.bfloat16 or with_states:
        scratch = tuple(torch.empty(shape, dtype=dt, device=dev) if shape != (0,) else None
                        for shape, dt in states_plan(B, S, H, hd, chunk, q.dtype).values())
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), igc.data_ptr(),
                    fgc.data_ptr(), *map(_ptr, st), h.data_ptr(), C.data_ptr(),
                    n.data_ptr(), m.data_ptr(), *map(_ptr, scratch), B, S, H, hd, L,
                    hd ** -0.5, DTYPES[q.dtype], stream)
    build.check(err, "mlstm_chunk")
    launch_counts.count(__name__, ROUTES[q.dtype])
    if not with_states:
        return (h, C, n, m) + empty
    gates, CT, nS, mS = (e if t is None else t for t, e in zip(scratch, empty))
    if state is None and q.dtype == torch.bfloat16:
        CT[:, 0].zero_()            # the kernel writes no C_0 of a zero start
    return h, C, n, m, gates, CT, nS, mS


@build.op("mlstm_chunk_bwd", "(Tensor q, Tensor k, Tensor v, Tensor ig, Tensor fg, "
          "Tensor dh, Tensor? dC, Tensor? dn, Tensor C, Tensor n, Tensor gates, "
          "Tensor CT, Tensor nS, Tensor mS, bool has_state, int chunk) "
          "-> (Tensor, Tensor, Tensor, Tensor, Tensor)")
def _launch_bwd(q, k, v, ig, fg, dh, dC, dn, C, n, gates, CT, nS, mS, has_state, chunk):
    """The backward kernel on CUDA tensors
    (``torch.ops.repro_torch.mlstm_chunk_bwd``): (dq, dk, dv, dig, dfg) of
    ``mlstm_chunk`` at (q, k, v, ig, fg), the gates' float32, given the
    output's gradient ``dh``, the state out's (``dC``, ``dn``; None: 0) and
    the state out ``C``, ``n``, from the chunk start states the forward kept
    (``with_states``); ``has_state``: the forward started from a state in."""
    _check("mlstm_chunk_bwd", q, k, v, ig, fg)
    B, S, H, hd = q.shape
    L = min(chunk, S)
    if not 1 <= chunk or L > MAX_CHUNK:
        raise ValueError(f"mlstm_chunk_bwd: chunk {chunk} (at most {MAX_CHUNK})")
    if dh.shape != q.shape or dh.dtype != q.dtype or dh.device != q.device \
            or not dh.is_contiguous() or not aligned16(dh):
        raise ValueError(f"mlstm_chunk_bwd: dh must be a contiguous, 16-byte aligned "
                         f"{q.dtype} tensor of q's shape")
    f32 = dict(dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dig, dfg = torch.empty(B, S, H, **f32), torch.empty(B, S, H, **f32)
    if B == 0 or H == 0 or S == 0:
        return dq, dk, dv, dig, dfg
    want = states_plan(B, S, H, hd, chunk, q.dtype)
    for name, t in zip(("gates", "CT", "nS", "mS"), (gates, CT, nS, mS)):
        shape, dt = want[name]
        if tuple(t.shape) != shape or t.dtype != dt or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"mlstm_chunk_bwd: saved {name} {tuple(t.shape)} {t.dtype} "
                             f"is not {dt} {shape} (the forward's with_states)")
    for name, t, shape in (("dC", dC, (B, H, hd, hd)), ("dn", dn, (B, H, hd)),
                           ("C", C, (B, H, hd, hd)), ("n", n, (B, H, hd))):
        if t is not None and (tuple(t.shape) != shape or t.dtype != torch.float32
                              or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"mlstm_chunk_bwd: {name} must be contiguous float32 {shape}")
    plan = bwd_plan(B, S, H, hd, chunk, q.dtype)
    scratch = {name: torch.empty(shape, dtype=SCRATCH_DTYPES.get(name, torch.float32),
                                 device=q.device)
               for name, shape in plan["scratch"].items()}
    if q.dtype == torch.bfloat16:
        scratch["gates"] = gates
    igc, fgc = ig.float().contiguous(), fg.float().contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sp = [scratch[name].data_ptr() if name in scratch else None
          for name in ("rows", "dlsc", "dCE", "dnE", "ddp", "dmp", "xs", "xq", "cols",
                       "pt", "sp", "gsc")]
    err = _bwd_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), igc.data_ptr(),
                        fgc.data_ptr(), dh.data_ptr(), _ptr(dC), _ptr(dn), C.data_ptr(),
                        n.data_ptr(), scratch["gates"].data_ptr(), CT.data_ptr(),
                        nS.data_ptr(), mS.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), dig.data_ptr(), dfg.data_ptr(), *sp, B, S, H, hd, L,
                        hd ** -0.5, int(has_state), DTYPES[q.dtype], stream)
    build.check(err, "mlstm_chunk_bwd")
    launch_counts.count(__name__, BWD_ROUTES[q.dtype])
    return dq, dk, dv, dig, dfg
