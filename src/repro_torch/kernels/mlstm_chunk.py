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

# Under autograd a CUDA launch raises (``build.refuse_grad``); the plain
# version on the CPU runs under autograd as it is.
BACKWARD = "its backward is ROADMAP.md queue 2 item 10"

launches = 0            # kernel launches (never the plain version)
launches_by_route = {route: 0 for route in ROUTES.values()}
_fn = None


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
        P, I = ctypes.c_void_p, ctypes.c_int
        _fn = build.entry("mlstm_chunk_fwd",
                          [P] * 16 + [I] * 5 + [ctypes.c_float, I, P])
    return _fn


def mlstm_chunk(q, k, v, ig, fg, state=None, *, chunk: int = 256):
    """Chunkwise mLSTM (see the module docstring); same contract as
    ``mlstm_chunk_ref``."""
    if q.device.type == "cpu":
        return mlstm_chunk_ref(q, k, v, ig, fg, state, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunk: unsupported device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mlstm_chunk: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} must be one [B, S, H, hd] shape")
    B, S, H, hd = q.shape
    if ig.shape != (B, S, H) or fg.shape != (B, S, H):
        raise ValueError(f"mlstm_chunk: ig {tuple(ig.shape)} / fg {tuple(fg.shape)} "
                         f"must be [{B}, {S}, {H}]")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"mlstm_chunk: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    step = TILE if q.dtype == torch.bfloat16 else 32
    if hd % step or hd > MAX_HEAD_DIM:
        raise ValueError(f"mlstm_chunk: head_dim {hd} must be a multiple of {step} "
                         f"up to {MAX_HEAD_DIM} for {q.dtype}")
    L = min(chunk, S)
    if not 1 <= chunk or L > MAX_CHUNK:
        raise ValueError(f"mlstm_chunk: chunk {chunk} (at most {MAX_CHUNK})")
    ins = [q, k, v, ig, fg]
    if state is not None:
        C0, n0, m0 = state
        if (C0.shape != (B, H, hd, hd) or n0.shape != (B, H, hd)
                or m0.shape != (B, H)
                or any(t.dtype != torch.float32 for t in state)):
            raise ValueError("mlstm_chunk: state must be float32 (C [B,H,hd,hd], "
                             "n [B,H,hd], m [B,H])")
        ins += [C0, n0, m0]
    build.refuse_grad("mlstm_chunk", BACKWARD, *ins)
    if any(t.device != q.device for t in ins):
        raise ValueError("mlstm_chunk: tensors on different devices")
    if not (all(t.is_contiguous() for t in (q, k, v)) and aligned16(q, k, v)):
        raise ValueError("mlstm_chunk: q, k, v must be contiguous and 16-byte aligned")
    igc = ig.float().contiguous()
    fgc = fg.float().contiguous()
    st = (None, None, None) if state is None else tuple(t.contiguous() for t in state)
    h = torch.empty_like(q)
    C, n, m = (torch.empty(B, H, hd, hd, dtype=torch.float32, device=q.device),
               torch.empty(B, H, hd, dtype=torch.float32, device=q.device),
               torch.empty(B, H, dtype=torch.float32, device=q.device))
    if B == 0 or H == 0:
        return h, (C, n, m)
    if S == 0:
        return h, zero_state(B, H, hd, q.device) if state is None else st
    scratch = (None,) * 4
    if q.dtype == torch.bfloat16:
        scratch = tuple(torch.empty(shape, dtype=torch.float32, device=q.device)
                        for shape in wgmma_plan(B, S, H, hd, chunk)["scratch"].values())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = (lambda t: None if t is None else t.data_ptr())       # noqa: E731
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), igc.data_ptr(),
                    fgc.data_ptr(), *map(ptr, st), h.data_ptr(), C.data_ptr(),
                    n.data_ptr(), m.data_ptr(), *map(ptr, scratch), B, S, H, hd, L,
                    hd ** -0.5, DTYPES[q.dtype], stream)
    build.check(err, "mlstm_chunk")
    launch_counts.count(__name__, ROUTES[q.dtype])
    return h, (C, n, m)
