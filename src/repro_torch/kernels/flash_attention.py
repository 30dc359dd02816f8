"""Causal flash attention: the plain PyTorch versions and their CUDA kernels.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention`` (source: ``csrc/flash_attention.cu``). Two differences
from it: KV is native GQA (``k, v [B, T, K, hd]`` plus ``q_per_kv``; the
result equals the reference applied to ``repeat_kv(k)``), and ``q_start``
places query row i at position ``q_start + i`` (key j sits at position j),
so the same kernel carries prefill, dense extend over a cache row and paged
extend over a gathered page view.

Two routes, chosen by dtype at the C entry point: bf16 runs the tensor-core
kernel (``csrc/flash_attention_wgmma.cu``: wgmma fed by TMA), float32 the
CUDA-core kernel (``csrc/flash_attention.cu``), because the tensor cores
take float32 only as TF32. ``launches_by_route`` counts each.

``flash_attention`` runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.

Gradients: when autograd is on and an input requires grad, the call goes
through ``FlashAttention`` (a ``torch.autograd.Function``). Its forward is
the same call with the rows' log-sum-exp saved (the kernel writes it when
given the buffer; serving passes none); its backward is the hand-written
backward kernel on the card (``csrc/flash_attention_bwd_wgmma.cu`` for
bf16, ``csrc/flash_attention_bwd.cu`` for float32, routes ``wgmma_bwd``
and ``simt_f32_bwd``: a dK / dV kernel and a dQ kernel, no atomics, so two
calls give the same bits) and ``flash_attention_bwd``, its plain version,
on the CPU. The JAX package has no backward kernel: its Pallas kernels
have no VJP and it trains on the XLA path, whose gradient is XLA's
autodiff of ``repro.models.attention.flash_attention``; the backward
kernel replaces that gradient. What bounds it: operations, five products
over the causal pairs (``costs.flash_bwd``), which only the tensor cores
come near in bf16. The bf16 dK / dV kernel runs a block per ``BWD_TILE``
keys of a KV head and row: one warpgroup up to head dim ``BWD_WIDE_HD``
(two blocks an SM), two splitting the columns at hd 256 (one pass), the
last warp done with a stage of its Q / dO ring refilling it; the G heads
of a KV head are summed in the block or, split by ``bwd_splits``, in
float32 partials added in split order. The dQ kernel is warp-specialised:
a TMA producer warpgroup feeds two wgmma consumer warpgroups. The rest is
in the source's note.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, launch_counts

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

ROUTES = {torch.bfloat16: "wgmma", torch.float32: "simt_f32"}
BWD_ROUTES = {torch.bfloat16: "wgmma_bwd", torch.float32: "simt_f32_bwd"}

launches = 0            # kernel launches, forward and backward (never the plain version)
launches_by_route = {route: 0 for route in (*ROUTES.values(), *BWD_ROUTES.values())}
_fn = None
_bwd_fn = None

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entry points' arguments (csrc/flash_attention.cu::flash_attention_fwd,
# csrc/flash_attention_bwd.cu::flash_attention_bwd): pointers and the stream
# as c_void_p, ints as c_int
FWD_ARGTYPES = [_P] * 5 + [_I] * 9 + [_P]
BWD_ARGTYPES = [_P] * 11 + [_I] * 10 + [_P]

# the bf16 backward's dK / dV grid (csrc/flash_attention_bwd_wgmma.cu): a
# block per BWD_TILE keys of a KV head and row (two blocks an SM up to head
# dim BWD_WIDE_HD, one above it), the G query heads of a KV head split over
# up to MAX_SPLITS blocks until the grid covers the card twice
BWD_TILE = 64
BWD_WIDE_HD = 128
MAX_SPLITS = 4
SMS = 132               # an H100's streaming multiprocessors


def aligned16(*tensors) -> bool:
    """The kernels read tiles with 16-byte vector loads."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def bwd_splits(B: int, T: int, K: int, G: int, hd: int, dtype) -> int:
    """Into how many parts the bf16 backward's dK / dV blocks split the G
    query heads of a KV head: the least power of two (dividing G, at most
    ``MAX_SPLITS``) that gives the card two waves of blocks, so the uneven
    causal walks (key tile 0 sees every query tile, the last one) spread
    over it; each part writes float32 partials, added in split order. The
    float32 route takes 1."""
    if dtype != torch.bfloat16:
        return 1
    blocks = B * K * -(-T // BWD_TILE)
    wave = SMS * (2 if hd <= BWD_WIDE_HD else 1)
    n = 1
    while n < MAX_SPLITS and G % (2 * n) == 0 and blocks * n < 2 * wave:
        n *= 2
    return n


def flash_attention_ref(q, k, v, *, q_per_kv: int, window: Optional[int] = None,
                        q_start: int = 0, return_lse: bool = False):
    """Plain version. q [B,S,H,hd]; k, v [B,T,K,hd] with H == K * q_per_kv.
    Causal in positions (q row i at ``q_start + i``), optional sliding
    window; float32 scores and accumulation, probabilities rounded to the
    value dtype before P·V as in the reference. ``return_lse``: also each
    row's log-sum-exp of its scaled, masked scores, float32 [B, H, S] (the
    backward's input)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, q_per_kv, hd).float()
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * (1.0 / math.sqrt(hd))
    q_pos = q_start + torch.arange(S, device=q.device)
    k_pos = torch.arange(T, device=q.device)
    mask = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype).float(), v.float())
    o = o.reshape(B, S, H, hd).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, H, S)
    return o


def _kernel():
    global _fn
    if _fn is None:
        _fn = build.entry("flash_attention_fwd", FWD_ARGTYPES)
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        _bwd_fn = build.entry("flash_attention_bwd", BWD_ARGTYPES)
    return _bwd_fn


def _check_rows_see_keys(S, T, window, q_start, name):
    if window is not None and q_start + S - window >= T:
        raise ValueError(f"{name}: query rows past T={T} + window {window} see no key")


def flash_attention_bwd(q, k, v, o, do, *, q_per_kv: int,
                        window: Optional[int] = None, q_start: int = 0,
                        block: int = 128, lse=None):
    """Plain version of the backward: the gradient of ``flash_attention_ref``
    at (q, k, v), given its output ``o``, the output's gradient ``do`` and,
    optionally, the forward's row log-sum-exp ``lse`` (float32 [B, H, S];
    recomputed from q and k when None): (dq, dk, dv) in the dtypes of q, k
    and v.

    Query blocks of ``block`` rows, each against only the keys its rows can
    see (causal, ``window``), with the G = ``q_per_kv`` heads of a KV head
    stacked as rows: one block holds [B, K, G*block, keys] float32 scores,
    never [S, T]. P = exp(S - lse), dP = dO·Vᵀ, dS = P∘(dP − rowsum(dO∘O)),
    dQ = dS·K, and dK += dSᵀ·Q and dV += Pᵀ·dO (P rounded to the value
    dtype, as the forward's P·V) over the G heads of each KV head. Float32
    throughout. Every query row must see at least one key."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = q_per_kv
    _check_rows_see_keys(S, T, window, q_start, "flash_attention_bwd")
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    kf = k.to(f32).permute(0, 2, 1, 3)                       # [B, K, T, hd]
    vf = v.to(f32).permute(0, 2, 1, 3)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dq = torch.empty(B, S, H, hd, dtype=f32, device=q.device)
    delta = (do.to(f32) * o.to(f32)).sum(-1)                 # [B, S, H]

    def rows(x):                    # [B, n, H, ...] -> [B, K, G*n, ...] float32
        n = x.shape[1]
        x = x.to(f32).reshape((B, n, K, G) + x.shape[3:])
        x = x.permute((0, 2, 3, 1) + tuple(range(4, x.dim())))
        return x.reshape((B, K, G * n) + x.shape[4:])

    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        n = s1 - s0
        lo = 0 if window is None else max(0, q_start + s0 - window + 1)
        hi = min(T, q_start + s1)
        qb, dob = rows(q[:, s0:s1]), rows(do[:, s0:s1])
        kb, vb = kf[:, :, lo:hi], vf[:, :, lo:hi]
        q_pos = (q_start + torch.arange(s0, s1, device=q.device)).repeat(G)
        k_pos = torch.arange(lo, hi, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = (qb @ kb.transpose(-1, -2)) * scale
        s = s.masked_fill(~mask, NEG_INF)
        if lse is None:
            p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
        else:
            p = torch.exp(s - rows(lse.transpose(1, 2)[:, s0:s1, :, None]))
        del s
        ds = p * (dob @ vb.transpose(-1, -2) - rows(delta[:, s0:s1, :, None]))
        dv[:, :, lo:hi] += p.to(v.dtype).to(f32).transpose(-1, -2) @ dob
        dk[:, :, lo:hi] += (ds.transpose(-1, -2) @ qb) * scale
        dqb = (ds @ kb) * scale                              # [B, K, G*n, hd]
        dq[:, s0:s1] = dqb.reshape(B, K, G, n, hd).permute(0, 3, 1, 2, 4) \
            .reshape(B, n, H, hd)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward is the wrapper's
    call with the rows' log-sum-exp kept (the kernel on the card), the
    backward the backward kernel on the very q, k, v the forward saw, its
    output and its log-sum-exp (``flash_attention_bwd``, the plain
    version, on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, q_per_kv, window, q_start):
        o, lse = _forward(q, k, v, q_per_kv=q_per_kv, window=window, q_start=q_start,
                          with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(q_per_kv=q_per_kv, window=window, q_start=q_start)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        a = ctx.args
        with torch.profiler.record_function("flash_attention_bwd"):
            if q.device.type == "cpu":
                dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse=lse, **a)
            else:
                dq, dk, dv = _launch_bwd(q, k, v, o, do.contiguous(), lse,
                                         a["q_per_kv"], a["window"], a["q_start"])
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, q_per_kv: int, window: Optional[int] = None,
                    q_start: int = 0):
    """Causal flash attention (see the module docstring); same contract as
    ``flash_attention_ref``. Under autograd, with an input that requires
    grad, it is ``FlashAttention`` (the same forward, with a backward)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, q_per_kv, window, q_start)
    return _forward(q, k, v, q_per_kv=q_per_kv, window=window, q_start=q_start)


def _forward(q, k, v, *, q_per_kv: int, window: Optional[int] = None,
             q_start: int = 0, with_lse: bool = False):
    """The plain version (CPU tensors), or the kernel's operator: o, or
    (o, lse) with ``with_lse``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_per_kv=q_per_kv, window=window,
                                   q_start=q_start, return_lse=with_lse)
    o, lse = _launch(q, k, v, q_per_kv, window, q_start, with_lse)
    return (o, lse) if with_lse else o


def _check(name, q, k, v, q_per_kv, window, q_start):
    """What both kernels take: shapes, head dims, dtypes, one CUDA device,
    contiguous 16-byte aligned inputs."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, S, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    T, K = k.shape[1], k.shape[2]
    if K * q_per_kv != H:
        raise ValueError(f"{name}: {H} heads != {K} KV heads x {q_per_kv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: tensors on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and aligned16(q, k, v)):
        raise ValueError(f"{name}: inputs must be contiguous and 16-byte aligned")
    if q_start < 0 or T < 1 or (window is not None and window < 1):
        raise ValueError(f"{name}: q_start={q_start} T={T} window={window}")


@build.op("flash_attention", "(Tensor q, Tensor k, Tensor v, int q_per_kv, "
          "int? window, int q_start, bool with_lse=False) -> (Tensor, Tensor)")
def _launch(q, k, v, q_per_kv, window, q_start, with_lse=False):
    """The kernel on CUDA tensors (``torch.ops.repro_torch.flash_attention``):
    (o, lse), lse float32 [B, H, S] with ``with_lse``, else empty (serving:
    the kernel writes none)."""
    _check("flash_attention", q, k, v, q_per_kv, window, q_start)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S) if with_lse else (0,), dtype=torch.float32,
                      device=q.device)
    if B == 0 or S == 0:
        return o, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr() if with_lse else None,
                    B, S, T, H, K, hd, int(q_start), window or 0,
                    DTYPES[q.dtype], stream)
    build.check(err, "flash_attention")
    launch_counts.count(__name__, ROUTES[q.dtype])
    return o, lse


@build.op("flash_attention_bwd", "(Tensor q, Tensor k, Tensor v, Tensor o, "
          "Tensor dout, Tensor lse, int q_per_kv, int? window, int q_start) "
          "-> (Tensor, Tensor, Tensor)")
def _launch_bwd(q, k, v, o, dout, lse, q_per_kv, window, q_start):
    """The backward kernel on CUDA tensors
    (``torch.ops.repro_torch.flash_attention_bwd``): (dq, dk, dv) of
    ``flash_attention`` at (q, k, v), given its output ``o``, the output's
    gradient ``dout`` and its row log-sum-exp ``lse`` (float32 [B, H, S])."""
    _check("flash_attention_bwd", q, k, v, q_per_kv, window, q_start)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous() or not aligned16(t):
            raise ValueError(f"flash_attention_bwd: {name} must be a contiguous, "
                             f"16-byte aligned {q.dtype} tensor of q's shape")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or lse.device != q.device \
            or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype} "
                         f"is not float32 [B, H, S] on {q.device}")
    _check_rows_see_keys(S, T, window, q_start, "flash_attention_bwd")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or S == 0:
        return dq, dk.zero_(), dv.zero_()
    nsplit = bwd_splits(B, T, K, q_per_kv, hd, q.dtype)
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty(B, H, S, **f32)
    part = torch.empty(2 * nsplit * k.numel(), **f32) if nsplit > 1 else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        None if part is None else part.data_ptr(),
                        B, S, T, H, K, hd, int(q_start), window or 0, nsplit,
                        DTYPES[q.dtype], stream)
    build.check(err, "flash_attention_bwd")
    launch_counts.count(__name__, BWD_ROUTES[q.dtype])
    return dq, dk, dv
