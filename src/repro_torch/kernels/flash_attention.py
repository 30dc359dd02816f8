"""Causal flash attention: the plain PyTorch version and its CUDA kernel.

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
through ``FlashAttention`` (a ``torch.autograd.Function``): its forward is
the same call (the kernel on the card, the plain version on the CPU, so
the CPU tests run the backward the card runs) and its backward is
``flash_attention_bwd``, written out in PyTorch. The JAX package has no
backward kernel either: its Pallas kernels have no VJP and it trains on
the XLA path, whose gradient is XLA's autodiff of
``repro.models.attention.flash_attention``. A backward kernel is
``ROADMAP.md`` queue 2 item 8.
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

launches = 0            # kernel launches (never the plain version)
launches_by_route = {route: 0 for route in ROUTES.values()}
_fn = None


def aligned16(*tensors) -> bool:
    """The kernels read tiles with 16-byte vector loads."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def flash_attention_ref(q, k, v, *, q_per_kv: int, window: Optional[int] = None,
                        q_start: int = 0):
    """Plain version. q [B,S,H,hd]; k, v [B,T,K,hd] with H == K * q_per_kv.
    Causal in positions (q row i at ``q_start + i``), optional sliding
    window; float32 scores and accumulation, probabilities rounded to the
    value dtype before P·V as in the reference."""
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
    return o.reshape(B, S, H, hd).to(q.dtype)


def _kernel():
    global _fn
    if _fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _fn = build.entry("flash_attention_fwd",
                          [P, P, P, P, I, I, I, I, I, I, I, I, I, P])
    return _fn


def flash_attention_bwd(q, k, v, o, do, *, q_per_kv: int,
                        window: Optional[int] = None, q_start: int = 0,
                        block: int = 128):
    """The gradient of ``flash_attention_ref`` at (q, k, v), given its
    output ``o`` and the output's gradient ``do``: (dq, dk, dv) in the
    dtypes of q, k and v.

    Query blocks of ``block`` rows, each against only the keys its rows can
    see (causal, ``window``), with the G = ``q_per_kv`` heads of a KV head
    stacked as rows: one block holds [B, K, G*block, keys] float32 scores,
    never [S, T]. Each block recomputes its log-sum-exp from q and k, then
    P = exp(S - lse), dP = dO·Vᵀ, dS = P∘(dP − rowsum(dO∘O)), dQ = dS·K,
    and adds dK += dSᵀ·Q and dV += Pᵀ·dO (P rounded to the value dtype, as
    the forward's P·V) over the G heads of each KV head. Float32 throughout.
    Every query row must see at least one key."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = q_per_kv
    if window is not None and q_start + S - window >= T:
        raise ValueError(f"flash_attention_bwd: query rows past T={T} + window "
                         f"{window} see no key")
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
        p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
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
    call (the kernel on the card), the backward ``flash_attention_bwd`` on
    the very q, k, v the forward saw and its output."""

    @staticmethod
    def forward(ctx, q, k, v, q_per_kv, window, q_start):
        o = _forward(q, k, v, q_per_kv=q_per_kv, window=window, q_start=q_start)
        ctx.save_for_backward(q, k, v, o)
        ctx.args = dict(q_per_kv=q_per_kv, window=window, q_start=q_start)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention_bwd"):
            dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(),
                                             **ctx.args)
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
             q_start: int = 0):
    """The plain version (CPU tensors), or the kernel's operator."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_per_kv=q_per_kv, window=window,
                                   q_start=q_start)
    return _launch(q, k, v, q_per_kv, window, q_start)


@build.op("flash_attention", "(Tensor q, Tensor k, Tensor v, int q_per_kv, "
          "int? window, int q_start) -> Tensor")
def _launch(q, k, v, q_per_kv, window, q_start):
    """The kernel on CUDA tensors (``torch.ops.repro_torch.flash_attention``)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, S, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    T, K = k.shape[1], k.shape[2]
    if K * q_per_kv != H:
        raise ValueError(f"flash_attention: {H} heads != {K} KV heads x {q_per_kv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: tensors on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and aligned16(q, k, v)):
        raise ValueError("flash_attention: inputs must be contiguous and "
                         "16-byte aligned")
    if q_start < 0 or T < 1 or (window is not None and window < 1):
        raise ValueError(f"flash_attention: q_start={q_start} T={T} window={window}")
    o = torch.empty_like(q)
    if B == 0 or S == 0:
        return o
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    B, S, T, H, K, hd, int(q_start), window or 0,
                    DTYPES[q.dtype], stream)
    build.check(err, "flash_attention")
    launch_counts.count(__name__, ROUTES[q.dtype])
    return o
