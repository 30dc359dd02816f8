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


def flash_attention(q, k, v, *, q_per_kv: int, window: Optional[int] = None,
                    q_start: int = 0):
    """Causal flash attention (see the module docstring); same contract as
    ``flash_attention_ref``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_per_kv=q_per_kv, window=window,
                                   q_start=q_start)
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
