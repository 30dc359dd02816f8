"""One-token decode attention against a dense (ring) cache: the plain
PyTorch version and its CUDA kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py::
decode_attention`` (source: ``csrc/decode_attention.cu``, entry
``decode_attention_fwd``). Grouped GQA (q viewed as ``[K, G, hd]``), valid
positions ``pos < min(cache_len + 1, W)`` and, with a window, the ring-age
mask ``age < min(window, n_valid + 1)``.

``decode_attention`` runs the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES, NEG_INF, aligned16

launches = 0            # kernel launches (never the plain version)
_fn = None


def decode_attention_ref(q, k_cache, v_cache, cache_len, *, q_per_kv: int,
                         window: Optional[int] = None):
    """Plain version: q [B,1,H,hd] against caches [B,W,K,hd]; cache_len
    scalar or [B]; the new token's K/V is already written."""
    B, W, K, hd = k_cache.shape
    H = q.shape[2]
    qg = q.reshape(B, K, q_per_kv, hd).float()
    s = torch.einsum("bkgh,bwkh->bkgw", qg, k_cache.float()) / math.sqrt(hd)
    pos = torch.arange(W, device=q.device)
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1).long()
    n_valid = torch.clamp(clen + 1, max=W)                    # [1|B]
    valid = pos[None, :] < n_valid[:, None]
    if window is not None:
        age = (clen % max(W, 1))[:, None] - pos[None, :]
        age = torch.where(age < 0, age + W, age)
        valid &= age < torch.clamp(n_valid + 1, max=window)[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bwkh->bkgh", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def check_decode_inputs(name, q, k, v, q_per_kv, *, multi_query=False):
    """Shape / dtype / device / contiguity checks shared by the decode
    wrappers (one query per row, or S with ``multi_query``). Returns
    (B, H, hd)."""
    if q.dim() != 4 or (q.shape[1] != 1 and not multi_query):
        raise ValueError(f"{name}: q must be [B, 1, H, hd], got {tuple(q.shape)}")
    B, _, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[3] != hd:
        raise ValueError(f"{name}: bad cache shapes {tuple(k.shape)} / "
                         f"{tuple(v.shape)} for q {tuple(q.shape)}")
    if k.shape[2] * q_per_kv != H:
        raise ValueError(f"{name}: {H} heads != {k.shape[2]} KV heads x {q_per_kv}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: tensors on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and aligned16(q, k, v)):
        raise ValueError(f"{name}: inputs must be contiguous and 16-byte aligned")
    if hd % 8:
        raise ValueError(f"{name}: head_dim {hd} is not a multiple of 8")
    return B, H, hd


def lens_on_device(cache_len, B, device):
    """cache_len (int, 0-d or [B]) as a contiguous int32 [B] device tensor."""
    clen = torch.as_tensor(cache_len, device=device)
    if clen.dim() == 0:
        clen = clen.expand(B)
    if clen.shape != (B,):
        raise ValueError(f"cache_len must be scalar or [{B}], got {tuple(clen.shape)}")
    return clen.to(torch.int32).contiguous()


def _kernel():
    global _fn
    if _fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _fn = build.entry("decode_attention_fwd",
                          [P, P, P, P, P, I, I, I, I, I, I, I, P])
    return _fn


def decode_attention(q, k_cache, v_cache, cache_len, *, q_per_kv: int,
                     window: Optional[int] = None):
    """Decode attention (see the module docstring); same contract as
    ``decode_attention_ref``."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    q_per_kv=q_per_kv, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, hd = check_decode_inputs("decode_attention", q, k_cache, v_cache,
                                   q_per_kv)
    if k_cache.shape[0] != B or k_cache.shape[1] < 1:
        raise ValueError(f"decode_attention: cache {tuple(k_cache.shape)} "
                         f"for batch {B}")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window={window}")
    W, K = k_cache.shape[1], k_cache.shape[2]
    clen = lens_on_device(cache_len, B, q.device)
    o = torch.empty_like(q)
    if B == 0:
        return o
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    clen.data_ptr(), o.data_ptr(), B, W, K, q_per_kv, hd,
                    window or 0, DTYPES[q.dtype], stream)
    build.check(err, "decode_attention")
    global launches
    launches += 1
    return o
