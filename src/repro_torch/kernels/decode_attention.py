"""One-token decode attention against a dense (ring) cache: the plain
PyTorch version and its CUDA kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py::
decode_attention`` with the split-K pair the port's decode forms share
(``split_decode.launch_split``; source ``csrc/split_decode_attention.cu``).
Grouped GQA (q viewed as ``[K, G, hd]``), valid slots
``pos < min(cache_len + 1, W)`` and, with a window, the ring-age mask
``age < min(window, n_valid + 1)``.

``decode_attention`` runs the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import split_decode
from repro_torch.kernels.flash_attention import NEG_INF

launches = 0            # kernel launches (never the plain version)


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


def decode_attention(q, k_cache, v_cache, cache_len, *, q_per_kv: int,
                     window: Optional[int] = None):
    """Decode attention (see the module docstring); same contract as
    ``decode_attention_ref``."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    q_per_kv=q_per_kv, window=window)
    return split_decode.decode("decode_attention", q, k_cache, v_cache, cache_len,
                               q_per_kv, one_token=True, window=window)
