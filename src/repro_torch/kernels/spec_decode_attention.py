"""Multi-query decode attention for the speculative verify step against a
dense (linear) cache: the plain PyTorch version and its CUDA kernel.

The JAX package computes this in XLA (``src/repro/models/attention.py::
spec_attention``; it has no Pallas kernel). The kernel is the one-token
decode's split-K pair with a grid dimension over the S queries of a row
(``split_decode.launch_split``; source ``csrc/split_decode_attention.cu``):
query s of row b sits at position ``cache_lens[b] + s`` and sees positions
``<= cache_lens[b] + s``; split boundaries are fixed absolute slots, so the
result equals S successive ``decode_attention`` calls bit for bit. The
draft K/V is already written.

``spec_decode_attention`` runs the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import split_decode
from repro_torch.kernels.flash_attention import NEG_INF

launches = 0            # kernel launches (never the plain version)


def spec_attention_ref(q, k_cache, v_cache, cache_lens, *, q_per_kv: int):
    """Plain version (the JAX ``spec_attention``): q [B,S,H,hd] against a
    linear cache [B,W,K,hd]; cache_lens [B]."""
    B, S, H, hd = q.shape
    W, K = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, S, K, q_per_kv, hd).float()
    s = torch.einsum("bskgh,bwkh->bkgsw", qg, k_cache.float()) / math.sqrt(hd)
    clens = torch.as_tensor(cache_lens, device=q.device).reshape(-1).long()
    pos_q = clens[:, None] + torch.arange(S, device=q.device)[None, :]
    valid = torch.arange(W, device=q.device)[None, None, :] <= pos_q[:, :, None]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgsw,bwkh->bskgh", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def spec_decode_attention(q, k_cache, v_cache, cache_lens, *, q_per_kv: int):
    """Multi-query decode attention (see the module docstring); same
    contract as ``spec_attention_ref``."""
    if q.device.type == "cpu":
        return spec_attention_ref(q, k_cache, v_cache, cache_lens,
                                  q_per_kv=q_per_kv)
    return split_decode.decode("spec_decode_attention", q, k_cache, v_cache,
                               cache_lens, q_per_kv, one_token=False)
