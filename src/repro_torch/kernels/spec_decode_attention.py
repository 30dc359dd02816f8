"""Multi-query decode attention for the speculative verify step against a
dense (linear) cache: the plain PyTorch version and its CUDA kernel.

The JAX package computes this in XLA (``src/repro/models/attention.py::
spec_attention``; it has no Pallas kernel). The kernel is the one-token
decode kernel with a grid dimension over the S queries of a row
(``csrc/decode_attention.cu``, entry ``spec_decode_attention_fwd``): query
s of row b sits at position ``cache_lens[b] + s`` and sees positions
``<= cache_lens[b] + s``, so the result equals S successive
``decode_attention`` calls; the draft K/V is already written.

``spec_decode_attention`` runs the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import check_decode_inputs, lens_on_device
from repro_torch.kernels.flash_attention import DTYPES, NEG_INF

launches = 0            # kernel launches (never the plain version)
_fn = None


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


def _kernel():
    global _fn
    if _fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _fn = build.entry("spec_decode_attention_fwd",
                          [P, P, P, P, P, I, I, I, I, I, I, I, P])
    return _fn


def spec_decode_attention(q, k_cache, v_cache, cache_lens, *, q_per_kv: int):
    """Multi-query decode attention (see the module docstring); same
    contract as ``spec_attention_ref``."""
    if q.device.type == "cpu":
        return spec_attention_ref(q, k_cache, v_cache, cache_lens,
                                  q_per_kv=q_per_kv)
    if q.device.type != "cuda":
        raise ValueError(f"spec_decode_attention: unsupported device {q.device}")
    B, H, hd = check_decode_inputs("spec_decode_attention", q, k_cache, v_cache,
                                   q_per_kv, multi_query=True)
    if k_cache.shape[0] != B or k_cache.shape[1] < 1:
        raise ValueError(f"spec_decode_attention: cache {tuple(k_cache.shape)} "
                         f"for batch {B}")
    S = q.shape[1]
    W, K = k_cache.shape[1], k_cache.shape[2]
    clen = lens_on_device(cache_lens, B, q.device)
    o = torch.empty_like(q)
    if B == 0 or S == 0:
        return o
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    clen.data_ptr(), o.data_ptr(), B, S, W, K, q_per_kv, hd,
                    DTYPES[q.dtype], stream)
    build.check(err, "spec_decode_attention")
    global launches
    launches += 1
    return o
