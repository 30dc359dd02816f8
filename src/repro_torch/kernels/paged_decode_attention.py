"""One-token decode attention over a paged KV pool: the plain PyTorch
version and its CUDA kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/paged_decode_attention.py::
paged_decode_attention`` (source: ``csrc/decode_attention.cu``, entry
``paged_decode_attention_fwd``, sharing its design with the dense decode
kernel). Position p of row b lives in page ``block_tables[b, p // ps]``;
valid positions are ``p < cache_len + 1``. The kernel visits only the
``ceil((cache_len + 1) / ps)`` live pages of a row, where the Pallas grid
walks every block-table entry (padding to trash page 0 included); the
result equals the masked reference either way.

``paged_decode_attention`` runs the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (check_decode_inputs,
                                                  decode_attention_ref,
                                                  lens_on_device)
from repro_torch.kernels.flash_attention import DTYPES

launches = 0            # kernel launches (never the plain version)
_fn = None


def paged_decode_attention_ref(q, pool_k, pool_v, block_tables, cache_len, *,
                               q_per_kv: int):
    """Plain version: gather each row's pages into a dense position-ordered
    view ``[B, nw * ps, K, hd]``, then the dense decode math (no window)."""
    def view(pool):
        g = pool[block_tables.long()]
        return g.reshape((g.shape[0], -1) + tuple(pool.shape[2:]))
    return decode_attention_ref(q, view(pool_k), view(pool_v), cache_len,
                                q_per_kv=q_per_kv, window=None)


def _kernel():
    global _fn
    if _fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _fn = build.entry("paged_decode_attention_fwd",
                          [P, P, P, P, P, P, I, I, I, I, I, I, I, P])
    return _fn


def paged_decode_attention(q, pool_k, pool_v, block_tables, cache_len, *,
                           q_per_kv: int):
    """Paged decode attention (see the module docstring); same contract as
    ``paged_decode_attention_ref``. pools [P, ps, K, hd], block_tables
    [B, nw] int32; the new token's K/V is already written."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, pool_k, pool_v, block_tables,
                                          cache_len, q_per_kv=q_per_kv)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    B, H, hd = check_decode_inputs("paged_decode_attention", q, pool_k, pool_v,
                                   q_per_kv)
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or block_tables.device != q.device):
        raise ValueError(f"paged_decode_attention: block_tables "
                         f"{tuple(block_tables.shape)} for batch {B}")
    ps, K = pool_k.shape[1], pool_k.shape[2]
    nw = block_tables.shape[1]
    bt = block_tables.to(torch.int32).contiguous()
    clen = lens_on_device(cache_len, B, q.device)
    o = torch.empty_like(q)
    if B == 0:
        return o
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                    bt.data_ptr(), clen.data_ptr(), o.data_ptr(), B, ps, K,
                    q_per_kv, hd, nw, DTYPES[q.dtype], stream)
    build.check(err, "paged_decode_attention")
    global launches
    launches += 1
    return o
