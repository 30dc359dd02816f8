"""Multi-query decode attention for the speculative verify step over a
paged KV pool: the plain PyTorch version and its CUDA kernel.

The JAX package gathers the whole block-table view every layer and runs
the XLA ``spec_attention`` on it (``src/repro/models/transformer.py``,
verify mode; no Pallas kernel). The kernel is the paged decode kernel with
a grid dimension over the S queries of a row (``csrc/decode_attention.cu``,
entry ``paged_spec_decode_attention_fwd``): the block of query s reads only
the ``ceil((cache_lens + s + 1) / ps)`` live pages it attends, where the
gather copies all ``nw`` pages of the block table. Query s of row b sits
at position ``cache_lens[b] + s`` and sees positions ``<= cache_lens[b] +
s``; the draft K/V is already written.

``paged_spec_decode_attention`` runs the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import check_decode_inputs, lens_on_device
from repro_torch.kernels.flash_attention import DTYPES
from repro_torch.kernels.spec_decode_attention import spec_attention_ref

launches = 0            # kernel launches (never the plain version)
_fn = None


def paged_spec_attention_ref(q, pool_k, pool_v, block_tables, cache_lens, *,
                             q_per_kv: int):
    """Plain version: ``spec_attention_ref`` over each row's gathered
    position-ordered view ``[B, nw * ps, K, hd]``."""
    def view(pool):
        g = pool[block_tables.long()]
        return g.reshape((g.shape[0], -1) + tuple(pool.shape[2:]))
    return spec_attention_ref(q, view(pool_k), view(pool_v), cache_lens,
                              q_per_kv=q_per_kv)


def _kernel():
    global _fn
    if _fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _fn = build.entry("paged_spec_decode_attention_fwd",
                          [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P])
    return _fn


def paged_spec_decode_attention(q, pool_k, pool_v, block_tables, cache_lens, *,
                                q_per_kv: int):
    """Paged multi-query decode attention (see the module docstring); same
    contract as ``paged_spec_attention_ref``. pools [P, ps, K, hd],
    block_tables [B, nw] int32."""
    if q.device.type == "cpu":
        return paged_spec_attention_ref(q, pool_k, pool_v, block_tables,
                                        cache_lens, q_per_kv=q_per_kv)
    if q.device.type != "cuda":
        raise ValueError(f"paged_spec_decode_attention: unsupported device {q.device}")
    B, H, hd = check_decode_inputs("paged_spec_decode_attention", q, pool_k,
                                   pool_v, q_per_kv, multi_query=True)
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or block_tables.device != q.device):
        raise ValueError(f"paged_spec_decode_attention: block_tables "
                         f"{tuple(block_tables.shape)} for batch {B}")
    S = q.shape[1]
    ps, K = pool_k.shape[1], pool_k.shape[2]
    nw = block_tables.shape[1]
    bt = block_tables.to(torch.int32).contiguous()
    clen = lens_on_device(cache_lens, B, q.device)
    o = torch.empty_like(q)
    if B == 0 or S == 0:
        return o
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                    bt.data_ptr(), clen.data_ptr(), o.data_ptr(), B, S, ps, K,
                    q_per_kv, hd, nw, DTYPES[q.dtype], stream)
    build.check(err, "paged_spec_decode_attention")
    global launches
    launches += 1
    return o
