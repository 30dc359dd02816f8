"""One-token decode attention over a paged KV pool: the plain PyTorch
version and its CUDA kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/paged_decode_attention.py::
paged_decode_attention`` (source: ``csrc/paged_decode_attention.cu``, entry
``paged_split_decode_attention_fwd``, which the multi-query verify form
shares). Position p of row b lives in page ``block_tables[b, p // ps]``;
valid positions are ``p < cache_len + 1``. The kernel visits only the
live pages of a row, where the Pallas grid walks every block-table entry
(padding to trash page 0 included); the result equals the masked
reference either way.

Split-K: the positions of a row are cut at fixed absolute boundaries, every
``SPLIT`` positions; one block per (split, KV head, row, query) writes
float32 partials (m, l, acc) into scratch, and a second kernel merges them
in split order with the log-sum-exp rescale. ``split_plan`` gives the
scratch shapes the wrapper allocates.

``paged_decode_attention`` runs the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (check_decode_inputs,
                                                  decode_attention_ref,
                                                  lens_on_device)
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS

# csrc/paged_decode_attention.cu's SPLIT and MAX_G (a CPU test holds them equal)
SPLIT = 128             # positions per split: 8 pages of 16
MAX_G = 64              # query heads per KV head the kernel's shared memory takes

launches = 0            # kernel launches (never the plain version)
_fn = None


def split_plan(B: int, S: int, K: int, G: int, hd: int, nw: int, ps: int):
    """(n_splits, part_acc shape, part_ml shape) of the split-K scratch for
    B rows of S queries, K KV heads of G query heads, head_dim hd and a
    block table of nw pages of ps positions. Split j covers positions
    [j * SPLIT, (j + 1) * SPLIT); a row's splits past its n_valid are
    neither written nor read."""
    n_splits = -(-(nw * ps) // SPLIT)
    return (n_splits, (B, S, K, G, n_splits, hd), (B, S, K, G, n_splits, 2))


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
        _fn = build.entry("paged_split_decode_attention_fwd",
                          [P, P, P, P, P, P, P, P] + [I] * 8 + [P])
    return _fn


def launch_split(name, q, pool_k, pool_v, block_tables, cache_len, q_per_kv):
    """Checks shared by the one-token and multi-query wrappers, then the
    split and combine kernels on a CUDA tensor; returns the output."""
    B, H, hd = check_decode_inputs(name, q, pool_k, pool_v, q_per_kv,
                                   multi_query=True)
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or block_tables.device != q.device):
        raise ValueError(f"{name}: block_tables {tuple(block_tables.shape)} "
                         f"for batch {B}")
    if hd not in HEAD_DIMS or q_per_kv > MAX_G:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS} or "
                         f"q_per_kv {q_per_kv} > {MAX_G}")
    S = q.shape[1]
    ps, K = pool_k.shape[1], pool_k.shape[2]
    nw = block_tables.shape[1]
    bt = block_tables.to(torch.int32).contiguous()
    clen = lens_on_device(cache_len, B, q.device)
    o = torch.empty_like(q)
    if B == 0 or S == 0:
        return o
    _, acc_shape, ml_shape = split_plan(B, S, K, q_per_kv, hd, nw, ps)
    n_acc = math.prod(acc_shape)
    # one allocation for both partials (acc, then (m, l)); 16-byte aligned
    # since n_acc is a multiple of hd >= 16
    scratch = torch.empty(n_acc + math.prod(ml_shape), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                    bt.data_ptr(), clen.data_ptr(), scratch.data_ptr(),
                    scratch.data_ptr() + 4 * n_acc, o.data_ptr(), B, S, ps, K,
                    q_per_kv, hd, nw, DTYPES[q.dtype], stream)
    build.check(err, name)
    return o


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
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention: q must be [B, 1, H, hd], "
                         f"got {tuple(q.shape)}")
    o = launch_split("paged_decode_attention", q, pool_k, pool_v, block_tables,
                     cache_len, q_per_kv)
    global launches
    launches += 1
    return o
