"""One-token decode attention over a paged KV pool: the plain PyTorch
version and its CUDA kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/paged_decode_attention.py::
paged_decode_attention`` with the split-K pair the port's decode forms share
(``split_decode.launch_split``; source ``csrc/split_decode_attention.cu``).
Position p of row b lives in page ``block_tables[b, p // ps]``; valid
positions are ``p < cache_len + 1``. The kernel visits only the live pages
of a row, where the Pallas grid walks every block-table entry
(padding to trash page 0 included); the result equals the masked
reference either way.

``paged_decode_attention`` runs the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

from repro_torch.kernels import split_decode
from repro_torch.kernels.decode_attention import decode_attention_ref

launches = 0            # kernel launches (never the plain version)


def paged_decode_attention_ref(q, pool_k, pool_v, block_tables, cache_len, *,
                               q_per_kv: int):
    """Plain version: gather each row's pages into a dense position-ordered
    view ``[B, nw * ps, K, hd]``, then the dense decode math (no window)."""
    def view(pool):
        g = pool[block_tables.long()]
        return g.reshape((g.shape[0], -1) + tuple(pool.shape[2:]))
    return decode_attention_ref(q, view(pool_k), view(pool_v), cache_len,
                                q_per_kv=q_per_kv, window=None)


def paged_decode_attention(q, pool_k, pool_v, block_tables, cache_len, *,
                           q_per_kv: int):
    """Paged decode attention (see the module docstring); same contract as
    ``paged_decode_attention_ref``. pools [P, ps, K, hd], block_tables
    [B, nw] int32; the new token's K/V is already written."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, pool_k, pool_v, block_tables,
                                          cache_len, q_per_kv=q_per_kv)
    return split_decode.decode("paged_decode_attention", q, pool_k, pool_v,
                               cache_len, q_per_kv, one_token=True,
                               block_tables=block_tables)
