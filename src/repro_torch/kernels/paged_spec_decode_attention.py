"""Multi-query decode attention for the speculative verify step over a
paged KV pool: the plain PyTorch version and its CUDA kernel.

The JAX package gathers the whole block-table view every layer and runs
the XLA ``spec_attention`` on it (``src/repro/models/transformer.py``,
verify mode; no Pallas kernel). The kernels are the paged decode kernels
with a grid dimension over the S queries of a row
(``split_decode.launch_split``; source ``csrc/split_decode_attention.cu``,
split-K): the blocks of query s read only the live pages it attends, where
the gather copies all ``nw`` pages of the block table. Query s of row b
sits at position ``cache_lens[b] + s`` and sees positions
``<= cache_lens[b] + s``; the draft K/V is already written. Split boundaries are fixed absolute positions, so query s computes
exactly what a one-token call at cache length ``cache_lens[b] + s``
computes, bit for bit.

``paged_spec_decode_attention`` runs the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

from repro_torch.kernels import split_decode
from repro_torch.kernels.spec_decode_attention import spec_attention_ref

launches = 0            # kernel launches (never the plain version)


def paged_spec_attention_ref(q, pool_k, pool_v, block_tables, cache_lens, *,
                             q_per_kv: int):
    """Plain version: ``spec_attention_ref`` over each row's gathered
    position-ordered view ``[B, nw * ps, K, hd]``."""
    def view(pool):
        g = pool[block_tables.long()]
        return g.reshape((g.shape[0], -1) + tuple(pool.shape[2:]))
    return spec_attention_ref(q, view(pool_k), view(pool_v), cache_lens,
                              q_per_kv=q_per_kv)


def paged_spec_decode_attention(q, pool_k, pool_v, block_tables, cache_lens, *,
                                q_per_kv: int):
    """Paged multi-query decode attention (see the module docstring); same
    contract as ``paged_spec_attention_ref``. pools [P, ps, K, hd],
    block_tables [B, nw] int32."""
    if q.device.type == "cpu":
        return paged_spec_attention_ref(q, pool_k, pool_v, block_tables,
                                        cache_lens, q_per_kv=q_per_kv)
    return split_decode.decode("paged_spec_decode_attention", q, pool_k, pool_v,
                               cache_lens, q_per_kv, one_token=False,
                               block_tables=block_tables)
