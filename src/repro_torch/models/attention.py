"""GQA attention for the port: projections, cache writes, paged helpers.

Counterpart of the linear full-attention subset of ``repro.models.
attention``. The attention math itself lives in ``repro_torch.kernels``
(each module holds the CUDA wrapper and its plain PyTorch version);
``repeat_kv`` has no counterpart because the kernels index KV head
``h // G`` directly.

Cache writes update the cache tensors IN PLACE (``index_put_`` /
``copy_``) where the JAX package returned new arrays and relied on
buffer donation; each such site is marked ``# mutation``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_decode_attention import \
    paged_decode_attention_ref  # noqa: F401  (the JAX module's name)
from repro_torch.kernels.spec_decode_attention import \
    spec_attention_ref as spec_attention  # noqa: F401  (the JAX module's name)
from repro_torch.models.layers import rms_norm_headwise, rotary_embed


def qkv_proj(p, x, cfg, positions):
    """x [B,S,D] -> q [B,S,H,hd], k,v [B,S,K,hd] with rope/qk-norm applied."""
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if cfg.attn_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if cfg.qk_norm:
        q, k = rms_norm_headwise(q), rms_norm_headwise(k)
    if cfg.pos_emb == "rope":
        q = rotary_embed(q, positions, cfg.rope_theta, cfg.rotary_pct)
        k = rotary_embed(k, positions, cfg.rope_theta, cfg.rotary_pct)
    return q.contiguous(), k.contiguous(), v.contiguous()


def out_proj(p, o):
    return torch.einsum("bshk,hkd->bsd", o, p.wo)


def cache_update(k_cache, v_cache, k_new, v_new, cache_len):
    """Write k_new/v_new [B,1,K,hd] at ring slot ``cache_len % W`` of each
    row (``cache_len`` scalar or [B]). Returns the (same) caches."""
    B, W = k_cache.shape[:2]
    rows = torch.arange(B, device=k_cache.device)
    slot = torch.as_tensor(cache_len, device=k_cache.device).long() % W
    slot = slot.expand(B) if slot.dim() == 0 else slot
    k_cache.index_put_((rows, slot), k_new[:, 0].to(k_cache.dtype))   # mutation
    v_cache.index_put_((rows, slot), v_new[:, 0].to(v_cache.dtype))   # mutation
    return k_cache, v_cache


def chunk_write(cache, chunk, start: int):
    """Write a chunk [B,S,K,hd] at positions [start, start+S) of every row
    of a linear cache [B,W,K,hd] (JAX: ``dynamic_update_slice``)."""
    S, W = chunk.shape[1], cache.shape[1]
    if start < 0 or start + S > W:
        raise ValueError(f"chunk [{start}, {start + S}) overruns capacity {W}")
    cache[:, start:start + S].copy_(chunk)                            # mutation
    return cache


# ---------------------------------------------------------------------------
# Speculative verify: S draft tokens per row at per-row positions
# [cache_lens[b], cache_lens[b]+S). Linear caches write ahead: K/V past a
# row's accepted prefix needs no rollback, because every later read masks by
# cache position and K/V at accepted positions never depended on rejected
# tokens. The attention itself is ``spec_attention`` (plain) or the
# multi-query decode kernels of repro_torch.kernels.
# ---------------------------------------------------------------------------


def spec_cache_update(k_cache, v_cache, k_new, v_new, cache_lens, valid):
    """Verify-step write: k_new/v_new [B,S,K,hd] land at positions
    ``cache_lens[b] + s`` of row b (linear cache). Rows with ``valid[b,s]``
    False (padded draft tail) and positions past the cache are dropped:
    they write back the value they would have replaced (at ``pos % W``,
    distinct from every kept position of the row while S <= W), so no host
    sync picks them out."""
    B, S = k_new.shape[:2]
    W = k_cache.shape[1]
    dev = k_cache.device
    clens = torch.as_tensor(cache_lens, device=dev).reshape(-1).long()
    pos = clens[:, None] + torch.arange(S, device=dev)[None, :]
    keep = (valid.to(dev) & (pos < W))[:, :, None, None]
    pos = pos % W
    rows = torch.arange(B, device=dev)[:, None].expand(B, S)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        val = torch.where(keep, new.to(cache.dtype), cache[rows, pos])
        cache.index_put_((rows, pos), val)                            # mutation
    return k_cache, v_cache


def paged_spec_cache_update(pool_k, pool_v, k_new, v_new, block_tables,
                            cache_lens, valid, page_size: int):
    """Paged verify-step write: positions route through per-row block tables;
    invalid rows land on the trash page (kvpool.TRASH_PAGE == 0), the same
    place block-table padding already sends masked-out decode writes."""
    B, S = k_new.shape[:2]
    nbt = block_tables.shape[1]
    dev = pool_k.device
    clens = torch.as_tensor(cache_lens, device=dev).reshape(-1).long()
    rows = torch.arange(B, device=dev)[:, None].expand(B, S)
    pos = clens[:, None] + torch.arange(S, device=dev)[None, :]
    pi = torch.clamp(pos // page_size, 0, nbt - 1)
    page = torch.where(valid.to(dev), block_tables[rows, pi].long(),
                       torch.zeros_like(pos))
    off = pos % page_size
    pool_k.index_put_((page, off), k_new.to(pool_k.dtype))            # mutation
    pool_v.index_put_((page, off), v_new.to(pool_v.dtype))            # mutation
    return pool_k, pool_v


# ---------------------------------------------------------------------------
# Paged KV cache: one pool of fixed-size pages, per-request block tables
# (serving/kvpool.py owns allocation; this is the data path)
# ---------------------------------------------------------------------------


def paged_view(pool, block_tables):
    """pool [P, ps, K, hd], block_tables [B, n] -> [B, n*ps, K, hd]; row w of
    sequence b is position w (pages are position-ordered)."""
    g = pool[block_tables.long()]
    B, n, ps = g.shape[:3]
    return g.reshape((B, n * ps) + tuple(g.shape[3:]))


def paged_cache_update(pool_k, pool_v, k_new, v_new, block_tables, cache_len,
                       page_size: int):
    """Decode-step write: k_new/v_new [B,1,K,hd] land at position
    ``cache_len[b]`` of sequence b, routed through its block table."""
    B = block_tables.shape[0]
    clen = torch.as_tensor(cache_len, device=pool_k.device).long()
    clen = clen.expand(B) if clen.dim() == 0 else clen
    rows = torch.arange(B, device=pool_k.device)
    page = block_tables[rows, clen // page_size].long()
    off = clen % page_size
    pool_k.index_put_((page, off), k_new[:, 0].to(pool_k.dtype))     # mutation
    pool_v.index_put_((page, off), v_new[:, 0].to(pool_v.dtype))     # mutation
    return pool_k, pool_v


def paged_chunk_write(pool, chunk, block_table_row, start: int, page_size: int):
    """Extend-chunk write: chunk [1, S, K, hd] at positions [start, start+S)
    of the single sequence whose block table row is [n] int32."""
    S = chunk.shape[1]
    pos = start + torch.arange(S, device=pool.device)
    page = block_table_row.long()[pos // page_size]
    off = pos % page_size
    pool.index_put_((page, off), chunk[0].to(pool.dtype))             # mutation
    return pool
