"""GQA attention for the port: projections, cache writes, ring and paged
helpers.

Counterpart of ``repro.models.attention`` for full attention and the
local-attention ring cache (recurrentgemma). The attention math itself
lives in ``repro_torch.kernels`` (each module holds the CUDA wrapper and
its plain PyTorch version);
``repeat_kv`` has no counterpart because the kernels index KV head
``h // G`` directly.

Cache writes update the cache tensors IN PLACE (``index_put_`` /
``copy_``) where the JAX package returned new arrays and relied on
buffer donation; each such site is marked ``# mutation``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.kernels.paged_decode_attention import \
    paged_decode_attention_ref  # noqa: F401  (the JAX module's name)
from repro_torch.kernels.spec_decode_attention import \
    spec_attention_ref as spec_attention  # noqa: F401  (the JAX module's name)
from repro_torch.models.layers import rms_norm_headwise, rotary_embed


def _proj(x, w, b, cfg, positions, rotate: bool):
    y = torch.einsum("bsd,dhk->bshk", x, w)
    if cfg.attn_bias:
        y = y + b
    if rotate and cfg.qk_norm:
        y = rms_norm_headwise(y)
    if rotate and cfg.pos_emb == "rope":
        y = rotary_embed(y, positions, cfg.rope_theta, cfg.rotary_pct)
    return y.contiguous()


def q_proj(p, x, cfg, positions):
    """x [B,S,D] -> q [B,S,H,hd] with rope / qk-norm applied."""
    return _proj(x, p.wq, getattr(p, "bq", None), cfg, positions, True)


def kv_proj(p, x, cfg, positions):
    """x [B,S,D] -> k, v [B,S,K,hd] (k with rope / qk-norm applied)."""
    return (_proj(x, p.wk, getattr(p, "bk", None), cfg, positions, True),
            _proj(x, p.wv, getattr(p, "bv", None), cfg, positions, False))


def qkv_proj(p, x, cfg, positions):
    """x [B,S,D] -> q [B,S,H,hd], k,v [B,S,K,hd] with rope/qk-norm applied."""
    return (q_proj(p, x, cfg, positions),) + kv_proj(p, x, cfg, positions)


def out_proj(p, o):
    return torch.einsum("bshk,hkd->bsd", o, p.wo)


def cache_update(k_cache, v_cache, k_new, v_new, cache_len, keep=None):
    """Write k_new/v_new [B,1,K,hd] at ring slot ``cache_len % W`` of each
    row (``cache_len`` scalar or [B]). ``keep`` [B] bool: rows marked False
    write back the value they would replace. Returns the (same) caches."""
    B, W = k_cache.shape[:2]
    rows = torch.arange(B, device=k_cache.device)
    slot = torch.as_tensor(cache_len, device=k_cache.device).long() % W
    slot = slot.expand(B) if slot.dim() == 0 else slot
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        val = new[:, 0].to(cache.dtype)
        if keep is not None:
            val = torch.where(keep[:, None, None], val, cache[rows, slot])
        cache.index_put_((rows, slot), val)                           # mutation
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
# Ring (local-window) cache: position p lives at slot p % cap. Extend and the
# verify commit splice a chunk in; extend and verify attend to a
# position-ordered view of the ring plus the chunk.
# ---------------------------------------------------------------------------


def ring_order(cache, start: int):
    """Position-ordered view of a ring cache: row i holds position
    ``start - cap + i``."""
    return torch.roll(cache, shifts=-(start % cache.shape[1]), dims=1)


def ring_splice(cache, chunk, starts, lengths, old=None):
    """The ring holding the last ``cap`` positions of a sequence ending at
    ``starts[b] + lengths[b]``, where chunk [B,S,...] holds positions
    [starts[b], starts[b]+S) of row b, the first ``lengths[b]`` valid, and
    ``old`` (default: ``cache``) the ring of the positions before
    ``starts[b]``. Slot s takes its position's chunk row or keeps ``old``.
    Written into ``cache`` in place; ``starts``/``lengths`` are ints or [B]
    tensors (no host sync)."""
    B, cap = cache.shape[:2]
    S = chunk.shape[1]
    dev = cache.device
    starts = torch.as_tensor(starts, device=dev).long().reshape(-1).expand(B)
    lengths = torch.as_tensor(lengths, device=dev).long().reshape(-1).expand(B)
    end = (starts + lengths)[:, None]
    slot = torch.arange(cap, device=dev)[None, :]
    pos = end - cap + torch.remainder(slot - (end - cap), cap)       # [B, cap]
    from_chunk = pos >= starts[:, None]
    idx = torch.clamp(pos - starts[:, None], 0, max(S - 1, 0))
    rows = torch.arange(B, device=dev)[:, None]
    picked = chunk.to(cache.dtype)[rows, idx]
    keep_old = cache if old is None else old
    sel = from_chunk.reshape(B, cap, *([1] * (cache.dim() - 2)))
    cache.copy_(torch.where(sel, picked, keep_old))                   # mutation
    return cache


def ring_verify_view(cache, cache_lens):
    """Per-row position-ordered ring view for the verify step: row i of
    sequence b holds position ``cache_lens[b] - cap + i`` (negative =
    unwritten, masked by ``spec_attention_ring``)."""
    B, cap = cache.shape[:2]
    dev = cache.device
    idx = (cache_lens.long()[:, None] + torch.arange(cap, device=dev)[None, :]) % cap
    return cache[torch.arange(B, device=dev)[:, None], idx]


def spec_attention_ring(q, k_view, v_view, cache_lens, *, q_per_kv: int,
                        window: int):
    """Multi-token decode attention against a ring view plus the draft chunk
    (the JAX package's XLA ``spec_attention_ring``; no Pallas kernel).

    q [B,S,H,hd] (query s of row b at position ``cache_lens[b] + s``) against
    ``concat(ring_verify_view(cache), chunk)`` [B,cap+S,K,hd], whose row i
    holds position ``cache_lens[b] - cap + i``. Queries attend causally
    within the sliding ``window``; nothing is written.
    """
    B, S, H, hd = q.shape
    T, K = k_view.shape[1], k_view.shape[2]
    cap = T - S
    qg = q.reshape(B, S, K, q_per_kv, hd).float()
    s = torch.einsum("bskgh,bwkh->bkgsw", qg, k_view.float()) / math.sqrt(hd)
    clens = cache_lens.long()[:, None]
    pos_k = clens - cap + torch.arange(T, device=q.device)[None]
    pos_q = clens + torch.arange(S, device=q.device)[None]
    valid = ((pos_k[:, None, :] >= 0) & (pos_k[:, None, :] <= pos_q[:, :, None])
             & (pos_q[:, :, None] - pos_k[:, None, :] < window))     # [B,S,T]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgsw,bwkh->bskgh", p.to(v_view.dtype).float(), v_view.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def ring_verify_commit(record, cache, cache_lens, ns, valid):
    """Splice the first ``ns[b]`` draft K/V rows of the verify record into
    each row's ring (rows not ``valid`` stay bit for bit)."""
    lengths = torch.where(valid, ns.long(), torch.zeros_like(ns.long()))
    ring_splice(cache["k"], record["k_new"], cache_lens, lengths)
    ring_splice(cache["v"], record["v_new"], cache_lens, lengths)
    return cache


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
