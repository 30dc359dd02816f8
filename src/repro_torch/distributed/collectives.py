"""Sequence-parallel decode attention: a KV cache cut by sequence over a
mesh axis, one log-sum-exp combine.

Counterpart of ``repro.distributed.collectives`` (its ``shard_map`` with a
``pmax`` / ``psum`` combine). Each sequence shard computes flash-decode
partials (m, l, acc) over its slots, and one combine merges them. On the
card both are the split-K decode kernel (``csrc/split_decode_attention.cu``)
launched apart: ``split_decode.launch_partials`` once per shard, writing
its 128-slot splits' float32 partials at their absolute split index into
one scratch, then ``launch_combine`` once, which merges every split in
split order. With shard boundaries at multiples of ``SPLIT`` the blocks
compute what the one-launch kernel computes, so the result equals
``decode_attention`` bit for bit. The plain version (``seqpar_decode_ref``,
the CPU's) is the reference's ``_local_flash_decode`` per shard and its
combine, in float32.

The serving path does not use it: the serve rules keep the sequence whole
("kv_seq" replicated), as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch import tracing
from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import Shards, split
from repro_torch.kernels import split_decode
from repro_torch.kernels.flash_attention import NEG_INF


def _local_flash_decode(q, k_shard, v_shard, valid):
    """q [B,K,G,hd]; k/v [B,Wl,K,hd]; valid [B,Wl] -> float32 (m, l, o)
    partials, the probabilities rounded to the value dtype before P·V."""
    s = torch.einsum("bkgh,bwkh->bkgw", q.float(), k_shard.float()) / math.sqrt(q.shape[-1])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)                                        # [B,K,G]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgw,bwkh->bkgh", p.to(v_shard.dtype).float(), v_shard.float())
    return m, l, o


def _valid(clen, W: int, lo: int, n: int, window: Optional[int]):
    """The reference's masks for slots [lo, lo + n) of a W-slot cache."""
    pos = lo + torch.arange(n, device=clen.device)
    n_valid = torch.clamp(clen + 1, max=W)
    valid = pos[None, :] < n_valid[:, None]
    if window is not None:
        age = (clen % W)[:, None] - pos[None, :]
        age = torch.where(age < 0, age + W, age)
        valid &= age < torch.clamp(n_valid + 1, max=window)[:, None]
    return valid


def seqpar_decode_ref(q, k_shards: Sequence, v_shards: Sequence, cache_len, *,
                      q_per_kv: int, window: Optional[int] = None):
    """Plain version: q [B,1,H,hd] against a dense (ring) cache cut by
    sequence into ``k_shards`` / ``v_shards`` ([B, Wl_r, K, hd], in slot
    order); per-shard partials, then m = max over shards and the rescaled
    sums, shard by shard."""
    B, _, H, hd = q.shape
    K = k_shards[0].shape[2]
    W = sum(k.shape[1] for k in k_shards)
    dev = q.device
    clen = torch.as_tensor(cache_len, device=dev).reshape(-1).long().expand(B)
    qg = q.reshape(B, K, q_per_kv, hd)
    parts, lo = [], 0
    for k, v in zip(k_shards, v_shards):
        n = k.shape[1]
        valid = _valid(clen, W, lo, n, window)
        parts.append(_local_flash_decode(qg, k.to(dev), v.to(dev), valid))
        lo += n
    m_g = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_g = o_g = 0.0
    for m, l, o in parts:
        corr = torch.exp(m - m_g)
        l_g = l_g + l * corr
        o_g = o_g + o * corr[..., None]
    out = o_g / torch.clamp(l_g, min=1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


def seqpar_decode_attention(q, k_shards: Shards, v_shards: Shards, cache_len, *,
                            q_per_kv: int, window: Optional[int] = None):
    """Decode attention over a cache cut by sequence (``Shards`` over dim
    1, part r on its device): the plain version for CPU tensors; on the
    card the partials launch of each shard and one combine on q's device.
    Shards must start at multiples of ``split_decode.SPLIT``."""
    if q.device.type == "cpu":
        return seqpar_decode_ref(q, k_shards.parts, v_shards.parts, cache_len,
                                 q_per_kv=q_per_kv, window=window)
    B, _, H, hd = q.shape
    K = H // q_per_kv
    W = k_shards.shape[1]
    clen = split_decode.lens_on_device(cache_len, B, q.device)
    acc, ml = split_decode.split_scratch(B, 1, K, q_per_kv, hd, W, q.device)
    lo = 0
    for k, v in zip(k_shards.parts, v_shards.parts):
        n = k.shape[1]
        if k.device == q.device:
            split_decode.launch_partials(q, k, v, clen, acc, ml, q_per_kv,
                                         n_pos=W, slot0=lo, window=window)
        else:
            # the shard's partials on its device, its splits copied over
            acc_r, ml_r = split_decode.split_scratch(B, 1, K, q_per_kv, hd, W, k.device)
            split_decode.launch_partials(q.to(k.device), k, v, clen.to(k.device),
                                         acc_r, ml_r, q_per_kv, n_pos=W, slot0=lo,
                                         window=window)
            sp = slice(lo // split_decode.SPLIT, -(-(lo + n) // split_decode.SPLIT))
            acc[..., sp, :].copy_(acc_r[..., sp, :])
            ml[..., sp, :].copy_(ml_r[..., sp, :])
        lo += n
    o = torch.empty_like(q)
    split_decode.launch_combine(acc, ml, clen, o, q_per_kv, n_pos=W)
    # the combine's exchange: every shard's float32 (m, l, acc), an all-gather
    n = len(k_shards.parts)
    tracing.collective("all-gather", (n - 1) * B * H * (hd + 2) * 4, ("model",),
                       k_shards.parts, o)
    return o


def make_seqpar_decode_attention(mesh: Mesh, *, seq_axis: str = "model"):
    """Returns ``decode_attn(q, k_cache, v_cache, cache_len, *, q_per_kv,
    window)`` with the cache cut by sequence over ``seq_axis``: a cache
    given whole is cut over the axis's devices (a copy), one already in
    ``Shards`` over dim 1 is used as it is. Rows are not cut (the port's
    "data" rows are views of one storage): the launches cover every row."""
    devices = mesh.axis_devices(seq_axis)

    def decode_attn(q, k_cache, v_cache, cache_len, *, q_per_kv: int,
                    window: Optional[int] = None):
        if not isinstance(k_cache, Shards):
            k_cache, v_cache = split(k_cache, 1, devices), split(v_cache, 1, devices)
        return seqpar_decode_attention(q, k_cache, v_cache, cache_len,
                                       q_per_kv=q_per_kv, window=window)

    return decode_attn
