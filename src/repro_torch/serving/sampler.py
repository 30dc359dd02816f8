"""Token sampling for the port: greedy / temperature / top-k, plain torch.

Counterpart of ``repro.serving.sampler.sample_batched``. JAX draws row b's
token t with ``categorical(fold_in(key_b, t), ...)``; ``torch.Generator``
is one stream per device and cannot give a batched step per-row streams, so
the port draws its noise from a counter-based hash instead: uniform bits
are a function of (request key, token index, vocab id) alone, turned into
Gumbel noise for the Gumbel-max trick. A request's draws therefore never
depend on batch composition or ``num_slots``, as in the JAX package, but
the bits differ from JAX's threefry stream (tests compare distributions).
``accept_batched`` belongs to the speculative-decode slice.
"""
from __future__ import annotations

import torch

NEG = -1e30
M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mix32(x):
    """32-bit integer finalizer on int64 tensors holding values in
    [0, 2**32): multipliers below 2**31 keep every product inside int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & M32
    return x ^ (x >> 16)


def _mix32_int(x: int) -> int:
    return int(_mix32(torch.tensor(x & M32, dtype=torch.int64)))


def prng_key(seed: int) -> int:
    """A request's 32-bit key from a seed of any size (JAX: PRNGKey)."""
    seed = int(seed)
    hi = _mix32_int((seed >> 32) & M32)
    return _mix32_int(((seed & M32) ^ hi) + _GOLDEN)


def fold_in(key: int, data: int) -> int:
    """Derive a key from ``key`` and an integer (JAX: random.fold_in)."""
    return _mix32_int(key ^ _mix32_int(int(data) + _GOLDEN))


def gumbel(keys, V: int):
    """Gumbel noise [B, V] for per-row ``keys`` [B, 2] int64 holding
    (request key, token index): element (b, v) depends only on keys[b] and
    v. 24-bit uniforms in (0, 1)."""
    k = keys[:, :1].long() & M32
    t = keys[:, 1:].long() & M32
    row = _mix32(k ^ _mix32((t + _GOLDEN) & M32))                   # [B, 1]
    v = torch.arange(V, device=keys.device, dtype=torch.int64)[None, :]
    h = _mix32(row ^ _mix32((v * 0x6C8E9CF5 + 1) & M32))
    h = _mix32((h + row) & M32)
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def _top_k_filter(scaled, k):
    """Keep the top-k entries of the trailing axis per row, NEG the rest;
    ``k <= 0`` means no filter for that row and ``k >= V`` keeps every
    entry (the k-th largest is then the row minimum)."""
    V = scaled.shape[-1]
    srt = torch.sort(scaled, dim=-1).values                         # ascending
    idx = torch.clamp(V - k, 0, V - 1).long()
    kth = torch.gather(srt, -1, idx[:, None])
    keep = (k <= 0)[:, None] | (scaled >= kth)
    return torch.where(keep, scaled, torch.full_like(scaled, NEG))


def sample_batched(logits, key, *, temperature, top_k=None, vocab_limit: int = 0):
    """Per-row sampling. logits [B, V] -> int32 ids [B].

    key:         [B, 2] int64 per-row (request key, token index) pairs, or
                 None when ``temperature`` is None.
    temperature: [B] float (<= 0 means greedy for that row), or None for a
                 statically greedy batch (no noise, no sort).
    top_k:       [B] int or None (<= 0 means no filter for that row; k >=
                 vocab also means no filter).
    vocab_limit: ids >= vocab_limit are never produced.
    """
    B, V = logits.shape
    logits = logits.float()
    if vocab_limit:
        vmask = torch.arange(V, device=logits.device) >= vocab_limit
        logits = logits.masked_fill(vmask[None, :], NEG)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if temperature is None:
        return greedy
    temperature = torch.as_tensor(temperature, device=logits.device,
                                  dtype=torch.float32).reshape(B)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    if top_k is not None:
        scaled = _top_k_filter(scaled, torch.as_tensor(
            top_k, device=logits.device).reshape(B))
    stochastic = torch.argmax(scaled + gumbel(key, V), dim=-1).to(torch.int32)
    return torch.where(temperature > 0.0, stochastic, greedy)
