"""Token sampling for the port: greedy / temperature / top-k, plain torch.

Counterpart of ``repro.serving.sampler.sample_batched``. JAX draws row b's
token t with ``categorical(fold_in(key_b, t), ...)``; ``torch.Generator``
is one stream per device and cannot give a batched step per-row streams, so
the port draws its noise from a counter-based hash instead: uniform bits
are a function of (request key, token index, vocab id) alone, turned into
Gumbel noise for the Gumbel-max trick. A request's draws therefore never
depend on batch composition or ``num_slots``, as in the JAX package, but
the bits differ from JAX's threefry stream (tests compare distributions).

``accept_batched`` is the speculative-decode verify step (the JAX
function of the same name): greedy rows accept a draft iff it is the
argmax, exactly as the JAX package; stochastic rows draw their accept
uniforms and their correction token from the same counter hash under two
salts, keyed by (request key, token index of the column), so they too are
independent of the batch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import spec_scan

NEG = -1e30
M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
SALT_ACCEPT = 0x5A17AC01        # accept uniforms of the verify step
SALT_CORRECT = 0x5A17C0FF       # correction / bonus token of the verify step


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


def uniform(keys, V: int):
    """Uniforms [B, V] in (0, 1) (24 bits) for per-row ``keys`` [B, 2]
    int64 holding (request key, token index): element (b, v) depends only
    on keys[b] and v."""
    k = keys[:, :1].long() & M32
    t = keys[:, 1:].long() & M32
    row = _mix32(k ^ _mix32((t + _GOLDEN) & M32))                   # [B, 1]
    v = torch.arange(V, device=keys.device, dtype=torch.int64)[None, :]
    h = _mix32(row ^ _mix32((v * 0x6C8E9CF5 + 1) & M32))
    h = _mix32((h + row) & M32)
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def gumbel(keys, V: int):
    """Gumbel noise [B, V] from ``uniform(keys, V)``."""
    return -torch.log(-torch.log(uniform(keys, V)))


def salted(keys, salt: int):
    """``keys`` [..., 2] with the request key mixed with ``salt``: another
    stream of the same (request, token index) pairs."""
    k = _mix32((keys[..., :1].long() & M32) ^ salt)
    return torch.cat([k, keys[..., 1:].long()], dim=-1)


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


def accept_batched(logits, inputs, draft_lens, keys, *, temperature,
                   top_k=None, vocab_limit: int = 0):
    """Batched draft acceptance for drafter-free speculative decoding.

    logits [B, S, V]:  verify-forward logits; ``logits[:, i]`` is the target
                       distribution for the token FOLLOWING input i.
    inputs [B, S]:     the verify inputs ``[last, d_1 .. d_k, pad...]`` per
                       row, so ``inputs[:, i+1]`` is the draft token that
                       ``logits[:, i]`` is judged against.
    draft_lens [B]:    k per row (0 <= k <= S-1).
    keys [B, 2]:       int64 (request key, token index of column 0) per row,
                       or None when ``temperature`` is None; column i's token
                       index is ``keys[b, 1] + i``.
    temperature/top_k/vocab_limit: as in ``sample_batched``.

    Greedy rows accept a draft iff it matches the argmax (bit-identical to
    non-speculative greedy decode). Stochastic rows use rejection sampling
    against the deterministic drafter: accept d with prob p(d) (uniform of
    column i: ``uniform(salted(key, SALT_ACCEPT), token index i)``); on
    reject, draw from p with d removed (Gumbel-max under SALT_CORRECT at
    the token index of the column); each emitted token is marginally
    distributed as non-speculative sampling. The accepted-prefix length
    goes through ``spec_scan.accept_len`` (the CUDA kernel on the card).

    Returns (out_tokens [B, S] int32, out_lens [B] int32):
    ``out_tokens[b, :m]`` are the accepted drafts, ``out_tokens[b, m]`` the
    correction or bonus token, ``out_lens = m + 1``.
    """
    B, S, V = logits.shape
    dev = logits.device
    logits = logits.float()
    if vocab_limit:
        vmask = torch.arange(V, device=dev) >= vocab_limit
        logits = logits.masked_fill(vmask[None, None, :], NEG)
    col = torch.arange(S, device=dev, dtype=torch.int32)[None, :]
    draft_lens = torch.as_tensor(draft_lens, device=dev).reshape(B).to(torch.int32)
    inputs = inputs.long()
    # draft token judged at column i (junk at the last column, never read)
    d_next = torch.cat([inputs[:, 1:], inputs[:, :1]], dim=1)
    greedy_tok = torch.argmax(logits, dim=-1)
    if temperature is None:
        accept = greedy_tok == d_next
    else:
        temperature = torch.as_tensor(temperature, device=dev,
                                      dtype=torch.float32).reshape(B)
        t_div = torch.clamp(temperature, min=1e-6)
        scaled = logits / t_div[:, None, None]
        if top_k is not None:
            k = torch.as_tensor(top_k, device=dev).reshape(B)
            scaled = _top_k_filter(scaled.reshape(B * S, V),
                                   k.repeat_interleave(S)).reshape(B, S, V)
        probs = torch.softmax(scaled, dim=-1)
        p_draft = torch.gather(probs, -1, d_next[..., None])[..., 0]
        col_keys = torch.stack([keys[:, :1].long().expand(B, S),
                                keys[:, 1:].long() + col], dim=-1)
        u = uniform(salted(col_keys, SALT_ACCEPT).reshape(B * S, 2), 1)
        accept = torch.where(temperature[:, None] > 0.0,
                             u.reshape(B, S) < p_draft, greedy_tok == d_next)

    m = spec_scan.accept_len(accept, draft_lens).long()

    # correction / bonus token from the target distribution at column m
    l_m = torch.gather(logits, 1, m[:, None, None].expand(B, 1, V))[:, 0]
    greedy_m = torch.argmax(l_m, dim=-1)
    if temperature is None:
        t_star = greedy_m
    else:
        scaled_m = l_m / t_div[:, None]
        if top_k is not None:
            scaled_m = _top_k_filter(scaled_m, k)
        # residual for a point-mass drafter: p with the rejected token
        # removed (only when a draft was actually rejected)
        rejected_d = torch.gather(d_next, 1, m[:, None])[:, 0]
        drop = ((m < draft_lens)[:, None]
                & (torch.arange(V, device=dev)[None, :] == rejected_d[:, None]))
        scaled_m = scaled_m.masked_fill(drop, NEG)
        m_keys = torch.stack([keys[:, 0].long(), keys[:, 1].long() + m], dim=-1)
        stoch = torch.argmax(scaled_m + gumbel(salted(m_keys, SALT_CORRECT), V),
                             dim=-1)
        t_star = torch.where(temperature > 0.0, stoch, greedy_m)

    out = torch.where(col < m[:, None], d_next, torch.zeros_like(d_next))
    out = torch.where(col == m[:, None], t_star[:, None], out)
    return out.to(torch.int32), (m + 1).to(torch.int32)
