"""Griffin / RecurrentGemma recurrent block of the port: conv1d + RG-LRU.

Counterpart of ``repro.models.rglru``. RG-LRU recurrence (diagonal, real):

    r_t = sigmoid(w_r * x_t + b_r)           (recurrence gate)
    i_t = sigmoid(w_i * x_t + b_i)           (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The scan over time runs in the ``rglru_scan`` kernel wrapper (full, extend
and verify modes; the plain sequential version on the CPU); one decode step
is elementwise PyTorch. Caches are ``{"h": [B, R] float32, "conv": [B, W-1,
R]}`` and are written in place (``# mutation``); ``keep`` [B] bool, when
given, leaves the rows it marks False untouched (done rows of a decode
chunk).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (Shards, by_rows, gather, per_part,
                                              psum, tree_parts)
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models.layers import assign

C_RGLRU = 8.0


def causal_conv1d(x, w, b, state=None, length=None):
    """Depthwise causal conv. x [B,S,R], w [W,R]; state [B,W-1,R] or None.

    ``length`` (int, optional): number of valid leading positions when ``x``
    is right-padded (bucketed prefill); the returned state then holds the
    inputs at positions [length-W+1, length) rather than the padded tail.
    Returns (y [B,S,R], new_state [B,W-1,R]).
    """
    W, S = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros(x.shape[0], W - 1, x.shape[2], dtype=x.dtype,
                            device=x.device)
    xs = torch.cat([state.to(x.dtype), x], dim=1)            # [B, S+W-1, R]
    y = sum(xs[:, i:i + S] * w[i] for i in range(W)) + b
    if W <= 1:
        new_state = state
    elif length is None:
        new_state = xs[:, -(W - 1):]
    else:
        # xs index j holds the input at position j - (W-1)
        new_state = xs[:, length:length + W - 1]
    return y.to(x.dtype), new_state


def _gates(p, x):
    """a_t [.., R] (float32) and the gated input beta * i * x (float32)."""
    xf = x.float()
    r = torch.sigmoid(xf * p.w_rgate.float() + p.b_rgate.float())
    i = torch.sigmoid(xf * p.w_igate.float() + p.b_igate.float())
    a = torch.exp(-C_RGLRU * F.softplus(p.a_param.float()) * r)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * i * xf


def rglru_step(p, x, h):
    """Single decode step. x [B,1,R], h [B,R] float32 -> (y [B,1,R], h')."""
    a, bx = _gates(p, x[:, 0])
    h_new = a * h.float() + bx
    return h_new[:, None].to(x.dtype), h_new


def _masked_gates(p, c, mask):
    """Gates with padded positions turned into identity steps (a=1, bx=0)."""
    a, bx = _gates(p, c)
    if mask is not None:
        a = torch.where(mask[..., None], a, torch.ones_like(a))
        bx = torch.where(mask[..., None], bx, torch.zeros_like(bx))
    return a.contiguous(), bx.contiguous()


def apply_recurrent_mixer(p, x, cfg, *, cache=None, mode="full", length=None,
                          mask=None, keep=None):
    """Griffin temporal-mixing branch (pre-norm handled by the caller).

    x [B,S,D] -> (y [B,S,D], record). The cache is updated in place; in
    ``mode="verify"`` it is left as it is and ``record`` holds the state
    after every draft position (``hh``, the kernel's float32 output) and
    the raw conv input stream (``xs``), from which ``verify_commit``
    rewinds to each row's accepted length. ``record`` is None otherwise.

    On a mesh (``p.wx`` in ``Shards``) each "model" shard runs its RG-LRU
    channels (rnn-up cut by its output dim; the recurrence is elementwise
    per channel) over its part of the cache, and the gated output is
    gathered before ``wo`` (the reference's "rnn_act"); the record is then
    ``Shards`` too. Under a baseline table ``wo`` is cut by its rows too
    ("rnn_in") and the shards' partial products are added.
    """
    if not isinstance(p.wx, Shards):
        yg, record = _mixer_channels(p, x, cfg, cache=cache, mode=mode,
                                     length=length, mask=mask, keep=keep)
        return yg @ p.wo, record
    devs = p.devices()
    outs = per_part(lambda j: _mixer_channels(
        p.part(j), x.to(devs[j]), cfg, cache=tree_parts(cache, j), mode=mode,
        length=length, mask=None if mask is None else mask.to(devs[j]),
        keep=None if keep is None else keep.to(devs[j])), len(devs))
    record = None
    if outs[0][1] is not None:
        record = {k: Shards([r[k] for _, r in outs], -1) for k in outs[0][1]}
    if isinstance(p.wo, Shards):
        w = p.wo.parts
        return psum(per_part(lambda j: outs[j][0] @ w[j], len(w)), x.device), record
    yg = gather(Shards([y for y, _ in outs], -1), x.device)
    return yg @ p.wo, record


def _scan(a, bx, h0, out_dtype):
    """``rglru_scan``, launched per "data" shard over its rows on a mesh."""
    return by_rows(lambda a_, bx_, h_: rglru_scan(a_, bx_, h_, out_dtype=out_dtype),
                   a.shape[0], a, bx, h0)


def _mixer_channels(p, x, cfg, *, cache, mode, length, mask, keep):
    """The mixer up to ``wo``: (y * gate [B,S,R], record)."""
    u = x @ p.wx
    gate = F.gelu(x @ p.wy, approximate="tanh")
    record = None
    if mode == "decode":
        c, conv_state = causal_conv1d(u, p.conv_w, p.conv_b, cache["conv"])
        y, h = rglru_step(p, c, cache["h"])
    elif mode == "verify":
        prev_conv = cache["conv"]
        c, _ = causal_conv1d(u, p.conv_w, p.conv_b, prev_conv)
        a, bx = _masked_gates(p, c, mask)
        hh, _ = _scan(a, bx, cache["h"].contiguous(), torch.float32)
        y = hh.to(c.dtype)
        record = {"hh": hh, "xs": torch.cat([prev_conv.to(u.dtype), u], dim=1)}
    else:
        extend = mode == "extend"
        c, conv_state = causal_conv1d(u, p.conv_w, p.conv_b,
                                      cache["conv"] if extend else None,
                                      length=length)
        a, bx = _masked_gates(p, c, mask)
        y, h = _scan(a, bx, cache["h"].contiguous() if extend else None, c.dtype)
    if cache is not None and mode != "verify":
        assign(cache["h"], h, keep)                                    # mutation
        assign(cache["conv"], conv_state, keep)                        # mutation
    return y * gate, record


def gather_conv(xs, ns, valid, width: int):
    """The conv window after ``ns[b]`` accepted inputs, per row: stream
    positions [n-W+1, n) = ``xs[b, n:n+W-1]`` (rows not ``valid`` keep the
    pre-verify window, n = 0)."""
    S = xs.shape[1] - width
    n_eff = torch.where(valid, torch.clamp(ns.long(), 0, S), torch.zeros_like(ns.long()))
    idx = n_eff[:, None] + torch.arange(width, device=xs.device)[None, :]
    return xs[torch.arange(xs.shape[0], device=xs.device)[:, None], idx]


def gather_states(stack, old, ns, valid):
    """Pick the state after input ``ns[b]`` of each row from a per-position
    stack [B, S, ...]; rows not ``valid`` keep ``old``."""
    B, S = stack.shape[:2]
    idx = torch.clamp(ns.long() - 1, 0, S - 1)
    sel = stack[torch.arange(B, device=stack.device), idx]
    v = valid.reshape((-1,) + (1,) * (old.dim() - 1))
    return torch.where(v, sel.to(old.dtype), old)


def verify_commit(record, cache, ns, valid):
    """Rewind one RG-LRU layer to each row's accepted length ``ns`` [B]
    (rows not ``valid`` keep their pre-verify state bit for bit): the state
    is gathered from the verify record, no replay forward."""
    h = gather_states(record["hh"], cache["h"], ns, valid)
    conv = gather_conv(record["xs"], ns, valid, cache["conv"].shape[1])
    cache["h"].copy_(h)                                                # mutation
    cache["conv"].copy_(conv)                                          # mutation
    return cache
