"""xLSTM blocks of the port: mLSTM (matrix memory, chunkwise) and sLSTM.

Counterpart of ``repro.models.xlstm``. The mLSTM prefill and extend run
in the ``mlstm_chunk`` kernel wrapper with the (C, n, m) state carried in
and out (the JAX package ran its Pallas kernel without state and repeated
the XLA chunkwise pass for the state; one call does both here); one decode
step and the verify step's stepwise recurrence are plain PyTorch. The sLSTM
recurrence, sequential by nature, runs in the ``slstm_scan`` kernel
wrapper: one launch walks every time step on the card (the JAX package's
``lax.scan``), its gradient another. Caches are ``{"state": (C, n, m),
"conv"}`` (mLSTM) and ``{"state": (c, n, h, m)}`` (sLSTM), float32
states, written in place (``# mutation``); ``keep`` [B] bool freezes the
rows it marks False.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import slstm_scan as kslstm
from repro_torch.kernels.mlstm_chunk import NEG_INF, mlstm_chunk
from repro_torch.models.layers import assign
from repro_torch.models.rglru import causal_conv1d, gather_conv, gather_states


def mlstm_step(q, k, v, ig, fg, state):
    """Single decode step. q,k,v [B,1,H,hd]; ig,fg [B,1,H]."""
    C, n, m = state
    q1, k1, v1 = (x[:, 0].float() for x in (q, k, v))
    scale = q.shape[-1] ** -0.5
    logf = F.logsigmoid(fg[:, 0].float())
    i1 = ig[:, 0].float()
    m_new = torch.maximum(logf + m, i1)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(i1 - m_new)
    C_new = (C * fp[..., None, None]
             + ip[..., None, None] * (k1[..., :, None] * v1[..., None, :]))
    n_new = n * fp[..., None] + ip[..., None] * k1
    qs = q1 * scale
    h_num = torch.einsum("bhd,bhde->bhe", qs, C_new)
    denom = torch.maximum((qs * n_new).sum(-1).abs(), torch.exp(-m_new))
    h = (h_num / denom[..., None])[:, None]
    return h.to(q.dtype), (C_new, n_new, m_new)


def _heads(x, H):
    B, S, F2 = x.shape
    return x.reshape(B, S, H, F2 // H)


def _group_norm_heads(x, scale, eps=1e-6):
    """Per-head RMS norm with a flat [F2] learned scale."""
    B, S, H, hd = x.shape
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    y = (xf * torch.rsqrt(ms + eps)).reshape(B, S, H * hd)
    return (y * scale.float()).to(x.dtype)


def _assign_state(dst, new, keep):
    for d, n in zip(dst, new):
        assign(d, n, keep)                                             # mutation


def apply_mlstm(p, x, cfg, *, cache=None, mode="full", length=None, mask=None,
                keep=None):
    """x [B,S,D] -> (y, record); the cache is updated in place.

    ``length``/``mask`` mark the valid prefix of a right-padded (bucketed)
    prompt: padded positions get i-gate -1e30 / f-gate +30, so they neither
    write to nor decay the (C, n, m) state. ``mode="verify"`` leaves the
    cache as it is and returns a record of the state after every position
    (stepwise recurrence) plus the conv input stream; ``mlstm_verify_commit``
    rewinds to each row's accepted length with a gather.
    """
    H = cfg.num_heads
    u = x @ p.w_up
    z = x @ p.w_gate
    conv_state = cache["conv"] if mode in ("decode", "extend", "verify") else None
    c, new_conv = causal_conv1d(u, p.conv_w, p.conv_b, conv_state,
                                length=None if mode == "verify" else length)
    c = F.silu(c)
    q = _heads(c @ p.wq, H)
    k = _heads(c @ p.wk, H)
    v = _heads(u @ p.wv, H)
    ig = u @ p.w_ig + p.b_ig
    fg = u @ p.w_fg + p.b_fg
    if mask is not None and mode != "decode":
        ig = torch.where(mask[..., None], ig, torch.full_like(ig, NEG_INF))
        fg = torch.where(mask[..., None], fg, torch.full_like(fg, 30.0))
    record = None
    if mode == "verify":
        st = cache["state"]
        hs, states = [], []
        for t in range(q.shape[1]):
            h_t, st = mlstm_step(q[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                                 ig[:, t:t + 1], fg[:, t:t + 1], st)
            hs.append(h_t)
            states.append(st)
        h = torch.cat(hs, dim=1)
        record = {"states": tuple(torch.stack(s, dim=1) for s in zip(*states)),
                  "xs": torch.cat([cache["conv"].to(u.dtype), u], dim=1)}
    elif mode == "decode":
        h, state = mlstm_step(q, k, v, ig, fg, cache["state"])
    else:
        # prefill starts from the zero state, extend resumes the cached one
        h, state = mlstm_chunk(q, k, v, ig, fg,
                               cache["state"] if mode == "extend" else None,
                               chunk=cfg.mlstm_chunk)
    h = _group_norm_heads(h, p.out_norm)
    y = (h * F.silu(z)) @ p.w_down
    if cache is not None and mode != "verify":
        _assign_state(cache["state"], state, keep)
        assign(cache["conv"], new_conv, keep)                          # mutation
    return y, record


def slstm_scan(p, x, cfg, state=None, mask=None, all_states: bool = False):
    """Sequential sLSTM over [B,S,D]. state: (c,n,h,m) each [B,D] float32.

    ``mask`` [B,S] bool: padded timesteps carry the state through unchanged.
    Returns (y [B,S,D], state after the last step), or with ``all_states``
    (y, the state after every step, each [B,S,D]). The input projection is
    one einsum here; the recurrence over time is the ``slstm_scan`` kernel
    wrapper (one launch on the card, forward and gradient; the plain loop
    on the CPU).
    """
    del cfg                                 # the heads are r_gates' first dim
    gates_x = torch.einsum("bsd,dge->bsge", x, p.w_gates) + p.b_gates   # [B,S,4,D]
    return kslstm.slstm_scan(gates_x, p.r_gates, state, mask, all_states)


def apply_slstm(p, x, cfg, *, cache=None, mode="full", length=None, mask=None,
                keep=None):
    """x [B,S,D] -> (y, record); the cache is updated in place (verify:
    left as it is, ``record`` holds the per-position states)."""
    del length
    state = cache["state"] if mode in ("decode", "extend", "verify") else None
    h, new_state = slstm_scan(p, x, cfg, state,
                              mask=mask if mode != "decode" else None,
                              all_states=mode == "verify")
    hf = h.float()
    ms = hf.square().mean(-1, keepdim=True)
    h = ((hf * torch.rsqrt(ms + 1e-6)) * p.out_norm.float()).to(x.dtype)
    y = h @ p.wo
    if mode == "verify":
        return y, {"states": new_state}
    if cache is not None:
        _assign_state(cache["state"], new_state, keep)
    return y, None


def mlstm_verify_commit(record, cache, ns, valid):
    """Commit an mLSTM layer's verify record at each row's accepted length
    ``ns`` [B] (rows not ``valid`` keep their state): gathers, no replay."""
    for dst, stack in zip(cache["state"], record["states"]):
        dst.copy_(gather_states(stack, dst, ns, valid))               # mutation
    cache["conv"].copy_(gather_conv(record["xs"], ns, valid,
                                    cache["conv"].shape[1]))           # mutation
    return cache


def slstm_verify_commit(record, cache, ns, valid):
    for dst, stack in zip(cache["state"], record["states"]):
        dst.copy_(gather_states(stack, dst, ns, valid))               # mutation
    return cache
