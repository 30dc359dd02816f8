"""Basic layers of the PyTorch port: norms, MLP, rotary, embeddings.

Counterpart of ``repro.models.layers``. Parameters live on ``nn.Module``s
(``models/transformer.py``); the functions here take a module ``p`` whose
attributes are the JAX tree's leaf names (``p.scale``, ``p.wi`` ...) and
keep the JAX package's cast points: norms and rotary run in float32 and cast
back to the activation dtype, logits come out in float32.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import (Shards, fsdp_gathered, gather,
                                              per_part, psum)

# ---------------------------------------------------------------------------
# Parameters and their initialisation (the rules of
# repro.models.layers._init_one)
# ---------------------------------------------------------------------------


def param(*shape, device, dtype):
    """A leaf that serving never differentiates (``requires_grad=False``);
    a trainer turns it on (``Model.init(..., trainable=True)``)."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class Params(nn.Module):
    """A module of leaves named after the JAX tree. ``INIT`` maps a leaf to
    its JAX ``ParamDef`` init rule; leaves not named there are "scaled"."""

    INIT: Dict[str, str] = {}
    AXES: Dict[str, tuple] = {}     # leaf -> logical axes (distributed/sharding.py)


def init_(t: torch.Tensor, init: str, gen: torch.Generator, *,
          scale: float = 0.02, stack: int = 1):
    """Fill ``t`` in place by one of the JAX init rules.

    ``stack`` is the number of stacked copies the JAX def-tree gives this
    leaf (``stack_defs``: scanned block params carry a leading layer axis),
    because the JAX "scaled" rule counts that axis into its fan-in.
    """
    with torch.no_grad():
        if init == "zeros":
            t.zero_()
        elif init == "ones":
            t.fill_(1.0)
        else:
            x = torch.randn(t.shape, generator=gen, device=t.device,
                            dtype=torch.float32)
            if init == "scaled":
                shape = (stack,) + tuple(t.shape) if stack > 1 else tuple(t.shape)
                fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
                x /= math.sqrt(max(fan_in, 1))
            else:
                x *= scale
            t.copy_(x)
    return t


def assign(dst: torch.Tensor, new: torch.Tensor, keep=None):
    """``dst.copy_(new)`` in place; with ``keep`` [B] bool only the rows it
    marks True take ``new`` and the rest keep ``dst`` bit for bit (the JAX
    package's ``select_rows`` freeze of done rows, here one masked copy per
    state leaf and no host sync)."""
    if keep is not None:
        k = keep.reshape((-1,) + (1,) * (dst.dim() - 1))
        new = torch.where(k, new.to(dst.dtype), dst)
    dst.copy_(new)
    return dst


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def apply_norm(p, x, cfg, eps=None):
    eps = eps or cfg.norm_eps
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p.scale.float() + p.bias.float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p.scale.float()
    return y.to(x.dtype)


def rms_norm_headwise(x, eps=1e-6):
    """Per-head RMS norm (chameleon qk-norm), no learned scale."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def activation(x, kind: str):
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def _mlp_hidden(p, x, cfg):
    h = x @ p.wi
    if cfg.mlp_bias:
        h = h + p.bi
    if cfg.gated_mlp:
        return activation(h, cfg.act) * (x @ p.wg)
    return activation(h, cfg.act)


def apply_mlp(p, x, cfg):
    """On a mesh (``p.wi`` in ``Shards``) each "model" shard computes its
    columns of the hidden state (mlp-up is cut by its output dim, its
    contraction whole). Under the serve rules the hidden state is gathered
    before ``wo``, so the down-projection's sum is never split (the
    reference's "mlp_act"); under a baseline table ``wo`` is cut by its
    rows too ("mlp_in") and the shards' partial products are added."""
    if isinstance(p.wo, Shards):
        devs = p.devices()
        y = psum(per_part(lambda j: _mlp_hidden(p.part(j), x.to(devs[j]), cfg)
                          @ p.wo.parts[j], len(devs)), x.device)
        return y + p.bo if cfg.mlp_bias else y
    if isinstance(p.wi, Shards):
        h = gather(Shards([_mlp_hidden(p.part(j), x.to(d), cfg)
                           for j, d in enumerate(p.devices())], -1), x.device)
    else:
        h = _mlp_hidden(p, x, cfg)
    y = h @ p.wo
    if cfg.mlp_bias:
        y = y + p.bo
    return y


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------


def rotary_embed(x, positions, theta: float, rotary_pct: float = 1.0):
    """Apply RoPE to ``x[..., S, H, hd]`` given ``positions [B, S]``;
    ``rotary_pct < 1`` rotates only the leading fraction of the head dim."""
    hd = x.shape[-1]
    rot = int(hd * rotary_pct)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                  # [B, S, half]
    cos = torch.cos(ang)[..., None, :]                          # [B, S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x_rot[..., :half].float(), x_rot[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def sinusoidal_pos(positions, d_model: int, dtype):
    """Classic transformer sinusoidal positional encoding, [B, S, D]:
    computed in float32, ``[sin, cos]`` concatenated, then cast."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def _embed_rows(table: Shards, tokens):
    """Rows of a table cut over "model" by vocab rows: each shard looks up
    the ids it holds, and the rows are gathered onto the ids' device by
    selection (copies only)."""
    x = None
    lo = 0
    for part in table.parts:
        n = part.shape[0]
        ids = tokens.to(part.device) - lo
        rows = part[ids.clamp(0, n - 1)].to(tokens.device)
        mine = ((tokens >= lo) & (tokens < lo + n))[..., None]
        x = rows if x is None else torch.where(mine, rows, x)
        lo += n
    return x


def embed_tokens(params, tokens, cfg):
    table = fsdp_gathered(params.embed).table
    x = _embed_rows(table, tokens) if isinstance(table, Shards) else table[tokens]
    if cfg.name.startswith("gemma") or cfg.family == "hybrid":
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


class _MatmulF32(torch.autograd.Function):
    """``torch.mm(a, b, out_dtype=float32)`` with a gradient (the op has no
    derivative): the float32 output gradient is rounded to the inputs'
    dtype and the two products run in it, so no float32 copy of a
    vocab-sized table is made in the backward either."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ b.t(), a.t() @ g


def matmul_f32(a, b):
    """``a @ b`` accumulated and returned in float32 — JAX's
    ``preferred_element_type=float32``. Half-precision inputs keep their
    dtype on the card and only the output is widened (no float32 copy of a
    vocab-sized table); float32 inputs are a plain matmul."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda or a.is_meta:          # meta: the dry run traces the card's path
        a2 = a.reshape(-1, a.shape[-1])
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            out = _MatmulF32.apply(a2, b)
        else:
            out = torch.mm(a2, b, out_dtype=torch.float32)
        return out.reshape(a.shape[:-1] + b.shape[-1:])
    return a.float() @ b.float()


def unembed(params, x, cfg):
    """float32 logits; on a mesh each "model" shard computes its vocab
    columns (the contraction over d_model whole) and they are gathered."""
    w = fsdp_gathered(params.embed if cfg.tie_embeddings else params.unembed).table
    if isinstance(w, Shards):
        logits = gather(Shards([
            matmul_f32(x.to(part.device), part.t() if cfg.tie_embeddings else part)
            for part in w.parts], -1), x.device)
    elif cfg.tie_embeddings:
        logits = matmul_f32(x, w.t())
    else:
        logits = matmul_f32(x, w)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
