"""Basic layers of the PyTorch port: norms, MLP, rotary, embeddings.

Counterpart of ``repro.models.layers``. Parameters live on ``nn.Module``s
(``models/transformer.py``); the functions here take a module ``p`` whose
attributes are the JAX tree's leaf names (``p.scale``, ``p.wi`` ...) and
keep the JAX package's cast points: norms and rotary run in float32 and cast
back to the activation dtype, logits come out in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Initialisation (the rules of repro.models.layers._init_one)
# ---------------------------------------------------------------------------


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


def apply_mlp(p, x, cfg):
    h = x @ p.wi
    if cfg.mlp_bias:
        h = h + p.bi
    if cfg.gated_mlp:
        h = activation(h, cfg.act) * (x @ p.wg)
    else:
        h = activation(h, cfg.act)
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


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_tokens(params, tokens, cfg):
    x = params.embed.table[tokens]
    if cfg.name.startswith("gemma") or cfg.family == "hybrid":
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def matmul_f32(a, b):
    """``a @ b`` accumulated and returned in float32 — JAX's
    ``preferred_element_type=float32``. Half-precision inputs keep their
    dtype on the card and only the output is widened (no float32 copy of a
    vocab-sized table); float32 inputs are a plain matmul."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a.reshape(-1, a.shape[-1]), b,
                        out_dtype=torch.float32).reshape(
                            a.shape[:-1] + b.shape[-1:])
    return a.float() @ b.float()


def unembed(params, x, cfg):
    if cfg.tie_embeddings:
        logits = matmul_f32(x, params.embed.table.t())
    else:
        logits = matmul_f32(x, params.unembed.table)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
