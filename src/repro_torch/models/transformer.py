"""Block assembly, the layer stack and the train/prefill/decode/extend entry
points of the port (linear full attention: ``ATTN`` blocks).

Counterpart of ``repro.models.transformer``. Parameters are an
``nn.Module`` tree whose state-dict names follow the JAX tree
(``embed.table``, ``blocks.<l>.attn.wq``, ``final_norm.scale``; the JAX
``scan/sub0`` stack becomes one module per layer and a Python loop over
layers stands in for ``lax.scan``). Caches keep the JAX pytree and layouts,
``{"scan": {"sub<i>": {"k", "v": [L, B, cap, K, hd]}}}``, and are updated
in place: every entry point returns the cache object it was given.

Attention runs through the kernel wrappers of ``repro_torch.kernels`` on
every path (the CUDA kernel for tensors on the card, its plain version on
the CPU): prefill and train through ``flash_attention``, dense and paged
extend through ``flash_attention`` with ``q_start``, decode through
``decode_attention`` / ``paged_decode_attention``, and the speculative
verify step through their multi-query forms ``spec_decode_attention`` /
``paged_spec_decode_attention``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs import base as cfgbase
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.paged_spec_decode_attention import \
    paged_spec_decode_attention
from repro_torch.kernels.spec_decode_attention import spec_decode_attention
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       init_, unembed)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def check_supported(cfg):
    """Raise for what this slice of the port does not carry yet; each
    message names the ROADMAP.md item that ports it."""
    bad = sorted(set(k for k in cfg.layer_kinds if k != cfgbase.ATTN))
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {bad} are not ported yet (ROADMAP.md "
            "queue 1: item 8 for MoE, item 9 for recurrent / xLSTM / local "
            "attention)")
    if cfg.sliding_window is not None or cfg.local_window is not None:
        raise NotImplementedError(
            f"{cfg.name}: sliding/local-window attention is not ported yet "
            "(ROADMAP.md queue 1, item 8)")
    if cfg.modality == "audio_frames" or cfg.pos_emb == "sinusoidal":
        # vlm_tokens are plain token ids in the JAX model too; only the
        # frame-embedding stub (musicgen, the one sinusoidal arch) has
        # another input path
        raise NotImplementedError(
            f"{cfg.name}: modality {cfg.modality!r} is not ported yet "
            "(ROADMAP.md queue 1, item 9: modality stubs)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _p(*shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class Norm(nn.Module):
    def __init__(self, cfg, dim, *, device, dtype):
        super().__init__()
        self.scale = _p(dim, device=device, dtype=dtype)
        if cfg.norm_type == "layernorm":
            self.bias = _p(dim, device=device, dtype=dtype)


class Attention(nn.Module):
    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.norm = Norm(cfg, D, **kw)
        self.wq = _p(D, H, hd, **kw)
        self.wk = _p(D, K, hd, **kw)
        self.wv = _p(D, K, hd, **kw)
        self.wo = _p(H, hd, D, **kw)
        if cfg.attn_bias:
            self.bq = _p(H, hd, **kw)
            self.bk = _p(K, hd, **kw)
            self.bv = _p(K, hd, **kw)


class MLP(nn.Module):
    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D, F = cfg.d_model, cfg.d_ff
        kw = dict(device=device, dtype=dtype)
        self.wi = _p(D, F, **kw)
        self.wo = _p(F, D, **kw)
        if cfg.gated_mlp:
            self.wg = _p(D, F, **kw)
        if cfg.mlp_bias:
            self.bi = _p(F, **kw)
            self.bo = _p(D, **kw)


class Block(nn.Module):
    """One ATTN block: pre-norm attention + pre-norm MLP."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn = Attention(cfg, **kw)
        self.norm2 = Norm(cfg, cfg.d_model, **kw)
        self.mlp = MLP(cfg, **kw)


class Table(nn.Module):
    def __init__(self, *shape, device, dtype):
        super().__init__()
        self.table = _p(*shape, device=device, dtype=dtype)


class TransformerParams(nn.Module):
    """The model's parameters (uninitialised until ``init_`` or a load)."""

    # JAX init rule per leaf name (layers.py ParamDefs)
    _ZEROS = ("bias", "bq", "bk", "bv", "bi", "bo")

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        check_supported(cfg)
        kw = dict(device=device, dtype=dtype)
        self.embed = Table(cfg.padded_vocab, cfg.d_model, **kw)
        if not cfg.tie_embeddings:
            self.unembed = Table(cfg.d_model, cfg.padded_vocab, **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg, cfg.d_model, **kw)
        self.stack = cfg.num_scan_groups

    def init_(self, gen: torch.Generator):
        """Fill every parameter by the JAX package's init rules
        (``layers._init_one``) from ``gen``: norm scales ones, biases zeros,
        the embedding normal(0.02), every other matrix fan-in scaled normal
        (block matrices count the scanned layer axis into their fan-in, as
        the JAX ``stack_defs`` tree does)."""
        for name, t in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                init_(t, "ones", gen)
            elif leaf in self._ZEROS:
                init_(t, "zeros", gen)
            elif name == "embed.table":
                init_(t, "normal", gen)
            else:
                init_(t, "scaled", gen,
                      stack=self.stack if name.startswith("blocks.") else 1)
        return self


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def cache_spec(cfg, batch: int, capacity: int) -> Dict[str, Any]:
    """The cache pytree as (shape, dtype) leaves: scanned attention layers
    stack to [num_scan_groups, batch, capacity, K, hd]."""
    row = (batch, capacity, cfg.num_kv_heads, cfg.head_dim)
    dt = DTYPES[cfg.dtype]
    stacked = ((cfg.num_scan_groups,) + row, dt)
    c: Dict[str, Any] = {"scan": {f"sub{i}": {"k": stacked, "v": stacked}
                                  for i in range(len(cfg.pattern))}}
    for j, _ in enumerate(cfg.tail_kinds):
        c[f"tail{j}"] = {"k": (row, dt), "v": (row, dt)}
    return c


def init_cache(cfg, batch: int, capacity: int, device) -> Dict[str, Any]:
    def mk(spec):
        if isinstance(spec, dict):
            return {k: mk(v) for k, v in spec.items()}
        return torch.zeros(spec[0], dtype=spec[1], device=device)
    return mk(cache_spec(cfg, batch, capacity))


def layer_cache(cache, cfg, layer: int):
    """Per-layer views {"k", "v"} into the (stacked) cache pytree."""
    P = len(cfg.pattern)
    g, i = divmod(layer, P)
    if g < cfg.num_scan_groups:
        c = cache["scan"][f"sub{i}"]
        return {"k": c["k"][g], "v": c["v"][g]}
    return cache[f"tail{layer - cfg.num_scan_groups * P}"]


# ---------------------------------------------------------------------------
# Blocks and the stack
# ---------------------------------------------------------------------------


def _attn_mixer(p, x, cfg, *, positions, mode, cache, cache_len,
                block_tables=None, lens=None):
    """Attention temporal mixer (the ATTN part of the JAX ``_attn_mixer``).
    ``mode == "extend"`` continues a partially filled cache: a chunk at
    positions [cache_len, cache_len+S) attends to the cached prefix plus
    itself; ``cache_len`` is then a Python int. ``mode == "verify"`` scores
    S draft tokens per row at per-row positions [cache_len[b],
    cache_len[b]+S), the first ``lens[b]`` of them valid: the linear cache
    is written ahead (padded-tail writes dropped, or sent to trash page 0
    when paged) and needs no rollback, since later reads mask by position.
    Only linear full-attention caches reach it (``check_supported``); the
    JAX package's ring-cache branch is not ported."""
    G = cfg.q_per_kv
    q, k, v = attn.qkv_proj(p, x, cfg, positions)
    if mode == "decode" and block_tables is not None:
        ps = cache["k"].shape[1]
        kc, vc = attn.paged_cache_update(cache["k"], cache["v"], k, v,
                                         block_tables, cache_len, ps)
        o = paged_decode_attention(q, kc, vc, block_tables, cache_len,
                                   q_per_kv=G)
    elif mode == "decode":
        kc, vc = attn.cache_update(cache["k"], cache["v"], k, v, cache_len)
        o = decode_attention(q, kc, vc, cache_len, q_per_kv=G)
    elif mode == "verify":
        S = k.shape[1]
        clens = torch.as_tensor(cache_len, device=x.device).reshape(-1)
        clens = clens.to(torch.int32)
        n = torch.as_tensor(S if lens is None else lens, device=x.device)
        valid = (torch.arange(S, device=x.device)[None, :]
                 < n.reshape(-1, 1)).expand(k.shape[0], S)
        if block_tables is not None:
            ps = cache["k"].shape[1]
            kc, vc = attn.paged_spec_cache_update(cache["k"], cache["v"], k, v,
                                                  block_tables, clens, valid, ps)
            o = paged_spec_decode_attention(q, kc, vc, block_tables, clens,
                                            q_per_kv=G)
        else:
            kc, vc = attn.spec_cache_update(cache["k"], cache["v"], k, v, clens,
                                            valid)
            o = spec_decode_attention(q, kc, vc, clens, q_per_kv=G)
    elif mode == "extend":
        S = k.shape[1]
        start = int(cache_len)
        if block_tables is not None:
            if k.shape[0] != 1:
                raise NotImplementedError(
                    "paged extend writes one sequence per call (the engine "
                    f"prefills slot by slot); got batch {k.shape[0]}")
            ps = cache["k"].shape[1]
            attn.paged_chunk_write(cache["k"], k, block_tables[0], start, ps)
            attn.paged_chunk_write(cache["v"], v, block_tables[0], start, ps)
            # only the pages holding positions a query of this chunk can
            # see; later positions are causally masked anyway
            n = -(-(start + S) // ps)
            kv = attn.paged_view(cache["k"], block_tables[:, :n])
            vv = attn.paged_view(cache["v"], block_tables[:, :n])
        else:
            kv = attn.chunk_write(cache["k"], k, start)
            vv = attn.chunk_write(cache["v"], v, start)
        o = flash_attention(q, kv, vv, q_per_kv=G, q_start=start)
    else:                                   # train / prefill
        o = flash_attention(q, k, v, q_per_kv=G)
        if mode == "prefill":
            # right-padding is harmless: padded rows land at positions >=
            # the prompt length, which decode masks by cache_len
            attn.chunk_write(cache["k"], k, 0)
            attn.chunk_write(cache["v"], v, 0)
    return attn.out_proj(p, o)


def apply_block(kind, p, x, cfg, *, positions, mode, cache, cache_len,
                block_tables=None, lens=None):
    """One residual ATTN block (the only kind this slice carries; see
    ``check_supported``). Returns x'; the cache is updated in place."""
    h = apply_norm(p.attn.norm, x, cfg)
    x = x + _attn_mixer(p.attn, h, cfg, positions=positions, mode=mode,
                        cache=cache, cache_len=cache_len,
                        block_tables=block_tables, lens=lens)
    h2 = apply_norm(p.norm2, x, cfg)
    return x + apply_mlp(p.mlp, h2, cfg)


def apply_stack(params, x, cfg, *, positions, mode, cache=None,
                cache_len=None, block_tables=None, lens=None):
    """Run all layers (a Python loop over layers stands in for the JAX
    scan). Returns (x, cache)."""
    for layer, (kind, blk) in enumerate(zip(cfg.layer_kinds, params.blocks)):
        lc = layer_cache(cache, cfg, layer) if cache is not None else None
        x = apply_block(kind, blk, x, cfg, positions=positions, mode=mode,
                        cache=lc, cache_len=cache_len,
                        block_tables=block_tables, lens=lens)
    return x, cache


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


@torch.no_grad()
def forward_logits(params, batch, cfg, *, mode="train", cache=None,
                   cache_len=None, prefill_len=None, block_tables=None,
                   with_logits=True, lens=None):
    """``with_logits``: False skips final-norm + unembed (None logits);
    "last" unembeds only position ``prefill_len - 1`` (or the final one),
    [B, 1, V]; "all" / True unembeds every position. Returns
    (logits, cache, aux) with aux = 0 (no MoE in this slice)."""
    x = embed_tokens(params, batch["tokens"], cfg)
    x, new_cache = apply_stack(params, x, cfg, positions=batch["positions"],
                               mode=mode, cache=cache, cache_len=cache_len,
                               block_tables=block_tables, lens=lens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not with_logits:
        return None, new_cache, aux
    x = apply_norm(params.final_norm, x, cfg)
    if with_logits == "last":
        last = prefill_len - 1 if prefill_len is not None else x.shape[1] - 1
        x = x[:, last:last + 1]
    return unembed(params, x, cfg), new_cache, aux


def prefill(params, batch, cfg, cache, *, length=None, with_logits=True):
    """Fill the cache from a (right-padded) prompt at positions [0, S).
    ``length`` is the valid prompt length (for ``with_logits="last"``).
    Returns (logits, cache)."""
    logits, new_cache, _ = forward_logits(params, batch, cfg, mode="prefill",
                                          cache=cache, cache_len=0,
                                          prefill_len=length,
                                          with_logits=with_logits)
    return logits, new_cache


def decode_step(params, batch, cfg, cache, cache_len, *, block_tables=None):
    """One decode step. batch tokens [B,1]; cache_len [B] (or scalar).
    ``block_tables`` [B, n] switches the caches to the paged layout."""
    logits, new_cache, _ = forward_logits(params, batch, cfg, mode="decode",
                                          cache=cache, cache_len=cache_len,
                                          block_tables=block_tables)
    return logits, new_cache


def extend(params, batch, cfg, cache, cache_len, *, length=None,
           block_tables=None, with_logits=True):
    """Prefill continuation: a chunk of S tokens at positions
    [cache_len, cache_len+S) against a partially filled cache (chunked
    prefill, paged suffix prefill). ``length`` marks the valid chunk
    prefix for ``with_logits="last"``."""
    logits, new_cache, _ = forward_logits(params, batch, cfg, mode="extend",
                                          cache=cache, cache_len=cache_len,
                                          prefill_len=length,
                                          block_tables=block_tables,
                                          with_logits=with_logits)
    return logits, new_cache


def verify(params, batch, cfg, cache, cache_lens, *, lens=None,
           block_tables=None):
    """Speculative-decode verify: score S draft tokens per row in ONE
    forward. batch tokens [B, S] are ``[last, d_1 .. d_k, pad...]`` per row
    at per-row positions ``[cache_lens[b], cache_lens[b]+S)``; ``lens`` [B]
    counts the valid inputs (k+1). Returns (logits [B,S,V], staged):
    ``logits[:, i]`` is the target distribution for the token following
    input i. For the linear full-attention caches of this slice ``staged``
    IS the new cache (written ahead in place)."""
    logits, new_cache, _ = forward_logits(params, batch, cfg, mode="verify",
                                          cache=cache, cache_len=cache_lens,
                                          block_tables=block_tables,
                                          with_logits="all", lens=lens)
    return logits, new_cache


def verify_commit(cfg, staged, cache_lens, ns, lens):
    """Resolve a ``verify`` call's staged record to the committed cache.
    Linear full-attention K/V was written ahead and is masked by position,
    so the commit is the staged cache itself. The JAX package's other
    commits (ring splices for windowed attention, state rewinds for
    recurrent / xLSTM blocks) are not ported; ``check_supported`` refuses
    those archs, naming ROADMAP.md queue 1 items 8 and 9."""
    del cfg, cache_lens, ns, lens
    return staged
