"""Block assembly, the layer stack and the train/prefill/decode/extend/
verify entry points of the port: full attention (ATTN, sliding-window on a
ring cache when ``cfg.sliding_window`` is set), attention + MoE (ATTN_MOE),
local attention on a ring cache (LOCAL_ATTN), RG-LRU (RECURRENT), mLSTM
and sLSTM blocks.

Counterpart of ``repro.models.transformer``. Parameters are an
``nn.Module`` tree whose state-dict names follow the JAX tree
(``embed.table``, ``blocks.<l>.attn.wq``, ``blocks.<l>.rec.a_param``,
``final_norm.scale``; the JAX ``scan/sub<i>`` stacks and ``tail<j>``
layers become one module per layer and a Python loop over layers stands in
for ``lax.scan``). Caches keep the JAX pytree and layouts, ``{"scan":
{"sub<i>": {leaf: [G, B, ...]}}, "tail<j>": {leaf: [B, ...]}}`` with the
mLSTM / sLSTM states as tuples, and are updated in place: every entry
point returns the cache object it was given.

The hot loops run through the kernel wrappers of ``repro_torch.kernels``
(the CUDA kernel for tensors on the card, its plain version on the CPU):
prefill, train and extend attention through ``flash_attention`` (with
``q_start`` and, for local attention, ``window``), decode through
``decode_attention`` / ``paged_decode_attention``, the verify step through
``spec_decode_attention`` / ``paged_spec_decode_attention``, the RG-LRU
scan through ``rglru_scan`` and the mLSTM prefill / extend through
``mlstm_chunk``. The MoE FFN (``models/moe.py``) is one-hot dispatch and
combine around batched expert matmuls, as in the JAX package.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs import base as cfgbase
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (Shards, by_rows, first_shards,
                                              gather, psum, rows_here,
                                              tree_parts)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.paged_spec_decode_attention import \
    paged_spec_decode_attention
from repro_torch.kernels.spec_decode_attention import spec_decode_attention
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (Params, apply_mlp, apply_norm,
                                       embed_tokens, init_, sinusoidal_pos,
                                       unembed)
from repro_torch.models.layers import param as _p

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
ATTN_KINDS = (cfgbase.ATTN, cfgbase.ATTN_MOE, cfgbase.LOCAL_ATTN)


def attn_window(kind, cfg):
    """The attention window of a block (the JAX ``_attn_mixer``'s rule):
    ``local_window`` for LOCAL_ATTN, ``sliding_window`` (None: full
    attention) for ATTN and ATTN_MOE."""
    return cfg.local_window if kind == cfgbase.LOCAL_ATTN else cfg.sliding_window


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class Norm(Params):
    INIT = {"scale": "ones", "bias": "zeros"}
    AXES = {"scale": ("norm",), "bias": ("norm",)}

    def __init__(self, cfg, dim, *, device, dtype):
        super().__init__()
        self.scale = _p(dim, device=device, dtype=dtype)
        if cfg.norm_type == "layernorm":
            self.bias = _p(dim, device=device, dtype=dtype)


class Attention(Params):
    INIT = {"bq": "zeros", "bk": "zeros", "bv": "zeros"}
    # wo's head dim is the contraction side of the output projection: its
    # own axis, so serve replicates it while train shards it
    AXES = {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads_in", "head_dim", "embed"),
            "bq": ("heads", "head_dim"), "bk": ("kv_heads", "head_dim"),
            "bv": ("kv_heads", "head_dim")}

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


class MLP(Params):
    INIT = {"bi": "zeros", "bo": "zeros"}
    AXES = {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
            "wo": ("mlp_in", "embed"), "bi": ("mlp",), "bo": ("embed",)}

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


class Recurrent(Params):
    """RG-LRU mixer leaves (``rglru.rglru_defs``)."""
    INIT = {"conv_b": "zeros", "b_rgate": "zeros", "b_igate": "zeros",
            "w_rgate": "normal", "w_igate": "normal", "a_param": "normal"}
    AXES = {"wx": ("embed", "rnn"), "wy": ("embed", "rnn"),
            "conv_w": ("conv", "rnn"), "wo": ("rnn_in", "embed"),
            **dict.fromkeys(("conv_b", "w_rgate", "b_rgate", "w_igate",
                             "b_igate", "a_param"), ("rnn",))}

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D, R, W = cfg.d_model, cfg.rglru_dim or cfg.d_model, cfg.conv1d_width
        kw = dict(device=device, dtype=dtype)
        self.norm = Norm(cfg, D, **kw)
        self.wx = _p(D, R, **kw)
        self.wy = _p(D, R, **kw)
        self.conv_w = _p(W, R, **kw)
        for name in ("conv_b", "w_rgate", "b_rgate", "w_igate", "b_igate", "a_param"):
            setattr(self, name, _p(R, **kw))
        self.wo = _p(R, D, **kw)


class MLSTM(Params):
    """mLSTM mixer leaves (``xlstm.mlstm_defs``)."""
    INIT = {"conv_b": "zeros", "b_ig": "zeros", "b_fg": "ones", "out_norm": "ones"}
    AXES = {"w_up": ("embed", "inner"), "w_gate": ("embed", "inner"),
            "conv_w": ("conv", "inner"), "conv_b": ("inner",),
            "wq": ("inner", "inner_out"), "wk": ("inner", "inner_out"),
            "wv": ("inner", "inner_out"), "w_ig": ("inner", None),
            "b_ig": (None,), "w_fg": ("inner", None), "b_fg": (None,),
            "out_norm": ("inner",), "w_down": ("inner", "embed")}

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D, H, W = cfg.d_model, cfg.num_heads, cfg.conv1d_width
        F2 = int(cfg.mlstm_proj_factor * D)
        kw = dict(device=device, dtype=dtype)
        self.norm = Norm(cfg, D, **kw)
        self.w_up = _p(D, F2, **kw)
        self.w_gate = _p(D, F2, **kw)
        self.conv_w = _p(W, F2, **kw)
        self.conv_b = _p(F2, **kw)
        self.wq = _p(F2, F2, **kw)
        self.wk = _p(F2, F2, **kw)
        self.wv = _p(F2, F2, **kw)
        self.w_ig = _p(F2, H, **kw)
        self.b_ig = _p(H, **kw)
        self.w_fg = _p(F2, H, **kw)
        self.b_fg = _p(H, **kw)
        self.out_norm = _p(F2, **kw)
        self.w_down = _p(F2, D, **kw)


class SLSTM(Params):
    """sLSTM mixer leaves (``xlstm.slstm_defs``)."""
    INIT = {"b_gates": "zeros", "out_norm": "ones"}
    AXES = {"w_gates": ("embed", None, "slstm_inner"),
            "r_gates": (None, None, None, None),
            "b_gates": (None, "slstm_inner"), "out_norm": ("slstm_inner",),
            "wo": ("slstm_inner", "embed")}

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D, H = cfg.d_model, cfg.slstm_heads
        kw = dict(device=device, dtype=dtype)
        self.norm = Norm(cfg, D, **kw)
        self.w_gates = _p(D, 4, D, **kw)
        self.r_gates = _p(H, 4, D // H, D // H, **kw)
        self.b_gates = _p(4, D, **kw)
        self.out_norm = _p(D, **kw)
        self.wo = _p(D, D, **kw)


class Block(nn.Module):
    """One residual block of ``kind``, named as the JAX ``block_defs``:
    ATTN / LOCAL_ATTN {attn, norm2, mlp}, ATTN_MOE {attn, norm2, moe},
    RECURRENT {rec, norm2, mlp}, MLSTM {mlstm}, SLSTM {slstm}."""

    def __init__(self, cfg, kind, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        if kind in ATTN_KINDS:
            self.attn = Attention(cfg, **kw)
        elif kind == cfgbase.RECURRENT:
            self.rec = Recurrent(cfg, **kw)
        elif kind == cfgbase.MLSTM:
            self.mlstm = MLSTM(cfg, **kw)
        elif kind == cfgbase.SLSTM:
            self.slstm = SLSTM(cfg, **kw)
        else:
            raise ValueError(kind)
        if kind in ATTN_KINDS + (cfgbase.RECURRENT,):
            self.norm2 = Norm(cfg, cfg.d_model, **kw)
        if kind == cfgbase.ATTN_MOE:
            self.moe = moe_mod.MoE(cfg, **kw)
        elif kind in (cfgbase.ATTN, cfgbase.LOCAL_ATTN, cfgbase.RECURRENT):
            self.mlp = MLP(cfg, **kw)


class Table(Params):
    def __init__(self, *shape, axes, init, device, dtype):
        super().__init__()
        self.INIT = {"table": init}
        self.AXES = {"table": axes}
        self.table = _p(*shape, device=device, dtype=dtype)


class TransformerParams(nn.Module):
    """The model's parameters (uninitialised until ``init_`` or a load)."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed = Table(cfg.padded_vocab, cfg.d_model, axes=("vocab", "embed"),
                           init="normal", **kw)
        if not cfg.tie_embeddings:
            self.unembed = Table(cfg.d_model, cfg.padded_vocab, axes=("embed", "vocab"),
                                 init="scaled", **kw)
        self.blocks = nn.ModuleList(Block(cfg, kind, **kw) for kind in cfg.layer_kinds)
        self.final_norm = Norm(cfg, cfg.d_model, **kw)
        self.stack = cfg.num_scan_groups
        self.scanned = cfg.num_scan_groups * len(cfg.pattern)

    def init_(self, gen: torch.Generator):
        """Fill every parameter by its JAX ``ParamDef`` rule
        (``layers._init_one``) from ``gen``: ones, zeros, normal(0.02) or
        fan-in scaled normal, per leaf (``Params.INIT``). The scanned
        layers' matrices count the scan axis into their fan-in, as the JAX
        ``stack_defs`` tree does; the tail layers (past the last whole
        pattern period) have no such axis."""
        for path, mod in self.named_modules():
            if not isinstance(mod, Params):
                continue
            parts = path.split(".")
            scanned = parts[0] == "blocks" and int(parts[1]) < self.scanned
            for name, t in mod.named_parameters(recurse=False):
                init_(t, mod.INIT.get(name, "scaled"), gen,
                      stack=self.stack if scanned else 1)
        return self


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def tree_map(fn, tree):
    """Map over the tensor (or spec) leaves of a cache tree of dicts and
    tuples; a spec leaf is a (shape, dtype) pair. A ``Shards`` leaf (a
    mesh's cache) maps part by part; ``fn`` may drop leading dims."""
    if isinstance(tree, Shards):
        parts = [fn(p) for p in tree.parts]
        return Shards(parts, tree.dim - (tree.parts[0].dim() - parts[0].dim()))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and not _is_spec(tree):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """The leaves in ``jax.tree.leaves`` order (dict keys sorted); a
    ``Shards`` leaf gives its parts."""
    if isinstance(tree, Shards):
        return list(tree.parts)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, tuple) and not _is_spec(tree):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _is_spec(x):
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], torch.dtype)


def block_cache_spec(kind, cfg, batch: int, capacity: int):
    """One layer's cache leaves as (shape, dtype), the JAX
    ``block_cache_spec`` layout."""
    K, hd = cfg.num_kv_heads, cfg.head_dim
    R = cfg.rglru_dim or cfg.d_model
    F2 = int(cfg.mlstm_proj_factor * cfg.d_model)
    W = cfg.conv1d_width
    dt, f32 = DTYPES[cfg.dtype], torch.float32
    if kind in ATTN_KINDS:
        cap = min(capacity, attn_window(kind, cfg) or capacity)
        return {"k": ((batch, cap, K, hd), dt), "v": ((batch, cap, K, hd), dt)}
    if kind == cfgbase.RECURRENT:
        return {"h": ((batch, R), f32), "conv": ((batch, W - 1, R), dt)}
    if kind == cfgbase.MLSTM:
        H = cfg.num_heads
        mhd = F2 // H
        return {"state": (((batch, H, mhd, mhd), f32), ((batch, H, mhd), f32),
                          ((batch, H), f32)),
                "conv": ((batch, W - 1, F2), dt)}
    if kind == cfgbase.SLSTM:
        st = ((batch, cfg.d_model), f32)
        return {"state": (st, st, st, st)}
    raise ValueError(kind)


def cache_spec(cfg, batch: int, capacity: int) -> Dict[str, Any]:
    """The cache pytree as (shape, dtype) leaves: the scanned layers of
    pattern position i stack to [num_scan_groups, ...] under
    ``scan/sub<i>``, the tail layers sit under ``tail<j>``."""
    G = cfg.num_scan_groups
    c: Dict[str, Any] = {"scan": {
        f"sub{i}": tree_map(lambda s: ((G,) + s[0], s[1]),
                            block_cache_spec(kind, cfg, batch, capacity))
        for i, kind in enumerate(cfg.pattern)}}
    for j, kind in enumerate(cfg.tail_kinds):
        c[f"tail{j}"] = block_cache_spec(kind, cfg, batch, capacity)
    return c


def cache_bytes(cfg, batch: int, capacity: int) -> int:
    spec = cache_spec(cfg, batch, capacity)
    return sum(math.prod(s[0]) * torch.empty((), dtype=s[1]).element_size()
               for s in tree_leaves(spec))


def init_cache(cfg, batch: int, capacity: int, device) -> Dict[str, Any]:
    """Zeros in every leaf, as the JAX ``init_cache`` (a prefill starts
    from the zero recurrent state whatever the row holds)."""
    return tree_map(lambda s: torch.zeros(s[0], dtype=s[1], device=device),
                    cache_spec(cfg, batch, capacity))


def layer_cache(cache, cfg, layer: int):
    """Per-layer views of every leaf of the (stacked) cache pytree; writes
    through them update the cache."""
    P = len(cfg.pattern)
    g, i = divmod(layer, P)
    if g < cfg.num_scan_groups:
        return tree_map(lambda t: t[g], cache["scan"][f"sub{i}"])
    return cache[f"tail{layer - cfg.num_scan_groups * P}"]


# ---------------------------------------------------------------------------
# Blocks and the stack
# ---------------------------------------------------------------------------


def _on(dev, v):
    """``v`` on ``dev`` if it is a tensor (no copy on its own device)."""
    return v.to(dev) if isinstance(v, torch.Tensor) else v


def per_part(fn, tree, *args, **kw):
    """``fn(tree, *args, **kw)``, or, for a tree holding ``Shards`` (a
    mesh's "model" shards), ``fn`` on each shard's parts with the tensor
    arguments moved to its device. Returns the results, one per shard."""
    s = first_shards(tree)
    if s is None:
        return [fn(tree, *args, **kw)]
    return [fn(tree_parts(tree, j), *(_on(part.device, a) for a in args),
               **{k: _on(part.device, v) for k, v in kw.items()})
            for j, part in enumerate(s.parts)]


def _attn_mixer(p, x, cfg, *, kind, cache, positions, **kw):
    """Attention temporal mixer (the JAX ``_attn_mixer``): the q / k / v
    projections, ``_attend`` and the output projection. Returns (out,
    record).

    On a mesh (under ``sharding.use_rules``) the cache kernels launch per
    shard: per "data" shard over its rows (views of the slot cache; the
    page pool whole, so a shared page is readable by every shard) and, with
    ``p.wq`` in ``Shards``, per "model" shard over its q heads and the KV
    heads they read (cut by their output dims, the projections' sums stay
    whole). The heads are gathered before ``wo`` (the reference's
    "heads_act"), so the projection's sum over heads is never split; the
    products run over all rows at once. A verify record is then ``Shards``
    over the KV heads too."""
    if sharding.baseline():
        return _attn_mixer_tp(p, x, cfg, kind=kind, cache=cache,
                              positions=positions, **kw)
    n = x.shape[0]
    rows = rows_here(n)
    sharded = isinstance(p.wq, Shards)
    if not sharded and len(rows) == 1:
        q, k, v = attn.qkv_proj(p, x, cfg, positions)
        o, record = _attend(q, k, v, cfg, kind=kind, cache=cache, **kw)
        return attn.out_proj(p, o), record
    paged = kw.get("block_tables") is not None
    parts = ([(p.part(j), tree_parts(cache, j), d) for j, d in enumerate(p.devices())]
             if sharded else [(p, cache, x.device)])
    outs = []
    for pj, cj, d in parts:
        q, k, v = attn.qkv_proj(pj, x.to(d), cfg, positions.to(d))
        res = [_attend(q[r], k[r], v[r], cfg, kind=kind,
                       cache=cj if paged or len(rows) == 1 else _cache_rows(cj, r),
                       **{a: _on(d, _rows(b, r, n)) for a, b in kw.items()})
               for r in rows]
        o = _cat0([o for o, _ in res])
        rec = None if res[0][1] is None else {
            a: _cat0([rc[a] for _, rc in res]) for a in res[0][1]}
        outs.append((o, rec))
    if not sharded:
        o, record = outs[0]
        return attn.out_proj(p, o), record
    o = gather(Shards([o for o, _ in outs], 2), x.device)
    record = None
    if outs[0][1] is not None:
        record = {a: Shards([r[a] for _, r in outs], 2) for a in outs[0][1]}
    return attn.out_proj(p, o), record


def _kv_for(k, j: int, h: int, G: int):
    """The KV heads the q heads [j*h, (j+1)*h) of part j read, and their
    q_per_kv: a slice when the part holds whole GQA groups or shares one KV
    head, else one KV head per q head (an index)."""
    lo = j * h
    if h % G == 0:
        return k[:, :, lo // G:(lo + h) // G].contiguous(), G
    if G % h == 0:
        return k[:, :, lo // G:lo // G + 1].contiguous(), h
    idx = torch.arange(lo, lo + h, device=k.device) // G
    return k.index_select(2, idx), 1


def _attn_mixer_tp(p, x, cfg, *, kind, cache, positions, mode, cache_len,
                   block_tables=None, lens=None, prefill_len=None, keep=None):
    """Attention under a baseline table (train / prefill / decode, the
    reference's ``rules_for``): q heads cut over "model" with ``p.wq`` in
    ``Shards``, K / V whole ("kv_heads" replicated), the output projection
    cut by its rows ("heads_in") and the parts' partial products added
    (``psum``). Train and prefill run flash per part over the KV heads its
    q heads read, per "data" shard. Decode gathers q (all heads) and
    attends once over the cache, sequence-parallel when the cache is cut
    by "kv_seq" (``collectives.seqpar_decode_attention``: the split-K
    kernel's partials per sequence shard, one combine). Returns (out,
    None)."""
    if mode not in ("train", "prefill", "decode") or block_tables is not None:
        raise NotImplementedError(
            f"mode {mode!r}{' on a page pool' if block_tables is not None else ''} "
            "under a baseline table: the serving path runs under the serve rules")
    G, window = cfg.q_per_kv, attn_window(kind, cfg)
    k, v = attn.kv_proj(p, x, cfg, positions)
    if isinstance(p.wq, Shards):
        devs = p.devices()
        qs = sharding.per_part(lambda j: attn.q_proj(
            p.part(j), x.to(devs[j]), cfg, positions.to(devs[j])), len(devs))
    else:
        qs = [attn.q_proj(p, x, cfg, positions)]
    h = qs[0].shape[2]
    if mode == "decode":
        kc, vc = cache["k"], cache["v"]
        _decode_write(kc, vc, k, v, cache_len, keep)
        q = gather(Shards(qs, 2), x.device) if len(qs) > 1 else qs[0]
        if isinstance(kc, Shards):
            o = collectives.seqpar_decode_attention(q, kc, vc, cache_len,
                                                    q_per_kv=G, window=window)
        else:
            clen = torch.as_tensor(cache_len, device=x.device).reshape(-1).expand(
                x.shape[0]).contiguous()
            o = by_rows(lambda q_, k_, v_, c_: decode_attention(
                q_, k_, v_, c_, q_per_kv=G, window=window), x.shape[0], q, kc, vc, clen)
        outs = [o[:, :, j * h:(j + 1) * h] for j in range(len(qs))]
    else:
        def attend(j):
            q = qs[j]
            kj, g = _kv_for(k.to(q.device), j, h, G)
            vj, _ = _kv_for(v.to(q.device), j, h, G)
            return by_rows(lambda q_, k_, v_: flash_attention(
                q_, k_, v_, q_per_kv=g, window=window), q.shape[0], q, kj, vj)
        outs = sharding.per_part(attend, len(qs))
        if mode == "prefill":
            _prefill_write(cache, k, v, prefill_len)
    if isinstance(p.wo, Shards):
        w = p.wo.parts
        return psum(sharding.per_part(lambda j: torch.einsum(
            "bshk,hkd->bsd", outs[j].to(w[j].device), w[j]), len(w)), x.device), None
    o = outs[0] if len(outs) == 1 else gather(Shards(outs, 2), x.device)
    return attn.out_proj(p, o), None


def _decode_write(kc, vc, k, v, cache_len, keep):
    """The decode token's K / V at slot ``cache_len % W`` of each row; a
    cache cut by sequence (``Shards`` over dim 1) takes it in the part
    holding the slot, the others write back what they hold."""
    if not isinstance(kc, Shards):
        attn.cache_update(kc, vc, k, v, cache_len, keep)
        return
    B, W = k.shape[0], kc.shape[1]
    slot = torch.as_tensor(cache_len, device=k.device).long().reshape(-1).expand(B) % W
    lo = 0
    for kp, vp in zip(kc.parts, vc.parts):
        n, d = kp.shape[1], kp.device
        mine = ((slot >= lo) & (slot < lo + n)).to(d)
        attn.cache_update(kp, vp, k.to(d), v.to(d), (slot.to(d) - lo).clamp(0, n - 1),
                          mine if keep is None else mine & keep.to(d))
        lo += n


def _prefill_write(cache, k, v, prefill_len):
    """A prefill's K / V into a layer's cache (``_attend``'s writes); a
    cache cut by sequence takes each part's slots."""
    if not isinstance(cache["k"], Shards):
        for name, new in (("k", k), ("v", v)):
            _prefill_write_one(cache[name], new, prefill_len)
        return
    for name, new in (("k", k), ("v", v)):
        sh = cache[name]
        full = torch.zeros(sh.shape, dtype=sh.dtype, device=new.device)
        _prefill_write_one(full, new, prefill_len)
        lo = 0
        for part in sh.parts:
            n = part.shape[1]
            part.copy_(full[:, lo:lo + n])                             # mutation
            lo += n


def _prefill_write_one(c, new, prefill_len):
    S, cap = new.shape[1], c.shape[1]
    if cap >= S:
        attn.chunk_write(c, new, 0)
    else:
        length = S if prefill_len is None else prefill_len
        attn.ring_splice(c, new, 0, length, old=torch.zeros_like(c))


def _rows(v, r: slice, n: int):
    """Rows ``r`` of a per-row argument (a tensor of ``n`` rows)."""
    if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == n:
        return v[r]
    return v


def _cat0(xs):
    return xs[0] if len(xs) == 1 else torch.cat(xs)


def _cache_rows(cache, r: slice):
    """Rows ``r`` of every leaf of a layer's slot cache (views)."""
    return tree_map(lambda t: t[r], cache)


def _attend(q, k, v, cfg, *, kind, mode, cache, cache_len, block_tables=None,
            lens=None, prefill_len=None, keep=None):
    """Attention of projected q [B,S,H,hd], k, v [B,S,K,hd] with the cache
    writes. Returns (o [B,S,H,hd], record); record is the verify step's
    staged draft K/V of a ring cache, None otherwise. The window is
    ``attn_window``'s: a windowed block keeps its K/V in a ring of
    min(capacity, window) slots.

    ``mode == "extend"`` continues a partially filled cache: a chunk at
    positions [cache_len, cache_len+S) attends to the cached prefix plus
    itself; ``cache_len`` is then a Python int. ``mode == "verify"`` scores
    S draft tokens per row at per-row positions [cache_len[b],
    cache_len[b]+S), the first ``lens[b]`` of them valid: the linear cache
    is written ahead (padded-tail writes dropped, or sent to trash page 0
    when paged) and needs no rollback, since later reads mask by position;
    a ring cache cannot be written ahead, so verify attends to its
    position-ordered view plus the chunk and stages the chunk for
    ``verify_commit``. ``prefill_len`` is the valid prompt length of a
    right-padded prefill or extend chunk; ``keep`` freezes decode rows."""
    G = cfg.q_per_kv
    window = attn_window(kind, cfg)
    dev = q.device
    record = None
    if mode == "decode" and block_tables is not None:
        ps = cache["k"].shape[1]
        kc, vc = attn.paged_cache_update(cache["k"], cache["v"], k, v,
                                         block_tables, cache_len, ps)
        o = paged_decode_attention(q, kc, vc, block_tables, cache_len,
                                   q_per_kv=G)
    elif mode == "decode":
        kc, vc = attn.cache_update(cache["k"], cache["v"], k, v, cache_len, keep)
        o = decode_attention(q, kc, vc, cache_len, q_per_kv=G, window=window)
    elif mode == "verify":
        S = k.shape[1]
        clens = torch.as_tensor(cache_len, device=dev).reshape(-1)
        clens = clens.to(torch.int32)
        if window is not None:
            kv = torch.cat([attn.ring_verify_view(cache["k"], clens),
                            k.to(cache["k"].dtype)], dim=1)
            vv = torch.cat([attn.ring_verify_view(cache["v"], clens),
                            v.to(cache["v"].dtype)], dim=1)
            o = attn.spec_attention_ring(q, kv, vv, clens, q_per_kv=G,
                                         window=window)
            record = {"k_new": k, "v_new": v}
        else:
            n = torch.as_tensor(S if lens is None else lens, device=dev)
            valid = (torch.arange(S, device=dev)[None, :]
                     < n.reshape(-1, 1)).expand(k.shape[0], S)
            if block_tables is not None:
                ps = cache["k"].shape[1]
                kc, vc = attn.paged_spec_cache_update(
                    cache["k"], cache["v"], k, v, block_tables, clens, valid, ps)
                o = paged_spec_decode_attention(q, kc, vc, block_tables, clens,
                                                q_per_kv=G)
            else:
                kc, vc = attn.spec_cache_update(cache["k"], cache["v"], k, v,
                                                clens, valid)
                o = spec_decode_attention(q, kc, vc, clens, q_per_kv=G)
    elif mode == "extend":
        S = k.shape[1]
        start = int(cache_len)
        length = S if prefill_len is None else prefill_len
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
            o = flash_attention(q, kv, vv, q_per_kv=G, q_start=start)
        elif window is None:
            kv = attn.chunk_write(cache["k"], k, start)
            vv = attn.chunk_write(cache["v"], v, start)
            o = flash_attention(q, kv, vv, q_per_kv=G, q_start=start)
        else:
            # ring: attend to the position-ordered ring plus the chunk. Row
            # i of the view holds position start - cap + i; drop the rows
            # of negative (unwritten) positions so that key row 0 is
            # position max(start - cap, 0), and shift the queries to match
            # (the JAX package's k_start mask, by slicing)
            cap = cache["k"].shape[1]
            off = max(cap - start, 0)
            kseq = torch.cat([attn.ring_order(cache["k"], start),
                              k.to(cache["k"].dtype)], dim=1)[:, off:]
            vseq = torch.cat([attn.ring_order(cache["v"], start),
                              v.to(cache["v"].dtype)], dim=1)[:, off:]
            o = flash_attention(q, kseq.contiguous(), vseq.contiguous(),
                                q_per_kv=G, window=window, q_start=cap - off)
            attn.ring_splice(cache["k"], k, start, length)
            attn.ring_splice(cache["v"], v, start, length)
    else:                                   # train / prefill
        o = flash_attention(q, k, v, q_per_kv=G, window=window)
        if mode == "prefill":
            S, cap = k.shape[1], cache["k"].shape[1]
            if cap >= S:
                # right-padding is harmless: padded rows land at positions
                # >= the prompt length, which decode masks by cache_len
                attn.chunk_write(cache["k"], k, 0)
                attn.chunk_write(cache["v"], v, 0)
            else:
                # ring under padding: positions [length - cap, length) at
                # slot p % cap, zeros for the negative ones (a prefill
                # starts from an empty ring whatever the row held)
                length = S if prefill_len is None else prefill_len
                for name, new in (("k", k), ("v", v)):
                    attn.ring_splice(cache[name], new, 0, length,
                                     old=torch.zeros_like(cache[name]))
    return o, record


def apply_block(kind, p, x, cfg, *, positions, mode, cache, cache_len,
                block_tables=None, lens=None, prefill_len=None,
                prefill_mask=None, keep=None):
    """One residual block. Returns (x', record, aux): aux is the MoE
    router's loss (None for blocks without one); the cache is updated in
    place. In ``mode="verify"`` the blocks with state (recurrent, mLSTM,
    sLSTM, ring attention) leave their cache as it is and return a record
    that ``verify_commit`` resolves once the accept step has picked each
    row's accepted length; linear full attention commits in place."""
    p = sharding.fsdp_gathered(p)
    rec_mode = mode if mode in ("decode", "extend", "verify") else "full"
    rec_len = prefill_len if mode in ("prefill", "extend") else None
    rec_mask = prefill_mask if mode in ("prefill", "extend", "verify") else None
    if kind in ATTN_KINDS:
        h = apply_norm(p.attn.norm, x, cfg)
        o, record = _attn_mixer(p.attn, h, cfg, kind=kind, positions=positions,
                                mode=mode, cache=cache, cache_len=cache_len,
                                block_tables=block_tables, lens=lens,
                                prefill_len=rec_len, keep=keep)
        x = x + o
        h2 = apply_norm(p.norm2, x, cfg)
        if kind == cfgbase.ATTN_MOE:
            y, aux = moe_mod.apply_moe(p.moe, h2, cfg)
            return x + y, record, aux
        return x + apply_mlp(p.mlp, h2, cfg), record, None
    if kind == cfgbase.RECURRENT:
        h = apply_norm(p.rec.norm, x, cfg)
        o, record = rglru_mod.apply_recurrent_mixer(
            p.rec, h, cfg, cache=cache, mode=rec_mode, length=rec_len,
            mask=rec_mask, keep=keep)
        x = x + o
        y = apply_mlp(p.mlp, apply_norm(p.norm2, x, cfg), cfg)
        return x + y, record, None
    if kind == cfgbase.MLSTM:
        h = apply_norm(p.mlstm.norm, x, cfg)
        o, record = xlstm_mod.apply_mlstm(p.mlstm, h, cfg, cache=cache,
                                          mode=rec_mode, length=rec_len,
                                          mask=rec_mask, keep=keep)
        return x + o, record, None
    if kind == cfgbase.SLSTM:
        h = apply_norm(p.slstm.norm, x, cfg)
        o, record = xlstm_mod.apply_slstm(p.slstm, h, cfg, cache=cache,
                                          mode=rec_mode, length=rec_len,
                                          mask=rec_mask, keep=keep)
        return x + o, record, None
    raise ValueError(kind)


def _layers(params, layers, x, aux, cfg, positions):
    """Train-mode layers (no cache) in order; returns (x, aux + their MoE
    losses)."""
    for layer in layers:
        x, _, a = apply_block(cfg.layer_kinds[layer], params.blocks[layer], x,
                              cfg, positions=positions, mode="train",
                              cache=None, cache_len=None)
        if a is not None:
            aux = aux + a
    return x, aux


# "minimal" saves what JAX's ``dots_with_no_batch_dims_saveable`` saves: the
# products of activations with weight matrices (``x @ w`` lowers to mm, the
# projection einsums to a bmm of batch 1), and recomputes the rest
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _minimal_policy(ctx, op, *args, **kwargs):
    del ctx, kwargs
    if op in _SAVED_OPS or (op == torch.ops.aten.bmm.default
                            and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(policy: str):
    """How a period of layers runs under autograd (the JAX
    ``remat_policy``): "full" saves only its input and recomputes the rest
    in the backward (``nothing_saveable``), "minimal" also saves the matmul
    outputs, "none" saves everything. The recompute runs in the backward,
    on autograd's device thread for CUDA tensors, so it re-enters the
    sharding rules the forward ran under (they are thread-local)."""
    if policy == "none":
        return lambda fn, *args: fn(*args)
    kw = dict(use_reentrant=False)
    if policy == "minimal":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _minimal_policy)
    elif policy != "full":
        raise ValueError(f"remat_policy {policy!r}")

    def run(fn, *args):
        rules = sharding.current_rules()
        if rules is None:
            return ckpt.checkpoint(fn, *args, **kw)

        def under_rules(*a):
            with sharding.use_rules(rules):
                return fn(*a)
        return ckpt.checkpoint(under_rules, *args, **kw)
    return run


def _train_stack(params, x, cfg, positions):
    """Train mode: each period of the pattern (the JAX scan body) runs
    under ``_remat(cfg.remat_policy)``; the tail layers past the last whole
    period run plainly, as outside the JAX scan. The JAX package's
    ``_diff_barrier`` guards against an XLA loop-invariant hoist and has no
    counterpart here: eager PyTorch hoists nothing."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    P, G = len(cfg.pattern), cfg.num_scan_groups
    run = _remat(cfg.remat_policy if torch.is_grad_enabled() else "none")
    for g in range(G):
        x, aux = run(_layers, params, range(g * P, (g + 1) * P), x, aux, cfg,
                     positions)
    return _layers(params, range(G * P, cfg.num_layers), x, aux, cfg, positions)


def apply_stack(params, x, cfg, *, positions, mode, cache=None,
                cache_len=None, block_tables=None, lens=None,
                prefill_len=None, prefill_mask=None, keep=None):
    """Run all layers (a Python loop over layers stands in for the JAX
    scan). Returns (x, records, aux): the verify records by layer index and
    the MoE aux losses summed over the layers (float32, 0 without MoE)."""
    if mode == "train":
        x, aux = _train_stack(params, x, cfg, positions)
        return x, {}, aux
    records = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, (kind, blk) in enumerate(zip(cfg.layer_kinds, params.blocks)):
        lc = layer_cache(cache, cfg, layer) if cache is not None else None
        x, rec, a = apply_block(kind, blk, x, cfg, positions=positions,
                                mode=mode, cache=lc, cache_len=cache_len,
                                block_tables=block_tables, lens=lens,
                                prefill_len=prefill_len,
                                prefill_mask=prefill_mask, keep=keep)
        if rec is not None:
            records[layer] = rec
        if a is not None:
            aux = aux + a
    return x, records, aux


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _inputs_to_x(params, batch, cfg):
    """Token ids or precomputed frame embeddings (the modality stub):
    ``audio_frames`` configs take ``batch["frames"]`` [B, S, d_model] in
    ``cfg.dtype``, the others embed ``batch["tokens"]``; sinusoidal
    positions are added where ``cfg.pos_emb`` asks for them."""
    if cfg.modality == "audio_frames":
        x = batch["frames"].to(DTYPES[cfg.dtype])
    else:
        x = embed_tokens(params, batch["tokens"], cfg)
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_pos(batch["positions"], cfg.d_model, x.dtype)
    return x


def forward_logits(params, batch, cfg, *, mode="train", **kw):
    """The forward of every entry point. ``mode="train"`` runs with
    autograd as the caller has it, for ``train_loss``; every serving mode
    runs under ``torch.no_grad()``. See ``_forward``."""
    if mode == "train":
        return _forward(params, batch, cfg, mode=mode, **kw)
    with torch.no_grad():
        return _forward(params, batch, cfg, mode=mode, **kw)


def _forward(params, batch, cfg, *, mode, cache=None, cache_len=None,
             prefill_len=None, block_tables=None, with_logits=True, lens=None,
             keep=None):
    """``with_logits``: False skips final-norm + unembed (None logits);
    "last" unembeds only position ``prefill_len - 1`` (or the final one),
    [B, 1, V]; "all" / True unembeds every position. ``prefill_len`` (int)
    marks the valid prefix of a right-padded prefill / extend chunk and
    ``lens`` [B] the valid inputs of each verify row: both become the
    ``prefill_mask`` that stops recurrent, conv and xLSTM state at the
    last real token. Returns (logits, cache, aux) with aux the MoE router
    losses summed over the layers (0 without MoE); in ``mode="verify"`` the
    "cache" is the staged record ``{"cache", "records"}`` that
    ``verify_commit`` resolves, as in the JAX package."""
    x = _inputs_to_x(params, batch, cfg)
    B, S = x.shape[:2]
    n = lens if mode == "verify" else prefill_len
    prefill_mask = None
    if n is not None:
        n = torch.as_tensor(n, device=x.device).reshape(-1, 1)
        prefill_mask = (torch.arange(S, device=x.device)[None, :] < n).expand(B, S)
    x, records, aux = apply_stack(params, x, cfg, positions=batch["positions"],
                                  mode=mode, cache=cache, cache_len=cache_len,
                                  block_tables=block_tables, lens=lens,
                                  prefill_len=prefill_len,
                                  prefill_mask=prefill_mask, keep=keep)
    out = {"cache": cache, "records": records} if mode == "verify" else cache
    if not with_logits:
        return None, out, aux
    x = apply_norm(params.final_norm, x, cfg)
    if with_logits == "last":
        last = prefill_len - 1 if prefill_len is not None else x.shape[1] - 1
        x = x[:, last:last + 1]
    return unembed(params, x, cfg), out, aux


def train_loss(params, batch, cfg):
    """Causal LM loss (the JAX ``train_loss``): batch ``tokens`` (or
    ``frames``), ``labels`` [B, S] and ``positions``. float32 logits over
    the padded vocab (the log-sum-exp includes the pad columns), labels
    outside [0, vocab_size) masked out, the mean NLL of the rest plus the
    MoE aux loss. Returns (loss, {"nll", "aux"})."""
    logits, _, aux = forward_logits(params, batch, cfg, mode="train")
    labels = batch["labels"].long()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      labels.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    mask = (labels >= 0) & (labels < cfg.vocab_size)
    nll = torch.where(mask, lse - ll, torch.zeros_like(lse))
    loss = nll.sum() / torch.clamp(mask.sum(), min=1)
    return loss + aux, {"nll": loss, "aux": aux}


def prefill(params, batch, cfg, cache, *, length=None, with_logits=True):
    """Fill the cache from a (right-padded) prompt at positions [0, S),
    starting from the zero state whatever the cache row held. ``length``
    is the valid prompt length: recurrent, conv, xLSTM and ring-KV state
    then match an unpadded prefill of the first ``length`` tokens.
    Returns (logits, cache)."""
    logits, new_cache, _ = forward_logits(params, batch, cfg, mode="prefill",
                                             cache=cache, cache_len=0,
                                             prefill_len=length,
                                             with_logits=with_logits)
    return logits, new_cache


def decode_step(params, batch, cfg, cache, cache_len, *, block_tables=None,
                keep=None):
    """One decode step. batch tokens [B,1]; cache_len [B] (or scalar).
    ``block_tables`` [B, n] switches the caches to the paged layout;
    ``keep`` [B] bool leaves the cache rows it marks False bit for bit (the
    done rows of a decode chunk on archs with state)."""
    logits, new_cache, _ = forward_logits(params, batch, cfg, mode="decode",
                                             cache=cache, cache_len=cache_len,
                                             block_tables=block_tables,
                                             keep=keep)
    return logits, new_cache


def extend(params, batch, cfg, cache, cache_len, *, length=None,
           block_tables=None, with_logits=True):
    """Prefill continuation: a chunk of S tokens at positions
    [cache_len, cache_len+S) against a partially filled cache (chunked
    prefill, paged suffix prefill, a snapshot restore's suffix); recurrent,
    conv and xLSTM layers resume from their cached state. ``length`` marks
    the valid chunk prefix."""
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
    input i. Linear full-attention K/V is written ahead in place; every
    other block leaves its cache as it is and stages a record, so
    ``staged`` is ``{"cache", "records"}`` for ``verify_commit``."""
    logits, staged, _ = forward_logits(
        params, batch, cfg, mode="verify", cache=cache, cache_len=cache_lens,
        block_tables=block_tables, with_logits="all", lens=lens)
    return logits, staged


def verify_commit(cfg, staged, cache_lens, ns, lens):
    """Resolve a ``verify`` call's staged record to the committed cache.

    ns [B]: tokens emitted per row by ``sampler.accept_batched`` (accepted
    drafts + 1, the inputs consumed); lens [B]: the verify call's valid
    inputs, rows with ``lens == 0`` keep their pre-verify state bit for
    bit. Recurrent, xLSTM and ring-attention layers rewind by gathers and
    ring splices (no second forward); linear full attention was written
    ahead and is masked by position. Returns the cache."""
    cache = staged["cache"]
    if not staged["records"]:
        return cache
    dev = next(iter(tree_leaves(cache))).device
    clens = torch.as_tensor(cache_lens, device=dev).reshape(-1)
    ns = torch.as_tensor(ns, device=dev).reshape(-1).long()
    valid = torch.as_tensor(lens, device=dev).reshape(-1) > 0
    for layer, rec in staged["records"].items():
        kind = cfg.layer_kinds[layer]
        lc = layer_cache(cache, cfg, layer)
        if kind in ATTN_KINDS:
            per_part(lambda t, *a: attn.ring_verify_commit(t[0], t[1], *a),
                     (rec, lc), clens, ns, valid)
        elif kind == cfgbase.RECURRENT:
            per_part(lambda t, *a: rglru_mod.verify_commit(t[0], t[1], *a),
                     (rec, lc), ns, valid)
        elif kind == cfgbase.MLSTM:
            xlstm_mod.mlstm_verify_commit(rec, lc, ns, valid)
        elif kind == cfgbase.SLSTM:
            xlstm_mod.slstm_verify_commit(rec, lc, ns, valid)
        else:
            raise ValueError(kind)
    return cache
