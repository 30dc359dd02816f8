"""Logical-axis -> mesh-axis sharding rules, and leaves laid out on a mesh.

Counterpart of ``repro.distributed.sharding``. Parameters carry *logical*
axis names (each parameter module's ``AXES``, the reference's ``ParamDef``
axes); a rule set maps them to mesh axes, per phase: ``rules_for`` keeps
every table of the reference (train, decode, ``weight_stationary``,
``expert_parallel``, multi-pod, serve), and ``param_pspecs`` /
``cache_pspecs`` / ``batch_pspecs`` turn them into specs. Every table
drives code: the serve rules the serving path, the baseline tables
(train / prefill / decode, ``weight_stationary``, ``expert_parallel``) the
model-level entry points and the train step (below).

The serve layout (phase="serve") keeps greedy outputs bit-identical to one
device: it shards only batch-like dims (slot / page / snapshot rows over
"data"; q heads, KV heads and experts over "model") and the output dims of
products whose contraction stays replicated (vocab, mlp-up, rnn-up), and
gathers before every down-projection, so no float sum is ever split.

How a leaf lies on a mesh in the port (``shard_put``): a dim mapped to
"model" is cut into ``Shards``, part j a contiguous tensor on the mesh's
j-th "model" device; a dim mapped to "data" (or "pod") is cut into equal
row ranges that are views of one storage per "model" position, because
the devices along "data" of each position must be one device
(``Mesh.rows_share_devices``: the paged pool is then readable by every
data shard's launch, and a slot row is a view). A leaf with no "model" dim
is one tensor on the mesh's lead device, where replicated work runs. A dim
whose mesh extent does not divide it stays whole (``_divisible_spec``).

Under the baseline tables (``place_params`` of a non-serve rule set) a
parameter dim mapped to the FSDP axes ("data", or ("pod", "data")) is cut
into ``Fsdp`` parts, one a "data" position (the reference's FSDP over
"embed" / "moe_embed"); a layer gathers them before it runs
(``fsdp_gathered``: a concatenation whose gradient is the parts' slices,
the reduce-scatter), except experts over the FSDP axis
(``expert_parallel``), which run where they lie. Products whose
contraction dim is cut over "model" ("heads_in", "mlp_in", "rnn_in") run
per part and their partial sums are added (``psum``: re-associated, so
float32 is close to the unsharded result, not bit-equal). With
``trainable=True`` every part is a leaf that requires grad, and a
``Placed`` tree lists its parts as its parameters (``named_parameters``),
so the train step and AdamW run on the parts, their moments shaped alike.
Each collective point tells a tracer (``tracing.collective``; the dry
run's cost counter) the bytes a device receives there.
"""
from __future__ import annotations

import contextlib
import threading
import types
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch import tracing
from repro_torch.configs import base as cfgbase
from repro_torch.distributed.mesh import Mesh

# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


class P(tuple):
    """A partition spec: one entry per dim, None (replicated), a mesh axis
    name or a tuple of names (the reference's ``PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


class NamedSharding:
    """A spec on a mesh: where ``checkpoint.restore(shardings=...)`` and
    ``reshard_tree`` put a leaf."""

    def __init__(self, mesh: Mesh, spec: P, fsdp: bool = False):
        self.mesh, self.spec, self.fsdp = mesh, P(*spec), fsdp


def rules_for(mesh: Mesh, phase: str, *, shard_batch: bool = True,
              weight_stationary: bool = False,
              expert_parallel: bool = False) -> dict:
    """The baseline layout, or the reference's ``weight_stationary`` decode
    layout (activations replicated over the batch axes, every weight 2-D
    sharded, caches keep their sharded batch); ``expert_parallel`` puts
    the experts on the FSDP axis; phase "serve" is ``_serve_rules``."""
    axes = mesh.axis_names
    multi_pod = "pod" in axes
    fsdp = ("pod", "data") if multi_pod else ("data",)
    batch = fsdp if shard_batch else ()
    if phase == "serve":
        return _serve_rules(mesh, batch)
    rules = {
        "phase": phase,
        "mesh": mesh,
        "batch": batch,
        "cache_batch": batch,
        "fsdp": fsdp,
        "vocab": ("model",),
        "embed": fsdp,
        "heads": ("model",),
        "heads_in": ("model",),
        "heads_act": ("model",),
        "kv_heads": (),
        "head_dim": (),
        "mlp": ("model",),
        "mlp_in": ("model",),
        "mlp_act": ("model",),
        "experts": (),
        "moe_mlp": ("model",),
        "moe_embed": fsdp,
        "moe_tokens": batch,
        "experts_run": (),
        "rnn": ("model",),
        "rnn_in": ("model",),
        "rnn_act": ("model",),
        # xLSTM inner dims replicate over "model" (the reference's §Perf
        # iteration 2: a 2048-wide recurrence over 16 shards gathered its
        # state every chunk)
        "inner": (),
        "inner_out": (),
        "slstm_inner": (),
        "conv": (),
        "norm": (),
        "layers": (),
        "kv_seq": ("model",),
        None: (),
    }
    if weight_stationary:
        assert phase == "decode", "weight-stationary layout is a decode mode"
        rules["batch"] = ()
        rules["moe_tokens"] = ()
    if expert_parallel:
        rules["experts"] = fsdp
        rules["moe_embed"] = ()
        rules["experts_run"] = fsdp
        rules["moe_tokens"] = ()
    return rules


def _serve_rules(mesh: Mesh, batch) -> dict:
    """The bit-exact serving layout (see the module docstring): every
    contraction side (embed, ``*_in``) and every pre-down-projection
    activation (``*_act``) replicated; no sequence parallelism (the softmax
    combine re-associates sums)."""
    return {
        "phase": "serve",
        "mesh": mesh,
        "batch": batch,
        "cache_batch": batch,
        "fsdp": (),
        "vocab": ("model",),
        "embed": (),
        "heads": ("model",),
        "heads_in": (),
        "heads_act": (),
        "kv_heads": ("model",),
        "head_dim": (),
        "mlp": ("model",),
        "mlp_in": (),
        "mlp_act": (),
        "experts": ("model",),
        "moe_mlp": (),
        "moe_embed": (),
        "moe_tokens": (),
        "experts_run": ("model",),
        "rnn": ("model",),
        "rnn_in": (),
        "rnn_act": (),
        "inner": (),
        "inner_out": (),
        "slstm_inner": (),
        "conv": (),
        "norm": (),
        "layers": (),
        "kv_seq": (),
        None: (),
    }


def _axes_to_spec(axes: Sequence[Optional[str]], rules: dict) -> P:
    out = []
    for a in axes:
        phys = rules.get(a, ())
        if isinstance(phys, str):
            phys = (phys,)
        out.append(None if not phys else phys[0] if len(phys) == 1 else tuple(phys))
    return P(*out)


def _is_axes(x) -> bool:
    return (isinstance(x, tuple) and not isinstance(x, P)
            and all(a is None or isinstance(a, str) for a in x))


def _map(fn, tree, is_leaf):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_map(fn, v, is_leaf) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree)


def param_pspecs(logical_tree, rules: dict):
    """Tree of logical-axis tuples -> tree of ``P``."""
    return _map(lambda axes: _axes_to_spec(axes, rules), logical_tree, _is_axes)


def param_axes(cfg) -> Dict[str, Any]:
    """The logical axes of every parameter in the JAX package's tree
    layout (``Model.param_axes()``): ``scan/sub<i>`` leaves carry the
    stacking axis "layers" first. Built from the parameter modules'
    ``AXES`` on the meta device."""
    from repro_torch.models import transformer as tfm

    meta = dict(device="meta", dtype=torch.float32)
    out: Dict[str, Any] = {}

    def add(prefix, mod, lead=()):
        for path, sub in mod.named_modules():
            for name, _ in sub.named_parameters(recurse=False):
                key = prefix + tuple(p for p in path.split(".") if p) + (name,)
                node = out
                for k in key[:-1]:
                    node = node.setdefault(k, {})
                node[key[-1]] = lead + tuple(sub.AXES[name])

    for name, mod in tfm.TransformerParams(cfg, **meta).named_children():
        if name != "blocks":
            add((name,), mod)
    for i, kind in enumerate(cfg.pattern):
        add(("scan", f"sub{i}"), tfm.Block(cfg, kind, **meta), ("layers",))
    for j, kind in enumerate(cfg.tail_kinds):
        add((f"tail{j}",), tfm.Block(cfg, kind, **meta))
    return out


def cache_pspecs(cfg, rules: dict):
    """Specs mirroring the cache tree (``transformer.cache_spec``): the
    dense slot cache, the paged page pool (batch = pages) and the snapshot
    arena (batch = rows) share it. Serve: rows over "data", KV heads and
    RG-LRU channels over "model", never the sequence."""
    batch = rules.get("cache_batch", rules["batch"])
    b = batch if len(batch) > 1 else (batch[0] if batch else None)
    kv = rules["kv_seq"][0] if rules["kv_seq"] else None
    kvh = rules.get("kv_heads", ())
    kvh = kvh[0] if kvh else None
    rnn = rules.get("rnn", ())
    ch = rnn[0] if rnn else None

    def block_specs(kind, lead):
        if kind in (cfgbase.ATTN, cfgbase.ATTN_MOE, cfgbase.LOCAL_ATTN):
            s = P(*lead, b, kv, kvh, None)
            return {"k": s, "v": s}
        if kind == cfgbase.RECURRENT:
            return {"h": P(*lead, b, ch), "conv": P(*lead, b, None, ch)}
        if kind == cfgbase.MLSTM:
            return {"state": (P(*lead, b, None, None, None),
                              P(*lead, b, None, None),
                              P(*lead, b, None)),
                    "conv": P(*lead, b, None, None)}
        if kind == cfgbase.SLSTM:
            s = P(*lead, b, None)
            return {"state": (s, s, s, s)}
        raise ValueError(kind)

    out = {"scan": {}}
    for i, kind in enumerate(cfg.pattern):
        out["scan"][f"sub{i}"] = block_specs(kind, (None,))
    for j, kind in enumerate(cfg.tail_kinds):
        out[f"tail{j}"] = block_specs(kind, ())
    return out


def batch_pspecs(cfg, rules: dict, phase: str):
    batch = rules["batch"]
    b = batch if len(batch) != 1 else (batch[0] if batch else None)
    if not batch:
        b = None
    specs = {"positions": P(b, None)}
    if cfg.modality == "audio_frames":
        specs["frames"] = P(b, None, None)
    else:
        specs["tokens"] = P(b, None)
    if phase == "train":
        specs["labels"] = P(b, None)
    return specs


# ---------------------------------------------------------------------------
# Leaves on a mesh
# ---------------------------------------------------------------------------


class Shards:
    """A tensor cut along ``dim`` over the "model" axis: ``parts[j]``, a
    contiguous tensor on the mesh's j-th "model" device."""

    __slots__ = ("parts", "dim")

    def __init__(self, parts, dim: int):
        self.parts, self.dim = list(parts), dim

    def __len__(self):
        return len(self.parts)

    @property
    def shape(self):
        s = list(self.parts[0].shape)
        s[self.dim] = sum(p.shape[self.dim] for p in self.parts)
        return torch.Size(s)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        return self.parts[0].device


class Fsdp:
    """A parameter cut along ``dim`` over the FSDP axes: ``parts[i]`` the
    i-th contiguous slice, all on one "model" position's device.
    ``logical`` is the cut dim's logical axis."""

    __slots__ = ("parts", "dim", "logical")

    def __init__(self, parts, dim: int, logical=None):
        self.parts, self.dim, self.logical = list(parts), dim, logical

    def __len__(self):
        return len(self.parts)

    shape = Shards.shape
    dtype = Shards.dtype
    device = Shards.device


def _ring(n: int) -> float:
    return (n - 1) / n if n > 1 else 0.0


class _AllGather(torch.autograd.Function):
    """``torch.cat(parts, dim)``: the FSDP gather; its gradient is the
    slices of the output gradient (the reduce-scatter)."""

    @staticmethod
    def forward(ctx, dim, axes, *parts):
        ctx.dim, ctx.axes = dim, axes
        ctx.sizes = [p.shape[dim] for p in parts]
        out = torch.cat(parts, dim)
        tracing.collective("all-gather", _ring(len(parts)) * out.numel()
                        * out.element_size(), axes, parts, out)
        return out

    @staticmethod
    def backward(ctx, g):
        tracing.collective("reduce-scatter", _ring(len(ctx.sizes)) * g.numel()
                        * g.element_size(), ctx.axes, (g,))
        # each part's gradient its own tensor, so the whole one is freed
        return (None, None) + tuple(t.contiguous() if len(ctx.sizes) == 1 else t.clone()
                                    for t in g.split(ctx.sizes, ctx.dim))


def fsdp_full(x, axes=("data",)):
    """An ``Fsdp`` leaf (or a ``Shards`` of them) gathered over the FSDP
    axes; other leaves pass through."""
    if isinstance(x, Fsdp):
        if len(x.parts) == 1:
            return x.parts[0]
        return _AllGather.apply(x.dim, axes, *x.parts)
    if isinstance(x, Shards) and isinstance(x.parts[0], Fsdp):
        return Shards([fsdp_full(q, axes) for q in x.parts], x.dim)
    return x


def _runs_in_place(x) -> bool:
    """Experts over the FSDP axis run where they lie (expert parallelism)."""
    if isinstance(x, Shards):
        x = x.parts[0]
    return isinstance(x, Fsdp) and x.logical == "experts"


def fsdp_gathered(p):
    """A ``Placed`` module with its ``Fsdp`` leaves gathered (not experts
    over the FSDP axis): what a layer reads. Other values pass through."""
    if not isinstance(p, Placed) or not p.__dict__.get("_fsdp"):
        return p
    rules = current_rules()
    axes = rules["fsdp"] if rules is not None and rules.get("fsdp") else ("data",)
    out = {}
    for k, v in vars(p).items():
        if k.startswith("_"):
            continue
        if isinstance(v, Placed):
            out[k] = fsdp_gathered(v)
        elif isinstance(v, list):
            out[k] = [fsdp_gathered(b) for b in v]
        else:
            out[k] = v if _runs_in_place(v) else fsdp_full(v, axes)
    return Placed(**out)


def psum(partials, device=None):
    """The row-parallel sum: the "model" parts' partial products added in
    part order on ``device`` (default: part 0's), an all-reduce."""
    device = device or partials[0].device
    out = partials[0].to(device)
    for t in partials[1:]:
        out = out + t.to(device)
    tracing.collective("all-reduce", 2 * _ring(len(partials)) * out.numel()
                    * out.element_size(), ("model",), partials, out)
    return out


def baseline() -> bool:
    """Whether the current rules are a baseline table (not "serve")."""
    rules = current_rules()
    return rules is not None and rules.get("phase") != "serve"


def gather(x, device=None):
    """A ``Shards`` gathered into one tensor on ``device`` (default: part
    0's): a copy and a concatenation, which move bits and add nothing.
    Tensors pass through (moved to ``device`` if given)."""
    if isinstance(x, Fsdp):
        x = torch.cat(x.parts, dim=x.dim)
        return x if device is None else x.to(device)
    if isinstance(x, Shards):
        device = device or x.parts[0].device
        out = torch.cat([gather(p).to(device) for p in x.parts], dim=x.dim)
        tracing.collective("all-gather", _ring(len(x.parts)) * out.numel()
                        * out.element_size(), ("model",), x.parts, out)
        return out
    return x if device is None else x.to(device)


def split(t, dim: int, devices) -> Shards:
    """``t`` cut into ``len(devices)`` equal parts along ``dim``, part j
    contiguous on ``devices[j]`` (a part that is already contiguous on its
    device is a view of ``t``)."""
    return Shards([c.contiguous().to(d) for c, d in
                   zip(t.chunk(len(devices), dim), devices)], dim)


def _names(entry):
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _divisible_spec(shape, spec: P, mesh: Mesh) -> P:
    """Drop spec entries whose mesh extent does not divide the dim:
    replicating it keeps every value, so a config whose KV heads, slots or
    pages do not divide the mesh still serves, only unsharded on that dim."""
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is not None:
            extent = mesh.extent(_names(entry))
            if extent == 0 or dim % extent != 0:
                entry = None
        out.append(entry)
    return P(*out)


def _put(x, spec: P, mesh: Mesh, fsdp: bool = False, logical=None,
         trainable: bool = False):
    """One leaf on ``mesh`` by ``spec`` (after ``_divisible_spec``): cut
    into ``Shards`` over "model"; with ``fsdp`` (a parameter under a
    baseline table) a dim over the FSDP axes is cut into ``Fsdp`` parts
    (``logical``: the leaf's logical axes); otherwise such a dim is rows,
    views of one storage. ``trainable``: every part a leaf that requires
    grad."""
    spec = _divisible_spec(x.shape, spec, mesh)
    cut = [i for i, e in enumerate(spec) if "model" in _names(e)
           and mesh.shape.get("model", 1) > 1]
    rows = [i for i, e in enumerate(spec)
            if e is not None and set(_names(e)) - {"model"}]
    if rows and not mesh.rows_share_devices():
        raise NotImplementedError(
            f"{mesh}: rows cut over 'data' on several devices need a storage "
            "per device and a page gather (ROADMAP.md queue 1, item 15)")
    part = (lambda t: t.detach().clone().requires_grad_(True)) if trainable else \
        (lambda t: t)

    def rows_cut(t):
        if not (fsdp and rows):
            return part(t)
        n = mesh.extent(_names(spec[rows[0]]))
        if n <= 1:
            return part(t)
        return Fsdp([part(c.contiguous()) for c in t.chunk(n, rows[0])], rows[0],
                    None if logical is None else logical[rows[0]])

    if cut:
        sh = split(x, cut[0], mesh.column_devices())
        return Shards([rows_cut(q) for q in sh.parts], sh.dim)
    return rows_cut(x.to(mesh.lead))


def shard_put(tree, spec_tree, mesh: Mesh):
    """Lay a tree of tensors (dicts, tuples) out on ``mesh`` by a matching
    tree of ``P`` (see the module docstring), with the divisibility
    fallback."""
    if isinstance(spec_tree, P):
        return _put(unshard(tree), spec_tree, mesh)
    if isinstance(spec_tree, NamedSharding):
        return _put(unshard(tree), spec_tree.spec, spec_tree.mesh, spec_tree.fsdp)
    if isinstance(tree, dict):
        return {k: shard_put(v, spec_tree[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, Shards):
        out = [shard_put(v, s, mesh) for v, s in zip(tree, spec_tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    raise TypeError(f"no spec for leaf {type(tree).__name__}")


def unshard(tree, device=None):
    """Every ``Shards`` leaf of a tree gathered into one tensor."""
    return _map(lambda x: gather(x, device), tree,
                lambda x: isinstance(x, (Shards, Fsdp, torch.Tensor)))


def tree_parts(tree, j: int):
    """Part ``j`` of every ``Shards`` leaf of a tree (dicts, tuples, None);
    other leaves pass through."""
    return _map(lambda x: x.parts[j] if isinstance(x, Shards) else x, tree,
                lambda x: isinstance(x, Shards) or x is None
                or isinstance(x, torch.Tensor))


def first_shards(tree) -> Optional[Shards]:
    """The first ``Shards`` leaf of a tree, or None."""
    if isinstance(tree, Shards):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for v in tree:
            s = first_shards(v)
            if s is not None:
                return s
    return None


# ---------------------------------------------------------------------------
# Placed parameters
# ---------------------------------------------------------------------------


class Placed(types.SimpleNamespace):
    """A parameter module laid out on a mesh: its leaves as attributes
    (``Shards`` or tensors, under the ``nn.Module``'s names), sub-modules
    as ``Placed``, ``blocks`` a list. ``part(j)`` is the module as "model"
    shard j sees it: every ``Shards`` leaf replaced by its part j."""

    def _leaves(self):
        return [v for k, v in vars(self).items() if not k.startswith("_")]

    def sharded(self) -> bool:
        return any(isinstance(v, Shards) or (isinstance(v, Placed) and v.sharded())
                   for v in self._leaves())

    def part(self, j: int) -> "Placed":
        cache = self.__dict__.setdefault("_parts", {})
        if j not in cache:
            cache[j] = Placed(**{
                k: (v.parts[j] if isinstance(v, Shards) else
                    v.part(j) if isinstance(v, Placed) else v)
                for k, v in vars(self).items() if not k.startswith("_")})
        return cache[j]

    def named_parameters(self, prefix: str = ""):
        """(state-dict name, leaf) of every leaf: a tensor, or a ``Shards``
        / ``Fsdp`` whose parts are the tensors (``leaf_parts``)."""
        for k, v in vars(self).items():
            if k.startswith("_"):
                continue
            if isinstance(v, Placed):
                yield from v.named_parameters(f"{prefix}{k}.")
            elif isinstance(v, list):
                for i, b in enumerate(v):
                    yield from b.named_parameters(f"{prefix}{k}.{i}.")
            else:
                yield prefix + k, v

    def parameters(self):
        return [t for _, v in self.named_parameters() for t in leaf_parts(v)]

    def devices(self):
        """The "model" devices of the module's first ``Shards`` leaf."""
        for v in self._leaves():
            if isinstance(v, Shards):
                return [p.device for p in v.parts]
            if isinstance(v, Placed) and v.sharded():
                return v.devices()
        return None


def _attention_spec(name, spec, shapes, mesh):
    """GQA groups stay whole on a shard: when the KV heads do not divide
    "model" they replicate (``_divisible_spec``), and then the q heads and
    their bias replicate too, so a shard never holds q heads without the
    KV heads they read (nor a strided slice of them)."""
    kv = _divisible_spec(shapes["wk"], P(None, "model"), mesh)
    if name in ("wq", "bq") and kv[1] is None:
        return P(*(None if "model" in _names(e) else e for e in spec))
    return spec


def place_params(params, rules: dict, *, trainable: bool = False):
    """The params ``nn.Module`` laid out on ``rules["mesh"]`` by the
    modules' ``AXES`` under ``rules`` (``shard_put`` leaf by leaf; under a
    baseline table FSDP dims become ``Fsdp`` parts). ``trainable``: every
    part a leaf that requires grad (a copy). Returns a ``Placed`` tree;
    ``source_params`` gives the module back."""
    mesh = rules["mesh"]
    fsdp = rules.get("phase") != "serve"

    def place(mod):
        out = {}
        shapes = {n: tuple(t.shape) for n, t in mod.named_parameters(recurse=False)}
        for name, t in mod.named_parameters(recurse=False):
            spec = _axes_to_spec(mod.AXES[name], rules)
            if "wk" in shapes and "wq" in shapes and not fsdp:
                spec = _attention_spec(name, spec, shapes, mesh)
            out[name] = _put(t.detach(), spec, mesh, fsdp, mod.AXES[name], trainable)
        for name, sub in mod.named_children():
            out[name] = ([place(b) for b in sub] if isinstance(sub, torch.nn.ModuleList)
                         else place(sub))
        placed = Placed(**out)
        placed.__dict__["_fsdp"] = fsdp
        return placed

    placed = place(params)
    placed.__dict__["_source"] = params
    return placed


def per_part(fn, n: int) -> list:
    """``[fn(0), ..., fn(n - 1)]``, the work of each "model" part; while a
    tracer counts one device (``tracing.one_part``) only part 0's,
    standing for all (the parts are alike)."""
    if tracing.one_part():
        return [fn(0)] * n
    return [fn(j) for j in range(n)]


def leaf_parts(x) -> List[torch.Tensor]:
    """The tensors a laid-out leaf holds: itself, or the parts of a
    ``Shards`` / ``Fsdp`` (part 0 only under ``tracing.one_part``)."""
    if isinstance(x, (Shards, Fsdp)):
        parts = x.parts[:1] if tracing.one_part() else x.parts
        return [t for q in parts for t in leaf_parts(q)]
    return [x]


def map_parts(fn, x):
    """``fn`` on every part of a laid-out leaf, keeping its layout (on part
    0 only under ``tracing.one_part``)."""
    if isinstance(x, (Shards, Fsdp)):
        parts = [map_parts(fn, q) for q in (x.parts[:1] if tracing.one_part()
                                            else x.parts)]
        return Shards(parts, x.dim) if isinstance(x, Shards) else \
            Fsdp(parts, x.dim, x.logical)
    return fn(x)


def zip_parts(*leaves):
    """Tuples of the matching parts of laid-out leaves of one layout."""
    return list(zip(*(leaf_parts(x) for x in leaves)))


def placed_from(named: Dict[str, Any]) -> "Placed":
    """A ``Placed`` tree (baseline layout) from state-dict names to laid-out
    leaves, as ``named_parameters`` lists them (``blocks.<i>`` a list):
    what a checkpoint of ``dict(placed.named_parameters())`` restores to."""
    root: Dict[str, Any] = {}
    for name, leaf in named.items():
        node = root
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf

    def build(d):
        if d and all(k.isdigit() for k in d):
            return [build(d[k]) for k in sorted(d, key=int)]
        out = Placed(**{k: build(v) if isinstance(v, dict) else v for k, v in d.items()})
        out.__dict__["_fsdp"] = True
        return out

    return build(root)


def state_dict_pspecs(params, rules: dict) -> Dict[str, P]:
    """name -> ``P`` of every parameter of a params module under ``rules``."""
    return {(f"{path}." if path else "") + name: _axes_to_spec(mod.AXES[name], rules)
            for path, mod in params.named_modules()
            for name, _ in mod.named_parameters(recurse=False)}


def full_state_dict(params) -> Dict[str, torch.Tensor]:
    """name -> the whole tensor of every leaf of a ``Placed`` tree (or a
    params module's state dict)."""
    if isinstance(params, Placed):
        return {n: gather(v).detach() for n, v in params.named_parameters()}
    return {k: v.detach() for k, v in params.state_dict().items()}


def source_params(params):
    """The module a ``Placed`` tree was laid out from (others as given)."""
    return params.__dict__["_source"] if isinstance(params, Placed) else params


# ---------------------------------------------------------------------------
# Rules context
# ---------------------------------------------------------------------------

_tls = threading.local()


def current_rules() -> Optional[dict]:
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def use_rules(rules: dict):
    prev = getattr(_tls, "rules", None)
    _tls.rules = rules
    try:
        yield
    finally:
        _tls.rules = prev


def constrain(x, *axes):
    """Lay ``x`` out by logical axes under the current rules; a no-op
    outside a rules context. A ``Shards`` whose cut dim the axes replicate
    is gathered onto its part 0's device; a tensor with a dim the axes put
    on "model" (and the extent divides) is cut over the mesh's "model"
    devices; other entries ("data") are row views and move nothing."""
    rules = current_rules()
    if rules is None:
        return x
    spec = _axes_to_spec(axes, rules)
    if isinstance(x, Shards):
        return x if "model" in _names(spec[x.dim]) else gather(x)
    mesh = rules["mesh"]
    spec = _divisible_spec(x.shape, spec, mesh)
    cut = [i for i, e in enumerate(spec) if "model" in _names(e)]
    if cut and mesh.shape.get("model", 1) > 1:
        return split(x, cut[0], mesh.column_devices())
    return x


def rows_here(n: int) -> List[slice]:
    """The "data" shards' row ranges of an ``n``-row batch under the
    current rules (one range outside a rules context)."""
    rules = current_rules()
    return data_rows(n, rules["mesh"], rules) if rules is not None else [slice(0, n)]


def by_rows(fn, n: int, *args):
    """``fn(*args)`` once per "data" shard on its rows of every tensor
    argument with ``n`` rows (other arguments pass as they are), the
    results (tensors, or tuples of them) concatenated along the rows."""
    rows = rows_here(n)
    if len(rows) == 1:
        return fn(*args)
    outs = [fn(*(a[r] if isinstance(a, torch.Tensor) and a.dim() and a.shape[0] == n
                 else a for a in args)) for r in rows]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(xs) for xs in zip(*outs))
    return torch.cat(outs)


def data_rows(n: int, mesh: Mesh, rules: dict) -> List[slice]:
    """The row ranges of ``n`` rows cut over the batch axes of ``rules``
    (one range, all rows, when the extent does not divide ``n``)."""
    d = mesh.extent(rules["batch"]) if rules is not None else 1
    if d <= 1 or n % d:
        return [slice(0, n)]
    k = n // d
    return [slice(i * k, (i + 1) * k) for i in range(d)]
