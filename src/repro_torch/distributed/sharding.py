"""Logical-axis -> mesh-axis sharding rules, and leaves laid out on a mesh.

Counterpart of ``repro.distributed.sharding``. Parameters carry *logical*
axis names (each parameter module's ``AXES``, the reference's ``ParamDef``
axes); a rule set maps them to mesh axes, per phase: ``rules_for`` keeps
every table of the reference (train, decode, ``weight_stationary``,
``expert_parallel``, multi-pod, serve), and ``param_pspecs`` /
``cache_pspecs`` / ``batch_pspecs`` turn them into specs. Only the serve
rules drive code here; the other tables are held against the JAX
package's by the tests.

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
"""
from __future__ import annotations

import contextlib
import threading
import types
from typing import Any, Dict, List, Optional, Sequence

import torch

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

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)


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


def gather(x, device=None):
    """A ``Shards`` gathered into one tensor on ``device`` (default: part
    0's): a copy and a concatenation, which move bits and add nothing.
    Tensors pass through (moved to ``device`` if given)."""
    if isinstance(x, Shards):
        device = device or x.parts[0].device
        return torch.cat([p.to(device) for p in x.parts], dim=x.dim)
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


def _put(x, spec: P, mesh: Mesh):
    spec = _divisible_spec(x.shape, spec, mesh)
    cut = [i for i, e in enumerate(spec) if "model" in _names(e)
           and mesh.shape.get("model", 1) > 1]
    rows = [e for e in spec if e is not None and set(_names(e)) - {"model"}]
    if rows and not mesh.rows_share_devices():
        raise NotImplementedError(
            f"{mesh}: rows cut over 'data' on several devices need a storage "
            "per device and a page gather (ROADMAP.md queue 1, item 15)")
    if cut:
        return split(x, cut[0], mesh.column_devices())
    return x.to(mesh.lead)


def shard_put(tree, spec_tree, mesh: Mesh):
    """Lay a tree of tensors (dicts, tuples) out on ``mesh`` by a matching
    tree of ``P`` (see the module docstring), with the divisibility
    fallback."""
    if isinstance(spec_tree, P):
        return _put(unshard(tree), spec_tree, mesh)
    if isinstance(tree, dict):
        return {k: shard_put(v, spec_tree[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, Shards):
        out = [shard_put(v, s, mesh) for v, s in zip(tree, spec_tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    raise TypeError(f"no spec for leaf {type(tree).__name__}")


def unshard(tree, device=None):
    """Every ``Shards`` leaf of a tree gathered into one tensor."""
    return _map(lambda x: gather(x, device), tree,
                lambda x: isinstance(x, (Shards, torch.Tensor)))


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


def place_params(params, rules: dict):
    """The params ``nn.Module`` laid out on ``rules["mesh"]`` by the
    modules' ``AXES`` under ``rules`` (``shard_put`` leaf by leaf).
    Returns a ``Placed`` tree; ``source_params`` gives the module back."""
    mesh = rules["mesh"]

    def place(mod):
        out = {}
        shapes = {n: tuple(t.shape) for n, t in mod.named_parameters(recurse=False)}
        for name, t in mod.named_parameters(recurse=False):
            spec = _axes_to_spec(mod.AXES[name], rules)
            if "wk" in shapes and "wq" in shapes:
                spec = _attention_spec(name, spec, shapes, mesh)
            out[name] = _put(t.detach(), spec, mesh)
        for name, sub in mod.named_children():
            out[name] = ([place(b) for b in sub] if isinstance(sub, torch.nn.ModuleList)
                         else place(sub))
        return Placed(**out)

    placed = place(params)
    placed.__dict__["_source"] = params
    return placed


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
