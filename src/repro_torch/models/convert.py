"""Carry weights between the JAX package's parameter tree and the port.

``params_from_jax(tree, cfg)`` turns the JAX parameter pytree — given as
(nested dicts of) numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``,
or of tensors — into the port's state dict; ``params_to_jax(state_dict,
cfg)`` is its inverse. The JAX tree is ``embed/table``, optional
``unembed/table``, ``scan/sub<i>/...`` stacked ``[num_scan_groups, ...]``
(``transformer.model_defs``), ``tail<j>/...`` and ``final_norm``; every
leaf keeps its layout, so the state dict is the same numbers under the
port's names (``blocks.<layer>.attn.wq`` ...). ``jax_layout(cfg)`` lists
that tree's leaves in ``jax.tree.flatten`` order, derived from the port's
own parameter modules: both directions and the checkpoint reader
(``Model.restore``) go through it. Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as tfm


def _tensor(a, dtype: Optional[str] = None) -> torch.Tensor:
    """A leaf as a tensor (tensors pass through). bfloat16 goes through
    its 2-byte words: an ml_dtypes bfloat16 array, or the ``|V2`` void
    array ``np.load`` gives back for one when ``dtype`` (a checkpoint
    manifest's) says ``"bfloat16"``."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _array(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bfloat16 as its 2-byte words (``V2``), the
    inverse of ``_tensor``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def jax_layout(cfg) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """The JAX parameter tree of ``cfg`` as (path, shape) pairs in
    ``jax.tree.flatten`` order (dict keys sorted at every level), from the
    port's own parameter modules on the meta device: the scanned blocks of
    pattern position i stacked ``[num_scan_groups, ...]`` under
    ``scan/sub<i>``, the tail blocks under ``tail<j>``."""
    meta = dict(device="meta", dtype=torch.float32)
    out = {}

    def add(prefix, mod, stack=()):
        for name, p in mod.named_parameters():
            out[prefix + tuple(name.split("."))] = stack + tuple(p.shape)

    for name, mod in tfm.TransformerParams(cfg, **meta).named_children():
        if name != "blocks":
            add((name,), mod)
    for i, kind in enumerate(cfg.pattern):
        add(("scan", f"sub{i}"), tfm.Block(cfg, kind, **meta),
            (cfg.num_scan_groups,))
    for j, kind in enumerate(cfg.tail_kinds):
        add((f"tail{j}",), tfm.Block(cfg, kind, **meta))
    return sorted(out.items())


def _port_names(path, cfg) -> List[str]:
    """The port's state-dict names of a JAX leaf: one a layer for a
    ``scan`` leaf (its stack axis in order), else one."""
    P, G = len(cfg.pattern), cfg.num_scan_groups
    if path[0] == "scan":
        i = int(path[1][len("sub"):])
        return [f"blocks.{g * P + i}." + ".".join(path[2:]) for g in range(G)]
    if path[0].startswith("tail"):
        j = int(path[0][len("tail"):])
        return [f"blocks.{G * P + j}." + ".".join(path[1:])]
    return [".".join(path)]


def nest(pairs) -> Dict[str, Any]:
    """A nested dict from (path, leaf) pairs."""
    tree: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def params_from_jax(tree, cfg) -> Dict[str, torch.Tensor]:
    """JAX params pytree (numpy or tensor leaves) -> the port's state dict
    (a scanned leaf's layers are views of its stack)."""
    out: Dict[str, torch.Tensor] = {}
    for path, shape in jax_layout(cfg):
        leaf = _tensor(_get(tree, path))
        if tuple(leaf.shape) != shape:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(leaf.shape)}, "
                             f"{cfg.name} has {shape}")
        names = _port_names(path, cfg)
        if path[0] == "scan":
            out.update(zip(names, leaf.unbind(0)))
        else:
            out[names[0]] = leaf
    return out


def params_to_jax(state_dict, cfg) -> Dict[str, Any]:
    """The port's state dict -> the JAX params pytree (tensor leaves on the
    state dict's device): the inverse of ``params_from_jax``."""
    pairs = []
    for path, shape in jax_layout(cfg):
        names = _port_names(path, cfg)
        if path[0] != "scan":
            pairs.append((path, state_dict[names[0]]))
        elif names:
            pairs.append((path, torch.stack([state_dict[n] for n in names])))
        else:                                   # no whole pattern period
            ref = next(iter(state_dict.values()))
            pairs.append((path, ref.new_empty(shape)))
    return nest(pairs)
