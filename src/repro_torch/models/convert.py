"""Carry weights from the JAX package into the port.

``params_from_jax(tree, cfg)`` turns the JAX parameter pytree — given as
(nested dicts of) numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``
— into the port's state dict. The JAX tree is ``embed/table``, optional
``unembed/table``, ``scan/sub<i>/...`` stacked ``[num_scan_groups, ...]``
(``transformer.model_defs``), ``tail<j>/...`` and ``final_norm``; every
leaf keeps its layout, so the state dict is the same numbers under the
port's names (``blocks.<layer>.attn.wq`` ...). Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = v


def params_from_jax(tree, cfg) -> Dict[str, torch.Tensor]:
    """JAX params pytree (numpy leaves) -> the port's state dict."""
    out: Dict[str, np.ndarray] = {}
    _flatten({"embed": tree["embed"], "final_norm": tree["final_norm"]}, "", out)
    if "unembed" in tree:
        _flatten({"unembed": tree["unembed"]}, "", out)
    P = len(cfg.pattern)
    for layer in range(cfg.num_layers):
        g, i = divmod(layer, P)
        flat: Dict[str, np.ndarray] = {}
        if g < cfg.num_scan_groups:
            _flatten(tree["scan"][f"sub{i}"], "", flat)
            flat = {k: np.asarray(v)[g] for k, v in flat.items()}
        else:
            _flatten(tree[f"tail{layer - cfg.num_scan_groups * P}"], "", flat)
        for k, v in flat.items():
            out[f"blocks.{layer}.{k}"] = v
    return {k: _tensor(v) for k, v in out.items()}
