"""Batch and cache stand-ins of every (arch x shape) dry-run cell, on meta.

Counterpart of ``repro.launch.input_specs``: the same trees (``tokens`` or
``frames``, ``positions``, ``labels`` for train; the ``cache_spec`` tree for
prefill and decode), as (shape, dtype) specs and as ``meta`` tensors. ``rows`` overrides the global batch (the rows one
device holds, when the dry run traces one position).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import transformer as tfm


def batch_specs(cfg, shape, rows: Optional[int] = None) -> Dict[str, Any]:
    """Model inputs of one cell as (shape, dtype)."""
    B = shape.global_batch if rows is None else rows
    S = shape.seq_len if shape.phase != "decode" else 1
    specs = {"positions": ((B, S), torch.int32)}
    if cfg.modality == "audio_frames":
        specs["frames"] = ((B, S, cfg.d_model), tfm.DTYPES[cfg.dtype])
    else:
        specs["tokens"] = ((B, S), torch.int32)
    if shape.phase == "train":
        specs["labels"] = ((B, S), torch.int32)
    return specs


def cache_specs(cfg, shape, rows: Optional[int] = None):
    """The KV / state cache as (shape, dtype) leaves (prefill and decode;
    None for train)."""
    if shape.phase == "train":
        return None
    return tfm.cache_spec(cfg, shape.global_batch if rows is None else rows,
                          shape.seq_len)


def on_meta(tree):
    """A tree of (shape, dtype) specs as ``meta`` tensors."""
    return tfm.tree_map(lambda s: torch.empty(s[0], dtype=s[1], device="meta"), tree)
