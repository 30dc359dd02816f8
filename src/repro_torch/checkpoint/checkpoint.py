"""Checkpoints in the JAX package's on-disk format, read and written
without JAX.

Counterpart of ``repro.checkpoint.checkpoint``. A checkpoint directory
holds ``step_%08d`` directories (written as ``.tmp-<step>`` and published
by an atomic rename), a ``latest`` file naming the newest one, and at most
``keep`` of them. A step directory holds ``manifest.msgpack`` (``step``,
the tree's ``treedef`` string as JAX prints it, and each leaf's ``shape``
and ``dtype``) and one ``leaf_%05d.npy`` per leaf, in ``jax.tree.flatten``
order: dict keys sorted at every level, tuple and NamedTuple fields in
order, ``None`` no leaf. A bfloat16 leaf is stored as its 2-byte words
with the ``<V2`` header an ml_dtypes array gets from ``np.save``, and read
back by the manifest's ``"bfloat16"``.

Trees are nested dicts, tuples and NamedTuples (``OptState``, the
optimizer state ``examples/train_lm.py`` saves beside its params) of
tensors. The manifest goes through ``msgpack_lite``, so nothing here
needs the ``msgpack`` package.
"""
from __future__ import annotations

import concurrent.futures
import os
import shutil
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_lite
from repro_torch.distributed.sharding import _put, gather
from repro_torch.models.convert import _array, _tensor


class OptState(NamedTuple):
    """AdamW state of the JAX package's trainer: a scalar int32 step and
    the first and second moments, float32 trees shaped like the params."""
    step: Any
    m: Any
    v: Any


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree) -> Tuple[List[Any], str]:
    """(leaves, treedef string) as ``jax.tree.flatten`` gives them and
    ``str(treedef)`` prints them."""
    leaves: List[Any] = []

    def walk(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if _is_namedtuple(t):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(walk(v) for v in t) + "])")
        if isinstance(t, tuple):
            inner = ", ".join(walk(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        leaves.append(t)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def unflatten(like, leaves):
    """The structure of ``like`` with ``leaves`` (in flatten order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, tuple):
            return tuple(build(v) for v in t)
        return next(it)

    return build(like)


def _dtype_name(leaf: torch.Tensor) -> str:
    return str(leaf.dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------


def _write_leaf(path: str, leaf: torch.Tensor):
    arr = _array(leaf)
    with open(path, "wb") as f:
        if _dtype_name(leaf) == "bfloat16":
            # the header np.save writes for an ml_dtypes bfloat16 array
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": arr.shape})
            f.write(np.ascontiguousarray(arr).tobytes())
        else:
            np.save(f, arr)


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomic synchronous save. Returns the step directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    leaves, treedef = flatten(tree)
    leaves = [gather(leaf) for leaf in leaves]  # a mesh's Shards, whole
    manifest = {"step": step, "treedef": treedef,
                "leaves": [{"shape": list(leaf.shape),
                            "dtype": _dtype_name(leaf)} for leaf in leaves]}
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(msgpack_lite.packb(manifest))
    for i, leaf in enumerate(leaves):
        _write_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), leaf)
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)                       # atomic publish
    with open(os.path.join(ckpt_dir, "latest"), "w") as f:
        f.write(os.path.basename(final))
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


class AsyncCheckpointer:
    """Background-thread save (compute keeps running while IO drains)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[concurrent.futures.Future] = None

    def save(self, step: int, tree):
        self.wait()
        # snapshot to host BEFORE backgrounding so later updates don't race
        leaves, _ = flatten(tree)
        host_tree = unflatten(tree, [gather(leaf).detach().to("cpu", copy=True)
                                     for leaf in leaves])
        self._pending = self._pool.submit(save, self.ckpt_dir, step, host_tree,
                                          keep=self.keep)

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------


def latest_step_dir(ckpt_dir: str) -> Optional[str]:
    p = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        d = os.path.join(ckpt_dir, f.read().strip())
    return d if os.path.isdir(d) else None


def _latest(ckpt_dir: str) -> Tuple[str, dict]:
    d = latest_step_dir(ckpt_dir)
    if d is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        return d, msgpack_lite.unpackb(f.read())


def _read_leaf(step_dir: str, i: int, manifest, shape) -> torch.Tensor:
    """Leaf ``i`` as a host tensor, checked against ``shape``."""
    with open(os.path.join(step_dir, f"leaf_{i:05d}.npy"), "rb") as f:
        arr = np.load(f)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{step_dir} leaf {i}: shape {tuple(arr.shape)}, "
                         f"expected {tuple(shape)}")
    return _tensor(arr, manifest["leaves"][i]["dtype"])


def restore(ckpt_dir: str, like_tree, *, shardings=None) -> Tuple[Any, int]:
    """Restore the latest checkpoint into the structure of ``like_tree``
    (tensors, or ``Shards`` of a mesh): leaf count and shapes are checked
    against it, and each leaf is cast to its like leaf's dtype, on its
    device. ``shardings``: a matching tree of ``sharding.NamedSharding``s
    of the CURRENT mesh; each leaf is then laid out on it (``shard_put``:
    an elastic restore onto another device count; FSDP parts where the
    sharding says ``fsdp``). Returns (tree, step)."""
    d, manifest = _latest(ckpt_dir)
    like, _ = flatten(like_tree)
    if len(like) != len(manifest["leaves"]):
        raise ValueError(f"{d}: {len(manifest['leaves'])} leaves, the tree "
                         f"has {len(like)} (tree structure changed)")
    shards = flatten(shardings)[0] if shardings is not None else [None] * len(like)
    if len(shards) != len(like):
        raise ValueError(f"{len(shards)} shardings for {len(like)} leaves")
    out = []
    for i, (ref, sh) in enumerate(zip(like, shards)):
        leaf = _read_leaf(d, i, manifest, ref.shape).to(dtype=ref.dtype)
        out.append(leaf.to(ref.device) if sh is None
                   else _put(leaf, sh.spec, sh.mesh, sh.fsdp))
    return unflatten(like_tree, out), manifest["step"]


def restore_params(ckpt_dir: str, params_like) -> Tuple[Any, int]:
    """The params of the latest checkpoint, written either as the params
    tree alone or as the ``(params, OptState)`` pair a training run saves
    (then only its first element is read). The two are told apart by the
    manifest's treedef string, leaf count and shapes against
    ``params_like`` (a tree of anything with ``.shape``); anything else is
    refused. Leaves come back as host tensors in the checkpoint's dtype.
    Returns (tree, step)."""
    d, manifest = _latest(ckpt_dir)
    like, treedef = flatten(params_like)
    n = len(like)
    shapes = [tuple(ref.shape) for ref in like]
    found = [tuple(leaf["shape"]) for leaf in manifest["leaves"]]
    _, pair = flatten((params_like, OptState(step=0, m=params_like,
                                             v=params_like)))
    if manifest["treedef"] == treedef and found == shapes:
        pass
    elif manifest["treedef"] == pair and found == shapes + [()] + 2 * shapes:
        pass
    else:
        raise ValueError(
            f"{d} holds neither the params ({n} leaves) nor the (params, "
            f"OptState) pair ({3 * n + 1} leaves) of this model: found "
            f"{len(found)} leaves, treedef {manifest['treedef'][:200]!r}")
    out = [_read_leaf(d, i, manifest, s) for i, s in enumerate(shapes)]
    return unflatten(params_like, out), manifest["step"]
