"""Elastic scaling: re-derive the mesh from the surviving devices and lay a
restored tree out on it.

Counterpart of ``repro.distributed.elastic``. On node loss the job
restarts on fewer devices: ``best_mesh_shape`` picks the largest valid
(data, model) grid of the surviving count, keeping the "model" width a
power of two that divides it; ``reshard_tree`` lays a host (or otherwise
laid out) tree out on the new mesh. With ``checkpoint.restore(shardings=
...)`` and ``FaultTolerantLoop.run(shardings=...)`` the same checkpoint
restores onto any mesh.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from repro_torch.distributed.mesh import Mesh, make_test_mesh
from repro_torch.distributed.sharding import P, shard_put


def best_mesh_shape(n_devices: int, *, model_parallel: int = 16,
                    min_model: int = 1) -> Tuple[int, int]:
    """Largest (data, model) grid for n_devices, preferring the target
    "model" width and degrading (16 -> 8 -> 4 ...) when devices are lost."""
    tp = 1
    while tp * 2 <= min(model_parallel, n_devices):
        tp *= 2                                   # largest power-of-two width
    while tp > min_model and n_devices % tp:
        tp //= 2
    tp = max(tp, min_model)
    return (n_devices // tp, tp)


def make_elastic_mesh(devices: Sequence, *, model_parallel: int = 16) -> Mesh:
    """The ``best_mesh_shape`` mesh over ``devices`` (a list; one device
    may be listed more than once)."""
    devices = list(devices)
    shape = best_mesh_shape(len(devices), model_parallel=model_parallel)
    return make_test_mesh(shape, ("data", "model"), devices)


def reshard_tree(tree, mesh: Mesh, pspec_tree):
    """Lay ``tree`` (dicts, tuples; tensors or ``Shards`` of another mesh)
    out on ``mesh`` by a matching tree of ``P`` (``sharding.shard_put``)."""
    return shard_put(tree, pspec_tree, mesh)

