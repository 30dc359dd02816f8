"""Device meshes of the port: named axes over ``torch.device``s.

Counterpart of ``repro.launch.mesh``. A ``Mesh`` is an array of devices
with one name per axis, ("data", "model") by default; ``mesh.shape`` maps
each name to its extent, as a JAX mesh's does. One process drives every
device of the mesh (the reference's single controller): a leaf laid out
on it is its per-shard tensors (``sharding.Shards``), and each shard's
kernels launch on its device.

A mesh may list one device more than once, as ``XLA_FLAGS=--xla_force_host_
platform_device_count=8`` makes eight devices of one CPU: the CPU tests
run a (2, 4) mesh on ``"cpu"``, and one card runs the sharded path with its
real kernels on ``"cuda:0"``. The production meshes of the reference (TPU
pod slices) and its TPU roofline constants have no counterpart here.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

AXES = ("pod", "data", "model")


def canonical(device) -> torch.device:
    """``device`` resolved as the entry points resolve it, with the current
    card's index filled in (``cuda`` and ``cuda:0`` are then one device)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """``devices``: an array (nested sequences) of devices, one axis per
    name in ``axis_names``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        flat = [canonical(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        shape = np.asarray(devices, dtype=object).shape
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh of shape {shape} with axes {tuple(axis_names)}")
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """The first device: where replicated work runs and gathers land."""
        return self.devices.flat[0]

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        return tuple(dict.fromkeys(self.devices.flat))

    def extent(self, axes) -> int:
        """The product of the extents of ``axes`` (names; absent ones 1)."""
        return math.prod(self.shape.get(a, 1) for a in axes)

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The device of each position along ``axis`` (the first along the
        other axes)."""
        if axis not in self.shape:
            return (self.lead,)
        ax = self.axis_names.index(axis)
        return tuple(np.moveaxis(self.devices, ax, -1).reshape(-1, self.shape[axis])[0])

    def column_devices(self) -> Tuple[torch.device, ...]:
        """Where a leaf's parts over "model" live."""
        return self.axis_devices("model")

    def rows_share_devices(self) -> bool:
        """Whether every "model" position holds one device along the other
        axes: then rows cut over "data" (and "pod") are views of one
        storage per position, which is how the port lays them out."""
        if "model" not in self.shape:
            return len(self.distinct_devices()) == 1
        ax = self.axis_names.index("model")
        cols = np.moveaxis(self.devices, ax, -1).reshape(-1, self.shape["model"])
        return all(len(set(cols[:, j])) == 1 for j in range(cols.shape[1]))

    def __repr__(self):
        devs = ",".join(str(d) for d in self.distinct_devices())
        return f"Mesh({self.shape}, devices=[{devs}])"


def make_host_mesh(device="cuda") -> Mesh:
    """The degenerate 1x1 mesh over one device (the unsharded default)."""
    return Mesh([[device]], ("data", "model"))


def make_test_mesh(shape=(2, 4), axis_names=None, devices="cuda") -> Mesh:
    """A mesh of explicit shape. Axis names default to the reference's
    convention, right-aligned: 2 axes -> ("data", "model"), 3 -> ("pod",
    "data", "model"). ``devices``: one device, repeated over the mesh (the
    CPU tests and one card), or a sequence holding at least as many devices
    as the mesh has positions (the first ones are taken)."""
    if axis_names is None:
        axis_names = AXES[-len(shape):]
    need = math.prod(shape)
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * need
    devices = list(devices)
    if len(devices) < need:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {need} devices but {len(devices)} were "
            f"given (device_count); list one device more than once to share it")
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names))
