"""H100 production meshes and the card's published peaks.

Counterpart of ``repro.launch.mesh``. The reference lays its cells out on
TPU pod slices of 256 and 512 chips; ``make_production_mesh`` keeps those
device counts and shapes them for DGX H100 hosts: "model" over the 8
NVLink-connected cards of one host, "data" over hosts (32 x 8 = 256), and
("pod", "data", "model") = (2, 32, 8) = 512 with ``multi_pod``. Any shape
may be asked for instead (``shape=(16, 16)`` is the reference's own grid,
for a cell-for-cell comparison). The devices are ``meta``: a mesh of 256
cards never exists here, and a dry run only traces shapes.
"""
from __future__ import annotations

import math

from repro_torch.distributed.mesh import AXES, Mesh, make_test_mesh

# NVIDIA H100 SXM, per card (data sheet; dense rates, no sparsity)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
HBM_BYTES = 80e9                # 80 GB of HBM3
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 450e9               # bytes/s each way, NVLink 4 (18 links)
# between hosts: the DGX H100 layout, one 400 Gb/s NDR InfiniBand NIC a card
IB_BW = 50e9                    # bytes/s each way
CARDS_PER_HOST = 8


def make_production_mesh(*, multi_pod: bool = False, shape=None) -> Mesh:
    """(32, 8) ("data", "model"), or (2, 32, 8) ("pod", "data", "model")
    with ``multi_pod``; ``shape`` overrides it (axis names right-aligned).
    Every position is the ``meta`` device."""
    if shape is None:
        shape = (2, 32, CARDS_PER_HOST) if multi_pod else (32, CARDS_PER_HOST)
    shape = tuple(shape)
    return make_test_mesh(shape, AXES[-len(shape):], devices="meta")


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def devices(mesh: Mesh) -> int:
    return math.prod(mesh.shape.values())
