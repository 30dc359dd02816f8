"""Kernel launch counts across CUDA graph replays.

Every wrapper adds one to its module's ``launches`` (and, where it has
routes, to ``launches_by_route``) when it launches its kernel. A captured
CUDA graph runs the wrappers' Python code once, at capture, and launches
the kernels on the device at every replay, with no Python in between. So
``captured`` counts what the wrappers launched while a graph was captured
and rolls the counters back (nothing ran on the device then), and
``Replayed.replay`` adds those launches at every replay: the counters keep
meaning launches on the device, graph or eager.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

from repro_torch.kernels import (decode_attention, flash_attention, mlstm_chunk,
                                 paged_decode_attention,
                                 paged_spec_decode_attention, rglru_scan,
                                 spec_decode_attention, spec_scan)

MODULES = {m.__name__.rsplit(".", 1)[1]: m for m in (
    flash_attention, decode_attention, paged_decode_attention,
    spec_decode_attention, paged_spec_decode_attention, spec_scan, rglru_scan,
    mlstm_chunk)}

Key = Tuple[str, str]          # (module, "" for ``launches`` or the route)


def snapshot() -> Dict[Key, int]:
    """Every counter: ``(module, "")`` for ``launches``, ``(module, route)``
    for each entry of ``launches_by_route``."""
    out = {}
    for name, m in MODULES.items():
        out[name, ""] = m.launches
        for route, n in getattr(m, "launches_by_route", {}).items():
            out[name, route] = n
    return out


def add(counts: Dict[Key, int], sign: int = 1):
    """Add ``counts`` (a difference of two snapshots) to the counters."""
    for (name, route), n in counts.items():
        m = MODULES[name]
        if route:
            m.launches_by_route[route] += sign * n
        else:
            m.launches += sign * n


@contextlib.contextmanager
def captured(out: Dict[Key, int]):
    """Around a graph capture: fills ``out`` with the launches the wrappers
    counted inside, then takes them off the counters again."""
    before = snapshot()
    try:
        yield out
    finally:
        after = snapshot()
        out.update({k: after[k] - before[k] for k in after
                    if after[k] != before[k]})
        add(out, -1)


class Replayed:
    """A captured graph (anything with ``replay()``) and the launches its
    capture counted; ``replay`` runs it and counts them again."""

    def __init__(self, graph, launches: Dict[Key, int]):
        self.graph = graph
        self.launches = dict(launches)

    def replay(self):
        self.graph.replay()
        add(self.launches)
