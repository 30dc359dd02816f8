"""Kernel launch counts, by thread and across CUDA graph replays.

Every wrapper calls ``count(__name__, route)`` where it launches its
kernel: one more in its module's ``launches`` and, where the kernel has
routes, in ``launches_by_route[route]``. Every change of a counter takes
one lock, so pumps of several servers on one card lose no increment.

A captured CUDA graph runs the wrappers' Python code once, at capture, and
launches the kernels on the device at every replay, with no Python in
between. So while a thread captures (``captured``), that thread's counts go
into the capture's record and not into the counters (nothing ran on the
device then), and ``Replayed.replay`` adds the record at every replay: the
counters keep meaning launches on the device, graph or eager. The record
is the capturing thread's own: launches that other threads make during the
capture (another server's eager admission) count as they happen and never
enter the graph's record.
"""
from __future__ import annotations

import contextlib
import importlib
import threading
from typing import Dict, Optional, Tuple

NAMES = ("flash_attention", "decode_attention", "paged_decode_attention",
         "spec_decode_attention", "paged_spec_decode_attention", "spec_scan",
         "rglru_scan", "mlstm_chunk", "split_decode", "slstm_scan")

Key = Tuple[str, str]          # (module, "" for ``launches`` or the route)

_lock = threading.Lock()
_local = threading.local()     # ``record``: the open capture's counts


def _module(name: str):
    return importlib.import_module(f"repro_torch.kernels.{name}")


def count(module: str, route: Optional[str] = None):
    """One launch of the kernel of ``module`` (a wrapper's ``__name__``)
    on ``route``: into the calling thread's open capture record, or else
    into the counters."""
    name = module.rsplit(".", 1)[-1]
    keys = [(name, "")] + ([(name, route)] if route is not None else [])
    rec = getattr(_local, "record", None)
    if rec is not None:
        for k in keys:
            rec[k] = rec.get(k, 0) + 1
        return
    add(dict.fromkeys(keys, 1))


def expected(steps: int, shards_by_layer) -> int:
    """The launches of a kernel that each layer of ``shards_by_layer`` runs
    once a step, over ``steps`` steps: ``layers x steps`` on one device;
    on a mesh each layer launches once a step on every shard that runs it
    (``EnginePrograms.launch_shards``: "data" shards times the "model"
    shards of the layer's mixer), so ``steps x sum(shards_by_layer)``."""
    return steps * sum(shards_by_layer)


def snapshot() -> Dict[Key, int]:
    """Every counter: ``(module, "")`` for ``launches``, ``(module, route)``
    for each entry of ``launches_by_route``."""
    out = {}
    with _lock:
        for name in NAMES:
            m = _module(name)
            out[name, ""] = m.launches
            for route, n in getattr(m, "launches_by_route", {}).items():
                out[name, route] = n
    return out


def add(counts: Dict[Key, int], sign: int = 1):
    """Add ``counts`` (e.g. a difference of two snapshots) to the counters."""
    with _lock:
        for (name, route), n in counts.items():
            m = _module(name)
            if route:
                m.launches_by_route[route] += sign * n
            else:
                m.launches += sign * n


def reset():
    """Every counter to 0."""
    with _lock:
        for name in NAMES:
            m = _module(name)
            m.launches = 0
            for route in getattr(m, "launches_by_route", {}):
                m.launches_by_route[route] = 0


@contextlib.contextmanager
def captured(out: Dict[Key, int]):
    """Around a graph capture: the calling thread's launches inside go into
    ``out`` instead of the counters. Other threads count as before."""
    prev = getattr(_local, "record", None)
    _local.record = out
    try:
        yield out
    finally:
        _local.record = prev


class Replayed:
    """A captured graph (anything with ``replay()``) and the launches its
    capture counted; ``replay`` runs it and counts them again."""

    def __init__(self, graph, launches: Dict[Key, int]):
        self.graph = graph
        self.launches = dict(launches)

    def replay(self):
        self.graph.replay()
        add(self.launches)
