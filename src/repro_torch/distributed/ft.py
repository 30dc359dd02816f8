"""Fault tolerance for the training loop.

Counterpart of ``repro.distributed.ft``:

- ``FaultTolerantLoop``: checkpoint/restart supervision — run a step
  function, checkpoint every N steps (async, the port's
  ``AsyncCheckpointer``: the reference's on-disk format), and on failure
  restore the latest checkpoint and resume. A restore puts each leaf in
  the dtype of the state it is given, on its device, or, with
  ``run(shardings=...)``, lays it out on that tree's mesh: a restart onto
  another mesh shape (``elastic.make_elastic_mesh``).
- ``Heartbeat``: liveness monitor hook (wall-clock watchdog).
- Data determinism: the data cursor lives in the state, so the skip-ahead
  on restart is automatic.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               latest_step_dir, restore)


@dataclasses.dataclass
class LoopReport:
    steps_run: int
    restarts: int
    final_step: int


class Heartbeat:
    def __init__(self, timeout_s: float = 300.0):
        self.timeout_s = timeout_s
        self._last = time.monotonic()

    def beat(self):
        self._last = time.monotonic()

    @property
    def alive(self) -> bool:
        return time.monotonic() - self._last < self.timeout_s


class FaultTolerantLoop:
    """Supervised step loop with periodic async checkpoints + auto-restart.

    ``step_fn(state, step) -> state``; ``state`` is a tree of tensors
    (dicts, tuples, NamedTuples: what the checkpoint module writes).
    Injected failures (tests) raise from step_fn; the loop restores and
    replays.
    """

    def __init__(self, ckpt_dir: str, step_fn: Callable, *,
                 ckpt_every: int = 20, max_restarts: int = 3):
        self.ckpt_dir = ckpt_dir
        self.step_fn = step_fn
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.ckpt = AsyncCheckpointer(ckpt_dir)
        self.heartbeat = Heartbeat()

    def run(self, state, *, start_step: int = 0, num_steps: int = 100,
            shardings=None) -> tuple:
        step = start_step
        restarts = 0
        steps_run = 0
        if latest_step_dir(self.ckpt_dir) is not None:
            state, step = restore(self.ckpt_dir, state, shardings=shardings)
        while step < num_steps:
            try:
                state = self.step_fn(state, step)
                step += 1
                steps_run += 1
                self.heartbeat.beat()
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state)
            except Exception:  # noqa: BLE001 — supervised restart
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                if latest_step_dir(self.ckpt_dir) is not None:
                    state, step = restore(self.ckpt_dir, state,
                                          shardings=shardings)
                # else: restart from the initial state (step unchanged)
        self.ckpt.save(step, state)
        self.ckpt.wait()
        return state, LoopReport(steps_run, restarts, step)
