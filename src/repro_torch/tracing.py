"""What a tracing dispatch mode may ask of the program as it runs.

The program carries no dry-run code. A ``TorchDispatchMode`` that traces
it (the dry run's cost counter, ``launch/cost.py``) marks itself with
``traces_program = True`` and is found on the current mode stack; with no
such mode every function here is the plain behaviour:

* ``loop(n)``: ``range(n)``. A tracer with ``trip_counts`` runs trip 0
  only and counts it ``n`` times (the microbatch loop), as a ``while``
  body is counted once times its trip count.
* ``one_part()``: whether only part 0 of a leaf's equal parts need be
  computed (the tracer counts one device's work).
* ``collective(kind, nbytes, axes, inputs, output)``: the bytes one device
  receives at a collective point of the program, told to the tracer.
"""
from __future__ import annotations

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def tracer():
    """The innermost tracing mode on the stack, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "traces_program", False):
            return mode
    return None


def loop(n: int):
    t = tracer()
    if t is None or n <= 1:
        yield from range(n)
        return
    yield from t.loop(n)


def one_part() -> bool:
    t = tracer()
    return t is not None and t.one_part


def collective(kind: str, nbytes: float, axes, inputs, output=None):
    t = tracer()
    if t is not None:
        t.collective(kind, nbytes, tuple(axes), inputs, output)
