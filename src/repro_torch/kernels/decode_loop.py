"""The decode chunk as one CUDA graph with a conditional while node.

Source ``csrc/decode_loop.cu`` (entries ``decode_loop_build`` /
``_launch`` / ``_destroy``): the graph runs a captured decode step while
``step < nsteps`` and some row is not done, the condition set on the
device after every step, as the reference's ``lax.while_loop`` does
(``src/repro/serving/programs.py``: ``(i < chunk) & any(~done)``). A chunk
is then one graph launch, and it stops once every row is done.

``WhileGraph`` keeps the PyTorch ``CUDAGraph`` of the step alive: it owns
the memory pool whose addresses the loop's copy of the step reads. A
dropped loop is destroyed at the next loop build or launch outside a
capture, never from the garbage collector: a collection can run inside
another graph's capture, where ``cudaGraphExecDestroy`` fails with
cudaErrorStreamCaptureUnsupported and invalidates that capture (shown on
the card by ``tests/test_torch_gpu.py``:
``test_gpu_dropped_while_graph_inside_a_capture``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_fns = {}
_dropped = []           # (executable, step graph) of loops no longer held


def _entry(name, argtypes):
    if name not in _fns:
        _fns[name] = build.entry(name, argtypes)
    return _fns[name]


def _destroy_dropped():
    """Destroy the dropped loops (outside any capture on this thread)."""
    if torch.cuda.is_current_stream_capturing():
        return
    while _dropped:
        exec_, _ = _dropped.pop()
        build.check(_entry("decode_loop_destroy", [ctypes.c_void_p])(exec_),
                    "decode_loop_destroy")


class WhileGraph:
    """``step_graph`` (a ``torch.cuda.CUDAGraph`` captured with
    ``keep_graph=True``) looped on the device over the buffers ``step``
    (int64 [1]), ``nsteps`` (int32 [1]) and ``done`` (bool [rows])."""

    def __init__(self, step_graph, step, nsteps, done):
        _destroy_dropped()
        P = ctypes.c_void_p
        fn = _entry("decode_loop_build", [P, P, P, P, ctypes.c_int, P])
        exec_ = P()
        err = fn(step_graph.raw_cuda_graph(), step.data_ptr(), nsteps.data_ptr(),
                 done.data_ptr(), done.numel(), ctypes.byref(exec_))
        build.check(err, "decode_loop_build")
        self.step_graph = step_graph
        self.buffers = (step, nsteps, done)
        self._exec = exec_
        self.device = step.device

    def launch(self):
        _destroy_dropped()
        fn = _entry("decode_loop_launch", [ctypes.c_void_p, ctypes.c_void_p])
        stream = torch.cuda.current_stream(self.device).cuda_stream
        build.check(fn(self._exec, stream), "decode_loop_launch")

    def __del__(self, _dropped=_dropped):  # the list, even at interpreter exit
        if getattr(self, "_exec", None):
            _dropped.append((self._exec, self.step_graph))
            self._exec = None
