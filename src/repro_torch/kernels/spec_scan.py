"""Accepted-prefix length of speculative decoding: the plain PyTorch
version and its CUDA kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/spec_scan.py::
accept_len`` (source: ``csrc/spec_scan.cu``, entry ``accept_len_fwd``):
``m[b]`` = the number of leading True flags in ``accept[b, :draft_lens[b]]``;
columns at or past ``draft_lens[b]`` are padding and ignored.

``accept_len`` runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launch_counts

launches = 0            # kernel launches (never the plain version)
_fn = None


def accept_len_ref(accept, draft_lens):
    """Plain version: accept [B, S] bool, draft_lens [B] int -> [B] int32."""
    S = accept.shape[1]
    col = torch.arange(S, device=accept.device, dtype=torch.int32)[None, :]
    lens = draft_lens.to(torch.int32)
    bad = ~accept & (col < lens[:, None])
    first_bad = torch.where(bad, col, torch.full_like(col, S)).amin(dim=1)
    return torch.minimum(first_bad, lens).to(torch.int32)


def _kernel():
    global _fn
    if _fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _fn = build.entry("accept_len_fwd", [P, P, P, I, I, P])
    return _fn


def accept_len(accept, draft_lens):
    """Accepted-prefix length (see the module docstring); same contract as
    ``accept_len_ref``."""
    if accept.device.type == "cpu":
        return accept_len_ref(accept, draft_lens)
    return _launch(accept, draft_lens)


@build.op("accept_len", "(Tensor accept, Tensor draft_lens) -> Tensor")
def _launch(accept, draft_lens):
    """The kernel on CUDA tensors (``torch.ops.repro_torch.accept_len``)."""
    if accept.device.type != "cuda":
        raise ValueError(f"accept_len: unsupported device {accept.device}")
    if accept.dim() != 2 or accept.dtype != torch.bool:
        raise ValueError(f"accept_len: accept must be [B, S] bool, got "
                         f"{tuple(accept.shape)} {accept.dtype}")
    B, S = accept.shape
    if draft_lens.shape != (B,) or draft_lens.device != accept.device:
        raise ValueError(f"accept_len: draft_lens {tuple(draft_lens.shape)} on "
                         f"{draft_lens.device} for accept {tuple(accept.shape)}")
    acc = accept.contiguous()
    lens = draft_lens.to(torch.int32).contiguous()
    out = torch.empty(B, dtype=torch.int32, device=accept.device)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(accept.device).cuda_stream
    err = _kernel()(acc.data_ptr(), lens.data_ptr(), out.data_ptr(), B, S, stream)
    build.check(err, "accept_len")
    launch_counts.count(__name__)
    return out
