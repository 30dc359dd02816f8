"""RG-LRU linear recurrence: the plain PyTorch version and its CUDA kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/rglru_scan.py::
rglru_scan`` (source: ``csrc/rglru_scan.cu``, entry ``rglru_scan_fwd``):
``h_t = a_t * h_{t-1} + bx_t`` over ``[B, S, R]`` with a float32 state.

Contract: ``a``, ``bx`` float32 (``_gates`` of the conv output, padding
masked to ``a = 1, bx = 0``), optional ``h0 [B, R]`` float32; returns
``y [B, S, R]`` in ``out_dtype`` and ``h_last [B, R]`` float32, the state
after the last position. This follows the JAX package's default XLA path
(``models/rglru.py:82-103``: float32 gates, ``h_last`` from the float32
scan), not its Pallas path, which rounds ``a``/``bx`` to the activation
dtype and re-widens ``y[:, -1]``; the two agree in float32. A float32
``out_dtype`` makes ``y`` the all-states record of the verify step.

Two routes, chosen by S at the C entry point; ``launches_by_route`` counts
each. ``"chunked"`` (S > ``SHORT_S``: prefill and long extends) splits S
into tiles of ``T`` steps x ``CH`` channels that compose the affine pairs
``(a, b)`` and take their carry-in by decoupled look-back over per-tile
flags (``scan_plan`` gives the tiles and the scratch this wrapper
allocates); ``"sequential"`` (verify and short extends) loops over S in one
thread per channel.

``rglru_scan`` runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launch_counts
from repro_torch.kernels.flash_attention import DTYPES

# csrc/rglru_scan.cu's constexpr values
SHORT_S = 64        # the longest S on the sequential route
SEG = 16            # chunked route: steps of a warp's segment
NW = 8              # segments of a tile
T = SEG * NW        # steps of a tile
CH = 32             # channels of a tile

# Under autograd a CUDA launch raises (``build.refuse_grad``); the plain
# version on the CPU runs under autograd as it is.
BACKWARD = "its backward, the same recurrence in reverse, is ROADMAP.md queue 2 item 9"

launches = 0            # kernel launches (never the plain version)
launches_by_route = {"chunked": 0, "sequential": 0}
_fn = None


def scan_plan(B: int, S: int, R: int) -> dict:
    """The route for ``[B, S, R]`` and, on the chunked route, its tiles and
    scratch: int32 flags (one per tile, then the ticket counter; zeroed each
    call) and float32 ``agg [ntiles, 3, CH]`` (a tile's aggregate pair and
    the state after it)."""
    if S <= SHORT_S:
        return dict(route="sequential", ntiles=0, scratch={})
    ntiles = B * -(-R // CH) * -(-S // T)
    return dict(route="chunked", ntiles=ntiles,
                scratch={"flags": (ntiles + 1,), "agg": (ntiles, 3, CH)})


def rglru_scan_ref(a, bx, h0=None, *, out_dtype=torch.float32):
    """Plain version: a sequential loop over S (``kernels/ref.py``'s
    ``rglru_scan``), the state in float32."""
    B, S, R = a.shape
    h = (torch.zeros(B, R, dtype=torch.float32, device=a.device) if h0 is None
         else h0.float())
    ys = torch.empty(B, S, R, dtype=torch.float32, device=a.device)
    af, bf = a.float(), bx.float()
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        ys[:, t] = h
    return ys.to(out_dtype), h


def _kernel():
    global _fn
    if _fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _fn = build.entry("rglru_scan_fwd", [P] * 7 + [I, I, I, I, P])
    return _fn


def rglru_scan(a, bx, h0=None, *, out_dtype=torch.float32):
    """The recurrence (see the module docstring); same contract as
    ``rglru_scan_ref``."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, bx, h0, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    if a.dim() != 3 or bx.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} / bx {tuple(bx.shape)} "
                         "must be one [B, S, R] shape")
    B, S, R = a.shape
    if a.dtype != torch.float32 or bx.dtype != torch.float32:
        raise ValueError(f"rglru_scan: a, bx must be float32, got {a.dtype}/{bx.dtype}")
    if h0 is not None and (h0.shape != (B, R) or h0.dtype != torch.float32):
        raise ValueError(f"rglru_scan: h0 must be [{B}, {R}] float32, got "
                         f"{tuple(h0.shape)} {h0.dtype}")
    if out_dtype not in DTYPES:
        raise ValueError(f"rglru_scan: out_dtype {out_dtype}")
    tensors = (a, bx) + (() if h0 is None else (h0,))
    build.refuse_grad("rglru_scan", BACKWARD, *tensors)
    if any(t.device != a.device for t in tensors):
        raise ValueError("rglru_scan: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rglru_scan: inputs must be contiguous")
    y = torch.empty(B, S, R, dtype=out_dtype, device=a.device)
    h_last = torch.empty(B, R, dtype=torch.float32, device=a.device)
    if B == 0 or R == 0:
        return y, h_last
    if S == 0:
        return y, (h_last.zero_() if h0 is None else h_last.copy_(h0))
    plan = scan_plan(B, S, R)
    flags = agg = None
    if plan["route"] == "chunked":
        flags = torch.zeros(plan["scratch"]["flags"], dtype=torch.int32, device=a.device)
        agg = torch.empty(plan["scratch"]["agg"], dtype=torch.float32, device=a.device)
    ptr = (lambda t: None if t is None else t.data_ptr())       # noqa: E731
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _kernel()(a.data_ptr(), bx.data_ptr(), ptr(h0), y.data_ptr(),
                    h_last.data_ptr(), ptr(flags), ptr(agg), B, S, R,
                    DTYPES[out_dtype], stream)
    build.check(err, "rglru_scan")
    launch_counts.count(__name__, plan["route"])
    return y, h_last
