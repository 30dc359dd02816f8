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

Gradients: when autograd is on and an input requires grad, the call goes
through ``RGLRUScan`` (a ``torch.autograd.Function``, built as
``FlashAttention`` is): its forward is the same call with a float32
``out_dtype`` (one launch; the float32 states are saved for the backward
and ``y`` is rounded to ``out_dtype`` from them), and its backward,
``rglru_scan_bwd``, is the same recurrence run backwards in time on the
same entry point: one more launch. So a layer under remat "full" launches
the kernel three times a microbatch: forward, recompute, reverse scan. On
the CPU both directions run the plain version, so the CPU tests run the
backward the card runs. The JAX package's gradient is XLA's autodiff of
its associative scan (``repro.models.rglru.rglru_scan``).
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


def _wide(x):
    """The state's dtype: float32, or float64 for float64 inputs (the
    reference a float32 result is held to where rounding is the question)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def rglru_scan_ref(a, bx, h0=None, *, out_dtype=torch.float32):
    """Plain version: a sequential loop over S (``kernels/ref.py``'s
    ``rglru_scan``), the state in float32 (float64 for float64 inputs)."""
    B, S, R = a.shape
    wide = _wide(a)
    h = (torch.zeros(B, R, dtype=wide, device=a.device) if h0 is None
         else h0.to(wide))
    ys = torch.empty(B, S, R, dtype=wide, device=a.device)
    af, bf = a.to(wide), bx.to(wide)
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


def rglru_scan_bwd(a, hh, dy, h0=None, dh_last=None):
    """The gradient of the recurrence at ``a`` (and ``h0``), given the
    float32 states after every position ``hh [B, S, R]`` and the gradients
    of ``y`` (``dy``, any float dtype; None: 0) and of ``h_last``
    (``dh_last [B, R]``; None: 0). Returns (da, dbx, dh0) in float32
    (float64 for float64 inputs), dh0 None without ``h0``.

    The same linear recurrence run backwards in time:
    ``dh_t = dy_t + a_{t+1}·dh_{t+1}`` with ``dh_last`` added at t = S-1,
    ``da_t = dh_t·h_{t-1}`` (``h_{-1} = h0``, or 0), ``dbx_t = dh_t`` and
    ``dh0 = a_0·dh_0``. As a forward scan over reversed time u = S-1-t it
    is ``D_u = a'_u·D_{u-1} + g_u`` with ``a' = [1, a_{S-1}, ..., a_1]``,
    ``g = dy`` reversed and the start state ``dh_last``: one call of
    ``_forward`` on contiguous float32 copies (the kernel on the card, on
    the route its S picks; the plain version on the CPU)."""
    B, S, R = a.shape
    wide = _wide(a)
    g = (torch.zeros(B, S, R, dtype=wide, device=a.device) if dy is None
         else dy.to(wide))
    a_rev = torch.cat([torch.ones(B, 1, R, dtype=wide, device=a.device),
                       a.to(wide)[:, 1:].flip(1)], dim=1)
    start = None if dh_last is None else dh_last.to(wide).contiguous()
    d_rev, _ = _forward(a_rev.contiguous(), g.flip(1).contiguous(), start,
                        out_dtype=wide)
    dh = d_rev.flip(1)
    prev = torch.zeros(B, 1, R, dtype=wide, device=a.device) if h0 is None \
        else h0.to(wide)[:, None]
    da = dh * torch.cat([prev, hh.to(wide)[:, :-1]], dim=1)
    dh0 = None if h0 is None else a[:, 0].to(wide) * dh[:, 0]
    return da, dh, dh0


class RGLRUScan(torch.autograd.Function):
    """``rglru_scan`` with a gradient: the forward is the wrapper's call
    with a float32 ``out_dtype`` (the kernel on the card), whose states it
    saves, and the backward ``rglru_scan_bwd`` (one more launch)."""

    @staticmethod
    def forward(ctx, a, bx, h0, out_dtype):
        hh, h_last = _forward(a, bx, h0, out_dtype=_wide(a))
        ctx.save_for_backward(a, hh, h0)
        ctx.bx_dtype = bx.dtype
        ctx.set_materialize_grads(False)
        return hh.to(out_dtype), h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        a, hh, h0 = ctx.saved_tensors
        with torch.profiler.record_function("rglru_scan_bwd"):
            da, dbx, dh0 = rglru_scan_bwd(a, hh, dy, h0, dh_last)
        if h0 is not None:
            dh0 = dh0.to(h0.dtype)
        return da.to(a.dtype), dbx.to(ctx.bx_dtype), dh0, None


def rglru_scan(a, bx, h0=None, *, out_dtype=torch.float32):
    """The recurrence (see the module docstring); same contract as
    ``rglru_scan_ref``. Under autograd, with an input that requires grad,
    it is ``RGLRUScan`` (the same forward, with a backward)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (a, bx, h0)):
        return RGLRUScan.apply(a, bx, h0, out_dtype)
    return _forward(a, bx, h0, out_dtype=out_dtype)


def _forward(a, bx, h0=None, *, out_dtype=torch.float32):
    """The plain version (CPU tensors), or the kernel's operator."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, bx, h0, out_dtype=out_dtype)
    return _launch(a, bx, h0, out_dtype)


@build.op("rglru_scan", "(Tensor a, Tensor bx, Tensor? h0, ScalarType out_dtype) "
          "-> (Tensor, Tensor)")
def _launch(a, bx, h0, out_dtype):
    """The kernel on CUDA tensors (``torch.ops.repro_torch.rglru_scan``)."""
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
