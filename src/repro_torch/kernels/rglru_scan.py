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
``FlashAttention`` is): its forward is one launch that writes ``y`` in
``out_dtype`` and, beside it, the float32 states the backward reads (a
float32 ``y`` is those states); its backward is ``rglru_scan_bwd``, the
gradient kernel (C entry ``rglru_scan_bwd``, operator
``torch.ops.repro_torch.rglru_scan_bwd``): the recurrence run backwards in
time in one launch, on ``"chunked_bwd"`` (S > ``SHORT_S``: the forward's
tiles, taking their tickets in reverse time order, each tile's carry its
predecessor's published state, so two calls give the same bits) or
``"sequential_bwd"`` (one thread per channel walking t down). So a layer
under remat "full" launches the kernel three times a microbatch: forward,
recompute, backward. On the CPU both directions run the plain versions
(``rglru_scan_ref``, ``rglru_scan_bwd_ref``); the card never runs them.
The JAX package's gradient is XLA's autodiff of its associative scan
(``repro.models.rglru.rglru_scan``).
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
launches_by_route = dict.fromkeys(("chunked", "sequential", "chunked_bwd",
                                   "sequential_bwd"), 0)
_fn = None
_bwd_fn = None

_P, _I = ctypes.c_void_p, ctypes.c_int
FWD_ARGTYPES = [_P] * 8 + [_I] * 4 + [_P]
BWD_ARGTYPES = [_P] * 9 + [_I] * 4 + [_P]


def scan_plan(B: int, S: int, R: int, backward: bool = False) -> dict:
    """The route for ``[B, S, R]`` and, on the chunked route, its tiles and
    the scratch this wrapper allocates (the C entry zeroes it before each
    launch). Forward: int32 ``flags`` (one per tile, then the ticket
    counter) and float32 ``agg [ntiles, 3, CH]`` (a tile's aggregate pair
    and the state after it). ``backward``: 64-bit ``carry`` words, one per
    tile and channel (the gradient of the state before the tile's first
    step, which the tile before it reads, with its published bit), then the
    ticket counter."""
    suffix = "_bwd" if backward else ""
    if S <= SHORT_S:
        return dict(route="sequential" + suffix, ntiles=0, scratch={})
    ntiles = B * -(-R // CH) * -(-S // T)
    scratch = ({"carry": (ntiles * CH + 1,)} if backward
               else {"flags": (ntiles + 1,), "agg": (ntiles, 3, CH)})
    return dict(route="chunked" + suffix, ntiles=ntiles, scratch=scratch)


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


def rglru_scan_bwd_ref(a, hh, dy, h0=None, dh_last=None):
    """Plain version of the gradient (the CPU's; the tests' reference):
    the same linear recurrence run backwards in time,
    ``dh_t = dy_t + a_{t+1}·dh_{t+1}`` with ``dh_last`` added at t = S-1,
    ``da_t = dh_t·h_{t-1}`` (``h_{-1} = h0``, or 0), ``dbx_t = dh_t`` and
    ``dh0 = a_0·dh_0``. As a forward scan over reversed time u = S-1-t it
    is ``D_u = a'_u·D_{u-1} + g_u`` with ``a' = [1, a_{S-1}, ..., a_1]``,
    ``g = dy`` reversed and the start state ``dh_last``: ``rglru_scan_ref``
    on reversed, shifted copies. Same contract as ``rglru_scan_bwd``."""
    B, S, R = a.shape
    wide = _wide(a)
    g = (torch.zeros(B, S, R, dtype=wide, device=a.device) if dy is None
         else dy.to(wide))
    a_rev = torch.cat([torch.ones(B, 1, R, dtype=wide, device=a.device),
                       a.to(wide)[:, 1:].flip(1)], dim=1)
    start = None if dh_last is None else dh_last.to(wide)
    d_rev, _ = rglru_scan_ref(a_rev, g.flip(1), start, out_dtype=wide)
    dh = d_rev.flip(1)
    prev = torch.zeros(B, 1, R, dtype=wide, device=a.device) if h0 is None \
        else h0.to(wide)[:, None]
    da = dh * torch.cat([prev, hh.to(wide)[:, :-1]], dim=1)
    dh0 = None if h0 is None else a[:, 0].to(wide) * dh[:, 0]
    return da, dh, dh0


def _kernel():
    global _fn
    if _fn is None:
        _fn = build.entry("rglru_scan_fwd", FWD_ARGTYPES)
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        _bwd_fn = build.entry("rglru_scan_bwd", BWD_ARGTYPES)
    return _bwd_fn


def rglru_scan_bwd(a, hh, dy, h0=None, dh_last=None):
    """The gradient of the recurrence at ``a`` (and ``h0``), given the
    float32 states after every position ``hh [B, S, R]`` and the gradients
    of ``y`` (``dy``, any float dtype on the CPU, bf16 or float32 on the
    card; None: 0) and of ``h_last`` (``dh_last [B, R]``; None: 0). Returns
    (da, dbx, dh0) in float32 (float64 for float64 inputs on the CPU), dh0
    None without ``h0``. The plain version for CPU tensors, the kernel's
    operator for CUDA tensors (one launch); a ``dy`` that is not contiguous
    is copied first (the train step's arrives contiguous)."""
    if a.device.type == "cpu":
        return rglru_scan_bwd_ref(a, hh, dy, h0, dh_last)
    if dy is not None and not dy.is_contiguous():
        dy = dy.contiguous()
    da, dbx, dh0 = _launch_bwd(a, hh, dy, h0, dh_last)
    return da, dbx, None if h0 is None else dh0


class RGLRUScan(torch.autograd.Function):
    """``rglru_scan`` with a gradient: the forward is one launch writing y
    in ``out_dtype`` and the float32 states it saves (``_forward(...,
    with_states=True)``), the backward ``rglru_scan_bwd`` (one more
    launch)."""

    @staticmethod
    def forward(ctx, a, bx, h0, out_dtype):
        y, h_last, hh = _forward(a, bx, h0, out_dtype=out_dtype, with_states=True)
        ctx.save_for_backward(a, hh, h0)
        ctx.bx_dtype = bx.dtype
        ctx.set_materialize_grads(False)
        return y, h_last

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


def _forward(a, bx, h0=None, *, out_dtype=torch.float32, with_states=False):
    """The plain version (CPU tensors), or the kernel's operator: (y,
    h_last), and with ``with_states`` the float32 states after every
    position too (float64 for float64 inputs on the CPU; ``y`` itself when
    ``out_dtype`` is the states' dtype)."""
    if a.device.type == "cpu":
        ys, h = rglru_scan_ref(a, bx, h0, out_dtype=_wide(a))
        return (ys.to(out_dtype), h, ys) if with_states else (ys.to(out_dtype), h)
    keep = with_states and out_dtype != torch.float32
    y, h_last, states = _launch(a, bx, h0, out_dtype, keep)
    if not with_states:
        return y, h_last
    return y, h_last, states if keep else y


def _ptr(t):
    return None if t is None else t.data_ptr()


_SCRATCH_DTYPES = {"flags": torch.int32, "agg": torch.float32, "carry": torch.int64}


def _scratch(plan, device, *names):
    """The plan's scratch tensors named ``names`` (None where the route has
    none)."""
    got = {k: torch.empty(shape, dtype=_SCRATCH_DTYPES[k], device=device)
           for k, shape in plan["scratch"].items()}
    return [got.get(k) for k in names]


@build.op("rglru_scan", "(Tensor a, Tensor bx, Tensor? h0, ScalarType out_dtype, "
          "bool with_states=False) -> (Tensor, Tensor, Tensor)")
def _launch(a, bx, h0, out_dtype, with_states=False):
    """The kernel on CUDA tensors (``torch.ops.repro_torch.rglru_scan``):
    (y, h_last, states), states float32 [B, S, R] with ``with_states``
    (written in the same launch), else empty."""
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
    states = torch.empty((B, S, R) if with_states else (0,), dtype=torch.float32,
                         device=a.device)
    h_last = torch.empty(B, R, dtype=torch.float32, device=a.device)
    if B == 0 or R == 0:
        return y, h_last, states
    if S == 0:
        return y, (h_last.zero_() if h0 is None else h_last.copy_(h0)), states
    plan = scan_plan(B, S, R)
    flags, agg = _scratch(plan, a.device, "flags", "agg")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _kernel()(a.data_ptr(), bx.data_ptr(), _ptr(h0), y.data_ptr(),
                    states.data_ptr() if with_states else None, h_last.data_ptr(),
                    _ptr(flags), _ptr(agg), B, S, R, DTYPES[out_dtype], stream)
    build.check(err, "rglru_scan")
    launch_counts.count(__name__, plan["route"])
    return y, h_last, states


@build.op("rglru_scan_bwd", "(Tensor a, Tensor hh, Tensor? dy, Tensor? h0, "
          "Tensor? dh_last) -> (Tensor, Tensor, Tensor)")
def _launch_bwd(a, hh, dy, h0, dh_last):
    """The gradient kernel on CUDA tensors
    (``torch.ops.repro_torch.rglru_scan_bwd``): (da, dbx, dh0) float32,
    dh0 [B, R] written when ``h0`` is given (else empty)."""
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd: unsupported device {a.device}")
    if a.dim() != 3 or hh.shape != a.shape:
        raise ValueError(f"rglru_scan_bwd: a {tuple(a.shape)} / hh {tuple(hh.shape)} "
                         "must be one [B, S, R] shape")
    B, S, R = a.shape
    if a.dtype != torch.float32 or hh.dtype != torch.float32:
        raise ValueError(f"rglru_scan_bwd: a, hh must be float32, got {a.dtype}/{hh.dtype}")
    if dy is not None and (dy.shape != a.shape or dy.dtype not in DTYPES):
        raise ValueError(f"rglru_scan_bwd: dy must be {tuple(a.shape)} in "
                         f"{sorted(map(str, DTYPES))}, got {tuple(dy.shape)} {dy.dtype}")
    for name, t in (("h0", h0), ("dh_last", dh_last)):
        if t is not None and (t.shape != (B, R) or t.dtype != torch.float32):
            raise ValueError(f"rglru_scan_bwd: {name} must be [{B}, {R}] float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    tensors = [t for t in (a, hh, dy, h0, dh_last) if t is not None]
    if any(t.device != a.device for t in tensors):
        raise ValueError("rglru_scan_bwd: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rglru_scan_bwd: inputs must be contiguous")
    f32 = dict(dtype=torch.float32, device=a.device)
    da, dbx = torch.empty(B, S, R, **f32), torch.empty(B, S, R, **f32)
    dh0 = torch.empty((B, R) if h0 is not None else (0,), **f32)
    if B == 0 or R == 0:
        return da, dbx, dh0
    if S == 0:
        if h0 is not None and dh_last is not None:
            dh0.copy_(dh_last)
        elif h0 is not None:
            dh0.zero_()
        return da, dbx, dh0
    plan = scan_plan(B, S, R, backward=True)
    (carry,) = _scratch(plan, a.device, "carry")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _bwd_kernel()(a.data_ptr(), hh.data_ptr(), _ptr(dy), _ptr(h0), _ptr(dh_last),
                        da.data_ptr(), dbx.data_ptr(),
                        dh0.data_ptr() if h0 is not None else None, _ptr(carry), B, S, R,
                        DTYPES[torch.float32 if dy is None else dy.dtype], stream)
    build.check(err, "rglru_scan_bwd")
    launch_counts.count(__name__, plan["route"])
    return da, dbx, dh0
