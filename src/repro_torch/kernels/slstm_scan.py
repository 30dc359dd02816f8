"""sLSTM recurrence: the plain PyTorch version and its CUDA kernels.

Replaces the JAX package's ``src/repro/models/xlstm.py::slstm_scan`` (a
``lax.scan``: one device loop, no Pallas kernel) and its gradient, XLA's
autodiff of the same scan (source: ``csrc/slstm_scan.cu``, entries
``slstm_scan_fwd`` / ``slstm_scan_bwd``). Per head of ``r_gates`` and time
step, with the float32 state (c, n, h, m):

    rec = round_X(round_X(h) · R)   g = float(gates_x_t) + float(rec)
    m' = max(g_f + m, g_i)   f' = exp(g_f + m - m')   i' = exp(g_i - m')
    c' = f' c + i' tanh(g_z)   n' = f' n + i'
    h' = sigmoid(g_o) c' / max(n', 1e-6)   y_t = round_X(h')

X is ``r_gates.dtype`` (the activations'). At a position ``mask`` marks
False the state is carried unchanged; ``y_t`` is still the h' of g_t.

Contract: ``gates_x [B, S, 4, D]`` (the input projection, computed by the
caller), ``r_gates [H, 4, hd, hd]``, ``state`` (c, n, h, m) each ``[B, D]``
float32 or None (0, 0, 0, -1e30), ``mask [B, S]`` bool or None. Returns
``(y [B, S, D] in X, the state after the last step)``, or with
``all_states`` ``(y, the state after every step, each [B, S, D])``: the
verify step's record.

``slstm_scan`` runs the plain version (``slstm_scan_ref``) only for
tensors on the CPU; for CUDA tensors it launches the kernel (route
``"cluster"``: one thread-block cluster per head and group of up to 8
rows, all S steps in one launch) or raises. On the card it takes hd a
power of two from 16 to 256 and raises on any other.

Gradients: when autograd is on and an input requires grad the call goes
through ``SLSTMScan``, whose forward is the same launch keeping the
float32 gates g and the state after every step, and whose backward is
``slstm_scan_bwd``, the gradient kernel (route ``"cluster_bwd"``, operator
``torch.ops.repro_torch.slstm_scan_bwd``): the recurrence walked backwards
in time in one launch, writing d gates_x (and the gradient of a state
passed in); dR is one batched product after it (``recurrent_grad``). On
the CPU both directions run the plain versions (``slstm_scan_ref``,
``slstm_scan_bwd_ref``, a written-out reverse recurrence doing the
kernel's arithmetic); the card never runs them. A layer under remat "full"
launches the forward twice a microbatch and the gradient once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launch_counts
from repro_torch.kernels.flash_attention import DTYPES

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)     # the hd the kernels take

launches = 0            # kernel launches (never the plain version)
launches_by_route = dict.fromkeys(("cluster", "cluster_bwd"), 0)
_fn = None
_bwd_fn = None

_P, _I = ctypes.c_void_p, ctypes.c_int
FWD_ARGTYPES = [_P] * 13 + [_I] * 6 + [_P]
BWD_ARGTYPES = [_P] * 19 + [_I] * 5 + [_P]


def _wide(t):
    """The state's dtype: float32, or float64 for float64 inputs (the
    reference a float32 result is held to where rounding is the question)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _empty_state(B, D, wide, device):
    zeros = torch.zeros(B, D, dtype=wide, device=device)
    return zeros, zeros, zeros, torch.full_like(zeros, NEG_INF)


def slstm_scan_ref(gates_x, r_gates, state=None, mask=None, all_states=False,
                   keep_gates=False):
    """Plain version: a loop over time (the port's loop before the kernel,
    the JAX scan's step). ``keep_gates`` also returns g [B, S, 4, D], the
    float32 gates the gradient reads."""
    B, S, _, D = gates_x.shape
    H, hd = r_gates.shape[0], r_gates.shape[-1]
    X, wide = r_gates.dtype, _wide(r_gates)
    if state is None:
        state = _empty_state(B, D, wide, gates_x.device)
    c, n, h, m = (t.to(wide) for t in state)
    ys, stack, gs = [], [], []
    for t in range(S):
        rec = torch.einsum("bhd,hgde->bhge", h.reshape(B, H, hd).to(X), r_gates)
        g = gates_x[:, t].to(wide) + rec.permute(0, 2, 1, 3).reshape(B, 4, D).to(wide)
        gi, gf, gz, go = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
        m_new = torch.maximum(gf + m, gi)
        fp = torch.exp(gf + m - m_new)
        ip = torch.exp(gi - m_new)
        c_new = fp * c + ip * torch.tanh(gz)
        n_new = fp * n + ip
        h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1e-6)
        ys.append(h_new.to(X))
        new = (c_new, n_new, h_new, m_new)
        if mask is not None:
            keep = mask[:, t, None]
            new = tuple(torch.where(keep, a, b) for a, b in zip(new, (c, n, h, m)))
        c, n, h, m = new
        if all_states or keep_gates:
            stack.append(new)
        if keep_gates:
            gs.append(g)
    y = torch.stack(ys, dim=1) if S else gates_x.new_empty(B, 0, D, dtype=X)
    if all_states or keep_gates:
        states = (tuple(torch.stack(s, dim=1) for s in zip(*stack)) if S else
                  tuple(torch.empty(B, 0, D, dtype=wide, device=gates_x.device)
                        for _ in range(4)))
    else:
        states = (c, n, h, m)
    if keep_gates:
        g_all = (torch.stack(gs, dim=1) if S else
                 torch.empty(B, 0, 4, D, dtype=wide, device=gates_x.device))
        return y, states, g_all
    return y, states


def slstm_scan_bwd_ref(g, r_gates, c, n, m, state0=None, mask=None, dy=None,
                       dlast=None):
    """Plain version of the gradient (the CPU's; the tests' reference): the
    reverse-time recurrence of the kernel, step for step its arithmetic.
    ``g`` [B, S, 4, D] and the states after every step ``c``, ``n``, ``m``
    [B, S, D] come from the forward (``keep_gates``); ``state0`` (c0, n0,
    m0) the state it started from, or None; ``dy`` [B, S, D] and ``dlast``
    (dc, dn, dh, dm) [B, D] the gradients of y and of the last state (None:
    0). Returns (d gates_x [B, S, 4, D] in X, the gradient of the first
    state (dc0, dn0, dh0, dm0), or None without ``state0``)."""
    B, S, _, D = g.shape
    H, hd = r_gates.shape[0], r_gates.shape[-1]
    X, wide = r_gates.dtype, _wide(r_gates)
    zeros = torch.zeros(B, D, dtype=wide, device=g.device)
    dc_, dn_, dh_, dm_ = (zeros,) * 4 if dlast is None else (t.to(wide) for t in dlast)
    c0, n0, m0 = ((zeros, zeros, torch.full_like(zeros, NEG_INF)) if state0 is None
                  else tuple(t.to(wide) for t in state0))
    dgx = torch.empty(B, S, 4, D, dtype=X, device=g.device)
    half = torch.tensor(0.5, dtype=wide, device=g.device)
    for t in reversed(range(S)):
        cp, np_, mp = (c[:, t - 1], n[:, t - 1], m[:, t - 1]) if t > 0 else (c0, n0, m0)
        gi, gf, gz, go = g[:, t, 0], g[:, t, 1], g[:, t, 2], g[:, t, 3]
        # the forward's step again
        a = gf + mp
        m_new = torch.maximum(a, gi)
        fp = torch.exp(a - m_new)
        ip = torch.exp(gi - m_new)
        tz = torch.tanh(gz)
        c_new = fp * cp + ip * tz
        n_new = fp * np_ + ip
        sg = torch.sigmoid(go)
        ncl = torch.clamp(n_new, min=1e-6)
        keep = (torch.ones(B, 1, dtype=torch.bool, device=g.device) if mask is None
                else mask[:, t, None])
        dhn = (zeros if dy is None else dy[:, t].to(wide)) + torch.where(keep, dh_, zeros)
        dcn, dnn, dmn = (torch.where(keep, v, zeros) for v in (dc_, dn_, dm_))
        # h' = (sg c') / max(n', 1e-6)
        q = sg * c_new
        dq = dhn / ncl
        dnc = -dhn * ((q / ncl) / ncl)
        dsg = dq * c_new
        dcn = dcn + dq * sg
        dnn = dnn + torch.where(n_new >= 1e-6, dnc, zeros)
        dgo = dsg * (1 - sg) * sg
        # c' = f' c + i' tanh(g_z), n' = f' n + i'
        dfp = dcn * cp + dnn * np_
        dip = dcn * tz + dnn
        dgz = dcn * ip * (1 - tz * tz)
        ei, ef = dip * ip, dfp * fp
        dmn = dmn - ei - ef
        # m' = max(g_f + m, g_i): the gradient split in half at a tie
        tie = torch.where(a == gi, half * dmn, zeros)
        da = torch.where(a > gi, dmn, tie)
        dgi = ei + torch.where(a < gi, dmn, tie)
        dgf = ef + da
        dmp = ef + da
        dc_ = dcn * fp + torch.where(keep, zeros, dc_)
        dn_ = dnn * fp + torch.where(keep, zeros, dn_)
        dm_ = dmp + torch.where(keep, zeros, dm_)
        dhold = torch.where(keep, zeros, dh_)
        dg = torch.stack([dgi, dgf, dgz, dgo], dim=1).to(X)             # [B, 4, D]
        dgx[:, t] = dg
        dhx = torch.einsum("bghe,hgde->bhd", dg.reshape(B, 4, H, hd), r_gates)
        dh_ = dhx.reshape(B, D).to(wide) + dhold
    return dgx, (None if state0 is None else (dc_, dn_, dh_, dm_))


def recurrent_grad(h_prev, dgx, H):
    """dR [H, 4, hd, hd] = Σ_{b,t} h_prev[b, t, head, d] · dg[b, t, gate, head,
    e]: one batched product over all rows and steps, in the dtype of its
    operands (``h_prev`` [B, S, D] already rounded to X: the state before
    each step, not y, which differs at masked steps)."""
    B, S, _, D = dgx.shape
    hd = D // H
    a = h_prev.reshape(B * S, H, hd).permute(1, 2, 0)                    # [H, hd, N]
    b = dgx.reshape(B * S, 4, H, hd).permute(2, 0, 1, 3).reshape(H, B * S, 4 * hd)
    return torch.matmul(a, b).reshape(H, hd, 4, hd).permute(0, 2, 1, 3).contiguous()


def _kernel():
    global _fn
    if _fn is None:
        _fn = build.entry("slstm_scan_fwd", FWD_ARGTYPES)
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        _bwd_fn = build.entry("slstm_scan_bwd", BWD_ARGTYPES)
    return _bwd_fn


def _contiguous(t):
    return None if t is None else t.contiguous()


def _split(state):
    return (None,) * 4 if state is None else tuple(state)


def _forward(gates_x, r_gates, state=None, mask=None, all_states=False,
             keep_gates=False):
    """The plain version (CPU tensors), or the kernel's operator; same
    returns as ``slstm_scan_ref``. A mask that is not contiguous (a
    broadcast prefill mask) is copied first."""
    if gates_x.device.type == "cpu":
        return slstm_scan_ref(gates_x, r_gates, state, mask, all_states, keep_gates)
    y, c, n, h, m, g = _launch(gates_x, r_gates, *_split(state), _contiguous(mask),
                               all_states, keep_gates)
    return (y, (c, n, h, m), g) if keep_gates else (y, (c, n, h, m))


def slstm_scan_bwd(g, r_gates, c, n, m, state0=None, mask=None, dy=None, dlast=None):
    """The gradient (see ``slstm_scan_bwd_ref`` for the contract): the plain
    version for CPU tensors, the kernel's operator for CUDA tensors (one
    launch). A ``dy`` or ``mask`` that is not contiguous is copied first;
    a None ``dy`` is 0."""
    if g.device.type == "cpu":
        return slstm_scan_bwd_ref(g, r_gates, c, n, m, state0, mask, dy, dlast)
    B, S, _, D = g.shape
    if dy is None:
        dy = torch.zeros(B, S, D, dtype=r_gates.dtype, device=g.device)
    c0, n0, m0 = (None,) * 3 if state0 is None else state0
    dgx, *d0 = _launch_bwd(g, r_gates, c, n, m, c0, n0, m0, _contiguous(mask),
                           dy.contiguous(), *_split(dlast))
    return dgx, (None if state0 is None else tuple(d0))


class SLSTMScan(torch.autograd.Function):
    """``slstm_scan`` with a gradient: the forward is one launch writing y
    and, beside it, the float32 gates and states the backward reads; the
    backward is ``slstm_scan_bwd`` (one more launch) and, for ``r_gates``,
    ``recurrent_grad``. Returns (y, c, n, h, m), the state after the last
    step."""

    @staticmethod
    def forward(ctx, gates_x, r_gates, mask, c0, n0, h0, m0):
        state = None if c0 is None else (c0, n0, h0, m0)
        y, (cs, ns, hs, ms), g = _forward(gates_x, r_gates, state, mask, keep_gates=True)
        ctx.save_for_backward(g, r_gates, cs, ns, hs, ms, mask, c0, n0, h0, m0)
        ctx.gx_dtype = gates_x.dtype
        last = tuple(s[:, -1].clone() for s in (cs, ns, hs, ms))
        return (y,) + last

    @staticmethod
    def backward(ctx, dy, dc, dn, dh, dm):
        g, r_gates, cs, ns, hs, ms, mask, c0, n0, h0, m0 = ctx.saved_tensors
        state0 = None if c0 is None else (c0, n0, m0)
        with torch.profiler.record_function("slstm_scan_bwd"):
            dgx, d0 = slstm_scan_bwd(g, r_gates, cs, ns, ms, state0, mask, dy,
                                     (dc, dn, dh, dm))
        dR = None
        if ctx.needs_input_grad[1]:
            B, S, _, D = g.shape
            first = (torch.zeros(B, 1, D, dtype=hs.dtype, device=hs.device)
                     if h0 is None else h0[:, None].to(hs.dtype))
            h_prev = torch.cat([first, hs[:, :-1]], dim=1).to(r_gates.dtype)
            dR = recurrent_grad(h_prev, dgx, r_gates.shape[0])
        d0 = (None,) * 4 if d0 is None else tuple(
            d.to(s.dtype) for d, s in zip(d0, (c0, n0, h0, m0)))
        return (dgx.to(ctx.gx_dtype), dR, None) + d0


def slstm_scan(gates_x, r_gates, state=None, mask=None, all_states=False):
    """The recurrence (see the module docstring). Under autograd, with an
    input that requires grad, it is ``SLSTMScan`` (the same forward, with a
    backward); ``all_states`` (the verify record) has no gradient and
    raises there."""
    tensors = (gates_x, r_gates) + tuple(_split(state))
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        if all_states:
            raise NotImplementedError("slstm_scan: all_states has no gradient")
        B, S, _, D = gates_x.shape
        if S == 0:
            raise ValueError("slstm_scan: no time steps to differentiate")
        y, c, n, h, m = SLSTMScan.apply(gates_x, r_gates, mask, *_split(state))
        return y, (c, n, h, m)
    return _forward(gates_x, r_gates, state, mask, all_states)


def _check_state(name, ts, B, D, device):
    """The state's parts ``ts``: all None, or all [B, D] float32 contiguous
    on ``device``."""
    for t in ts:
        if t is None:
            continue
        if t.shape != (B, D) or t.dtype != torch.float32:
            raise ValueError(f"{name}: state must be [{B}, {D}] float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: state must be contiguous on {device}")
    if any(t is None for t in ts) and any(t is not None for t in ts):
        raise ValueError(f"{name}: give all of the state's parts or none")


def _check(name, gates_x, r_gates, mask, gx_dtype):
    """(B, S, H, hd) of a call the kernels take (``gates_x``, or the
    gradient's g, in ``gx_dtype``); raises on any other."""
    if gates_x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {gates_x.device}")
    if gates_x.dim() != 4 or gates_x.shape[2] != 4 or r_gates.dim() != 4:
        raise ValueError(f"{name}: gates_x {tuple(gates_x.shape)} must be [B, S, 4, D] "
                         f"and r_gates {tuple(r_gates.shape)} [H, 4, hd, hd]")
    B, S, _, D = gates_x.shape
    H, hd = r_gates.shape[0], r_gates.shape[-1]
    if r_gates.shape != (H, 4, hd, hd) or H * hd != D:
        raise ValueError(f"{name}: r_gates {tuple(r_gates.shape)} does not fit D = {D}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if r_gates.dtype not in DTYPES or gates_x.dtype != gx_dtype:
        raise ValueError(f"{name}: r_gates must be one of {sorted(map(str, DTYPES))} "
                         f"and gates_x {gx_dtype}, got {r_gates.dtype}/{gates_x.dtype}")
    if mask is not None and (mask.shape != (B, S) or mask.dtype != torch.bool):
        raise ValueError(f"{name}: mask must be [{B}, {S}] bool, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    for t in (gates_x, r_gates, mask):
        if t is not None and (t.device != gates_x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: inputs must be contiguous on {gates_x.device}")
    return B, S, H, hd


def _ptr(t):
    return None if t is None else t.data_ptr()


@build.op("slstm_scan", "(Tensor gates_x, Tensor r_gates, Tensor? c0, Tensor? n0, "
          "Tensor? h0, Tensor? m0, Tensor? mask, bool all_states=False, "
          "bool keep_gates=False) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
def _launch(gates_x, r_gates, c0, n0, h0, m0, mask, all_states=False, keep_gates=False):
    """The forward kernel on CUDA tensors (``torch.ops.repro_torch.
    slstm_scan``): (y, c, n, h, m, g): the state after every step [B, S, D]
    with ``all_states`` or ``keep_gates``, else after the last [B, D]; g
    float32 [B, S, 4, D] with ``keep_gates``, else empty."""
    B, S, H, hd = _check("slstm_scan", gates_x, r_gates, mask, r_gates.dtype)
    D = H * hd
    _check_state("slstm_scan", (c0, n0, h0, m0), B, D, gates_x.device)
    f32 = dict(dtype=torch.float32, device=gates_x.device)
    every = all_states or keep_gates
    y = torch.empty(B, S, D, dtype=r_gates.dtype, device=gates_x.device)
    st = tuple(torch.empty((B, S, D) if every else (B, D), **f32) for _ in range(4))
    g = torch.empty((B, S, 4, D) if keep_gates else (0,), **f32)
    if B == 0 or S == 0:
        if not every:
            for dst, src in zip(st, _empty_state(B, D, torch.float32, gates_x.device)
                                if c0 is None else (c0, n0, h0, m0)):
                dst.copy_(src)
        return (y,) + st + (g,)
    stream = torch.cuda.current_stream(gates_x.device).cuda_stream
    err = _kernel()(gates_x.data_ptr(), r_gates.data_ptr(), _ptr(c0), _ptr(n0), _ptr(h0),
                    _ptr(m0), _ptr(mask), y.data_ptr(), *(s.data_ptr() for s in st),
                    g.data_ptr() if keep_gates else None, int(every), B, S, H, hd,
                    DTYPES[r_gates.dtype], stream)
    build.check(err, "slstm_scan")
    launch_counts.count(__name__, "cluster")
    return (y,) + st + (g,)


@build.op("slstm_scan_bwd", "(Tensor g, Tensor r_gates, Tensor c, Tensor n, Tensor m, "
          "Tensor? c0, Tensor? n0, Tensor? m0, Tensor? mask, Tensor dy, Tensor? dc, "
          "Tensor? dn, Tensor? dh, Tensor? dm) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")
def _launch_bwd(g, r_gates, c, n, m, c0, n0, m0, mask, dy, dc, dn, dh, dm):
    """The gradient kernel on CUDA tensors (``torch.ops.repro_torch.
    slstm_scan_bwd``): (d gates_x [B, S, 4, D] in X, dc0, dn0, dh0, dm0),
    the last four [B, D] float32 when the forward started from a state
    (``c0`` given), else empty."""
    B, S, H, hd = _check("slstm_scan_bwd", g, r_gates, mask, torch.float32)
    D = H * hd
    for name, t in (("c", c), ("n", n), ("m", m)):
        if t.shape != (B, S, D) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != g.device:
            raise ValueError(f"slstm_scan_bwd: {name} must be contiguous [{B}, {S}, {D}] "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    if dy.shape != (B, S, D) or dy.dtype != r_gates.dtype or not dy.is_contiguous():
        raise ValueError(f"slstm_scan_bwd: dy must be contiguous [{B}, {S}, {D}] "
                         f"{r_gates.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    _check_state("slstm_scan_bwd", (c0, n0, m0), B, D, g.device)
    _check_state("slstm_scan_bwd", (dc, dn, dh, dm), B, D, g.device)
    f32 = dict(dtype=torch.float32, device=g.device)
    dgx = torch.empty(B, S, 4, D, dtype=r_gates.dtype, device=g.device)
    d0 = tuple(torch.empty((B, D) if c0 is not None else (0,), **f32) for _ in range(4))
    if B == 0 or S == 0:
        return (dgx,) + d0
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = _bwd_kernel()(g.data_ptr(), r_gates.data_ptr(), c.data_ptr(), n.data_ptr(),
                        m.data_ptr(), _ptr(c0), _ptr(n0), _ptr(m0), _ptr(mask),
                        dy.data_ptr(), _ptr(dc), _ptr(dn), _ptr(dh), _ptr(dm),
                        dgx.data_ptr(), *((t.data_ptr() if c0 is not None else None)
                                          for t in d0),
                        B, S, H, hd, DTYPES[r_gates.dtype], stream)
    build.check(err, "slstm_scan_bwd")
    launch_counts.count(__name__, "cluster_bwd")
    return (dgx,) + d0
