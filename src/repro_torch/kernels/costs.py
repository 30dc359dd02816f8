"""The work of each hand-written kernel: operations and bytes, from shapes.

One source for two readers: the dry run's cost counter
(``launch/cost.py``), which answers each kernel's operator with these
counts, and ``chip_smoke.py``'s kernel rows, whose ``bound_ms`` is
``bound_ms`` of the same counts (``mlstm_bwd`` is the bound of the plain
mLSTM backward's float32 products, which no card path runs). Each function
returns ``(ops, nbytes)``: ``ops`` maps a rate
("bf16", "tf32", "f32": the tensor cores, TF32, or the CUDA cores) to the
operations done at it; ``nbytes`` counts each input read once and each
output written once. Where the work depends on the data (the cache rows a
decode reads, the causal or windowed pairs of flash) the caller passes
what its inputs need.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

# NVIDIA H100 SXM, per card (data sheet; dense rates, no sparsity)
PEAK = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BW = 3.35e12            # bytes/s

Cost = Tuple[Dict[str, float], float]


def rate(dtype) -> str:
    """The rate of products in ``dtype``: the tensor cores for half
    precision, the CUDA cores for float32 (the port's float32 kernels)."""
    return "bf16" if str(dtype).endswith(("bfloat16", "float16")) else "f32"


def bound_ms(cost: Cost) -> Tuple[float, str]:
    """(least time in ms, "bytes" or "operations") for ``cost``."""
    ops, nbytes = cost
    t_f = sum(n / PEAK[r] for r, n in ops.items()) * 1e3
    t_b = nbytes / HBM_BW * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def flash_pairs(S: int, window: Optional[int] = None, q_start: int = 0) -> int:
    """(query, key) pairs one head of one row computes: query i at position
    ``q_start + i`` sees keys [max(0, p - window + 1), p]."""
    if window is None:
        return S * q_start + S * (S + 1) // 2
    n1 = max(0, min(S, window - q_start))       # queries that see every key
    return n1 * q_start + n1 * (n1 + 1) // 2 + (S - n1) * window


def flash(B, S, T, H, K, hd, elt, pairs, r="bf16", lse: bool = False) -> Cost:
    """Flash forward: q [B,S,H,hd], k / v [B,T,K,hd] read, o written (and
    the rows' float32 log-sum-exp with ``lse``, training); q·kᵀ and p·v
    over ``pairs`` pairs a head and row."""
    return ({r: 4.0 * hd * H * pairs * B},
            elt * B * (2 * S * H * hd + 2 * T * K * hd) + (4 * B * H * S if lse else 0))


def flash_bwd(B, S, T, H, K, hd, elt, pairs, r="bf16") -> Cost:
    """Flash backward: q, k, v, o, dO and the forward's float32 log-sum-exp
    read, dq, dk, dv written; five products over the pairs (q·kᵀ and dO·vᵀ
    recomputed, pᵀ·dO, dsᵀ·q, ds·k)."""
    return ({r: 10.0 * hd * H * pairs * B},
            elt * B * (4 * S * H * hd + 4 * T * K * hd) + 4 * B * H * S)


def decode(B, H, K, hd, live, elt, pages=0, r="bf16") -> Cost:
    """One-token decode: q read and o written, ``live`` cache rows (over all
    batch rows) of K and V read, the lengths (and block-table entries)."""
    return ({r: 4.0 * hd * H * live},
            elt * (2 * B * H * hd + 2 * live * K * hd) + 4 * (B + pages))


def verify(B, S, H, K, hd, live, pairs, elt, pages=0, r="bf16") -> Cost:
    """Multi-query (verify) decode: S queries a row over ``live`` cache
    rows, ``pairs`` (query, key) pairs over all rows."""
    return ({r: 4.0 * hd * H * pairs},
            elt * (2 * B * S * H * hd + 2 * live * K * hd) + 4 * (B + pages))


def split_combine(n_acc, n_ml, out_elems, out_elt) -> Cost:
    """The split-K combine: every split's float32 partials (acc, then m and
    l) read, rescaled and summed; the output written."""
    return {"f32": 3.0 * n_acc}, 4 * (n_acc + n_ml) + out_elt * out_elems


def accept_len(B, S) -> Cost:
    return {"f32": 2.0 * B * S}, B * S + 4 * B + 4 * B


def rglru(B, S, R, out_elt, h0: bool, with_states: bool = False) -> Cost:
    """The scan: a and bx (float32) read, the states written in the output
    dtype (and, ``with_states``, in float32 beside a narrower output: the
    states training keeps for the gradient), h0 read and the last state
    written when given."""
    kept = 4 * B * S * R if with_states and out_elt != 4 else 0
    return ({"f32": 2.0 * B * S * R},
            4 * 2 * B * S * R + out_elt * B * S * R + kept + (4 * 2 * B * R if h0 else 0))


def rglru_bwd(B, S, R) -> Cost:
    """The reverse scan: a, the states and dy read, da and dbx written."""
    n = B * S * R
    return {"f32": 4.0 * n}, (4 + 4 + 2 + 4 + 4) * n


def mlstm(B, S, H, hd, L, elt=2, state: bool = True) -> Cost:
    """Chunkwise mLSTM: q, k, v, h (``elt`` bytes) and the two gates read or
    written, the carried state in and out; the causal q·kᵀ and w·v of each
    chunk at the half-precision rate, q·C and the state update with a
    float32 operand at TF32's."""
    nc = -(-S // L)
    pairs = L * (L + 1) // 2
    r = "bf16" if elt == 2 else "f32"
    ops = {r: 2.0 * 2 * B * H * nc * pairs * hd}
    r2 = "tf32" if elt == 2 else "f32"
    ops[r2] = ops.get(r2, 0.0) + 4.0 * B * H * nc * L * hd * hd
    nbytes = elt * 4 * B * S * H * hd + 4 * 2 * B * S * H
    if state:
        nbytes += 2 * 4 * (B * H * hd * hd + B * H * hd + B * H)
    return ops, nbytes


def mlstm_bwd(B, S, H, hd, L) -> Cost:
    """The plain backward (``mlstm_chunk_bwd``) in float32: nine products
    over the causal pairs and six over the state; the forward's inputs and
    dh read, the five gradients written."""
    nc = -(-S // L)
    pairs = L * (L + 1) // 2
    io = 2 * 4 * B * S * H * hd + 4 * 2 * B * S * H
    return ({"f32": B * H * nc * (9.0 * 2 * pairs * hd + 6.0 * 2 * L * hd * hd)},
            2 * io)



def mlstm_bwd_kernel(B, S, H, hd, L, elt=2) -> Cost:
    """The backward kernel: five products over each chunk's causal pairs
    (q·kᵀ and dh·vᵀ recomputed, ds'·k, ds'ᵀ·q, wᵀ·dh) at the half-precision
    rate and four over the state (X = dh·Cᵀ, which gives both dq's term and
    dh·(q C) as q·X; qᵀ·dh, v·dCEᵀ, (k ⊙ sc)·dCE) at TF32's (float32 inputs: both on the CUDA cores); q, k, v, dh and the
    two gates read, the forward's saved chunk start states (C, n, m) read,
    dq, dk, dv and the two gate gradients written."""
    nc = -(-S // L)
    pairs = L * (L + 1) // 2
    r = "bf16" if elt == 2 else "f32"
    ops = {r: 5.0 * 2 * B * H * nc * pairs * hd}
    r2 = "tf32" if elt == 2 else "f32"
    ops[r2] = ops.get(r2, 0.0) + 4.0 * 2 * B * H * nc * L * hd * hd
    nbytes = (elt * 7 * B * S * H * hd + 4 * 4 * B * S * H
              + 4 * B * H * nc * (hd * hd + hd + 1))
    return ops, nbytes


def slstm(B, S, H, hd, elt=2, state: bool = False, keep: bool = False) -> Cost:
    """The sLSTM scan: the recurrent products h·R (4·hd outputs of length
    hd a channel group, every step) at the rate of the activations' dtype;
    gates_x and R read, y written (``elt`` bytes), the float32 state read
    (``state``) and the last one written, or (``keep``, training and the
    verify record) the float32 states after every step and the float32
    gates g written beside y."""
    D = H * hd
    ops = {"bf16" if elt == 2 else "f32": 2.0 * B * S * 4 * D * hd}
    nbytes = elt * (4 * B * S * D + H * 4 * hd * hd + B * S * D)
    nbytes += 4 * 4 * B * D * (int(state) + (0 if keep else 1))
    if keep:
        nbytes += 4 * (4 + 4) * B * S * D
    return ops, nbytes


def slstm_bwd(B, S, H, hd, elt=2, state: bool = False) -> Cost:
    """The sLSTM gradient kernel: the recurrent products dg·Rᵀ every step;
    the forward's float32 gates and states c, n, m, dy and R read, d
    gates_x written (``elt`` bytes); the first state read and its gradient
    written with ``state``. dR is a product outside the kernel."""
    D = H * hd
    ops = {"bf16" if elt == 2 else "f32": 2.0 * B * S * 4 * D * hd}
    nbytes = 4 * (4 + 3) * B * S * D + elt * (B * S * D + H * 4 * hd * hd + 4 * B * S * D)
    nbytes += 4 * B * D * 4 + (4 * 3 * B * D + 4 * 4 * B * D if state else 0)
    return ops, nbytes

