"""The split-K launch shared by the port's four decode-attention forms:
a dense (ring) cache or a paged pool, one query token per row or the S
queries of a verify step (``csrc/split_decode_attention.cu``, entry
``split_decode_attention_fwd``).

The slots of a row are cut at fixed absolute boundaries, every ``SPLIT``
slots; one block per (split, KV head, row, query) writes float32 partials
(m, l, acc) into scratch, and a second kernel merges them in split order
with the log-sum-exp rescale. ``split_plan`` gives the scratch shapes the
wrapper allocates. Query s of row b is computed exactly as a one-token call
at cache length ``cache_len[b] + s``, so a verify step equals S decode
steps bit for bit.

The wrappers (``decode_attention``, ``spec_decode_attention``,
``paged_decode_attention``, ``paged_spec_decode_attention``) run their plain
versions for CPU tensors and otherwise call ``decode``, the operator
``torch.ops.repro_torch.split_decode``, whose CUDA path (``launch_split``)
counts each form's launches.

The sequence-parallel decode (``distributed/collectives.py``) launches the
two kernels apart: ``launch_partials`` once per sequence shard of a dense
cache (entry ``split_decode_partials``: the shard's splits into the scratch
of the whole cache) and ``launch_combine`` once over all of them (entry
``split_decode_combine``). They count here, by stage.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, launch_counts
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS, aligned16

# csrc/split_decode_attention.cu's SPLIT and MAX_G (a CPU test holds them equal)
SPLIT = 128             # slots per split: 8 pages of 16
MAX_G = 64              # query heads per KV head the kernel's shared memory takes

launches = 0            # launches_by_route's sum: the two stages apart
launches_by_route = {"partials": 0, "combine": 0}

_fn = None
_stage_fns = {}


def split_plan(B: int, S: int, K: int, G: int, hd: int, n_pos: int):
    """(n_splits, part_acc shape, part_ml shape) of the split-K scratch for
    B rows of S queries, K KV heads of G query heads, head_dim hd and
    n_pos slots a row (a dense cache's W, or a block table's nw * ps).
    Split j covers slots [j * SPLIT, (j + 1) * SPLIT); a row's splits past
    its n_valid are neither written nor read."""
    n_splits = -(-n_pos // SPLIT)
    return (n_splits, (B, S, K, G, n_splits, hd), (B, S, K, G, n_splits, 2))


def check_decode_inputs(name, q, k, v, q_per_kv, *, multi_query=False):
    """Shape / dtype / device / contiguity checks shared by the decode
    wrappers (one query per row, or S with ``multi_query``). Returns
    (B, H, hd)."""
    if q.dim() != 4 or (q.shape[1] != 1 and not multi_query):
        raise ValueError(f"{name}: q must be [B, 1, H, hd], got {tuple(q.shape)}")
    B, _, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[3] != hd:
        raise ValueError(f"{name}: bad cache shapes {tuple(k.shape)} / "
                         f"{tuple(v.shape)} for q {tuple(q.shape)}")
    if k.shape[2] * q_per_kv != H:
        raise ValueError(f"{name}: {H} heads != {k.shape[2]} KV heads x {q_per_kv}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: tensors on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and aligned16(q, k, v)):
        raise ValueError(f"{name}: inputs must be contiguous and 16-byte aligned")
    if hd not in HEAD_DIMS or q_per_kv > MAX_G:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS} or "
                         f"q_per_kv {q_per_kv} > {MAX_G}")
    return B, H, hd


def lens_on_device(cache_len, B, device):
    """cache_len (int, 0-d or [B]) as a contiguous int32 [B] device tensor."""
    clen = torch.as_tensor(cache_len, device=device)
    if clen.dim() == 0:
        clen = clen.expand(B)
    if clen.shape != (B,):
        raise ValueError(f"cache_len must be scalar or [{B}], got {tuple(clen.shape)}")
    return clen.to(torch.int32).contiguous()


def _kernel():
    global _fn
    if _fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _fn = build.entry("split_decode_attention_fwd", [P] * 8 + [I] * 10 + [P])
    return _fn


def _stage_fn(name: str, argtypes):
    if name not in _stage_fns:
        _stage_fns[name] = build.entry(name, argtypes)
    return _stage_fns[name]


def split_scratch(B: int, S: int, K: int, G: int, hd: int, n_pos: int, device):
    """(part_acc, part_ml) float32 scratch of a cache of ``n_pos`` slots a
    row, in one 16-byte aligned allocation."""
    _, acc_shape, ml_shape = split_plan(B, S, K, G, hd, n_pos)
    n_acc = math.prod(acc_shape)
    buf = torch.empty(n_acc + math.prod(ml_shape), dtype=torch.float32, device=device)
    return buf[:n_acc].view(acc_shape), buf[n_acc:].view(ml_shape)


def launch_partials(q, k, v, clen, part_acc, part_ml, q_per_kv: int, *,
                    n_pos: int, slot0: int, window: Optional[int] = None):
    """The split kernel over one sequence shard of a dense cache: k, v
    [B, Wl, K, hd] hold slots [slot0, slot0 + Wl) of a cache of ``n_pos``
    slots a row (``slot0`` a multiple of ``SPLIT``); its splits' partials
    land at their absolute index in the scratch of the whole cache
    (``split_scratch``), on the shard's device. ``clen`` [B] int32."""
    _partials(q, k, v, clen, part_acc, part_ml, q_per_kv, n_pos, slot0, window)


@build.op("split_decode_partials", "(Tensor q, Tensor k, Tensor v, Tensor clen, "
          "Tensor(a!) part_acc, Tensor(b!) part_ml, int q_per_kv, int n_pos, "
          "int slot0, int? window) -> ()")
def _partials(q, k, v, clen, part_acc, part_ml, q_per_kv, n_pos, slot0, window):
    name = "split_decode_partials"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, H, hd = check_decode_inputs(name, q, k, v, q_per_kv)
    build.refuse_grad(name, "a serving kernel; train mode never decodes", q, k, v)
    Wl, K = k.shape[1], k.shape[2]
    if slot0 % SPLIT or slot0 < 0 or slot0 + Wl > n_pos or k.shape[0] != B:
        raise ValueError(f"{name}: shard [{slot0}, {slot0 + Wl}) of {n_pos} slots "
                         f"(cut at multiples of {SPLIT}) for batch {B}")
    P_, I = ctypes.c_void_p, ctypes.c_int
    fn = _stage_fn(name, [P_] * 6 + [I] * 10 + [P_])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), clen.data_ptr(),
             part_acc.data_ptr(), part_ml.data_ptr(), B, 1, K, q_per_kv, hd,
             n_pos, slot0, Wl, window or 0, DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    launch_counts.count(__name__, "partials")


def launch_combine(part_acc, part_ml, clen, o, q_per_kv: int, *, n_pos: int):
    """The combine over the partials of every shard: o [B, 1, H, hd]."""
    _combine(part_acc, part_ml, clen, o, q_per_kv, n_pos)


@build.op("split_decode_combine", "(Tensor part_acc, Tensor part_ml, Tensor clen, "
          "Tensor(a!) o, int q_per_kv, int n_pos) -> ()")
def _combine(part_acc, part_ml, clen, o, q_per_kv, n_pos):
    name = "split_decode_combine"
    if o.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {o.device}")
    B, _, H, hd = o.shape
    P_, I = ctypes.c_void_p, ctypes.c_int
    fn = _stage_fn(name, [P_] * 4 + [I] * 7 + [P_])
    err = fn(part_acc.data_ptr(), part_ml.data_ptr(), clen.data_ptr(), o.data_ptr(),
             B, 1, H // q_per_kv, q_per_kv, hd, n_pos, DTYPES[o.dtype],
             torch.cuda.current_stream(o.device).cuda_stream)
    build.check(err, name)
    launch_counts.count(__name__, "combine")


def launch_split(name, q, k, v, cache_len, q_per_kv, *, one_token: bool,
                 block_tables=None, window: Optional[int] = None):
    """The split and combine kernels on CUDA tensors, after the checks the
    four wrappers share; returns the output. Dense when ``block_tables`` is
    None (caches [B, W, K, hd], an optional ring window), else paged (pools
    [P, ps, K, hd], block_tables [B, nw], no window)."""
    B, H, hd = check_decode_inputs(name, q, k, v, q_per_kv,
                                   multi_query=not one_token)
    build.refuse_grad(name, "a serving kernel; train mode never decodes", q, k, v)
    if block_tables is None:
        if k.shape[0] != B or k.shape[1] < 1:
            raise ValueError(f"{name}: cache {tuple(k.shape)} for batch {B}")
        if window is not None and window < 1:
            raise ValueError(f"{name}: window={window}")
        n_pos, ps, nw, bt = k.shape[1], 0, 0, None
    else:
        if (block_tables.dim() != 2 or block_tables.shape[0] != B
                or block_tables.device != q.device):
            raise ValueError(f"{name}: block_tables {tuple(block_tables.shape)} "
                             f"for batch {B}")
        if window is not None:
            raise ValueError(f"{name}: a paged cache has no window")
        ps, nw = k.shape[1], block_tables.shape[1]
        n_pos, bt = nw * ps, block_tables.to(torch.int32).contiguous()
    S, K = q.shape[1], k.shape[2]
    clen = lens_on_device(cache_len, B, q.device)
    o = torch.empty_like(q)
    if B == 0 or S == 0:
        return o
    _, acc_shape, ml_shape = split_plan(B, S, K, q_per_kv, hd, n_pos)
    n_acc = math.prod(acc_shape)
    # one allocation for both partials (acc, then (m, l)); 16-byte aligned
    # since n_acc is a multiple of hd >= 16
    scratch = torch.empty(n_acc + math.prod(ml_shape), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if bt is None else bt.data_ptr(), clen.data_ptr(),
                    scratch.data_ptr(), scratch.data_ptr() + 4 * n_acc,
                    o.data_ptr(), B, S, K, q_per_kv, hd, n_pos, ps, nw,
                    window or 0, DTYPES[q.dtype], stream)
    build.check(err, name)
    return o


@build.op("split_decode", "(str form, Tensor q, Tensor k, Tensor v, Tensor? lens, "
          "int length, int q_per_kv, bool one_token, Tensor? block_tables, "
          "int? window) -> Tensor")
def _split_op(form, q, k, v, lens, length, q_per_kv, one_token, block_tables, window):
    """The kernels of the decode form ``form`` on CUDA tensors
    (``torch.ops.repro_torch.split_decode``); ``lens`` [B], or ``length``
    for every row when None."""
    if q.device.type != "cuda":
        raise ValueError(f"{form}: unsupported device {q.device}")
    o = launch_split(form, q, k, v, length if lens is None else lens, q_per_kv,
                     one_token=one_token, block_tables=block_tables, window=window)
    launch_counts.count(form)
    return o


def decode(form, q, k, v, cache_len, q_per_kv, *, one_token: bool,
           block_tables=None, window: Optional[int] = None):
    """The operator of the decode form ``form`` (a wrapper's name);
    ``cache_len`` a tensor [B] or one int for every row."""
    lens = cache_len if isinstance(cache_len, torch.Tensor) else None
    return _split_op(form, q, k, v, lens, 0 if lens is not None else int(cache_len),
                     q_per_kv, one_token, block_tables, window)
