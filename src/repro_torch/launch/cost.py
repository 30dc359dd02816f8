"""Per-device cost of a cell's real program, traced on the meta device.

The role of ``repro.launch.hlo_cost`` (which reads XLA's optimized HLO): a
``TorchDispatchMode`` over the port's own program counts, for one device
of the mesh,

* ``flops``: every product at 2·m·n·k (``product_flops``), every
  hand-written kernel's analytic operations (a call of its operator
  ``torch.ops.repro_torch.<name>`` is answered here, by name, with the
  kernel's outputs and its work from ``kernels/costs.py``: the causal or
  windowed pairs of flash and of its backward kernel, the cache rows a
  decode reads, the scans' states), and one operation per output element
  of every other arithmetic op (the backward kernels of flash, of the
  mLSTM and of the sLSTM are operators too, counted by their analytic
  cost);
* ``bytes_accessed``: operand and result bytes at every op boundary, the
  upper bound (each eager op reads and writes memory);
* ``bytes_min``: the data movers only: products, kernels (their analytic
  bytes), copies, gathers and scatters, the cache writes;
* collective bytes and counts by kind, at the port's collective points
  (``tracing.collective``: the gathers and the row-parallel sum of
  ``sharding.py``, the FSDP gather and its gradient's reduce-scatter, the
  sequence-parallel combine): the bytes one device receives under a ring,
  (n-1)/n of the whole for all-gather and reduce-scatter, 2(n-1)/n for
  all-reduce, each tagged with the axes it crosses;
* ``peak_bytes``: the most bytes live above the arguments (each op's
  outputs allocated, freed when the tensor dies; autograd's saved tensors,
  ``torch.utils.checkpoint``'s recompute and the microbatch loop as the
  train step runs them).

One device: the single-controller program runs every "model" part and
"data" part of a layer; tensors of part j carry its position
(``tag_positions``), an op's output takes its inputs' positions (one index
along an axis; several: a gather, no index), and only ops at position 0
along every axis count; with ``one_part`` the program computes only part
0 of equal parts (``tracing.one_part``). Loops of equal trips (the
microbatches) run once and count ``n`` times
(``tracing.loop``), as the reference counts a ``while`` body once times
its trip count. The program finds the counter on the dispatch mode stack
(``repro_torch/tracing.py``); nothing below this layer imports it.
"""
from __future__ import annotations

import collections
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.distributed import sharding
from repro_torch.kernels import costs
from repro_torch.kernels import mlstm_chunk as kmc

aten = torch.ops.aten
_POS = "_cost_pos"
AXES = ("pod", "data", "model")

PRODUCTS = {getattr(getattr(aten, op), o) for op, o in (
    ("mm", "default"), ("bmm", "default"), ("addmm", "default"),
    ("baddbmm", "default"), ("mm", "dtype"), ("bmm", "dtype"))
    if hasattr(getattr(aten, op), o)}
MOVERS = {aten.copy_.default, aten._to_copy.default, aten.clone.default,
          aten.cat.default, aten.index.Tensor, aten.index_put_.default,
          aten.index_put.default, aten.index_select.default, aten.gather.default,
          aten.scatter.src, aten.scatter_.src, aten.embedding.default,
          aten.index_copy_.default, aten.index_copy.default,
          aten.stack.default, aten.constant_pad_nd.default}
ALLOCS = {aten.empty.memory_format, aten.empty_strided.default}
FREE = {aten.detach.default, aten.lift_fresh.default, aten.alias.default,
        aten._local_scalar_dense.default} | ALLOCS


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def position(t) -> tuple:
    return getattr(t, _POS, (None, None, None))


def set_position(t, pos):
    if isinstance(t, torch.Tensor):
        setattr(t, _POS, tuple(pos))


def tag_positions(tree, axis: str, index: int):
    """Mark every tensor of ``tree`` (parts, caches) as lying at ``index``
    along ``axis``."""
    k = AXES.index(axis)
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            pos = list(position(t))
            pos[k] = index
            set_position(t, pos)


def tag_placed(leaf, fsdp_axis: str = "data", model=None):
    """Tag the parts of a laid-out leaf: ``Shards`` part j at "model" j,
    ``Fsdp`` part i at ``fsdp_axis`` i."""
    if isinstance(leaf, sharding.Shards):
        for j, q in enumerate(leaf.parts):
            tag_placed(q, fsdp_axis, j)
    elif isinstance(leaf, sharding.Fsdp):
        for i, q in enumerate(leaf.parts):
            tag_placed(q, fsdp_axis, model)
            tag_positions(q, fsdp_axis, i)
    elif model is not None:
        tag_positions(leaf, "model", model)


def _merge(tensors) -> tuple:
    out = []
    for k in range(len(AXES)):
        vals = {position(t)[k] for t in tensors} - {None}
        out.append(vals.pop() if len(vals) == 1 else None)
    return tuple(out)


def _here(pos) -> bool:
    return all(p in (None, 0) for p in pos)


class CostCounter(TorchDispatchMode):
    """Counts one device's work (see the module docstring). ``trip_counts``
    False runs every trip of a ``tracing.loop`` instead of one;
    ``one_part`` lets the program compute part 0 of equal parts only."""

    traces_program = True

    def __init__(self, trip_counts: bool = True, one_part: bool = False):
        super().__init__()
        self.trip_counts = trip_counts
        self.one_part = one_part
        self.mult = 1.0
        self.flops = self.product_flops = self.kernel_flops = 0.0
        self.bytes_accessed = self.bytes_min = 0.0
        self.collective_bytes: Dict[str, float] = collections.Counter()
        self.collective_counts: Dict[str, float] = collections.Counter()
        self.link_bytes: Dict[str, float] = collections.Counter()   # nvlink / ib
        self.kernels: Dict[str, float] = collections.Counter()
        self.kernel_flops_by: Dict[str, float] = collections.Counter()
        # products inside each open ``torch.profiler.record_function`` range
        # (the flash backward's range holds its kernel's operator and no
        # product)
        self.range_product_flops: Dict[str, float] = collections.Counter()
        self._ranges = []
        self.live = self.peak = 0

    # ---- what the program asks (repro_torch/tracing.py) --------------------
    def loop(self, n: int):
        if not self.trip_counts:
            yield from range(n)
            return
        self.mult *= n
        try:
            yield 0
        finally:
            self.mult /= n

    def collective(self, kind, nbytes, axes, inputs, output):
        pos = _merge([t for t in inputs if isinstance(t, torch.Tensor)])
        if isinstance(output, torch.Tensor):
            set_position(output, [None if a in axes else p
                                  for a, p in zip(AXES, pos)])
        if not _here(pos):
            return
        self.collective_bytes[kind] += self.mult * nbytes
        self.collective_counts[kind] += self.mult
        self.link_bytes["nvlink" if set(axes) <= {"model"} else "ib"] += self.mult * nbytes

    # ---- the hand-written kernels -------------------------------------------
    def _kernel(self, name, args):
        """A call of ``torch.ops.repro_torch.<name>``: its outputs (empty,
        on meta) and the kernel's analytic cost."""
        out, (ops, nbytes), label = KERNELS[name](*args)
        ins = [t for t in args if isinstance(t, torch.Tensor)]
        pos = _merge(ins)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            set_position(t, pos)
        if _here(pos):
            m = self.mult
            self.flops += m * sum(ops.values())
            self.kernel_flops += m * sum(ops.values())
            self.bytes_accessed += m * nbytes
            self.bytes_min += m * nbytes
            self.kernels[label] += m
            self.kernel_flops_by[label] += m * sum(ops.values())
            for t in outs:
                self._allocated(t)
        return out

    # ---- the dispatch ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "repro_torch":
            return self._kernel(func._opname, args)
        if func.namespace == "profiler":
            if func._opname.startswith("_record_function_enter"):
                self._ranges.append(args[0])
            elif func._opname == "_record_function_exit":
                self._ranges.pop()
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        pos = _merge(ins)
        for t in outs:
            if not any(t is i for i in ins):
                set_position(t, pos)
        if not _here(pos):
            return out
        m = self.mult
        # a view or an in-place result aliases its input: no new memory
        aliases = any(r.alias_info is not None for r in func._schema.returns)
        if func in FREE:
            pass
        elif func in PRODUCTS:
            f = 2.0 * outs[0].numel() * ins[-2].shape[-1]
            self.flops += m * f
            self.product_flops += m * f
            for r in set(self._ranges):
                self.range_product_flops[r] += m * f
        elif ins and outs and outs[0].dtype.is_floating_point and not aliases \
                and func not in MOVERS:
            self.flops += m * outs[0].numel()
        if ins and func not in FREE and (not aliases or func in MOVERS):
            moved = sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs if not any(t is i for i in ins))
            self.bytes_accessed += m * moved
            if func in PRODUCTS or func in MOVERS:
                self.bytes_min += m * moved
        if aliases or (func in FREE and func not in ALLOCS):
            return out
        for t in outs:
            if not any(t is i for i in ins):
                self._allocated(t)
        return out

    def _allocated(self, t):
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n):
        self.live -= n

    def result(self) -> dict:
        return {"flops": self.flops, "product_flops": self.product_flops,
                "kernel_flops": self.kernel_flops,
                "range_product_flops": dict(self.range_product_flops),
                "bytes_accessed": self.bytes_accessed, "bytes_min": self.bytes_min,
                "collectives": {"total_bytes": sum(self.collective_bytes.values()),
                                "bytes": dict(self.collective_bytes),
                                "counts": dict(self.collective_counts),
                                "link_bytes": dict(self.link_bytes)},
                "kernels": dict(self.kernels),
                "kernel_flops_by": dict(self.kernel_flops_by), "peak_bytes": self.peak}


# ---------------------------------------------------------------------------
# The kernels' operators: (outputs, cost, name) from the operator's arguments
# ---------------------------------------------------------------------------


def _flash(q, k, v, q_per_kv, window, q_start, with_lse=False):
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    pairs = costs.flash_pairs(S, window=window, q_start=q_start)
    lse = torch.empty((B, H, S) if with_lse else (0,), dtype=torch.float32,
                      device=q.device)
    return ((torch.empty_like(q), lse),
            costs.flash(B, S, T, H, K, hd, q.element_size(), pairs, costs.rate(q.dtype),
                        lse=with_lse),
            "flash_attention")


def _flash_bwd(q, k, v, o, dout, lse, q_per_kv, window, q_start):
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    pairs = costs.flash_pairs(S, window=window, q_start=q_start)
    return ((torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)),
            costs.flash_bwd(B, S, T, H, K, hd, q.element_size(), pairs,
                            costs.rate(q.dtype)),
            "flash_attention_bwd")


def _split_decode(form, q, k, v, lens, length, q_per_kv, one_token, block_tables,
                  window):
    """A length given as one int counts the rows it reaches; a tensor of
    lengths cannot be read on meta, and then every row of the cache counts
    (a full cache, or every page the block table maps)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    reach = k.shape[1] if block_tables is None else block_tables.shape[1] * k.shape[1]
    if lens is None:
        reach = min(length + S, reach)
    pages = 0 if block_tables is None else B * block_tables.shape[1]
    elt, r = k.element_size(), costs.rate(q.dtype)
    if S == 1:
        cost = costs.decode(B, H, K, hd, B * reach, elt, pages, r)
    else:
        cost = costs.verify(B, S, H, K, hd, B * reach, B * S * reach, elt, pages, r)
    return torch.empty_like(q), cost, form


def _partials(q, k, v, clen, part_acc, part_ml, q_per_kv, n_pos, slot0, window):
    B, _, H, hd = q.shape
    return (None, costs.decode(B, H, k.shape[2], hd, B * k.shape[1], k.element_size(),
                               0, costs.rate(q.dtype)), "split_decode_partials")


def _combine(part_acc, part_ml, clen, o, q_per_kv, n_pos):
    return (None, costs.split_combine(part_acc.numel(), part_ml.numel(), o.numel(),
                                      o.element_size()), "split_decode_combine")


def _accept_len(accept, draft_lens):
    return (torch.empty(accept.shape[0], dtype=torch.int32, device=accept.device),
            costs.accept_len(*accept.shape), "accept_len")


def _rglru_scan(a, bx, h0, out_dtype, with_states=False):
    """The float32 states it writes beside y with ``with_states`` count
    toward the peak (autograd saves them) and toward its bytes."""
    B, S, R = a.shape
    f32 = dict(dtype=torch.float32, device=a.device)
    y = torch.empty(B, S, R, dtype=out_dtype, device=a.device)
    states = torch.empty((B, S, R) if with_states else (0,), **f32)
    return ((y, torch.empty(B, R, **f32), states),
            costs.rglru(B, S, R, y.element_size(), h0 is not None, with_states),
            "rglru_scan")


def _rglru_scan_bwd(a, hh, dy, h0, dh_last):
    B, S, R = a.shape
    f32 = dict(dtype=torch.float32, device=a.device)
    return ((torch.empty(B, S, R, **f32), torch.empty(B, S, R, **f32),
             torch.empty((B, R) if h0 is not None else (0,), **f32)),
            costs.rglru_bwd(B, S, R), "rglru_scan_bwd")


def _mlstm_chunk(q, k, v, ig, fg, C0, n0, m0, chunk, with_states=False):
    """The chunk start states it keeps with ``with_states`` count toward the
    peak (autograd saves them); their writes are the kernel's scratch."""
    B, S, H, hd = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    kept = kmc.states_plan(B, S, H, hd, chunk, q.dtype).values()
    states = tuple(torch.empty(shape if with_states else (0,), dtype=dt, device=q.device)
                   for shape, dt in kept)
    return ((torch.empty_like(q), torch.empty(B, H, hd, hd, **f32),
             torch.empty(B, H, hd, **f32), torch.empty(B, H, **f32)) + states,
            costs.mlstm(B, S, H, hd, chunk, q.element_size(), C0 is not None),
            "mlstm_chunk")


def _mlstm_chunk_bwd(q, k, v, ig, fg, dh, dC, dn, C, n, gates, CT, nS, mS, has_state,
                     chunk):
    B, S, H, hd = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return ((torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
             torch.empty(B, S, H, **f32), torch.empty(B, S, H, **f32)),
            costs.mlstm_bwd_kernel(B, S, H, hd, min(chunk, S), q.element_size()),
            "mlstm_chunk_bwd")


def _slstm_scan(gates_x, r_gates, c0, n0, h0, m0, mask, all_states=False,
                keep_gates=False):
    """The states after every step and the gates it keeps with
    ``keep_gates`` count toward the peak (autograd saves them)."""
    B, S, _, D = gates_x.shape
    H, hd = r_gates.shape[0], r_gates.shape[-1]
    f32 = dict(dtype=torch.float32, device=gates_x.device)
    every = all_states or keep_gates
    st = tuple(torch.empty((B, S, D) if every else (B, D), **f32) for _ in range(4))
    g = torch.empty((B, S, 4, D) if keep_gates else (0,), **f32)
    return ((torch.empty(B, S, D, dtype=r_gates.dtype, device=gates_x.device),) + st + (g,),
            costs.slstm(B, S, H, hd, r_gates.element_size(), c0 is not None, every),
            "slstm_scan")


def _slstm_scan_bwd(g, r_gates, c, n, m, c0, n0, m0, mask, dy, dc, dn, dh, dm):
    B, S, _, D = g.shape
    H, hd = r_gates.shape[0], r_gates.shape[-1]
    f32 = dict(dtype=torch.float32, device=g.device)
    d0 = tuple(torch.empty((B, D) if c0 is not None else (0,), **f32) for _ in range(4))
    return ((torch.empty(B, S, 4, D, dtype=r_gates.dtype, device=g.device),) + d0,
            costs.slstm_bwd(B, S, H, hd, r_gates.element_size(), c0 is not None),
            "slstm_scan_bwd")


KERNELS = {"flash_attention": _flash, "flash_attention_bwd": _flash_bwd,
           "split_decode": _split_decode,
           "split_decode_partials": _partials, "split_decode_combine": _combine,
           "accept_len": _accept_len, "rglru_scan": _rglru_scan,
           "rglru_scan_bwd": _rglru_scan_bwd,
           "mlstm_chunk": _mlstm_chunk, "mlstm_chunk_bwd": _mlstm_chunk_bwd,
           "slstm_scan": _slstm_scan, "slstm_scan_bwd": _slstm_scan_bwd}
