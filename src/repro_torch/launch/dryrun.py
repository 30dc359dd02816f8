"""Dry run of every (arch x shape) cell on an H100 production mesh, on meta.

Counterpart of ``repro.launch.dryrun``: each active cell of the registry
is built at its published widths under the reference's baseline layout
(``sharding.rules_for(mesh, phase, ...)``) and its real program (the train
step, ``prefill`` or ``decode_step``) is traced on the ``meta`` device
under ``launch/cost.py``'s counter, one device's work. No card, no JAX.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape train_4k [--multi-pod] [--mesh 16x16] [--out F]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--weight-stationary] [--expert-parallel] [--accum-steps N] [--out F]

Each result carries the reference's keys (``arch``, ``shape``, ``mesh``,
``devices``, ``phase``, ``memory`` {argument, output, temp bytes a device},
``flops``, ``bytes_accessed``, ``bytes_min``, ``collectives``, ``params``,
``active_params``) and the H100 roofline terms (``roofline``: compute,
memory, NVLink and InfiniBand seconds, the dominant term, the useful-FLOPs
ratio, whether the cell fits 80 GB a card). The argument bytes come from
the shard shapes of the cell's specs (``_divisible_spec`` where a dim does
not divide). A train cell without ``accum_steps`` takes the smallest power
of two of microbatches whose traced peak fits 90% of 80 GB.

How one device is traced: the parameters are laid out on the mesh (meta
tensors, the parts of each "model" and FSDP position tagged), the batch
and caches hold one "data" position's rows, and the counter counts the
ops at position 0 (``cost.py``); the optimizer updates position 0's parts
(the counter's ``one_part``) and the microbatch loop runs one trip counted
``accum_steps`` times. Attention's forward FLOPs are the kernels' causal
(or windowed) pairs, not the full masked S x S product the reference's
``hlo_cost`` counts on XLA's attention, and so are its backward kernel's
(five products over the same pairs, ``costs.flash_bwd``); the written-out
mLSTM backward counts as the PyTorch ops it runs.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.registry import ARCHS, SHAPES, cell_is_active, get_arch, get_shape
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cost, mesh as lmesh
from repro_torch.launch.input_specs import batch_specs, cache_specs, on_meta
from repro_torch.models import transformer as tfm
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_step import TrainConfig, make_train_step

FIT = 0.9 * lmesh.HBM_BYTES


def _bytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def shard_bytes(shape, dtype, spec, mesh) -> int:
    """Bytes one device holds of a leaf laid out by ``spec`` (after the
    reference's ``_divisible_spec`` fallback)."""
    spec = shd._divisible_spec(shape, spec, mesh)
    local = [d // mesh.extent(shd._names(spec[i])) if i < len(spec) and spec[i]
             else d for i, d in enumerate(shape)]
    return _bytes(local, dtype)


def param_leaves(cfg, rules):
    """(state-dict name, shape, spec) of every parameter under ``rules``."""
    params = tfm.TransformerParams(cfg, device="meta", dtype=torch.float32)
    out = []
    for path, mod in params.named_modules():
        for name, t in mod.named_parameters(recurse=False):
            out.append(((f"{path}." if path else "") + name, tuple(t.shape),
                        shd._axes_to_spec(mod.AXES[name], rules)))
    return out


def fallback_leaves(cfg, rules, mesh):
    """The parameters whose spec the divisibility fallback changes."""
    return [name for name, shape, spec in param_leaves(cfg, rules)
            if shd._divisible_spec(shape, spec, mesh) != spec]


def argument_bytes(cfg, shape, mesh, rules) -> dict:
    """Per-device argument bytes by group: params, AdamW state (train),
    batch, cache (prefill / decode)."""
    pdt = tfm.DTYPES[cfg.param_dtype]
    leaves = param_leaves(cfg, rules)
    out = {"params": sum(shard_bytes(s, pdt, sp, mesh) for _, s, sp in leaves)}
    if shape.phase == "train":
        out["opt_state"] = 2 * sum(shard_bytes(s, torch.float32, sp, mesh)
                                   for _, s, sp in leaves) + 4
    bspec = shd.batch_pspecs(cfg, rules, shape.phase)
    out["batch"] = sum(shard_bytes(s, dt, bspec[k], mesh)
                       for k, (s, dt) in batch_specs(cfg, shape).items())
    c = cache_specs(cfg, shape)
    if c is not None:
        cs = shd.cache_pspecs(cfg, rules)
        out["cache"] = sum(shard_bytes(s, dt, sp, mesh) for (s, dt), sp in
                           zip(tfm.tree_leaves(c), _spec_leaves(cs)))
        if shape.phase == "decode":
            out["cache_len"] = 4
    return out


def _spec_leaves(tree):
    if isinstance(tree, shd.P):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [x for v in tree for x in _spec_leaves(v)]


def _local_rows(shape, mesh, rules) -> int:
    d = mesh.extent(rules["batch"])
    B = shape.global_batch
    return B // d if d > 1 and B % d == 0 else B


def _cache_on_mesh(cfg, shape, rows, mesh, rules):
    cache = on_meta(cache_specs(cfg, shape, rows))
    placed = shd.shard_put(cache, shd.cache_pspecs(cfg, rules), mesh)
    _tag_cache(placed)
    return placed


def _tag_cache(tree):
    if isinstance(tree, shd.Shards):
        cost.tag_placed(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tag_cache(v)
    elif isinstance(tree, tuple):
        for v in tree:
            _tag_cache(v)


def build_cell(arch_name: str, shape_name: str, mesh, *, accum_steps=None,
               weight_stationary: bool = False, expert_parallel: bool = False):
    """Returns ((args, program), rules, cfg, shape, accum_steps):
    ``args()`` builds the cell's arguments on meta (one device's rows) and
    ``program(*args)`` runs it once; ``rules`` is the cell's layout. The
    arch and shape are registry names or config objects."""
    cfg = get_arch(arch_name) if isinstance(arch_name, str) else arch_name
    shape = get_shape(shape_name) if isinstance(shape_name, str) else shape_name
    phase = shape.phase
    rules = shd.rules_for(mesh, phase, shard_batch=shape.global_batch > 1,
                          weight_stationary=weight_stationary and phase == "decode",
                          expert_parallel=expert_parallel)
    rows = _local_rows(shape, mesh, rules)
    # the traced program holds one "data" position's rows, so its own row
    # loops see one shard
    local = dict(rules, batch=(), cache_batch=())
    fsdp_axis = "data"

    def placed_params(trainable):
        p = shd.place_params(tfm.TransformerParams(
            cfg, device="meta", dtype=tfm.DTYPES[cfg.param_dtype]), rules,
            trainable=trainable)
        for _, leaf in p.named_parameters():
            cost.tag_placed(leaf, fsdp_axis)
        return p

    if phase == "train":
        tcfg = TrainConfig(accum_steps=accum_steps or 1)
        step = make_train_step(cfg, tcfg)

        def args():
            params = placed_params(True)
            return params, init_opt_state(params), on_meta(batch_specs(cfg, shape, rows))

        def program(params, opt, batch):
            with shd.use_rules(local):
                return step(params, opt, batch)
        return (args, program), rules, cfg, shape, tcfg.accum_steps

    def args():
        return (placed_params(False), on_meta(batch_specs(cfg, shape, rows)),
                _cache_on_mesh(cfg, shape, rows, mesh, local))

    def program(params, batch, cache):
        with shd.use_rules(local):
            if phase == "prefill":
                return tfm.prefill(params, batch, cfg, cache)
            return tfm.decode_step(params, batch, cfg, cache, shape.seq_len - 1)
    return (args, program), rules, cfg, shape, None


def trace(run, trip_counts: bool = True) -> dict:
    """Build a cell's arguments, then run its program once under the cost
    counter: its per-device counts and the output's bytes."""
    make_args, program = run
    args = make_args()
    # the card's train step recomputes each checkpointed layer whole
    # (chip_smoke.py's dryrun phase measures it): so does the trace
    with cost.CostCounter(trip_counts, one_part=True) as counter, \
            ckpt.set_checkpoint_early_stop(False):
        out = program(*args)
    res = counter.result()
    res["output_bytes"] = _out_bytes(out)
    del out
    return res


def _out_bytes(out) -> int:
    n = 0
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if cost._here(cost.position(x)):
                n += x.numel() * x.element_size()
        elif isinstance(x, (shd.Shards, shd.Fsdp)):
            stack.append(x.parts[0])
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, shd.Placed):
            stack.extend(v for _, v in x.named_parameters())
    return n


def dryrun_cell(arch_name: str, shape_name: str, *, multi_pod: bool = False,
                mesh_shape=None, verbose: bool = True, accum_steps=None,
                weight_stationary: bool = False, expert_parallel: bool = False) -> dict:
    mesh = lmesh.make_production_mesh(multi_pod=multi_pod, shape=mesh_shape)
    t0 = time.time()
    kw = dict(weight_stationary=weight_stationary, expert_parallel=expert_parallel)
    run, rules, cfg, shape, accum = build_cell(arch_name, shape_name, mesh,
                                               accum_steps=accum_steps, **kw)
    args = argument_bytes(cfg, shape, mesh, rules)
    arg_total = sum(args.values())
    res = trace(run)
    tried = [(accum, res["peak_bytes"])] if accum else []
    if shape.phase == "train" and accum_steps is None:
        rows = _local_rows(shape, mesh, rules)
        while arg_total + res["peak_bytes"] > FIT and accum * 2 <= rows:
            accum *= 2
            run = build_cell(arch_name, shape_name, mesh, accum_steps=accum, **kw)[0]
            res = trace(run)
            tried.append((accum, res["peak_bytes"]))
    dev = lmesh.devices(mesh)
    coll = res["collectives"]
    peak = lmesh.PEAK_FLOPS.get(cfg.dtype, lmesh.PEAK_FLOPS["float32"])
    terms = {"compute_s": res["flops"] / peak,
             "memory_s": res["bytes_min"] / lmesh.HBM_BW,
             "memory_upper_s": res["bytes_accessed"] / lmesh.HBM_BW,
             "nvlink_s": coll["link_bytes"].get("nvlink", 0.0) / lmesh.NVLINK_BW,
             "infiniband_s": coll["link_bytes"].get("ib", 0.0) / lmesh.IB_BW}
    dominant = max(("compute_s", "memory_s", "nvlink_s", "infiniband_s"),
                   key=terms.get)
    tokens = shape.global_batch * (shape.seq_len if shape.phase != "decode" else 1)
    useful = (6 if shape.phase == "train" else 2) * cfg.active_param_count() * tokens
    need = arg_total + res["peak_bytes"]
    out = {
        "arch": arch_name, "shape": shape_name, "mesh": lmesh.mesh_name(mesh),
        "devices": dev, "phase": shape.phase,
        "layout": {"weight_stationary": weight_stationary,
                   "expert_parallel": expert_parallel},
        "trace_s": round(time.time() - t0, 2),
        "memory": {"argument_size_in_bytes": arg_total,
                   "output_size_in_bytes": res["output_bytes"],
                   "temp_size_in_bytes": res["peak_bytes"],
                   "argument_bytes_by_group": args},
        "flops": res["flops"], "product_flops": res["product_flops"],
        "kernel_flops": res["kernel_flops"],
        "bytes_accessed": res["bytes_accessed"], "bytes_min": res["bytes_min"],
        "collectives": {"total_bytes": coll["total_bytes"], "bytes": coll["bytes"],
                        "counts": coll["counts"], "link_bytes": coll["link_bytes"]},
        "kernels": res["kernels"],
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "accum_steps": accum, "accum_tried": tried,
        "divisibility_fallback": fallback_leaves(cfg, rules, mesh),
        "roofline": dict(terms, dominant=dominant.removesuffix("_s"),
                         step_s=terms[dominant],
                         useful_flops_ratio=useful / max(res["flops"] * dev, 1.0),
                         gb_per_card=need / 1e9,
                         fits_80gb=need <= lmesh.HBM_BYTES),
    }
    if verbose:
        print(f"[dryrun] {arch_name} x {shape_name} on {out['mesh']}: "
              f"flops/dev={out['flops']:.3e} bytes_min/dev={out['bytes_min']:.3e} "
              f"coll/dev={coll['total_bytes']:.3e}B arg={arg_total / 1e9:.2f}GB "
              f"temp={res['peak_bytes'] / 1e9:.2f}GB fits={need <= lmesh.HBM_BYTES} "
              f"dominant={out['roofline']['dominant']} accum={accum} "
              f"({out['trace_s']:.1f}s)", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None, help="e.g. 16x16 or 2x16x16")
    ap.add_argument("--accum-steps", type=int, default=None)
    ap.add_argument("--weight-stationary", action="store_true")
    ap.add_argument("--expert-parallel", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    mesh_shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else None

    cells = []
    if args.all:
        for cfg in ARCHS.values():
            for shape in SHAPES.values():
                active, why = cell_is_active(cfg, shape)
                if active:
                    cells.append((cfg.name, shape.name))
                else:
                    print(f"[skip] {cfg.name} × {shape.name}: {why}")
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]

    results, failures = [], []
    t0 = time.time()
    for arch, shape in cells:
        try:
            results.append(dryrun_cell(arch, shape, multi_pod=args.multi_pod,
                                       mesh_shape=mesh_shape,
                                       accum_steps=args.accum_steps,
                                       weight_stationary=args.weight_stationary,
                                       expert_parallel=args.expert_parallel))
        except Exception as e:  # noqa: BLE001 — record and continue the sweep
            traceback.print_exc()
            failures.append({"arch": arch, "shape": shape, "error": repr(e)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results, "failures": failures}, f, indent=1)
    print(f"[dryrun] done: {len(results)} ok, {len(failures)} failed "
          f"in {time.time() - t0:.0f}s")
    return 1 if failures else 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
