"""The port's launch layer (``repro_torch.launch``) against the JAX package.

* the H100 production meshes: shapes, axes, ``meta`` devices, and only the
  card's constants;
* per-device argument bytes (params, AdamW state, batch, cache) of every
  registry arch and active shape on the reference's (16, 16) and
  (2, 16, 16) grids equal the reference's, computed by
  ``NamedSharding(AbstractMesh(...), spec).shard_shape`` over the JAX
  package's specs, with its ``_divisible_spec`` fallback (``shard_shape``
  raises where GSPMD would pad); the fallback's leaves are the same;
* the cost counter's product FLOPs on reduced float32 prefill, decode and
  train cells (qwen, recurrentgemma, mixtral, xlstm) within 5% of
  ``repro.launch.hlo_cost`` over the reference's compiled cell: both
  without attention's products (the reference's dots with two or more
  batch dims: XLA's masked S x T scores and P·V, forward and backward; the
  port's attention and mLSTM run in kernels, forward and backward, counted
  apart by their analytic costs; no product runs inside a profiler range;
  the sLSTM's recurrent products, dots of one batch dim in the reference,
  run in its two kernels and count at their analytic FLOPs);
* xlstm's prefill traced with trip counts equals its step-by-step trace
  (S = 16; the sLSTM over time is one kernel operator, no host loop);
* ``dryrun_cell`` of qwen2.5-3b ``decode_32k`` and mixtral-8x22b
  ``train_4k`` at full width on (32, 8): JAX-free, the reference's keys
  and the H100 roofline terms.
"""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.configs.registry import SHAPES as JSHAPES  # noqa: E402
from repro.configs.registry import cell_is_active as jactive  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch.input_specs import batch_specs as jbatch_specs  # noqa: E402
from repro.launch.input_specs import cache_specs as jcache_specs  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.mesh import make_test_mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRIDS = [(16, 16), (2, 16, 16)]


def test_production_meshes_are_h100_hosts_on_meta():
    sp, mp = lmesh.make_production_mesh(), lmesh.make_production_mesh(multi_pod=True)
    assert (sp.shape, sp.axis_names) == ({"data": 32, "model": 8}, ("data", "model"))
    assert mp.shape == {"pod": 2, "data": 32, "model": 8}
    assert mp.axis_names == ("pod", "data", "model")
    assert lmesh.devices(sp) == 256 and lmesh.devices(mp) == 512
    assert sp.distinct_devices() == (torch.device("meta"),)
    ref = lmesh.make_production_mesh(shape=(16, 16))
    assert ref.shape == {"data": 16, "model": 16}
    assert lmesh.PEAK_FLOPS == {"bfloat16": 989e12, "float16": 989e12,
                                "tf32": 495e12, "float32": 67e12}
    assert (lmesh.HBM_BYTES, lmesh.HBM_BW) == (80e9, 3.35e12)
    assert (lmesh.NVLINK_BW, lmesh.IB_BW) == (450e9, 50e9)
    text = (ROOT / "src" / "repro_torch" / "launch" / "mesh.py").read_text()
    for tpu in ("197e12", "819e9", "ICI", "v5e"):
        assert tpu not in text
    with pytest.raises(ValueError):
        from repro_torch.device import resolve_device
        resolve_device("xla")


# ---------------------------------------------------------------------------
# argument bytes a device holds
# ---------------------------------------------------------------------------


def _jbytes(sds, spec, amesh):
    spec = jshd._divisible_spec(sds.shape, spec, amesh)
    shape = NamedSharding(amesh, spec).shard_shape(sds.shape)
    return int(np.prod(shape)) * np.dtype(sds.dtype).itemsize


def _jtree_bytes(sds_tree, spec_tree, amesh):
    leaves = jax.tree.leaves(sds_tree)
    specs = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, jshd.P))
    assert len(leaves) == len(specs)
    return sum(_jbytes(s, p, amesh) for s, p in zip(leaves, specs))


def _reference_bytes(name, shape_name, grid):
    jcfg, shape = JARCHS[name], JSHAPES[shape_name]
    amesh = AbstractMesh(grid, ("pod", "data", "model")[-len(grid):])
    rules = jshd.rules_for(amesh, shape.phase, shard_batch=shape.global_batch > 1)
    model = JModel(jcfg)
    p_specs = model.param_specs()
    p_pspecs = jshd.param_pspecs(model.param_axes(), rules)
    out = {"params": _jtree_bytes(p_specs, p_pspecs, amesh)}
    if shape.phase == "train":
        o = jopt.opt_state_specs(p_specs)
        op = jopt.opt_state_pspecs(p_pspecs)
        out["opt_state"] = (_jtree_bytes(o.m, op.m, amesh) + _jtree_bytes(o.v, op.v, amesh)
                            + _jbytes(o.step, op.step, amesh))
    out["batch"] = _jtree_bytes(jbatch_specs(jcfg, shape),
                                jshd.batch_pspecs(jcfg, rules, shape.phase), amesh)
    c = jcache_specs(jcfg, shape)
    if c is not None:
        out["cache"] = _jtree_bytes(c, jshd.cache_pspecs(jcfg, rules), amesh)
        if shape.phase == "decode":
            out["cache_len"] = 4
    fallback = set()
    for path, s in jax.tree_util.tree_flatten_with_path(p_specs)[0]:
        spec = p_pspecs
        for k in path:
            spec = spec[k.key]
        if jshd._divisible_spec(s.shape, spec, amesh) != spec:
            fallback.add(tuple(str(k.key) for k in path[-2:]))
    return out, fallback


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_argument_bytes_equal_reference(name):
    """Every active shape of ``name`` on (16, 16) and (2, 16, 16)."""
    cfg = ARCHS[name]
    for shape_name, shape in JSHAPES.items():
        if not jactive(JARCHS[name], shape)[0]:
            continue
        tshape = dryrun.get_shape(shape_name)
        for grid in GRIDS:
            mesh = lmesh.make_production_mesh(shape=grid)
            rules = shd.rules_for(mesh, tshape.phase,
                                  shard_batch=tshape.global_batch > 1)
            got = dryrun.argument_bytes(cfg, tshape, mesh, rules)
            want, fallback = _reference_bytes(name, shape_name, grid)
            assert got == want, (name, shape_name, grid)
            names = {tuple(n.split(".")[-2:]) for n in
                     dryrun.fallback_leaves(cfg, rules, mesh)}
            assert names == fallback, (name, shape_name, grid)


# ---------------------------------------------------------------------------
# product FLOPs against the reference's compiled cell
# ---------------------------------------------------------------------------

KW = dict(dtype="float32", param_dtype="float32", vocab_size=512)
FLOP_CELLS = [(a, p) for a in ("qwen2.5-3b", "recurrentgemma-9b", "mixtral-8x22b",
                               "xlstm-350m") for p in ("prefill", "decode", "train")]
B, S = 4, 64


def _dot_flops_without_attention(hlo: str) -> float:
    """``hlo_cost``'s trip-count-aware dot FLOPs, leaving out dots with two
    or more batch dims (attention's scores and P·V)."""
    comps, symbols = hlo_cost.parse_module(hlo)
    entry = next(c for c in comps.values() if c.is_entry)
    total = 0.0

    def visit(comp, mult):
        nonlocal total
        for ins in comp.instrs:
            if ins.opcode == "while":
                trip = hlo_cost._while_trip_count(ins, comps)
                for name, role in hlo_cost._called_comps(ins):
                    if name in comps and role == "body":
                        visit(comps[name], mult * trip)
                continue
            if ins.opcode in ("fusion", "call", "conditional"):
                for name, _ in hlo_cost._called_comps(ins):
                    if name in comps:
                        visit(comps[name], mult)
                continue
            if ins.opcode != "dot":
                continue
            batch = re.search(r"lhs_batch_dims=\{([0-9,]*)\}", ins.rest)
            if batch and len([d for d in batch.group(1).split(",") if d]) >= 2:
                continue
            m = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", ins.rest)
            lhs = hlo_cost._first_shape_dims(symbols.get(ins.operands[0], ""))
            k = 1
            for ci in m.group(1).split(","):
                if ci:
                    k *= lhs[int(ci)]
            total += mult * 2 * hlo_cost._shape_numel(ins.result_type) * k

    visit(entry, 1.0)
    return total


def _reference_cell_hlo(name, phase):
    jcfg = JARCHS[name].reduced(**KW)
    shape = JSHAPES[{"prefill": "prefill_32k", "decode": "decode_32k",
                     "train": "train_4k"}[phase]]
    shape = type(shape)(shape.name, S, B, phase)
    model = JModel(jcfg)
    p = model.param_specs()
    b = jbatch_specs(jcfg, shape)
    if phase == "train":
        step = jts.make_train_step(jcfg, jts.TrainConfig())
        args = (p, jopt.opt_state_specs(p), b)
        fn = step
    elif phase == "prefill":
        args = (p, b, jcache_specs(jcfg, shape))
        fn = lambda pp, bb, cc: jtfm.prefill(pp, bb, jcfg, cc)  # noqa: E731
    else:
        args = (p, b, jcache_specs(jcfg, shape),
                jax.ShapeDtypeStruct((), jax.numpy.int32))
        fn = lambda pp, bb, cc, cl: jtfm.decode_step(pp, bb, jcfg, cc, cl)  # noqa: E731
    return jax.jit(fn).lower(*args).compile().as_text()


@pytest.mark.parametrize("name,phase", FLOP_CELLS)
def test_product_flops_match_hlo_cost(name, phase):
    cfg = ARCHS[name].reduced(**KW)
    shape = ShapeConfig(f"{phase}_test", S, B, phase)
    run = dryrun.build_cell(cfg, shape, make_test_mesh((1, 1), devices="meta"))[0]
    res = dryrun.trace(run)
    # the gradients of attention and of the mLSTM chunk are kernels, counted
    # apart (their products are left out as the reference's batched dots are);
    # the sLSTM's recurrent products (h·R forward, dg·Rᵀ backward) moved
    # into its two kernels, and the reference counts them as dots of one
    # batch dim: they count here at the kernels' analytic FLOPs
    got = res["product_flops"] + sum(res["kernel_flops_by"].get(k, 0.0)
                                     for k in ("slstm_scan", "slstm_scan_bwd"))
    want = _dot_flops_without_attention(_reference_cell_hlo(name, phase))
    assert abs(got - want) <= 0.05 * want, (got, want)
    assert not res["range_product_flops"]
    if name == "xlstm-350m":
        assert res["kernels"]["slstm_scan"] > 0
    if name == "xlstm-350m" and phase == "train":
        assert res["kernels"]["mlstm_chunk_bwd"] > 0
        assert res["kernel_flops_by"]["mlstm_chunk_bwd"] > 0
        assert res["kernels"]["slstm_scan_bwd"] > 0


def test_slstm_trip_count_equals_the_traced_loop():
    """xlstm's prefill over S = 16 traced with trip counts equals the
    step-by-step trace, in every count: the sLSTM over time is one call
    of its kernel's operator either way."""
    cfg = ARCHS["xlstm-350m"].reduced(**KW)
    shape = ShapeConfig("prefill_test", 16, 2, "prefill")
    run = dryrun.build_cell(cfg, shape, make_test_mesh((1, 1), devices="meta"))[0]
    once, every = dryrun.trace(run), dryrun.trace(run, trip_counts=False)
    for key in ("flops", "product_flops", "bytes_accessed", "bytes_min"):
        assert once[key] == pytest.approx(every[key], rel=1e-12), key


def test_per_device_counts_follow_the_layout():
    """One device of a (2, 4) mesh does a quarter of the model-parallel
    products of a (2, 1) mesh's device, plus the replicated K / V
    projections, on half the (1, 1) batch."""
    cfg = ARCHS["qwen2.5-3b"].reduced(**KW)
    shape = ShapeConfig("prefill_test", S, B, "prefill")
    flops = {}
    for grid in ((1, 1), (2, 1), (2, 4)):
        run = dryrun.build_cell(cfg, shape, make_test_mesh(grid, devices="meta"))[0]
        flops[grid] = dryrun.trace(run)["product_flops"]
    assert flops[(2, 1)] == pytest.approx(flops[(1, 1)] / 2, rel=1e-9)
    kv = 2 * 2 * (B // 2) * S * cfg.d_model * cfg.num_kv_heads * cfg.head_dim \
        * cfg.num_layers
    assert flops[(2, 4)] == pytest.approx((flops[(2, 1)] - kv) / 4 + kv, rel=1e-9)


# ---------------------------------------------------------------------------
# full-width cells
# ---------------------------------------------------------------------------

KEYS = {"arch", "shape", "mesh", "devices", "phase", "memory", "flops",
        "bytes_accessed", "bytes_min", "collectives", "params", "active_params"}


@pytest.mark.parametrize("arch,shape,accum", [("qwen2.5-3b", "decode_32k", None),
                                              ("mixtral-8x22b", "train_4k", 8)])
def test_dryrun_cell_full_width_without_jax(arch, shape, accum):
    code = (
        "import json, sys\n"
        "from repro_torch.launch import dryrun\n"
        f"r = dryrun.dryrun_cell({arch!r}, {shape!r}, verbose=False, accum_steps={accum})\n"
        "assert not any(m.split('.')[0] in ('jax', 'repro') for m in sys.modules)\n"
        "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert KEYS <= set(r)
    assert (r["mesh"], r["devices"]) == ("32x8", 256)
    assert {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes"} <= set(r["memory"])
    assert {"total_bytes", "bytes", "counts"} <= set(r["collectives"])
    roof = r["roofline"]
    assert {"compute_s", "memory_s", "nvlink_s", "infiniband_s", "dominant",
            "useful_flops_ratio", "fits_80gb"} <= set(roof)
    assert r["flops"] > 0 and r["bytes_min"] > 0 and r["collectives"]["total_bytes"] > 0
    assert 0 < roof["useful_flops_ratio"] <= 1.5
    if r["phase"] == "train":
        assert r["accum_steps"] == accum
        assert r["collectives"]["bytes"]["reduce-scatter"] > 0
        assert r["collectives"]["bytes"]["all-gather"] > 0
    else:
        assert r["kernels"].get("split_decode_partials", 0) > 0
