"""The port's sharding tables and mesh layout (repro_torch.distributed)
against repro.distributed.sharding and repro.launch.mesh.

* ``rules_for`` (every phase and option, multi-pod included; the "mesh"
  entry aside), ``param_axes``, ``param_pspecs``, ``cache_pspecs`` and
  ``batch_pspecs`` equal the JAX package's for every registry arch;
* the serve rules never split a contraction;
* ``shard_put``'s divisibility fallback, ``constrain`` (a no-op outside a
  rules context), ``make_test_mesh``'s axis names and device count;
* placed params and pools: each "model" part contiguous on its device, the
  GQA groups whole on a shard.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.mesh import make_host_mesh, make_test_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402

PHASES = [("train", {}), ("decode", {}), ("serve", {}),
          ("decode", dict(weight_stationary=True)),
          ("train", dict(expert_parallel=True)),
          ("decode", dict(expert_parallel=True)),
          ("train", dict(shard_batch=False)),
          ("serve", dict(shard_batch=False))]
PHASE_IDS = [p + "".join(f"-{k}" for k in kw) for p, kw in PHASES]


def _meshes(pods: bool):
    """(JAX mesh, port mesh) with the same axis names: the tables depend
    on the names only."""
    if pods:
        return (jax.make_mesh((1, 1, 1), ("pod", "data", "model")),
                make_test_mesh((2, 2, 2), devices="cpu"))
    return jax.make_mesh((1, 1), ("data", "model")), make_test_mesh((2, 4), devices="cpu")


def _spec(x):
    """A spec (JAX's or the port's) as a plain tuple, or a tree of them."""
    if isinstance(x, (JP, shd.P)):
        return tuple(x)
    if isinstance(x, dict):
        return {k: _spec(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_spec(v) for v in x)
    return x


def _jaxes(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x))


@pytest.mark.parametrize("pods", [False, True], ids=["2d", "multi_pod"])
@pytest.mark.parametrize("phase,kw", PHASES, ids=PHASE_IDS)
def test_rules_equal_jax(phase, kw, pods):
    jm, pm = _meshes(pods)
    want = {k: v for k, v in jshd.rules_for(jm, phase, **kw).items() if k != "mesh"}
    got = shd.rules_for(pm, phase, **kw)
    assert got["mesh"] is pm
    assert {k: v for k, v in got.items() if k != "mesh"} == want


def test_multi_pod_rules_add_pod_axis():
    _, pm = _meshes(True)
    assert shd.rules_for(pm, "train")["batch"] == ("pod", "data")
    assert shd.rules_for(pm, "serve")["batch"] == ("pod", "data")
    _, pm2 = _meshes(False)
    assert shd.rules_for(pm2, "train")["batch"] == ("data",)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_axes_and_pspecs_equal_jax(name):
    jaxes = _jaxes(JModel(JARCHS[name]).param_axes())
    axes = shd.param_axes(ARCHS[name])
    assert axes == jaxes
    jm, pm = _meshes(False)
    for phase, kw in PHASES:
        want = jshd.param_pspecs(JModel(JARCHS[name]).param_axes(),
                                 jshd.rules_for(jm, phase, **kw))
        got = shd.param_pspecs(axes, shd.rules_for(pm, phase, **kw))
        assert _spec(got) == _spec(want), (name, phase, kw)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cache_and_batch_pspecs_equal_jax(name):
    for pods in (False, True):
        jm, pm = _meshes(pods)
        for phase, kw in PHASES:
            jr, pr = jshd.rules_for(jm, phase, **kw), shd.rules_for(pm, phase, **kw)
            assert _spec(shd.cache_pspecs(ARCHS[name], pr)) == \
                _spec(jshd.cache_pspecs(JARCHS[name], jr)), (name, phase, kw)
            for bp in ("train", "decode", "serve"):
                assert _spec(shd.batch_pspecs(ARCHS[name], pr, bp)) == \
                    _spec(jshd.batch_pspecs(JARCHS[name], jr, bp))


def test_every_emitted_axis_has_a_rule():
    axes = set()

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            axes.update(a for a in t if a is not None)
    for name in ARCHS:
        walk(shd.param_axes(ARCHS[name]))
    _, pm = _meshes(False)
    for phase, kw in PHASES:
        rules = shd.rules_for(pm, phase, **kw)
        assert not sorted(a for a in axes if a not in rules)


def test_serve_rules_never_split_a_contraction():
    _, pm = _meshes(False)
    rules = shd.rules_for(pm, "serve")
    for side in ("embed", "heads_in", "mlp_in", "rnn_in", "moe_mlp", "moe_embed",
                 "inner", "kv_seq", "heads_act", "mlp_act", "rnn_act"):
        assert rules[side] == (), side
    assert rules["batch"] == ("data",) and rules["cache_batch"] == ("data",)
    for batch_like in ("vocab", "heads", "kv_heads", "mlp", "experts",
                       "experts_run", "rnn"):
        assert rules[batch_like] == ("model",), batch_like
    qwen = shd.cache_pspecs(ARCHS["qwen2.5-3b"], rules)
    assert qwen["scan"]["sub0"]["k"] == (None, "data", None, "model", None)
    rg = shd.cache_pspecs(ARCHS["recurrentgemma-9b"], rules)
    assert rg["scan"]["sub0"]["h"] == (None, "data", "model")


def test_make_test_mesh_shapes():
    m = make_test_mesh((2, 4), devices="cpu")
    assert m.axis_names == ("data", "model") and m.shape == {"data": 2, "model": 4}
    assert m.size == 8 and m.distinct_devices() == (torch.device("cpu"),)
    assert make_test_mesh((1, 2, 2), devices="cpu").axis_names == ("pod", "data", "model")
    h = make_host_mesh("cpu")
    assert h.shape == {"data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="device_count"):
        make_test_mesh((4, 4), devices=["cpu"] * 8)


def test_shard_put_divisibility_fallback():
    mesh = make_test_mesh((2, 4), devices="cpu")
    x = torch.arange(12.0).reshape(3, 4)
    assert shd._divisible_spec((3, 4), shd.P("data", "model"), mesh) == (None, "model")
    out = shd.shard_put({"w": x}, {"w": shd.P("data", "model")}, mesh)["w"]
    assert isinstance(out, shd.Shards) and len(out) == 4 and out.dim == 1
    assert all(p.is_contiguous() and p.shape == (3, 1) for p in out.parts)
    assert torch.equal(shd.gather(out), x)
    # 2 KV heads on a 4-way "model" axis: that dim stays whole
    kv = torch.randn(2, 8, 2, 4)
    got = shd.shard_put(kv, shd.P("data", None, "model", None), mesh)
    assert isinstance(got, torch.Tensor) and torch.equal(got, kv)


def test_constrain_is_a_no_op_outside_rules():
    mesh = make_test_mesh((1, 2), devices="cpu")
    x = torch.randn(3, 4, 6)
    assert shd.constrain(x, "batch", None, "mlp") is x
    with shd.use_rules(shd.rules_for(mesh, "serve")):
        s = shd.constrain(x, "batch", None, "mlp")
        assert isinstance(s, shd.Shards) and [p.shape[-1] for p in s.parts] == [3, 3]
        g = shd.constrain(s, "batch", None, "mlp_act")
        assert torch.equal(g, x)
        assert shd.current_rules()["phase"] == "serve"
    assert shd.current_rules() is None


def test_placed_params_keep_gqa_groups_whole():
    """q heads and their KV heads share a shard; when the KV heads do not
    divide "model" both stay whole. Every part is contiguous."""
    mesh = make_test_mesh((2, 4), devices="cpu")
    rules = shd.rules_for(mesh, "serve")
    for kv, sharded in ((4, True), (2, False)):
        cfg = ARCHS["qwen2.5-3b"].reduced(dtype="float32", param_dtype="float32",
                                          vocab_size=512, num_kv_heads=kv)
        params = Model(cfg, device="cpu").init(0)
        placed = shd.place_params(params, rules)
        a = placed.blocks[0].attn
        assert isinstance(a.wq, shd.Shards) == sharded == isinstance(a.wk, shd.Shards)
        assert not isinstance(a.wo, shd.Shards)
        assert isinstance(placed.blocks[0].mlp.wi, shd.Shards)
        if sharded:
            assert all(p.is_contiguous() for p in a.wq.parts)
            assert torch.equal(shd.gather(a.wq), params.blocks[0].attn.wq)
        assert shd.source_params(placed) is params
