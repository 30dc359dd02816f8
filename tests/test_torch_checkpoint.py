"""The port's checkpoint module (repro_torch.checkpoint) against
repro.checkpoint on the CPU.

* checkpoints cross both ways, bit-equal: a JAX ``save`` of float32
  params, of bfloat16 params and of the ``(params, init_opt_state(params))``
  pair restores into the port (``Model.restore``) as ``params_from_jax``
  of the same tree; a port ``save`` of float32 params restores in the JAX
  ``restore``, and writes the same manifest and leaf files, byte for
  byte, as a JAX ``save`` of the same numbers (bfloat16 included);
* the port's leaf order and treedef string equal ``jax.tree.flatten``'s
  for every arch of the registry (reduced; shapes only), params alone and
  paired with an ``OptState``;
* the port's msgpack subset round-trips and gives ``msgpack.packb``'s
  bytes for manifests;
* ``latest``, ``_gc`` and ``AsyncCheckpointer`` behave as in
  tests/test_checkpoint_ft.py.

The reference's ``restore`` itself cannot read a bfloat16 leaf under this
JAX (``np.load`` gives ``|V2`` back and ``jnp.asarray`` has no cast from
it), so bfloat16 crosses only into the port here.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.training.optimizer import init_opt_state  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint import msgpack_lite  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving.server import LLMServer, SamplingParams  # noqa: E402

KW = dict(dtype="float32", param_dtype="float32", vocab_size=512)
CROSS_ARCHS = ["musicgen-large", "recurrentgemma-9b"]


def _cfgs(arch, **over):
    kw = dict(KW, **over)
    return JARCHS[arch].reduced(**kw), ARCHS[arch].reduced(**kw)


def _jparams(jcfg, seed=0):
    return JModel(jcfg).init(jax.random.PRNGKey(seed))


def _equal_sd(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].view(torch.int16) if got[k].dtype == torch.bfloat16
                           else got[k],
                           want[k].view(torch.int16) if want[k].dtype == torch.bfloat16
                           else want[k]), k


# ---------------------------------------------------------------------------
# tree layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_leaf_order_and_treedef_equal_jax(arch):
    jcfg, cfg = _cfgs(arch)
    shapes = jax.eval_shape(lambda: _jparams(jcfg))
    leaves, treedef = jax.tree.flatten(shapes)
    layout = convert.jax_layout(cfg)
    assert [s for _, s in layout] == [tuple(x.shape) for x in leaves]
    paths = [tuple(k.key for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    assert [p for p, _ in layout] == paths
    like = convert.nest((p, torch.empty(s, device="meta")) for p, s in layout)
    assert ckpt.checkpoint.flatten(like)[1] == str(treedef)
    opt = jax.eval_shape(init_opt_state, shapes)
    pair = (like, ckpt.OptState(step=0, m=like, v=like))
    assert ckpt.checkpoint.flatten(pair)[1] == str(jax.tree.flatten((shapes, opt))[1])


def test_flatten_matches_jax_on_mixed_trees():
    trees = [{"b": (1, 2), "a": (3, {"z": 4, "y": None}), "c": (5,)},
             (1,), (), {}, ({"x": 1}, None)]
    for t in trees:
        leaves, treedef = jax.tree.flatten(t)
        got, got_def = ckpt.checkpoint.flatten(t)
        assert got == leaves and got_def == str(treedef)
        assert ckpt.checkpoint.unflatten(t, got) == t


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_params_to_jax_inverts_params_from_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp = jax.tree.map(np.asarray, _jparams(jcfg))
    back = convert.params_to_jax(convert.params_from_jax(jp, cfg), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert np.array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# msgpack subset
# ---------------------------------------------------------------------------


def test_msgpack_lite_round_trips_and_matches_msgpack():
    vals = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 64 - 1, -1,
            -32, -33, -128, -129, -2 ** 15 - 1, -2 ** 31 - 1, -2 ** 63, True,
            False, None, "", "a" * 31, "a" * 32, "é" * 200, "a" * 70000,
            list(range(15)), list(range(16)), list(range(70000)),
            {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
            {str(i): i for i in range(70000)}]
    for v in vals:
        b = msgpack_lite.packb(v)
        assert b == msgpack.packb(v)
        assert msgpack_lite.unpackb(b) == v
    with pytest.raises(TypeError):
        msgpack_lite.packb(1.5)
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(msgpack.packb(1.5))


@pytest.mark.parametrize("arch", ["chameleon-34b", "xlstm-350m"])
def test_manifest_bytes_equal_msgpack(arch, tmp_path):
    """A full-size manifest (shapes only), params and the training pair."""
    cfg = ARCHS[arch]
    layout = convert.jax_layout(cfg)
    like = convert.nest((p, torch.empty(s, device="meta", dtype=torch.bfloat16))
                        for p, s in layout)
    for tree in (like, (like, ckpt.OptState(step=torch.empty((), dtype=torch.int32),
                                            m=like, v=like))):
        leaves, treedef = ckpt.checkpoint.flatten(tree)
        manifest = {"step": 123456, "treedef": treedef,
                    "leaves": [{"shape": list(x.shape),
                                "dtype": str(x.dtype)[len("torch."):]}
                               for x in leaves]}
        b = msgpack_lite.packb(manifest)
        assert b == msgpack.packb(manifest)
        assert msgpack_lite.unpackb(b) == msgpack.unpackb(b)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", CROSS_ARCHS)
@pytest.mark.parametrize("form", ["float32", "bfloat16", "with_opt_state"])
def test_jax_checkpoint_restores_into_port_bit_equal(arch, form, tmp_path):
    dt = "bfloat16" if form == "bfloat16" else "float32"
    jcfg, cfg = _cfgs(arch, param_dtype=dt)
    jp = _jparams(jcfg)
    tree = (jp, init_opt_state(jp)) if form == "with_opt_state" else jp
    d = str(tmp_path / "ckpt")
    jckpt.save(d, 7, tree)
    params, step = Model(cfg, device="cpu").restore(d)
    assert step == 7
    want = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    _equal_sd(params.state_dict(), want)


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_port_checkpoint_restores_in_jax_bit_equal(arch, tmp_path):
    jcfg, cfg = _cfgs(arch)
    jp = _jparams(jcfg, seed=3)
    sd = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 11, convert.params_to_jax(sd, cfg))
    got, step = jckpt.restore(d, jax.tree.map(jnp.zeros_like, jp))
    assert step == 11
    assert jax.tree.structure(got) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_port_and_jax_write_the_same_files(dt, tmp_path):
    jcfg, cfg = _cfgs("musicgen-large", param_dtype=dt)
    jp = _jparams(jcfg)
    opt = init_opt_state(jp)
    sd = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    tsd = convert.params_to_jax(sd, cfg)
    topt = ckpt.OptState(step=torch.zeros((), dtype=torch.int32),
                         m=jax.tree.map(lambda x: torch.zeros(x.shape), tsd),
                         v=jax.tree.map(lambda x: torch.zeros(x.shape), tsd))
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save(jdir, 3, (jp, opt))
    ckpt.save(tdir, 3, (tsd, topt))
    names = sorted(os.listdir(os.path.join(jdir, "step_00000003")))
    assert names == sorted(os.listdir(os.path.join(tdir, "step_00000003")))
    assert len(names) == 1 + 3 * len(jax.tree.leaves(jp)) + 1
    for n in names:
        with open(os.path.join(jdir, "step_00000003", n), "rb") as f:
            a = f.read()
        with open(os.path.join(tdir, "step_00000003", n), "rb") as f:
            assert f.read() == a, n


def test_restore_params_refuses_other_trees(tmp_path):
    """A checkpoint of another model, or of another tree, is refused with
    what was found."""
    _, cfg = _cfgs("musicgen-large")
    jcfg2, _ = _cfgs("chameleon-34b")
    d = str(tmp_path / "other")
    jckpt.save(d, 1, _jparams(jcfg2))
    with pytest.raises(ValueError, match="found .* leaves, treedef"):
        Model(cfg, device="cpu").restore(d)
    d2 = str(tmp_path / "tree")
    ckpt.save(d2, 1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="found 1 leaves"):
        Model(cfg, device="cpu").restore(d2)
    with pytest.raises(FileNotFoundError):
        Model(cfg, device="cpu").restore(str(tmp_path / "none"))


def test_restored_server_serves_the_same_ids(tmp_path):
    """Save a model's params, restore them into another model, and serve:
    the same greedy ids as the in-memory params."""
    jcfg, cfg = _cfgs("musicgen-large")
    sd = convert.params_from_jax(jax.tree.map(np.asarray, _jparams(jcfg)), cfg)
    m = Model(cfg, device="cpu")
    params = m.load(sd)
    d = str(tmp_path / "ckpt")
    ck = ckpt.AsyncCheckpointer(d)
    ck.save(1, convert.params_to_jax(params.state_dict(), cfg))
    ck.wait()
    restored, step = Model(cfg, device="cpu").restore(d)
    assert step == 1
    _equal_sd(restored.state_dict(), params.state_dict())
    outs = []
    for p in (params, restored):
        srv = LLMServer(cfg, num_slots=2, capacity=64, params=p, device="cpu")
        hs = [srv.submit(t, SamplingParams(max_new_tokens=6))
              for t in ("first prompt", "a second one")]
        srv.run_until_idle()
        outs.append([h.request.output_ids for h in hs])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the module's own behaviour (tests/test_checkpoint_ft.py)
# ---------------------------------------------------------------------------


def _tree(x=0.0):
    return {"w": torch.full((4, 4), x), "opt": {"m": torch.full((4,), x * 2)},
            "cursor": torch.tensor(int(x), dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 5, _tree(1.5))
    got, step = ckpt.restore(d, _tree(0.0))
    assert step == 5
    assert torch.equal(got["w"], torch.full((4, 4), 1.5))
    assert torch.equal(got["opt"]["m"], torch.full((4,), 3.0))
    assert got["cursor"].dtype == torch.int32 and int(got["cursor"]) == 1
    with pytest.raises(ValueError, match="tree structure changed"):
        ckpt.restore(d, {"w": torch.zeros(4, 4)})


def test_latest_pointer_and_gc(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, _tree(float(s)), keep=2)
    dirs = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert dirs == ["step_00000004", "step_00000005"]
    assert ckpt.latest_step_dir(d) == os.path.join(d, "step_00000005")
    got, step = ckpt.restore(d, _tree())
    assert step == 5 and float(got["w"][0, 0]) == 5.0
    assert ckpt.latest_step_dir(str(tmp_path / "none")) is None


def test_async_checkpointer_snapshot_isolation(tmp_path):
    d = str(tmp_path / "ckpt")
    ck = ckpt.AsyncCheckpointer(d)
    t = _tree(1.0)
    ck.save(1, t)
    t["w"].mul_(100)               # mutate in place after save: must not leak in
    ck.wait()
    got, _ = ckpt.restore(d, _tree())
    assert torch.equal(got["w"], torch.ones(4, 4))
