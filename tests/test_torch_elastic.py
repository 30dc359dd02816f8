"""Elastic restarts of the port (repro_torch.distributed.elastic) and the
sequence-parallel decode's plain version (distributed/collectives.py).

* ``best_mesh_shape`` on the cases of tests/test_elastic.py;
* a checkpoint the JAX package wrote, restored onto a port mesh
  (``restore(shardings=...)``): every leaf bit-equal, cut as asked;
* ``reshard_tree`` from one mesh onto another and back, bit-equal;
* ``FaultTolerantLoop.run(shardings=...)``: a run that fails, then resumes
  on another mesh shape, ends where the uninterrupted run ends;
* the sequence-parallel decode against ``repro.kernels.ref.decode_attention``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpoint import save as jsave  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.checkpoint.checkpoint import restore, save  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.collectives import (  # noqa: E402
    make_seqpar_decode_attention, seqpar_decode_ref)
from repro_torch.distributed.elastic import (best_mesh_shape,  # noqa: E402
                                             make_elastic_mesh, reshard_tree)
from repro_torch.distributed.ft import FaultTolerantLoop  # noqa: E402
from repro_torch.distributed.mesh import make_test_mesh  # noqa: E402


@pytest.mark.parametrize("n,want", [(512, (32, 16)), (256, (16, 16)), (240, (15, 16)),
                                    (252, (63, 4)), (13, (13, 1)), (1, (1, 1))])
def test_best_mesh_shape_degrades_gracefully(n, want):
    assert best_mesh_shape(n) == want


def test_make_elastic_mesh():
    m = make_elastic_mesh(["cpu"] * 8, model_parallel=4)
    assert m.shape == {"data": 2, "model": 4}
    assert make_elastic_mesh(["cpu"]).shape == {"data": 1, "model": 1}


def test_jax_checkpoint_restores_onto_a_port_mesh(tmp_path):
    d = str(tmp_path / "ckpt")
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    jsave(d, 7, {"w": jnp.asarray(w), "b": jnp.asarray(b), "step": jnp.array(7)})
    like = {"w": torch.zeros(8, 8), "b": torch.zeros(6), "step": torch.zeros((), dtype=torch.int32)}
    mesh = make_test_mesh((2, 2), devices="cpu")
    shardings = {"w": shd.NamedSharding(mesh, shd.P("data", "model")),
                 "b": shd.NamedSharding(mesh, shd.P("model")),     # 6 on 2: cut
                 "step": shd.NamedSharding(mesh, shd.P())}
    got, step = restore(d, like, shardings=shardings)
    assert step == 7
    assert isinstance(got["w"], shd.Shards) and [p.shape for p in got["w"].parts] == \
        [(8, 4), (8, 4)]
    assert torch.equal(shd.gather(got["w"]), torch.from_numpy(w))
    assert torch.equal(shd.gather(got["b"]), torch.from_numpy(b))
    assert int(got["step"]) == 7
    # the same checkpoint onto a (1, 4) mesh: b (6 rows) does not divide 4
    m4 = make_test_mesh((1, 4), devices="cpu")
    got4, _ = restore(d, like, shardings={k: shd.NamedSharding(m4, s.spec)
                                          for k, s in shardings.items()})
    assert len(got4["w"].parts) == 4 and isinstance(got4["b"], torch.Tensor)
    assert torch.equal(shd.gather(got4["w"]), torch.from_numpy(w))


def test_reshard_tree_places_leaves():
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(4, 8, generator=g), "b": (torch.randn(2, 4, generator=g),)}
    ps = {"a": shd.P(None, "model"), "b": (shd.P("data", "model"),)}
    m24 = make_test_mesh((2, 4), devices="cpu")
    out = reshard_tree(tree, m24, ps)
    assert len(out["a"].parts) == 4 and len(out["b"][0].parts) == 4
    back = reshard_tree(out, make_test_mesh((1, 2), devices="cpu"), ps)
    assert len(back["a"].parts) == 2
    for x, y in ((tree["a"], back["a"]), (tree["b"][0], back["b"][0])):
        assert torch.equal(shd.gather(y), x)
    host = shd.unshard(back)
    assert torch.equal(host["a"], tree["a"])


def _step(state, step):
    """An elementwise step (the same bits on any layout) that fails once."""
    if step == 5 and not _step.failed:
        _step.failed = True
        raise RuntimeError("injected fault")
    w = state["w"]
    f = (lambda t: t * 0.5 + float(step))
    if isinstance(w, shd.Shards):
        return {"w": shd.Shards([f(p) for p in w.parts], w.dim)}
    return {"w": f(w)}


def test_ft_resumes_onto_another_mesh(tmp_path):
    """Run 4 steps on a (1, 2) mesh, checkpoint, then restart with a step
    that fails once on a (2, 4) mesh: the end state equals the
    uninterrupted run's, bit for bit."""
    w0 = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
    spec = {"w": shd.P(None, "model")}
    _step.failed = True
    ref, _ = FaultTolerantLoop(str(tmp_path / "ref"), _step, ckpt_every=2).run(
        {"w": w0.clone()}, num_steps=8)
    d = str(tmp_path / "ckpt")
    m12 = make_test_mesh((1, 2), devices="cpu")
    state = reshard_tree({"w": w0.clone()}, m12, spec)
    part, rep = FaultTolerantLoop(d, _step, ckpt_every=2).run(state, num_steps=4)
    assert rep.final_step == 4 and len(part["w"].parts) == 2
    m24 = make_test_mesh((2, 4), devices="cpu")
    shardings = {"w": shd.NamedSharding(m24, spec["w"])}
    _step.failed = False
    out, rep = FaultTolerantLoop(d, _step, ckpt_every=2).run(
        part, num_steps=8, shardings=shardings)
    assert rep.restarts == 1 and rep.final_step == 8
    assert len(out["w"].parts) == 4
    assert torch.equal(shd.gather(out["w"]), ref["w"])


def test_save_gathers_shards(tmp_path):
    mesh = make_test_mesh((1, 2), devices="cpu")
    x = torch.arange(8.0).reshape(2, 4)
    save(str(tmp_path / "c"), 1, {"x": reshard_tree(x, mesh, shd.P(None, "model"))})
    got, _ = restore(str(tmp_path / "c"), {"x": torch.zeros(2, 4)})
    assert torch.equal(got["x"], x)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shards,window", [(4, None), (2, 24), (3, None)])
def test_seqpar_decode_plain_matches_reference(dtype, tol, shards, window):
    """The plain version over a cache cut by sequence into ``shards`` parts
    (uneven ones included) against the JAX package's oracle, ring windows
    and cache lengths across the wrap included."""
    rng = np.random.default_rng(0)
    B, W, K, G, hd = 3, 96, 2, 3, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, 1, K * G, hd), (B, W, K, hd), (B, W, K, hd)))
    clen = np.array([5, 60, 130])
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jref.decode_attention(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), jnp.asarray(clen),
        q_per_kv=G, window=window).astype(jnp.float32))
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    cuts = np.array_split(np.arange(W), shards)
    got = seqpar_decode_ref(tq, [tk[:, c] for c in cuts], [tv[:, c] for c in cuts],
                            torch.from_numpy(clen), q_per_kv=G, window=window)
    assert np.abs(got.float().numpy() - want).max() <= tol
    if W % shards == 0:
        f = make_seqpar_decode_attention(make_test_mesh((1, shards), devices="cpu"))
        alt = f(tq, tk, tv, torch.from_numpy(clen), q_per_kv=G, window=window)
        assert torch.equal(alt, got)
