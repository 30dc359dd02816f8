"""The reference's baseline layouts on the port (CPU meshes).

Under ``sharding.use_rules(rules_for(mesh, phase, ...))`` the port computes
on the parts each table lays out: FSDP over "data" (a layer gathers its
weights; the gradient of the gather is the parts' slices), q heads,
mlp-up, RG-LRU channels and expert hidden dims over "model" with the
down-projections row-parallel (partial sums added), "kv_seq" over "model"
for decode (the sequence-parallel split-K decode), ``weight_stationary``
and ``expert_parallel``. On (2, 4) and (2, 2, 2) CPU meshes:

* the train step under the train table (accumulation 1 and 2) equals the
  unsharded step for qwen, mixtral, recurrentgemma and xlstm: the loss
  (relative), every gradient leaf and the updated params, float32, within
  1e-5; mixtral and xlstm within 4x their own unsharded step's spread
  under a 1e-7 change of the params where that is larger (the reference's
  bf16 rounding of the MoE input and the mLSTM's exponential gates turn
  re-associated sums into more, as in tests/test_torch_training.py);
* the AdamW moments are laid out as their parameters;
* the unsharded step equals the JAX package's ``make_train_step``;
* prefill and decode under the prefill and decode tables (with "kv_seq",
  ``weight_stationary`` and ``expert_parallel``) give the unsharded greedy
  ids, logits within 1e-5 (mixtral: 2e-3, the JAX package's own bound for
  its MoE decode);
* ``FaultTolerantLoop.run(shardings=...)`` restarts a train-table run onto
  another mesh and lands on the unsharded trajectory.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.checkpoint.checkpoint import OptState  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.ft import FaultTolerantLoop  # noqa: E402
from repro_torch.distributed.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.training.optimizer import init_opt_state  # noqa: E402
from repro_torch.training.train_step import TrainConfig, make_train_step  # noqa: E402

KW = dict(dtype="float32", param_dtype="float32", vocab_size=512)
FAMILIES = ("qwen2.5-3b", "mixtral-8x22b", "recurrentgemma-9b", "xlstm-350m")
MESHES = ((2, 4), (2, 2, 2))
TOL = 1e-5
SPREAD = ("mixtral-8x22b", "xlstm-350m")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return ARCHS[arch].reduced(**KW)


def _batch(seed=0, B=4, S=16):
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, 500, (B, S))).int()
    return {"tokens": tok, "labels": torch.roll(tok, -1, 1),
            "positions": torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()}


def _diff(a, b):
    return float((a - b).abs().max())


def _perturbed(sd, seed=1):
    g = torch.Generator().manual_seed(seed)
    return {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=g)) for k, v in sd.items()}


def _unsharded(cfg, sd, batch, accum):
    params = Model(cfg, device="cpu").load(sd, trainable=True)
    step = make_train_step(cfg, TrainConfig(accum_steps=accum))
    loss, _, grads = step.loss_and_grads(params, batch)
    params, _, _ = step(params, init_opt_state(params), batch)
    return float(loss), grads, shd.full_state_dict(params)


def _bounds(arch, cfg, sd, batch, accum, ref):
    """TOL, or for mixtral and xlstm 4x the unsharded step's own spread
    under a 1e-7 parameter change where that is larger."""
    if arch not in SPREAD:
        return TOL, TOL
    _, g2, p2 = _unsharded(cfg, _perturbed(sd), batch, accum)
    _, g1, p1 = ref
    return (max(TOL, 4 * max(_diff(g2[k], g1[k]) for k in g1)),
            max(TOL, 4 * max(_diff(p2[k], p1[k]) for k in p1)))


@pytest.mark.parametrize("grid", MESHES)
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_table_step_equals_unsharded(arch, accum, grid):
    cfg = _cfg(arch)
    sd = Model(cfg, device="cpu").init(seed=0).state_dict()
    batch = _batch()
    ref = _unsharded(cfg, sd, batch, accum)
    gtol, ptol = _bounds(arch, cfg, sd, batch, accum, ref)
    mesh = make_test_mesh(grid, devices="cpu")
    rules = shd.rules_for(mesh, "train", expert_parallel=arch == "mixtral-8x22b")
    placed = shd.place_params(Model(cfg, device="cpu").load(sd), rules, trainable=True)
    assert any(isinstance(v, shd.Fsdp) or (isinstance(v, shd.Shards)
                                          and isinstance(v.parts[0], shd.Fsdp))
               for _, v in placed.named_parameters())
    step = make_train_step(cfg, TrainConfig(accum_steps=accum))
    opt = init_opt_state(placed)
    with shd.use_rules(rules):
        loss, _, grads = step.loss_and_grads(placed, batch)
        placed, opt, _ = step(placed, opt, batch)
    assert abs(float(loss) - ref[0]) <= TOL * abs(ref[0])
    for k, g in ref[1].items():
        assert _diff(shd.gather(grads[k]), g) <= gtol, k
    got = shd.full_state_dict(placed)
    for k, p in ref[2].items():
        assert _diff(got[k], p) <= ptol, k
    for k, v in placed.named_parameters():          # moments on the parts
        assert [t.shape for t in shd.leaf_parts(opt.m[k])] == \
            [t.shape for t in shd.leaf_parts(v)]
    if arch not in SPREAD:
        assert (gtol, ptol) == (TOL, TOL)


def test_unsharded_step_equals_jax():
    """The port's step on the JAX init equals ``make_train_step`` of the
    JAX package (accumulation 2): loss at 1e-5 relative, params at 1e-5."""
    arch = "qwen2.5-3b"
    jcfg, cfg = JARCHS[arch].reduced(**KW), _cfg(arch)
    jp = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(0)))
    batch = _batch()
    jstep = jax.jit(jts.make_train_step(jcfg, jts.TrainConfig(accum_steps=2)))
    jb = {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()}
    jnew, _, jm = jstep(jp, jopt.init_opt_state(jp), jb)
    params = Model(cfg, device="cpu").load(params_from_jax(jp, cfg), trainable=True)
    step = make_train_step(cfg, TrainConfig(accum_steps=2))
    params, _, m = step(params, init_opt_state(params), batch)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    want = params_from_jax(jax.tree.map(np.asarray, jnew), cfg)
    for k, p in shd.full_state_dict(params).items():
        assert _diff(p, want[k]) <= TOL, k


DECODE_CASES = [("qwen2.5-3b", (2, 4), {}), ("qwen2.5-3b", (2, 2, 2), {"ws": True}),
                ("mixtral-8x22b", (2, 4), {"ep": True}),
                ("mixtral-8x22b", (2, 2, 2), {"ws": True}),
                ("recurrentgemma-9b", (2, 4), {}), ("xlstm-350m", (2, 2, 2), {})]


def _serve(cfg, params, cache, rules_pf, rules_dec, tok, steps=6):
    B, S = tok.shape
    pos = torch.arange(S).expand(B, S).contiguous()
    ctx = (lambda r: shd.use_rules(r)) if rules_pf else (lambda r: torch.no_grad())
    with ctx(rules_pf):
        lg, cache = tfm.prefill(params, {"tokens": tok, "positions": pos}, cfg, cache)
    logits, ids = [lg[:, -1]], [lg[:, -1].argmax(-1)]
    for i in range(steps):
        clen = torch.full((B,), S + i, dtype=torch.int32)
        with ctx(rules_dec):
            lg, cache = tfm.decode_step(params, {"tokens": ids[-1][:, None],
                                                 "positions": clen[:, None].long()},
                                        cfg, cache, clen)
        logits.append(lg[:, 0])
        ids.append(lg[:, 0].argmax(-1))
    return torch.stack(logits), torch.stack(ids)


@pytest.mark.parametrize("arch,grid,var", DECODE_CASES)
def test_prefill_and_decode_tables_equal_unsharded(arch, grid, var):
    cfg = _cfg(arch)
    params = Model(cfg, device="cpu").init(seed=0)
    B, S, cap = 4, 24, 64
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, 500, (B, S))).long()
    want_l, want_i = _serve(cfg, params, tfm.init_cache(cfg, B, cap, "cpu"), None, None, tok)
    mesh = make_test_mesh(grid, devices="cpu")
    ep = var.get("ep", False)
    rp = shd.rules_for(mesh, "prefill", expert_parallel=ep)
    rd = shd.rules_for(mesh, "decode", weight_stationary=var.get("ws", False),
                       expert_parallel=ep)
    placed = shd.place_params(params, rp)
    cache = shd.shard_put(tfm.init_cache(cfg, B, cap, "cpu"), shd.cache_pspecs(cfg, rp),
                          mesh)
    if cfg.pattern[0] in tfm.ATTN_KINDS:          # "kv_seq": the sequence over "model"
        assert isinstance(cache["scan"]["sub0"]["k"], shd.Shards)
    got_l, got_i = _serve(cfg, placed, cache, rp, rd, tok)
    assert torch.equal(got_i, want_i)
    tol = 2e-3 if cfg.num_experts else TOL
    assert float((got_l - want_l).abs().max()) <= tol


def test_fault_tolerant_loop_restarts_onto_another_mesh(tmp_path):
    """A train-table run on (2, 4) checkpoints every step and fails at step
    3; a new loop restores the checkpoint onto (2, 2) and runs to step 4:
    the params equal 4 unsharded steps."""
    cfg = _cfg("qwen2.5-3b")
    sd = Model(cfg, device="cpu").init(seed=0).state_dict()
    step = make_train_step(cfg, TrainConfig())
    ref = Model(cfg, device="cpu").load(sd, trainable=True)
    ropt = init_opt_state(ref)
    for i in range(4):
        ref, ropt, _ = step(ref, ropt, _batch(i))

    def state_on(grid):
        rules = shd.rules_for(make_test_mesh(grid, devices="cpu"), "train")
        placed = shd.place_params(Model(cfg, device="cpu").load(sd), rules,
                                  trainable=True)
        return rules, dict(placed.named_parameters()), init_opt_state(placed)

    def step_fn(rules, fail_at=None):
        def fn(state, i):
            if i == fail_at:
                raise RuntimeError("injected failure")
            named, opt = state
            for leaf in named.values():
                for t in shd.leaf_parts(leaf):
                    t.requires_grad_(True)
            with shd.use_rules(rules):
                params, opt, _ = step(shd.placed_from(named), opt, _batch(i))
            return dict(params.named_parameters()), opt
        return fn

    rules_a, named, opt = state_on((2, 4))
    loop = FaultTolerantLoop(str(tmp_path), step_fn(rules_a, fail_at=3),
                             ckpt_every=1, max_restarts=0)
    with pytest.raises(RuntimeError):
        loop.run((named, opt), num_steps=4)
    loop.ckpt.wait()
    rules_b, named_b, opt_b = state_on((2, 2))
    mesh_b = rules_b["mesh"]
    specs = shd.state_dict_pspecs(Model(cfg, device="cpu").init(seed=0), rules_b)
    sh = {k: shd.NamedSharding(mesh_b, specs[k], fsdp=True) for k in named_b}
    shardings = (sh, OptState(step=shd.NamedSharding(mesh_b, shd.P()), m=sh, v=sh))
    loop_b = FaultTolerantLoop(str(tmp_path), step_fn(rules_b), ckpt_every=100)
    (named_b, opt_b), report = loop_b.run((named_b, opt_b), num_steps=4,
                                          shardings=shardings)
    assert report.final_step == 4 and report.steps_run == 1
    leaf = named_b["blocks.0.mlp.wi"]       # (2, 2): mlp over "model", embed FSDP
    assert isinstance(leaf, shd.Shards) and len(leaf.parts) == 2
    assert isinstance(leaf.parts[0], shd.Fsdp) and len(leaf.parts[0].parts) == 2
    want = shd.full_state_dict(ref)
    got = shd.full_state_dict(shd.placed_from(named_b))
    for k, p in want.items():
        assert _diff(got[k], p) <= TOL, k
