"""The port's fault-tolerant loop (repro_torch.distributed.ft) and training
checkpoints across the two packages, on the CPU.

* tests/test_checkpoint_ft.py:48 and :65 on the port's loop: one injected
  failure is replayed from the last checkpoint (exactly-once), and a fresh
  loop resumes a finished one's checkpoint and runs only the rest;
* a ``(params, OptState)`` checkpoint that the JAX package wrote after 3
  JAX steps resumes in the port (``state_from_jax``), and the port's next
  2 steps equal JAX's next 2: losses at 1e-5, params at 1e-4 relative to
  each leaf's largest value or 4x JAX's own spread under float32 noise
  (``test_torch_training._check_params``);
* the port's checkpoint of a trained state restores in JAX bit for bit.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.checkpoint import checkpoint as tckpt  # noqa: E402
from repro_torch.distributed.ft import FaultTolerantLoop, Heartbeat  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_training as tt  # noqa: E402

KW = dict(lr=1e-2, warmup_steps=1, total_steps=10)


def test_ft_loop_recovers_from_injected_failure(tmp_path):
    d = str(tmp_path / "ckpt")
    fail_at = {30}

    def step_fn(state, step):
        if step in fail_at:
            fail_at.discard(step)           # fail once
            raise RuntimeError("injected node failure")
        return {"w": state["w"] + 1.0}

    loop = FaultTolerantLoop(d, step_fn, ckpt_every=10, max_restarts=2)
    state, report = loop.run({"w": torch.zeros(())}, num_steps=50)
    assert report.restarts == 1
    assert float(state["w"]) == 50.0        # exactly-once semantics via replay
    assert report.final_step == 50
    assert loop.heartbeat.alive


def test_ft_loop_resumes_across_process_restart(tmp_path):
    d = str(tmp_path / "ckpt")

    def step_fn(state, step):
        return {"w": state["w"] + 1.0}

    loop = FaultTolerantLoop(d, step_fn, ckpt_every=5)
    loop.run({"w": torch.zeros(())}, num_steps=20)
    # "new process": fresh loop resumes from the checkpoint, runs further
    loop2 = FaultTolerantLoop(d, step_fn, ckpt_every=5)
    state, report = loop2.run({"w": torch.zeros(())}, num_steps=30)
    assert float(state["w"]) == 30.0
    assert report.steps_run == 10           # only the remaining steps


def test_ft_loop_gives_up_after_max_restarts(tmp_path):
    def step_fn(state, step):
        raise RuntimeError("always down")

    loop = FaultTolerantLoop(str(tmp_path / "ckpt"), step_fn, max_restarts=2)
    with pytest.raises(RuntimeError, match="always down"):
        loop.run({"w": torch.zeros(())}, num_steps=3)
    hb = Heartbeat(timeout_s=0.0)
    assert not hb.alive


def _jax_steps(jcfg, jstate, start, n, accum=1):
    """n JAX steps from ``jstate`` on the batches of steps start.. (the
    training test's data); returns (state, losses)."""
    jstep = jax.jit(tt.jts.make_train_step(jcfg, tt.jts.TrainConfig(
        opt=jopt.AdamWConfig(**KW), accum_steps=accum)))
    data = tt.jdata.SyntheticLM(tt.jdata.DataConfig(
        global_batch=4, seq_len=32, vocab_size=jcfg.vocab_size), jcfg)
    losses = []
    for i in range(start, start + n):
        p, o, m = jstep(*jstate, data.batch_at(i))
        jstate = (p, o)
        losses.append(float(m["loss"]))
    return jstate, losses


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    d = str(tmp_path / "ckpt")
    jcfg, cfg = tt._cfgs("qwen2.5-3b")
    jp = tt._jparams(jcfg)
    j3, _ = _jax_steps(jcfg, (jp, jopt.init_opt_state(jp)), 0, 3)
    jckpt.save(d, 3, j3)
    j5, jlosses = _jax_steps(jcfg, j3, 3, 2)

    params = tt.Model(cfg, device="cpu").init(seed=5, trainable=True)
    like = tts.state_to_jax(params, topt.init_opt_state(params), cfg)
    tree, step = tckpt.restore(d, like)
    assert step == 3
    params, opt = tts.state_from_jax(tree, params, cfg)
    assert int(opt.step) == 3 and opt.step.dtype == torch.int32
    assert all(p.requires_grad for p in params.parameters())
    tt._check_tree(jax.tree.map(np.asarray, j3[1].v), opt.v, cfg, 0.0, "v restored")
    train = tts.make_train_step(cfg, tts.TrainConfig(opt=topt.AdamWConfig(**KW)))
    data = tt.tdata.SyntheticLM(tt.tdata.DataConfig(
        global_batch=4, seq_len=32, vocab_size=cfg.vocab_size), cfg, device="cpu")
    tlosses = []
    for i in (3, 4):
        params, opt, m = train(params, opt, data.batch_at(i))
        tlosses.append(float(m["loss"]))
    np.testing.assert_allclose(tlosses, jlosses, rtol=tt.LOSS_TOL)
    assert int(opt.step) == 5
    want = jax.tree.map(np.asarray, j5[0])
    j3_params = jax.tree.map(np.asarray, j3)
    spread = tt._spread(lambda p: _jax_steps(jcfg, (p, j3_params[1]), 3, 2)[0][0],
                        j3_params[0], want, cfg, seeds=(1, 2))
    tt._check_params(want, spread, dict(params.named_parameters()), cfg)


def test_port_checkpoint_restores_in_jax(tmp_path):
    d = str(tmp_path / "ckpt")
    jcfg, cfg = tt._cfgs("qwen2.5-3b")
    jp = tt._jparams(jcfg)
    params = tt._tparams(jp, cfg)
    train = tts.make_train_step(cfg, tts.TrainConfig(opt=topt.AdamWConfig(**KW),
                                                     accum_steps=2))
    data = tt.tdata.SyntheticLM(tt.tdata.DataConfig(
        global_batch=4, seq_len=32, vocab_size=cfg.vocab_size), cfg, device="cpu")
    opt = topt.init_opt_state(params)
    for i in range(2):
        params, opt, _ = train(params, opt, data.batch_at(i))
    ck = tckpt.AsyncCheckpointer(d)
    ck.save(2, tts.state_to_jax(params, opt, cfg))
    ck.wait()
    (jparams, jstate), step = jckpt.restore(d, (jp, jopt.init_opt_state(jp)))
    assert step == 2 and int(jstate.step) == 2 and jstate.step.dtype == jnp.int32
    tt._check_tree(jax.tree.map(np.asarray, jparams), dict(params.named_parameters()),
                   cfg, 0.0, "params")
    tt._check_tree(jax.tree.map(np.asarray, jstate.m), opt.m, cfg, 0.0, "m")
    tt._check_tree(jax.tree.map(np.asarray, jstate.v), opt.v, cfg, 0.0, "v")
    # and JAX trains on from it
    _, losses = _jax_steps(jcfg, (jparams, jstate), 2, 1, accum=2)
    assert np.isfinite(losses[0])
