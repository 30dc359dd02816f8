"""End-to-end training driver of the port: a reduced model for a few
hundred steps with the production loop — microbatch accumulation, async
checkpoints in the reference's format, resume from the latest one.

The counterpart of ``examples/train_lm.py`` (the same flags and the same
reduced-config rule); it lives in the package because ``examples/`` is
the JAX package's. It runs on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.training.train_lm --arch qwen2.5-3b --steps 200
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               latest_step_dir, restore)
from repro_torch.configs.registry import ARCHS
from repro_torch.models import Model
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import (TrainConfig, make_train_step,
                                             state_from_jax, state_to_jax)

CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def reduced_config(arch: str, d_model: int, layers: int):
    """The JAX driver's rule: float32, 8 heads of 32, d_ff 4 x d_model,
    vocab 2048, ``layers`` rounded down to whole pattern periods."""
    base = ARCHS[arch]
    n_layers = (layers if len(base.pattern) == 1
                else len(base.pattern) * max(1, layers // len(base.pattern)))
    return base.reduced(dtype="float32", param_dtype="float32",
                        d_model=d_model, num_heads=8, head_dim=32,
                        d_ff=4 * d_model if base.d_ff else 0,
                        vocab_size=2048, num_layers=n_layers,
                        rglru_dim=d_model if base.rglru_dim else 0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch, args.d_model, args.layers)
    model = Model(cfg, device=args.device)
    params = model.init(seed=0, trainable=True)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M layers={cfg.num_layers} "
          f"device={model.device}")

    data = SyntheticLM(DataConfig(global_batch=args.batch, seq_len=args.seq,
                                  vocab_size=cfg.vocab_size), cfg,
                       device=model.device)
    tcfg = TrainConfig(opt=AdamWConfig(lr=3e-3, warmup_steps=20,
                                       total_steps=args.steps),
                       accum_steps=args.accum)
    step_fn = make_train_step(cfg, tcfg)
    opt = init_opt_state(params)
    ckpt = AsyncCheckpointer(args.ckpt_dir)

    start = 0
    if latest_step_dir(args.ckpt_dir):
        tree, start = restore(args.ckpt_dir, state_to_jax(params, opt, cfg))
        params, opt = state_from_jax(tree, params, cfg)
        print(f"resumed from checkpoint at step {start}")

    t0 = time.time()
    for step in range(start, args.steps):
        batch = data.batch_at(step)
        params, opt, metrics = step_fn(params, opt, batch)
        if step % 20 == 0 or step == args.steps - 1:
            toks = args.batch * args.seq * (step - start + 1)
            print(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"grad_norm={float(metrics['grad_norm']):.3f} "
                  f"tok/s={toks / (time.time() - t0):.0f}")
        if step and step % 50 == 0:
            ckpt.save(step, state_to_jax(params, opt, cfg))
    ckpt.save(args.steps, state_to_jax(params, opt, cfg))
    ckpt.wait()
    print(f"done; checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
