"""How far reduced xlstm-350m's bf16 gradients sit from float32, in the JAX
package and in the port, from the same weights and batch (CPU).

The reduced config is the one ``chip_smoke.py``'s ``stateful_grad_checks``
trains on the card (8 layers: 7 mLSTM and 1 sLSTM, d_model 128, mLSTM chunk
64, vocab 512), a SyntheticLM batch of 2 x 256 tokens (``--batch``, default
1). The JAX init (``--seed``, default 3) is carried into the port by
``convert.params_from_jax``; bf16 runs take the same float32 weights rounded
to bf16. For each package and each parameter
leaf the script prints the bf16 gradient's distance from the same package's
float32 gradient, relative to the float32 gradient's largest value (the
"spread"), and the ratio of the port's spread to the reference's; then the
port against the reference in each dtype, with the medians and largest
values over the leaves. The port runs its plain path (the kernels' plain
versions; ``MLSTMChunk``'s CPU backward).

    PYTHONPATH=src python tools/bf16_grad_spread.py [--layers 8] [--seed 3] \
        [--batch 1] [--json out.json]
"""
from __future__ import annotations

import argparse
import json
import statistics

import numpy as np


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs.registry import ARCHS as JARCHS
    from repro.models import Model as JModel
    from repro.models import transformer as jtfm
    from repro.training import data as jdata
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import Model, convert
    from repro_torch.training import data as tdata
    from repro_torch.training import train_step as tts

    torch.set_num_threads(4)
    over = dict(vocab_size=512, d_model=128, mlstm_chunk=64, num_layers=args.layers)
    name = "xlstm-350m"
    jp32 = JModel(JARCHS[name].reduced(dtype="float32", param_dtype="float32", **over)) \
        .init(jax.random.PRNGKey(args.seed))
    dcfg = dict(global_batch=2, seq_len=args.seq, vocab_size=over["vocab_size"])
    grads = {}
    for dt in ("float32", "bfloat16"):
        jcfg = JARCHS[name].reduced(dtype=dt, param_dtype=dt, **over)
        cfg = ARCHS[name].reduced(dtype=dt, param_dtype=dt, **over)
        jp = jax.tree.map(lambda x: x.astype(jnp.dtype(dt)), jp32)
        jb = jdata.SyntheticLM(jdata.DataConfig(**dcfg), jcfg).batch_at(args.batch)
        tb = tdata.SyntheticLM(tdata.DataConfig(**dcfg), cfg, device="cpu").batch_at(args.batch)
        fn = jax.jit(jax.value_and_grad(lambda p: jtfm.train_loss(p, jb, jcfg),
                                        has_aux=True))
        (jloss, _), jg = fn(jp)
        params = Model(cfg, device="cpu").load(
            convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg), trainable=True)
        tloss, _, tg = tts.loss_and_grads(params, tb, cfg)
        tg = convert.params_to_jax({k: v.detach().float() for k, v in tg.items()}, cfg)
        leaves = {}
        for path, _ in convert.jax_layout(cfg):
            a, b = jg, tg
            for key in path:
                a, b = a[key], b[key]
            a = np.asarray(jnp.asarray(a, jnp.float32))
            if a.size:
                leaves["/".join(path)] = (a, np.asarray(b.numpy(), np.float32))
        grads[dt] = leaves
        print(f"{dt}: loss JAX {float(jloss):.6f} port {float(tloss):.6f}", flush=True)

    rows = []
    for path in grads["float32"]:
        j32, t32 = grads["float32"][path]
        j16, t16 = grads["bfloat16"][path]
        rows.append(dict(leaf=path, ref_spread=_rel(j16, j32), port_spread=_rel(t16, t32),
                         f32_port_vs_ref=_rel(t32, j32), bf16_port_vs_ref=_rel(t16, j16)))
    for r in rows:
        r["ratio"] = r["port_spread"] / max(r["ref_spread"], 1e-30)
        print(f"{r['leaf']:40s} spread ref {r['ref_spread']:.3e} port {r['port_spread']:.3e} "
              f"ratio {r['ratio']:.3f}; port vs ref: float32 {r['f32_port_vs_ref']:.3e} "
              f"bf16 {r['bf16_port_vs_ref']:.3e}")
    ratios = [r["ratio"] for r in rows]
    summary = dict(
        seed=args.seed, batch=args.batch, leaves=len(rows),
        ref_spread_max=max(r["ref_spread"] for r in rows),
        port_spread_max=max(r["port_spread"] for r in rows),
        ref_spread_median=statistics.median(r["ref_spread"] for r in rows),
        port_spread_median=statistics.median(r["port_spread"] for r in rows),
        ratio_median=statistics.median(ratios), ratio_min=min(ratios), ratio_max=max(ratios),
        leaves_port_over_2x_ref=sum(x > 2 for x in ratios),
        f32_port_vs_ref_max=max(r["f32_port_vs_ref"] for r in rows),
        bf16_port_vs_ref_median=statistics.median(r["bf16_port_vs_ref"] for r in rows),
        bf16_port_vs_ref_max=max(r["bf16_port_vs_ref"] for r in rows))
    print(json.dumps(summary))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(summary=summary, leaves=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
