"""Time one source tree's mLSTM backward kernel at xlstm-350m's train
microbatch on one NVIDIA card.

The tree's ``torch.ops.repro_torch.mlstm_chunk_bwd`` on q, k, v, dh [4,
1024, 4, 512] bf16, chunk 256, the float32 gates and the chunk start states
the tree's forward keeps (``_forward(..., with_states=True)``), as
``MLSTMChunk.backward`` passes them: call ms (CUDA events around 20 calls,
host cost included), device ms (a CUDA graph of the call replayed,
the median of five ``chip_smoke.graph_ms``), its launches' device ms by
name (profiler self
time), the operations bound (``kernels/costs.py`` of this checkout),
whether two calls give the same bits, the device memory a call allocates
past its inputs (``allocated_mb``; its five gradients are
``outputs_mb`` of it, the rest scratch), and the largest error of each
gradient against the tree's plain ``mlstm_chunk_bwd`` run in float64 on the
same inputs, relative to max(1, |grad|). One JSON line, with the card's
name and power limit.

The code timed is the one under ``--src`` (default: this checkout's
``src``); the timing helpers and the bound come from this checkout. To
compare two commits on one card, unpack the parent under build/parent and
run, in one call:

    python3 tools/mlstm_bwd_ab.py --src build/parent/src
    python3 tools/mlstm_bwd_ab.py
    python3 tools/mlstm_bwd_ab.py
    python3 tools/mlstm_bwd_ab.py --src build/parent/src

Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, S, H, HD, CHUNK = 4, 1024, 4, 512, 256      # xlstm-350m: 4 x 1024 tokens, one microbatch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree's src directory (repro_torch is imported from it)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mlstm_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import mlstm_chunk as kmc
    costs = _costs()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(15)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device=dev) * scale + shift

    bf16 = torch.bfloat16
    q, k = (rnd(B, S, H, HD, scale=0.5).to(bf16) for _ in range(2))
    v, dh = rnd(B, S, H, HD).to(bf16), rnd(B, S, H, HD).to(bf16)
    ig, fg = rnd(B, S, H), rnd(B, S, H, shift=2.0)
    _, (C, n, _), kept = kmc._forward(q, k, v, ig, fg, chunk=CHUNK, with_states=True)

    def bwd():
        return torch.ops.repro_torch.mlstm_chunk_bwd(q, k, v, ig, fg, dh, None, None, C, n,
                                                     *kept, False, CHUNK)

    first, second = bwd(), bwd()
    bits = all(torch.equal(x, y) for x, y in zip(first, second))
    want = kmc.mlstm_chunk_bwd(*(t.double() for t in (q, k, v, ig, fg, dh)), chunk=CHUNK)
    err = {name: float((x.double() - w).abs().max()) / max(1.0, float(w.abs().max()))
           for name, x, w in zip(("dq", "dk", "dv", "dig", "dfg"), first, want)}
    out_bytes = sum(x.numel() * x.element_size() for x in first)
    del first, second, want
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = bwd()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del res
    by_kernel = chip_smoke.device_ms_by_kernel(bwd, 20)
    out = dict(card=card, src=args.src, shape=[B, S, H, HD], chunk=CHUNK,
               call_ms=chip_smoke.time_ms(bwd, 20), device_ms=device_ms(chip_smoke, bwd),
               by_kernel=_short(by_kernel), by_kernel_sum=sum(by_kernel.values()),
               bound_ms=costs.bound_ms(costs.mlstm_bwd_kernel(B, S, H, HD, CHUNK, 2))[0],
               bits_equal=bits, max_rel_err=err, allocated_mb=peak / 2 ** 20,
               outputs_mb=out_bytes / 2 ** 20)
    print(json.dumps(out))
    return 0


def device_ms(chip_smoke, fn, runs=5):
    """The median of ``runs`` CUDA-graph replay timings (20 replays each): a
    replay the host is late to enqueue counts its idle gap, so one timing
    alone can read high."""
    times = sorted(chip_smoke.graph_ms(fn, 20) for _ in range(runs))
    return times[runs // 2]


def _costs():
    """This checkout's ``kernels/costs.py`` (the bound), whatever tree is timed."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_mlstm_ab_costs", ROOT / "src" / "repro_torch" / "kernels" / "costs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _short(by_kernel):
    return {k.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0][:60]:
            round(v, 5) for k, v in by_kernel.items()}


if __name__ == "__main__":
    sys.exit(main())
