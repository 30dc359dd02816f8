"""Time the flash backward kernel at each split of its dK / dV grid, on one
NVIDIA card.

The bf16 backward splits the G query heads of a KV head over ``nsplit``
dK / dV blocks that write float32 partials (``flash_attention.bwd_splits``
picks it). This sweeps ``nsplit`` over the divisors of G at the train
microbatches the port runs (qwen2.5-3b: [2,2048,16,128], 2 KV heads;
recurrentgemma-9b: [2,2048,16,256], one KV head, window 2048) and prints
one JSON line: per shape and split the device ms of one call (a CUDA
graph of the call replayed, ``chip_smoke.graph_ms``), the split the plan
picks, and the card's name and power limit. The results are bit-identical
across splits only up to the partials' float32 sums, so it checks each
against the plan's split at the bf16 tolerance (2e-2 of max(1, |grad|)).

    python3 tools/flash_bwd_splits.py

Exits non-zero without a card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SHAPES = {  # name: (B, S, H, K, hd, window)
    "qwen2.5-3b train microbatch": (2, 2048, 16, 2, 128, None),
    "recurrentgemma-9b train microbatch": (2, 2048, 16, 1, 256, 2048),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_splits: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import flash_attention as kfa
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = {"card": card, "shapes": {}}
    plan = kfa.bwd_splits
    for name, (B, S, H, K, hd, window) in SHAPES.items():
        G = H // K
        g = torch.Generator(device=dev).manual_seed(7)
        q, k, v, do = (torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
                       for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd)))
        o, lse = kfa._forward(q, k, v, q_per_kv=G, window=window, with_lse=True)
        picked = plan(B, S, K, G, torch.bfloat16)
        ref = kfa._launch_bwd(q, k, v, o, do, lse, G, window, 0)
        row = {"picked": picked, "device_ms": {}}
        for n in [d for d in (1, 2, 4, 8, 16) if G % d == 0]:
            kfa.bwd_splits = lambda *a, n=n: n
            try:
                got = kfa._launch_bwd(q, k, v, o, do, lse, G, window, 0)
                for a, w in zip(got, ref):
                    scale = max(1.0, float(w.float().abs().max()))
                    if float((a.float() - w.float()).abs().max()) > 2e-2 * scale:
                        raise AssertionError(f"{name}: split {n} departs from split {picked}")
                row["device_ms"][n] = chip_smoke.graph_ms(
                    lambda: kfa._launch_bwd(q, k, v, o, do, lse, G, window, 0))
            finally:
                kfa.bwd_splits = plan
        out["shapes"][name] = row
        print(f"{name}: {row}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
