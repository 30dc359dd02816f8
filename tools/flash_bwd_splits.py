"""Time the bf16 flash backward kernel of one source tree at the train
microbatches the port runs, at each split of its dK / dV grid, on one
NVIDIA card, with SDPA's backward beside it.

The bf16 backward splits the G query heads of a KV head over ``nsplit``
dK / dV blocks that write float32 partials (``flash_attention.bwd_splits``
picks it, at most ``MAX_SPLITS``). At qwen2.5-3b's microbatch
([2,2048,16,128], 2 KV heads) and recurrentgemma-9b's ([2,2048,16,256], one
KV head, window 2048) this prints one JSON line: per shape the split the
plan picks, the device ms of one call at each split that divides G up to
``MAX_SPLITS`` (a CUDA graph of the call replayed, ``chip_smoke.graph_ms``;
``--plan-only``: the plan's split alone), the plan's call by kernel
(profiler self time: delta, dK / dV, the partials' sum, dQ), SDPA's
backward device ms (a graph of its forward and backward less one of its
forward) and the bound (``costs.flash_bwd``), and the card's name and power
limit. The splits agree only up to the partials' float32 sums, so it checks
each against the plan's split at the bf16 tolerance (2e-2 of max(1,
|grad|)); the plan's split against autograd of the plain version is
``chip_smoke.flash_bwd_row``'s check.

The kernel is the one under ``--src`` (default: this checkout's ``src``);
the timing helpers come from this checkout's ``chip_smoke.py``. To compare
two commits on one card, unpack the parent under build/parent and run, in
one process sequence on one machine:

    python3 tools/flash_bwd_splits.py --src build/parent/src --plan-only
    python3 tools/flash_bwd_splits.py --plan-only
    python3 tools/flash_bwd_splits.py --plan-only
    python3 tools/flash_bwd_splits.py --src build/parent/src --plan-only

Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import inspect
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree's src directory (repro_torch is imported from it)")
    ap.add_argument("--plan-only", action="store_true",
                    help="time the plan's split alone")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_splits: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    import torch.nn.functional as F
    from repro_torch.kernels import costs
    from repro_torch.kernels import flash_attention as kfa
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = {"card": card, "src": args.src, "shapes": {}}
    plan = kfa.bwd_splits
    # a tree whose plan takes no head dim: (B, T, K, G, dtype)
    with_hd = len(inspect.signature(plan).parameters) == 6
    for name, (B, S, H, K, hd, window) in SHAPES.items():
        G = H // K
        g = torch.Generator(device=dev).manual_seed(7)
        q, k, v, do = (torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
                       for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd)))
        o, lse = kfa._forward(q, k, v, q_per_kv=G, window=window, with_lse=True)
        picked = (plan(B, S, K, G, hd, torch.bfloat16) if with_hd
                  else plan(B, S, K, G, torch.bfloat16))
        call = lambda: kfa._launch_bwd(q, k, v, o, do, lse, G, window, 0)  # noqa: E731
        ref = call()
        row = {"picked": picked, "device_ms": {}}
        splits = [picked] if args.plan_only else [
            d for d in (1, 2, 4, 8, 16) if G % d == 0 and d <= kfa.MAX_SPLITS]
        for n in splits:
            kfa.bwd_splits = lambda *a, n=n: n
            try:
                got = call()
                for a, w in zip(got, ref):
                    scale = max(1.0, float(w.float().abs().max()))
                    if float((a.float() - w.float()).abs().max()) > 2e-2 * scale:
                        raise AssertionError(f"{name}: split {n} departs from split {picked}")
                row["device_ms"][n] = chip_smoke.graph_ms(call)
            finally:
                kfa.bwd_splits = plan
        row["by_kernel"] = {
            key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]: ms
            for key, ms in chip_smoke.device_ms_by_kernel(call).items()}
        qs, ks, vs = (t.detach().clone().transpose(1, 2).requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2)
        sdpa = lambda: F.scaled_dot_product_attention(                  # noqa: E731
            qs, ks, vs, is_causal=True, enable_gqa=True)
        row["sdpa_bwd_device_ms"] = (
            chip_smoke.graph_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), dot))
            - chip_smoke.graph_ms(sdpa))
        pairs = costs.flash_pairs(S, window=window)
        row["bound_ms"] = chip_smoke.bound("flash_bwd", B, S, S, H, K, hd, 2, pairs,
                                           "bf16")[0]
        out["shapes"][name] = row
        print(f"{name}: {row}", flush=True)
        del q, k, v, do, o, lse, ref, qs, ks, vs
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
