"""Time one source tree's RG-LRU gradient and training forward at
recurrentgemma-9b's train microbatch on one NVIDIA card.

The tree's ``rglru_scan_bwd`` (a, the float32 states and a bf16 dy [2, 2048,
4096], as ``RGLRUScan.backward`` passes them) and the body of
``RGLRUScan.forward`` (a, bx float32 in; a bf16 y and the float32 states
the backward reads out: one launch on a tree whose ``_forward`` takes
``with_states``, else the float32 scan and a rounding pass, as the parent
of that change ran it). For each: call ms (CUDA events around 20 calls,
host cost included), device ms (a CUDA graph of the call replayed,
``chip_smoke.graph_ms``), its kernels' device ms by name (profiler self
time), the bytes bound (``kernels/costs.py`` of this checkout: 18 bytes an
element backward, 14 forward), whether two calls give the same bits, and
the device memory a backward call allocates past its inputs. The gradient
is also held against a float64 loop of the recurrence run backwards
(max error relative to max(1, |grad|)). One JSON line, with the card's
name and power limit.

The code timed is the one under ``--src`` (default: this checkout's
``src``); the timing helpers and the bounds come from this checkout. To
compare two commits on one card, unpack the parent under build/parent and
run, in one call:

    python3 tools/rglru_bwd_ab.py --src build/parent/src
    python3 tools/rglru_bwd_ab.py
    python3 tools/rglru_bwd_ab.py
    python3 tools/rglru_bwd_ab.py --src build/parent/src

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
B, S, R = 2, 2048, 4096          # recurrentgemma-9b: 4 x 2048 tokens in 2 microbatches


def plain_grad(a, hh, dy):
    """(da, dbx) of the recurrence in float64: dh_t = dy_t + a_{t+1} dh_{t+1}."""
    import torch
    a64, h64, g64 = a.double(), hh.double(), dy.double()
    dbx = torch.empty_like(g64)
    d = torch.zeros(a.shape[0], a.shape[2], dtype=torch.float64, device=a.device)
    for t in range(a.shape[1] - 1, -1, -1):
        d = g64[:, t] + (a64[:, t + 1] * d if t + 1 < a.shape[1] else d)
        dbx[:, t] = d
    prev = torch.cat([torch.zeros_like(h64[:, :1]), h64[:, :-1]], dim=1)
    return dbx * prev, dbx


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree's src directory (repro_torch is imported from it)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rglru_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import rglru_scan as krs
    costs = _costs()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(14)
    a = torch.sigmoid(torch.randn(B, S, R, generator=g, device=dev))
    bx = torch.randn(B, S, R, generator=g, device=dev) * 0.5
    dy = torch.randn(B, S, R, generator=g, device=dev).to(torch.bfloat16)
    hh, _ = krs._forward(a, bx)
    out = {"card": card, "src": args.src, "shape": [B, S, R]}

    bwd = lambda: krs.rglru_scan_bwd(a, hh, dy)                    # noqa: E731
    first, second = bwd()[:2], bwd()[:2]
    want = plain_grad(a, hh, dy)
    err = max(float((x.double() - w).abs().max()) / max(1.0, float(w.abs().max()))
              for x, w in zip(first, want))
    bits = all(torch.equal(x, y) for x, y in zip(first, second))
    del first, second, want
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = bwd()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del res
    out["backward"] = dict(
        call_ms=chip_smoke.time_ms(bwd, 20), device_ms=chip_smoke.graph_ms(bwd, 50),
        by_kernel=_short(chip_smoke.device_ms_by_kernel(bwd, 20)),
        bound_ms=costs.bound_ms(costs.rglru_bwd(B, S, R))[0], bits_equal=bits,
        max_rel_err=err, allocated_mb=peak / 2 ** 20)

    if "with_states" in inspect.signature(krs._forward).parameters:
        body = lambda: krs._forward(a, bx, out_dtype=torch.bfloat16,  # noqa: E731
                                    with_states=True)
    else:
        def body():
            hs, h_last = krs._forward(a, bx)
            return hs.to(torch.bfloat16), h_last, hs
    one, two = body(), body()
    out["forward"] = dict(
        call_ms=chip_smoke.time_ms(body, 20), device_ms=chip_smoke.graph_ms(body, 50),
        by_kernel=_short(chip_smoke.device_ms_by_kernel(body, 20)),
        bound_ms=costs.bound_ms(costs.rglru(B, S, R, 2, False, True))[0],
        bits_equal=all(torch.equal(x, y) for x, y in zip(one, two)))
    print(json.dumps(out))
    return 0


def _costs():
    """This checkout's ``kernels/costs.py`` (the bounds), whatever tree is timed."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_rglru_ab_costs", ROOT / "src" / "repro_torch" / "kernels" / "costs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _short(by_kernel):
    return {k.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0][:60]:
            round(v, 5) for k, v in by_kernel.items()}


if __name__ == "__main__":
    sys.exit(main())
