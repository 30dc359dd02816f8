#!/usr/bin/env python3
"""Time the two serving paths the attention kernels sit on, for one source
tree of the PyTorch port, on one NVIDIA card.

For full-width qwen2.5-3b (bf16, random weights from seed 0, 4 slots,
capacity 2048) it runs, warm, the two profiles of ``chip_smoke.py``:

  * ``profile_prefill``: admission of one ~1500-token prompt alone in a
    dense server (prefill, first sample and its host sync: the TTFT path);
  * ``profile_decode_chunk``: one paged decode chunk (page_size 16,
    decode_chunk 8: the FAME harness's setting) with 4 live slots;

each the wall times of ``chip_smoke.WALL_REPS`` unprofiled runs and the
device busy time of one more under torch.profiler. The profiles come from
this checkout's ``chip_smoke.py``; the port they drive is the one under
``--src``. It prints one JSON line. Run it once per tree and alternate
trees inside one machine session to compare two commits on one card, e.g.
with the parent unpacked under build/parent:

    python3 tools/serving_ab.py --src build/parent/src
    python3 tools/serving_ab.py --src src
    python3 tools/serving_ab.py --src src
    python3 tools/serving_ab.py --src build/parent/src

Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="directory holding repro_torch")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serving_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.serving.server import EngineConfig, LLMServer

    dev = torch.device("cuda", 0)
    model, params, tok = cs.full_model(dev)
    rng = random.Random(0)
    srv = LLMServer(model.cfg, num_slots=4, capacity=2048, params=params, device=dev,
                    engine_cfg=EngineConfig(cache_mode="dense"))
    admit = cs.profile_prefill(srv, cs.make_text(tok, rng, 1500))
    del srv
    torch.cuda.empty_cache()
    srv = LLMServer(model.cfg, num_slots=4, capacity=2048, params=params, device=dev,
                    engine_cfg=EngineConfig(cache_mode="paged", page_size=16,
                                            decode_chunk=8))
    chunk = cs.profile_decode_chunk(
        srv, [cs.make_text(tok, rng, n) for n in (672, 869, 1173, 1470)])

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(json.dumps({
        "src": args.src, "card": smi.stdout.strip(),
        "admit_prompt_tokens": admit["prompt_tokens"], "admit_ms": admit["wall_ms"],
        "admit_median_ms": statistics.median(admit["wall_ms"]),
        "admit_device_ms": admit["device_busy_ms"],
        "paged_chunk_ms": chunk["wall_ms"],
        "paged_chunk_median_ms": statistics.median(chunk["wall_ms"]),
        "paged_chunk_device_ms": chunk["device_busy_ms"],
        "paged_live_slots": chunk["live_slots"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
