"""Time the serving paths the attention kernels sit on, for one source
tree of the PyTorch port, on one NVIDIA card.

Each profile comes from ``chip_smoke.py`` and runs warm: the wall times of
``chip_smoke.WALL_REPS`` unprofiled runs and the device busy time of one
more under torch.profiler. ``--profiles`` picks them (default
``admit,paged``):

  * ``admit``: ``profile_prefill`` of full-width qwen2.5-3b (bf16, random
    weights from seed 0, 4 slots, capacity 2048): admission of one
    ~1500-token prompt alone in a dense server (prefill, first sample and
    its host sync: the TTFT path);
  * ``paged``: ``profile_decode_chunk`` of the same model: one paged
    decode chunk (page_size 16, decode_chunk 8: the FAME harness's
    setting) with 4 live slots;
  * ``dense``: ``profile_decode_chunk`` on a dense server (decode_chunk 16)
    with 4 live slots, for qwen2.5-3b (prompts of ~200-1500 tokens,
    capacity 2048) and recurrentgemma-9b (~200-3000 tokens, capacity 4096:
    its local-attention ring decode).

The profiles come from this checkout's ``chip_smoke.py``; the port they
drive is the one under ``--src``. It prints one JSON line. Run it once per
tree and alternate trees inside one machine session to compare two commits
on one card, e.g. with the parent unpacked under build/parent:

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


def dense_chunk(cs, arch, capacity, prompt_tokens, dev):
    """``profile_decode_chunk`` on a dense server of ``arch`` (full width,
    bf16, random weights from seed 0, 4 slots)."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import Model
    from repro_torch.serving.server import EngineConfig, LLMServer
    from repro_torch.serving.tokenizer import ByteTokenizer
    cfg = ARCHS[arch]
    model = Model(cfg, device=dev)
    params = model.init(seed=0)
    tok, rng = ByteTokenizer(cfg.vocab_size), random.Random(0)
    srv = LLMServer(cfg, num_slots=4, capacity=capacity, params=params, device=dev,
                    engine_cfg=EngineConfig(cache_mode="dense"))
    chunk = cs.profile_decode_chunk(
        srv, [cs.make_text(tok, rng, n) for n in prompt_tokens])
    del srv, model, params
    torch.cuda.empty_cache()
    return chunk


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="directory holding repro_torch")
    ap.add_argument("--profiles", default="admit,paged",
                    help="comma list of admit,paged,dense (default: admit,paged)")
    args = ap.parse_args()
    profiles = set(args.profiles.split(","))
    if not profiles or profiles - {"admit", "paged", "dense"}:
        ap.error(f"--profiles: {args.profiles}")
    import torch
    if not torch.cuda.is_available():
        print("serving_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.serving.server import EngineConfig, LLMServer

    dev = torch.device("cuda", 0)
    out = {"src": args.src}
    if profiles & {"admit", "paged"}:
        model, params, tok = cs.full_model(dev)
        rng = random.Random(0)
    if "admit" in profiles:
        srv = LLMServer(model.cfg, num_slots=4, capacity=2048, params=params,
                        device=dev, engine_cfg=EngineConfig(cache_mode="dense"))
        admit = cs.profile_prefill(srv, cs.make_text(tok, rng, 1500))
        del srv
        torch.cuda.empty_cache()
        out.update(admit_prompt_tokens=admit["prompt_tokens"], admit_ms=admit["wall_ms"],
                   admit_median_ms=statistics.median(admit["wall_ms"]),
                   admit_device_ms=admit["device_busy_ms"])
    if "paged" in profiles:
        srv = LLMServer(model.cfg, num_slots=4, capacity=2048, params=params,
                        device=dev, engine_cfg=EngineConfig(
                            cache_mode="paged", page_size=16, decode_chunk=8))
        chunk = cs.profile_decode_chunk(
            srv, [cs.make_text(tok, rng, n) for n in (672, 869, 1173, 1470)])
        del srv
        out.update(paged_chunk_ms=chunk["wall_ms"],
                   paged_chunk_median_ms=statistics.median(chunk["wall_ms"]),
                   paged_chunk_device_ms=chunk["device_busy_ms"],
                   paged_live_slots=chunk["live_slots"])
    if profiles & {"admit", "paged"}:
        del model, params
        torch.cuda.empty_cache()
    if "dense" in profiles:
        for key, arch, cap, lens in (
                ("qwen", "qwen2.5-3b", 2048, (200, 600, 1000, 1500)),
                ("rgemma", "recurrentgemma-9b", 4096, (200, 800, 1500, 3000))):
            chunk = dense_chunk(cs, arch, cap, lens, dev)
            out.update({f"dense_{key}_chunk_ms": chunk["wall_ms"],
                        f"dense_{key}_chunk_median_ms": statistics.median(chunk["wall_ms"]),
                        f"dense_{key}_chunk_device_ms": chunk["device_busy_ms"],
                        f"dense_{key}_live_slots": chunk["live_slots"]})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    out["card"] = smi.stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
