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
    its local-attention ring decode);
  * ``stateful``: ``profile_prefill`` on a dense server of each stateful
    arch (full width, bf16, random weights from seed 0, 4 slots): admission
    of one ~3000-token prompt in recurrentgemma-9b (capacity 4096; its
    rglru_scan layers) and of one ~1500-token prompt in xlstm-350m
    (capacity 2048; its mlstm_chunk and sLSTM layers; host operators not
    traced there, for a tree whose sLSTM is a host loop), with the device
    ms of the scan kernels;
  * ``train``: xlstm-350m's train step as ``chip_smoke.STATEFUL_TRAIN``
    runs it (whole, bf16, random weights from seed 0, remat full, 4 x
    1024 tokens in one microbatch, AdamW): the wall of ``TRAIN_STEPS``
    steps after a warm-up one, each ending in a host read of its loss;
  * ``spec``: ``profile_verify_step`` of qwen2.5-3b on a dense server with
    spec_len=4 (4 slots, capacity 2048, ``chip_smoke.copy_prompts``): one
    verify step, drafting and commit included;
  * ``scans``: the two scan kernels alone through the tree's wrappers, call
    ms (CUDA events) and device ms: ``rglru_scan`` at recurrentgemma-9b's
    largest prefill bucket ([1,4096,4096], h0, bf16 out) and its verify
    step ([4,5,4096], float32 out), ``mlstm_chunk`` at xlstm-350m's
    ([1,2048,4,512] bf16, chunk 256, state in).

The profiles come from this checkout's ``chip_smoke.py``; the port they
drive is the one under ``--src``. On a tree whose decode and verify steps
are replayed CUDA graphs, the decode and verify profiles also run its eager
steps (``progs.eager()``) on the same slots, reported under ``*_eager_*``. It prints one JSON line. Run it once per
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


def chunk_fields(key, chunk) -> dict:
    """The JSON fields of one ``profile_decode_chunk`` result."""
    out = {f"{key}_ms": chunk["wall_ms"],
           f"{key}_median_ms": statistics.median(chunk["wall_ms"]),
           f"{key}_device_ms": chunk["device_busy_ms"]}
    if chunk.get("eager"):
        e = chunk["eager"]
        out.update({f"{key}_eager_ms": e["wall_ms"],
                    f"{key}_eager_median_ms": statistics.median(e["wall_ms"]),
                    f"{key}_eager_device_ms": e["device_busy_ms"]})
    return out


def stateful_admit(cs, arch, capacity, prompt_tokens, dev, reps, host_trace):
    """``profile_prefill`` on a dense server of ``arch`` (full width, bf16,
    random weights from seed 0, 4 slots); the device ms of the kernels
    whose names hold "rglru", "mlstm" or "slstm"."""
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
    admit = cs.profile_prefill(srv, cs.make_text(tok, rng, prompt_tokens), reps=reps,
                               host_trace=host_trace)
    del srv, model, params
    torch.cuda.empty_cache()
    scan = {k: ms for k, ms in admit["kernel_ms"].items()
            if any(w in k for w in ("rglru", "mlstm", "slstm"))}
    return admit, scan


TRAIN_STEPS = 3


def xlstm_train(cs, dev):
    """Wall ms of ``TRAIN_STEPS`` xlstm-350m train steps after a warm-up
    step (see the module docstring), and their losses."""
    import time
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import Model
    from repro_torch.training import optimizer as topt
    cfg = ARCHS["xlstm-350m"]
    run = cs.STATEFUL_TRAIN["xlstm-350m"]
    params = Model(cfg, device=dev).init(seed=0, trainable=True)
    data = cs.train_data(cfg, dev, run["batch"], run["seq"])
    _, step = cs.train_step_fn(cfg, run["lr"], run["accum"])
    opt = topt.init_opt_state(params)
    walls, losses = [], []
    for i in range(TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, data.batch_at(i))
        loss = float(m["loss"])
        torch.cuda.synchronize()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
    del params, opt
    torch.cuda.empty_cache()
    return walls, losses


def scans(cs, dev):
    """Call and device ms of the scan kernels through the wrappers of the
    port under ``--src`` (inputs from seed 2, the scales of
    ``chip_smoke.stateful_kernel_rows``)."""
    import torch
    from repro_torch.kernels import mlstm_chunk as kmc
    from repro_torch.kernels import rglru_scan as krs
    g = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    out = {}
    R = 4096
    for key, B, S, out_dtype in (("rglru", 1, 4096, torch.bfloat16),
                                 ("rglru_verify", 4, 5, torch.float32)):
        a, bx, h0 = torch.sigmoid(rnd(B, S, R)), rnd(B, S, R, scale=0.5), rnd(B, R)
        fn = lambda: krs.rglru_scan(a, bx, h0, out_dtype=out_dtype)  # noqa: E731
        out[f"{key}_ms"], out[f"{key}_device_ms"] = cs.time_ms(fn, 50), cs.device_ms(fn)
    bf16 = torch.bfloat16
    q, k = (rnd(1, 2048, 4, 512, dtype=bf16, scale=0.5) for _ in range(2))
    v = rnd(1, 2048, 4, 512, dtype=bf16)
    ig, fg = rnd(1, 2048, 4), rnd(1, 2048, 4) + 2.0
    _, st = kmc.mlstm_chunk_ref(q[:, :300], k[:, :300], v[:, :300], ig[:, :300],
                                fg[:, :300], chunk=256)
    fn = lambda: kmc.mlstm_chunk(q, k, v, ig, fg, st, chunk=256)  # noqa: E731
    out["mlstm_ms"], out["mlstm_device_ms"] = cs.time_ms(fn, 20), cs.device_ms(fn)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="directory holding repro_torch")
    ap.add_argument("--profiles", default="admit,paged",
                    help="comma list of admit,paged,dense,spec,stateful,scans,train "
                         "(default: admit,paged)")
    args = ap.parse_args()
    profiles = set(args.profiles.split(","))
    if not profiles or profiles - {"admit", "paged", "dense", "spec", "stateful",
                                   "scans", "train"}:
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
    if profiles & {"admit", "paged", "spec"}:
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
        out.update(chunk_fields("paged_chunk", chunk),
                   paged_live_slots=chunk["live_slots"])
    if "spec" in profiles:
        srv = LLMServer(model.cfg, num_slots=4, capacity=2048, params=params,
                        device=dev, engine_cfg=EngineConfig(cache_mode="dense",
                                                            spec_len=4))
        verify = cs.profile_verify_step(srv, cs.copy_prompts(tok, random.Random(1)))
        del srv
        out.update(chunk_fields("spec_verify", verify))
    if profiles & {"admit", "paged", "spec"}:
        del model, params
        torch.cuda.empty_cache()
    if "dense" in profiles:
        for key, arch, cap, lens in (
                ("qwen", "qwen2.5-3b", 2048, (200, 600, 1000, 1500)),
                ("rgemma", "recurrentgemma-9b", 4096, (200, 800, 1500, 3000))):
            chunk = dense_chunk(cs, arch, cap, lens, dev)
            out.update(chunk_fields(f"dense_{key}_chunk", chunk))
            out[f"dense_{key}_live_slots"] = chunk["live_slots"]
    if "scans" in profiles:
        out.update(scans(cs, dev))
    if "stateful" in profiles:
        for key, arch, cap, n, reps, host_trace in (
                ("rgemma", "recurrentgemma-9b", 4096, 3000, cs.WALL_REPS, True),
                ("xlstm", "xlstm-350m", 2048, 1500, 3, False)):
            admit, scan = stateful_admit(cs, arch, cap, n, dev, reps, host_trace)
            out.update({f"{key}_admit_prompt_tokens": admit["prompt_tokens"],
                        f"{key}_admit_ms": admit["wall_ms"],
                        f"{key}_admit_median_ms": statistics.median(admit["wall_ms"]),
                        f"{key}_admit_device_ms": admit["device_busy_ms"],
                        f"{key}_admit_scan_kernel_ms": scan})
    if "train" in profiles:
        walls, losses = xlstm_train(cs, dev)
        out.update(xlstm_train_ms=walls, xlstm_train_median_ms=statistics.median(walls),
                   xlstm_train_losses=losses)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    out["card"] = smi.stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
