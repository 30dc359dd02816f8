#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``src/repro_torch``).

Drives the port's main path on one NVIDIA card and fails (non-zero exit,
no result line) on any fault:

  0. device: the card's name and power limit (nvidia-smi); no CUDA -> fail;
  1. build: compile the port's CUDA kernels from ``src/repro_torch/kernels/
     csrc`` (nvcc, sm_90a) and print registers / spills (-Xptxas -v);
  2. kernels: each kernel against its plain PyTorch version at the serving
     path's shapes in bf16 (tolerance 2e-2) and at one fp32 shape (2e-5),
     the dense window-ring case included; kernel, plain-version and
     library (``scaled_dot_product_attention``, a yardstick the port never
     calls) times, and the least time the card could take for the work;
  3. dense serving: ``LLMServer`` with full-width qwen2.5-3b (bf16, random
     weights from a seed, 4 slots, capacity 2048, cache_mode="dense"):
     4 concurrent requests of ~200-1500 prompt tokens, one sampled, and a
     2-turn session; every request COMPLETED, flash and decode kernels
     launched; then torch.profiler over one decode chunk (device time by
     kernel, the device's idle share);
  4. paged serving: the same server with cache_mode="paged", page_size=16,
     decode_chunk=8 (the FAME harness's setting) on prompts sharing a
     system prompt; prefix hits > 0, paged-decode kernel launched;
  5. dense against paged: teacher-forced logits of both cache layouts on the
     same weights and tokens, and their greedy-token agreement;
  6. speculative decode: the same model served with spec_len=4, dense and
     paged (page_size=16, decode_chunk=8), on copy-heavy agent prompts;
     every request COMPLETED, verify steps and drafts > 0, the path's four
     kernels launched (flash, one-token decode, multi-query decode,
     accept_len); verify logits against step-by-step decode logits of one
     request (5e-2), greedy agreement with non-speculative serving (bf16,
     printed), and greedy spec == non-spec token for token at full width
     and 4 layers in float32 (asserted);
  7. FAME: one log-analytics M+C session through the port's
     WorkflowServingRuntime on the paged spec_len=4 server; statuses equal
     the ScriptedOracle backend's, prefix hits > 0, session tail reused.

Kernel launch counts are zeroed just before each serving phase and read
just after it. The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.

Run from the repository root:  python3 chip_smoke.py
(``--phases`` picks a subset of kernels,serve,spec,fame.)
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16 = 989e12          # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_F32 = 67e12            # float32 outside the tensor cores
HBM = 3.35e12               # bytes/s
TOL = {"bfloat16": 2e-2, "float32": 2e-5}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(least time in ms, "bytes" or "operations"); int32 and float32 work
    runs outside the tensor cores, at the float32 rate."""
    import torch
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    t_b, t_f = nbytes / HBM * 1e3, flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def check_close(name, got, want, dtype_name):
    err = float((got.float() - want.float()).abs().max())
    tol = TOL[dtype_name]
    log(f"  {name}: max_abs_err={err:.3e} (tol {tol})")
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import paged_decode_attention as kpda

    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    rows = {}
    H, K, hd = 16, 2, 128            # qwen2.5-3b attention
    G = H // K

    # ---- flash_attention: prefill at the largest bucket (2048) ----------
    log("[kernels] flash_attention")
    S = 2048
    q, k, v = rnd(1, S, H, hd), rnd(1, S, K, hd), rnd(1, S, K, hd)
    fa = lambda: kfa.flash_attention(q, k, v, q_per_kv=G)          # noqa: E731
    fr = lambda: kfa.flash_attention_ref(q, k, v, q_per_kv=G)      # noqa: E731
    err = check_close("bf16 prefill [1,2048,16,128]", fa(), fr(), "bfloat16")
    # extend after a prefix (q_start), paged-extend shape
    qe, ke, ve = rnd(1, 512, H, hd), rnd(1, 1536, K, hd), rnd(1, 1536, K, hd)
    err = max(err, check_close(
        "bf16 extend q_start=1024 [1,512,16,128] vs T=1536",
        kfa.flash_attention(qe, ke, ve, q_per_kv=G, q_start=1024),
        kfa.flash_attention_ref(qe, ke, ve, q_per_kv=G, q_start=1024), "bfloat16"))
    f32 = dict(dtype=torch.float32)
    q3, k3, v3 = rnd(2, 200, 4, 64, **f32), rnd(2, 300, 2, 64, **f32), rnd(2, 300, 2, 64, **f32)
    for kw in (dict(), dict(q_start=100), dict(q_start=100, window=48)):
        err = max(err, check_close(
            f"f32 [2,200,4,64] vs T=300 {kw}",
            kfa.flash_attention(q3, k3, v3, q_per_kv=2, **kw),
            kfa.flash_attention_ref(q3, k3, v3, q_per_kv=2, **kw), "float32"))
    ms, plain = time_ms(fa, 20), time_ms(fr, 5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    pairs = S * (S + 1) // 2
    b_ms, b_by = bound(2 * (2 * S * H * hd + 2 * S * K * hd), 4 * hd * H * pairs,
                       torch.bfloat16)
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:63",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib)

    # ---- decode_attention: 4 slots x capacity 2048 ----------------------
    log("[kernels] decode_attention")
    B, W = 4, 2048
    qd, kc, vc = rnd(B, 1, H, hd), rnd(B, W, K, hd), rnd(B, W, K, hd)
    clen = torch.tensor([1500, 200, 2047, 700], dtype=torch.int32, device=dev)
    da = lambda: kda.decode_attention(qd, kc, vc, clen, q_per_kv=G)       # noqa: E731
    dr = lambda: kda.decode_attention_ref(qd, kc, vc, clen, q_per_kv=G)   # noqa: E731
    err = check_close("bf16 [4,1,16,128] vs [4,2048,2,128]", da(), dr(), "bfloat16")
    q4, k4, v4 = rnd(3, 1, 8, 32, **f32), rnd(3, 200, 2, 32, **f32), rnd(3, 200, 2, 32, **f32)
    c4 = torch.tensor([0, 99, 199], dtype=torch.int32, device=dev)
    err = max(err, check_close(
        "f32 [3,1,8,32] vs [3,200,2,32]",
        kda.decode_attention(q4, k4, v4, c4, q_per_kv=4),
        kda.decode_attention_ref(q4, k4, v4, c4, q_per_kv=4), "float32"))
    err = max(err, check_close(
        "f32 scalar cache_len 150",
        kda.decode_attention(q4, k4, v4, 150, q_per_kv=4),
        kda.decode_attention_ref(q4, k4, v4, 150, q_per_kv=4), "float32"))
    q5, k5, v5 = rnd(2, 1, 4, 32, **f32), rnd(2, 64, 2, 32, **f32), rnd(2, 64, 2, 32, **f32)
    c5 = torch.tensor([70, 200], dtype=torch.int32, device=dev)   # wrapped ring
    err = max(err, check_close(
        "f32 window ring W=64 window=24 clen=[70,200]",
        kda.decode_attention(q5, k5, v5, c5, q_per_kv=2, window=24),
        kda.decode_attention_ref(q5, k5, v5, c5, q_per_kv=2, window=24), "float32"))
    ms, plain = time_ms(da, 50), time_ms(dr, 10)
    pos = torch.arange(W, device=dev)
    mask = (pos[None, :] <= clen[:, None].long())[:, None, None, :]
    qdt, kct, vct = qd.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qdt, kct, vct, attn_mask=mask, enable_gqa=True), 50)
    live = int((torch.clamp(clen.long() + 1, max=W)).sum())
    b_ms, b_by = bound(2 * (2 * B * H * hd + 2 * live * K * hd) + 4 * B,
                       4 * hd * H * live, torch.bfloat16)
    rows["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:71",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib)

    # ---- paged_decode_attention: the auto-sized pool of the paged server --
    log("[kernels] paged_decode_attention")
    P, ps, nw = 1025, 16, 128
    kp, vp = rnd(P, ps, K, hd), rnd(P, ps, K, hd)
    perm = torch.randperm(P - 1, generator=g, device=dev)[: B * nw] + 1
    bt = perm.reshape(B, nw).to(torch.int32)
    cl = torch.tensor([1500, 17, 2047, 700], dtype=torch.int32, device=dev)
    for b, c in enumerate(cl.tolist()):          # trash page past the live ones
        bt[b, -(-(c + 1) // ps):] = 0
    pa = lambda: kpda.paged_decode_attention(qd, kp, vp, bt, cl, q_per_kv=G)      # noqa: E731
    pr = lambda: kpda.paged_decode_attention_ref(qd, kp, vp, bt, cl, q_per_kv=G)  # noqa: E731
    err = check_close("bf16 pool [1025,16,2,128] bt [4,128]", pa(), pr(), "bfloat16")
    kp6, vp6 = rnd(11, 8, 2, 16, **f32), rnd(11, 8, 2, 16, **f32)
    q6 = rnd(3, 1, 4, 16, **f32)
    bt6 = torch.tensor([[3, 1, 7, 10], [2, 5, 0, 0], [9, 8, 6, 4]],
                       dtype=torch.int32, device=dev)
    c6 = torch.tensor([25, 10, 31], dtype=torch.int32, device=dev)
    err = max(err, check_close(
        "f32 pool [11,8,2,16] bt [3,4]",
        kpda.paged_decode_attention(q6, kp6, vp6, bt6, c6, q_per_kv=2),
        kpda.paged_decode_attention_ref(q6, kp6, vp6, bt6, c6, q_per_kv=2),
        "float32"))
    ms, plain = time_ms(pa, 50), time_ms(pr, 10)
    kview = kp[bt.long()].reshape(B, nw * ps, K, hd).transpose(1, 2)
    vview = vp[bt.long()].reshape(B, nw * ps, K, hd).transpose(1, 2)
    pmask = (torch.arange(nw * ps, device=dev)[None, :]
             <= cl[:, None].long())[:, None, None, :]
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qdt, kview, vview, attn_mask=pmask, enable_gqa=True), 50)
    live = int((cl.long() + 1).sum())
    pages = sum(-(-(c + 1) // ps) for c in cl.tolist())
    b_ms, b_by = bound(2 * (2 * B * H * hd + 2 * live * K * hd) + 4 * (B + pages),
                       4 * hd * H * live, torch.bfloat16)
    rows["paged_decode_attention"] = dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/paged_decode_attention.py:70",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib)
    rows.update(spec_kernel_rows(dev, rnd))
    for r in rows.values():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"[kernels] {r['name']}: kernel_ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} library_ms={lib} bound_ms="
            f"{r['bound_ms']:.4f} ({r['bound_by']})")
    return rows


def spec_kernel_rows(dev, rnd):
    """accept_len and the multi-query (verify) decode kernels against their
    plain versions, at the spec phase's shapes (4 slots, spec_len=4: S=5)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_spec_decode_attention as kpsda
    from repro_torch.kernels import spec_decode_attention as ksda
    from repro_torch.kernels import spec_scan

    rows = {}
    H, K, hd = 16, 2, 128
    G = H // K
    f32 = dict(dtype=torch.float32)

    # ---- accept_len: the verify step's [slots, spec_len + 1] flags --------
    log("[kernels] accept_len")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    cases = []
    for B, S in ((4, 5), (64, 33)):
        acc = torch.rand(B, S, generator=g, device=dev) < 0.85
        lens = torch.randint(0, S, (B,), generator=g, device=dev, dtype=torch.int32)
        lens[0], acc[0] = S - 1, True                  # all accepted
        lens[1], acc[1] = S - 1, False                 # all rejected
        lens[2] = 0
        got, want = spec_scan.accept_len(acc, lens), spec_scan.accept_len_ref(acc, lens)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        log(f"  accept_len B={B} S={S}: mismatches={int((got != want).sum())}")
        if err != 0:
            raise AssertionError(f"accept_len B={B} S={S}: {got.tolist()} != {want.tolist()}")
        cases.append((acc, lens))
    acc, lens = cases[0]
    ms = time_ms(lambda: spec_scan.accept_len(acc, lens), 200)
    plain = time_ms(lambda: spec_scan.accept_len_ref(acc, lens), 50)
    B, S = acc.shape
    b_ms, b_by = bound(B * S + 4 * B + 4 * B, 2 * B * S, torch.int32)
    rows["accept_len"] = dict(
        name="accept_len", route="cuda",
        source="src/repro_torch/kernels/csrc/spec_scan.cu",
        replaces="src/repro/kernels/spec_scan.py:33",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None)

    # ---- spec_decode_attention: 4 slots x capacity 2048, S = 5 -----------
    log("[kernels] spec_decode_attention")
    B, W, S = 4, 2048, 5
    qs, kc, vc = rnd(B, S, H, hd), rnd(B, W, K, hd), rnd(B, W, K, hd)
    clen = torch.tensor([1500, 200, 2043, 700], dtype=torch.int32, device=dev)
    sa = lambda: ksda.spec_decode_attention(qs, kc, vc, clen, q_per_kv=G)      # noqa: E731
    sr = lambda: ksda.spec_attention_ref(qs, kc, vc, clen, q_per_kv=G)         # noqa: E731
    err = check_close("bf16 [4,5,16,128] vs [4,2048,2,128]", sa(), sr(), "bfloat16")
    q7, k7, v7 = rnd(3, 5, 8, 32, **f32), rnd(3, 200, 2, 32, **f32), rnd(3, 200, 2, 32, **f32)
    c7 = torch.tensor([0, 99, 195], dtype=torch.int32, device=dev)
    err = max(err, check_close(
        "f32 [3,5,8,32] vs [3,200,2,32]",
        ksda.spec_decode_attention(q7, k7, v7, c7, q_per_kv=4),
        ksda.spec_attention_ref(q7, k7, v7, c7, q_per_kv=4), "float32"))
    one = multi_query_equals_steps(qs, kc, vc, clen)
    ms, plain = time_ms(sa, 50), time_ms(sr, 10)
    pos_q = clen[:, None].long() + torch.arange(S, device=dev)[None, :]
    mask = (torch.arange(W, device=dev)[None, None, :] <= pos_q[:, :, None])[:, None]
    qst, kct, vct = qs.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qst, kct, vct, attn_mask=mask, enable_gqa=True), 50)
    live = int(torch.clamp(clen.long() + S, max=W).sum())
    pairs = int(torch.clamp(pos_q + 1, max=W).sum())
    b_ms, b_by = bound(2 * (2 * B * S * H * hd + 2 * live * K * hd) + 4 * B,
                       4 * hd * H * pairs, torch.bfloat16)
    rows["spec_decode_attention"] = dict(
        name="spec_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/models/attention.py:344 (XLA spec_attention; no Pallas kernel)",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib)
    log(f"  S=5 multi-query == 5 one-token decode calls, bit for bit: {one}")

    # ---- paged_spec_decode_attention: the paged server's pool, S = 5 -----
    log("[kernels] paged_spec_decode_attention")
    P, ps, nw = 1025, 16, 128
    kp, vp = rnd(P, ps, K, hd), rnd(P, ps, K, hd)
    perm = torch.randperm(P - 1, generator=g, device=dev)[: B * nw] + 1
    bt = perm.reshape(B, nw).to(torch.int32)
    cl = torch.tensor([1500, 17, 2043, 700], dtype=torch.int32, device=dev)
    for b, c in enumerate(cl.tolist()):          # trash page past the live ones
        bt[b, -(-(c + S) // ps):] = 0
    pa = lambda: kpsda.paged_spec_decode_attention(qs, kp, vp, bt, cl, q_per_kv=G)    # noqa: E731
    pr = lambda: kpsda.paged_spec_attention_ref(qs, kp, vp, bt, cl, q_per_kv=G)       # noqa: E731
    err = check_close("bf16 pool [1025,16,2,128] bt [4,128] S=5", pa(), pr(), "bfloat16")
    kp8, vp8 = rnd(11, 8, 2, 16, **f32), rnd(11, 8, 2, 16, **f32)
    q8 = rnd(3, 5, 4, 16, **f32)
    bt8 = torch.tensor([[3, 1, 7, 10], [2, 5, 0, 0], [9, 8, 6, 4]],
                       dtype=torch.int32, device=dev)
    c8 = torch.tensor([25, 10, 26], dtype=torch.int32, device=dev)
    err = max(err, check_close(
        "f32 pool [11,8,2,16] bt [3,4] S=5",
        kpsda.paged_spec_decode_attention(q8, kp8, vp8, bt8, c8, q_per_kv=2),
        kpsda.paged_spec_attention_ref(q8, kp8, vp8, bt8, c8, q_per_kv=2), "float32"))
    ms, plain = time_ms(pa, 50), time_ms(pr, 10)
    kview = kp[bt.long()].reshape(B, nw * ps, K, hd).transpose(1, 2)
    vview = vp[bt.long()].reshape(B, nw * ps, K, hd).transpose(1, 2)
    pos_q = cl[:, None].long() + torch.arange(S, device=dev)[None, :]
    pmask = (torch.arange(nw * ps, device=dev)[None, None, :]
             <= pos_q[:, :, None])[:, None]
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qst, kview, vview, attn_mask=pmask, enable_gqa=True), 50)
    live = int((cl.long() + S).sum())
    pairs = int((pos_q + 1).sum())
    pages = sum(-(-(c + S) // ps) for c in cl.tolist())
    b_ms, b_by = bound(2 * (2 * B * S * H * hd + 2 * live * K * hd) + 4 * (B + pages),
                       4 * hd * H * pairs, torch.bfloat16)
    rows["paged_spec_decode_attention"] = dict(
        name="paged_spec_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/models/transformer.py:194 (XLA spec_attention over "
                 "paged_view; no Pallas kernel)",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib)
    return rows


def multi_query_equals_steps(qs, kc, vc, clen):
    """The multi-query kernel runs one block per query position, each the
    one-token kernel at cache length clen + s: its output equals S
    one-token decode calls bit for bit."""
    import torch
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import spec_decode_attention as ksda
    G = qs.shape[2] // kc.shape[2]
    got = ksda.spec_decode_attention(qs, kc, vc, clen, q_per_kv=G)
    steps = torch.cat([kda.decode_attention(qs[:, s:s + 1].contiguous(), kc, vc,
                                            clen + s, q_per_kv=G)
                       for s in range(qs.shape[1])], dim=1)
    if not torch.equal(got, steps):
        raise AssertionError("multi-query decode differs from one-token steps")
    return True


# ---------------------------------------------------------------------------
# phases 3-5: serving
# ---------------------------------------------------------------------------

WORDS = ("agent tool result planner actor evaluator workflow function cache "
         "search paper summary log error request response memory session "
         "invoke state retry deadline token stream prefix page batch").split()


def make_text(tok, rng: random.Random, n_tokens: int) -> str:
    words = []
    while True:
        words.append(rng.choice(WORDS))
        text = " ".join(words) + ". "
        if len(tok.encode(text)) >= n_tokens:
            return text


def kernel_modules():
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     paged_decode_attention,
                                     paged_spec_decode_attention,
                                     spec_decode_attention, spec_scan)
    return {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "paged_decode_attention": paged_decode_attention,
            "accept_len": spec_scan, "spec_decode_attention": spec_decode_attention,
            "paged_spec_decode_attention": paged_spec_decode_attention}


def kernel_counts():
    return {name: m.launches for name, m in kernel_modules().items()}


def reset_counts():
    for m in kernel_modules().values():
        m.launches = 0


def serve_phase(name, server, prompts, sampled_idx, session_turns, warm=None):
    """Submit ``prompts`` concurrently (+ a 2-turn session), drain, check."""
    import torch
    from repro_torch.serving.server import SamplingParams
    if warm is not None:
        server.submit(warm, SamplingParams(max_new_tokens=4)).result()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = server.stats()
    reset_counts()
    t0 = time.perf_counter()
    handles = []
    for i, p in enumerate(prompts):
        sp = (SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=7)
              if i == sampled_idx else SamplingParams(max_new_tokens=32))
        handles.append(server.submit(p, sp))
    server.run_until_idle()
    sess = server.open_session()
    text = session_turns[0]
    for turn in session_turns[1:] + [None]:
        h = sess.submit(text, SamplingParams(max_new_tokens=32))
        h.result()
        handles.append(h)
        if turn is not None:
            text = sess.text + turn
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    st = server.stats()
    for h in handles:
        r = h.request
        if r.status != "completed" or not r.output_ids:
            raise AssertionError(f"{name}: rid={r.rid} status={r.status} "
                                 f"outputs={r.output_ids}")
    ttft = [h.request.first_token_s for h in handles]
    dec_tok = sum(h.request.output_tokens for h in handles)
    # each decode chunk's wall time is split over the requests in it, so the
    # requests' decode_s sum to the phase's decode wall time
    dec_s = sum(h.request.decode_s for h in handles)
    dec_tps = (st["decode_tokens"] - before["decode_tokens"]) / max(dec_s, 1e-9)
    log(f"[{name}] requests={len(handles)} prompt_tokens="
        f"{[h.request.prompt_tokens for h in handles]} output_tokens="
        f"{[h.request.output_tokens for h in handles]}")
    log(f"[{name}] wall_s={wall:.3f} ttft_s={[round(t, 4) for t in ttft]} "
        f"decode_tok_per_s={dec_tps:.1f} "
        f"output_tok_per_s_wall={dec_tok / wall:.1f} "
        f"max_memory_allocated_GB={torch.cuda.max_memory_allocated() / 1e9:.3f}")
    log(f"[{name}] launches={counts} prefix_hit_tokens="
        f"{st.get('prefix_hit_tokens', 0) - before.get('prefix_hit_tokens', 0)} "
        f"decode_chunks={st['decode_chunks'] - before['decode_chunks']} "
        f"host_syncs_per_token={st['host_syncs_per_token']:.4f}")
    return handles, counts, st


def profile_decode_chunk(server, prompts):
    """Where one dense decode chunk's time goes (4 live slots): device time
    by kernel from torch.profiler, and the device's idle share of the
    step's wall time. Runs after the launch counts were read."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.server import SamplingParams
    handles = [server.submit(p, SamplingParams(max_new_tokens=60)) for p in prompts]
    server.step()                                  # admission + first chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.step()                                  # one decode chunk, unprofiled
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server.step()                              # the next chunk, profiled
        torch.cuda.synchronize()
    live = sum(1 for s in server.engine.slots if s.request is not None)
    server.run_until_idle()
    if not all(h.request.status == "completed" for h in handles):
        raise AssertionError("profiled requests did not complete")
    # kernels only (operator rows would count the same device time twice)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        log("[profile] torch.profiler recorded no device time: not measured")
        return
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"[profile] one dense decode chunk ({server.engine.engine_cfg.decode_chunk} "
        f"steps, {live} slots): unprofiled wall_ms={wall_ms:.2f}, kernel time of "
        f"the next chunk device_busy_ms={busy:.2f}, device_idle_share="
        f"{1 - busy / wall_ms:.3f}")
    for name, ms, n in rows[:10]:
        log(f"[profile]   {ms:9.3f} ms  {n:6d} calls  {name[:90]}")


def teacher_forced(model, params, ids, n_prompt, *, paged: bool, dev):
    """Logits of every continuation step: prefill ids[:n_prompt], then feed
    ids[n_prompt:] one token at a time (dense cache, or a page pool)."""
    import torch
    from repro_torch.serving import kvpool
    cap, ps = 2048, 16
    out = []
    tok = torch.tensor([ids[:n_prompt]], device=dev)
    batch = model.make_batch(tok)
    if paged:
        n_pages = cap // ps
        cache = kvpool.init_paged_cache(model.cfg, 1 + n_pages, ps, dev)
        bt = torch.arange(1, 1 + n_pages, dtype=torch.int32, device=dev)[None]
        logits, _ = model.extend(params, batch, cache, 0, length=n_prompt,
                                 block_tables=bt, with_logits="last")
    else:
        bt = None
        cache = model.init_cache(1, cap)
        logits, _ = model.prefill(params, batch, cache, length=n_prompt,
                                  with_logits="last")
    out.append(logits[:, 0])
    for t, x in enumerate(ids[n_prompt:-1]):
        pos = n_prompt + t
        b = {"tokens": torch.tensor([[x]], device=dev),
             "positions": torch.tensor([[pos]], device=dev)}
        clen = torch.tensor([pos], dtype=torch.int32, device=dev)
        logits, _ = model.decode_step(params, b, cache, clen, block_tables=bt)
        out.append(logits[:, 0])
    return torch.cat(out)


def full_model(dev):
    """Full-width qwen2.5-3b (bf16), random weights from seed 0."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import Model
    from repro_torch.serving.tokenizer import ByteTokenizer

    cfg = ARCHS["qwen2.5-3b"]                       # full width, bf16
    log(f"[model] {cfg.name}: layers={cfg.num_layers} d_model={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} dtype={cfg.dtype}")
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(seed=0)
    torch.cuda.synchronize()
    log(f"[model] params={model.param_count() / 1e9:.3f}B init_s="
        f"{time.perf_counter() - t0:.2f}")
    return model, params, ByteTokenizer(cfg.vocab_size)


def serving_phases(dev, model, params, tok):
    import torch
    from repro_torch.serving.server import EngineConfig, LLMServer

    cfg = model.cfg
    rng = random.Random(0)

    # ---- phase 3: dense ---------------------------------------------------
    dense = LLMServer(cfg, num_slots=4, capacity=2048, params=params,
                      engine_cfg=EngineConfig(cache_mode="dense"), device=dev)
    prompts = [make_text(tok, rng, n) for n in (200, 600, 1000, 1500)]
    turns = [make_text(tok, rng, 300), " user: " + make_text(tok, rng, 100)]
    dh, dcounts, _ = serve_phase("dense", dense, prompts, 2, turns,
                                 warm=make_text(tok, rng, 40))
    if dcounts["flash_attention"] <= 0 or dcounts["decode_attention"] <= 0:
        raise AssertionError(f"dense: kernels not launched: {dcounts}")
    profile_decode_chunk(dense, prompts)
    del dense
    torch.cuda.empty_cache()

    # ---- phase 4: paged (the FAME harness's engine setting) --------------
    paged = LLMServer(cfg, num_slots=4, capacity=2048, params=params,
                      engine_cfg=EngineConfig(cache_mode="paged", page_size=16,
                                              decode_chunk=8), device=dev)
    system = ("System: you are one agent of a Planner/Actor/Evaluator "
              "workflow; tools are MCP functions. " + make_text(tok, rng, 500))
    warm = system + "planner: plan the task."
    pprompts = [system + f"{role}: " + make_text(tok, rng, n)
                for role, n in (("planner", 100), ("actor", 300),
                                ("evaluator", 600), ("actor", 900))]
    pturns = [system + "planner: " + make_text(tok, rng, 80),
              " tool: " + make_text(tok, rng, 120)]
    ph, pcounts, pst = serve_phase("paged", paged, pprompts, 1, pturns, warm=warm)
    if pcounts["flash_attention"] <= 0 or pcounts["paged_decode_attention"] <= 0:
        raise AssertionError(f"paged: kernels not launched: {pcounts}")
    if pst["prefix_hit_tokens"] <= 0:
        raise AssertionError("paged: no prefix hits")
    del paged
    torch.cuda.empty_cache()

    # ---- phase 5: dense against paged, teacher-forced ---------------------
    r = dh[0].request                              # a greedy dense request
    ids = tok.encode(prompts[0])[-r.prompt_tokens:] + list(r.output_ids)
    ld = teacher_forced(model, params, ids, r.prompt_tokens, paged=False, dev=dev)
    lp = teacher_forced(model, params, ids, r.prompt_tokens, paged=True, dev=dev)
    diff = float((ld - lp).abs().max())
    scale = float(ld.abs().max())
    agree = float((ld.argmax(-1) == lp.argmax(-1)).float().mean())
    greedy_ok = ld.argmax(-1).tolist() == [int(x) for x in r.output_ids]
    log(f"[dense-vs-paged] steps={ld.shape[0]} max_abs_logit_diff={diff:.3e} "
        f"(|logit| max {scale:.3f}, tol 5e-2) greedy_agreement={agree:.4f} "
        f"dense_teacher_forced_matches_served={greedy_ok}")
    if not math.isfinite(diff) or diff > 5e-2:
        raise AssertionError(f"dense vs paged logits differ by {diff}")
    return {k: dcounts[k] + pcounts[k] for k in dcounts}


# ---------------------------------------------------------------------------
# phase 6: speculative decode
# ---------------------------------------------------------------------------


def copy_prompts(tok, rng):
    """Agent prompts that repeat tool output inside themselves, the traffic
    the n-gram drafter is for."""
    out = []
    for role, n in (("actor", 150), ("evaluator", 300), ("planner", 450),
                    ("actor", 600)):
        tool = make_text(tok, rng, n)
        out.append(f"System: one agent of a Planner/Actor/Evaluator workflow.\n"
                   f"[ToolMessage tool=search_logs]\n{tool}\n[{role}] The tool "
                   f"returned:\n{tool}\nQuote it again:\n{tool[:len(tool) // 2]}")
    return out


def spec_server(model, params, dev, mode, spec_len=4):
    from repro_torch.serving.server import EngineConfig, LLMServer
    kw = dict(page_size=16, decode_chunk=8) if mode == "paged" else {}
    return LLMServer(model.cfg, num_slots=4, capacity=2048, params=params,
                     engine_cfg=EngineConfig(cache_mode=mode, spec_len=spec_len, **kw),
                     device=dev)


def serve_ids(server, prompts, max_new_tokens=48):
    from repro_torch.serving.server import SamplingParams
    hs = [server.submit(p, SamplingParams(max_new_tokens=max_new_tokens))
          for p in prompts]
    server.run_until_idle()
    for h in hs:
        if h.request.status != "completed" or not h.request.output_ids:
            raise AssertionError(f"rid={h.request.rid} status={h.request.status}")
    return hs


def verify_vs_decode(model, params, ids, n, S, dev, paged):
    """Teacher-forced: logits of one verify forward over ids[n:n+S] against
    S decode steps, after a prefill of ids[:n]; max abs difference."""
    import torch
    from repro_torch.serving import kvpool
    cap, ps = 2048, 16
    out = []
    for how in ("verify", "decode"):
        tok = torch.tensor([ids[:n]], device=dev)
        if paged:
            cache = kvpool.init_paged_cache(model.cfg, 1 + cap // ps, ps, dev)
            bt = torch.arange(1, 1 + cap // ps, dtype=torch.int32, device=dev)[None]
            model.extend(params, model.make_batch(tok), cache, 0, length=n,
                         block_tables=bt, with_logits=False)
        else:
            bt = None
            cache = model.init_cache(1, cap)
            model.prefill(params, model.make_batch(tok), cache, length=n,
                          with_logits=False)
        x = torch.tensor([ids[n:n + S]], device=dev)
        pos = n + torch.arange(S, device=dev)[None]
        if how == "verify":
            lg, _ = model.verify(params, {"tokens": x, "positions": pos}, cache,
                                 torch.tensor([n], dtype=torch.int32, device=dev),
                                 lens=torch.tensor([S], device=dev), block_tables=bt)
        else:
            steps = []
            for i in range(S):
                b = {"tokens": x[:, i:i + 1], "positions": pos[:, i:i + 1]}
                li, _ = model.decode_step(
                    params, b, cache,
                    torch.tensor([n + i], dtype=torch.int32, device=dev),
                    block_tables=bt)
                steps.append(li)
            lg = torch.cat(steps, 1)
        out.append(lg.float())
    diff = float((out[0] - out[1]).abs().max())
    agree = float((out[0].argmax(-1) == out[1].argmax(-1)).float().mean())
    return diff, agree, float(out[1].abs().max())


def spec_phase(dev, model, params, tok):
    import torch
    from repro_torch.models import Model

    rng = random.Random(1)
    prompts = copy_prompts(tok, rng)
    counts_all = collections.Counter()
    served = {}
    for mode in ("dense", "paged"):
        srv = spec_server(model, params, dev, mode)
        serve_ids(srv, [prompts[0][:200]], 4)              # warm
        torch.cuda.synchronize()
        before = srv.stats()
        eng = srv.engine
        rows0 = eng._verify_rows
        reset_counts()
        t0 = time.perf_counter()
        hs = serve_ids(srv, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        st = srv.stats()
        d = {k: st[k] - before[k] for k in ("verify_steps", "draft_tokens",
                                            "accepted_tokens", "decode_tokens")}
        rows = eng._verify_rows - rows0
        dec_s = sum(h.request.decode_s for h in hs)
        ttft = [round(h.request.first_token_s, 4) for h in hs]
        log(f"[spec-{mode}] requests={len(hs)} prompt_tokens="
            f"{[h.request.prompt_tokens for h in hs]} output_tokens="
            f"{[h.request.output_tokens for h in hs]}")
        log(f"[spec-{mode}] wall_s={wall:.3f} ttft_s={ttft} decode_tok_per_s="
            f"{d['decode_tokens'] / max(dec_s, 1e-9):.1f} verify_steps="
            f"{d['verify_steps']} draft_tokens={d['draft_tokens']} accepted_tokens="
            f"{d['accepted_tokens']} acceptance_rate="
            f"{d['accepted_tokens'] / max(d['draft_tokens'], 1):.4f} "
            f"verified_rows={rows} tokens_per_verify_step="
            f"{(d['accepted_tokens'] + rows) / max(d['verify_steps'], 1):.3f} "
            f"tokens_per_verified_row={(d['accepted_tokens'] + rows) / max(rows, 1):.3f}")
        log(f"[spec-{mode}] launches={counts}")
        if d["verify_steps"] <= 0 or d["draft_tokens"] <= 0:
            raise AssertionError(f"spec-{mode}: no verify steps / drafts: {d}")
        path = ("flash_attention", "accept_len") + (
            ("paged_decode_attention", "paged_spec_decode_attention")
            if mode == "paged" else ("decode_attention", "spec_decode_attention"))
        missing = [k for k in path if counts[k] <= 0]
        if missing:
            raise AssertionError(f"spec-{mode}: kernels not launched: {missing}")
        counts_all.update(counts)
        served[mode] = [h.request.output_ids for h in hs]
        if mode == "dense":
            r = hs[1].request
            ids = tok.encode(prompts[1])[-r.prompt_tokens:] + list(r.output_ids)
        del srv
        torch.cuda.empty_cache()

    # verify logits against step-by-step decode logits (bf16, full depth)
    for paged in (False, True):
        diff, agree, scale = verify_vs_decode(model, params, ids, len(ids) - 8, 5,
                                              dev, paged)
        log(f"[spec-verify-vs-decode] {'paged' if paged else 'dense'} S=5 "
            f"max_abs_logit_diff={diff:.3e} (|logit| max {scale:.3f}, tol 5e-2) "
            f"argmax_agreement={agree:.4f}")
        if not math.isfinite(diff) or diff > 5e-2:
            raise AssertionError(f"verify vs decode logits differ by {diff}")

    # greedy agreement with non-speculative serving (bf16: printed), and
    # the non-speculative decode rate on the same prompts
    base = spec_server(model, params, dev, "dense", spec_len=0)
    serve_ids(base, [prompts[0][:200]], 4)               # warm
    torch.cuda.synchronize()
    before = base.stats()
    t0 = time.perf_counter()
    hs = serve_ids(base, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dec = base.stats()["decode_tokens"] - before["decode_tokens"]
    log(f"[spec-base-dense] spec_len=0 on the same prompts: wall_s={wall:.3f} "
        f"decode_tok_per_s={dec / max(sum(h.request.decode_s for h in hs), 1e-9):.1f}")
    ref = [h.request.output_ids for h in hs]
    del base
    torch.cuda.empty_cache()
    for mode, outs in served.items():
        same = sum(a == b for o, r in zip(outs, ref) for a, b in zip(o, r))
        total = sum(len(r) for r in ref)
        log(f"[spec-{mode}] bf16 greedy agreement with spec_len=0: {same}/{total} "
            f"tokens, identical requests {sum(o == r for o, r in zip(outs, ref))}/"
            f"{len(ref)}")

    # float32, full width, 4 layers: greedy spec == non-spec, token for token
    cfg4 = dataclasses.replace(model.cfg, num_layers=4, dtype="float32",
                               param_dtype="float32")
    m4 = Model(cfg4, device=dev)
    p4 = m4.init(seed=1)
    outs4 = {}
    for mode, sl in (("dense", 0), ("dense", 4), ("paged", 4)):
        srv = spec_server(m4, p4, dev, mode, spec_len=sl)
        outs4[mode, sl] = [h.request.output_ids for h in serve_ids(srv, prompts)]
        st = srv.stats()
        if sl and st["verify_steps"] <= 0:
            raise AssertionError(f"f32 4-layer {mode}: no verify steps")
        del srv
    ok = outs4["dense", 4] == outs4["dense", 0] == outs4["paged", 4]
    log(f"[spec-f32-4-layers] greedy spec == non-spec (dense and paged): {ok} "
        f"output_tokens={[len(o) for o in outs4['dense', 0]]}")
    if not ok:
        raise AssertionError("float32 greedy spec output differs from non-spec")
    del m4, p4
    torch.cuda.empty_cache()
    return dict(counts_all)


# ---------------------------------------------------------------------------
# phase 7: the FAME runtime on the paged spec server
# ---------------------------------------------------------------------------


def fame_phase(dev, model, params):
    import torch
    from repro_torch.apps import log_analytics as la
    from repro_torch.core.config import CONFIGS
    from repro_torch.core.runtime import FameRuntime
    from repro_torch.fame import ServingMeter, WorkflowServingRuntime
    from repro_torch.serving.server import SamplingParams

    srv = spec_server(model, params, dev, "paged")
    serve_ids(srv, ["warmup " * 8], 8)
    query_input = la.APP.inputs[0]
    oracle_rt = FameRuntime(config=CONFIGS["M+C"])
    for role, oracle in la.build_oracles().items():
        oracle_rt.set_llm(role, oracle)
    oracle_rt.deploy_mcp(la.APP.servers, la.APP.sources)
    want = oracle_rt.run_session(f"fame-{query_input}",
                                 la.APP.queries(query_input)).statuses

    meter = ServingMeter(srv)
    rt = WorkflowServingRuntime(config=CONFIGS["M+C"], server=srv, meter=meter,
                                params=SamplingParams(max_new_tokens=8))
    for role, oracle in la.build_oracles().items():
        rt.set_llm(role, oracle)
    rt.deploy_mcp(la.APP.servers, la.APP.sources)
    torch.cuda.synchronize()
    before = srv.stats()
    reset_counts()
    t0 = time.perf_counter()
    res = rt.run_session(f"fame-{query_input}", la.APP.queries(query_input))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    st = srv.stats()
    hits = st["prefix_hit_tokens"] - before["prefix_hit_tokens"]
    conts = meter.continuation_turns()
    turns = meter.turns()
    log(f"[fame] log_analytics M+C: statuses={res.statuses} (oracle {want}) "
        f"session_wall_s={wall:.3f} turns={len(turns)} "
        f"continuation_turns={len(conts)} prefix_hit_tokens={hits} "
        f"billed_tokens={sum(r.billed_tokens for r in turns)} "
        f"prompt_tokens={sum(r.prompt_tokens for r in turns)} "
        f"verify_steps={st['verify_steps'] - before['verify_steps']}")
    log(f"[fame] launches={counts}")
    if res.statuses != want:
        raise AssertionError(f"fame: statuses {res.statuses} != oracle {want}")
    if not meter.all_terminal():
        raise AssertionError("fame: a turn is not terminal")
    if hits <= 0:
        raise AssertionError("fame: no prefix hits")
    if not conts or not meter.tail_reuse_ok():
        raise AssertionError("fame: the session tail was not reused")
    if counts["flash_attention"] <= 0 or counts["paged_decode_attention"] <= 0:
        raise AssertionError(f"fame: kernels not launched: {counts}")
    del srv
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernels,serve,spec,fame",
                    help="comma list of kernels,serve,spec,fame (default: all)")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # ---- phase 0: device ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    log(card)

    # ---- phase 1: build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    log(f"[build] {len(build.sources())} sources -> {lib} in "
        f"{time.perf_counter() - t0:.1f}s")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("[build] " + line.strip())

    phases = set(args.phases.split(","))
    rows = kernel_phase(dev) if "kernels" in phases else {}
    launches = collections.Counter()
    if phases & {"serve", "spec", "fame"}:
        model, params, tok = full_model(dev)
        if "serve" in phases:
            launches.update(serving_phases(dev, model, params, tok))
        if "spec" in phases:
            launches.update(spec_phase(dev, model, params, tok))
        if "fame" in phases:
            launches.update(fame_phase(dev, model, params))
    for name, r in rows.items():
        r["launches"] = launches.get(name, 0)
    if {"serve", "spec"} <= phases:
        idle = [name for name, r in rows.items() if r["launches"] <= 0]
        if idle:
            raise AssertionError(f"kernels never launched on the main path: {idle}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(card)
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
