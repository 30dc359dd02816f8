#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``src/repro_torch``).

Drives the port's main path on one NVIDIA card and fails (non-zero exit,
no result line) on any fault:

  0. device: the card's name and power limit (nvidia-smi); no CUDA -> fail;
  1. build: compile the port's CUDA kernels from ``src/repro_torch/kernels/
     csrc`` (nvcc, sm_90a) and print registers / spills (-Xptxas -v);
  2. kernels: each kernel against its plain PyTorch version at the serving
     path's shapes in bf16 (tolerance 2e-2) and at one fp32 shape (2e-5),
     the dense window-ring cases included (one with whole splits masked),
     and the split-K decode kernels, dense and paged, in fp32 at the serving
     shape too (1-16 splits a row); kernel, plain-version and library
     (``scaled_dot_product_attention``, a yardstick the port never calls)
     times, profiler device times of the attention kernels, and the least
     time the card could take for the work. Flash is timed at qwen2.5-3b's
     prefill and, as rows of their own, at recurrentgemma-9b's
     (``flash_attention_hd256``: hd 256, one KV head, window 2048) and at
     mixtral-8x22b's (``flash_attention_swa``: q [1,8192,48,128], 8 KV
     heads, G = 6, window 4096); the flash backward kernel at
     recurrentgemma-9b's train microbatch (``flash_attention_bwd_hd256``:
     [2,2048,16,256], one KV head, window 2048; gradients against plain
     autograd, two calls bit-identical, call and device ms beside the
     plain backward's and SDPA's backward, the share of the bound reached
     and the ratio to SDPA's backward); so is the ring decode
     (``decode_attention_ring``: recurrentgemma's 2048-slot ring, hd 256,
     one KV head; ``decode_attention_swa_ring``: mixtral's 4096-slot ring,
     hd 128, G = 6, cache lengths across the wrap); the multi-query
     decode kernels, dense and paged, equal S one-token calls bit for bit; rglru_scan on both routes
     (recurrentgemma-9b's prefill and verify shapes) and mlstm_chunk on
     both (bf16 tensor cores at xlstm-350m's prefill and extend shapes;
     float32 CUDA cores, at xlstm's chunk of 256 against the plain version
     in float64), with their profiler device times, and accept_len's;
     the sLSTM scan's two kernels at xlstm-350m's widths (4 heads of 256)
     against the plain loop and autograd through it, float32 and bf16, at
     its train microbatch, a padded 1500-token admission, decode, verify
     (every state kept) and an extend with a state in, two calls
     bit-identical (rows ``slstm_scan`` and ``slstm_scan_bwd``: call and
     device ms, bound, serial floor, plain ms; no library call);
  3. dense serving: ``LLMServer`` with full-width qwen2.5-3b (bf16, random
     weights from a seed, 4 slots, capacity 2048, cache_mode="dense"):
     4 concurrent requests of ~200-1500 prompt tokens, one sampled, and a
     2-turn session; every request COMPLETED, flash and decode kernels
     launched; then torch.profiler over one decode chunk (device time by
     kernel, the device's idle share), on the replayed CUDA graphs and on
     the eager steps, and over one 1503-token prefill alone
     (recurrentgemma-9b's 3002-token one in phase 8); then greedy ids of
     4 requests over two decode chunks, graph against eager, from fresh
     servers on the same weights (equal ids and launch counts);
  4. paged serving: the same server with cache_mode="paged", page_size=16,
     decode_chunk=8 (the FAME harness's setting) on prompts sharing a
     system prompt; prefix hits > 0, paged-decode kernel launched; one
     paged decode chunk profiled and graph against eager as in 3;
  5. dense against paged: teacher-forced logits of both cache layouts on the
     same weights and tokens, and their greedy-token agreement;
  6. speculative decode: the same model served with spec_len=4, dense and
     paged (page_size=16, decode_chunk=8), on copy-heavy agent prompts;
     every request COMPLETED, verify steps and drafts > 0, the path's four
     kernels launched (flash, one-token decode, multi-query decode,
     accept_len); one verify step profiled (graph and eager); verify
     logits against step-by-step decode logits of one request (5e-2),
     greedy agreement with non-speculative serving (bf16, printed), and
     greedy spec == non-spec token for token at full width and 4 layers
     in float32 (asserted);
  7. FAME: one log-analytics M+C session through the port's
     WorkflowServingRuntime on the paged spec_len=4 server; statuses equal
     the ScriptedOracle backend's, prefix hits > 0, session tail reused;
  7c. apps: the port's FAME entry points (``repro_torch.examples``) on the
     same weights: ``research_summary`` and ``log_analytics`` with oracle
     agents (host only: E does not finish, M+C does); ``quickstart`` with
     every agent role on ``TorchLLM`` over one paged server of its
     settings (4 slots, capacity 512), RS and LA under M+C in both fusion
     modes (four sessions; statuses logged, every turn terminal, prefix
     hits > 0, role sessions carried several turns); ``serve_agents``
     with 3 workflows x 2 rounds, paged, then spec_len=4 (every handle
     COMPLETED, turns admitted off the retained tail, verify steps > 0
     with spec); flash, paged decode and, with spec, accept_len and the
     paged multi-query decode launched, on the bf16 routes and graphs;
  7b. fleet: the same qwen2.5-3b weights behind ``FleetServer`` (2 replicas,
     4 slots each, capacity 2048, paged, page_size 16, decode_chunk 8, a
     background pump per replica capturing and replaying its own graphs);
     the replicas share one set of weight tensors (data_ptr) and peak
     memory is printed beside 1x weights + 2x (page pool + graph pool);
     replica 1 admits a request while replica 0's first decode capture is
     held open (the capture records one paged decode a layer, its own);
     8 two-turn sessions in two ~500-token prefix families from 4 threads:
     every turn COMPLETED, affinity hits > 0, both replicas placed work,
     every decode step of each replica a replay or a capture's warm-up,
     and paged-decode launches == layers x decode steps (the counts of two
     pumps stay exact); one FAME M+C session on the fleet (the oracle's
     statuses); replica 1's pump crashed mid-traffic, its sessions
     migrated and their next turns COMPLETED on replica 0; add_replica()
     then drain(0): the new replica shares the weights, captures its own
     graphs and takes every session; the same sessions on one 8-slot
     server (aggregate output tok/s printed beside the fleet's); priority
     preemption on graph servers, dense and paged (preemptions and resumes
     >= 1); journal restore into a fresh server; in bf16 the teacher-forced
     logits after a re-prefill (resume, migration) within 5e-2 of the
     decode-built ones, token agreement printed; then at full width, 4
     layers, float32: migration, preempt-resume (one request sampled) and
     journal restore equal the uninterrupted server token for token;
  8. stateful archs: recurrentgemma-9b (capacity 4096; a ~3000-token prompt
     wraps the 2048-position local-attention ring) and xlstm-350m
     (capacity 2048) at full width, bf16, random weights from seed 0,
     4 slots: dense, snapshot (cache_mode="paged", page_size 16,
     decode_chunk 8, explicit num_snapshots / snap_stride) with a shared
     system prompt and a 2-turn session, and spec_len=4 on copy-heavy
     prompts; every request COMPLETED, snapshot hits > 0, rglru_scan /
     flash / decode / accept_len (recurrentgemma) and mlstm_chunk /
     slstm_scan / accept_len (xlstm) launched, the sLSTM kernel once a
     sLSTM layer a prefill / extend forward, decode step and verify step,
     and the plain loop on no CUDA tensor; parameter, slot-cache, arena and
     verify-staging bytes and peak memory printed, each model freed before
     the next loads; the dense decode chunk and the longest prompt's
     admission profiled, and graph against eager as in 3. Then one pattern
     period (5 / 8 layers) at full width
     in float32: snapshot == dense and spec == non-spec greedy token for
     token, and decode-step logits after a prefill against one full
     forward within 1e-3;
  9. MoE archs: mixtral-8x22b (4 of 56 layers, capacity 8192; a ~6000-token
     prompt wraps the 4096-slot sliding-window ring) and dbrx-132b (3 of 40
     layers, capacity 2048), every width the published one, bf16, random
     weights from seed 0, 4 slots, each model freed before the next loads:
     dense serving with a 2-turn session, mixtral's state snapshots
     (cache_mode="paged", explicit num_snapshots / snap_stride) and dbrx's
     KV pages (page_size 16, decode_chunk 8) with prefix hits > 0, and
     spec_len=4 (mixtral dense, dbrx paged); every request COMPLETED, flash,
     ring decode, paged decode and accept_len launched; the dense decode
     chunk profiled on graphs and eagerly, the longest prompt's admission
     profiled, graph against eager ids; the share of (token, choice) pairs
     a prefill drops at the published capacity factor and the MoE layer's
     share of a decode step beside its bytes bound printed; dbrx's dense
     against paged teacher-forced logits (5e-2). Then one mixtral layer at
     full width in float32, drop-free (capacity factor 4 = E / k): snapshot
     == dense and spec == non-spec greedy, and decode-step logits after a
     4200-token prefill (past the window) against one full forward within
     1e-3;
  10. modality archs: musicgen-large (12 of 48 layers, MHA 32 heads at hd 64,
     sinusoidal positions; its inputs are the frame-embedding stub
     one_hot(id % d_model), built on the device) and chameleon-34b (12 of
     48 layers, d_model 8192, 64 / 8 heads, qk-norm, early-fusion token
     ids), published widths, bf16, random
     weights from seed 0, 4 slots, capacity 2048, each model freed before
     the next loads: dense serving with a 2-turn session, then KV pages
     (page_size 16, decode_chunk 8) on prompts sharing a ~500-token system
     prompt; every request COMPLETED, flash launches == layers x prefill /
     extend forwards and decode (dense or paged) launches == layers x
     decode steps; one dense decode chunk profiled (graph and eager) and
     the longest prompt's admission; graph ids == eager ids, dense and
     paged; teacher-forced logits of the dense cache and the page pool
     within 5e-2 of each other, and each against one forward over the same
     tokens (printed; bf16 rounding in other GEMM shapes); peak memory;
     then 4 layers at the published widths in float32: the decode-built
     logits within 1e-3 of one forward. The kernels phase
     times flash, dense and paged decode at musicgen's shapes and flash at
     chameleon's (rows ``*_musicgen``, ``flash_attention_chameleon``, with
     SDPA's device time);
  11. checkpoint: musicgen-large at full width and 4 of 48 layers, bf16:
     its params saved in the reference's format by the port's
     ``AsyncCheckpointer`` into a directory under build/ while a server on
     the same params serves 4 requests, restored onto the card by
     ``Model.restore``: every tensor bit-identical, a server on the restored
     params gives the same greedy ids; save / restore seconds and bytes
     printed, the directory deleted;
  12. train: qwen2.5-3b at its published width and depth (36 layers, bf16,
     random weights from seed 0, remat full), trained through the port's
     ``make_train_step``: SyntheticLM batches of 4 x 2048 tokens in 2
     microbatches, AdamW (lr 1e-4), 16 steps; the loss falls by >= 1.5,
     flash forward launches == 2 x 36 x 2 x 16 (each layer's forward and
     its recompute) on wgmma, backward launches == 36 x 2 x 16 on
     wgmma_bwd, and no other kernel; per-step loss, grad norm, lr, wall and
     tokens/s, peak memory, the split of a step into forward + backward and
     optimizer, one profiled step (the flash backward kernels' device ms
     and share) and the 8·N·T share of the bf16 peak. Then the flash
     kernels at the train shape (rows ``flash_attention_train``: forward
     against plain, and ``flash_attention_bwd``: the autograd.Function's
     gradients against plain autograd, two backward calls bit-identical,
     the backward's call and device ms beside the plain backward's and
     SDPA's backward's, its share of the bound and its ratio to SDPA's),
     one step's gradients
     through the kernel path against plain autograd at reduced float32 and
     bf16 configs (GQA, causal and windowed), and 2 of 36 layers trained 3
     steps, saved, restored into fresh params and resumed against the
     uninterrupted run (save / restore seconds and bytes; the directory
     deleted).
  13. mesh: serving on a device mesh whose positions all lie on the one
     card (``EngineConfig(mesh=make_test_mesh(shape, devices="cuda:0"))``,
     the reference's bit-exact serve rules; it runs after the fleet phase,
     on its qwen2.5-3b weights): (a) float32 at the published widths and a
     cut depth: qwen2.5-3b (4 layers, a (2, 2) mesh cutting its 2 KV
     heads), recurrentgemma-9b (3 layers, one period, (2, 2)) and
     mixtral-8x22b (2 layers, (2, 4): experts over "model"), each dense and
     paged (KV pages or state snapshots) with spec_len 0 and 4: the mesh
     server's greedy ids equal the unsharded server's in every cell, every
     step on the graph path, the decode kernel launched once a layer, step
     and launching shard (``launch_counts.expected``), and the largest
     teacher-forced logit difference printed; (b) bf16 qwen2.5-3b at 36
     layers on a (1, 2) mesh beside the unsharded server (paged, the FAME
     harness's settings): every decode step a replay, launches under the
     rule, decode tok/s, TTFT of a 1000-token prompt, peak memory and one
     decode chunk profiled on the graphs; (c)
     the sequence-parallel decode at qwen's decode shape (4 shards of 512
     slots: a partials launch each, one combine; the path's launches
     counted alone) bit-equal to the one-launch kernel and within
     tolerance of the plain version, timed (row ``seqpar_decode_attention``);
     (d) a 2-layer qwen saved unsharded, restored onto a (2, 2) mesh and
     back, every bit equal. The phase prints its seconds and fails past
     120 s.
  14. stateful_train: recurrentgemma-9b at its published widths and 6 of
     38 layers (two periods of recurrent, recurrent, local attention; 3.28 B
     params) and xlstm-350m whole (21 mLSTM, 3 sLSTM layers), bf16, random
     weights from seed 0, remat full, trained through ``make_train_step``:
     SyntheticLM batches of 4 x 2048 tokens in 2 microbatches at AdamW lr
     1e-4 for 8 steps (recurrentgemma) and 4 x 1024 in one at lr 3e-3 for 4
     steps (xlstm; see ``STATEFUL_TRAIN``); the loss falls by >= 0.5, every
     loss and grad norm finite; launches by the rule of
     ``stateful_train_launches`` (rglru_scan 3 a recurrent layer,
     microbatch and step: forward and recompute on the chunked route, the
     gradient kernel on chunked_bwd; mlstm_chunk and flash 3 a layer,
     forward and recompute on wgmma and the backward kernel on wgmma_bwd,
     21 mLSTM backward launches a step; slstm_scan 3 a layer, forward and
     recompute on cluster, the gradient kernel on cluster_bwd; nothing
     else); per-step loss, grad norm, wall and tokens/s, peak memory, the
     second-last step split into forward + backward and optimizer, the last
     under the profiler (the backwards' busy ms; each ``rglru_scan_bwd``
     and ``slstm_scan_bwd`` range holds one kernel, the gradient's), the
     8·N·T share. Then
     one step through the kernel path against plain autograd at reduced
     float32 and bf16 configs of both archs (each kernel call alone on the
     inputs and output gradient it had in the step, the sLSTM's included,
     the loss, the param leaves), and the kernels at the train shapes (rows
     ``rglru_scan_train``: the forward, one launch writing a bf16 y and the
     float32 states; ``rglru_scan_bwd``: the gradient kernel against
     autograd of the plain version on both routes, two calls
     bit-identical; call and device ms, bounds, plain and plain-autograd
     ms of both; ``mlstm_chunk_train``: the forward's;
     ``mlstm_chunk_bwd``:
     the backward kernel against autograd of the plain version, bf16 and a
     float32 call, two calls bit-identical, beside the plain written-out
     backward's ms). The phase prints its seconds and fails past 150 s.
 15. dryrun: the launch layer's trace on ``meta`` (this host's
     CPU; ``repro_torch.launch``) beside the card, for phase 12's train
     step (36-layer qwen2.5-3b on (1, 1), 4 x 2048 in 2 microbatches),
     phase 3's 4-slot decode step and phase 13's paged decode step under
     the serve table on (1, 2): argument bytes against
     ``memory_allocated``, peak temp against ``max_memory_allocated``,
     product FLOPs against the profiler's (``with_flops``), the flash
     backward kernel's analytic GFLOP against its launches on the card;
     the mLSTM backward kernel's in a trace of phase 14's xlstm-350m step
     against the launches phase 14 made a step; then one line per cell of
     the committed ``--all`` sweep on (32, 8).
 16. mesh_train: float32 qwen2.5-3b widths, 4 layers, on (2, 2)
     under the train table against the unsharded step (loss, gradients,
     params; bound 1e-5; the flash backward on its float32 route); bf16
     qwen, 36 layers, on (2, 1) (FSDP and batch
     over "data"), tok/s and peak beside phase 12's; a decode under the
     decode table with "kv_seq" on (1, 2) against unsharded (bound 2e-2).

Every decode chunk is one CUDA graph launch whose while node stops once
every row is done; each serving phase prints the decode steps run after
every row's last emit (``count_run_on``), and fails unless it is 0.

Every server runs its decode chunks and verify steps as replayed CUDA
graphs (``serving/programs.py``); each serving phase prints its decode and
verify steps, captures and replays, and fails unless every step was a
replay or the warm-up step of a capture, at most one capture per variant
and program a server. Kernel launch counts (replays included) are zeroed
just before each serving phase and read just after it; every bf16 serving
phase must have launched flash and mlstm_chunk only on their tensor-core
routes (``launches_by_route``). The line before the last is a JSON object
with one entry per kernel; the last line is ``{"ok": true, "device":
{...}}``.

Run from the repository root:  python3 chip_smoke.py
(``--phases`` picks a subset of kernels,serve,spec,fame,apps,fleet,mesh,
stateful,moe,modality,checkpoint,train,stateful_train,dryrun,mesh_train.)
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import math
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16 = 989e12          # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_TF32 = 495e12          # TF32 on the tensor cores
PEAK_F32 = 67e12            # float32 outside the tensor cores
HBM = 3.35e12               # bytes/s
TOL = {"bfloat16": 2e-2, "float32": 2e-5,
       # the stateful kernels' bounds (tests/test_kernels.py:101, 139)
       "bf16_state": 5e-2, "float32_scan": 5e-6,
       # a float32 backward against autograd of its plain version, relative
       # (tests/test_torch_stateful_training.py's mLSTM bound)
       "float32_grad": 1e-4,
       # the sLSTM scan's float32 route against its plain loop, relative to
       # max(1, the largest value): the state n grows with the steps
       "slstm_f32": 1e-5}


def log(*a):
    print(*a, flush=True)


def not_completed(label, handles) -> None:
    """Fail if a request of ``handles`` did not complete, with the error the
    scheduler's failure isolation kept on it (its traceback logged)."""
    import traceback
    for h in handles:
        r = h.request
        if r.status == "completed" and r.output_ids:
            continue
        why = "" if r.error is None else "".join(
            traceback.format_exception(type(r.error), r.error, r.error.__traceback__))
        log(f"[{label}] rid={r.rid} {r.status}, {len(r.output_ids)} tokens\n{why}")
        raise AssertionError(f"{label}: rid={r.rid} {r.status}: {r.error!r}")


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


def device_ms_by_kernel(fn, iters: int = 20) -> dict:
    """Device ms of one call by kernel: the self time of each kernel under
    torch.profiler, without the host's launch and wrapper cost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def device_ms(fn, iters: int = 20):
    """Device time of one call: the self time of its kernels under
    torch.profiler, without the host's launch and wrapper cost, which
    ``time_ms`` includes when calls are shorter than their dispatch; None
    where the profiler recorded no device time."""
    total = sum(device_ms_by_kernel(fn, iters).values())
    return total if total > 0 else None


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call without its host cost, for calls that launch
    only kernels a CUDA graph can hold: ``fn`` captured once, the graph
    replayed ``iters`` times between two CUDA events (one host call a
    replay), ms per replay."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def log_kernels(name, by_kernel: dict):
    """One line per kernel of a call's device time (``device_ms_by_kernel``)."""
    for key, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        short = key.replace("void ", "").replace("(anonymous namespace)::", "")
        log(f"[kernels] {name}: {ms:.4f} device ms  {short.split('(')[0][:70]}")


def bound(kernel: str, *args, **kw) -> tuple:
    """(least time in ms, "bytes" or "operations") of a kernel's work at
    these shapes: ``repro_torch.kernels.costs.<kernel>``, the counts the
    dry run's cost counter reads too."""
    from repro_torch.kernels import costs
    return costs.bound_ms(getattr(costs, kernel)(*args, **kw))


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
    lf = lambda: F.scaled_dot_product_attention(                    # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    lib = time_ms(lf, 20)
    log_device("flash_attention", fa, lf)
    b_ms, b_by = bound("flash", 1, S, S, H, K, hd, 2, S * (S + 1) // 2)
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
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
    # the same shape in float32: 1-16 splits a row, so the combine across
    # splits and the split boundaries are held to 2e-5
    qd32, kc32, vc32 = qd.float(), kc.float(), vc.float()
    c32 = torch.tensor([1500, 100, 2047, 700], dtype=torch.int32, device=dev)
    err = max(err, check_close(
        "f32 [4,1,16,128] vs [4,2048,2,128] clen [1500,100,2047,700]",
        kda.decode_attention(qd32, kc32, vc32, c32, q_per_kv=G),
        kda.decode_attention_ref(qd32, kc32, vc32, c32, q_per_kv=G), "float32"))
    del qd32, kc32, vc32
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
    # a wrapped ring whose window leaves whole splits masked: each such split
    # writes m = -1e30 and is weighted e^{m - M} = 0 by the combine
    q9, k9, v9 = rnd(4, 1, 16, 128, **f32), rnd(4, 512, 2, 128, **f32), rnd(4, 512, 2, 128, **f32)
    c9 = torch.tensor([1000, 600, 1023, 511], dtype=torch.int32, device=dev)
    err = max(err, check_close(
        "f32 window ring W=512 window=24 clen=[1000,600,1023,511]",
        kda.decode_attention(q9, k9, v9, c9, q_per_kv=G, window=24),
        kda.decode_attention_ref(q9, k9, v9, c9, q_per_kv=G, window=24), "float32"))
    ms, plain = time_ms(da, 50), time_ms(dr, 10)
    pos = torch.arange(W, device=dev)
    mask = (pos[None, :] <= clen[:, None].long())[:, None, None, :]
    qdt, kct, vct = qd.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    lf = lambda: F.scaled_dot_product_attention(                    # noqa: E731
        qdt, kct, vct, attn_mask=mask, enable_gqa=True)
    lib = time_ms(lf, 50)
    log_device("decode_attention", da, lf)
    live = int((torch.clamp(clen.long() + 1, max=W)).sum())
    b_ms, b_by = bound("decode", B, H, K, hd, live, 2)
    rows["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/split_decode_attention.cu",
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
    # the same shape in float32: 1-16 splits a row, so the combine across
    # splits and the split boundaries are held to 2e-5
    qd32, kp32, vp32 = qd.float(), kp.float(), vp.float()
    err = max(err, check_close(
        "f32 pool [1025,16,2,128] bt [4,128] clen [1500,17,2047,700]",
        kpda.paged_decode_attention(qd32, kp32, vp32, bt, cl, q_per_kv=G),
        kpda.paged_decode_attention_ref(qd32, kp32, vp32, bt, cl, q_per_kv=G),
        "float32"))
    del qd32, kp32, vp32
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
    lf = lambda: F.scaled_dot_product_attention(                    # noqa: E731
        qdt, kview, vview, attn_mask=pmask, enable_gqa=True)
    lib = time_ms(lf, 50)
    log_device("paged_decode_attention", pa, lf)
    live = int((cl.long() + 1).sum())
    pages = sum(-(-(c + 1) // ps) for c in cl.tolist())
    b_ms, b_by = bound("decode", B, H, K, hd, live, 2, pages)
    rows["paged_decode_attention"] = dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/split_decode_attention.cu",
        replaces="src/repro/kernels/paged_decode_attention.py:70",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib)
    rows.update(spec_kernel_rows(dev, rnd))
    # recurrentgemma's local attention: hd = 256, one KV head (MQA)
    log("[kernels] flash_attention at hd=256, K=1, window 2048")
    ql, kl, vl = rnd(1, 3000, 16, 256), rnd(1, 3000, 1, 256), rnd(1, 3000, 1, 256)
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], check_close(
            "bf16 [1,3000,16,256] K=1 window=2048",
            kfa.flash_attention(ql, kl, vl, q_per_kv=16, window=2048),
            kfa.flash_attention_ref(ql, kl, vl, q_per_kv=16, window=2048),
            "bfloat16"))
    del ql, kl, vl
    rows["flash_attention_hd256"] = flash_window_row(
        dev, rnd, "flash_attention_hd256", S=4096, H=16, K=1, hd=256, win=2048)
    # its backward kernel at recurrentgemma-9b's train microbatch (phase 14)
    rows["flash_attention_bwd_hd256"] = flash_bwd_row(
        dev, "flash_attention_bwd_hd256", 2, 2048, 16, 1, 256, window=2048)
    rows["decode_attention_ring"] = decode_ring_row(
        dev, rnd, "decode_attention_ring", W=2048, H=16, K=1, hd=256, win=2048,
        clens=[2999, 100, 2047, 4095])
    # mixtral-8x22b's sliding window: G = 6, window 4096 at hd 128
    rows["flash_attention_swa"] = flash_window_row(
        dev, rnd, "flash_attention_swa", S=8192, H=48, K=8, hd=128, win=4096)
    rows["decode_attention_swa_ring"] = decode_ring_row(
        dev, rnd, "decode_attention_swa_ring", W=4096, H=48, K=8, hd=128,
        win=4096, clens=[300, 4095, 4097, 8000])
    # the modality archs: musicgen-large is MHA at hd 64 (G = 1),
    # chameleon-34b the widest attention of the registry (64 / 8 heads)
    rows["flash_attention_musicgen"] = flash_window_row(
        dev, rnd, "flash_attention_musicgen", S=2048, H=32, K=32, hd=64, win=None)
    rows.update(mha_decode_rows(dev, rnd, "musicgen", W=2048, H=32, hd=64,
                                clens=[1500, 200, 2047, 700]))
    rows["flash_attention_chameleon"] = flash_window_row(
        dev, rnd, "flash_attention_chameleon", S=2048, H=64, K=8, hd=128, win=None)
    rows.update(stateful_kernel_rows(dev))
    rows.update(slstm_kernel_rows(dev))
    for r in rows.values():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"[kernels] {r['name']}: kernel_ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} library_ms={lib} bound_ms="
            f"{r['bound_ms']:.4f} ({r['bound_by']})")
    return rows


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def device_times(name, kernel, library):
    """The device times of a kernel and of its library call, beside the
    event-timed call times of the kernels line: (kernel's, library's)."""
    dms, lib = device_ms(kernel), device_ms(library)
    log(f"[kernels] {name}: device_ms={fmt_ms(dms)} library_device_ms={fmt_ms(lib)}")
    return dms, lib


def log_device(name, kernel, library):
    """``device_times``; returns the kernel's."""
    return device_times(name, kernel, library)[0]


def flash_window_row(dev, rnd, name, S, H, K, hd, win):
    """Flash over one sequence of S positions with a sliding window (None:
    causal only), bf16: ``flash_attention_hd256`` at recurrentgemma-9b's
    prefill bucket (q [1,4096,16,256], one KV head, window 2048),
    ``flash_attention_swa`` at mixtral-8x22b's largest prefill bucket (q
    [1,8192,48,128], 8 KV heads, G = 6, window 4096),
    ``flash_attention_musicgen`` (q, k, v [1,2048,32,64], MHA at hd 64) and
    ``flash_attention_chameleon`` (q [1,2048,64,128], 8 KV heads) at their
    largest bucket. The bound counts only the causal pairs inside the
    window; the library call is SDPA with that mask (``is_causal`` without
    a window)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    log(f"[kernels] {name}")
    q, k, v = rnd(1, S, H, hd), rnd(1, S, K, hd), rnd(1, S, K, hd)
    fa = lambda: kfa.flash_attention(q, k, v, q_per_kv=H // K, window=win)      # noqa: E731
    fr = lambda: kfa.flash_attention_ref(q, k, v, q_per_kv=H // K, window=win)  # noqa: E731
    err = check_close(f"bf16 [1,{S},{H},{hd}] K={K} window={win}", fa(), fr(),
                      "bfloat16")
    ms, plain = time_ms(fa, 20), time_ms(fr, 2, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if win is None:
        lf = lambda: F.scaled_dot_product_attention(                # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        pos = torch.arange(S, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < win)
        lf = lambda: F.scaled_dot_product_attention(                # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    lib = time_ms(lf, 20)
    dms, lib_dms = device_times(name, fa, lf)
    b_ms, b_by = bound("flash", 1, S, S, H, K, hd, 2, sum(min(i + 1, win or S)
                                                          for i in range(S)))
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        replaces="src/repro/kernels/flash_attention.py:63",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib, device_ms=dms, library_device_ms=lib_dms)


def mha_decode_rows(dev, rnd, name, W, H, hd, clens):
    """Split-K decode at an MHA geometry (G = 1: one query row per KV head),
    bf16, dense and paged: ``decode_attention_<name>`` (q [B,1,H,hd] over
    caches [B,W,H,hd]) and ``paged_decode_attention_<name>`` (the same
    positions in a pool of 16-token pages, trash page past the live ones),
    each also at float32 against the plain version. The bound reads the
    live positions' K/V once; the library call is SDPA with the length
    mask (over the pre-gathered view, paged)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import paged_decode_attention as kpda
    B, ps = len(clens), 16
    nw = W // ps
    q, kc, vc = rnd(B, 1, H, hd), rnd(B, W, H, hd), rnd(B, W, H, hd)
    clen = torch.tensor(clens, dtype=torch.int32, device=dev)
    P = B * nw + 1
    kp, vp = rnd(P, ps, H, hd), rnd(P, ps, H, hd)
    g = torch.Generator(device=dev)
    g.manual_seed(W + H)
    bt = (torch.randperm(P - 1, generator=g, device=dev)[:B * nw] + 1).reshape(B, nw)
    bt = bt.to(torch.int32)
    for b, c in enumerate(clens):                 # trash page past the live ones
        bt[b, -(-(c + 1) // ps):] = 0
    forms = {
        f"decode_attention_{name}": (
            "src/repro/kernels/decode_attention.py:71",
            lambda q_, k_, v_: kda.decode_attention(q_, k_, v_, clen, q_per_kv=1),
            lambda q_, k_, v_: kda.decode_attention_ref(q_, k_, v_, clen, q_per_kv=1),
            kc, vc, lambda t: t),
        f"paged_decode_attention_{name}": (
            "src/repro/kernels/paged_decode_attention.py:70",
            lambda q_, k_, v_: kpda.paged_decode_attention(q_, k_, v_, bt, clen,
                                                           q_per_kv=1),
            lambda q_, k_, v_: kpda.paged_decode_attention_ref(q_, k_, v_, bt, clen,
                                                               q_per_kv=1),
            kp, vp, lambda t: t[bt.long()].reshape(B, nw * ps, H, hd)),
    }
    live = sum(min(c + 1, W) for c in clens)
    pages = sum(-(-(c + 1) // ps) for c in clens)
    mask = (torch.arange(W, device=dev)[None, :]
            <= clen[:, None].long())[:, None, None, :]
    rows = {}
    for row, (replaces, kern, plain, k, v, view) in forms.items():
        log(f"[kernels] {row}")
        paged = row.startswith("paged")
        err = check_close(f"bf16 q [{B},1,{H},{hd}] G=1 clen={clens}",
                          kern(q, k, v), plain(q, k, v), "bfloat16")
        q32, k32, v32 = q.float(), k.float(), v.float()
        err = max(err, check_close(f"f32 q [{B},1,{H},{hd}] G=1", kern(q32, k32, v32),
                                   plain(q32, k32, v32), "float32"))
        del q32, k32, v32
        fn = lambda: kern(q, k, v)                                  # noqa: E731
        ms, plain_ms = time_ms(fn, 50), time_ms(lambda: plain(q, k, v), 10)
        qt, kt, vt = q.transpose(1, 2), view(k).transpose(1, 2), view(v).transpose(1, 2)
        lf = lambda: F.scaled_dot_product_attention(                # noqa: E731
            qt, kt, vt, attn_mask=mask)
        lib = time_ms(lf, 50)
        dms, lib_dms = device_times(row, fn, lf)
        b_ms, b_by = bound("decode", B, H, H, hd, live, 2, pages if paged else 0)
        rows[row] = dict(
            name=row, route="cuda",
            source="src/repro_torch/kernels/csrc/split_decode_attention.cu",
            replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib, device_ms=dms,
            library_device_ms=lib_dms)
    return rows


def decode_ring_row(dev, rnd, name, W, H, K, hd, win, clens):
    """Decode of 4 slots over a ring cache of W slots with window ``win``,
    bf16, cache lengths spread across the wrap: ``decode_attention_ring``
    at recurrentgemma-9b's local attention (ring 2048, one KV head, hd
    256), ``decode_attention_swa_ring`` at mixtral-8x22b's sliding window
    (ring 4096, 8 KV heads, G = 6, hd 128). The bound counts the slots the
    ring-age mask keeps; the library call is SDPA with that slot mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kda
    log(f"[kernels] {name}")
    B = len(clens)
    q, kc, vc = rnd(B, 1, H, hd), rnd(B, W, K, hd), rnd(B, W, K, hd)
    clen = torch.tensor(clens, dtype=torch.int32, device=dev)
    da = lambda: kda.decode_attention(q, kc, vc, clen, q_per_kv=H // K,      # noqa: E731
                                      window=win)
    dr = lambda: kda.decode_attention_ref(q, kc, vc, clen, q_per_kv=H // K,  # noqa: E731
                                          window=win)
    err = check_close(f"bf16 ring [{B},{W},{K},{hd}] G={H // K} window={win} "
                      f"clen={clens}", da(), dr(), "bfloat16")
    ms, plain = time_ms(da, 50), time_ms(dr, 10)
    c = clen.long()[:, None]
    pos = torch.arange(W, device=dev)[None, :]
    n_valid = torch.clamp(c + 1, max=W)
    age = torch.remainder(c % W - pos, W)
    kept = (pos < n_valid) & (age < torch.clamp(n_valid + 1, max=win))
    mask = kept[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    lf = lambda: F.scaled_dot_product_attention(                    # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    lib = time_ms(lf, 50)
    dms = log_device(name, da, lf)
    live = int(kept.sum())
    b_ms, b_by = bound("decode", B, H, K, hd, live, 2)
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/split_decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:71",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib, device_ms=dms)


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
    al = lambda: spec_scan.accept_len(acc, lens)                    # noqa: E731
    ms = time_ms(al, 200)
    plain = time_ms(lambda: spec_scan.accept_len_ref(acc, lens), 50)
    dms = device_ms(al, 200)
    log(f"[kernels] accept_len: device_ms={fmt_ms(dms)}")
    B, S = acc.shape
    b_ms, b_by = bound("accept_len", B, S)
    rows["accept_len"] = dict(
        name="accept_len", route="cuda",
        source="src/repro_torch/kernels/csrc/spec_scan.cu",
        replaces="src/repro/kernels/spec_scan.py:33",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, device_ms=dms)

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
    lf = lambda: F.scaled_dot_product_attention(                    # noqa: E731
        qst, kct, vct, attn_mask=mask, enable_gqa=True)
    lib = time_ms(lf, 50)
    log_device("spec_decode_attention", sa, lf)
    live = int(torch.clamp(clen.long() + S, max=W).sum())
    pairs = int(torch.clamp(pos_q + 1, max=W).sum())
    b_ms, b_by = bound("verify", B, S, H, K, hd, live, pairs, 2)
    rows["spec_decode_attention"] = dict(
        name="spec_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/split_decode_attention.cu",
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
    # a row whose 5 positions straddle the split boundary at 2048 - 128 = 1920
    cs = torch.tensor([1500, 17, 2043, 1917], dtype=torch.int32, device=dev)
    qs32, kp32, vp32 = qs.float(), kp.float(), vp.float()
    for c in (cl, cs):                           # 1-16 splits a row, float32
        err = max(err, check_close(
            f"f32 pool [1025,16,2,128] bt [4,128] S=5 clen {c.tolist()}",
            kpsda.paged_spec_decode_attention(qs32, kp32, vp32, bt, c, q_per_kv=G),
            kpsda.paged_spec_attention_ref(qs32, kp32, vp32, bt, c, q_per_kv=G),
            "float32"))
    del qs32, kp32, vp32
    one = paged_multi_query_equals_steps(qs, kp, vp, bt, cs)
    log(f"  S=5 paged multi-query == 5 one-token paged calls, bit for bit: {one}")
    ms, plain = time_ms(pa, 50), time_ms(pr, 10)
    kview = kp[bt.long()].reshape(B, nw * ps, K, hd).transpose(1, 2)
    vview = vp[bt.long()].reshape(B, nw * ps, K, hd).transpose(1, 2)
    pos_q = cl[:, None].long() + torch.arange(S, device=dev)[None, :]
    pmask = (torch.arange(nw * ps, device=dev)[None, None, :]
             <= pos_q[:, :, None])[:, None]
    lf = lambda: F.scaled_dot_product_attention(                    # noqa: E731
        qst, kview, vview, attn_mask=pmask, enable_gqa=True)
    lib = time_ms(lf, 50)
    log_device("paged_spec_decode_attention", pa, lf)
    live = int((cl.long() + S).sum())
    pairs = int((pos_q + 1).sum())
    pages = sum(-(-(c + S) // ps) for c in cl.tolist())
    b_ms, b_by = bound("verify", B, S, H, K, hd, live, pairs, 2, pages)
    rows["paged_spec_decode_attention"] = dict(
        name="paged_spec_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/split_decode_attention.cu",
        replaces="src/repro/models/transformer.py:194 (XLA spec_attention over "
                 "paged_view; no Pallas kernel)",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib)
    return rows


def check_state(name, got, want, tol):
    """(C, n, m) against (C, n, m); the error of each part is printed."""
    errs = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)]
    log(f"  {name} state: max_abs_err C={errs[0]:.3e} n={errs[1]:.3e} "
        f"m={errs[2]:.3e} (tol {tol})")
    if not all(math.isfinite(e) and e <= tol for e in errs):
        raise AssertionError(f"{name}: state differs by {errs}")
    return max(errs)


def stateful_kernel_rows(dev):
    """rglru_scan and mlstm_chunk against their plain versions at the
    stateful phase's shapes: recurrentgemma-9b's largest prefill bucket
    (R = 4096, S = 4096, the chunked route) and its verify step ([4, 5,
    4096], the sequential route); xlstm-350m's largest prefill bucket
    (H = 4, hd = 512, chunk 256, state in) and an extend shorter than the
    chunk (S = 130, state in) on the tensor-core route, plus float32 shapes
    and a state-carry check on the CUDA-core route. Bounds as in the JAX
    package's tests (tests/test_kernels.py:101, 139): bf16 5e-2, float32
    5e-6 (scan) and 2e-5 (mLSTM; at xlstm's chunk of 256 against the plain
    version run in float64, whose distance to the float32 plain version is
    printed beside); the bf16 mLSTM against the plain version's float32
    result, as there. Each route is checked by its launch count; each row
    gains its profiler device time."""
    import torch
    from repro_torch.kernels import mlstm_chunk as kmc
    from repro_torch.kernels import rglru_scan as krs

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16

    def rnd(*shape, dtype=f32, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def routes(mod, want):
        got = dict(mod.launches_by_route)
        log(f"  launches_by_route={got}")
        if got != want:
            raise AssertionError(f"{mod.__name__}: routes {got}, expected {want}")

    rows = {}
    # ---- rglru_scan ---------------------------------------------------------
    log("[kernels] rglru_scan")
    for r in krs.launches_by_route:
        krs.launches_by_route[r] = 0
    B, S, R = 1, 4096, 4096
    # the JAX package's test inputs (tests/test_kernels.py:97): |h| stays
    # small enough that one bf16 rounding step is below the bound
    a, bx, h0 = torch.sigmoid(rnd(B, S, R)), rnd(B, S, R, scale=0.5), rnd(B, R)
    ka = lambda: krs.rglru_scan(a, bx, h0, out_dtype=bf16)           # noqa: E731
    kr = lambda: krs.rglru_scan_ref(a, bx, h0, out_dtype=bf16)       # noqa: E731
    (y, h), (yw, hw) = ka(), kr()
    err = check_close("bf16 out [1,4096,4096] with h0", y, yw, "bf16_state")
    err = max(err, check_close("  h_last (float32)", h, hw, "float32_scan"))
    (y, h), (yw, hw) = krs.rglru_scan(a, bx, h0), krs.rglru_scan_ref(a, bx, h0)
    err = max(err, check_close("f32 out [1,4096,4096] with h0", y, yw, "float32_scan"),
              check_close("  h_last", h, hw, "float32_scan"))
    del y, yw
    a2, bx2, h2 = torch.sigmoid(rnd(2, 150, 100)), rnd(2, 150, 100), rnd(2, 100)
    for hh in (None, h2):
        y2, hl2 = krs.rglru_scan(a2, bx2, hh)
        y2w, hl2w = krs.rglru_scan_ref(a2, bx2, hh)
        err = max(err, check_close(f"f32 [2,150,100] h0={hh is not None}", y2, y2w,
                                   "float32_scan"),
                  check_close("  h_last", hl2, hl2w, "float32_scan"))
    # the verify step: all states in float32, [4, spec_len + 1, R]
    av, bv, hv = torch.sigmoid(rnd(4, 5, R)), rnd(4, 5, R, scale=0.5), rnd(4, R)
    kv = lambda: krs.rglru_scan(av, bv, hv)                            # noqa: E731
    (y5, h5), (y5w, h5w) = kv(), krs.rglru_scan_ref(av, bv, hv)
    err = max(err, check_close("f32 verify [4,5,4096] with h0", y5, y5w, "float32_scan"),
              check_close("  h_last", h5, h5w, "float32_scan"))
    routes(krs, {"chunked": 4, "sequential": 1, "chunked_bwd": 0, "sequential_bwd": 0})
    ms, plain = time_ms(ka, 20), time_ms(kr, 2, warmup=1)
    by_kernel = device_ms_by_kernel(ka)
    log_kernels("rglru_scan [1,4096,4096]", by_kernel)
    dms = sum(by_kernel.values()) or None
    v_ms, v_dms = time_ms(kv, 50), device_ms(kv)
    v_bound, v_by = bound("rglru", 4, 5, R, 4, True)
    log(f"[kernels] rglru_scan verify [4,5,4096]: ms={v_ms:.4f} "
        f"device_ms={fmt_ms(v_dms)} bound_ms={v_bound:.4f} ({v_by}) (sequential route)")
    b_ms, b_by = bound("rglru", B, S, R, 2, True)
    rows["rglru_scan"] = dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:42",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, device_ms=dms)
    del a, bx, h0

    # ---- mlstm_chunk --------------------------------------------------------
    log("[kernels] mlstm_chunk")
    for r in kmc.launches_by_route:
        kmc.launches_by_route[r] = 0
    B, S, H, hd, L = 1, 2048, 4, 512, 256
    # scales of the JAX package's test (tests/test_kernels.py:130-134)
    q, k = (rnd(B, S, H, hd, dtype=bf16, scale=0.5) for _ in range(2))
    v = rnd(B, S, H, hd, dtype=bf16)
    ig, fg = rnd(B, S, H), rnd(B, S, H) + 2.0
    # a carried-in state: the one a first call leaves
    _, st0 = kmc.mlstm_chunk_ref(q[:, :300], k[:, :300], v[:, :300], ig[:, :300],
                                 fg[:, :300], chunk=L)
    ma = lambda: kmc.mlstm_chunk(q, k, v, ig, fg, st0, chunk=L)       # noqa: E731
    mr = lambda: kmc.mlstm_chunk_ref(q, k, v, ig, fg, st0, chunk=L)   # noqa: E731
    # the bf16 kernel against the plain version's float32 result (inputs
    # widened, h not rounded), as tests/test_kernels.py:139 holds the bf16
    # kernel to a float32 reference: two bf16 roundings of one value differ
    # by an ulp, 0.0625 at |h| >= 8, above the bound
    x32 = (q.float(), k.float(), v.float(), ig, fg)
    (hk, sk), (hr, sr) = ma(), kmc.mlstm_chunk_ref(*x32, st0, chunk=L)
    err = check_close("bf16 [1,2048,4,512] chunk 256, state in", hk, hr, "bf16_state")
    err = max(err, check_state("bf16 [1,2048,4,512]", sk, sr, TOL["bf16_state"]))
    # prefill (zero state) and an extend shorter than the chunk (L = S = 130)
    x6 = tuple(t[:, :600].contiguous() for t in (q, k, v, ig, fg))
    x6w = tuple(t[:, :600] for t in x32)
    (h6, s6), (h6w, s6w) = kmc.mlstm_chunk(*x6, chunk=L), kmc.mlstm_chunk_ref(*x6w, chunk=L)
    err = max(err, check_close("bf16 [1,600,4,512] chunk 256, zero state", h6, h6w,
                               "bf16_state"),
              check_state("bf16 [1,600,4,512]", s6, s6w, TOL["bf16_state"]))
    xe = tuple(t[:, 600:730].contiguous() for t in (q, k, v, ig, fg))
    xew = tuple(t[:, 600:730] for t in x32)
    (he, se), (hew, sew) = (kmc.mlstm_chunk(*xe, s6w, chunk=L),
                            kmc.mlstm_chunk_ref(*xew, s6w, chunk=L))
    err = max(err, check_close("bf16 extend [1,130,4,512], state in", he, hew, "bf16_state"),
              check_state("bf16 extend [1,130,4,512]", se, sew, TOL["bf16_state"]))
    q3, k3, v3 = (rnd(2, 300, 2, 64, scale=0.5) for _ in range(3))
    ig3, fg3 = rnd(2, 300, 2), rnd(2, 300, 2) + 2.0
    h3, s3 = kmc.mlstm_chunk(q3, k3, v3, ig3, fg3, chunk=64)
    h3w, s3w = kmc.mlstm_chunk_ref(q3, k3, v3, ig3, fg3, chunk=64)
    err = max(err, check_close("f32 [2,300,2,64] chunk 64", h3, h3w, "float32"),
              check_state("f32 [2,300,2,64]", s3, s3w, TOL["float32"]))
    # state carry: two calls (130 + 170 positions) equal one call
    ha, sa = kmc.mlstm_chunk(q3[:, :130].contiguous(), k3[:, :130].contiguous(),
                             v3[:, :130].contiguous(), ig3[:, :130], fg3[:, :130],
                             chunk=64)
    hb, sb = kmc.mlstm_chunk(q3[:, 130:].contiguous(), k3[:, 130:].contiguous(),
                             v3[:, 130:].contiguous(), ig3[:, 130:], fg3[:, 130:],
                             sa, chunk=64)
    err = max(err, check_close("f32 two calls (130 + 170) == one call",
                               torch.cat([ha, hb], 1), h3, "float32"),
              check_state("f32 two calls", sb, s3, TOL["float32"]))
    # float32 at xlstm's chunk of 256, state in, against the plain version in
    # float64; the float32 plain version's own distance to it is printed
    for shape in ((2, 300, 2, 128), (1, 300, 1, 512)):
        x = (rnd(*shape, scale=0.5), rnd(*shape, scale=0.5), rnd(*shape),
             rnd(*shape[:3]), rnd(*shape[:3]) + 2.0)
        _, st = kmc.mlstm_chunk_ref(*(t[:, :17] for t in x), chunk=L)
        hf, sf = kmc.mlstm_chunk(*x, st, chunk=L)
        h64, s64 = kmc.mlstm_chunk_ref(*(t.double() for t in x),
                                       tuple(t.double() for t in st), chunk=L)
        hp, sp = kmc.mlstm_chunk_ref(*x, st, chunk=L)
        name = f"f32 {list(shape)} chunk 256, state in, vs float64"
        log(f"  {name}: float32 plain version vs float64 "
            f"h={float((hp.double() - h64).abs().max()):.3e} "
            f"C={float((sp[0].double() - s64[0]).abs().max()):.3e} |h|max="
            f"{float(h64.abs().max()):.2f}")
        err = max(err, check_close(name, hf.double(), h64, "float32"),
                  check_state(name, tuple(t.double() for t in sf), s64, TOL["float32"]))
    routes(kmc, {"wgmma": 3, "simt_f32": 5, "wgmma_bwd": 0, "simt_f32_bwd": 0})
    ms, plain = time_ms(ma, 20, warmup=2), time_ms(mr, 3, warmup=1)
    by_kernel = device_ms_by_kernel(ma)
    log_kernels("mlstm_chunk [1,2048,4,512]", by_kernel)
    dms = sum(by_kernel.values()) or None
    # causal q·kᵀ and w·v in bf16; q·C and the state update take a float32
    # operand, so TF32 (495 TFLOP/s) is their fastest rate
    b_ms, b_by = bound("mlstm", B, S, H, hd, L, 2, True)
    rows["mlstm_chunk"] = dict(
        name="mlstm_chunk", route="cuda",
        source="src/repro_torch/kernels/csrc/mlstm_chunk_wgmma.cu",
        replaces="src/repro/kernels/mlstm_chunk.py:77",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, device_ms=dms)
    return rows


def slstm_kernel_rows(dev):
    """The sLSTM scan's forward and gradient kernels against their plain
    versions (the loop over time; autograd through it), float32 within
    ``TOL["slstm_f32"]`` (gradients ``TOL["float32_grad"]``) and bf16
    within ``TOL["bfloat16"]`` of max(1, the largest value), at xlstm-350m's
    widths (4 heads of 256): its train microbatch [4, 1024], a 1500-token
    admission in the 2048 bucket (right padding), decode (S = 1, a state
    in), verify (S = 5, a state in, masked, every state kept) and an extend
    (S = 130, a state in, masked); two calls give the same bits. Rows
    ``slstm_scan`` (the forward at the train microbatch; the admission's
    numbers beside) and ``slstm_scan_bwd`` (the gradient kernel at the
    train microbatch on the forward's kept gates and states): call ms,
    device ms (torch.profiler), the bound, the serial floor (the device ms
    of the same S steps at the least work, [1, S] and one head of 16),
    plain ms; no library call computes the recurrence."""
    import torch
    from repro_torch.kernels import slstm_scan as kss

    g = torch.Generator(device=dev)
    g.manual_seed(4)
    f32, bf16 = torch.float32, torch.bfloat16
    H, hd = 4, 256
    D = H * hd

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def inputs(B, S, dtype, state=False, valid=None, heads=H, width=hd):
        # xlstm-350m's scales under its init: R fan-in scaled over the three
        # stacked sLSTM layers, gates_x ~0.3 (an RMS-normed x through the
        # scaled w_gates); at larger ones the recurrence amplifies each
        # rounding over 1000 steps and the bf16 plain loop drifts far from
        # its own float64 result
        gx = rnd(B, S, 4, heads * width, scale=0.3).to(dtype)
        R = rnd(heads, 4, width, width, scale=(12 * heads * width) ** -0.5).to(dtype)
        st = None if not state else (rnd(B, heads * width), rnd(B, heads * width).abs() + 0.5,
                                     rnd(B, heads * width, scale=0.5), rnd(B, heads * width))
        mask = None if valid is None else (
            torch.arange(S, device=dev)[None, :] < torch.tensor(valid, device=dev)[:, None])
        return gx, R, st, mask

    def close(name, got, want, tol):
        err = float((got.double() - want.double()).abs().max()) / max(
            1.0, float(want.double().abs().max()))
        log(f"  {name}: scaled_err={err:.3e} (tol {tol})")
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"slstm_scan: {name} differs by {err} > {tol}")
        return err

    log("[kernels] slstm_scan")
    for r in kss.launches_by_route:
        kss.launches_by_route[r] = 0
    cases = [("train microbatch [4,1024]", 4, 1024, False, None, False),
             ("admission 1500 of 2048 [1,2048], padded", 1, 2048, False, [1500], False),
             ("decode [4,1], state", 4, 1, True, None, False),
             ("verify [4,5], state, masked, all states", 4, 5, True, [5, 3, 1, 4], True),
             ("extend [2,130], state, masked", 2, 130, True, [130, 77], False)]
    err = 0.0
    for dtype in (f32, bf16):
        tol = TOL["slstm_f32" if dtype == f32 else "bfloat16"]
        for name, B, S, state, valid, every in cases:
            gx, R, st, mask = inputs(B, S, dtype, state, valid)
            (y, s), (y2, s2) = (kss.slstm_scan(gx, R, st, mask, every) for _ in range(2))
            yw, sw = kss.slstm_scan_ref(gx, R, st, mask, every)
            label = f"{'f32' if dtype == f32 else 'bf16'} {name}"
            err = max(err, close(f"{label}: y", y, yw, tol),
                      *(close(f"{label}: {k}", a, b, tol) for k, a, b in zip("cnhm", s, sw)))
            if not (torch.equal(y, y2) and all(torch.equal(a, b) for a, b in zip(s, s2))):
                raise AssertionError(f"slstm_scan: two calls differ ({label})")

    def grads(fn, gx, R, st, mask, dy, dlast, dtype=None):
        ins = [t.clone().to(dtype or t.dtype).requires_grad_()
               for t in (gx, R) + tuple(st or ())]
        y, last = fn(ins[0], ins[1], ins[2:] or None, mask)
        return torch.autograd.grad([y, *last], ins, [dy.to(y.dtype), *dlast])

    # the bf16 kernel's gradient against the plain loop run in float32 on
    # the same values: autograd through the bf16 loop adds each step's bf16
    # dR in bf16 (its distance to the float32 one is printed), the kernel
    # path forms dR in one product with float32 sums
    bwd_err = 0.0
    for dtype, B, S, state, valid in ((f32, 2, 300, True, [300, 200]),
                                      (bf16, 4, 1024, False, None)):
        gx, R, st, mask = inputs(B, S, dtype, state, valid)
        dy, dlast = rnd(B, S, D).to(dtype), [rnd(B, D) for _ in range(4)]
        got = grads(kss.slstm_scan, gx, R, st, mask, dy, dlast)
        want = grads(kss.slstm_scan_ref, gx, R, st, mask, dy, dlast, f32)
        tol = TOL["float32_grad" if dtype == f32 else "bfloat16"]
        label = f"{'f32' if dtype == f32 else 'bf16'} gradient [{B},{S}]"
        for name, a, b in zip(("gates_x", "r_gates", "c0", "n0", "h0", "m0"), got, want):
            bwd_err = max(bwd_err, close(f"{label}: d{name}", a, b, tol))
        if dtype == bf16:
            plain = grads(kss.slstm_scan_ref, gx, R, st, mask, dy, dlast)
            for name, a, b in zip(("gates_x", "r_gates"), plain, want):
                e = float((a.double() - b.double()).abs().max()) / max(
                    1.0, float(b.double().abs().max()))
                log(f"  (bf16 plain loop's autograd against float32: d{name} {e:.3e})")
    routes = dict(kss.launches_by_route)
    log(f"  launches_by_route={routes}")
    if routes != {"cluster": 4 * len(cases) + 2, "cluster_bwd": 2}:
        raise AssertionError(f"slstm_scan: routes {routes}")

    # times: bf16 at the train microbatch and the admission
    B, S = 4, 1024
    gx, R, _, _ = inputs(B, S, bf16)
    fwd = lambda: kss.slstm_scan(gx, R)                             # noqa: E731
    ms, dms = time_ms(fwd, 10), device_ms(fwd, 5)
    plain = time_ms(lambda: kss.slstm_scan_ref(gx, R), 1, warmup=1)
    keep_ms = time_ms(lambda: kss._forward(gx, R, keep_gates=True), 10)

    def floor(S, backward=False):
        """The device ms of S steps at the least work: [1, S], one head of
        16 (the cluster barrier and the exchange a step)."""
        gs, Rs, _, _ = inputs(1, S, bf16, heads=1, width=16)
        if not backward:
            return device_ms(lambda: kss.slstm_scan(gs, Rs), 5)
        _, (c, n, _, m), gk = kss._forward(gs, Rs, keep_gates=True)
        dys = rnd(1, S, 16).to(bf16)
        return device_ms(lambda: kss.slstm_scan_bwd(gk, Rs, c, n, m, None, None, dys), 5)

    serial = floor(S)
    b_ms, b_by = bound("slstm", B, S, H, hd, 2, False, False)
    log(f"[kernels] slstm_scan train microbatch [4,1024,4x256] bf16: ms={ms:.4f} "
        f"device_ms={fmt_ms(dms)} (keeping the gates and states for the gradient: "
        f"{keep_ms:.4f} ms) bound_ms={b_ms:.4f} ({b_by}) serial_floor_ms={fmt_ms(serial)} "
        f"plain_ms={plain:.4f} library: none")
    ga, Ra, _, ma = inputs(1, 2048, bf16, valid=[1500])
    adm = lambda: kss.slstm_scan(ga, Ra, None, ma)                  # noqa: E731
    a_ms, a_dms = time_ms(adm, 10), device_ms(adm, 5)
    a_plain = time_ms(lambda: kss.slstm_scan_ref(ga, Ra, None, ma), 1, warmup=1)
    a_bound, a_by = bound("slstm", 1, 2048, H, hd, 2, False, False)
    a_serial = floor(2048)
    log(f"[kernels] slstm_scan admission [1,2048,4x256] bf16 (1500 valid): ms={a_ms:.4f} "
        f"device_ms={fmt_ms(a_dms)} bound_ms={a_bound:.4f} ({a_by}) serial_floor_ms="
        f"{fmt_ms(a_serial)} plain_ms={a_plain:.4f} library: none")
    _, (c, n, _, m), gk = kss._forward(gx, R, keep_gates=True)
    dy = rnd(B, S, D).to(bf16)
    bwd = lambda: kss.slstm_scan_bwd(gk, R, c, n, m, None, None, dy)  # noqa: E731
    if not all(torch.equal(a, b) for a, b in zip(bwd()[:1], bwd()[:1])):
        raise AssertionError("slstm_scan_bwd: two calls differ")
    bms, bdms = time_ms(bwd, 10), device_ms(bwd, 5)
    b_plain = time_ms(lambda: kss.slstm_scan_bwd_ref(gk, R, c, n, m, None, None, dy), 1,
                      warmup=1)

    def autograd_loop():
        ins = [gx.clone().requires_grad_(), R.clone().requires_grad_()]
        y, _ = kss.slstm_scan_ref(*ins)
        torch.autograd.grad(y, ins, dy)

    b_autograd = time_ms(autograd_loop, 1, warmup=0)
    bb_ms, bb_by = bound("slstm_bwd", B, S, H, hd, 2)
    b_serial = floor(S, backward=True)
    log(f"[kernels] slstm_scan_bwd train microbatch [4,1024,4x256] bf16: ms={bms:.4f} "
        f"device_ms={fmt_ms(bdms)} bound_ms={bb_ms:.4f} ({bb_by}) serial_floor_ms="
        f"{fmt_ms(b_serial)} plain_ms={b_plain:.4f} (written out) plain autograd "
        f"(forward + backward through the loop) {b_autograd:.4f} ms; library: none")
    src = "src/repro_torch/kernels/csrc/slstm_scan.cu"
    return {
        "slstm_scan": dict(
            name="slstm_scan", route="cuda", source=src,
            replaces="src/repro/models/xlstm.py:258", max_abs_err=err, ms=ms,
            plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None, device_ms=dms,
            serial_floor_ms=serial, keep_ms=keep_ms,
            admission=dict(ms=a_ms, device_ms=a_dms, bound_ms=a_bound, bound_by=a_by,
                           serial_floor_ms=a_serial, plain_ms=a_plain)),
        "slstm_scan_bwd": dict(
            name="slstm_scan_bwd", route="cuda", source=src,
            replaces="src/repro/models/xlstm.py:258", max_abs_err=bwd_err, ms=bms,
            plain_ms=b_plain, bound_ms=bb_ms, bound_by=bb_by, library_ms=None,
            device_ms=bdms, serial_floor_ms=b_serial, plain_autograd_ms=b_autograd),
    }


def multi_query_equals_steps(qs, kc, vc, clen):
    """The multi-query kernels cut slots at the same absolute split
    boundaries as the one-token call, so query s equals a one-token call at
    cache length clen + s bit for bit."""
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


def paged_multi_query_equals_steps(qs, kp, vp, bt, clen):
    """The paged multi-query kernels cut positions at the same absolute split
    boundaries as the one-token call, so query s equals a one-token call at
    cache length clen + s bit for bit."""
    import torch
    from repro_torch.kernels import paged_decode_attention as kpda
    from repro_torch.kernels import paged_spec_decode_attention as kpsda
    G = qs.shape[2] // kp.shape[2]
    got = kpsda.paged_spec_decode_attention(qs, kp, vp, bt, clen, q_per_kv=G)
    steps = torch.cat([kpda.paged_decode_attention(qs[:, s:s + 1].contiguous(), kp, vp,
                                                   bt, clen + s, q_per_kv=G)
                       for s in range(qs.shape[1])], dim=1)
    again = kpsda.paged_spec_decode_attention(qs, kp, vp, bt, clen, q_per_kv=G)
    if not torch.equal(got, steps):
        raise AssertionError("paged multi-query decode differs from one-token steps")
    if not torch.equal(got, again):
        raise AssertionError("paged multi-query decode differs between two calls")
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
                                     mlstm_chunk, paged_decode_attention,
                                     paged_spec_decode_attention, rglru_scan,
                                     slstm_scan, spec_decode_attention, spec_scan,
                                     split_decode)
    return {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "paged_decode_attention": paged_decode_attention,
            "accept_len": spec_scan, "spec_decode_attention": spec_decode_attention,
            "paged_spec_decode_attention": paged_spec_decode_attention,
            "rglru_scan": rglru_scan, "mlstm_chunk": mlstm_chunk,
            "slstm_scan": slstm_scan,
            # the sequence-parallel decode's two launches (partials, combine)
            "seqpar_decode_attention": split_decode}


ROUTED = ("flash_attention", "mlstm_chunk", "rglru_scan", "slstm_scan")  # with routes


def kernel_counts():
    """Launches by kernel, and by route as ``<kernel>/<route>`` for the
    kernels with more than one (flash and mlstm_chunk by dtype, rglru_scan
    by S, slstm_scan by direction)."""
    mods = kernel_modules()
    counts = {name: m.launches for name, m in mods.items()}
    for name in ROUTED:
        counts.update({f"{name}/{r}": n for r, n in mods[name].launches_by_route.items()})
    return counts


def reset_counts():
    from repro_torch.kernels import launch_counts
    launch_counts.reset()


def check_bf16_routes(name, counts):
    """A bf16 serving phase runs flash and mlstm_chunk on their tensor-core
    routes only."""
    for kern in ("flash_attention", "mlstm_chunk"):
        wg, simt = counts[f"{kern}/wgmma"], counts[f"{kern}/simt_f32"]
        if simt != 0 or wg != counts[kern]:
            raise AssertionError(f"{name}: {kern} routes wgmma={wg} simt_f32={simt} "
                                 f"of {counts[kern]} launches")


def count_run_on():
    """From here on every decode chunk adds, on the device and with no host
    sync, the steps it ran after every row's last emit to its programs'
    ``_run_on`` (the step buffer minus the last ``emit_buf`` row with an
    emit): the work the reference's while loop does not do. Works on any
    tree whose chunk keeps a device step index (``tools/run_on.py``)."""
    import torch
    from repro_torch.serving.programs import EnginePrograms
    fn = EnginePrograms._decode_chunk_fn
    if getattr(fn, "counts_run_on", False):
        return

    def counted(self, *a, **kw):
        out = fn(self, *a, **kw)
        emit, step = out[2], self._bufs["decode"]["step"]
        rows = torch.arange(1, emit.shape[0] + 1, device=emit.device)
        last = (emit.any(dim=1) * rows).amax()
        if getattr(self, "_run_on", None) is None:
            self._run_on = torch.zeros((), dtype=torch.int64, device=emit.device)
        self._run_on += step[0] - last
        return out

    counted.counts_run_on = True
    EnginePrograms._decode_chunk_fn = counted


def run_on_steps(server) -> int:
    t = getattr(server.engine.progs, "_run_on", None)
    return 0 if t is None else int(t)


def pick_eos(outputs) -> int:
    """A token that many of ``outputs`` (id lists) emit after their first
    token, at different steps: the most rows, then the earliest mean step."""
    first = collections.defaultdict(list)
    for ids in outputs:
        seen = {}
        for i, t in enumerate(ids[1:], 1):
            seen.setdefault(int(t), i)
        for t, i in seen.items():
            first[t].append(i)
    return min(first, key=lambda t: (-len(first[t]), sum(first[t]) / len(first[t])))


def eos_stops(dev, mode: str, eager: bool = False) -> dict:
    """Reduced float32 qwen2.5-3b (vocab 512, random weights from seed 3),
    6 requests of 24 tokens on 3 slots, decode_chunk 8, with the EOS id set
    to a token the requests emit at different steps (``pick_eos`` over a
    first run), so rows stop at EOS mid-chunk: ids, decode steps and
    chunks, and the steps run after every row's last emit."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import Model
    from repro_torch.serving.server import EngineConfig, LLMServer, SamplingParams
    count_run_on()
    cfg = ARCHS["qwen2.5-3b"].reduced(dtype="float32", param_dtype="float32",
                                      vocab_size=512)
    sd = Model(cfg, device="cpu").init(seed=4).state_dict()
    prompts = [f"request {i}: " + "tool output line. " * (i + 1) for i in range(6)]
    eos = None
    for _ in range(2):
        srv = LLMServer(cfg, num_slots=3, capacity=256, device=dev,
                        params={k: v.to(dev) for k, v in sd.items()},
                        engine_cfg=EngineConfig(cache_mode=mode, page_size=16,
                                                decode_chunk=8))
        progs = srv.engine.progs
        if eos is not None:
            srv.engine.tokenizer.eos_id = progs.eos_id = eos
        with (progs.eager() if eager else contextlib.nullcontext()):
            hs = [srv.submit(p, SamplingParams(max_new_tokens=24)) for p in prompts]
            srv.run_until_idle()
        eos = pick_eos([h.request.output_ids for h in hs])
    return {"ids": [h.request.output_ids for h in hs],
            "decode_steps": progs.decode_steps,
            "decode_chunks": srv.stats()["decode_chunks"],
            "run_on": run_on_steps(srv)}


def eos_stop_check(dev):
    """The decode chunk stops once every row is done: on the while graph and
    on the eager steps the run-on is 0, with equal ids and steps."""
    for mode in ("dense", "paged"):
        got = {how: eos_stops(dev, mode, eager=how == "eager")
               for how in ("graph", "eager")}
        g, e = got["graph"], got["eager"]
        log(f"[eos-{mode}] rows stopping at EOS: output tokens "
            f"{[len(x) for x in g['ids']]}; decode steps graph {g['decode_steps']} "
            f"eager {e['decode_steps']}, chunks {g['decode_chunks']}; run-on "
            f"steps graph {g['run_on']} eager {e['run_on']}")
        if g["ids"] != e["ids"] or g["decode_steps"] != e["decode_steps"]:
            raise AssertionError(f"eos-{mode}: while graph differs from eager")
        if g["run_on"] or e["run_on"]:
            raise AssertionError(f"eos-{mode}: decode steps ran after every row's "
                                 "last emit")


def graph_counts(server) -> dict:
    """The decode and verify steps a server's programs ran, and their CUDA
    graph captures and replays."""
    p = server.engine.progs
    return {"decode_steps": p.decode_steps, "verify_steps": p.verify_steps,
            "run_on": run_on_steps(server),
            **{f"{prog}_{what}": n.get(prog, 0) for prog in ("decode", "verify")
               for what, n in (("captures", p.graph_captures),
                               ("replays", p.graph_replays))}}


GRAPH_VARIANTS = 3      # greedy, sampled, top-k: one graph each per program


def check_graphs(name, server, before):
    """Every decode and verify step since ``before`` ran on the graph path:
    as a replay, or as the warm-up step of a capture; a server captures
    each program at most once per variant. Logs the phase's counts."""
    now = graph_counts(server)
    d = {k: now[k] - before[k] for k in now}
    log(f"[{name}] graphs: decode steps={d['decode_steps']} captures="
        f"{d['decode_captures']} replays={d['decode_replays']}; verify steps="
        f"{d['verify_steps']} captures={d['verify_captures']} replays="
        f"{d['verify_replays']} (server captures: decode {now['decode_captures']}, "
        f"verify {now['verify_captures']}); run-on steps={d['run_on']}")
    if d["run_on"]:
        raise AssertionError(f"{name}: {d['run_on']} decode steps ran after every "
                             "row's last emit")
    for prog in ("decode", "verify"):
        if d[f"{prog}_captures"] + d[f"{prog}_replays"] != d[f"{prog}_steps"]:
            raise AssertionError(f"{name}: {prog} steps not all on graphs: {d}")
        if now[f"{prog}_captures"] > GRAPH_VARIANTS:
            raise AssertionError(f"{name}: {now[f'{prog}_captures']} {prog} captures")


def graph_matches_eager(name, cfg, params, dev, prompts, capacity, **ecfg):
    """Greedy ids over two decode chunks of ``prompts`` (4 requests): a fresh
    server on the graph path against a fresh one on the eager steps
    (``progs.eager()``), on the same weights. Any difference in the ids or in
    the kernels' launch counts fails."""
    import torch
    from repro_torch.serving.server import EngineConfig, LLMServer, SamplingParams
    ids, counts = {}, {}
    for how in ("graph", "eager"):
        srv = LLMServer(cfg, num_slots=4, capacity=capacity, params=params,
                        device=dev, engine_cfg=EngineConfig(**ecfg))
        n = 1 + 2 * srv.engine.engine_cfg.decode_chunk
        torch.cuda.synchronize()
        reset_counts()
        with (srv.engine.progs.eager() if how == "eager" else contextlib.nullcontext()):
            hs = [srv.submit(p, SamplingParams(max_new_tokens=n)) for p in prompts]
            srv.run_until_idle()
        torch.cuda.synchronize()
        counts[how] = kernel_counts()
        ids[how] = [h.request.output_ids for h in hs]
        if how == "graph":
            check_graphs(f"{name}-graph-vs-eager", srv, dict.fromkeys(graph_counts(srv), 0))
        del hs, srv
        torch.cuda.empty_cache()
    same = ids["graph"] == ids["eager"]
    log(f"[{name}] graph == eager: greedy ids over two chunks of {len(prompts)} "
        f"requests {same} (output tokens {[len(x) for x in ids['graph']]}), "
        f"launches {counts['graph'] == counts['eager']}")
    if not same:
        raise AssertionError(f"{name}: graph ids differ from the eager steps'")
    if counts["graph"] != counts["eager"]:
        raise AssertionError(f"{name}: launches graph {counts['graph']} != eager "
                             f"{counts['eager']}")


def serve_phase(name, server, prompts, sampled_idx, session_turns, warm=None):
    """Submit ``prompts`` concurrently (+ a 2-turn session), drain, check."""
    import torch
    from repro_torch.serving.server import SamplingParams
    if warm is not None:
        server.submit(warm, SamplingParams(max_new_tokens=4)).result()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = server.stats()
    gbefore = graph_counts(server)
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
    check_bf16_routes(name, counts)
    check_graphs(name, server, gbefore)
    st = server.stats()
    not_completed(name, handles)
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


WALL_REPS = 5       # unprofiled runs behind a profile's wall time (median)


def device_summary(prof, what: str, wall_ms: float, top: int):
    """Kernel rows of a torch.profiler run (operator rows would count the
    same device time twice), by device time: logs the busy time, the
    device's idle share of ``wall_ms`` and the ``top`` kernels, and returns
    the busy ms, or None where the profiler recorded no device time."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        log("[profile] torch.profiler recorded no device time: not measured")
        return None
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"[profile] {what}: unprofiled median wall_ms={wall_ms:.2f}, "
        f"device_busy_ms={busy:.2f}, device_idle_share={1 - busy / wall_ms:.3f}")
    for name, ms, n in rows[:top]:
        log(f"[profile]   {ms:9.3f} ms  {n:6d} calls  {name[:90]}")
    return busy


def step_paths(server):
    """(label, context) of each path a profile runs: the server's own (on
    this port, replayed CUDA graphs), then, where the port has them, its
    eager steps (``progs.eager()``). A tree without graphs has one path,
    its eager loop."""
    progs = server.engine.progs
    if not hasattr(progs, "eager"):
        return [("eager loop", contextlib.nullcontext)]
    return [("graph", contextlib.nullcontext), ("eager", progs.eager)]


def profile_decode_chunk(server, prompts, eager=True):
    """Where one decode chunk's time goes (the prompts' slots live), for
    each of ``step_paths`` (the first only without ``eager``): the median
    wall time of ``WALL_REPS``
    unprofiled chunks, then the next chunk under torch.profiler: device
    time by kernel, the device's idle share. Runs after the launch counts
    were read. Returns the first path's {"wall_ms": [...],
    "device_busy_ms", "live_slots"}, with the eager path's under "eager"
    (None on a tree without graphs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.server import SamplingParams
    ecfg = server.engine.engine_cfg
    paths = step_paths(server)[:None if eager else 1]
    handles = [server.submit(p, SamplingParams(
        max_new_tokens=ecfg.decode_chunk * (len(paths) * (WALL_REPS + 1) + 2)))
        for p in prompts]
    server.step()                                  # admission + first chunk
    torch.cuda.synchronize()
    out = {}
    for label, ctx in paths:
        walls = []
        with ctx():
            for _ in range(WALL_REPS):             # decode chunks, unprofiled
                t0 = time.perf_counter()
                server.step()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                server.step()                      # the next chunk, profiled
                torch.cuda.synchronize()
        live = sum(1 for s in server.engine.slots if s.request is not None)
        busy = device_summary(
            prof, f"{server.engine.cfg.name}: one {ecfg.cache_mode} decode chunk "
            f"({ecfg.decode_chunk} steps, {live} slots, {label})",
            statistics.median(walls), 10)
        out[label] = {"wall_ms": walls, "device_busy_ms": busy, "live_slots": live}
    server.run_until_idle()
    not_completed("profiled chunk", handles)
    return dict(out[paths[0][0]], eager=out.get("eager"))


def profile_verify_step(server, prompts):
    """Where one verify step's time goes (the prompts' slots live, drafting),
    for each of ``step_paths``: the median wall time of ``WALL_REPS`` spec
    passes that verified (the engine's drafting on the host, one verify
    step, its one pull and the commits; a pass that drafted nothing is
    followed by an engine step and not counted), then one more under
    torch.profiler: device time by kernel, the device's idle share.
    Returns the first path's {"wall_ms": [...], "device_busy_ms"}, with the
    eager path's under "eager"."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.server import SamplingParams
    eng = server.engine
    handles = [server.submit(p, SamplingParams(max_new_tokens=256)) for p in prompts]
    eng._admit()
    out = {}
    for label, ctx in step_paths(server):
        walls, prof = [], None
        with ctx():
            for _ in range(20 * WALL_REPS):
                active = eng._active()
                if not active or prof is not None:
                    break
                n0 = eng._verify_steps
                p = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                     if len(walls) == WALL_REPS else None)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with (p if p is not None else contextlib.nullcontext()):
                    eng._spec_pass(active)
                    torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                if eng._verify_steps == n0:
                    server.step()                  # nothing drafted: decode on
                elif p is None:
                    walls.append(wall)
                else:
                    prof = p
        if prof is None:
            raise AssertionError(f"verify profile ({label}): {len(walls)} verify "
                                 "steps, the slots stopped drafting")
        busy = device_summary(
            prof, f"{eng.cfg.name}: one verify step, spec_len "
            f"{eng.engine_cfg.spec_len}, {eng.engine_cfg.cache_mode} ({label})",
            statistics.median(walls), 10)
        out[label] = {"wall_ms": walls, "device_busy_ms": busy}
    server.run_until_idle()
    not_completed("profiled verify", handles)
    first = next(iter(out))
    return dict(out[first], eager=out.get("eager"))


def profile_prefill(server, prompt, *, reps: int = WALL_REPS, host_trace: bool = True):
    """Where one prefill's time goes: a request admitted alone, the
    engine's admission step only (prefill, first sample and its host sync:
    the TTFT path, without the decode chunk that follows): the median wall
    time of ``reps`` unprofiled admissions after a warm-up, then one under
    torch.profiler (host operators too unless ``host_trace`` is False):
    device busy time, the device's
    idle share, the top kernels. Returns {"wall_ms": [...],
    "device_busy_ms", "prompt_tokens", "kernel_ms": {kernel: device ms}}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.server import SamplingParams

    def admit(prof=None):
        h = server.submit(prompt, SamplingParams(max_new_tokens=1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if prof is None:
            server.engine._admit()
        else:
            with prof:
                server.engine._admit()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        server.run_until_idle()
        not_completed("prefill profile", [h])
        return wall, h.request.prompt_tokens

    admit()                                         # warm
    walls = [admit()[0] for _ in range(reps)]
    acts = [ProfilerActivity.CPU] if host_trace else []
    prof = profile(activities=acts + [ProfilerActivity.CUDA])
    _, n = admit(prof)
    busy = device_summary(
        prof, f"{server.engine.cfg.name}: admission of one {n}-token prompt alone "
        "(prefill + first token)", statistics.median(walls), 8)
    kernels = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    return {"wall_ms": walls, "device_busy_ms": busy, "prompt_tokens": n,
            "kernel_ms": kernels}


def teacher_forced(model, params, ids, n_prompt, *, paged: bool, dev):
    """Logits of every continuation step: prefill ids[:n_prompt], then feed
    ids[n_prompt:] one token at a time (dense cache, or a page pool)."""
    import torch
    from repro_torch.serving import kvpool
    from repro_torch.serving.programs import model_inputs
    cap, ps = 2048, 16
    out = []
    tok = torch.tensor([ids[:n_prompt]], device=dev)
    batch = model_inputs(model.cfg, tok, torch.arange(n_prompt, device=dev)[None])
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
        b = model_inputs(model.cfg, torch.tensor([[x]], device=dev),
                         torch.tensor([[pos]], device=dev))
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
    profile_prefill(dense, prompts[3])
    del dense
    torch.cuda.empty_cache()
    graph_matches_eager("dense", cfg, params, dev, prompts, 2048, cache_mode="dense")

    # ---- phase 4: paged (the FAME harness's engine setting) --------------
    paged, pprompts, pcounts = prefix_run("paged", cfg, params, dev, tok, rng, 2048)
    if pcounts["flash_attention"] <= 0 or pcounts["paged_decode_attention"] <= 0:
        raise AssertionError(f"paged: kernels not launched: {pcounts}")
    profile_decode_chunk(paged, pprompts)
    del paged
    torch.cuda.empty_cache()
    graph_matches_eager("paged", cfg, params, dev, pprompts, 2048,
                        cache_mode="paged", page_size=16, decode_chunk=8)

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
    eos_stop_check(dev)
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
    not_completed("serve", hs)
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
        gbefore = graph_counts(srv)
        eng = srv.engine
        rows0 = eng._verify_rows
        reset_counts()
        t0 = time.perf_counter()
        hs = serve_ids(srv, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        check_bf16_routes(f"spec-{mode}", counts)
        check_graphs(f"spec-{mode}", srv, gbefore)
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
        profile_verify_step(srv, prompts)
        del hs, srv
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
    gbefore = graph_counts(base)
    t0 = time.perf_counter()
    hs = serve_ids(base, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_graphs("spec-base-dense", base, gbefore)
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
        check_graphs(f"spec-f32-4-layers-{mode}-{sl}", srv,
                     dict.fromkeys(graph_counts(srv), 0))
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
# phase 8: the stateful archs (recurrentgemma-9b, xlstm-350m)
# ---------------------------------------------------------------------------

# per arch: capacity, prompt lengths of the dense run (recurrentgemma's
# longest wraps its 2048-position local-attention ring), the snapshot
# arena's rows and stride (set explicitly: the default arena,
# 1 + slots * (capacity / 16 + 2) rows, would hold ~46 GB of xlstm state),
# the kernels its path must launch, the float32 checks' config (one pattern
# period) and the prefill before their decode-vs-forward steps (past
# recurrentgemma's 2048-position ring)
STATEFUL = {
    "recurrentgemma-9b": dict(capacity=4096, prompts=(200, 800, 1500, 3000),
                              num_snapshots=48, snap_stride=8,
                              f32=dict(num_layers=5), f32_prefill=2100,
                              kernels=("rglru_scan", "flash_attention",
                                       "decode_attention", "accept_len")),
    "xlstm-350m": dict(capacity=2048, prompts=(200, 600, 1000, 1500),
                       num_snapshots=16, snap_stride=8,
                       f32=dict(num_layers=8), f32_prefill=300,
                       kernels=("mlstm_chunk", "slstm_scan", "accept_len")),
}


def gb(n: float) -> str:
    return f"{n / 1e9:.3f}"


def memory_report(name, cfg, params, spec):
    """Parameters (the MoE layers' share), slot cache (4 slots), snapshot
    arena and verify staging bytes."""
    from repro_torch.models import transformer as tfm
    p_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    moe = sum(p.numel() * p.element_size() for n, p in params.named_parameters()
              if ".moe." in n)
    row = tfm.cache_bytes(cfg, 1, spec["capacity"])
    arena = (f" arena_GB({spec['num_snapshots']} rows)="
             f"{gb(spec['num_snapshots'] * row)}" if "num_snapshots" in spec else "")
    log(f"[{name}] memory: params_GB={gb(p_bytes)}"
        f"{f' (MoE {gb(moe)})' if moe else ''} state_row_MB={row / 1e6:.2f} "
        f"slot_cache_GB(4 slots)={gb(4 * row)}{arena} verify_staging_GB(B=4,S=5)="
        f"{gb(verify_staging_bytes(cfg, 4, 5))}")


def verify_staging_bytes(cfg, B, S):
    """What a verify step stages per layer for the commit (float32 states
    after every draft position), summed over the layers."""
    from repro_torch.configs import base as cfgbase
    total = 0
    F2 = int(cfg.mlstm_proj_factor * cfg.d_model)
    for kind in cfg.layer_kinds:
        if kind == cfgbase.MLSTM:
            hd = F2 // cfg.num_heads
            total += 4 * B * S * cfg.num_heads * (hd * hd + hd + 1)
        elif kind == cfgbase.SLSTM:
            total += 4 * 4 * B * S * cfg.d_model
        elif kind == cfgbase.RECURRENT:
            total += 4 * B * S * (cfg.rglru_dim or cfg.d_model)
    return total


def logits_decode_vs_forward(model, params, ids, n, dev):
    """Decode-step logits after a prefill of ids[:n] against one full
    forward over the same tokens; (max abs difference, |logit| max)."""
    import torch
    from repro_torch.models import transformer as tfm
    cache = model.init_cache(1, len(ids) + 16)
    lg, _ = model.prefill(params, model.make_batch(torch.tensor([ids[:n]], device=dev)),
                          cache, length=n, with_logits="last")
    steps = [lg[:, 0]]
    for i, x in enumerate(ids[n:-1]):
        b = {"tokens": torch.tensor([[x]], device=dev),
             "positions": torch.tensor([[n + i]], device=dev)}
        li, _ = model.decode_step(params, b, cache,
                                  torch.tensor([n + i], dtype=torch.int32, device=dev))
        steps.append(li[:, 0])
    got = torch.cat(steps)
    full, _, _ = tfm.forward_logits(params, model.make_batch(
        torch.tensor([ids[:-1]], device=dev)), model.cfg, mode="train")
    want = full[0, n - 1:]
    return float((got - want).abs().max()), float(want.abs().max())


def self_quotes(tok, rng, prompt_ids, out):
    """Two requests that quote a greedy continuation ``out`` of
    ``prompt_ids`` back to the model, so that its drafts do not hang on a
    random model copying text: the prompt and continuation repeated, and
    the continuation's second half placed ~64 tokens before the prompt
    and its first half (these models' gates forget within tens of tokens,
    so the greedy next token stays out[12], which the drafter finds)."""
    filler = tok.encode(make_text(tok, rng, 64))
    return [prompt_ids + out + prompt_ids + out[:12],
            out[12:] + filler + prompt_ids + out[:12]]


def stateful_f32_checks(name, spec, dev, tok, rng):
    """Full width, float32, the depth (and for MoE the capacity factor) of
    ``spec["f32"]``: snapshot == dense and spec == non-spec greedy token for
    token; decode-step logits after a ``spec["f32_prefill"]``-token prefill
    against a full forward within 1e-3."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import Model
    from repro_torch.serving.server import EngineConfig, LLMServer, SamplingParams
    cfg = dataclasses.replace(ARCHS[name], dtype="float32", param_dtype="float32",
                              **spec["f32"])
    model = Model(cfg, device=dev)
    params = model.init(seed=1)
    cap = 2560
    system = "System: one agent of a Planner/Actor/Evaluator workflow. " + \
        make_text(tok, rng, 150)
    shared = [system + f"{r}: " + make_text(tok, rng, 40)
              for r in ("planner", "actor", "evaluator")]
    copies = copy_prompts(tok, rng)[:3]

    def run(prompts, quoted=(), **ecfg):
        srv = LLMServer(cfg, num_slots=4, capacity=cap, params=params, device=dev,
                        engine_cfg=EngineConfig(**ecfg))
        out = []
        for _ in range(2):
            hs = [srv.submit(p, SamplingParams(max_new_tokens=24)) for p in prompts]
            hs += [srv.submit("", SamplingParams(max_new_tokens=24), token_ids=q)
                   for q in quoted]
            srv.run_until_idle()
            out += [h.request.output_ids for h in hs]
        check_graphs(f"{name}-f32", srv, dict.fromkeys(graph_counts(srv), 0))
        st = srv.stats()
        del srv
        return out, st

    dense, _ = run(shared)
    snap, sst = run(shared, cache_mode="paged", page_size=16, decode_chunk=8,
                    num_snapshots=16, snap_stride=2)
    base, _ = run(copies)
    quoted = self_quotes(tok, rng, tok.encode(copies[0]), base[0])
    base, _ = run(copies, quoted)
    spec_out, pst = run(copies, quoted, spec_len=4, spec_ngram_min=1)
    ok_snap = snap == dense and sst["snapshot_hits"] > 0
    ok_spec = spec_out == base and pst["verify_steps"] > 0
    log(f"[{name}-f32-{cfg.num_layers}-layers] snapshot == dense: {ok_snap} "
        f"(snapshot_hits={sst['snapshot_hits']}); spec == non-spec: {ok_spec} "
        f"(verify_steps={pst['verify_steps']} accepted={pst['accepted_tokens']}/"
        f"{pst['draft_tokens']})")
    if not (ok_snap and ok_spec):
        raise AssertionError(f"{name} float32: snapshot==dense {ok_snap}, "
                             f"spec==non-spec {ok_spec}")
    n = spec["f32_prefill"]
    ids = tok.encode(make_text(tok, rng, n + 8))[:n + 8]
    n = len(ids) - 8
    diff, scale = logits_decode_vs_forward(model, params, ids, n, dev)
    log(f"[{name}-f32-{cfg.num_layers}-layers] decode after a {n}-token prefill vs "
        f"one full forward, 8 steps: max_abs_logit_diff={diff:.3e} (|logit| max "
        f"{scale:.3f}, tol 1e-3)")
    if not math.isfinite(diff) or diff > 1e-3:
        raise AssertionError(f"{name} float32: decode vs forward logits differ by {diff}")
    del model, params
    torch.cuda.empty_cache()


@contextlib.contextmanager
def slstm_rule(label, srv):
    """Around one counted serving run (launch counts zeroed at its start,
    read at its end, as ``serve_phase`` and ``spec_run`` do): the sLSTM
    kernel's launches inside equal sLSTM layers x (prefill and extend
    forwards + decode steps + verify steps), all on its ``cluster`` route,
    and the plain loop ran on no CUDA tensor (it is swapped for a function
    that raises). Yields a dict; put the run's launch counts under
    ``"counts"``. Archs without sLSTM layers pass through."""
    from repro_torch.kernels import slstm_scan as kss
    out = {}
    n_sl = srv.engine.cfg.layer_kinds.count("slstm")
    if not n_sl:
        yield out
        return
    progs = srv.engine.progs
    d0, v0 = progs.decode_steps, progs.verify_steps
    plain = kss.slstm_scan_ref

    def refuse(gates_x, *a, **kw):
        if gates_x.device.type != "cpu":
            raise AssertionError(f"{label}: the plain sLSTM loop ran on {gates_x.device}")
        return plain(gates_x, *a, **kw)

    kss.slstm_scan_ref = refuse
    try:
        with counted_forwards(srv) as n:
            yield out
    finally:
        kss.slstm_scan_ref = plain
    steps, verify = progs.decode_steps - d0, progs.verify_steps - v0
    c = out["counts"]
    want = n_sl * (n["forwards"] + steps + verify)
    log(f"[{label}] slstm_scan launches {c['slstm_scan']} (cluster "
        f"{c['slstm_scan/cluster']}) == sLSTM layers x (forwards + decode steps + "
        f"verify steps) = {n_sl} x ({n['forwards']} + {steps} + {verify}) = {want}")
    if c["slstm_scan"] != want or c["slstm_scan/cluster"] != want or n["forwards"] <= 0:
        raise AssertionError(f"{label}: slstm_scan launches {c['slstm_scan']} break the "
                             f"rule {want}")


def dense_run(name, cfg, params, dev, tok, rng, spec):
    """Dense serving of ``spec["prompts"]`` (4 slots, capacity
    ``spec["capacity"]``) and a 2-turn session (sLSTM launches by
    ``slstm_rule``), then one decode chunk profiled (graph and eager) and
    the longest prompt's admission. Returns (prompts, launches, the chunk
    profile)."""
    import torch
    from repro_torch.serving.server import EngineConfig, LLMServer, SamplingParams
    srv = LLMServer(cfg, num_slots=4, capacity=spec["capacity"], params=params,
                    device=dev, engine_cfg=EngineConfig(cache_mode="dense"))
    prompts = [make_text(tok, rng, n) for n in spec["prompts"]]
    turns = [make_text(tok, rng, 300), " user: " + make_text(tok, rng, 100)]
    srv.submit(make_text(tok, rng, 40), SamplingParams(max_new_tokens=4)).result()
    with slstm_rule(f"{name}-dense", srv) as rule:
        handles, counts, _ = serve_phase(f"{name}-dense", srv, prompts, 1, turns)
        rule["counts"] = counts
    prof = profile_decode_chunk(srv, prompts)
    prof["decode_chunk"] = srv.engine.engine_cfg.decode_chunk
    profile_prefill(srv, prompts[-1])
    del handles, srv            # a handle keeps its server (and cache) alive
    gc.collect()
    torch.cuda.empty_cache()
    return prompts, counts, prof


def prefix_prompts(tok, rng):
    """(warm-up prompt, prompts, session turns) sharing a ~500-token system
    prompt."""
    system = ("System: you are one agent of a Planner/Actor/Evaluator "
              "workflow; tools are MCP functions. " + make_text(tok, rng, 500))
    prompts = [system + f"{role}: " + make_text(tok, rng, n)
               for role, n in (("planner", 100), ("actor", 300),
                               ("evaluator", 600), ("actor", 900))]
    turns = [system + "planner: " + make_text(tok, rng, 80),
             " tool: " + make_text(tok, rng, 120)]
    return system + "planner: plan the task.", prompts, turns


def prefix_run(label, cfg, params, dev, tok, rng, cap, **ecfg):
    """Prompts sharing a ~500-token system prompt and a 2-turn session on a
    prefix-sharing server (cache_mode="paged", page_size 16, decode_chunk 8:
    KV pages, or state snapshots on archs with per-slot state); fails
    without prefix hits or off the sLSTM launch rule (``slstm_rule``).
    Returns (server, prompts, launches)."""
    from repro_torch.serving.server import EngineConfig, LLMServer, SamplingParams
    srv = LLMServer(cfg, num_slots=4, capacity=cap, params=params, device=dev,
                    engine_cfg=EngineConfig(cache_mode="paged", page_size=16,
                                            decode_chunk=8, **ecfg))
    warm, prompts, turns = prefix_prompts(tok, rng)
    before = srv.stats()
    srv.submit(warm, SamplingParams(max_new_tokens=4)).result()
    with slstm_rule(label, srv) as rule:
        handles, counts, st = serve_phase(label, srv, prompts, 1, turns)
        rule["counts"] = counts
    if srv.engine.snapshots:
        hits = st["snapshot_hits"] - before["snapshot_hits"]
        log(f"[{label}] snapshot_hits={hits} snapshot_captures="
            f"{st['snapshot_captures']} snapshot_evictions="
            f"{st['snapshot_evictions']} turn_prefix_hits={st['turn_prefix_hits']}")
    else:
        hits = st["prefix_hit_tokens"] - before["prefix_hit_tokens"]
        log(f"[{label}] prefix_hit_tokens={hits}")
    if hits <= 0:
        raise AssertionError(f"{label}: no prefix hits")
    del handles
    return srv, prompts, counts


def stateful_phase(dev):
    """Both stateful archs at full width (bf16, random weights from seed 0,
    4 slots): dense, snapshot (cache_mode="paged") and spec_len=4 serving,
    every request COMPLETED; then the float32 one-period checks. Each model
    is freed before the next one loads."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import Model
    from repro_torch.serving.tokenizer import ByteTokenizer

    counts_all = collections.Counter()
    for name, spec in STATEFUL.items():
        cfg = ARCHS[name]
        tok = ByteTokenizer(cfg.vocab_size)
        rng = random.Random(3)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Model(cfg, device=dev)
        params = model.init(seed=0)
        torch.cuda.synchronize()
        log(f"[{name}] layers={cfg.num_layers} pattern={cfg.pattern} d_model="
            f"{cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} vocab="
            f"{cfg.vocab_size} params={model.param_count() / 1e9:.3f}B init_s="
            f"{time.perf_counter() - t0:.2f}")
        memory_report(name, cfg, params, spec)
        cap = spec["capacity"]
        counts = collections.Counter()
        prompts, c, _ = dense_run(name, cfg, params, dev, tok, rng, spec)
        counts.update(c)
        graph_matches_eager(f"{name}-dense", cfg, params, dev, prompts, cap,
                            cache_mode="dense")
        srv, _, c = prefix_run(f"{name}-snapshot", cfg, params, dev, tok, rng, cap,
                               num_snapshots=spec["num_snapshots"],
                               snap_stride=spec["snap_stride"])
        counts.update(c)
        del srv
        torch.cuda.empty_cache()
        counts.update(spec_run(name, cfg, params, dev, tok, rng, cap))
        del model, params
        gc.collect()
        torch.cuda.empty_cache()

        missing = [k for k in spec["kernels"] if counts[k] <= 0]
        log(f"[{name}] launches={dict(counts)} peak_memory_GB="
            f"{gb(torch.cuda.max_memory_allocated())}")
        if missing:
            raise AssertionError(f"{name}: kernels not launched: {missing}")
        counts_all.update(counts)
        stateful_f32_checks(name, spec, dev, tok, rng)
    return dict(counts_all)


# ---------------------------------------------------------------------------
# phase 9: the MoE archs (mixtral-8x22b, dbrx-132b)
# ---------------------------------------------------------------------------

# per arch: the depth cut (every width is the published one), capacity,
# prompt lengths of the dense run (mixtral's longest wraps its 4096-slot
# sliding-window ring), the cache mode that shares prefixes (mixtral's ring
# K/V goes to state snapshots, sized explicitly: one arena row is the ring
# K/V of every layer, 134 MB, and the default arena, 1 + slots * (capacity
# / 16 + 2) rows, would hold ~276 GB; dbrx goes to KV pages), the kernels
# its path must launch, and mixtral's float32 drop-free checks: one layer
# with the capacity factor at E / k = 4, so that C >= G in every group, and
# a prefill past the window before the decode-vs-forward steps
MOE = {
    "mixtral-8x22b": dict(num_layers=4, capacity=8192, prompts=(200, 1500, 3000, 6000),
                          num_snapshots=16, snap_stride=8,
                          f32=dict(num_layers=1, capacity_factor=4.0),
                          f32_prefill=4200,
                          kernels=("flash_attention", "decode_attention",
                                   "accept_len")),
    "dbrx-132b": dict(num_layers=3, capacity=2048, prompts=(200, 600, 1000, 1500),
                      kernels=("flash_attention", "decode_attention",
                               "paged_decode_attention", "paged_spec_decode_attention",
                               "accept_len")),
}


@contextlib.contextmanager
def routed_groups(out: list):
    """Collects (router weights, grouped tokens, dispatch mask) of every
    call of the port's ``moe.route`` inside the block (``apply_moe`` looks
    ``route`` up in its module at each call)."""
    from repro_torch.models import moe
    route = moe.route

    def counted(router_w, x, cfg):
        d, c, aux = route(router_w, x, cfg)
        out.append((router_w, x, d))
        return d, c, aux

    moe.route = counted
    try:
        yield
    finally:
        moe.route = route


def prefill_drop_share(name, model, params, ids, dev):
    """The share of (token, choice) pairs a prefill of ``ids`` (exact length,
    no bucket padding: only the last group's zero rows pad) dropped, per
    layer and in all, from the port's ``route``: the real tokens' kept
    dispatch entries against tokens x k; and per layer the share of the
    tokens whose first choice is the busiest expert (1 / E if balanced)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.layers import matmul_f32
    cfg = model.cfg
    T, k = len(ids), cfg.experts_per_token
    masks = []
    cache = model.init_cache(1, T + 16)
    with routed_groups(masks):
        model.prefill(params, model.make_batch(torch.tensor([ids], device=dev)),
                      cache, length=T, with_logits=False)
    kept, busiest = [], []
    for w, x, d in masks:
        kept.append(int(d.reshape(-1, d.shape[2] * d.shape[3])[:T].float().sum()))
        top1 = matmul_f32(x.reshape(-1, x.shape[-1])[:T], w).argmax(-1)
        busiest.append(float(torch.bincount(top1, minlength=cfg.num_experts).max()) / T)
    shares = [1 - n / (T * k) for n in kept]
    G = masks[0][1].shape[1]
    log(f"[{name}] prefill of {T} tokens: groups of {G}, capacity "
        f"{moe.capacity(cfg, G)} a group and expert (capacity_factor "
        f"{cfg.capacity_factor}); dropped (token, choice) share per layer "
        f"{[round(x, 4) for x in shares]}, all layers "
        f"{1 - sum(kept) / (len(kept) * T * k):.4f}; first choices on the "
        f"busiest expert per layer {[round(x, 3) for x in busiest]} "
        f"(1/E = {1 / cfg.num_experts:.3f})")
    return shares


def moe_decode_share(name, model, params, chunk_prof, dev):
    """One MoE layer at the decode step's shape (4 rows, one token each):
    its device time, times the depth, against the decode chunk's device
    busy time per step (graph path), and its bytes bound: the reference's
    dense dispatch reads every expert's matrices in every step."""
    import torch
    from repro_torch.models import moe
    cfg = model.cfg
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    x = torch.randn(4, 1, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
    layer = params.blocks[0].moe
    fn = lambda: moe.apply_moe(layer, x, cfg)                       # noqa: E731
    ms, dms = time_ms(fn, 20), device_ms(fn)
    nbytes = sum(p.numel() * p.element_size() for p in layer.parameters())
    b_ms = nbytes / HBM * 1e3
    step = None
    if chunk_prof.get("device_busy_ms"):
        step = chunk_prof["device_busy_ms"] / chunk_prof["decode_chunk"]
    share = dms * cfg.num_layers / step if (dms and step) else None
    log(f"[{name}] MoE layer at the decode shape [4,1,{cfg.d_model}]: call_ms="
        f"{ms:.4f} device_ms={fmt_ms(dms)} bytes_bound_ms={b_ms:.4f} "
        f"({nbytes / 1e9:.3f} GB of router and expert weights); x{cfg.num_layers} "
        f"layers: device_ms={fmt_ms(dms * cfg.num_layers if dms else None)} of a "
        f"decode step's device_busy_ms={fmt_ms(step)} (share "
        f"{'not measured' if share is None else f'{share:.3f}'}), bytes_bound_ms="
        f"{b_ms * cfg.num_layers:.3f}")


def spec_run(name, cfg, params, dev, tok, rng, cap, **ecfg):
    """spec_len=4 on copy-heavy prompts plus requests quoting the model's
    own greedy continuation (``self_quotes``), so that its drafts do not
    hang on a random model copying text; unigram drafts; every request
    COMPLETED, verify steps and drafts > 0, every verify step on the graph
    path; sLSTM launches by ``slstm_rule``. Returns the launches."""
    import torch
    from repro_torch.serving.server import EngineConfig, LLMServer, SamplingParams
    srv = LLMServer(cfg, num_slots=4, capacity=cap, params=params, device=dev,
                    engine_cfg=EngineConfig(spec_len=4, spec_ngram_min=1, **ecfg))
    label = f"{name}-spec-{ecfg.get('cache_mode', 'dense')}"
    cprompts = copy_prompts(tok, rng)
    r0 = serve_ids(srv, cprompts[:1])[0].request                # also the warm-up
    quoted = self_quotes(tok, rng, tok.encode(cprompts[0])[-r0.prompt_tokens:],
                         list(r0.output_ids[:24]))
    before = srv.stats()
    gbefore = graph_counts(srv)
    with slstm_rule(label, srv) as rule:
        reset_counts()
        t0 = time.perf_counter()
        hs = [srv.submit(p, SamplingParams(max_new_tokens=48)) for p in cprompts]
        hs += [srv.submit("", SamplingParams(max_new_tokens=48), token_ids=q)
               for q in quoted]
        srv.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rule["counts"] = c = kernel_counts()
    not_completed(label, hs)
    check_bf16_routes(label, c)
    check_graphs(label, srv, gbefore)
    st = srv.stats()
    d = {k: st[k] - before[k] for k in ("verify_steps", "draft_tokens",
                                        "accepted_tokens", "decode_tokens")}
    dec_s = sum(h.request.decode_s for h in hs)
    log(f"[{label}] requests={len(hs)} wall_s={wall:.3f} ttft_s="
        f"{[round(h.request.first_token_s, 4) for h in hs]} decode_tok_per_s="
        f"{d['decode_tokens'] / max(dec_s, 1e-9):.1f} output_tokens="
        f"{[h.request.output_tokens for h in hs]} {d} "
        f"peak_GB={gb(torch.cuda.max_memory_allocated())}")
    log(f"[{label}] launches={c}")
    if d["verify_steps"] <= 0 or d["draft_tokens"] <= 0:
        raise AssertionError(f"{label}: no verify steps / drafts: {d}")
    del hs, srv
    gc.collect()
    torch.cuda.empty_cache()
    return c


def moe_phase(dev):
    """Both MoE archs at their published widths and a cut depth (bf16,
    random weights from seed 0, 4 slots): dense serving with a 2-turn
    session, the prefix-sharing mode (mixtral: state snapshots of its ring;
    dbrx: KV pages) and spec_len=4, every request COMPLETED and every
    decode / verify step on the graph path; one decode chunk profiled on
    graphs and eagerly, the longest prompt's admission profiled, graph ids
    against eager ids; the prefill's dropped share and the MoE layer's
    share of a decode step printed; dbrx's dense against paged
    teacher-forced logits; then mixtral's float32 drop-free checks. Each
    model is freed before the next loads. Returns the launches by arch."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import Model
    from repro_torch.models import moe
    from repro_torch.serving.server import LLMServer
    from repro_torch.serving.tokenizer import ByteTokenizer

    out = {}
    for name, spec in MOE.items():
        full = ARCHS[name]
        cfg = dataclasses.replace(full, num_layers=spec["num_layers"])
        tok = ByteTokenizer(cfg.vocab_size)
        rng = random.Random(4)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Model(cfg, device=dev)
        params = model.init(seed=0)
        torch.cuda.synchronize()
        log(f"[{name}] reduced: num_layers {full.num_layers} -> {cfg.num_layers}; "
            f"published widths: d_model={cfg.d_model} heads={cfg.num_heads}/"
            f"{cfg.num_kv_heads} hd={cfg.head_dim} d_ff={cfg.d_ff} experts="
            f"{cfg.num_experts} top-{cfg.experts_per_token} window="
            f"{cfg.sliding_window} norm={cfg.norm_type} vocab={cfg.vocab_size} "
            f"capacity_factor={cfg.capacity_factor} group={cfg.moe_group_size} "
            f"dtype={cfg.dtype}; params={model.param_count() / 1e9:.3f}B init_s="
            f"{time.perf_counter() - t0:.2f}")
        memory_report(name, cfg, params, spec)
        cap = spec["capacity"]
        counts = collections.Counter()

        prompts, c, prof = dense_run(name, cfg, params, dev, tok, rng, spec)
        counts.update(c)
        moe_decode_share(name, model, params, prof, dev)
        prefill_drop_share(name, model, params, tok.encode(prompts[-1])[:cap - 64], dev)
        torch.cuda.empty_cache()
        graph_matches_eager(f"{name}-dense", cfg, params, dev, prompts, cap,
                            cache_mode="dense")

        # prefix sharing: state snapshots of mixtral's ring, KV pages for dbrx
        snaps = {k: spec[k] for k in ("num_snapshots", "snap_stride") if k in spec}
        label = f"{name}-{'snapshot' if snaps else 'paged'}"
        srv, sprompts, c = prefix_run(label, cfg, params, dev, tok, rng, cap, **snaps)
        counts.update(c)
        if srv.engine.snapshots != bool(snaps):
            raise AssertionError(f"{label}: cache_mode='paged' chose "
                                 f"{'snapshots' if srv.engine.snapshots else 'pages'}")
        if not snaps:
            profile_decode_chunk(srv, sprompts)
        del srv
        gc.collect()
        torch.cuda.empty_cache()
        if not snaps:
            graph_matches_eager(label, cfg, params, dev, sprompts, cap,
                                cache_mode="paged", page_size=16, decode_chunk=8)

        # speculative decode: dense on mixtral's ring, paged for dbrx
        paged = {} if snaps else dict(cache_mode="paged", page_size=16, decode_chunk=8)
        counts.update(spec_run(name, cfg, params, dev, tok, rng, cap, **paged))

        if not snaps:                   # dbrx: dense against paged, teacher-forced
            srv = LLMServer(cfg, num_slots=4, capacity=cap, params=params, device=dev)
            r = serve_ids(srv, prompts[:1])[0].request
            ids = tok.encode(prompts[0])[-r.prompt_tokens:] + list(r.output_ids)
            n_prompt = r.prompt_tokens
            del r, srv
            ld = teacher_forced(model, params, ids, n_prompt, paged=False, dev=dev)
            lp = teacher_forced(model, params, ids, n_prompt, paged=True, dev=dev)
            diff = float((ld - lp).abs().max())
            agree = float((ld.argmax(-1) == lp.argmax(-1)).float().mean())
            log(f"[{name}-dense-vs-paged] steps={ld.shape[0]} max_abs_logit_diff="
                f"{diff:.3e} (|logit| max {float(ld.abs().max()):.3f}, tol 5e-2) "
                f"greedy_agreement={agree:.4f}")
            if not math.isfinite(diff) or diff > 5e-2:
                raise AssertionError(f"{name}: dense vs paged logits differ by {diff}")

        missing = [k for k in spec["kernels"] if counts[k] <= 0]
        log(f"[{name}] launches={dict(counts)} peak_memory_GB="
            f"{gb(torch.cuda.max_memory_allocated())}")
        if missing:
            raise AssertionError(f"{name}: kernels not launched: {missing}")
        out[name] = counts
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        if "f32" in spec:
            f32cfg = dataclasses.replace(full, **spec["f32"])
            G = f32cfg.moe_group_size
            C = moe.capacity(f32cfg, G)
            log(f"[{name}-f32] drop-free: capacity_factor={f32cfg.capacity_factor} "
                f"(E / k), capacity {C} >= group {G}, and 8 >= a decode step's 4 rows")
            if C < G:
                raise AssertionError(f"{name}: the float32 checks are not drop-free")
            stateful_f32_checks(name, spec, dev, tok, rng)
    return out


# ---------------------------------------------------------------------------
# phase 10: the modality archs (musicgen-large, chameleon-34b)
# ---------------------------------------------------------------------------

# per arch: the depth (None: the published one), capacity and the dense
# run's prompt lengths (the qwen cells')
# 12 of 48 layers each: the whole script must stay under its 1200 s on a
# slow host (1122 s with both at full depth on one H100 host, 1259 s with
# 24 layers and the launch-layer phases), and this phase's cost goes with
# the depth
MODALITY = {
    "musicgen-large": dict(num_layers=12, capacity=2048,
                           prompts=(200, 600, 1000, 1500)),
    "chameleon-34b": dict(num_layers=12, capacity=2048,
                          prompts=(200, 600, 1000, 1500)),
}


@contextlib.contextmanager
def counted_forwards(server):
    """Counts the prefill and extend calls of ``server``'s programs inside
    the block; each runs every layer once."""
    progs = server.engine.progs
    n = collections.Counter()
    names = ("_prefill_fn", "_extend_fn", "_extend_paged_fn")
    for attr in names:
        def counted(*a, _fn=getattr(progs, attr), **kw):
            n["forwards"] += 1
            return _fn(*a, **kw)
        setattr(progs, attr, counted)
    try:
        yield n
    finally:
        for attr in names:
            delattr(progs, attr)


def counted_serve(label, srv, prompts, turns, warm):
    """``serve_phase`` after a warm-up request; fails unless flash launches
    == layers x prefill / extend forwards and (paged-)decode launches ==
    layers x decode steps. Returns what ``serve_phase`` returns."""
    from repro_torch.serving.server import SamplingParams
    srv.submit(warm, SamplingParams(max_new_tokens=4)).result()
    steps0 = srv.engine.progs.decode_steps
    with counted_forwards(srv) as n:
        handles, counts, st = serve_phase(label, srv, prompts, 1, turns)
    steps = srv.engine.progs.decode_steps - steps0
    L = srv.engine.cfg.num_layers
    dec = "paged_decode_attention" if srv.engine.paged else "decode_attention"
    log(f"[{label}] flash launches {counts['flash_attention']} == layers x "
        f"forwards {L * n['forwards']} ({n['forwards']}); {dec} launches "
        f"{counts[dec]} == layers x decode steps {L * steps} ({steps})")
    if counts["flash_attention"] != L * n["forwards"] or counts[dec] != L * steps \
            or n["forwards"] <= 0 or steps <= 0:
        raise AssertionError(f"{label}: launches {counts} against {n['forwards']} "
                             f"forwards and {steps} decode steps of {L} layers")
    return handles, counts, st


def logits_against_forward(name, model, params, ids, n_prompt, dev, tol):
    """Teacher-forced logits of ids[n_prompt:] built by decode steps on a
    dense cache and on a page pool (``teacher_forced``): the two within
    ``tol`` of each other, and each against one forward over ids[:-1]
    (the same math in other GEMM shapes and reduction orders); returns
    the largest difference from the forward and logs each with the argmax
    agreement. Fails past ``tol`` between the two layouts."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.programs import model_inputs
    n = len(ids) - 1
    full, _, _ = tfm.forward_logits(params, model_inputs(
        model.cfg, torch.tensor([ids[:-1]], device=dev),
        torch.arange(n, device=dev)[None]), model.cfg, mode="train")
    want = full[0, n_prompt - 1:]
    got = {paged: teacher_forced(model, params, ids, n_prompt, paged=paged, dev=dev)
           for paged in (False, True)}
    layouts = float((got[False] - got[True]).abs().max())
    worst = 0.0
    for paged, lg in got.items():
        diff = float((lg - want).abs().max())
        worst = max(worst, diff)
        agree = float((lg.argmax(-1) == want.argmax(-1)).float().mean())
        log(f"[{name}-{'paged' if paged else 'dense'}-vs-forward] steps="
            f"{lg.shape[0]} max_abs_logit_diff={diff:.3e} (|logit| max "
            f"{float(want.abs().max()):.3f}) argmax_agreement={agree:.4f}")
    log(f"[{name}-dense-vs-paged] teacher-forced max_abs_logit_diff={layouts:.3e} "
        f"(tol {tol})")
    if not math.isfinite(layouts) or not math.isfinite(worst) or layouts > tol:
        raise AssertionError(f"{name}: dense vs paged teacher-forced logits differ "
                             f"by {layouts}")
    return worst


def modality_f32_check(name, dev, tok, rng):
    """The same arch at its published widths, 4 layers, float32: the
    decode-built logits (dense and paged) within 1e-3 of one forward, so
    the bf16 gap between the two is rounding, not a different result."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import Model
    cfg = dataclasses.replace(ARCHS[name], dtype="float32", param_dtype="float32",
                              num_layers=4)
    model = Model(cfg, device=dev)
    params = model.init(seed=1)
    ids = tok.encode(make_text(tok, rng, 300))[:308]
    worst = logits_against_forward(f"{name}-f32-4-layers", model, params, ids,
                                   len(ids) - 32, dev, 1e-3)
    if worst > 1e-3:
        raise AssertionError(f"{name} float32: decode-built logits differ from one "
                             f"forward by {worst}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()


def modality_phase(dev):
    """Both modality archs at their published widths (bf16, random weights
    from seed 0, 4 slots, capacity 2048; musicgen's inputs are the frame
    stub one_hot(id % d_model), chameleon's early-fusion token ids): dense
    serving with a 2-turn session, then KV pages (page_size 16,
    decode_chunk 8) on prompts sharing a system prompt, every request
    COMPLETED and flash / decode launches == layers x forwards / steps; one
    dense decode chunk (graph and eager) and the longest prompt's admission
    profiled; graph ids against eager ids, dense and paged; teacher-forced
    logits of the two cache layouts within 5e-2, and each against one
    forward (printed); then 4 layers in float32, decode-built logits
    within 1e-3 of one forward. Each model is freed before the next loads.
    Returns the launches by arch."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import Model
    from repro_torch.serving.server import EngineConfig, LLMServer
    from repro_torch.serving.tokenizer import ByteTokenizer

    out = {}
    for name, spec in MODALITY.items():
        gc.collect()
        torch.cuda.empty_cache()
        full = ARCHS[name]
        cfg = full if spec["num_layers"] is None else dataclasses.replace(
            full, num_layers=spec["num_layers"])
        tok = ByteTokenizer(cfg.vocab_size)
        rng = random.Random(5)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Model(cfg, device=dev)
        params = model.init(seed=0)
        torch.cuda.synchronize()
        log(f"[{name}] layers={cfg.num_layers} of {full.num_layers} d_model="
            f"{cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} hd="
            f"{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} modality="
            f"{cfg.modality} pos_emb={cfg.pos_emb} dtype={cfg.dtype}; params="
            f"{model.param_count() / 1e9:.3f}B init_s={time.perf_counter() - t0:.2f}")
        memory_report(name, cfg, params, spec)
        cap = spec["capacity"]
        counts = collections.Counter()
        peak = 0

        srv = LLMServer(cfg, num_slots=4, capacity=cap, params=params, device=dev,
                        engine_cfg=EngineConfig(cache_mode="dense"))
        prompts = [make_text(tok, rng, n) for n in spec["prompts"]]
        turns = [make_text(tok, rng, 300), " user: " + make_text(tok, rng, 100)]
        hs, c, _ = counted_serve(f"{name}-dense", srv, prompts, turns,
                                 make_text(tok, rng, 40))
        counts.update(c)
        peak = max(peak, torch.cuda.max_memory_allocated())
        profile_decode_chunk(srv, prompts)
        profile_prefill(srv, prompts[-1])
        r = hs[0].request                           # a greedy request
        ids = tok.encode(prompts[0])[-r.prompt_tokens:] + list(r.output_ids)
        n_prompt = r.prompt_tokens
        del r, hs, srv              # a handle keeps its server (and cache) alive
        gc.collect()
        torch.cuda.empty_cache()
        graph_matches_eager(f"{name}-dense", cfg, params, dev, prompts, cap,
                            cache_mode="dense")

        paged = dict(cache_mode="paged", page_size=16, decode_chunk=8)
        srv = LLMServer(cfg, num_slots=4, capacity=cap, params=params, device=dev,
                        engine_cfg=EngineConfig(**paged))
        warm, pprompts, pturns = prefix_prompts(tok, rng)
        hs, c, st = counted_serve(f"{name}-paged", srv, pprompts, pturns, warm)
        counts.update(c)
        peak = max(peak, torch.cuda.max_memory_allocated())
        log(f"[{name}-paged] prefix_hit_tokens={st['prefix_hit_tokens']}")
        if st["prefix_hit_tokens"] <= 0:
            raise AssertionError(f"{name}-paged: no prefix hits")
        del hs, srv
        gc.collect()
        torch.cuda.empty_cache()
        graph_matches_eager(f"{name}-paged", cfg, params, dev, pprompts, cap, **paged)

        logits_against_forward(name, model, params, ids, n_prompt, dev, 5e-2)
        log(f"[{name}] launches={dict(counts)} peak_memory_GB={gb(peak)}")
        out[name] = counts
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        modality_f32_check(name, dev, tok, rng)
    return out


# ---------------------------------------------------------------------------
# phase 11: a checkpoint in the reference's format, written and restored
# ---------------------------------------------------------------------------


def checkpoint_phase(dev):
    """musicgen-large at its published widths and 4 of 48 layers (bf16,
    random weights from seed 0): its params saved by the port's
    ``AsyncCheckpointer`` (the reference's format) into a directory under
    build/ while a server on the same params serves 4 requests, restored
    onto the card by ``Model.restore``; every tensor bit-identical and a
    fresh server on the restored params gives the same greedy ids. Prints
    save and restore seconds and bytes; the directory is deleted."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import Model, convert
    from repro_torch.serving.server import LLMServer
    from repro_torch.serving.tokenizer import ByteTokenizer

    cfg = dataclasses.replace(ARCHS["musicgen-large"], num_layers=4)
    model = Model(cfg, device=dev)
    params = model.init(seed=0)
    tok = ByteTokenizer(cfg.vocab_size)
    rng = random.Random(6)
    prompts = [make_text(tok, rng, n) for n in (200, 600, 1000, 1500)]
    (ROOT / "build").mkdir(exist_ok=True)
    d = tempfile.mkdtemp(prefix="ckpt-", dir=ROOT / "build")
    try:
        srv = LLMServer(cfg, num_slots=4, capacity=2048, params=params, device=dev)
        ck = AsyncCheckpointer(d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(1, convert.params_to_jax(params.state_dict(), cfg))
        host_s = time.perf_counter() - t0           # the copy to the host
        ids_mem = [h.request.output_ids for h in serve_ids(srv, prompts)]
        serve_s = time.perf_counter() - t0
        ck.wait()
        save_s = time.perf_counter() - t0
        files = [f for f in Path(d).rglob("*") if f.is_file()]
        nbytes = sum(f.stat().st_size for f in files)
        del srv
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, step = Model(cfg, device=dev).restore(d)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        sd0, sd1 = params.state_dict(), restored.state_dict()
        same = sorted(sd0) == sorted(sd1) and all(
            sd0[k].dtype == sd1[k].dtype and torch.equal(
                sd0[k].view(torch.int16), sd1[k].view(torch.int16)) for k in sd0)
        srv = LLMServer(cfg, num_slots=4, capacity=2048, params=restored, device=dev)
        ids_rest = [h.request.output_ids for h in serve_ids(srv, prompts)]
        del srv
        log(f"[checkpoint] {cfg.name} {cfg.num_layers} of 48 layers, bf16: "
            f"{len(files)} files, {nbytes} bytes ({gb(nbytes)} GB); save_s="
            f"{save_s:.3f} (host copy {host_s:.3f}, a server served 4 requests "
            f"for {serve_s - host_s:.3f} s meanwhile) restore_s={restore_s:.3f} "
            f"step={step}; {len(sd0)} tensors bit-identical: {same}; restored "
            f"ids == in-memory ids: {ids_rest == ids_mem} (output tokens "
            f"{[len(x) for x in ids_mem]})")
        if not same or step != 1 or ids_rest != ids_mem:
            raise AssertionError("checkpoint: the restored params or ids differ")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del model, params, restored
    gc.collect()
    torch.cuda.empty_cache()


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
    gbefore = graph_counts(srv)
    reset_counts()
    t0 = time.perf_counter()
    res = rt.run_session(f"fame-{query_input}", la.APP.queries(query_input))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    check_bf16_routes("fame", counts)
    check_graphs("fame", srv, gbefore)
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


# ---------------------------------------------------------------------------
# phase 7c: the FAME entry points (repro_torch.examples)
# ---------------------------------------------------------------------------


def record_requests(server):
    """Every request ``server``'s scheduler queues from here on, in order."""
    reqs, enqueue = [], server.engine.enqueue

    def recorded(*a, **kw):
        reqs.append(enqueue(*a, **kw))
        return reqs[-1]

    server.engine.enqueue = recorded
    return reqs


def counted_apps_run(name, server, fn):
    """``fn()`` on ``server`` with the kernel counts zeroed just before and
    read just after: (its result, the counts). The bf16 routes and the
    graph path are checked."""
    import torch
    torch.cuda.synchronize()
    gbefore = graph_counts(server)
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = kernel_counts()
    check_bf16_routes(name, counts)
    check_graphs(name, server, gbefore)
    return out, counts


def apps_phase(dev, model, params):
    """The port's four FAME entry points on the full-width model: the
    oracle apps (host only), ``quickstart`` with every agent role on
    ``TorchLLM`` (RS and LA, M+C, both fusion modes: four sessions on one
    paged server), and ``serve_agents`` (3 workflows x 2 rounds) paged,
    then with ``spec_len=4``."""
    import torch
    from repro_torch.examples import (log_analytics, quickstart,
                                      research_summary, serve_agents)

    launches = collections.Counter()
    # the oracle apps: FAME's control plane alone, on this machine's host
    table = research_summary.table("P1")
    la_res, _ = log_analytics.run("L1", "M+C")
    rows = {line.split()[0]: line for line in table[2:]}
    log(f"[apps] research_summary P1: {rows['E']!r}, {rows['M+C']!r}; "
        f"log_analytics L1 M+C: {la_res.statuses}")
    if "DNF" not in rows["E"] or "DNF" in rows["M+C"] or \
            set(la_res.statuses) != {"SUCCEEDED"}:
        raise AssertionError(f"apps: oracle statuses {table} {la_res.statuses}")

    # quickstart --llm torch: four sessions on one paged server
    arch = model.cfg.name
    srv = quickstart.make_server(model.cfg, dev, params)
    llm = quickstart.torch_backend(srv, arch)
    reqs = record_requests(srv)

    def sessions():
        for app in ("RS", "LA"):
            for fusion in ("singleton", "consolidated"):
                t0 = time.perf_counter()
                res, lines = quickstart.run(app, "M+C", fusion, llm)
                log(f"[apps] quickstart {app} M+C {fusion}: statuses={res.statuses} "
                    f"wall_s={time.perf_counter() - t0:.3f}; {lines[-1]}")

    _, counts = counted_apps_run("apps-quickstart", srv, sessions)
    st = srv.stats()
    log(f"[apps] quickstart: requests={len(reqs)} sessions_opened="
        f"{st['sessions_opened']} session_turns={st['session_turns']} "
        f"turn_prefix_hits={st['turn_prefix_hits']} prefix_hit_tokens="
        f"{st['prefix_hit_tokens']} of {st['prompt_tokens']} truncated_requests="
        f"{st['truncated_requests']} decode_tokens={st['decode_tokens']}")
    log(f"[apps] quickstart launches={counts}")
    if not reqs or not all(r.finished for r in reqs):
        raise AssertionError("apps: a quickstart turn is not terminal")
    if st["prefix_hit_tokens"] <= 0 or st["session_turns"] <= st["sessions_opened"]:
        raise AssertionError(f"apps: quickstart reused no prefix or session: {st}")
    if counts["flash_attention"] <= 0 or counts["paged_decode_attention"] <= 0:
        raise AssertionError(f"apps: quickstart kernels not launched: {counts}")
    launches.update(counts)
    del srv, llm
    torch.cuda.empty_cache()

    # serve_agents --workflows 3 --rounds 2, paged, then --spec-len 4
    for spec_len in (0, 4):
        name = f"apps-serve_agents-spec{spec_len}"
        srv = serve_agents.make_server(model.cfg, spec_len=spec_len, device=dev,
                                       params=params)
        t0 = time.perf_counter()
        out, counts = counted_apps_run(
            name, srv, lambda: serve_agents.run(srv, workflows=3, rounds=2))
        st = srv.stats()
        log(f"[{name}] wall_s={time.perf_counter() - t0:.3f} handles="
            f"{len(out['handles'])} turn_prefix_hits={out['stats']['turn_prefix_hits']} "
            f"fame statuses={out['fame'].statuses} verify_steps={st['verify_steps']} "
            f"draft_tokens={st['draft_tokens']} accepted_tokens={st['accepted_tokens']}")
        log(f"[{name}] launches={counts}")
        not_completed(name, out["handles"])
        if out["stats"]["turn_prefix_hits"] <= 0:
            raise AssertionError(f"{name}: no turn admitted off the retained tail")
        need = ["flash_attention", "paged_decode_attention"]
        if spec_len:
            if st["verify_steps"] <= 0:
                raise AssertionError(f"{name}: no verify step ran")
            need += ["accept_len", "paged_spec_decode_attention"]
        idle = [k for k in need if counts[k] <= 0]
        if idle:
            raise AssertionError(f"{name}: kernels not launched: {idle}")
        launches.update(counts)
        del srv
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 10: the replica fleet and the robustness layers
# ---------------------------------------------------------------------------

FLEET_ECFG = dict(cache_mode="paged", page_size=16, decode_chunk=8)  # FAME's engine


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def graph_pool_bytes():
    """Bytes the caching allocator holds in CUDA graph pools (segments of any
    pool but the default one), from its snapshot; None where the snapshot
    does not name the pools."""
    import torch
    segs = torch.cuda.memory._snapshot()["segments"]
    if any("segment_pool_id" not in s for s in segs):
        return None
    return sum(s["total_size"] for s in segs if tuple(s["segment_pool_id"]) != (0, 0))


def session_plan(tok, rng):
    """8 sessions in two prefix families (two ~500-token system prompts):
    per session its first turn and the deltas of turns 2-4."""
    systems = [f"Family {f} system prompt: agents of a FaaS workflow; tools are "
               "MCP functions. " + make_text(tok, rng, 500) for f in "AB"]
    return [(systems[i % 2] + f"[session {i}] user: " + make_text(tok, rng, 60),
             [" user: " + make_text(tok, rng, 40) for _ in range(3)])
            for i in range(8)]


def run_sessions(front, plan, turns, sessions=None, order=None, threads=4,
                 max_new=32):
    """Drive ``turns`` (indices: 0 = the first turn, k = delta k) of the
    sessions in ``plan`` on ``front`` (a server or a fleet): sessions 0 and 1
    (one per family) alone first when they are opened here, then the rest
    from ``threads`` client threads. Returns (sessions, handles by session),
    every handle completed."""
    import threading
    from repro_torch.serving.server import SamplingParams
    sp = SamplingParams(max_new_tokens=max_new)
    order = list(range(len(plan))) if order is None else order
    sessions = dict(sessions or {})
    out = {i: [] for i in order}
    errs = []

    def run(i):
        if i not in sessions:
            sessions[i] = front.open_session()
        s = sessions[i]
        for t in turns:
            h = s.submit(plan[i][0] if t == 0 else s.text + plan[i][1][t - 1], sp)
            h.result()
            not_completed(f"session {i} turn {t}", [h])
            out[i].append(h)

    def worker(idx):
        try:
            for i in idx:
                run(i)
        except BaseException as e:      # raised in the main thread below
            errs.append(e)

    first = [i for i in order[:2] if i not in sessions]
    for i in first:
        run(i)
    rest = [i for i in order if i not in first]
    ts = [threading.Thread(target=worker, args=(rest[k::threads],))
          for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(600)
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in ts):
        raise AssertionError("a client thread did not finish")
    return sessions, out


def capture_beside_admission(fleet, prompts):
    """Replica 0 captures its decode graph while replica 1 admits a request
    eagerly: replica 0's decode step, called under capture, waits until
    replica 1's request has been admitted (prefilled, first token pulled).
    Returns (replica 0's graph record, both handles)."""
    import threading
    import torch
    from repro_torch.serving.server import SamplingParams
    a, b = fleet.replicas[0].server, fleet.replicas[1].server
    model = a.engine.progs.model
    step = model.decode_step
    capturing, admitted = threading.Event(), threading.Event()

    def held(*args, **kw):
        if torch.cuda.is_current_stream_capturing() and not capturing.is_set():
            capturing.set()
            if not admitted.wait(120):
                raise RuntimeError("replica 1 admitted nothing during the capture")
        return step(*args, **kw)

    model.decode_step = held
    sp = SamplingParams(max_new_tokens=24)
    try:
        ha = a.submit(prompts[0], sp)
        if not capturing.wait(120):
            raise AssertionError("replica 0 did not capture")
        hb = b.submit(prompts[1], sp)
        t0 = time.perf_counter()
        while hb.request.status == "queued" and time.perf_counter() - t0 < 120:
            time.sleep(0.002)
        admitted.set()
        ha.result()
        hb.result()
    finally:
        model.decode_step = step
    return dict(a.engine.progs._graphs["decode", "greedy"].launches), (ha, hb)


def crash_pump(server, what: str):
    """Kill a replica's pump the way tests/test_fleet.py does: its next loop
    iteration raises."""
    def boom():
        raise RuntimeError(f"injected crash: {what}")
    server._step_impl = boom
    t0 = time.perf_counter()
    while server.pumping and time.perf_counter() - t0 < 60:
        time.sleep(0.01)
    if server.pumping:
        raise AssertionError(f"{what}: the pump did not die")


def tail_vs_prefill(model, params, ids, n_decoded, n_prefilled, dev, paged):
    """Logits of ids[n_prefilled:] two ways: with the cache built by decode
    steps from ``n_decoded`` (a tail the server built token by token) and
    with ids[:n_prefilled] prefilled at once (a re-prefill: preempt-resume,
    journal replay). Returns (max abs difference, argmax agreement)."""
    a = teacher_forced(model, params, ids, n_decoded, paged=paged, dev=dev)
    b = teacher_forced(model, params, ids, n_prefilled, paged=paged, dev=dev)
    a = a[n_prefilled - n_decoded:]
    return (float((a.float() - b.float()).abs().max()),
            float((a.argmax(-1) == b.argmax(-1)).float().mean()))


def agreement(outs, refs):
    same = sum(x == y for o, r in zip(outs, refs) for x, y in zip(o, r))
    return f"{same}/{sum(len(r) for r in refs)} tokens, identical " \
           f"{sum(o == r for o, r in zip(outs, refs))}/{len(refs)}"


def preempt_run(cfg, params, dev, prompts, sps, mode, preempt: bool):
    """Low-priority requests on a cooperative graph server with a slot each;
    with ``preempt`` a priority-5 arrival once they all decode. Returns (output
    ids by request, victims [(request index, tokens generated when
    preempted)], server stats)."""
    from repro_torch.serving.server import (EngineConfig, LLMServer,
                                            OverloadPolicy, SamplingParams)
    srv = LLMServer(cfg, num_slots=len(prompts), capacity=2048, params=params,
                    device=dev, overload=OverloadPolicy(preempt=True),
                    engine_cfg=EngineConfig(**dict(FLEET_ECFG, cache_mode=mode)))
    victims = []
    preempt_slot = srv.engine._preempt_slot

    def spy(si):
        slot = srv.engine.slots[si]
        victims.append((rids.index(slot.request.rid), len(slot.generated)))
        preempt_slot(si)

    srv.engine._preempt_slot = spy
    hs = [srv.submit(p, sp) for p, sp in zip(prompts, sps)]
    rids = [h.request.rid for h in hs]
    if preempt:
        while any(h.request.status != "running" for h in hs):
            srv.step()
        srv.step()
        hi = srv.submit("urgent: " + prompts[0][:200],
                        SamplingParams(max_new_tokens=16, priority=5))
        hs.append(hi)
    srv.run_until_idle()
    not_completed(f"preempt {mode}{'' if preempt else ' ref'}", hs)
    check_graphs(f"preempt-{mode}{'' if preempt else '-ref'}", srv,
                 dict.fromkeys(graph_counts(srv), 0))
    st = srv.stats()
    if preempt and (st["preemptions"] < 1 or st["preempt_resumes"] < 1):
        raise AssertionError(f"preempt {mode}: preemptions={st['preemptions']} "
                             f"resumes={st['preempt_resumes']}")
    out = [list(h.request.output_ids) for h in hs[:len(prompts)]]
    del srv
    return out, victims, st


def fleet_f32_checks(cfg, dev, plan):
    """Full width, 4 layers, float32: migration by journal replay after a
    crash, preempt-resume (dense and paged, one request sampled) and journal
    restore into a fresh server each give exactly the uninterrupted
    server's tokens."""
    import torch
    from repro_torch.models import Model
    from repro_torch.serving.fleet import FleetServer
    from repro_torch.serving.server import EngineConfig, LLMServer, SamplingParams
    cfg4 = dataclasses.replace(cfg, num_layers=4, dtype="float32",
                               param_dtype="float32")
    m4 = Model(cfg4, device=dev)
    p4 = m4.init(seed=1)
    sp = SamplingParams(max_new_tokens=32)
    ecfg = EngineConfig(**FLEET_ECFG)

    def turns(s, i, n):
        out = []
        for t in range(n):
            h = s.submit(plan[i][0] if t == 0 else s.text + plan[i][1][t - 1], sp)
            h.result()
            out.append(list(h.request.output_ids))
        return out

    # uninterrupted: sessions 0 and 1 (one per family), three turns, alone
    ref = LLMServer(cfg4, num_slots=4, capacity=2048, params=p4, device=dev,
                    engine_cfg=ecfg)
    want = [turns(ref.open_session(), i, 3) for i in (0, 1)]
    del ref

    # migration: the fleet pins session 0 to replica 0 and 1 to replica 1;
    # replica 1's pump dies after turn 1, turns 2-3 of session 1 migrate
    fleet = FleetServer(cfg4, num_replicas=2, num_slots=4, capacity=2048,
                        params=p4, device=dev, pump=True, engine_cfg=ecfg)
    ss = [fleet.open_session() for _ in range(2)]
    got = [[], []]
    for i in (0, 1):
        got[i] += turns(ss[i], i, 1)
    if [s.replica_index for s in ss] != [0, 1]:
        raise AssertionError(f"f32 fleet placement {[s.replica_index for s in ss]}")
    crash_pump(fleet.replicas[1].server, "f32 replica 1")
    for i in (0, 1):
        for t in (1, 2):
            h = ss[i].submit(ss[i].text + plan[i][1][t - 1], sp)
            h.result()
            got[i].append(list(h.request.output_ids))
    st = fleet.stats()
    for r in fleet.replicas:
        check_graphs(f"fleet-f32-replica{r.idx}", r.server,
                     dict.fromkeys(graph_counts(r.server), 0))
    fleet.close()
    del fleet
    migrated = st["migrated_sessions"] == 1 and ss[1].replica_index == 0
    log(f"[fleet-f32-4-layers] migration: migrated={st['migrated_sessions']} "
        f"session 1 on replica {ss[1].replica_index}; tokens == uninterrupted "
        f"{got == want} (output tokens {[[len(t) for t in g] for g in got]})")
    if not migrated or got != want:
        raise AssertionError("float32 migration differs from the uninterrupted server")

    # preempt-resume, dense and paged; the victim (request 0: the first
    # slot among equals) samples, so its RNG chain resumes mid-stream
    prompts = [plan[i][0] for i in range(2)]
    sps = [SamplingParams(max_new_tokens=48, temperature=0.7, seed=5),
           SamplingParams(max_new_tokens=48)]
    for mode in ("dense", "paged"):
        base, _, _ = preempt_run(cfg4, p4, dev, prompts, sps, mode, False)
        res, victims, st = preempt_run(cfg4, p4, dev, prompts, sps, mode, True)
        same = base == res
        log(f"[fleet-f32-4-layers] preempt-{mode}: victims (request, tokens) "
            f"{victims} preemptions={st['preemptions']} resumes="
            f"{st['preempt_resumes']}; tokens == uninterrupted {same}")
        if not same:
            raise AssertionError(f"float32 preempt-resume ({mode}) differs")

    # journal restore into a fresh server
    path = ROOT / "build" / "fleet_f32_journal.json"
    path.parent.mkdir(exist_ok=True)
    a = LLMServer(cfg4, num_slots=4, capacity=2048, params=p4, device=dev,
                  engine_cfg=ecfg, journal_path=str(path))
    sa = a.open_session()
    first = turns(sa, 0, 1)
    a.close()
    del a
    b = LLMServer(cfg4, num_slots=4, capacity=2048, params=p4, device=dev,
                  engine_cfg=ecfg)
    sb = b.restore_sessions(str(path))[sa.sid]
    h = sb.submit(sb.text + plan[0][1][0], sp)
    h.result()
    check_graphs("restore-f32", b, dict.fromkeys(graph_counts(b), 0))
    ok = first[0] == want[0][0] and list(h.request.output_ids) == want[0][1]
    log(f"[fleet-f32-4-layers] journal restore: turn 2 == uninterrupted {ok} "
        f"(turn_prefix_hits {b.stats()['turn_prefix_hits']})")
    if not ok:
        raise AssertionError("float32 journal restore differs from the uninterrupted server")
    del b, m4, p4
    torch.cuda.empty_cache()


def fleet_phase(dev, model, params, tok):
    """The port's replica fleet on one card (two replicas, a pump and CUDA
    graphs each) with the robustness layers: traffic, the FAME session,
    failover, elasticity, preemption, journal restore, then float32
    identity. Returns the launches."""
    import threading
    import torch
    from repro_torch.apps import log_analytics as la
    from repro_torch.core.config import CONFIGS
    from repro_torch.core.runtime import FameRuntime
    from repro_torch.fame import ServingMeter, WorkflowServingRuntime
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.serving.fleet import FleetServer
    from repro_torch.serving.server import EngineConfig, LLMServer, SamplingParams

    cfg = model.cfg
    rng = random.Random(10)
    t_phase = time.perf_counter()
    plan = session_plan(tok, rng)
    weights = tensor_bytes(params.parameters())

    # ---- 1. the fleet: two replicas on one set of weight tensors ---------
    gc.collect()                        # servers of earlier phases, in cycles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()            # the weights included
    fleet = FleetServer(cfg, num_replicas=2, num_slots=4, capacity=2048,
                        params=params, device=dev, pump=True,
                        engine_cfg=EngineConfig(**FLEET_ECFG))
    reps = fleet.replicas
    ptrs = [[t.data_ptr() for t in r.server.params.parameters()] for r in reps]
    shared = all(r.server.params is params for r in reps) and ptrs[0] == ptrs[1]
    pool = tensor_bytes(tree_leaves(reps[0].server.engine.cache))
    log(f"[fleet] 2 replicas: weights shared (same tensors, data_ptr) {shared}; "
        f"weights_GB={gb(weights)} page_pool_GB={gb(pool)} per replica")
    if not shared:
        raise AssertionError("fleet: replicas do not share the weight tensors")

    # replica 1 admits eagerly while replica 0's capture is open: the capture
    # holds and records replica 0's launches alone
    reset_counts()
    record, pair = capture_beside_admission(
        fleet, [make_text(tok, rng, 300), make_text(tok, rng, 700)])
    counts = kernel_counts()
    want_rec = {("paged_decode_attention", ""): cfg.num_layers}
    steps = [graph_counts(r.server)["decode_steps"] for r in reps]
    log(f"[fleet] replica 1 admitted {pair[1].request.prompt_tokens} tokens while "
        f"replica 0 captured: replica 0's graph record {record} (its own decode "
        f"step alone), both requests {[h.request.status for h in pair]}; "
        f"paged_decode launches {counts['paged_decode_attention']} == layers x "
        f"decode steps {cfg.num_layers * sum(steps)}")
    not_completed("fleet admission beside a capture", pair)
    if (record != want_rec
            or counts["paged_decode_attention"] != cfg.num_layers * sum(steps)
            or counts["flash_attention"] <= 0):
        raise AssertionError("fleet: an admission beside a capture leaked or broke it")

    # ---- 2. traffic: 8 sessions, two prefix families, 2 turns, 4 threads --
    gb0 = [graph_counts(r.server) for r in reps]
    reset_counts()
    t0 = time.perf_counter()
    sessions, hs = run_sessions(fleet, plan, (0, 1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    st = fleet.stats()
    steps = [graph_counts(r.server)["decode_steps"] - g["decode_steps"]
             for r, g in zip(reps, gb0)]
    for r, g in zip(reps, gb0):
        check_graphs(f"fleet-replica{r.idx}", r.server, g)
    check_bf16_routes("fleet", counts)
    dec = sum(h.request.output_tokens for v in hs.values() for h in v)
    placed = [r.routed for r in reps]
    log(f"[fleet] traffic: 16 turns wall_s={wall:.3f} output_tokens={dec} "
        f"output_tok_per_s_wall={dec / wall:.1f} routed={st['routed_requests']} "
        f"affinity_hits={st['affinity_hits']} spilled={st['spilled_admissions']} "
        f"per replica routed={placed} decode_steps={steps}")
    log(f"[fleet] launches={counts}")
    want_pd = cfg.num_layers * sum(steps)
    log(f"[fleet] two pumps: paged_decode launches {counts['paged_decode_attention']} "
        f"== layers x decode steps {want_pd}")
    if counts["paged_decode_attention"] != want_pd:
        raise AssertionError("fleet: launch counts inconsistent under two pumps")
    if st["affinity_hits"] <= 0 or min(placed) <= 0:
        raise AssertionError(f"fleet: affinity {st['affinity_hits']} placed {placed}")
    if counts["flash_attention"] <= 0 or counts["paged_decode_attention"] <= 0:
        raise AssertionError(f"fleet: kernels not launched: {counts}")
    graph = graph_pool_bytes()
    peak = torch.cuda.max_memory_allocated()
    caches = 2 * pool + (graph or 0)
    log(f"[fleet] peak_memory_GB={gb(peak)}: {gb(base)} allocated before the fleet "
        f"(1x weights {gb(weights)} included) + {gb(peak - base)} for the fleet, "
        f"against 2x (page pool + graph pool) = {gb(caches)} (graph pools "
        f"{'not measured' if graph is None else gb(graph)} GB in all)")
    if peak - base > caches + weights / 2:
        raise AssertionError("fleet: peak memory holds a second copy of the weights")

    # ---- 8. one FAME M+C session on the fleet ------------------------------
    query = la.APP.inputs[0]
    oracle_rt = FameRuntime(config=CONFIGS["M+C"])
    for role, oracle in la.build_oracles().items():
        oracle_rt.set_llm(role, oracle)
    oracle_rt.deploy_mcp(la.APP.servers, la.APP.sources)
    want = oracle_rt.run_session(f"fame-{query}", la.APP.queries(query)).statuses
    meter = ServingMeter(fleet)
    rt = WorkflowServingRuntime(config=CONFIGS["M+C"], server=fleet, meter=meter,
                                params=SamplingParams(max_new_tokens=8))
    for role, oracle in la.build_oracles().items():
        rt.set_llm(role, oracle)
    rt.deploy_mcp(la.APP.servers, la.APP.sources)
    t0 = time.perf_counter()
    res = rt.run_session(f"fame-{query}", la.APP.queries(query))
    log(f"[fleet-fame] log_analytics M+C on the fleet: statuses={res.statuses} "
        f"(oracle {want}) wall_s={time.perf_counter() - t0:.3f} "
        f"turns={len(meter.turns())} continuation_turns="
        f"{len(meter.continuation_turns())}")
    if res.statuses != want or not meter.all_terminal():
        raise AssertionError(f"fleet-fame: statuses {res.statuses} != {want}")

    # ---- 3. failover: replica 1's pump dies mid-traffic --------------------
    on1 = sorted(i for i, s in sessions.items() if s.replica_index == 1)
    on0 = sorted(i for i, s in sessions.items() if s.replica_index == 0)
    pinned1 = sum(1 for fs in list(fleet._sessions.values()) if fs.replica_index == 1)
    box = {}
    busy = threading.Thread(target=lambda: box.update(run=run_sessions(
        fleet, plan, (2,), sessions, on0)))
    busy.start()
    crash_pump(reps[1].server, "replica 1")
    busy.join(600)
    _, moved = run_sessions(fleet, plan, (2,), sessions, on1)
    if busy.is_alive() or "run" not in box:
        raise AssertionError("fleet: traffic on replica 0 did not finish")
    st = fleet.stats()
    where = {i: sessions[i].replica_index for i in on1}
    log(f"[fleet] failover: replica 1 died under {len(on1)} sessions; "
        f"migrated={st['migrated_sessions']} replicas_failed={st['replicas_failed']} "
        f"now on {where}; turn 3 completed on all")
    if st["migrated_sessions"] != pinned1 or set(where.values()) != {0}:
        raise AssertionError(f"fleet: failover migrated {st['migrated_sessions']} "
                             f"of {len(on1)} sessions: {where}")

    # ---- 4. elasticity: a new replica takes the load, replica 0 drains ----
    new = fleet.add_replica()
    g_new = graph_counts(fleet.replicas[new].server)
    fleet.drain(0)
    _, later = run_sessions(fleet, plan, (3,), sessions, sorted(sessions))
    fresh = fleet.submit(plan[0][0][:300] + " a fresh request",
                         SamplingParams(max_new_tokens=16))
    fresh.result()
    rn = fleet.replicas[new]
    check_graphs(f"fleet-replica{new}", rn.server, g_new)
    gc_new = graph_counts(rn.server)
    st = fleet.stats()
    log(f"[fleet] elastic: add_replica -> {new} (weights shared "
        f"{rn.server.params is params}), drain(0): drained={st['replicas_drained']} "
        f"migrated={st['migrated_sessions']}; replica {new} ran turn 4 of "
        f"{len(later)} sessions and a fresh request, decode captures "
        f"{gc_new['decode_captures']} replays {gc_new['decode_replays']}")
    not_completed("fleet elastic", [fresh])
    if (rn.server.params is not params or gc_new["decode_captures"] < 1
            or any(s.replica_index != new for s in sessions.values())):
        raise AssertionError("fleet: the added replica did not take the traffic")

    # bf16 migration against the uninterrupted 8-slot server (below) and the
    # teacher-forced logits of a re-prefilled tail against a decoded one
    mig = on1[0]
    fleet_turns = {i: [list(h.request.output_ids) for h in hs[i]]
                   + [list(box["run"][1][i][0].request.output_ids) if i in on0
                      else list(moved[i][0].request.output_ids)]
                   for i in sessions}
    agg_fleet = dict(wall=wall, tokens=dec)
    fleet_stats = fleet.stats()
    fleet.close()
    del fleet, reps, rn, sessions, hs, moved, later, box, rt, meter
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 9. one server with 8 slots on the same sessions -------------------
    single = LLMServer(cfg, num_slots=8, capacity=2048, params=params,
                       device=dev, pump=True, engine_cfg=EngineConfig(**FLEET_ECFG))
    t0 = time.perf_counter()
    ss, shs = run_sessions(single, plan, (0, 1))
    torch.cuda.synchronize()
    swall = time.perf_counter() - t0
    sdec = sum(h.request.output_tokens for v in shs.values() for h in v)
    _, s3 = run_sessions(single, plan, (2,), ss, sorted(ss))
    single_turns = {i: [list(h.request.output_ids) for h in shs[i]]
                    + [list(s3[i][0].request.output_ids)] for i in ss}
    conv = list(single.engine._sessions[ss[mig].sid].all_tokens)
    single.close()
    log(f"[fleet] aggregate decode: fleet of 2 x 4 slots "
        f"{agg_fleet['tokens'] / agg_fleet['wall']:.1f} output tok/s "
        f"({agg_fleet['tokens']} tokens in {agg_fleet['wall']:.3f} s) against one "
        f"8-slot server {sdec / swall:.1f} ({sdec} tokens in {swall:.3f} s), "
        f"same 16 turns")
    same12 = [i for i in ss if fleet_turns[i][:2] == single_turns[i][:2]]
    log(f"[fleet] bf16 turns 1-2 equal to the 8-slot server's in "
        f"{len(same12)}/8 sessions (co-batched neighbours differ); turn 3 of the "
        f"migrated sessions among them: "
        f"{agreement([fleet_turns[i][2] for i in on1 if i in same12], [single_turns[i][2] for i in on1 if i in same12])}")
    # teacher-forced: session `mig`'s conversation through turn 3 (on the
    # 8-slot server), its turn-3 tokens with a decode-built tail against a
    # re-prefilled one (what the journal replay rebuilt)
    d, agree = tail_vs_prefill(model, params, conv, shs[mig][0].request.prompt_tokens,
                               s3[mig][0].request.prompt_tokens, dev, paged=True)
    log(f"[fleet] bf16 migration, teacher-forced: turn-3 logits on a replayed "
        f"tail against a decoded one max_abs_diff={d:.3e} (tol 5e-2) "
        f"greedy_agreement={agree:.4f}")
    if not math.isfinite(d) or d > 5e-2:
        raise AssertionError(f"fleet: replayed-tail logits differ by {d}")
    del single, ss, shs, s3
    torch.cuda.empty_cache()

    # ---- 5. priority preemption on graph servers, dense and paged ---------
    prompts = [plan[i][0] for i in range(4)]
    sps = [SamplingParams(max_new_tokens=64) for _ in range(3)] + [
        SamplingParams(max_new_tokens=64, temperature=0.8, top_k=50, seed=7)]
    for mode in ("dense", "paged"):
        base, _, _ = preempt_run(cfg, params, dev, prompts, sps, mode, False)
        res, victims, pst = preempt_run(cfg, params, dev, prompts, sps, mode, True)
        vi, k = victims[0]
        vprompt = tok.encode(prompts[vi])
        plen = len(vprompt)
        seq = vprompt + base[vi]
        d, agree = tail_vs_prefill(model, params, seq, plen, plen + k, dev,
                                   paged=mode == "paged")
        log(f"[preempt-{mode}] bf16: victims (request, tokens) {victims} "
            f"preemptions={pst['preemptions']} resumes={pst['preempt_resumes']}; "
            f"agreement with the uninterrupted run "
            f"{agreement(res, base)}; teacher-forced "
            f"logits after a re-prefill at token {k} against decode max_abs_diff="
            f"{d:.3e} (tol 5e-2) greedy_agreement={agree:.4f}")
        if not math.isfinite(d) or d > 5e-2:
            raise AssertionError(f"preempt-{mode}: re-prefilled logits differ by {d}")
        torch.cuda.empty_cache()

    # ---- 6. journal restore into a fresh server ----------------------------
    path = ROOT / "build" / "fleet_journal.json"
    path.parent.mkdir(exist_ok=True)
    a = LLMServer(cfg, num_slots=4, capacity=2048, params=params, device=dev,
                  engine_cfg=EngineConfig(**FLEET_ECFG), journal_path=str(path))
    sa = a.open_session()
    sa.submit(plan[2][0], SamplingParams(max_new_tokens=32)).result()
    text = sa.text
    a.close()
    del a
    b = LLMServer(cfg, num_slots=4, capacity=2048, params=params, device=dev,
                  engine_cfg=EngineConfig(**FLEET_ECFG))
    sb = b.restore_sessions(str(path))[sa.sid]
    h = sb.submit(sb.text + plan[2][1][0], SamplingParams(max_new_tokens=32))
    h.result()
    check_graphs("restore", b, dict.fromkeys(graph_counts(b), 0))
    bst = b.stats()
    log(f"[restore] journal {path.name}: restored text equal {sb.text.startswith(text)}, "
        f"turn 2 {h.request.status} output_tokens={h.request.output_tokens} "
        f"turn_prefix_hits={bst['turn_prefix_hits']}")
    not_completed("restore", [h])
    if not sb.text.startswith(text):
        raise AssertionError("restore: the next turn did not complete")
    del b
    torch.cuda.empty_cache()

    # ---- 7. float32, full width, 4 layers: token identity ------------------
    fleet_f32_checks(cfg, dev, plan)

    counts = kernel_counts()
    log(f"[fleet] phase wall_s={time.perf_counter() - t_phase:.3f} "
        f"fleet gauges: routed={fleet_stats['routed_requests']} affinity="
        f"{fleet_stats['affinity_hits']} spilled={fleet_stats['spilled_admissions']} "
        f"migrated={fleet_stats['migrated_sessions']} per_replica_decode_tokens="
        f"{[p['decode_tokens'] if p else None for p in fleet_stats['per_replica']]}")
    return counts


# ---------------------------------------------------------------------------
# phase 12: training on the card
# ---------------------------------------------------------------------------


TRAIN_STEPS = 16
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = 4, 2048, 2
TRAIN_LOSS_DROP = 1.5       # the loss must fall by this over the steps
# lr 1e-4: at 1e-3 the first AdamW steps of the random 3 B init throw the
# loss from 6.94 to 11.2 and it settles at ~5.7, the uniform guess over the
# 256 data tokens, by step 11 (1.25 below its start)
TRAIN_LR = 1e-4


def train_data(cfg, dev, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    from repro_torch.training import data as tdata
    return tdata.SyntheticLM(tdata.DataConfig(global_batch=batch, seq_len=seq,
                                              vocab_size=256), cfg, device=dev)


def train_step_fn(cfg, lr=TRAIN_LR, accum=TRAIN_ACCUM):
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train_step as tts
    opt_cfg = topt.AdamWConfig(lr=lr, warmup_steps=3, total_steps=20)
    return opt_cfg, tts.make_train_step(cfg, tts.TrainConfig(
        opt=opt_cfg, accum_steps=accum))


def flash_train_row(dev, mb):
    """The flash forward kernel at the train step's shape (q
    [mb,2048,16,128], k/v [mb,2048,2,128], bf16, causal): against the plain
    version (bf16 2e-2); forward, plain, SDPA and bound times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    g = torch.Generator(device=dev).manual_seed(12)
    H, K, hd, S = 16, 2, 128, TRAIN_SEQ
    q, k, v = (torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
               for s in ((mb, S, H, hd), (mb, S, K, hd), (mb, S, K, hd)))
    kw = dict(q_per_kv=H // K)
    fa = lambda: kfa.flash_attention(q, k, v, **kw)                 # noqa: E731
    fr = lambda: kfa.flash_attention_ref(q, k, v, **kw)             # noqa: E731
    err = check_close(f"train flash fwd bf16 [{mb},{S},{H},{hd}]", fa(), fr(), "bfloat16")
    ms, plain = time_ms(fa, 20), time_ms(fr, 3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lf = lambda: F.scaled_dot_product_attention(                    # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    lib = time_ms(lf, 20)
    dms, lib_dms = graph_ms(fa), graph_ms(lf)
    log(f"[kernels] flash_attention_train: device_ms={dms:.4f}, library_device_ms="
        f"{lib_dms:.4f} (CUDA-graph replay)")
    b_ms, b_by = bound("flash", mb, S, S, H, K, hd, 2, S * (S + 1) // 2)
    return dict(
        name="flash_attention_train", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        replaces="src/repro/kernels/flash_attention.py:63",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib, device_ms=dms, library_device_ms=lib_dms)


def flash_bwd_row(dev, name, mb, S, H, K, hd, window=None):
    """The flash backward kernel at a train microbatch's shape (bf16,
    causal, optional window): the autograd.Function's gradients (forward
    kernel, backward kernel, launched once on wgmma_bwd) against autograd
    of the plain version (2e-2 relative to max(1, each gradient's largest
    value)); two backward calls bit-identical; the backward's call ms and
    device ms (CUDA-graph replay), the plain backward's ms, SDPA's backward
    call ms and device ms (a graph of its forward and backward less one of
    its forward), and the bound (``costs.flash_bwd`` at the bf16 rate); the
    ``[kernels]`` line adds the share of the bound the kernel reaches and
    its device ms over SDPA's backward's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import costs
    from repro_torch.kernels import flash_attention as kfa
    g = torch.Generator(device=dev).manual_seed(13)
    G = H // K
    q, k, v, do = (torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
                   for s in ((mb, S, H, hd), (mb, S, K, hd), (mb, S, K, hd), (mb, S, H, hd)))
    kw = dict(q_per_kv=G, window=window)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    before = kfa.launches_by_route["wgmma_bwd"]
    got = torch.autograd.grad(kfa.flash_attention(qg, kg, vg, **kw), (qg, kg, vg), do)
    torch.cuda.synchronize()
    if kfa.launches_by_route["wgmma_bwd"] != before + 1:
        raise AssertionError(f"{name}: the backward kernel did not launch once")
    want = torch.autograd.grad(kfa.flash_attention_ref(qg, kg, vg, **kw), (qg, kg, vg), do)
    err = 0.0
    for n, a, w in zip("qkv", got, want):
        scale = max(1.0, float(w.float().abs().max()))
        err = max(err, check_close(f"{name} d{n} [{mb},{S},{H},{hd}] K={K} window={window} "
                                   f"(scaled by {scale:.3g})", a.float() / scale,
                                   w.float() / scale, "bfloat16"))
    del got, want, qg, kg, vg
    o, lse = kfa._forward(q, k, v, with_lse=True, **kw)
    bwd = lambda: kfa._launch_bwd(q, k, v, o, do, lse, G, window, 0)   # noqa: E731
    first, second = bwd(), bwd()
    if not all(torch.equal(x, y) for x, y in zip(first, second)):
        raise AssertionError(f"{name}: two backward calls on the same inputs differ")
    del first, second
    ms, dms = time_ms(bwd, 20), graph_ms(bwd)
    plain = time_ms(lambda: kfa.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw), 3,
                    warmup=1)
    if window is not None and window < S:
        raise AssertionError(f"{name}: SDPA's yardstick here is causal only")
    qs, ks, vs = (t.detach().clone().transpose(1, 2).requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(                  # noqa: E731
        qs, ks, vs, is_causal=True, enable_gqa=True)
    out = sdpa()
    lib = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dot, retain_graph=True), 10)
    del out
    lib_fb = graph_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), dot))
    lib_dms = lib_fb - graph_ms(sdpa)
    pairs = costs.flash_pairs(S, window=window)
    b_ms, b_by = bound("flash_bwd", mb, S, S, H, K, hd, 2, pairs, "bf16")
    log(f"[kernels] {name} at [{mb},{S},{H},{hd}] K={K} window={window}: {ms:.4f} ms a "
        f"call, {dms:.4f} device ms (CUDA-graph replay; split "
        f"{kfa.bwd_splits(mb, S, K, G, hd, torch.bfloat16)}), bound {b_ms:.4f} by {b_by} "
        f"({b_ms / dms:.1%} of it reached); plain (written-out float32) {plain:.4f} ms; "
        f"SDPA backward {lib:.4f} ms a call, {lib_dms:.4f} device ms (forward + backward "
        f"graph {lib_fb:.4f} less the forward's; the kernel at {dms / lib_dms:.3f}x it); "
        f"two calls bit-identical")
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
        replaces="src/repro/kernels/flash_attention.py:63",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib, device_ms=dms, library_device_ms=lib_dms)


def profile_train_step(step, params, opt, batch, ranges=("flash_attention_bwd",),
                       kernels=("flash_wgmma", "flash_bwd")):
    """One train step under torch.profiler. Returns (params, opt, a dict):
    ``wall_ms`` of the profiled step; ``kernel_ms``, every kernel's self
    time; for each name of ``ranges`` (the ``record_function`` ranges of
    the backwards), ``busy[name]``, the kernels launched inside
    it, ``span[name]``, the device timeline it spans, idle gaps included,
    and ``host[name]``, its host time; ``metrics``, the step's; for each
    substring of ``kernels``, ``by_kernel[sub]``, the
    self time of the kernels whose name holds it; ``top``, the heaviest
    kernels; ``range_kernels[name]``, for each call of the range, the names
    of the device activities launched inside it (kernels, and memsets as
    "Memset ...")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    launched = [e for e in ev if e.device_type == DeviceType.CUDA and e.key not in ranges]

    def under(e):               # the device activities of e and its children
        return [k.name for k in e.kernels] + [n for c in e.cpu_children for n in under(c)]

    calls = {r: [under(e) for e in prof.events()
                 if e.name == r and e.device_type == DeviceType.CPU] for r in ranges}
    out = dict(
        wall_ms=wall,
        kernel_ms=sum(e.self_device_time_total for e in launched) / 1e3,
        busy={r: sum(e.device_time_total for e in ev
                     if e.key == r and e.device_type == DeviceType.CPU) / 1e3
              for r in ranges},
        span={r: sum(e.self_device_time_total for e in ev
                     if e.key == r and e.device_type == DeviceType.CUDA) / 1e3
              for r in ranges},
        host={r: sum(e.cpu_time_total for e in ev
                     if e.key == r and e.device_type == DeviceType.CPU) / 1e3
              for r in ranges},
        metrics=metrics,
        by_kernel={k: sum(e.self_device_time_total for e in launched if k in e.key) / 1e3
                   for k in kernels},
        top=[(e.key.replace("(anonymous namespace)::", "").split("(")[0][:60],
              e.self_device_time_total / 1e3, e.count)
             for e in sorted(launched, key=lambda e: -e.self_device_time_total)[:6]],
        range_kernels=calls)
    return params, opt, out


def train_grad_checks(dev):
    """Reduced qwen configs (4 layers, d_model 256, 4 / 2 heads of 64), one
    step's loss and gradients through the kernel path against the same
    step with the model's attention replaced by the plain version under
    autograd, on the card: float32 (2e-5 on the loss, 1e-4 relative to
    each gradient leaf's largest value, the CPU tests' bounds) and bf16
    (2e-2 on both); GQA causal and a sliding window of 48."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import Model
    from repro_torch.models import transformer as tfm
    from repro_torch.training import data as tdata
    from repro_torch.training import train_step as tts
    tols = {"float32": (1e-4, 2e-5), "bfloat16": (2e-2, 2e-2)}   # (grads, loss)
    for window in (None, 48):
        for dt in ("float32", "bfloat16"):
            cfg = ARCHS["qwen2.5-3b"].reduced(
                dtype=dt, param_dtype=dt, vocab_size=512, num_layers=4, d_model=256,
                num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512,
                sliding_window=window)
            params = Model(cfg, device=dev).init(seed=3, trainable=True)
            batch = tdata.SyntheticLM(tdata.DataConfig(global_batch=2, seq_len=256,
                                                       vocab_size=cfg.vocab_size),
                                      cfg, device=dev).batch_at(1)
            before, bwd0 = kfa.launches, dict(kfa.launches_by_route)
            loss, _, grads = tts.loss_and_grads(params, batch, cfg)
            grads = {n: g.float().clone() for n, g in grads.items()}
            launched = kfa.launches - before
            route = kfa.BWD_ROUTES[getattr(torch, dt)]
            bwd = kfa.launches_by_route[route] - bwd0[route]
            real = tfm.flash_attention
            tfm.flash_attention = kfa.flash_attention_ref
            try:
                loss_p, _, grads_p = tts.loss_and_grads(params, batch, cfg)
            finally:
                tfm.flash_attention = real
            tol, loss_tol = tols[dt]
            worst = max(float((grads[n] - g.float()).abs().max())
                        / max(float(g.float().abs().max()), 1e-30)
                        for n, g in grads_p.items())
            dl = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
            log(f"[train] kernel path vs plain autograd, {dt}, window={window}, GQA "
                f"4/2: flash launches {launched} (3 x {cfg.num_layers} layers: forward, "
                f"recompute, backward; {bwd} on {route}), loss rel diff {dl:.3e} (tol "
                f"{loss_tol}), worst grad leaf rel diff {worst:.3e} (tol {tol})")
            if launched != 3 * cfg.num_layers or bwd != cfg.num_layers \
                    or not dl <= loss_tol or not worst <= tol:
                raise AssertionError(f"train: kernel-path grads differ ({dt}, "
                                     f"window={window})")
            del params, grads, grads_p


def train_resume_check(dev):
    """qwen2.5-3b at its published widths and 2 of 36 layers (the cut keeps
    the checkpoint small: at 36 layers (params, OptState) is ~31 GB), bf16:
    3 steps, an async save of (params, OptState) under build/, 3 more
    steps; then fresh params restored from the checkpoint run the same 3
    steps. Losses and params against the uninterrupted run; the loss falls
    over the 6 steps. Save / restore seconds and bytes printed, the
    directory deleted. Returns the ledger of the run."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import AsyncCheckpointer, restore
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import Model
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train_step as tts

    cfg = dataclasses.replace(ARCHS["qwen2.5-3b"], num_layers=2)
    data = train_data(cfg, dev)
    _, step = train_step_fn(cfg)
    params = Model(cfg, device=dev).init(seed=0, trainable=True)
    opt = topt.init_opt_state(params)
    losses = []
    for i in range(3):
        params, opt, m = step(params, opt, data.batch_at(i))
        losses.append(float(m["loss"]))
    (ROOT / "build").mkdir(exist_ok=True)
    d = tempfile.mkdtemp(prefix="train-ckpt-", dir=ROOT / "build")
    try:
        ck = AsyncCheckpointer(d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(3, tts.state_to_jax(params, opt, cfg))
        host_s = time.perf_counter() - t0
        for i in range(3, 6):
            params, opt, m = step(params, opt, data.batch_at(i))
            losses.append(float(m["loss"]))
        ck.wait()
        save_s = time.perf_counter() - t0
        files = [f for f in Path(d).rglob("*") if f.is_file()]
        nbytes = sum(f.stat().st_size for f in files)
        want = {n: p.detach().clone() for n, p in params.named_parameters()}
        del params, opt
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = Model(cfg, device=dev).init(seed=1, trainable=True)
        tree, at = restore(d, tts.state_to_jax(fresh, topt.init_opt_state(fresh), cfg))
        params, opt = tts.state_from_jax(tree, fresh, cfg)
        del tree
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        resumed = []
        for i in range(3, 6):
            params, opt, m = step(params, opt, data.batch_at(i))
            resumed.append(float(m["loss"]))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    same = all(torch.equal(p.detach(), want[n]) for n, p in params.named_parameters())
    dparam = max(float((p.detach().float() - want[n].float()).abs().max())
                 for n, p in params.named_parameters())
    dloss = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[3:]))
    log(f"[train-resume] {cfg.name} 2 of 36 layers, bf16: {len(files)} files, "
        f"{nbytes} bytes ({gb(nbytes)} GB); save_s={save_s:.3f} (host copy "
        f"{host_s:.3f}, 3 steps ran meanwhile) restore_s={restore_s:.3f} "
        f"(step {at}); losses {[round(x, 4) for x in losses]}, resumed "
        f"{[round(x, 4) for x in resumed]}; bit-identical params and losses: "
        f"{same and resumed == losses[3:]} (max param diff {dparam:.3e}, max loss "
        f"rel diff {dloss:.3e})")
    # bit-identical is the expectation (no atomics on the path: the embedding
    # backward sorts); otherwise the resumed run must stay within 1e-3
    if at != 3 or not dloss <= 1e-3 or not losses[-1] < losses[0]:
        raise AssertionError("train: the resumed run departs from the "
                             "uninterrupted one, or the loss did not fall")
    del params, opt, want


def train_phase(dev, card):
    """qwen2.5-3b at its published width and depth (36 layers, bf16,
    random weights from seed 0, remat full), SyntheticLM batches of 4 x
    2048 tokens (data vocab 256), AdamW(lr 1e-4, warmup 3, total 20),
    accumulation over 2 microbatches, 16 steps: per-step loss, grad norm,
    lr, wall ms and tokens/s; flash forward launches == 2 x layers x
    microbatches x steps (forward and recompute) on wgmma and backward
    launches == layers x microbatches x steps on wgmma_bwd; the loss falls
    by >= 1.5; peak memory; a step split into forward + backward and
    optimizer; one profiled step (the flash backward kernels' device ms per
    layer and their share); the 8·N·T FLOP share of the bf16 peak. Then
    the flash kernels at the train shape, the kernel path's gradients
    against plain autograd at reduced configs, and a save / restore /
    resume. Returns (the kernel rows, the launch counts of the training
    steps)."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import Model
    from repro_torch.training import optimizer as topt

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ARCHS["qwen2.5-3b"]
    if cfg.remat_policy != "full" or cfg.dtype != "bfloat16":
        raise AssertionError(f"train: {cfg.name} is not bf16 with remat full")
    params = Model(cfg, device=dev).init(seed=0, trainable=True)
    n_params = sum(p.numel() for p in params.parameters())
    data = train_data(cfg, dev)
    opt_cfg, step = train_step_fn(cfg)
    opt = topt.init_opt_state(params)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[train] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size} (padded {cfg.padded_vocab}), tied={cfg.tie_embeddings}, "
        f"{n_params} params, bf16, remat {cfg.remat_policy}; batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens in {TRAIN_ACCUM} microbatches, {TRAIN_STEPS} steps")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, walls = [], []
    for i in range(TRAIN_STEPS):
        batch = data.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        losses.append(loss)
        walls.append(wall)
        log(f"[train] step {i:2d} loss={loss:.4f} grad_norm={float(m['grad_norm']):.4f} "
            f"lr={float(m['lr']):.3e} wall_ms={wall:.2f} tok/s={tokens / wall * 1e3:.1f}")
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    want = 2 * cfg.num_layers * TRAIN_ACCUM * TRAIN_STEPS
    want_bwd = cfg.num_layers * TRAIN_ACCUM * TRAIN_STEPS
    log(f"[train] flash launches {counts['flash_attention']}: forward on wgmma "
        f"{counts['flash_attention/wgmma']} (2 x {cfg.num_layers} layers x {TRAIN_ACCUM} "
        f"microbatches x {TRAIN_STEPS} steps = {want}), backward on wgmma_bwd "
        f"{counts['flash_attention/wgmma_bwd']} ({want_bwd}); other kernels "
        f"{ {k: n for k, n in counts.items() if n and not k.startswith('flash')} }; "
        f"peak memory {gb(peak)} GB; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    TRAIN_RECORD.update(tok_s=tokens / statistics.median(walls[1:]) * 1e3, peak=peak)
    if counts["flash_attention"] != want + want_bwd or \
            counts["flash_attention/wgmma"] != want or \
            counts["flash_attention/wgmma_bwd"] != want_bwd:
        raise AssertionError(f"train: flash launches {counts} break the rule "
                             f"({want} forward, {want_bwd} backward)")
    if any(n for k, n in counts.items() if not k.startswith("flash")):
        raise AssertionError("train: a kernel other than flash launched")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] <= losses[0] - TRAIN_LOSS_DROP:
        raise AssertionError(f"train: the loss did not fall by {TRAIN_LOSS_DROP}: "
                             f"{losses}")

    # ---- one step split: forward + backward (both microbatches), optimizer
    from repro_torch.training.optimizer import adamw_update
    batch = data.batch_at(TRAIN_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, grads = step.loss_and_grads(params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params, opt, _ = adamw_update(opt_cfg, params, grads, opt)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads
    fb_ms, opt_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    # ---- one profiled step
    params, opt, prof = profile_train_step(step, params, opt,
                                           data.batch_at(TRAIN_STEPS + 1))
    n_bwd = cfg.num_layers * TRAIN_ACCUM
    step_s = statistics.median(walls[2:]) / 1e3
    flops = 8 * n_params * tokens
    log(f"[train] step split (step {TRAIN_STEPS}): forward + backward {fb_ms:.2f} ms, "
        f"optimizer {opt_ms:.2f} ms; median step wall {step_s * 1e3:.2f} ms "
        f"({tokens / step_s:.1f} tok/s, steps 2-{TRAIN_STEPS - 1})")
    busy, span = prof["busy"]["flash_attention_bwd"], prof["span"]["flash_attention_bwd"]
    if busy > 0:
        share = (f"flash backward kernels (flash_attention_bwd range) {busy:.2f} device ms = "
                 f"{busy / n_bwd:.3f} per layer and microbatch ({n_bwd} calls), "
                 f"{100 * busy / prof['kernel_ms']:.1f}% of the kernel time; its "
                 f"ranges span {span:.2f} ms of the device timeline "
                 f"({100 * span / prof['wall_ms']:.1f}% of the step's wall)")
    else:
        share = "flash_attention_bwd: not measured (no device time in its range)"
    log(f"[train] profiled step: wall {prof['wall_ms']:.2f} ms, kernels "
        f"{prof['kernel_ms']:.2f} device ms (device idle "
        f"{100 * (1 - prof['kernel_ms'] / prof['wall_ms']):.1f}%); {share}; flash "
        f"forward kernels {prof['by_kernel']['flash_wgmma']:.2f} device ms, backward "
        f"kernels by name {prof['by_kernel']['flash_bwd']:.2f} device ms")
    for name, ms, n in prof["top"]:
        log(f"[train]   top kernel {ms:9.2f} ms / {n:5d} calls  {name}")
    log(f"[train] 8·N·T = {flops:.4e} FLOP a step (N={n_params}, T={tokens}, remat "
        f"full) in {step_s:.4f} s: {flops / step_s / 1e12:.1f} TFLOP/s = "
        f"{100 * flops / step_s / PEAK_BF16:.2f}% of the 989 TFLOP/s bf16 peak; "
        f"card {card}")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()

    mb = TRAIN_BATCH // TRAIN_ACCUM
    fwd = flash_train_row(dev, mb)
    bwd = flash_bwd_row(dev, "flash_attention_bwd", mb, TRAIN_SEQ, 16, 2, 128)
    # the train row carries its backward's columns too
    fwd.update(backward_ms=bwd["ms"], backward_device_ms=bwd["device_ms"],
               backward_bound_ms=bwd["bound_ms"], plain_backward_ms=bwd["plain_ms"],
               library_backward_ms=bwd["library_ms"],
               library_backward_device_ms=bwd["library_device_ms"])
    rows = {"flash_attention_train": fwd, "flash_attention_bwd": bwd}
    train_grad_checks(dev)
    train_resume_check(dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] phase wall_s={time.perf_counter() - t_phase:.3f}")
    return rows, counts


# ---------------------------------------------------------------------------
# phase 14: training the stateful families
# ---------------------------------------------------------------------------


# arch: layers (None: the published depth), batch x seq tokens a step in
# accum microbatches, AdamW lr, steps (the last two are the split step and
# the profiled one)
STATEFUL_TRAIN = {
    # 6 of 38 layers, two periods of (recurrent, recurrent, local attention):
    # 3.28 B params, ~52 GB of params, grads, float32 accumulation and AdamW
    # moments at 16 bytes a param, 71.3 GB at the peak on an H100 80GB
    "recurrentgemma-9b": dict(layers=6, batch=4, seq=2048, accum=2, lr=1e-4, steps=8),
    # whole (21 mLSTM, 3 sLSTM). lr 3e-3: at 1e-4 the loss moved 10.822 ->
    # 10.771 in 8 steps on an H100; 8 layers at the published widths in
    # float32 on the CPU fell by 0.06 at 1e-4, 0.86 at 1e-3 and 5.3 at 3e-3
    # in 8 steps; at 3e-3 the loss fell 10.82 -> 8.00 in 4 (H100, with the
    # sLSTM as a host loop of ~20 operators a position, ~14 s a step; the
    # sLSTM kernels keep the arithmetic)
    "xlstm-350m": dict(layers=None, batch=4, seq=1024, accum=1, lr=3e-3, steps=4),
}
STATEFUL_LOSS_DROP = 0.5
STATEFUL_TRAIN_S = 150      # the phase's time budget (seconds)
STATEFUL_RANGES = ("rglru_scan_bwd", "flash_attention_bwd", "slstm_scan_bwd")
STATEFUL_KERNELS = ("rglru_scan", "mlstm_", "mlstm_bwd", "flash_wgmma", "flash_bwd",
                    "slstm_fwd", "slstm_bwd")
XLSTM_BWD = {}              # phase 14's mLSTM backward launches a step, for dryrun


def stateful_train_launches(cfg, accum, steps):
    """The launch rule of a train run under remat "full": a layer of a
    scanned period runs its forward twice (forward and recompute), a tail
    layer once; each adds one launch of its backward kernel (counted apart
    too, as ``"rglru_scan/chunked_bwd"``, ``"flash_attention/wgmma_bwd"``,
    ``"mlstm_chunk/wgmma_bwd"`` and ``"slstm_scan/cluster_bwd"``). Per
    microbatch and step."""
    scanned = len(cfg.pattern) * cfg.num_scan_groups
    bwd = {"rglru_scan": "chunked_bwd", "mlstm_chunk": "wgmma_bwd",
           "flash_attention": "wgmma_bwd", "slstm_scan": "cluster_bwd"}
    want = dict.fromkeys(list(bwd) + [f"{k}/{r}" for k, r in bwd.items()], 0)
    kernel = {"recurrent": "rglru_scan", "mlstm": "mlstm_chunk",
              "local_attn": "flash_attention", "attn": "flash_attention",
              "slstm": "slstm_scan"}
    for i, kind in enumerate(cfg.layer_kinds):
        if kind in kernel:
            name = kernel[kind]
            want[name] += (2 if i < scanned else 1) + 1
            want[f"{name}/{bwd[name]}"] += 1
    return {k: n * accum * steps for k, n in want.items()}


def stateful_train_run(dev, card, arch):
    """One arch of ``STATEFUL_TRAIN`` trained its steps
    (bf16, random weights from seed 0, remat full, SyntheticLM, AdamW):
    per-step loss, grad norm, wall and tok/s; launches against
    ``stateful_train_launches``; peak memory; the second-last step split
    into forward + backward and optimizer; the last step under the
    profiler (the backwards' busy and host ms, the stateful, sLSTM and
    flash kernels' device ms); the 8·N·T share. Returns the launch
    counts."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import Model
    from repro_torch.training import optimizer as topt
    from repro_torch.training.optimizer import adamw_update

    run = STATEFUL_TRAIN[arch]
    batch, seq, accum = run["batch"], run["seq"], run["accum"]
    cfg = ARCHS[arch] if run["layers"] is None else dataclasses.replace(
        ARCHS[arch], num_layers=run["layers"])
    if cfg.remat_policy != "full" or cfg.dtype != "bfloat16":
        raise AssertionError(f"stateful_train: {arch} is not bf16 with remat full")
    gc.collect()
    torch.cuda.empty_cache()
    params = Model(cfg, device=dev).init(seed=0, trainable=True)
    n_params = sum(p.numel() for p in params.parameters())
    data = train_data(cfg, dev, batch, seq)
    opt_cfg, step = train_step_fn(cfg, run["lr"], accum)
    opt = topt.init_opt_state(params)
    tokens = batch * seq
    tag = f"[stateful_train] {arch}"
    log(f"{tag}: {cfg.num_layers} of {ARCHS[arch].num_layers} layers "
        f"{dict(collections.Counter(cfg.layer_kinds))}, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {n_params} params, bf16, remat {cfg.remat_policy}; batch "
        f"{batch} x {seq} tokens in {accum} microbatch(es), {run['steps']} "
        f"steps, lr {run['lr']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, norms, walls = [], [], []
    n = run["steps"]
    prof = None
    for i in range(n):
        b = data.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == n - 2:          # split: forward + backward, then the optimizer
            loss, _, grads = step.loss_and_grads(params, b)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, opt, m = adamw_update(opt_cfg, params, grads, opt)
            del grads
            m["loss"] = loss
            torch.cuda.synchronize()
            split = ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)
        elif i == n - 1:            # under the profiler
            params, opt, prof = profile_train_step(step, params, opt, b,
                                                   STATEFUL_RANGES, STATEFUL_KERNELS)
            m = prof["metrics"]
        else:
            params, opt, m = step(params, opt, b)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        losses.append(loss)
        norms.append(norm)
        walls.append(wall)
        log(f"{tag} step {i} loss={loss:.4f} grad_norm={norm:.4f} wall_ms={wall:.2f} "
            f"tok/s={tokens / wall * 1e3:.1f}"
            + {n - 2: " (split)", n - 1: " (profiled)"}.get(i, ""))
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    want = stateful_train_launches(cfg, accum, n)
    log(f"{tag}: launches { {k: c for k, c in counts.items() if c} } (rule {want}); "
        f"peak memory {gb(peak)} GB; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    # each kernel's launches all on its train routes
    routed = {"rglru_scan": ("chunked", "chunked_bwd"),
              "mlstm_chunk": ("wgmma", "wgmma_bwd"),
              "flash_attention": ("wgmma", "wgmma_bwd"),
              "slstm_scan": ("cluster", "cluster_bwd")}
    others = {k: c for k, c in counts.items() if c and "/" not in k and k not in want}
    if any(counts[k] != c for k, c in want.items()) or others or any(
            sum(counts[f"{k}/{r}"] for r in rs) != want[k] for k, rs in routed.items()):
        raise AssertionError(f"stateful_train: {arch} launches {counts} break the "
                             f"rule {want}")
    if not all(math.isfinite(x) for x in losses + norms) or \
            not losses[-1] <= losses[0] - STATEFUL_LOSS_DROP:
        raise AssertionError(f"stateful_train: {arch} loss did not fall by "
                             f"{STATEFUL_LOSS_DROP} (or is not finite): {losses} {norms}")
    n_mb = want["mlstm_chunk/wgmma_bwd"] // n
    if n_mb:
        XLSTM_BWD[arch] = n_mb
        log(f"{tag}: mLSTM backward kernel {n_mb} launches a step on wgmma_bwd "
            f"({counts['mlstm_chunk/wgmma_bwd']} in {n} steps), the plain "
            "mlstm_chunk_bwd none")

    first = min(2, n - 3)       # the median over the steps before the split one
    step_ms = statistics.median(walls[first:n - 2])
    flops = 8 * n_params * tokens
    log(f"{tag} step split: forward + backward {split[0]:.2f} ms, optimizer "
        f"{split[1]:.2f} ms; median step wall {step_ms:.2f} ms ({tokens / step_ms * 1e3:.1f} "
        f"tok/s, steps {first}-{n - 3})")
    if prof is not None:
        log(f"{tag} profiled step: wall {prof['wall_ms']:.2f} ms, kernels "
            f"{prof['kernel_ms']:.2f} device ms (device idle "
            f"{100 * (1 - prof['kernel_ms'] / prof['wall_ms']):.1f}%)")
        per = {"rglru_scan_bwd": ("RG-LRU gradient kernel", want["rglru_scan/chunked_bwd"]),
               "flash_attention_bwd": ("flash backward kernel",
                                       want["flash_attention/wgmma_bwd"]),
               "slstm_scan_bwd": ("sLSTM gradient kernel",
                                  want["slstm_scan/cluster_bwd"])}
        kernel_ms = prof["kernel_ms"] or math.nan
        for r in STATEFUL_RANGES:
            what, calls = per[r][0], per[r][1] // n
            if calls:
                busy, hms = prof["busy"][r], prof["host"][r]
                log(f"{tag}   {what} ({r}, {calls} calls): busy {busy:.3f} device ms "
                    f"({busy / calls:.4f} a call, {100 * busy / kernel_ms:.1f}% of the "
                    f"kernel time); host {hms:.2f} ms inside the range "
                    f"({100 * hms / prof['wall_ms']:.1f}% of the profiled wall)")
        # each call of the gradient's range holds one kernel, the gradient
        # kernel (its carry words' memset aside): no flip, cat or cast pass
        n_bwd = want["rglru_scan/chunked_bwd"] // n
        if n_bwd:
            got = prof["range_kernels"]["rglru_scan_bwd"]
            kern = [[k for k in ks if not k.startswith("Memset")] for ks in got]
            log(f"{tag}   rglru_scan_bwd range: {len(got)} calls (rule {n_bwd}), kernels a "
                f"call {sorted({len(k) for k in kern})}, "
                f"{sorted({k.split('(')[0][-40:] for ks in got for k in ks})}")
            if len(got) != n_bwd or any(len(k) != 1 or "rglru_scan_chunked_bwd" not in k[0]
                                        for k in kern):
                raise AssertionError(f"stateful_train: the rglru_scan_bwd ranges hold {got}, "
                                     f"not one gradient kernel in each of {n_bwd} calls")
        # likewise the sLSTM's: one gradient kernel a call, no loop of
        # operators (dR's product follows outside the range)
        n_sbwd = want["slstm_scan/cluster_bwd"] // n
        if n_sbwd:
            got = prof["range_kernels"]["slstm_scan_bwd"]
            names = {k.replace("(anonymous namespace)::", "").split("(")[0][-40:]
                     for ks in got for k in ks}
            log(f"{tag}   slstm_scan_bwd range: {len(got)} calls (rule {n_sbwd}), "
                f"{sorted(names)}")
            if len(got) != n_sbwd or any(len(k) != 1 or "slstm_bwd" not in k[0] for k in got):
                raise AssertionError(f"stateful_train: the slstm_scan_bwd ranges hold {got}, "
                                     f"not one gradient kernel in each of {n_sbwd} calls")
        for k, ms in prof["by_kernel"].items():
            if ms:
                log(f"{tag}   kernels '{k}*': {ms:.3f} device ms")
        for name, ms, c in prof["top"]:
            log(f"{tag}   top kernel {ms:9.2f} ms / {c:5d} calls  {name}")
    log(f"{tag} 8·N·T = {flops:.4e} FLOP a step (N={n_params}, T={tokens}) in "
        f"{step_ms / 1e3:.4f} s: {flops / step_ms / 1e9:.1f} TFLOP/s = "
        f"{100 * flops / step_ms * 1e3 / PEAK_BF16:.2f}% of the 989 TFLOP/s bf16 peak; "
        f"card {card}")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return counts


SPREAD_CAP = 0.1           # the most a leaf's bound may take from its spread


@contextlib.contextmanager
def call_records(recs):
    """Records each ``rglru_scan``, ``mlstm_chunk`` and ``slstm_scan`` call of a model's
    train step whose output the backward reaches: the kernel, its arguments
    (tensors detached and copied) and the gradient that arrives at its
    output, appended to ``recs`` as dicts. Calls whose output no gradient
    reaches (a remat recompute's: the backward runs through the forward's
    graph) are left out."""
    import torch
    from repro_torch.models import rglru as trg
    from repro_torch.models import xlstm as txl
    from repro_torch.kernels import slstm_scan as kss
    taps = ((trg, "rglru_scan"), (txl, "mlstm_chunk"), (kss, "slstm_scan"))
    real = [(mod, name, getattr(mod, name)) for mod, name in taps]

    def tap(fn, kernel):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if torch.is_grad_enabled() and out[0].requires_grad:
                rec = dict(kernel=kernel, kw=kw, args=[
                    t.detach().clone() if isinstance(t, torch.Tensor) else t for t in args])
                out[0].register_hook(lambda g: rec.__setitem__("dout", g.detach().clone()))
                recs.append(rec)
            return out
        return call

    for mod, name, fn in real:
        setattr(mod, name, tap(fn, name))
    try:
        yield
    finally:
        for mod, name, fn in real:
            setattr(mod, name, fn)
        recs[:] = [r for r in recs if "dout" in r]


def call_check(rec, tol):
    """One recorded call (``call_records``) run again alone through the
    kernel's wrapper under autograd (the kernel forward, the Function's
    backward) and through its plain version under autograd, on the same
    inputs and output gradient: the largest relative difference (to the
    plain value's largest) of the output and of each differentiable input's
    gradient (rglru_scan: a, bx; mlstm_chunk: q, k, v, ig, fg; slstm_scan:
    gates_x, r_gates), and those past ``tol``. The sLSTM's plain loop runs
    on float32 copies of its inputs: autograd through the bf16 loop adds
    each step's bf16 dR in bf16, the kernel path forms dR in one product
    with float32 sums (``slstm_kernel_rows`` prints the two apart)."""
    import torch
    from repro_torch.kernels import mlstm_chunk as kmc
    from repro_torch.kernels import rglru_scan as krs
    from repro_torch.kernels import slstm_scan as kss
    kernel, ref, names = {
        "rglru_scan": (krs.rglru_scan, krs.rglru_scan_ref, ("a", "bx")),
        "mlstm_chunk": (kmc.mlstm_chunk, kmc.mlstm_chunk_ref, ("q", "k", "v", "ig", "fg")),
        "slstm_scan": (kss.slstm_scan, lambda gx, r, *a, **kw: kss.slstm_scan_ref(
            gx.float(), r.float(), *a, **kw), ("gates_x", "r_gates")),
    }[rec["kernel"]]
    errs = {}
    outs = []
    for fn in (kernel, ref):
        ins = [t.clone().requires_grad_() for t in rec["args"][:len(names)]]
        out = fn(*ins, *rec["args"][len(names):], **rec["kw"])[0]
        outs.append([out.detach()] + list(torch.autograd.grad(out, ins, rec["dout"])))
    for name, got, want in zip(("out",) + names, *outs):
        errs[name] = float((got.float() - want.float()).abs().max()) / max(
            float(want.float().abs().max()), 1e-30)
    return errs, [(rec["kernel"], n, e) for n, e in errs.items() if not e <= tol]


def stateful_grad_checks(dev):
    """Reduced recurrentgemma-9b (5 layers: one period and the two tail
    recurrent layers; d_model 256, 4 heads of 64 over one KV head, window
    48) and xlstm-350m (8 layers, d_model 128, mLSTM heads of 64, chunk
    64), float32 and bf16: one step through the kernel path against the
    same step with the kernels swapped for their plain versions under
    autograd, on the card; bounds float32 1e-4 (loss 2e-5) and bf16 2e-2,
    relative to the largest value, as ``train_grad_checks``:

    * every ``rglru_scan``, ``mlstm_chunk`` and ``slstm_scan`` call of the kernel-path
      step, on the inputs and output gradient it had there
      (``call_records``, ``call_check``): its output and its inputs'
      gradients, kernel against plain, at the bound;
    * the loss, at its bound;
    * each param leaf, at the bound or at 4x the plain path's own spread
      where that is larger, as in the CPU tests
      (tests/test_torch_training.py ``_spread``), never above
      ``SPREAD_CAP`` (a zeroed or sign-flipped gradient is off by 1 or
      more): in float32 the spread is the largest relative change of the
      leaf's gradient when every param moves by a random 1e-7 of itself,
      in bf16 its distance from the plain path run in float32 on the same
      weights. A leaf whose spread alone reaches ``SPREAD_CAP`` is printed,
      not held: the plain path's own bf16 gradient there is further from
      float32 than the cap, so a comparison of two bf16 runs cannot tell a
      fault from rounding; the call checks hold its kernels. Reduced xlstm
      in bf16 is such a model: two bf16 steps whose first mLSTM outputs
      differ by 7e-4 reach the seventh call with inputs 21% apart and
      output gradients up to 108% apart, while each call alone agrees to
      3.4e-3 (output) and 2.8e-4 (gradients) (H100)."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import mlstm_chunk as kmc
    from repro_torch.kernels import rglru_scan as krs
    from repro_torch.kernels import slstm_scan as kss
    from repro_torch.models import Model
    from repro_torch.models import rglru as trg
    from repro_torch.models import transformer as tfm
    from repro_torch.models import xlstm as txl
    from repro_torch.training import train_step as tts
    tols = {"float32": (1e-4, 2e-5), "bfloat16": (2e-2, 2e-2)}   # (grads, loss)
    shapes = {"recurrentgemma-9b": dict(d_model=256, num_heads=4, num_kv_heads=1,
                                        head_dim=64, d_ff=512, rglru_dim=256,
                                        local_window=48),
              "xlstm-350m": dict(d_model=128, mlstm_chunk=64)}
    plain = ((tfm, "flash_attention", kfa.flash_attention_ref),
             (trg, "rglru_scan", krs.rglru_scan_ref),
             (txl, "mlstm_chunk", kmc.mlstm_chunk_ref),
             (kss, "slstm_scan", kss.slstm_scan_ref))

    def rel(a, w):
        return float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)

    def worst(rows, what):      # the three worst of (err, name, bound or spread)
        return [(n, f"{e:.3e}", f"{what} {x:.3e}")
                for e, n, x in sorted(rows, reverse=True)[:3]]

    for arch, over in shapes.items():
        for dt in ("float32", "bfloat16"):
            cfg = ARCHS[arch].reduced(dtype=dt, param_dtype=dt, vocab_size=512, **over)
            params = Model(cfg, device=dev).init(seed=3, trainable=True)
            b = train_data(cfg, dev, 2, 256).batch_at(1)
            reset_counts()
            recs = []
            with call_records(recs):
                loss, _, grads = tts.loss_and_grads(params, b, cfg)
            grads = {n: g.float().clone() for n, g in grads.items()}
            launched = {k: n for k, n in kernel_counts().items() if n and "/" not in k}
            real = [(mod, name, getattr(mod, name)) for mod, name, _ in plain]
            gen = torch.Generator(device=dev).manual_seed(1)
            if dt == "float32":         # the plain path on params moved by 1e-7
                mcfg, moved = cfg, {n: p.detach() * (1 + 1e-7 * torch.randn(
                    p.shape, generator=gen, device=dev))
                    for n, p in params.named_parameters()}
            else:                       # the plain path in float32
                mcfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
                moved = {n: p.detach().float() for n, p in params.named_parameters()}
            moved = Model(mcfg, device=dev).load(moved, trainable=True)
            try:
                for mod, name, fn in plain:
                    setattr(mod, name, fn)
                loss_p, _, grads_p = tts.loss_and_grads(params, b, cfg)
                grads_p = {n: g.float().clone() for n, g in grads_p.items()}
                _, _, grads_m = tts.loss_and_grads(moved, b, mcfg)
            finally:
                for mod, name, fn in real:
                    setattr(mod, name, fn)
            tol, loss_tol = tols[dt]
            bad, held, loose = [], [], []
            for n, g in grads_p.items():
                spread, err = rel(grads_m[n].float(), g), rel(grads[n], g)
                if spread >= SPREAD_CAP:
                    loose.append((err, n, spread))
                    continue
                lim = max(tol, min(4 * spread, SPREAD_CAP))
                held.append((err, n, lim))
                if not err <= lim:
                    bad.append((n, err, lim))
            calls = []
            for rec in recs:
                errs, past = call_check(rec, tol)
                calls.append((max(errs.values()), rec["kernel"], errs))
                bad += past
            if len(recs) != sum(1 for k in cfg.layer_kinds
                                if k in ("recurrent", "mlstm", "slstm")):
                bad.append(("calls recorded", len(recs)))
            dl = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
            want = {k: n for k, n in stateful_train_launches(cfg, 1, 1).items()
                    if n and "/" not in k}      # by kernel; the routes follow dt
            worst_call = max(calls, key=lambda c: c[0])
            log(f"[stateful_train] kernel path vs plain autograd, {arch} reduced "
                f"({cfg.num_layers} layers), {dt}: launches {launched} (rule {want}); "
                f"{len(calls)} calls alone, worst {worst_call[0]:.3e} ({worst_call[1]}: "
                f"{ {k: f'{e:.2e}' for k, e in worst_call[2].items()} }; tol {tol}); "
                f"loss rel diff {dl:.3e} (tol {loss_tol}); {len(held)} grad leaves held "
                f"(tol {tol}, or 4x the plain path's spread up to {SPREAD_CAP}), worst "
                f"{worst(held, 'bound')}; "
                f"{len(loose)} not held (own spread >= {SPREAD_CAP}), worst "
                f"{worst(loose, 'spread')}; "
                f"past their bound: {bad}")
            if launched != want or not dl <= loss_tol or bad:
                raise AssertionError(f"stateful_train: kernel-path grads differ "
                                     f"({arch}, {dt})")
            del params, moved, grads, grads_p, grads_m, recs


def rglru_train_row(dev):
    """rglru_scan at recurrentgemma-9b's train microbatch (a, bx [2, 2048,
    4096] float32, bf16 y and dy, as the model passes them) through
    ``RGLRUScan``: the forward (one launch on ``"chunked"`` writing the bf16
    y and the float32 states it saves; y at 5e-2 and the states at 5e-6
    against the plain version) and the backward (the gradient kernel, one
    launch on ``"chunked_bwd"``, the plain ``rglru_scan_bwd_ref`` never)
    against autograd of the plain version at 2e-5 relative to max(1, the
    gradient's largest value); two backward calls bit-identical; the
    ``"sequential_bwd"`` route at [4, 5, 256] with h0 and a gradient of
    h_last, float32 dy, at the same bound. Call, device (CUDA-graph
    replay), bound and plain ms of both directions. Returns (the forward's
    row, the gradient kernel's row)."""
    import torch
    from repro_torch.kernels import rglru_scan as krs
    g = torch.Generator(device=dev).manual_seed(14)
    B, S, R = 2, 2048, 4096
    bf16 = torch.bfloat16
    a = torch.sigmoid(torch.randn(B, S, R, generator=g, device=dev))
    bx = torch.randn(B, S, R, generator=g, device=dev) * 0.5
    dy = torch.randn(B, S, R, generator=g, device=dev).to(bf16)
    ag, bg = a.clone().requires_grad_(), bx.clone().requires_grad_()
    fwd = lambda: krs.rglru_scan(ag, bg, out_dtype=bf16)             # noqa: E731
    ref = lambda: krs.rglru_scan_ref(ag, bg, out_dtype=bf16)         # noqa: E731
    before = dict(krs.launches_by_route)
    (y, _), (yw, _) = fwd(), ref()
    err = check_close("train rglru_scan y bf16 [2,2048,4096]", y, yw, "bf16_state")
    plain_bwd = krs.rglru_scan_bwd_ref

    def never(*a, **kw):
        raise AssertionError("rglru_scan_train: the plain rglru_scan_bwd_ref ran on the card")

    krs.rglru_scan_bwd_ref = never
    try:
        got = torch.autograd.grad(y, (ag, bg), dy)
    finally:
        krs.rglru_scan_bwd_ref = plain_bwd
    torch.cuda.synchronize()
    routes = {r: n - before[r] for r, n in krs.launches_by_route.items()}
    log(f"  train rglru_scan forward + backward: launches_by_route {routes}")
    if routes != {"chunked": 1, "sequential": 0, "chunked_bwd": 1, "sequential_bwd": 0}:
        raise AssertionError(f"rglru_scan_train: routes {routes}, expected one forward "
                             "on chunked and one backward on chunked_bwd")
    want = torch.autograd.grad(yw, (ag, bg), dy, retain_graph=True)
    b_err = 0.0
    for name, x, w in zip(("a", "bx"), got, want):
        scale = max(1.0, float(w.abs().max()))
        b_err = max(b_err, check_close(f"train rglru_scan d{name} (scaled by {scale:.3g})",
                                       x / scale, w / scale, "float32"))
    del got, want
    _, _, hh = krs._forward(a, bx, out_dtype=bf16, with_states=True)
    hw, _ = krs.rglru_scan_ref(a, bx)
    err = max(err, check_close("train rglru_scan kept float32 states", hh, hw,
                               "float32_scan"))
    del hw
    # the sequential route of the gradient (S <= SHORT_S), h0 and dh_last in
    gs = torch.Generator(device=dev).manual_seed(15)
    ins = [torch.sigmoid(torch.randn(4, 5, 256, generator=gs, device=dev)).requires_grad_(),
           torch.randn(4, 5, 256, generator=gs, device=dev, requires_grad=True),
           torch.randn(4, 256, generator=gs, device=dev, requires_grad=True)]
    d5, dl5 = (torch.randn(*sh, generator=gs, device=dev) for sh in ((4, 5, 256), (4, 256)))
    n_seq = krs.launches_by_route["sequential_bwd"]
    y5, h5 = krs.rglru_scan(*ins)
    got = torch.autograd.grad((y5, h5), ins, (d5, dl5))
    y5w, h5w = krs.rglru_scan_ref(*ins)
    want = torch.autograd.grad((y5w, h5w), ins, (d5, dl5))
    torch.cuda.synchronize()
    if krs.launches_by_route["sequential_bwd"] != n_seq + 1:
        raise AssertionError("rglru_scan_train: the sequential_bwd route did not launch once")
    for name, x, w in zip(("a", "bx", "h0"), got, want):
        scale = max(1.0, float(w.abs().max()))
        b_err = max(b_err, check_close(f"rglru_scan [4,5,256] sequential_bwd d{name} "
                                       f"(scaled by {scale:.3g})", x / scale, w / scale,
                                       "float32"))
    bwd = lambda: krs.rglru_scan_bwd(a, hh, dy)                        # noqa: E731
    first, second = bwd(), bwd()
    if not all(torch.equal(x, z) for x, z in zip(first[:2], second[:2])):
        raise AssertionError("rglru_scan_train: two backward calls on the same inputs differ")
    del first, second
    # device ms (CUDA-graph replay) of the Function's forward body, outside
    # autograd, and of the backward
    body = lambda: krs._forward(a, bx, out_dtype=bf16, with_states=True)  # noqa: E731
    ms, dms = time_ms(fwd, 20), graph_ms(body)
    b_ms, b_dms = time_ms(bwd, 20), graph_ms(bwd)
    log_kernels("rglru_scan_bwd [2,2048,4096]", device_ms_by_kernel(bwd))
    plain = time_ms(ref, 1, warmup=0)
    plain_b = time_ms(lambda: torch.autograd.grad(yw, (ag, bg), dy, retain_graph=True),
                      1, warmup=0)
    # the forward reads a and bx and writes the bf16 y and the float32
    # states (14 bytes an element); the backward reads a, the states and dy
    # and writes da and dbx (18)
    f_bound, f_by = bound("rglru", B, S, R, 2, False, True)
    bb_ms, bb_by = bound("rglru_bwd", B, S, R)
    log(f"[stateful_train] rglru_scan_train [2,2048,4096]: forward {ms:.4f} ms "
        f"({fmt_ms(dms)} device; bound {f_bound:.4f} by {f_by}; plain {plain:.2f}); "
        f"backward kernel {b_ms:.4f} ms ({fmt_ms(b_dms)} device; bound {bb_ms:.4f} by "
        f"{bb_by}; two calls bit-identical; plain autograd {plain_b:.2f})")
    train = dict(
        name="rglru_scan_train", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:42",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=f_bound, bound_by=f_by,
        library_ms=None, device_ms=dms)
    back = dict(
        name="rglru_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:42",
        max_abs_err=b_err, ms=b_ms, plain_ms=plain_b, bound_ms=bb_ms, bound_by=bb_by,
        library_ms=None, device_ms=b_dms)
    return train, back


def mlstm_train_row(dev):
    """mlstm_chunk at xlstm-350m's train microbatch (q/k/v [4, 1024, 4, 512]
    bf16, chunk 256: ``STATEFUL_TRAIN``) through ``MLSTMChunk``: the forward
    (the kernel, ``"wgmma"`` route, its chunk start states kept) against the
    plain version's float32 result (5e-2); the backward kernel (launched once
    on ``"wgmma_bwd"``, the plain ``mlstm_chunk_bwd`` never) against autograd
    of the plain version (2e-2 relative to max(1, each gradient's largest
    value)), two backward calls bit-identical; the float32 route's backward
    at a reduced shape ([2, 300, 2, 128], chunk 256) at 1e-4. Call, device,
    bound and plain ms of the forward (its row) and of the backward kernel
    (its own row, with autograd of the plain version as its plain ms and the
    plain backward ``mlstm_chunk_bwd``, the written-out float32 PyTorch the
    card ran before, beside it; device: CUDA-graph replay). Returns (the
    forward's row, the backward kernel's)."""
    import torch
    from repro_torch.kernels import mlstm_chunk as kmc
    g = torch.Generator(device=dev).manual_seed(15)
    xl = STATEFUL_TRAIN["xlstm-350m"]
    B, S, H, hd, L = xl["batch"] // xl["accum"], xl["seq"], 4, 512, 256
    shape = f"[{B},{S},{H},{hd}]"
    bf16 = torch.bfloat16

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device=dev) * scale + shift

    q, k = (rnd(B, S, H, hd, scale=0.5).to(bf16) for _ in range(2))
    v, dh = rnd(B, S, H, hd).to(bf16), rnd(B, S, H, hd).to(bf16)
    ig, fg = rnd(B, S, H), rnd(B, S, H, shift=2.0)
    ins = [t.clone().requires_grad_() for t in (q, k, v, ig, fg)]
    fwd = lambda: kmc.mlstm_chunk(*ins, chunk=L)                      # noqa: E731
    ref = lambda: kmc.mlstm_chunk_ref(*ins, chunk=L)                  # noqa: E731
    (h, _), (hw, _) = fwd(), kmc.mlstm_chunk_ref(q.float(), k.float(), v.float(),
                                                 ig, fg, chunk=L)
    err = check_close(f"train mlstm_chunk h bf16 {shape}", h, hw, "bf16_state")
    before = kmc.launches_by_route["wgmma_bwd"]
    plain_bwd = kmc.mlstm_chunk_bwd

    def never(*a, **kw):
        raise AssertionError("mlstm_chunk_train: the plain mlstm_chunk_bwd ran on the card")

    kmc.mlstm_chunk_bwd = never
    try:
        got = torch.autograd.grad(h, ins, dh)
    finally:
        kmc.mlstm_chunk_bwd = plain_bwd
    torch.cuda.synchronize()
    if kmc.launches_by_route["wgmma_bwd"] != before + 1:
        raise AssertionError("mlstm_chunk_train: the backward kernel did not launch once")
    hr, _ = ref()
    want = torch.autograd.grad(hr, ins, dh, retain_graph=True)
    b_err = 0.0
    for name, x, w in zip(("q", "k", "v", "ig", "fg"), got, want):
        scale = max(1.0, float(w.float().abs().max()))
        b_err = max(b_err, check_close(f"train mlstm_chunk d{name} (scaled by {scale:.3g})",
                                       x.float() / scale, w.float() / scale, "bfloat16"))
    del got, want
    # the float32 route's backward, at a reduced shape
    f32 = [rnd(2, 300, 2, 128, scale=0.5), rnd(2, 300, 2, 128, scale=0.5),
           rnd(2, 300, 2, 128), rnd(2, 300, 2), rnd(2, 300, 2, shift=2.0)]
    dh32 = rnd(2, 300, 2, 128)
    xs = [t.clone().requires_grad_() for t in f32]
    before32 = kmc.launches_by_route["simt_f32_bwd"]
    got = torch.autograd.grad(kmc.mlstm_chunk(*xs, chunk=L)[0], xs, dh32)
    want = torch.autograd.grad(kmc.mlstm_chunk_ref(*xs, chunk=L)[0], xs, dh32)
    torch.cuda.synchronize()
    if kmc.launches_by_route["simt_f32_bwd"] != before32 + 1:
        raise AssertionError("mlstm_chunk_train: the float32 backward did not launch once")
    f_err = 0.0
    for name, x, w in zip(("q", "k", "v", "ig", "fg"), got, want):
        scale = max(1.0, float(w.abs().max()))
        f_err = max(f_err, check_close(f"train mlstm_chunk float32 d{name} [2,300,2,128] "
                                       f"(scaled by {scale:.3g})", x / scale, w / scale,
                                       "float32_grad"))
    del got, want, xs
    # the backward kernel alone, on the forward's kept states
    _, (C, n, _), kept = kmc._forward(q, k, v, ig, fg, chunk=L, with_states=True)
    bwd = lambda: torch.ops.repro_torch.mlstm_chunk_bwd(      # noqa: E731
        q, k, v, ig, fg, dh, None, None, C, n, *kept, False, L)
    first, second = bwd(), bwd()
    if not all(torch.equal(x, y) for x, y in zip(first, second)):
        raise AssertionError("mlstm_chunk_train: two backward calls on the same inputs differ")
    del first, second
    body = lambda: kmc._forward(q, k, v, ig, fg, chunk=L)             # noqa: E731
    ms, dms = time_ms(fwd, 20), graph_ms(body)
    b_ms, b_dms = time_ms(bwd, 20), graph_ms(bwd)
    log_kernels(f"mlstm_chunk_bwd {shape} (by launch)", device_ms_by_kernel(bwd, 10))
    written = lambda: plain_bwd(q, k, v, ig, fg, dh, chunk=L)         # noqa: E731
    w_ms, w_dms = time_ms(written, 5, warmup=1), graph_ms(written, iters=5)
    plain = time_ms(ref, 3, warmup=1)
    plain_b = time_ms(lambda: torch.autograd.grad(hr, ins, dh, retain_graph=True), 3,
                      warmup=1)
    # forward: causal q·kᵀ and w·v in bf16, q·C and the state update in TF32
    f_bound, f_by = bound("mlstm", B, S, H, hd, L, 2, False)
    # backward kernel: five products over the pairs in bf16, four over the
    # state in TF32; q, k, v, dh, the gates and the kept states read once,
    # the five gradients written
    bb_ms, bb_by = bound("mlstm_bwd_kernel", B, S, H, hd, L, 2)
    wb_ms, wb_by = bound("mlstm_bwd", B, S, H, hd, L)
    log(f"[stateful_train] mlstm_chunk_train {shape} chunk {L}: forward "
        f"{ms:.4f} ms ({fmt_ms(dms)} device; bound {f_bound:.4f} by {f_by}; plain "
        f"{plain:.2f}); backward kernel {b_ms:.4f} ms ({fmt_ms(b_dms)} device; bound "
        f"{bb_ms:.4f} by {bb_by}; two calls bit-identical; float32 route at "
        f"[2,300,2,128] max scaled err {f_err:.3e}); the plain mlstm_chunk_bwd "
        f"(written-out float32, the card's backward until this kernel) {w_ms:.4f} ms "
        f"({fmt_ms(w_dms)} device; bound {wb_ms:.4f} by {wb_by} at the float32 rate); "
        f"plain autograd {plain_b:.2f}")
    train = dict(
        name="mlstm_chunk_train", route="cuda",
        source="src/repro_torch/kernels/csrc/mlstm_chunk_wgmma.cu",
        replaces="src/repro/kernels/mlstm_chunk.py:77",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=f_bound, bound_by=f_by,
        library_ms=None, device_ms=dms)
    back = dict(
        name="mlstm_chunk_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/mlstm_chunk_bwd_wgmma.cu",
        replaces="src/repro/kernels/mlstm_chunk.py:77",
        max_abs_err=max(b_err, f_err), ms=b_ms, plain_ms=plain_b, bound_ms=bb_ms,
        bound_by=bb_by, library_ms=None, device_ms=b_dms, written_out_ms=w_ms,
        written_out_device_ms=w_dms)
    return train, back


def stateful_train_phase(dev, card):
    """Phase 14 (see the module docstring); returns (kernel rows, launch
    counts by arch). Fails past ``STATEFUL_TRAIN_S`` seconds."""
    t_phase = time.perf_counter()
    counts, parts = {}, {}
    for arch in STATEFUL_TRAIN:
        t0 = time.perf_counter()
        counts[arch] = stateful_train_run(dev, card, arch)
        parts[arch] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stateful_grad_checks(dev)
    parts["gradient checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = {}
    rows["rglru_scan_train"], rows["rglru_scan_bwd"] = rglru_train_row(dev)
    rows["mlstm_chunk_train"], rows["mlstm_chunk_bwd"] = mlstm_train_row(dev)
    parts["kernel rows"] = time.perf_counter() - t0
    # xlstm's mLSTM backward calls a step at the row's device time (the
    # profiled step gives their sum in the step)
    xl = STATEFUL_TRAIN["xlstm-350m"]
    calls = counts["xlstm-350m"]["mlstm_chunk/wgmma_bwd"] // xl["steps"]
    b_dms = rows["mlstm_chunk_bwd"]["device_ms"]
    log(f"[stateful_train] xlstm-350m mLSTM backward: {calls} calls a step x "
        f"{fmt_ms(b_dms)} device ms = "
        f"{fmt_ms(None if b_dms is None else calls * b_dms)} device ms a step")
    secs = time.perf_counter() - t_phase
    log(f"[stateful_train] phase seconds={secs:.1f} (budget {STATEFUL_TRAIN_S}): "
        f"{ {k: round(v, 1) for k, v in parts.items()} }")
    if secs > STATEFUL_TRAIN_S:
        raise AssertionError(f"stateful_train: {secs:.1f} s past its budget of "
                             f"{STATEFUL_TRAIN_S}")
    return rows, counts


# ---------------------------------------------------------------------------
# phase 13: serving on a device mesh
# ---------------------------------------------------------------------------

# float32 at the published widths, a cut depth: (layers, mesh shape)
MESH_F32 = {"qwen2.5-3b": (4, (2, 2)),            # its 2 KV heads over "model"
            "recurrentgemma-9b": (3, (2, 2)),     # one pattern period
            "mixtral-8x22b": (2, (2, 4))}         # 8 experts over "model" = 4
MESH_PHASE_S = 120          # the phase's time budget (seconds)


def eos_guard(cfg, params):
    """Pin the EOS logit at 0 (random weights would stop some requests at
    once, and equal ids would then prove little)."""
    import torch
    with torch.no_grad():
        if cfg.tie_embeddings:
            params.embed.table[cfg.vocab_size - 1] = 0
        else:
            params.unembed.table[:, cfg.vocab_size - 1] = 0
    return params


def attention_layers(cfg):
    from repro_torch.models.transformer import ATTN_KINDS
    return [i for i, k in enumerate(cfg.layer_kinds) if k in ATTN_KINDS]


def mesh_serve(name, cfg, params, dev, prompts, mesh, max_new, **ecfg):
    """Serve ``prompts`` greedily on one server (on ``mesh``, or unsharded
    with None): every decode / verify step on the graph path, the decode
    kernel launched ``launch_counts.expected`` times. Returns (ids, stats,
    the decode kernel's launches)."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.serving.server import EngineConfig, LLMServer, SamplingParams
    srv = LLMServer(cfg, num_slots=4, capacity=ecfg.pop("capacity", 512), params=params,
                    device=dev, engine_cfg=EngineConfig(mesh=mesh, **ecfg))
    before = launch_counts.snapshot()
    gbefore = graph_counts(srv)
    hs = [srv.submit(p, SamplingParams(max_new_tokens=max_new)) if isinstance(p, str)
          else srv.submit("", SamplingParams(max_new_tokens=max_new), token_ids=p)
          for p in prompts]
    srv.run_until_idle()
    torch.cuda.synchronize()
    after = launch_counts.snapshot()
    check_graphs(name, srv, gbefore)
    not_completed(name, hs)
    for h in hs:
        if len(h.request.output_ids) != max_new:
            raise AssertionError(f"{name}: rid={h.request.rid} {h.request.status} "
                                 f"{len(h.request.output_ids)} tokens")
    progs, st = srv.engine.progs, srv.stats()
    kern = "paged_decode_attention" if srv.engine.paged else "decode_attention"
    got = after[kern, ""] - before[kern, ""]
    shards = [progs.launch_shards(srv.params, i) for i in attention_layers(cfg)]
    want = launch_counts.expected(progs.decode_steps, shards)
    log(f"[{name}] {kern} launches={got} == decode steps {progs.decode_steps} x "
        f"shards by attention layer {sorted(set(shards))} x {len(shards)} layers "
        f"= {want}; verify steps={progs.verify_steps}")
    if got != want:
        raise AssertionError(f"{name}: {kern} launched {got} times, the rule says {want}")
    ids = [h.request.output_ids for h in hs]
    srv.close()
    return ids, st, got


def mesh_logit_diff(model, params, mesh, ids, dev):
    """The largest |logit| difference between the model on ``mesh`` and
    unsharded: two rows prefilled with ids[:, :n], then 4 decode steps
    teacher-forced, float32."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.serving.programs import slot_extract
    cfg = model.cfg
    rules = shd.rules_for(mesh, "serve")
    placed = shd.place_params(params, rules)
    B, n = ids.shape[0], ids.shape[1] - 4
    out = []
    for p in (params, placed):
        cache = model.init_cache(B, 512)
        if p is placed:
            cache = shd.shard_put(cache, shd.cache_pspecs(cfg, rules), mesh)
        lg = []
        for b in range(B):
            logits, _ = model.prefill(p, model.make_batch(ids[b:b + 1, :n]),
                                      slot_extract(cache, b))
            lg.append(logits[:, -1])
        clen = torch.full((B,), n, dtype=torch.int32, device=dev)
        for s in range(4):
            batch = {"tokens": ids[:, n + s:n + s + 1], "positions": clen[:, None].long()}
            with shd.use_rules(rules if p is placed else None):
                logits, _ = model.decode_step(p, batch, cache, clen)
            lg.append(logits[:, 0])
            clen = clen + 1
        out.append(torch.cat([x.reshape(-1) for x in lg]))
    del placed
    return float((out[0] - out[1]).abs().max())


def split_product_diffs(dev, cfg, rows=(1, 4, 20), parts=2):
    """Which float32 product gives other bits once cut over "model": for
    ``rows`` rows, ``x @ W`` against ``x @ W[:, part]`` concatenated, at
    the arch's mlp-up (d_model x d_ff) and vocab (d_model x vocab)
    shapes: the largest difference by shape (0: the same bits)."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    out = {}
    for label, n in (("mlp-up", cfg.d_ff or cfg.d_model), ("vocab", cfg.padded_vocab)):
        w = torch.randn(cfg.d_model, n, generator=g, device=dev) / cfg.d_model ** 0.5
        cols = [c.contiguous() for c in w.chunk(parts, 1)]
        for m in rows:
            x = torch.randn(m, cfg.d_model, generator=g, device=dev)
            whole = x @ w
            cut = torch.cat([x @ c for c in cols], 1)
            out[f"{label} [{m},{cfg.d_model}]x[{cfg.d_model},{n}]/{parts}"] = float(
                (whole - cut).abs().max())
    return out


def mesh_f32_cells(dev, tok, rng):
    """(a) Each arch of ``MESH_F32`` at its published widths and a cut
    depth, float32, random weights from seed 1: dense and paged (KV pages,
    or state snapshots) with spec_len 0 and 4, the mesh server's greedy ids
    against the unsharded server's; the largest logit difference. The
    cells after the first add two requests quoting the first cell's greedy
    continuation of prompt 0 (``self_quotes``), which the drafter finds."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.models import Model
    from repro_torch.serving.tokenizer import ByteTokenizer
    tool = make_text(tok, rng, 60)
    prompts = [f"[ToolMessage]\n{tool}\n[actor] The tool returned:\n{tool}\nQuote it "
               f"again:\n{tool[:len(tool) // 2]}",
               make_text(tok, rng, 40), make_text(tok, rng, 90), "[planner] next step"]
    out = {}
    for name, (layers, shape) in MESH_F32.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(ARCHS[name], dtype="float32", param_dtype="float32",
                                  num_layers=layers)
        model = Model(cfg, device=dev)
        params = eos_guard(cfg, model.init(seed=1))
        mesh = make_test_mesh(shape, devices=dev)
        atok = ByteTokenizer(cfg.vocab_size)        # the server's own tokenizer
        ids = torch.tensor([atok.encode(p)[:24] for p in prompts[1:3]], device=dev)
        diff = mesh_logit_diff(model, params, mesh, ids, dev)
        log(f"[mesh-f32] {name} ({layers} layers, mesh {shape}): largest |logit| "
            f"difference mesh vs unsharded, 2 prefills + 4 decode steps: {diff:.3e}")
        if diff != 0:
            log(f"[mesh-f32] {name}: float32 products cut by output columns "
                f"(max |whole - cut|): {split_product_diffs(dev, cfg, parts=shape[1])}")
        cells, verified, cell_prompts = {}, 0, list(prompts)
        for mode in ("dense", "paged"):
            ecfg = dict(cache_mode=mode, page_size=16, decode_chunk=4, spec_ngram_min=1)
            if name != "qwen2.5-3b" and mode == "paged":
                ecfg.update(num_snapshots=16, snap_stride=2)
            for spec in (0, 4):
                label = f"mesh-f32 {name} {mode} spec{spec}"
                ref, _, _ = mesh_serve(label + " unsharded", cfg, params, dev,
                                       cell_prompts, None, 16, spec_len=spec, **ecfg)
                got, st, _ = mesh_serve(label + f" mesh{shape}", cfg, params, dev,
                                        cell_prompts, mesh, 16, spec_len=spec, **ecfg)
                if len(cell_prompts) == len(prompts):
                    cell_prompts += self_quotes(atok, rng, atok.encode(prompts[0]), ref[0])
                verified += st["verify_steps"] > 0
                if not st["sharded"] or not st["step_graphs"]:
                    raise AssertionError(f"{label}: stats {st['sharded']} "
                                         f"{st['step_graphs']}")
                cells[mode, spec] = got == ref
                log(f"[{label}] mesh ids == unsharded ids: {got == ref} "
                    f"(verify_steps={st['verify_steps']})")
        if not all(cells.values()) or not verified:
            raise AssertionError(f"mesh-f32 {name}: ids equal by cell {cells}, "
                                 f"cells that verified {verified}")
        out[name] = dict(logit_diff=diff, seconds=time.perf_counter() - t0)
        del model, params
        torch.cuda.empty_cache()
    return out


def admit_ms(server, prompt, reps=3):
    """Median wall ms of admitting ``prompt`` alone (prefill + first
    token: the TTFT path) on a warm server."""
    import torch
    from repro_torch.serving.server import SamplingParams
    walls = []
    for _ in range(reps + 1):
        h = server.submit(prompt, SamplingParams(max_new_tokens=1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.engine._admit()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        server.run_until_idle()
        not_completed("admission", [h])
    return statistics.median(walls[1:])


def mesh_full_qwen(dev, model, params, tok, rng):
    """(b) qwen2.5-3b at its published width and depth (36 layers, bf16) on
    a (1, 2) mesh beside the unsharded server, paged (page_size 16,
    decode_chunk 8): every decode step a replay, the decode kernel's
    launches under the rule, decode tok/s, TTFT of a ~1000-token prompt
    and peak memory; one decode chunk profiled on the graphs; greedy
    agreement printed."""
    import torch
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.kernels import launch_counts
    from repro_torch.serving.server import EngineConfig, LLMServer, SamplingParams
    prompts = [make_text(tok, rng, n) for n in (200, 400, 600, 800)]
    long_prompt = make_text(tok, rng, 1000)
    res = {}
    for label, mesh in (("unsharded", None), ("mesh(1,2)", make_test_mesh((1, 2), devices=dev))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        srv = LLMServer(model.cfg, num_slots=4, capacity=2048, params=params, device=dev,
                        engine_cfg=EngineConfig(mesh=mesh, **FLEET_ECFG))
        srv.submit(prompts[0], SamplingParams(max_new_tokens=8)).result()   # warm
        ttft = admit_ms(srv, long_prompt)
        before, gbefore = launch_counts.snapshot(), graph_counts(srv)
        st0 = srv.stats()
        hs = [srv.submit(p, SamplingParams(max_new_tokens=64)) for p in prompts]
        srv.run_until_idle()
        torch.cuda.synchronize()
        after = launch_counts.snapshot()
        check_graphs(f"mesh-bf16 {label}", srv, gbefore)
        st, progs = srv.stats(), srv.engine.progs
        steps = st["decode_tokens"] - st0["decode_tokens"]
        dec_s = sum(h.request.decode_s for h in hs)
        got = after["paged_decode_attention", ""] - before["paged_decode_attention", ""]
        d_steps = graph_counts(srv)["decode_steps"] - gbefore["decode_steps"]
        shards = [progs.launch_shards(srv.params, i) for i in range(model.cfg.num_layers)]
        want = launch_counts.expected(d_steps, shards)
        peak = torch.cuda.max_memory_allocated() / 1e9
        res[label] = dict(ids=[h.request.output_ids for h in hs], ttft_ms=ttft,
                          decode_tok_s=steps / max(dec_s, 1e-9), peak_gb=peak,
                          launches=got, decode_steps=d_steps)
        log(f"[mesh-bf16 {label}] paged_decode_attention launches={got} == decode steps "
            f"{d_steps} x {shards[0]} shards x {len(shards)} layers = {want}; "
            f"decode_tok_per_s={res[label]['decode_tok_s']:.1f} "
            f"ttft_ms(1000-token prompt, median of 3)={ttft:.2f} "
            f"max_memory_allocated_GB={peak:.3f} graphs={progs.graphs}")
        if got != want or not progs.graphs:
            raise AssertionError(f"mesh-bf16 {label}: launches {got} != {want}")
        res[label]["chunk"] = profile_decode_chunk(srv, prompts, eager=False)
        srv.close()
        del srv
    a, b = res["unsharded"]["ids"], res["mesh(1,2)"]["ids"]
    same = sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))
    log(f"[mesh-bf16] greedy tokens equal mesh vs unsharded: {same}/"
        f"{sum(len(r) for r in a)}")
    return res


def seqpar_row(dev):
    """(c) The sequence-parallel decode at qwen2.5-3b's decode shape (q
    [4,1,16,128], caches [4,2048,2,128] cut into 4 shards of 512 slots): a
    partials launch a shard and one combine. The path's launches are
    counted alone; then against the one-launch kernel (bit-equal, bf16 and
    float32, a windowed ring too) and the plain version (the reference's
    per-shard flash decode and combine, at the bf16 / float32 tolerances),
    and timed beside SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.distributed.collectives import (make_seqpar_decode_attention,
                                                     seqpar_decode_ref)
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.kernels import decode_attention as kda
    B, W, K, G, hd = 4, 2048, 2, 8, 128
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    q, kc, vc = rnd(B, 1, K * G, hd), rnd(B, W, K, hd), rnd(B, W, K, hd)
    clen = torch.tensor([1500, 100, 2047, 700], dtype=torch.int32, device=dev)
    f = make_seqpar_decode_attention(make_test_mesh((1, 4), devices=dev))
    from repro_torch.distributed.sharding import split
    ks, vs = split(kc, 1, [dev] * 4), split(vc, 1, [dev] * 4)
    reset_counts()
    o = f(q, ks, vs, clen, q_per_kv=G)                  # the path
    torch.cuda.synchronize()
    counts = kernel_counts()
    log(f"[seqpar] launches on the path: {counts['seqpar_decode_attention']} "
        "(4 partials + 1 combine)")
    if counts["seqpar_decode_attention"] != 5:
        raise AssertionError(f"seqpar: {counts['seqpar_decode_attention']} launches")
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for window in (None, 600):
            qd, kd, vd = q.to(dtype), kc.to(dtype), vc.to(dtype)
            got = f(qd, kd, vd, clen, q_per_kv=G, window=window)
            one = kda.decode_attention(qd, kd, vd, clen, q_per_kv=G, window=window)
            if not torch.equal(got, one):
                raise AssertionError(f"seqpar {dtype} window={window}: not bit-equal "
                                     f"to the one-launch kernel")
            want = seqpar_decode_ref(qd, kd.chunk(4, 1), vd.chunk(4, 1), clen,
                                     q_per_kv=G, window=window)
            e = check_close(f"{str(dtype)[6:]} window={window} vs plain (and == one "
                            "launch bit for bit)", got, want,
                            "bfloat16" if dtype == torch.bfloat16 else "float32")
            err = max(err, e) if dtype == torch.bfloat16 else err
    fn = lambda: f(q, ks, vs, clen, q_per_kv=G)                          # noqa: E731
    ms = time_ms(fn, 50)
    plain_ms = time_ms(lambda: seqpar_decode_ref(q, ks.parts, vs.parts, clen,
                                                 q_per_kv=G), 10)
    one_ms = time_ms(lambda: kda.decode_attention(q, kc, vc, clen, q_per_kv=G), 50)
    mask = (torch.arange(W, device=dev)[None, :] <= clen[:, None].long())[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    lf = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,  # noqa: E731
                                                enable_gqa=True)
    lib = time_ms(lf, 50)
    dms, lib_dms = device_times("seqpar_decode_attention", fn, lf)
    live = int(torch.clamp(clen.long() + 1, max=W).sum())
    b_ms, b_by = bound("decode", B, K * G, K, hd, live, 2)
    log(f"[seqpar] ms={ms:.4f} one-launch decode_attention ms={one_ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={lib:.4f} bound_ms={b_ms:.5f} ({b_by})")
    row = dict(name="seqpar_decode_attention", route="cuda",
               source="src/repro_torch/kernels/csrc/split_decode_attention.cu",
               replaces="src/repro/kernels/decode_attention.py:71",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib, device_ms=dms, library_device_ms=lib_dms)
    return row, counts["seqpar_decode_attention"]


def elastic_check(dev):
    """(d) qwen2.5-3b at its published width and 2 of 36 layers (bf16),
    saved unsharded in the reference's format, restored onto a (2, 2) mesh
    (``restore(shardings=...)``, the serve specs) and back onto one device
    (``reshard_tree``): every leaf bit-equal; the directory deleted."""
    import shutil
    import torch
    from repro_torch.checkpoint.checkpoint import flatten, restore, save
    from repro_torch.configs.registry import ARCHS
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.elastic import reshard_tree
    from repro_torch.distributed.mesh import make_host_mesh, make_test_mesh
    from repro_torch.models import Model, convert
    cfg = dataclasses.replace(ARCHS["qwen2.5-3b"], num_layers=2)
    params = Model(cfg, device=dev).init(seed=2)
    tree = convert.params_to_jax(params.state_dict(), cfg)
    d = ROOT / "build" / "mesh_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    save(str(d), 1, tree)
    t_save = time.perf_counter() - t0
    mesh = make_test_mesh((2, 2), devices=dev)
    specs = shd.param_pspecs(shd.param_axes(cfg), shd.rules_for(mesh, "serve"))
    shardings = shd._map(lambda s: shd.NamedSharding(mesh, s), specs,
                         lambda x: isinstance(x, shd.P))
    t0 = time.perf_counter()
    got, step = restore(str(d), tree, shardings=shardings)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    n_cut = sum(isinstance(x, shd.Shards) for x in flatten(got)[0])
    back = reshard_tree(got, make_host_mesh(dev), specs)
    want_leaves, back_leaves = flatten(tree)[0], flatten(back)[0]
    equal = all(torch.equal(a, b) for a, b in zip(want_leaves, back_leaves))
    nbytes = sum(t.numel() * t.element_size() for t in want_leaves)
    log(f"[elastic] {len(want_leaves)} leaves ({nbytes / 1e9:.3f} GB) saved in "
        f"{t_save:.2f}s, restored onto a (2, 2) mesh in {t_restore:.2f}s ({n_cut} "
        f"leaves cut over 'model'), back onto one device: every bit equal: {equal}")
    shutil.rmtree(d, ignore_errors=True)
    if not equal or step != 1 or n_cut == 0:
        raise AssertionError(f"elastic restore: equal={equal} step={step} cut={n_cut}")


def mesh_phase(dev, model, params, tok):
    """Phase 13 (see the module docstring); returns (kernel rows, launch
    counts of the serving path, seqpar launches)."""
    import torch
    t0 = time.perf_counter()
    rng = random.Random(13)
    reset_counts()
    f32 = mesh_f32_cells(dev, tok, rng)
    full = mesh_full_qwen(dev, model, params, tok, rng)
    counts = kernel_counts()
    log(f"[mesh] launches on the serving path: {counts}")
    idle = [k for k in ("flash_attention", "decode_attention", "paged_decode_attention",
                        "spec_decode_attention", "paged_spec_decode_attention",
                        "accept_len", "rglru_scan") if counts[k] <= 0]
    if idle:
        raise AssertionError(f"mesh: kernels never launched on its path: {idle}")
    row, n_seqpar = seqpar_row(dev)
    elastic_check(dev)
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"[mesh] phase seconds={secs:.1f} (budget {MESH_PHASE_S}); "
        f"f32 cells: {{{', '.join(f'{k}: {v['seconds']:.1f}s' for k, v in f32.items())}}}")
    if secs > MESH_PHASE_S:
        raise AssertionError(f"mesh phase took {secs:.1f}s > {MESH_PHASE_S}s")
    return {"seqpar_decode_attention": row}, counts, n_seqpar


# ---------------------------------------------------------------------------
# phase 15: the dry run's predictions beside the card
# ---------------------------------------------------------------------------

PRODUCT_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
SWEEP = ROOT / "results" / "torch" / "dryrun_single_pod.json"
TRAIN_RECORD = {}           # phase 12's unsharded tok/s and peak, for mesh_train


def profiled_products(fn):
    """The aten products' FLOPs (``with_flops``) of one call of ``fn`` (no
    card path runs a written-out backward: the kernels' work is counted
    apart, by their analytic costs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], with_flops=True) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.flops for e in prof.events() if e.name in PRODUCT_OPS and e.flops)


def predicted(cfg, shape, grid=(1, 1), accum=None):
    """The dry run of a one-card cell: (argument bytes, its trace)."""
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.launch import dryrun
    mesh = make_test_mesh(grid, devices="meta")
    run, rules, *_ = dryrun.build_cell(cfg, shape, mesh, accum_steps=accum)
    args = sum(dryrun.argument_bytes(cfg, shape, mesh, rules).values())
    return args, dryrun.trace(run)


PAGED_ROWS, PAGED_PAGES = 4, 128        # 4 rows of 2048 slots in pages of 16


def paged_serve_step(cfg, dev):
    """One paged decode step of phase 13's (1, 2) qwen on ``dev``: the
    serve table's placement of the weights and of a 4 x 2048-slot pool
    (``kvpool.shard_rows``), each row at its last slot. Returns (the step,
    the bytes of its arguments' tensors)."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.models import Model
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import kvpool
    mesh = make_test_mesh((1, 2), devices=dev)
    rules = shd.rules_for(mesh, "serve")
    params = Model(cfg, device=dev)
    params = (tfm.TransformerParams(cfg, device="meta", dtype=tfm.DTYPES[cfg.param_dtype])
              if str(dev) == "meta" else params.init(seed=0))
    params = shd.place_params(params, rules)
    n_pages = 1 + PAGED_ROWS * PAGED_PAGES          # page 0: the trash page
    pool = kvpool.shard_rows(kvpool.init_paged_cache(cfg, n_pages, 16, dev), cfg,
                             rules, mesh)
    bt = (1 + torch.arange(PAGED_ROWS * PAGED_PAGES, dtype=torch.int32,
                           device=dev)).view(PAGED_ROWS, PAGED_PAGES)
    clen = torch.full((PAGED_ROWS,), PAGED_PAGES * 16 - 1, dtype=torch.int32, device=dev)
    batch = {"tokens": torch.zeros(PAGED_ROWS, 1, dtype=torch.long, device=dev),
             "positions": clen[:, None].long()}
    # every storage the step's arguments hold: the placed parts, the module
    # they were cut from (kept beside them: a fleet's replicas share it),
    # the pool's parts, the step's inputs
    held = [t for _, leaf in params.named_parameters() for t in shd.leaf_parts(leaf)]
    held += list(shd.source_params(params).parameters())
    held += [t for leaf in tfm.tree_leaves(pool) for t in shd.leaf_parts(leaf)]
    held += [bt, clen] + list(batch.values())
    nbytes = sum({t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                  for t in held}.values())

    def step():
        with torch.no_grad(), shd.use_rules(rules):
            return tfm.decode_step(params, batch, cfg, pool, clen, block_tables=bt)

    return step, nbytes


def compare_line(name, what, pred, meas):
    log(f"[dryrun] {name} {what}: predicted {pred / 1e9:.4f} G measured "
        f"{meas / 1e9:.4f} G (measured / predicted {meas / max(pred, 1):.4f})")


def dryrun_phase(dev, card):
    """Phase 15 (see the module docstring)."""
    import torch
    from repro_torch.launch import cost
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import costs
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import Model
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train_step as tts

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ARCHS["qwen2.5-3b"]
    log(f"[dryrun] {card}: predictions of the launch layer (repro_torch.launch, "
        "traced on meta on this host's CPU) beside the card")
    # -- the train step of phase 12: 4 x 2048 tokens in 2 microbatches
    shape = ShapeConfig("train_phase12", TRAIN_SEQ, TRAIN_BATCH, "train")
    t1 = time.perf_counter()
    p_args, tr = predicted(cfg, shape, accum=TRAIN_ACCUM)
    log(f"[dryrun] train trace {time.perf_counter() - t1:.1f} s")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = Model(cfg, device=dev).init(seed=0, trainable=True)
    opt = topt.init_opt_state(params)
    batch = train_data(cfg, dev).batch_at(0)
    torch.cuda.synchronize()
    args = torch.cuda.memory_allocated() - base
    _, step = train_step_fn(cfg)
    log(f"[dryrun] train placed {time.perf_counter() - t1:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    temp = torch.cuda.max_memory_allocated() - base - args
    half = {k: v[:TRAIN_BATCH // TRAIN_ACCUM] for k, v in batch.items()}
    log(f"[dryrun] train step {time.perf_counter() - t1:.1f} s")
    before = kfa.launches_by_route["wgmma_bwd"]
    meas = profiled_products(lambda: tts.loss_and_grads(params, half, cfg))
    n_bwd = kfa.launches_by_route["wgmma_bwd"] - before
    log(f"[dryrun] train profiled {time.perf_counter() - t1:.1f} s")
    compare_line("train 36-layer qwen2.5-3b (1, 1)", "argument GB", p_args, args)
    compare_line("train", "peak temp GB", tr["peak_bytes"], temp)
    compare_line("train", "products GFLOP a microbatch", tr["product_flops"] / TRAIN_ACCUM,
                 meas)
    # the backward kernel: the trace's analytic count against the launches
    # the card made in the microbatch, each at costs.flash_bwd of its shape
    mb = TRAIN_BATCH // TRAIN_ACCUM
    per_call = sum(costs.flash_bwd(mb, TRAIN_SEQ, TRAIN_SEQ, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.head_dim, 2,
                                   costs.flash_pairs(TRAIN_SEQ))[0].values())
    compare_line("train", f"flash backward kernel's analytic GFLOP a microbatch "
                 f"({n_bwd} launches on the card)",
                 tr["kernel_flops_by"].get("flash_attention_bwd", 0.0) / TRAIN_ACCUM,
                 n_bwd * per_call)
    log(f"[dryrun] train forward kernels' analytic GFLOP a microbatch (the trace's "
        f"count; the profiler sees no products in a kernel): "
        f"{tr['kernel_flops'] / TRAIN_ACCUM / 1e9:.2f}")
    del params, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    # -- phase 14's xlstm-350m step: the mLSTM backward kernel's analytic
    # GFLOP in the trace against the launches the card made a step
    if "xlstm-350m" in XLSTM_BWD:
        t1 = time.perf_counter()
        xl, xcfg = STATEFUL_TRAIN["xlstm-350m"], ARCHS["xlstm-350m"]
        mb = xl["batch"] // xl["accum"]
        shape = ShapeConfig("train_phase14", xl["seq"], xl["batch"], "train")
        _, tr = predicted(xcfg, shape, accum=xl["accum"])
        hd = int(xcfg.mlstm_proj_factor * xcfg.d_model) // xcfg.num_heads
        per_call = sum(costs.mlstm_bwd_kernel(
            mb, xl["seq"], xcfg.num_heads, hd, min(xcfg.mlstm_chunk, xl["seq"]))[0].values())
        n_bwd = XLSTM_BWD["xlstm-350m"]
        compare_line("train xlstm-350m (phase 14's step)",
                     f"mLSTM backward kernel's analytic GFLOP a step ({n_bwd} launches "
                     f"on the card, {tr['kernels'].get('mlstm_chunk_bwd', 0):.0f} traced)",
                     tr["kernel_flops_by"].get("mlstm_chunk_bwd", 0.0), n_bwd * per_call)
        if tr["kernels"].get("mlstm_chunk_bwd", 0) != n_bwd or tr["range_product_flops"]:
            raise AssertionError(f"dryrun: the trace counts {tr['kernels']} mLSTM launches "
                                 f"and range products {tr['range_product_flops']}; the card "
                                 f"{n_bwd} backward launches a step")
        log(f"[dryrun] xlstm trace {time.perf_counter() - t1:.1f} s")
    else:
        log("[dryrun] xlstm-350m's mLSTM backward: phase 14 did not run, no launches "
            "to hold the trace to")
    # -- the 4-slot decode step of phase 3 (capacity 2048)
    t1 = time.perf_counter()
    shape = ShapeConfig("decode_phase3", 2048, 4, "decode")
    p_args, tr = predicted(cfg, shape)
    log(f"[dryrun] decode trace {time.perf_counter() - t1:.1f} s")
    model = Model(cfg, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = model.init(seed=0)
    cache = model.init_cache(4, 2048)
    tok = torch.zeros(4, 1, dtype=torch.long, device=dev)
    clen = torch.full((4,), 2047, dtype=torch.int32, device=dev)
    batch = {"tokens": tok, "positions": clen[:, None].long()}
    torch.cuda.synchronize()
    args = torch.cuda.memory_allocated() - base
    model.decode_step(params, batch, cache, clen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model.decode_step(params, batch, cache, clen)
    torch.cuda.synchronize()
    temp = torch.cuda.max_memory_allocated() - base - args
    meas = profiled_products(lambda: model.decode_step(params, batch, cache, clen))
    compare_line("decode 4-slot qwen2.5-3b (1, 1)", "argument GB", p_args, args)
    compare_line("decode", "peak temp GB", tr["peak_bytes"], temp)
    compare_line("decode", "products GFLOP a step", tr["product_flops"], meas)
    del params, cache, model
    gc.collect()
    torch.cuda.empty_cache()
    # -- phase 13's (1, 2) paged qwen under the serve table, both positions
    # on this card: the trace counts every position (no position tags)
    t1 = time.perf_counter()
    step, p_args = paged_serve_step(cfg, "meta")
    with cost.CostCounter() as counter:
        step()
    tr = counter.result()
    log(f"[dryrun] paged (1, 2) trace {time.perf_counter() - t1:.1f} s")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    step, _ = paged_serve_step(cfg, dev)
    torch.cuda.synchronize()
    args = torch.cuda.memory_allocated() - base
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    temp = torch.cuda.max_memory_allocated() - base - args
    meas = profiled_products(step)
    compare_line("paged decode 4-slot qwen2.5-3b, serve table on (1, 2)", "argument GB",
                 p_args, args)
    compare_line("paged (1, 2)", "peak temp GB", tr["peak_bytes"], temp)
    compare_line("paged (1, 2)", "products GFLOP a step", tr["product_flops"], meas)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    # -- the sweep of every cell on (32, 8), from the committed trace
    sweep = json.loads(SWEEP.read_text())
    log(f"[dryrun] sweep {SWEEP.relative_to(ROOT)} ({len(sweep['results'])} cells, "
        f"{len(sweep['failures'])} failed; python -m repro_torch.launch.dryrun --all "
        "on the CPU): GB a card, fits 80 GB, dominant term")
    for r in sweep["results"]:
        roof = r["roofline"]
        log(f"[dryrun]   {r['arch']} x {r['shape']} on {r['mesh']}: "
            f"{roof['gb_per_card']:.2f} GB fits={roof['fits_80gb']} "
            f"dominant={roof['dominant']} accum={r['accum_steps']}")
    log(f"[dryrun] phase seconds={time.perf_counter() - t0:.1f}")


# ---------------------------------------------------------------------------
# phase 16: training and decode under the baseline tables on the card
# ---------------------------------------------------------------------------

MESH_TRAIN_STEPS = 3


def _max_gap(a, b, rel=False):
    import torch
    d = float((a.float() - b.float()).abs().max())
    return d / max(1.0, float(b.float().abs().max())) if rel else d


def mesh_train_phase(dev, card):
    """Phase 16 (see the module docstring)."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.mesh import make_test_mesh
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import Model
    from repro_torch.models import transformer as tfm
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train_step as tts

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    # -- (a) float32, published widths, 4 layers, (2, 2) train table
    cfg = dataclasses.replace(ARCHS["qwen2.5-3b"], num_layers=4, dtype="float32",
                              param_dtype="float32")
    sd = Model(cfg, device=dev).init(seed=0).state_dict()
    batch = train_data(cfg, dev, batch=4, seq=256).batch_at(0)
    step = tts.make_train_step(cfg, tts.TrainConfig())
    ref = Model(cfg, device=dev).load(sd, trainable=True)
    reset_counts()
    l0, _, g0 = step.loss_and_grads(ref, batch)
    ref, _, _ = step(ref, topt.init_opt_state(ref), batch)
    rules = shd.rules_for(make_test_mesh((2, 2), devices=dev), "train")
    placed = shd.place_params(Model(cfg, device=dev).load(sd), rules, trainable=True)
    with shd.use_rules(rules):
        l1, _, g1 = step.loss_and_grads(placed, batch)
        placed, _, _ = step(placed, topt.init_opt_state(placed), batch)
    counts = kernel_counts()
    log(f"[mesh_train] float32 flash launches: forward "
        f"{counts['flash_attention/simt_f32']}, backward kernel on simt_f32_bwd "
        f"{counts['flash_attention/simt_f32_bwd']} (wgmma_bwd "
        f"{counts['flash_attention/wgmma_bwd']})")
    if counts["flash_attention/simt_f32_bwd"] <= 0 or counts["flash_attention/wgmma_bwd"] \
            or counts["flash_attention/wgmma"]:
        raise AssertionError(f"mesh_train: float32 cells off the float32 routes: {counts}")
    dl = abs(float(l1) - float(l0)) / abs(float(l0))
    dg = max(_max_gap(shd.gather(g1[k]), g, rel=True) for k, g in g0.items())
    want, got = shd.full_state_dict(ref), shd.full_state_dict(placed)
    dp = max(_max_gap(got[k], p) for k, p in want.items())
    log(f"[mesh_train] float32 qwen2.5-3b widths, 4 layers, (2, 2) train table "
        f"against unsharded: loss rel {dl:.3e}, largest gradient gap {dg:.3e} "
        f"(of max(1, |leaf|)), largest param gap {dp:.3e} (bound 1e-5)")
    if not max(dl, dg, dp) <= 1e-5:
        raise AssertionError(f"mesh_train: float32 gaps {dl}, {dg}, {dp} > 1e-5")
    del sd, ref, placed, g0, g1, want, got
    gc.collect()
    torch.cuda.empty_cache()
    # -- (b) bf16 qwen2.5-3b, 36 layers, (2, 1): FSDP and batch over "data"
    cfg = ARCHS["qwen2.5-3b"]
    rules = shd.rules_for(make_test_mesh((2, 1), devices=dev), "train")
    data = train_data(cfg, dev)
    opt_cfg, step = train_step_fn(cfg)
    params = Model(cfg, device=dev).init(seed=0, trainable=True)
    batch = data.batch_at(0)
    half = {k: v[:TRAIN_BATCH // TRAIN_ACCUM] for k, v in batch.items()}
    l0, _, g0 = tts.loss_and_grads(params, half, cfg)
    placed = shd.place_params(params, rules, trainable=True)
    before = kfa.launches_by_route["wgmma_bwd"]
    with shd.use_rules(rules):
        l1, _, g1 = tts.loss_and_grads(placed, half, cfg)
    if kfa.launches_by_route["wgmma_bwd"] - before != 2 * cfg.num_layers:
        raise AssertionError("mesh_train: the (2, 1) microbatch did not run the bf16 "
                             "backward kernel once a layer and \"data\" shard")
    dl = abs(float(l1) - float(l0)) / abs(float(l0))
    dg = max(_max_gap(shd.gather(g1[k]), g, rel=True) for k, g in g0.items())
    log(f"[mesh_train] bf16 qwen2.5-3b 36 layers, (2, 1) train table against "
        f"unsharded, one microbatch: loss rel {dl:.3e}, largest gradient gap "
        f"{dg:.3e} (of max(1, |leaf|); bound 2e-2)")
    if not max(dl, dg) <= 2e-2:
        raise AssertionError(f"mesh_train: bf16 gaps {dl}, {dg} > 2e-2")
    del params, g0, g1
    gc.collect()
    torch.cuda.empty_cache()
    opt = topt.init_opt_state(placed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, tokens = [], TRAIN_BATCH * TRAIN_SEQ
    with shd.use_rules(rules):
        for i in range(MESH_TRAIN_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            placed, opt, m = step(placed, opt, data.batch_at(i))
            loss = float(m["loss"])
            walls.append((time.perf_counter() - t1) * 1e3)
            if not math.isfinite(loss):
                raise AssertionError(f"mesh_train: loss {loss}")
            log(f"[mesh_train] (2, 1) step {i} loss={loss:.4f} wall_ms={walls[-1]:.2f} "
                f"tok/s={tokens / walls[-1] * 1e3:.1f}")
    peak = torch.cuda.max_memory_allocated()
    tps = tokens / statistics.median(walls[1:]) * 1e3
    ref = TRAIN_RECORD or {"tok_s": float("nan"), "peak": float("nan")}
    log(f"[mesh_train] (2, 1) bf16 36 layers: {tps:.1f} tok/s (median of steps "
        f"1-{MESH_TRAIN_STEPS - 1}), peak {gb(peak)} GB; phase 12 unsharded: "
        f"{ref['tok_s']:.1f} tok/s, peak {ref['peak'] / 1e9:.3f} GB")
    del placed, opt
    gc.collect()
    torch.cuda.empty_cache()
    # -- (c) decode under the decode table, "kv_seq" over a (1, 2) mesh
    params = eos_guard(cfg, Model(cfg, device=dev).init(seed=0))
    rules_pf = shd.rules_for(make_test_mesh((1, 2), devices=dev), "prefill")
    rules_dec = shd.rules_for(rules_pf["mesh"], "decode")
    B, S, cap, n = 2, 1024, 4096, 8
    g = torch.Generator().manual_seed(15)
    tok = torch.randint(0, min(30000, cfg.vocab_size), (B, S), generator=g).to(dev)
    out = {}
    for how in ("unsharded", "kv_seq"):
        p = params if how == "unsharded" else shd.place_params(params, rules_pf)
        cache = tfm.init_cache(cfg, B, cap, dev)
        if how == "kv_seq":
            cache = shd.shard_put(cache, shd.cache_pspecs(cfg, rules_pf), rules_pf["mesh"])
        ctx = (lambda r: contextlib.nullcontext()) if how == "unsharded" else shd.use_rules
        pos = torch.arange(S, device=dev).expand(B, S)
        with ctx(rules_pf):
            lg, cache = tfm.prefill(p, {"tokens": tok, "positions": pos}, cfg, cache)
        logits = [lg[:, -1]]
        feed = out["unsharded"][1] if how == "kv_seq" else None
        ids = [lg[:, -1].argmax(-1)]
        for i in range(n):
            clen = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            nxt = ids[-1] if feed is None else feed[i]      # teacher-forced
            with ctx(rules_dec):
                lg, cache = tfm.decode_step(p, {"tokens": nxt[:, None],
                                                "positions": clen[:, None].long()},
                                            cfg, cache, clen)
            logits.append(lg[:, 0])
            ids.append(lg[:, 0].argmax(-1))
        out[how] = (torch.stack(logits), ids)
        del cache, p
    gap = _max_gap(out["kv_seq"][0], out["unsharded"][0], rel=True)
    agree = float(sum((a == b).float().mean() for a, b in zip(out["kv_seq"][1],
                                                             out["unsharded"][1]))
                  / (n + 1))
    log(f"[mesh_train] bf16 decode, decode table with kv_seq on (1, 2) against "
        f"unsharded ({S}-token prompts, {n} teacher-forced steps): greedy agreement "
        f"{agree:.4f}, largest logit gap {gap:.3e} of max(1, |logit|) (bound 2e-2)")
    if not gap <= 2e-2:
        raise AssertionError(f"mesh_train: decode logit gap {gap} > 2e-2")
    del params, out
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[mesh_train] phase seconds={time.perf_counter() - t0:.1f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="kernels,serve,spec,fame,apps,fleet,mesh,stateful,moe,"
                            "modality,checkpoint,train,stateful_train,dryrun,mesh_train",
                    help="comma list of kernels,serve,spec,fame,apps,fleet,mesh,"
                         "stateful,moe,modality,checkpoint,train,stateful_train,"
                         "dryrun,mesh_train (default: all)")
    args = ap.parse_args()
    t_start = t_lap = time.perf_counter()

    def lap(what):              # each phase's seconds, for the 1200 s budget
        nonlocal t_lap
        now = time.perf_counter()
        log(f"[time] {what}: {now - t_lap:.1f} s ({now - t_start:.1f} s since start)")
        t_lap = now

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
    count_run_on()
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

    lap("build")
    phases = set(args.phases.split(","))
    rows = kernel_phase(dev) if "kernels" in phases else {}
    lap("kernels")
    launches = collections.Counter()
    if phases & {"serve", "spec", "fame", "apps", "fleet", "mesh"}:
        model, params, tok = full_model(dev)
        if "serve" in phases:
            launches.update(serving_phases(dev, model, params, tok))
            lap("serve")
        if "spec" in phases:
            launches.update(spec_phase(dev, model, params, tok))
            lap("spec")
        if "fame" in phases:
            launches.update(fame_phase(dev, model, params))
            lap("fame")
        if "apps" in phases:
            launches.update(apps_phase(dev, model, params))
            lap("apps")
        if "fleet" in phases:
            launches.update(fleet_phase(dev, model, params, tok))
            lap("fleet")
        if "mesh" in phases:
            mrows, mc, n_seqpar = mesh_phase(dev, model, params, tok)
            rows.update(mrows)
            launches.update(mc)
            launches["seqpar_decode_attention"] = n_seqpar
            lap("mesh")
        del model, params
        torch.cuda.empty_cache()
    if "stateful" in phases:
        sc = stateful_phase(dev)
        launches.update(sc)
        # recurrentgemma-9b's flash and ring-decode calls: hd 256, one KV
        # head, window 2048
        launches["flash_attention_hd256"] = sc.get("flash_attention", 0)
        launches["decode_attention_ring"] = sc.get("decode_attention", 0)
        lap("stateful")
    if "moe" in phases:
        mc = moe_phase(dev)
        for counts in mc.values():
            launches.update(counts)
        # mixtral-8x22b's flash and ring-decode calls: G = 6, window 4096
        launches["flash_attention_swa"] = mc["mixtral-8x22b"]["flash_attention"]
        launches["decode_attention_swa_ring"] = mc["mixtral-8x22b"]["decode_attention"]
        lap("moe")
    if "modality" in phases:
        mo = modality_phase(dev)
        for counts in mo.values():
            launches.update(counts)
        # musicgen-large's calls (MHA at hd 64) and chameleon-34b's flash
        mg = mo["musicgen-large"]
        for k in ("flash_attention", "decode_attention", "paged_decode_attention"):
            launches[f"{k}_musicgen"] = mg[k]
        launches["flash_attention_chameleon"] = mo["chameleon-34b"]["flash_attention"]
        lap("modality")
    if "checkpoint" in phases:
        checkpoint_phase(dev)
        lap("checkpoint")
    if "train" in phases:
        trows, tc = train_phase(dev, card)
        rows.update(trows)
        launches["flash_attention_train"] = tc["flash_attention/wgmma"]
        launches["flash_attention_bwd"] = tc["flash_attention/wgmma_bwd"]
        rows["flash_attention_bwd"]["routes"] = {
            r: tc[f"flash_attention/{r}"] for r in ("wgmma_bwd", "simt_f32_bwd")}
        lap("train")
    if "stateful_train" in phases:
        srows, sc = stateful_train_phase(dev, card)
        rows.update(srows)
        launches["rglru_scan_train"] = sc["recurrentgemma-9b"]["rglru_scan/chunked"]
        launches["rglru_scan_bwd"] = sc["recurrentgemma-9b"]["rglru_scan/chunked_bwd"]
        rows["rglru_scan_bwd"]["routes"] = {
            r: sc["recurrentgemma-9b"][f"rglru_scan/{r}"]
            for r in ("chunked_bwd", "sequential_bwd")}
        launches["slstm_scan"] += sc["xlstm-350m"]["slstm_scan/cluster"]
        launches["slstm_scan_bwd"] = sc["xlstm-350m"]["slstm_scan/cluster_bwd"]
        for r in ("slstm_scan", "slstm_scan_bwd"):
            if r in rows:
                rows[r]["routes"] = {k: sc["xlstm-350m"][f"slstm_scan/{k}"]
                                     for k in ("cluster", "cluster_bwd")}
        launches["mlstm_chunk_train"] = sc["xlstm-350m"]["mlstm_chunk/wgmma"]
        launches["mlstm_chunk_bwd"] = sc["xlstm-350m"]["mlstm_chunk/wgmma_bwd"]
        rows["mlstm_chunk_bwd"]["routes"] = {
            r: sc["xlstm-350m"][f"mlstm_chunk/{r}"] for r in ("wgmma_bwd", "simt_f32_bwd")}
        # recurrentgemma-9b's flash backward calls: hd 256, one KV head
        launches["flash_attention_bwd_hd256"] = \
            sc["recurrentgemma-9b"]["flash_attention/wgmma_bwd"]
        if "flash_attention_bwd_hd256" in rows:
            rows["flash_attention_bwd_hd256"]["routes"] = {
                r: sc["recurrentgemma-9b"][f"flash_attention/{r}"]
                for r in ("wgmma_bwd", "simt_f32_bwd")}
        lap("stateful_train")
    if "dryrun" in phases:
        dryrun_phase(dev, card)
        lap("dryrun")
    if "mesh_train" in phases:
        mesh_train_phase(dev, card)
        lap("mesh_train")
    for name, r in rows.items():
        r["launches"] = launches.get(name, 0)
    if {"serve", "spec", "stateful", "moe", "modality", "train",
            "stateful_train"} <= phases:
        idle = [name for name, r in rows.items() if r["launches"] <= 0]
        if idle:
            raise AssertionError(f"kernels never launched on the main path: {idle}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("device_ms", "library_device_ms", "backward_ms", "backward_device_ms",
             "backward_bound_ms", "plain_backward_ms", "library_backward_ms",
             "library_backward_device_ms", "written_out_ms", "written_out_device_ms",
             "routes", "serial_floor_ms", "keep_ms", "admission", "plain_autograd_ms")
    log(card)
    log(json.dumps({"kernels": [{k: r[k] for k in keys + extra if k in r}
                                for r in rows.values()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
