"""Serve a (reduced) assigned architecture behind concurrent FAME workflows
through the session-oriented serving API: N workflows open N sessions on one
``LLMServer``, every round their Planner/Actor/Evaluator turns are submitted
as non-blocking handles BEFORE any is drained — so they co-batch inside the
same engine steps — and each session's next turn restores the previous
turn's end-of-generation state instead of re-prefilling the conversation.

    PYTHONPATH=src python -m repro_torch.examples.serve_agents --arch recurrentgemma-9b [--device cpu]

The server runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.apps import research_summary as rs
from repro_torch.configs.registry import ARCHS
from repro_torch.core.config import CONFIGS
from repro_torch.device import resolve_device
from repro_torch.fame import WorkflowServingRuntime
from repro_torch.serving.server import EngineConfig, LLMServer, SamplingParams

ROLES = [("planner", "Plan the next step toward the goal."),
         ("actor", "Act: run the planned tool call."),
         ("evaluator", "Evaluate the output; pass or retry.")]


def make_server(cfg, *, slots=4, chunk=16, block_w=256, cache_mode="paged",
                spec_len=0, device="cuda", params=None) -> LLMServer:
    """The script's server for ``cfg`` (capacity 512)."""
    return LLMServer(cfg, num_slots=slots, capacity=512, params=params,
                     engine_cfg=EngineConfig(decode_chunk=chunk,
                                             block_w=block_w,
                                             cache_mode=cache_mode,
                                             spec_len=spec_len),
                     device=device)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"


def run(server: LLMServer, *, workflows=3, rounds=2, temperature=0.0,
        top_k=0) -> dict:
    """The script's two parts on ``server``, printing as it goes: the
    co-batched workflow rounds (with the streaming demo), then an M+C
    research-summary FAME session through ``WorkflowServingRuntime``.
    Returns the rounds' handles, the server's ``stats()`` after them, the
    FAME session result and its meter summary."""
    eng = server.engine
    ecfg = eng.engine_cfg
    print(f"server up: arch={eng.cfg.name} slots={eng.num_slots} "
          f"buckets={list(eng.buckets)} chunk={ecfg.decode_chunk} "
          f"cache={ecfg.cache_mode} spec_len={ecfg.spec_len}")

    # 1) N concurrent workflows: one session per workflow, handles co-batch
    params = SamplingParams(max_new_tokens=10, temperature=temperature,
                            top_k=top_k)
    sessions = [server.open_session() for _ in range(workflows)]
    convs = [f"System: cooperating agents, workflow {w}. Keep tool calls "
             f"minimal, cite evidence. " for w in range(workflows)]
    t0 = time.time()
    toks = turns = 0
    all_handles = []
    for r in range(rounds):
        for role, ask in ROLES:
            # submit EVERY workflow's turn before draining any — that is
            # what lets the engine co-batch them in the same decode chunks
            handles = [sessions[w].submit(convs[w] + f"[{role} r{r}] {ask} ",
                                          params)
                       for w in range(workflows)]
            if r == 0 and role == "planner":
                # streaming demo on the first turn of workflow 0
                print("streaming turn 0.0: ", end="")
                for piece in handles[0].stream():
                    print(repr(piece), end=" ")
                print()
            server.run_until_idle()
            for w, h in enumerate(handles):
                convs[w] = sessions[w].text
                toks += h.request.output_tokens
                turns += 1
            all_handles += handles
    dt = time.time() - t0
    stats = server.stats()
    print(f"co-batched serving: {workflows} workflows x {turns // max(workflows, 1)} "
          f"turns, {toks} tokens, {dt:.1f}s wall ({toks / dt:.1f} tok/s on "
          f"{device_name(server.device)})")
    print(f"fast path: {stats['prefill_compiles']} prefill compiles over "
          f"{len(stats['prefill_buckets'])} buckets, "
          f"{stats['host_syncs_per_token']:.3f} host syncs/token, "
          f"{stats['active_slots_per_step']:.2f} active slots/engine step")
    print(f"sessions: {stats['sessions_opened']} opened, "
          f"{stats['session_turns']} turns, "
          f"{stats['turn_prefix_hits']} admitted off the retained tail, "
          f"{stats['stream_chunks']} stream chunks")
    if ecfg.cache_mode == "paged":
        kind = ("shared pages" if "pages_total" in stats
                else "restored state snapshots")
        pool = (f"{stats['pages_free']}/{stats['pages_total']} pages free"
                if "pages_total" in stats else
                f"{stats['snapshots_free']}/{stats['snapshots_total']} "
                f"snapshot rows free")
        print(f"prefix sharing: {stats['prefix_hit_rate']:.0%} of prompt "
              f"tokens served from {kind} "
              f"({stats['prefix_hit_tokens']}/{stats['prompt_tokens']}), "
              f"{stats['radix_nodes']} radix nodes, {pool}")

    # 2) the same server under the FAME workflow runtime: one persistent
    #    session per invocation chain (memory == tail reuse), oracle-guided
    #    decisions, tool results injected through the cache
    rt = WorkflowServingRuntime(
        config=CONFIGS["M+C"], server=server,
        params=SamplingParams(max_new_tokens=8,
                              temperature=temperature, top_k=top_k))
    for role, oracle in rs.build_oracles().items():
        rt.set_llm(role, oracle)
    rt.deploy_mcp(rs.APP.servers, rs.APP.sources)
    res = rt.run_session("serve-demo", rs.APP.queries("P1")[:2])
    m = rt.meter.summary()
    print(f"FAME workflow on the server: statuses={res.statuses} "
          f"turns={m['turns']} injections={m['injections']} "
          f"billed_in={m['billed_in_tokens']} of {m['prompt_tokens']} "
          f"prompt tokens ({m['continuation_turns']} continuation turns "
          f"reused the session tail)")
    print("(decisions are oracle-guided over the served conversation — "
          "untrained weights decode noise — but every agent turn and tool "
          "injection above was a real tokenize->prefill->decode request)")
    return {"handles": all_handles, "stats": stats, "fame": res,
            "meter": m}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=sorted(ARCHS))
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--workflows", type=int, default=3,
                    help="concurrent agent workflows (one session each)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="Planner/Actor/Evaluator rounds per workflow")
    ap.add_argument("--chunk", type=int, default=16,
                    help="decode tokens per decode chunk")
    ap.add_argument("--block-w", type=int, default=256,
                    help="decode-attention KV block (cache capacity aligns to it)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--cache-mode", default="paged", choices=("dense", "paged"),
                    help="paged = radix prefix sharing + session tail reuse: "
                         "KV page pool on full-attention archs, per-prefix "
                         "recurrent-state snapshots on stateful archs; turns "
                         "that extend their conversation skip its prefill")
    ap.add_argument("--spec-len", type=int, default=0,
                    help="speculative decode: max draft tokens per verify "
                         "step from the prompt n-gram lookup drafter "
                         "(0 = off); copy-heavy agent outputs decode "
                         "several tokens per forward")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch].reduced(dtype="float32", param_dtype="float32",
                                   vocab_size=512)
    server = make_server(cfg, slots=args.slots, chunk=args.chunk,
                         block_w=args.block_w, cache_mode=args.cache_mode,
                         spec_len=args.spec_len,
                         device=resolve_device(args.device))
    run(server, workflows=args.workflows, rounds=args.rounds,
        temperature=args.temperature, top_k=args.top_k)


if __name__ == "__main__":
    main()
