"""Quickstart: deploy a FAME stack and run one multi-turn agentic session.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--config M+C] [--app RS] [--device cpu]

``--llm oracle`` (default) drives the workflow with the deterministic
scripted oracle; ``--llm torch`` hosts the agents on the port's serving
stack — an ``repro_torch.serving.server.LLMServer`` session per agent role
(tokenize → prefill → decode on a reduced architecture; untrained weights,
so workflow outcomes DNF — the point is the serving path). The server runs
on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
from typing import List, Tuple

from repro_torch.apps import log_analytics as la
from repro_torch.apps import research_summary as rs
from repro_torch.configs.registry import ARCHS
from repro_torch.core.config import CONFIGS
from repro_torch.core.llm import TorchLLM, rates_for_arch
from repro_torch.core.runtime import FameRuntime, SessionResult
from repro_torch.device import resolve_device
from repro_torch.serving.server import EngineConfig, LLMServer

APPS = {"RS": rs, "LA": la}
STAT_KEYS = ("sessions_opened", "session_turns", "turn_prefix_hits",
             "decode_tokens", "host_syncs_per_token", "active_slots_per_step")


def make_server(cfg, device="cuda", params=None) -> LLMServer:
    """The quickstart's server for ``cfg``: 4 slots, capacity 512,
    ``cache_mode="paged"``."""
    return LLMServer(cfg, num_slots=4, capacity=512, params=params,
                     engine_cfg=EngineConfig(cache_mode="paged"),
                     device=device)


def torch_backend(server: LLMServer, arch: str) -> TorchLLM:
    return TorchLLM(server, max_new_tokens=8, latency=rates_for_arch(arch))


def build_torch_backend(arch: str, device="cuda", params=None):
    """FAME agents on the session-oriented serving API (LLMServer) of the
    reduced float32 ``arch``: (server, backend). ``params``: a state dict
    or ``TransformerParams`` (default: random from the server's seed)."""
    cfg = ARCHS[arch].reduced(dtype="float32", param_dtype="float32",
                              vocab_size=512)
    server = make_server(cfg, device, params)
    return server, torch_backend(server, arch)


def run(app: str, config: str, fusion: str, llm) -> Tuple[SessionResult, List[str]]:
    """One session of ``app`` ("RS" / "LA") on its first input under memory
    config ``config`` and fusion mode ``fusion``. ``llm`` is the backend
    every agent role is hosted on (a ``TorchLLM``) or a dict of role ->
    backend (``build_oracles()``). Returns the session result and the
    lines the script prints after its header."""
    mod = APPS[app]
    roles = llm if isinstance(llm, dict) else dict.fromkeys(mod.build_oracles(), llm)
    rt = FameRuntime(config=CONFIGS[config], fusion_mode=fusion)
    for role, backend in roles.items():
        rt.set_llm(role, backend)
    rt.deploy_mcp(mod.APP.servers, mod.APP.sources)

    lines = [f"deployed functions: {sorted(rt.platform.functions)}"]
    for w in rt._wrapped:
        lines.append(f"--- generated wrapper for MCP server {w.server.name!r} ---")
        lines.append(w.wrapper_source.splitlines()[2])

    inp = mod.APP.inputs[0]
    res = rt.run_session(f"quickstart-{inp}", mod.APP.queries(inp))
    for qi, (q, resp, status) in enumerate(
            zip(mod.APP.queries(inp), res.responses, res.statuses)):
        tr = res.traces[qi]
        i_tok, o_tok = tr.llm_tokens()
        lines.append(f"\nQ{qi + 1}: {q[:78]}")
        lines.append(f"  status={status} in_tokens={i_tok} out_tokens={o_tok} "
                     f"tool_calls={tr.count('mcp')}")
        lines.append(f"  answer: {resp[:120]}...")
    lines.append(f"\ncache hits: {rt.cache.hits}  "
                 f"memory entries: {len(rt.memory.recall(f'quickstart-{inp}'))}")
    cost = {k: round(sum(t.cost_breakdown()[k] for t in res.traces), 3)
            for k in ("llm_cents", "faas_agent_cents", "faas_mcp_cents")}
    lines.append(f"cost breakdown (cents): {cost}")
    if isinstance(llm, TorchLLM):
        st = llm.serving_stats()
        shown = {k: st[k] for k in STAT_KEYS if k in st}
        lines.append(f"serving stats: {shown}")
    return res, lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="M+C", choices=sorted(CONFIGS))
    ap.add_argument("--app", default="RS", choices=["RS", "LA"])
    ap.add_argument("--fusion", default="singleton",
                    choices=["singleton", "consolidated"])
    ap.add_argument("--llm", default="oracle", choices=["oracle", "torch"],
                    help="oracle: scripted deterministic LLM; torch: the real "
                         "serving stack behind an LLMServer session per role")
    ap.add_argument("--arch", default="qwen2.5-3b",
                    help="architecture for --llm torch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.llm == "torch":
        _, llm = build_torch_backend(args.arch, device)
    else:
        llm = APPS[args.app].build_oracles()
    _, lines = run(args.app, args.config, args.fusion, llm)
    print(f"=== FAME quickstart: app={args.app} config={args.config} "
          f"fusion={args.fusion} llm={args.llm} ===")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
