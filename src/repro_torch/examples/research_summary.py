"""Research-paper-summarization app (§4.1) across all five memory configs —
reproduces the paper's Fig. 3/4 behaviour interactively.

    PYTHONPATH=src python -m repro_torch.examples.research_summary [--paper P1] [--device cpu]

The agents are the scripted oracles, so the whole run is on the host; the
script still takes ``--device`` as every entry point of the port does, and
without a card it needs ``--device cpu``.
"""
from __future__ import annotations

import argparse
from typing import List

from repro_torch.apps import research_summary as rs
from repro_torch.core.config import CONFIGS
from repro_torch.core.runtime import FameRuntime
from repro_torch.device import resolve_device

CONFIG_ORDER = ("E", "N", "C", "M", "M+C")


def table(paper: str) -> List[str]:
    """The paper's three queries under each memory config: status and FaaS
    span per query, input tokens and end-to-end seconds per config."""
    lines = [f"paper: {rs.data.title_of(paper)!r}",
             f"{'config':6s} {'Q1':>14s} {'Q2':>14s} {'Q3':>14s} "
             f"{'in_tok':>8s} {'e2e_s':>7s}"]
    for cname in CONFIG_ORDER:
        rt = FameRuntime(config=CONFIGS[cname])
        for role, o in rs.build_oracles().items():
            rt.set_llm(role, o)
        rt.deploy_mcp(rs.APP.servers, rs.APP.sources)
        res = rt.run_session(f"s-{paper}", rs.queries(paper))
        cells = []
        for st, tr in zip(res.statuses, res.traces):
            faas = [s for s in tr.spans if s.kind == "faas"]
            dur = (max(s.t_end for s in faas) - min(s.t_start for s in faas)
                   if faas else 0)
            cells.append(f"{'OK' if st == 'SUCCEEDED' else 'DNF'}/{dur:5.1f}s")
        tok = sum(t.llm_tokens()[0] for t in res.traces)
        tot = sum(max((s.t_end for s in t.spans if s.kind == 'faas'), default=0)
                  - min((s.t_start for s in t.spans if s.kind == 'faas'), default=0)
                  for t in res.traces)
        lines.append(f"{cname:6s} {cells[0]:>14s} {cells[1]:>14s} "
                     f"{cells[2]:>14s} {tok:8d} {tot:7.1f}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--paper", default="P1", choices=["P1", "P2", "P3"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    print("\n".join(table(args.paper)))


if __name__ == "__main__":
    main()
