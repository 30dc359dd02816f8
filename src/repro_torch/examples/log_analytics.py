"""Log-analytics app (§4.1): error filtering → aggregation → visualization,
showing S3 file handling and the artifacts left in the object store.

    PYTHONPATH=src python -m repro_torch.examples.log_analytics [--log L1] [--config M+C] [--device cpu]

The agents are the scripted oracles, so the whole run is on the host; the
script still takes ``--device`` as every entry point of the port does, and
without a card it needs ``--device cpu``.
"""
from __future__ import annotations

import argparse
from typing import List, Tuple

from repro_torch.apps import log_analytics as la
from repro_torch.core.config import CONFIGS
from repro_torch.core.runtime import FameRuntime, SessionResult
from repro_torch.device import resolve_device

BUCKETS = ("fame-timestamps", "fame-plots", "fame-mcp-cache")


def run(log: str, config: str) -> Tuple[SessionResult, List[str]]:
    """The log's three queries under memory config ``config``: the session
    result and the lines the script prints (answers, object-store
    listing)."""
    rt = FameRuntime(config=CONFIGS[config])
    for role, o in la.build_oracles().items():
        rt.set_llm(role, o)
    rt.deploy_mcp(la.APP.servers, la.APP.sources)

    meta = la.data.LOGS[log]
    lines = [f"log: {meta['path']} ({meta['kind']}, {meta['kb']}KB), "
             f"errors: {meta['errors']}"]
    res = rt.run_session(f"la-{log}", la.APP.queries(log))
    for qi, (resp, st) in enumerate(zip(res.responses, res.statuses)):
        lines.append(f"\nQ{qi + 1} [{st}]: {resp[:200]}")
    lines.append("\nobject-store artifacts:")
    for bucket in BUCKETS:
        keys = rt.objects.list(bucket)
        lines.append(f"  s3://{bucket}/: {len(keys)} objects "
                     f"{keys[:3] if keys else ''}")
    return res, lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--log", default="L1", choices=["L1", "L2", "L3"])
    ap.add_argument("--config", default="M+C", choices=sorted(CONFIGS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    print("\n".join(run(args.log, args.config)[1]))


if __name__ == "__main__":
    main()
