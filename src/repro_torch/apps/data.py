"""Deterministic synthetic corpus for the two reference applications.

Paper instances mirror §4.1 (titles + PDF sizes); extracted-text sizes are
calibrated so config-N token counts land in the ranges Fig. 5 reports
(~4.7 KB text per MB of PDF). Log files mirror the LogHub samples.
"""
from __future__ import annotations

import dataclasses
import hashlib
import random
from typing import Dict, List

# ---------------------------------------------------------------------------
# Research papers (P1–P3)
# ---------------------------------------------------------------------------

PAPERS = {
    "P1": {"title": "Multi-scale competition in the Majorana-Kondo system",
           "pdf_mb": 5.6},
    "P2": {"title": "Chondrule formation by collisions of planetesimals "
                    "containing volatiles triggered by Jupiter's formation",
           "pdf_mb": 2.1},
    "P3": {"title": "Resolving the flat-spectrum conundrum: clumpy aerosol "
                    "distributions in sub-Neptune atmospheres",
           "pdf_mb": 3.7},
}

_SECTIONS = ["Introduction", "Contributions", "Methodology", "Analysis",
             "Results", "Conclusions", "Implications", "Future Work"]


def _det_words(seed: str, n: int) -> str:
    rng = random.Random(int(hashlib.sha256(seed.encode()).hexdigest()[:8], 16))
    vocab = ["the", "system", "we", "observe", "scaling", "regime", "coupling",
             "measurement", "model", "spectral", "analysis", "parameter",
             "estimate", "distribution", "dynamics", "interaction", "phase",
             "signal", "response", "structure", "temperature", "formation"]
    return " ".join(rng.choice(vocab) for _ in range(n))


def paper_content(pid: str) -> str:
    """Deterministic 'extracted text' for a paper, sized from its PDF MB."""
    meta = PAPERS[pid]
    chars_target = int(meta["pdf_mb"] * 4_700)
    per_section = max(200, chars_target // (6 * len(_SECTIONS)))
    parts = [f"TITLE: {meta['title']}"]
    for sec in _SECTIONS:
        parts.append(f"\n== {sec} ==\n" + _det_words(pid + sec, per_section))
    text = "\n".join(parts)
    reps = max(1, chars_target // max(len(text), 1))
    return (text * reps)[:chars_target]


def title_of(pid: str) -> str:
    return PAPERS[pid]["title"]


def pid_by_title(title: str) -> str:
    for pid, meta in PAPERS.items():
        if meta["title"].lower() in title.lower() or title.lower() in meta["title"].lower():
            return pid
    raise KeyError(f"unknown paper title: {title!r}")


# ---------------------------------------------------------------------------
# Log files (L1–L3, LogHub-style)
# ---------------------------------------------------------------------------

LOGS = {
    "L1": {"path": "/logs/apache.log", "kind": "Apache", "kb": 170,
           "errors": {"AH01630": 214, "AH00558": 97, "AH00163": 41}},
    "L2": {"path": "/logs/hadoop.log", "kind": "Hadoop", "kb": 380,
           "errors": {"LeaseExpired": 331, "BlockMissing": 120, "DiskChecker": 58}},
    "L3": {"path": "/logs/openssh.log", "kind": "OpenSSH", "kb": 220,
           "errors": {"AuthFail": 402, "ConnReset": 154, "Timeout": 66}},
}


@dataclasses.dataclass
class LogLine:
    ts: float
    error: str
    text: str


def log_lines(lid: str) -> List[LogLine]:
    meta = LOGS[lid]
    rng = random.Random(int(hashlib.sha256(lid.encode()).hexdigest()[:8], 16))
    lines = []
    t = 1_700_000_000.0
    for error, count in meta["errors"].items():
        for i in range(count):
            t_i = t + rng.random() * 86_400
            lines.append(LogLine(round(t_i, 3), error,
                                 f"{t_i:.3f} [{meta['kind']}] ERROR {error} "
                                 f"worker={rng.randint(1, 64)} detail={_det_words(lid + error + str(i), 6)}"))
    lines.sort(key=lambda l: l.ts)
    return lines


def log_text(lid: str) -> str:
    body = "\n".join(l.text for l in log_lines(lid))
    target = LOGS[lid]["kb"] * 1024
    filler = "\n# heartbeat ok " + _det_words(lid + "hb", 8)
    while len(body) < target:
        body += filler
    return body[:target]


def lid_by_path(path: str) -> str:
    for lid, meta in LOGS.items():
        if meta["path"] == path or path.endswith(meta["path"].rsplit("/", 1)[-1]):
            return lid
    raise KeyError(f"unknown log path: {path!r}")


def most_frequent_error(lid: str) -> str:
    return max(LOGS[lid]["errors"].items(), key=lambda kv: kv[1])[0]
