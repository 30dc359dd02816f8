"""Count the decode steps a source tree of the PyTorch port runs after every
row of a chunk has stopped, on one NVIDIA card.

Runs ``chip_smoke.eos_stops`` (this checkout's) against the port under
``--src``: reduced float32 qwen2.5-3b with no EOS guard, so rows stop at
EOS at different steps, dense and paged, on the graph path and on the eager
steps. Prints one JSON line: per mode and path the decode steps, chunks,
the steps run after every row's last emit (``run_on``) and whether the ids
equal the other path's. Compare two trees on the same card, one after the other:

    python3 tools/run_on.py --src build/parent/src
    python3 tools/run_on.py --src src

Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("run_on: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    dev = torch.device("cuda", 0)
    out = {"src": args.src}
    for mode in ("dense", "paged"):
        got = {how: chip_smoke.eos_stops(dev, mode, eager=how == "eager")
               for how in ("graph", "eager")}
        for how, r in got.items():
            out[f"{mode}_{how}"] = {k: r[k] for k in ("decode_steps", "decode_chunks",
                                                      "run_on")}
        out[f"{mode}_ids_equal"] = got["graph"]["ids"] == got["eager"]["ids"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
