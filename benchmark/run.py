"""Run one cell of the benchmark once, on the card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. Prints, as the last line of standard
output, one JSON object (correct, attempted, failed, metrics, device,
with --trace 1 also breakdown, then the compared numbers under
"checks"); the compared numbers are also the last lines of standard
error. --trace 0 reports the cell's end-to-end metrics, --trace 1 its
per-layer metrics from a traced sub-window.

Without a CUDA device, or with fewer cards than the cell asks for, it
exits with code 2 and prints no result: it never falls back to the CPU
(the CPU rehearsal is benchmark.harness.run_cell, which only the tests
call). A run that loads jax, jaxlib, flax or thor_tpu exits with code 3.
Build and kernel caches stay inside the checkout (thor_tpu_torch/_build
for the port's kernels, benchmark/.cache for the rest).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """This process's start on the time.time() clock (from /proc; the
    interpreter's own start-up is part of set-up), or now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        t = btime + start / ticks
        return t if 0 <= time.time() - t < 600 else time.time()
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path.cwd()
    cache = root / "benchmark" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    from benchmark import harness
    try:
        spec = harness.benchmark_spec(root)
        entry = next(w for w in spec["workloads"]
                     if w["name"] == args.workload)
    except (OSError, StopIteration, KeyError, ValueError) as e:
        print(f"no cell {args.workload!r}: {e!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on a card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"the cell needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda:0", T_START, root)
    except harness.CellError as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
