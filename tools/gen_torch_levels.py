#!/usr/bin/env python3
"""Write thor_tpu's dependency-level sizes of the golden streams.

    JAX_PLATFORMS=cpu python3 tools/gen_torch_levels.py [stream ...]

`thor_tpu.parallel.stream.ShardedDecoder` reconstructs a stream in
dependency levels: each level holds every parsed frame whose read
references are already made. The port's ShardedDecoder
(thor_tpu_torch/parallel/stream.py) must form the same levels. A machine
with a CUDA card has no JAX, so thor_tpu's sizes are kept as data: this
tool decodes each stream of STREAMS (or the named ones) with
`ShardedDecoder(gop=1, tile=1)` on one CPU device, checks the frames
against the stream's golden, and writes `last_level_sizes` into
testdata/torch_levels.json (written as <file>.part and renamed when
complete; streams already in the file and not named keep their entry).

STREAMS and LEVELS are what the port's tests and chip_smoke.py read.
Nothing of thor_tpu or JAX is imported until main() runs.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "testdata"
LEVELS = TESTDATA / "torch_levels.json"

CIF_STREAMS = ("intra_only", "LDB_low_complexity", "LDB_medium_complexity",
               "LDB_high_efficiency", "RA_low_complexity",
               "RA16_high_efficiency", "HDB16_medium_complexity")
STREAMS = CIF_STREAMS + ("RA16_long", "LDB_medium_complexity_1080",
                         "RA16_high_efficiency_1080")


def load_levels() -> dict:
    """{stream: [level sizes]} from testdata/torch_levels.json."""
    return json.loads(LEVELS.read_text()) if LEVELS.exists() else {}


def golden_sha256(name: str) -> str:
    yuv = TESTDATA / f"{name}_dec.yuv"
    if yuv.exists():
        return hashlib.sha256(yuv.read_bytes()).hexdigest()
    return (TESTDATA / f"{name}_dec.sha256").read_text().split()[0]


def thor_tpu_levels(name: str) -> list:
    """thor_tpu's level sizes of testdata/<name>.bit on one CPU device;
    raises if the decode differs from the golden."""
    import jax
    from thor_tpu.parallel.stream import ShardedDecoder

    sd = ShardedDecoder(gop=1, tile=1, devices=jax.devices("cpu")[:1])
    h = hashlib.sha256()
    for planes in sd.iter_frames(str(TESTDATA / f"{name}.bit")):
        for p in planes:
            h.update(p.tobytes())
    if h.hexdigest() != golden_sha256(name):
        raise RuntimeError(f"thor_tpu's sharded decode of {name} differs "
                           "from its golden")
    return list(sd.last_level_sizes)


def main(argv):
    sys.path.insert(0, str(ROOT))
    names = argv or list(STREAMS)
    for name in names:
        if name not in STREAMS:
            raise SystemExit(f"unknown stream {name}; one of {STREAMS}")
    levels = load_levels()
    for name in names:
        t0 = time.perf_counter()
        levels[name] = thor_tpu_levels(name)
        part = LEVELS.with_name(LEVELS.name + ".part")
        part.write_text(json.dumps(
            {k: levels[k] for k in STREAMS if k in levels}, indent=1) + "\n")
        part.replace(LEVELS)
        print(f"{name}: {len(levels[name])} levels {levels[name]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
