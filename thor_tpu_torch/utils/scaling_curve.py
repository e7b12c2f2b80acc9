"""GOP-parallel decode scaling of a stream over slots.

    python -m thor_tpu_torch.utils.scaling_curve [stream.bit] [g ...]
        [--device cpu] [--eager] [--json out]

Counterpart of thor_tpu's tools/scaling_curve.py. Decodes the stream
(testdata/RA16_long.bit by default: two dyadic sub-GOPs, levels up to 8
frames) through parallel/stream.ShardedDecoder(gop=g, tile=1) at
g = 1, 2, 4, 8 slots: CUDA streams of the one card, or the cards in turn
where more than one is visible (CPU slots with --device cpu), each slot
replaying CUDA graphs on its lane (fused, the default; --eager: the
stages one by one). Each point is one warm decode after an untimed one. Gates: every decode equals the
first point's and the stream's golden (utils/device_decode_fps.golden_of).
Reports fps, the speedup over the first point and the dependency-limited
ceiling: with g slots a level of L frames takes ceil(L / g) steps, so
independent slots could reach sum(L) / sum(ceil(L / g)). Prints one JSON
object.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from pathlib import Path

import torch

from ..device import resolve_device, synchronize
from ..parallel.stream import ShardedDecoder
from .device_decode_fps import golden_of

TESTDATA = Path(__file__).resolve().parents[2] / "testdata"
DEFAULT = str(TESTDATA / "RA16_long.bit")


def measure(path=DEFAULT, sizes=(1, 2, 4, 8), device=None,
            fused: bool = True):
    """{"points": {g: {fps, speedup, dependency_ceiling}}, "levels",
    "frames", "fused"}; raises when a decode differs from the golden or
    from the first point's. fused: ShardedDecoder(fused=)."""
    dev = resolve_device(device)
    devices = ["cpu"] if dev.type == "cpu" else None
    kind, want = golden_of(path)
    base = levels = None
    points = {}
    for g in sizes:
        dec = ShardedDecoder(gop=g, tile=1, devices=devices, fused=fused)
        dec.decode_stream(str(path))
        synchronize(dev)
        t0 = time.perf_counter()
        frames = dec.decode_stream(str(path))
        synchronize(dev)
        dt = time.perf_counter() - t0
        data = b"".join(p.tobytes() for f in frames for p in f)
        if (data if kind == "yuv" else hashlib.sha256(data).hexdigest()) \
                != want:
            raise AssertionError(f"gop={g}: the decode differs from the "
                                 f"golden ({kind})")
        if base is None:
            base, fps0 = data, len(frames) / dt
        elif data != base:
            raise AssertionError(f"gop={g}: the decode differs from "
                                 f"gop={sizes[0]}'s")
        levels = dec.last_level_sizes
        fps = len(frames) / dt
        steps = sum(-(-n // g) for n in levels)
        points[g] = {"fps": fps, "speedup": fps / fps0,
                     "dependency_ceiling": sum(levels) / steps}
    return {"stream": str(path), "frames": len(frames), "levels": levels,
            "points": points, "device": str(dev), "fused": fused}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("stream", nargs="?", default=DEFAULT)
    ap.add_argument("sizes", nargs="*", type=int, default=[1, 2, 4, 8])
    ap.add_argument("--device", default=None,
                    help="cpu: CPU slots, the kernels' plain versions")
    ap.add_argument("--eager", action="store_true",
                    help="the eager stages (ShardedDecoder(fused=False))")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    r = measure(args.stream, args.sizes, args.device, not args.eager)
    if r["device"].startswith("cuda"):
        r["cards"] = torch.cuda.device_count()
        r["card"] = torch.cuda.get_device_name(0)
    s = json.dumps(r)
    if args.json:
        Path(args.json).write_text(s + "\n")
    print(s)


if __name__ == "__main__":
    main()
