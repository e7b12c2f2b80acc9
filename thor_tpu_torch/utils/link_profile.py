"""The host<->card link and the end-to-end decode floor it sets.

    python -m thor_tpu_torch.utils.link_profile [W H]   (default 1920 1080)

Counterpart of thor_tpu's tools/link_profile.py. Decoding to host YUV
ships W*H*3/2 bytes a frame from the card to the host, so the decode
cannot run faster than the device-to-host rate over that size:
link_floor_fps = 1 / (the seconds of one frame's copy). The copies are
made as the decoder makes them (dec/decoder._Output, dec/reconstruct
.to_device), with thor_tpu's method:
  - device to host: a tensor generated on the card for each sample, made
    and summed to a scalar before the clock starts, copied into pinned
    memory without blocking and waited for by an event;
  - host to device: fresh host data for each sample, pinned and copied
    without blocking, then synced by fetching a strided scalar sum.
Best of REPS samples each, after one warm sample. It measures the card
only: on the CPU there is no link, and it raises. Prints one JSON line.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..device import resolve_device


REPS = 4


def measure_link(frame_bytes: int, device=None):
    """The device-to-host and host-to-device copy of `frame_bytes` bytes
    on `device` (the card by default): a dict with the best of REPS
    samples each and the floor fps of a decode that outputs frames of
    that size."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("measure_link times the link between the host and "
                         "a CUDA device; the CPU has none")
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    n = frame_bytes

    def fresh():
        return torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                             generator=gen)

    def scalar(d):
        return int(d[::65536].sum())

    def d2h(d):
        host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        host.copy_(d, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()

    def h2d(x):
        scalar(torch.from_numpy(x).pin_memory().to(dev, non_blocking=True))

    down, up = [], []
    for _ in range(REPS + 1):
        d = fresh()
        scalar(d)                       # made on the card before the clock
        t0 = time.perf_counter()
        d2h(d)
        down.append(time.perf_counter() - t0)
    for _ in range(REPS + 1):
        x = rng.integers(0, 256, n, dtype=np.uint8)
        t0 = time.perf_counter()
        h2d(x)
        up.append(time.perf_counter() - t0)
    best_d2h, best_h2d = min(down[1:]), min(up[1:])
    return {"frame_bytes": frame_bytes,
            "d2h_ms": round(best_d2h * 1e3, 3),
            "d2h_MBps": round(frame_bytes / best_d2h / 1e6, 1),
            "h2d_ms": round(best_h2d * 1e3, 3),
            "link_floor_fps": round(1.0 / best_d2h, 2),
            "card": torch.cuda.get_device_name(dev)}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    W, H = (int(argv[0]), int(argv[1])) if len(argv) >= 2 else (1920, 1080)
    out = measure_link(W * H * 3 // 2)
    out["resolution"] = f"{W}x{H}"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
