"""Where an all-intra device encode's time goes on the card.

    python -m thor_tpu_torch.utils.profile_encode [--json out]

Encodes the top-left 1920x1080 crop of testdata/test_4k.yuv, every frame
an I frame (QP 32, 10 intra modes, deblocking, CLPF, block contexts):
three frames on the host clock for the stage times (search, scan, emit,
filters; Encoder.frame_times), then one frame under torch.profiler (CPU +
CUDA activities) for the device time by kernel, grouped into the scan
kernel, host<->device copies and PyTorch's own kernels (the search and the
filters), the number of kernel launches, and the device's idle share of
that frame's wall time. The profiler slows the host down, so its wall
time is longer than the unprofiled frames'. Prints one JSON object. Needs
a CUDA device; run it from the repo's root.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import torch

from ..enc.encoder import Encoder, EncoderParams, read_yuv_frames
from .profile_decode import profile_run

INPUT = ("testdata/test_4k.yuv", 3840, 2160)
W, H = 1920, 1080


def crop_frames(n):
    path, sw, sh = INPUT
    return [(y[:H, :W].copy(), u[:H // 2, :W // 2].copy(),
             v[:H // 2, :W // 2].copy())
            for y, u, v in read_yuv_frames(path, sw, sh, n)]


def encode(frames, out_path):
    enc = Encoder(EncoderParams(
        width=W, height=H, qp=32, intra_period=1, num_frames=len(frames),
        device_encode=1, intra_rdo=1, use_block_contexts=1))
    enc.encode_sequence(frames, out_path)
    return enc.frame_times


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_encode needs a CUDA device")
    frames = crop_frames(3)
    with tempfile.TemporaryDirectory() as tmp:
        out_path = str(Path(tmp) / "o.bit")
        encode(frames[:1], out_path)                           # warm
        times = encode(frames, out_path)
        _, wall, groups, top, launches = profile_run(
            lambda: encode(frames[:1], out_path))
    busy = sum(groups.values())
    out = {"card": torch.cuda.get_device_name(0),
           "stage_ms_per_frame_unprofiled": [
               {k: (v * 1e3 if k != "tus" else v) for k, v in t.items()}
               for t in times],
           "profiled_frames": 1, "wall_ms": wall, "kernel_launches": launches,
           "device_ms_by_group": groups, "device_busy_ms": busy,
           "device_idle_share": max(0.0, 1 - busy / wall),
           "top_kernels_ms_count_name": top}
    s = json.dumps(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(s + "\n")
    print(s)


if __name__ == "__main__":
    main()
