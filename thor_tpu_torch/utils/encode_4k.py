"""A 3840x2160 device encode that decodes back exactly, with its replay.

    python -m thor_tpu_torch.utils.encode_4k [n_frames] [--reps N]
        [--device cpu] [--out result.json]

Counterpart of thor_tpu's tools/encode_4k.py. Encodes the first frames of
testdata/test_4k.yuv (5 are committed) with the device encoder in the RA
form of the 1080p RA-form encode (RA_4K below, built in code: thor_tpu's
tool reads a reference config file), with Encoder(record=True); 2160 is
not a multiple of 64, so the last superblock row holds 48 lines. Then:
  - bit_exact_roundtrip: the port's decoder reads the stream back to the
    encoder's reconstruction;
  - the stream's bytes, the end-to-end encode fps (host clock, the whole
    encode_sequence call);
  - the replay's device fps of the P and B frames
    (utils/device_encode_fps.replay, gated on equal reconstructions),
    with its host waits per frame;
  - the peak device memory (torch.cuda.max_memory_allocated).
Prints one JSON line and writes nothing into the tree unless --out is
given.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..dec.decoder import decode_file
from ..device import resolve_device, synchronize
from ..enc.encoder import Encoder, EncoderParams, read_yuv_frames
from .device_encode_fps import TESTDATA, replay

INPUT_4K = TESTDATA / "test_4k.yuv"
W, H = 3840, 2160
RA_4K = dict(width=W, height=H, qp=32, device_encode=1, max_num_ref=2,
             enable_bipred=1, num_reorder_pics=3, interp_ref=1,
             use_block_contexts=1, encoder_speed=0)


def measure(n=3, reps=2, device=None):
    """The result dict; raises when a replayed frame differs from the
    live reconstruction."""
    dev = resolve_device(device)
    frames = list(read_yuv_frames(INPUT_4K, W, H, n))
    cuda = dev.type == "cuda"
    synchronize(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    enc = Encoder(EncoderParams.in_code(num_frames=len(frames), **RA_4K),
                  device=dev, record=True)
    with tempfile.TemporaryDirectory() as tmp:
        bit = Path(tmp) / "enc_4k.bit"
        t0 = time.perf_counter()
        recons = enc.encode_sequence(frames, str(bit))
        synchronize(dev)
        e2e = time.perf_counter() - t0
        size = bit.stat().st_size
        dec = decode_file(str(bit), device=dev)
    ok = len(dec) == len(recons) and all(
        np.array_equal(a, b) for r, d in zip(recons, dec)
        for a, b in zip(r, d))
    rep = replay(enc, recons, reps) if enc.device_record else None
    return {
        "width": W, "height": H, "frames": len(frames),
        "form": "RA (max_num_ref 2, bipred, num_reorder_pics 3, interp_ref, "
                "block contexts, encoder_speed 0), qp 32",
        "bit_exact_roundtrip": bool(ok), "stream_bytes": size,
        "encode_e2e_seconds": e2e, "encode_e2e_fps": len(frames) / e2e,
        "replayed_frames": rep and rep["frames"],
        "encode_device_fps": rep and rep["device_fps"],
        "replay_seconds": rep and rep["seconds"],
        "replay_host_waits_per_frame": rep and rep["host_waits_per_frame"],
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if cuda else None),
        "device": str(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("frames", nargs="?", type=int, default=3)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cpu runs the kernels' plain versions")
    ap.add_argument("--out", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    r = measure(args.frames, args.reps, args.device)
    if r["device"].startswith("cuda"):
        r["card"] = torch.cuda.get_device_name(0)
    s = json.dumps(r)
    if args.out:
        Path(args.out).write_text(s + "\n")
    print(s)


if __name__ == "__main__":
    main()
