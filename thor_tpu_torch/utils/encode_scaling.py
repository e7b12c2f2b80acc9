"""GOP-parallel encode scaling over slots.

    python -m thor_tpu_torch.utils.encode_scaling [slots ...] [--frames N]
        [--device cpu] [--eager] [--json out]

Counterpart of thor_tpu's tools/encode_scaling.py. Encodes the top-left
176x144 crop of testdata/test_cif.yuv (9 frames) in the RA form of
tools/gen_torch_enc_goldens.py's ra_qcif case (RA_QCIF below, built in
code: thor_tpu's tool reads a reference config file) with the sequential
Encoder, then through parallel/encode.ShardedEncoder at 1, 2 and 4 slots:
CUDA streams of the one card, or the cards in turn where more than one is
visible (CPU slots with --device cpu). Both run the Encoder's CUDA
graphs (fused, the default; each slot on its own lane) or, with --eager,
its stages one by one. Every encode is timed warm, after an untimed
one: the sequential Encoder's on the card's lane, each sharded point's
on the same slots (so on lanes that hold their graphs already). Gate:
every stream equals the sequential Encoder's bytes, and its reconstruction the Encoder's. Reports each
encode's seconds and fps and the speedup over one slot. Writes nothing
into the tree; prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device, synchronize
from ..enc.encoder import Encoder, EncoderParams, crop_yuv_frames
from ..parallel.encode import ShardedEncoder
from .device_encode_fps import TESTDATA

INPUT_CIF = (TESTDATA / "test_cif.yuv", 352, 288)
# ra_qcif's fields: hierarchical B frames on a synthesized reference,
# tb-split trials and the fast paths
RA_QCIF = dict(width=176, height=144, qp=32, device_encode=1, max_num_ref=2,
               enable_bipred=1, use_block_contexts=1, num_reorder_pics=3,
               interp_ref=1, enable_tb_split=1, encoder_speed=2)


def measure(slots=(1, 2, 4), n=9, device=None, fused: bool = True):
    """{"sequential": {seconds, fps}, "points": {k: {seconds, fps,
    speedup}}, "bytes", "fused"}; raises when a stream or reconstruction
    differs from the sequential Encoder's. fused: Encoder(fused=) and
    ShardedEncoder(fused=)."""
    dev = resolve_device(device)
    frames = crop_yuv_frames(*INPUT_CIF, 176, 144, n)

    def params():
        return EncoderParams.in_code(num_frames=n, **RA_QCIF)

    def timed(encoder, out):
        synchronize(dev)
        t0 = time.perf_counter()
        rec = encoder.encode_sequence(frames, str(out))
        synchronize(dev)
        return rec, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        seq_out = Path(tmp) / "seq.bit"
        Encoder(params(), device=dev, fused=fused).encode_sequence(
            frames, str(seq_out))
        rec0, dt0 = timed(Encoder(params(), device=dev, fused=fused),
                          seq_out)
        want = seq_out.read_bytes()
        cards = torch.cuda.device_count() if dev.type == "cuda" else 1
        points = {}
        for k in slots:
            devices = [dev] * k if cards == 1 else \
                [torch.device("cuda", i % cards) for i in range(k)]
            out = Path(tmp) / f"slots{k}.bit"
            first = ShardedEncoder(params(), devices=devices, fused=fused)
            first.encode_sequence(frames, str(out))
            se = ShardedEncoder(params(), devices=devices, fused=fused)
            se.slots = first.slots
            rec, dt = timed(se, out)
            if out.read_bytes() != want or len(rec) != len(rec0) or not all(
                    np.array_equal(a, b) for x, y in zip(rec, rec0)
                    for a, b in zip(x, y)):
                raise AssertionError(f"{k} slots: the stream or its "
                                     "reconstruction differs from the "
                                     "sequential Encoder's")
            points[k] = {"seconds": dt, "fps": n / dt}
    for pt in points.values():
        pt["speedup"] = points[slots[0]]["seconds"] / pt["seconds"]
    return {"clip": f"QCIF RA form, {n} frames", "bytes": len(want),
            "sequential": {"seconds": dt0, "fps": n / dt0},
            "points": points, "device": str(dev), "fused": fused}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("slots", nargs="*", type=int, default=[1, 2, 4])
    ap.add_argument("--frames", type=int, default=9)
    ap.add_argument("--device", default=None,
                    help="cpu: CPU slots, the kernels' plain versions")
    ap.add_argument("--eager", action="store_true",
                    help="the eager stages (fused=False)")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    r = measure(args.slots, args.frames, args.device, not args.eager)
    if r["device"].startswith("cuda"):
        r["cards"] = torch.cuda.device_count()
        r["card"] = torch.cuda.get_device_name(0)
    s = json.dumps(r)
    if args.json:
        Path(args.json).write_text(s + "\n")
    print(s)


if __name__ == "__main__":
    main()
