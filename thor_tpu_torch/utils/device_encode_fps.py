"""Device-only encode throughput of the device encoder's P and B frames,
and of its I frames.

    python -m thor_tpu_torch.utils.device_encode_fps [--frames N]
        [--reps N] [--device cpu] [--path fused|eager|both]
        [--input 4k|cif] [--json out]

Counterpart of thor_tpu's tools/device_encode_fps.py. Encodes the
top-left 1920x1080 crop of testdata/test_4k.yuv (frames 0..N-1; --input
cif: the whole 352x288 frames of testdata/test_cif.yuv) with
Encoder(record=True), in the low-delay B form of
LDB_medium_complexity_1080.bit's header (LDB_1080 below, built in code:
thor_tpu's tool reads a reference config file), then runs every recorded
P/B frame again through enc/device_inter.replay_device_frame, back to
back, with the reference chain on the device and one wait at the end:
ME, the trials, the intra search, the final reconstruction (kernels 2
and 6) and the filters, without the host's decision walk and emit. The
records hold their inputs on the device already (on the fused path,
Encoder(fused=True), the default: the packed inputs of the three
programs of enc/fused.py, whose CUDA graphs the replay runs again).

Gate: every replayed frame's reconstruction equals the live encode's
(checked after the clock stops); without that, no number is reported.
The calls that make the host wait for the card are counted
(utils/tracing.host_waits) during one untimed replay, and frame by frame
during the live encode (per P/B frame, with their sites); the live
encode's graph captures (signatures) and their host ms come from
ops/graphs.STATS. --path both (the default) runs the fused path, then the
stage-wise one (fused=False), each encoded and replayed. The I frames
are timed and replayed on their own ("intra": enc/fused_intra
.replay_intra_frame over the records of Encoder(record=True), the two
programs of enc/fused_intra.py on the fused path, the search, the scans
and the filters stage by stage on the other; gated like the P/B frames),
with their host waits and their "search" and "scan" + "filters" stage ms
(on the fused path the final program holds the filters). Prints one
JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device, synchronize
from ..enc.device_inter import replay_device_frame
from ..enc.encoder import Encoder, EncoderParams, crop_yuv_frames
from ..enc.fused_intra import replay_intra_frame
from ..ops import graphs as G
from .tracing import host_waits

TESTDATA = Path(__file__).resolve().parents[2] / "testdata"
INPUT_4K = (TESTDATA / "test_4k.yuv", 3840, 2160)
INPUT_CIF = (TESTDATA / "test_cif.yuv", 352, 288)      # 10 frames
# the sequence header of LDB_medium_complexity_1080.bit: two references,
# bipred, deblocking, CLPF, block contexts, no tb / pb split, no delta-QP
LDB_1080 = dict(width=1920, height=1080, qp=32, device_encode=1,
                max_num_ref=2, enable_bipred=1, encoder_speed=0,
                deblocking=1, clpf=1, use_block_contexts=1)


def _replayed(records, recons, run, reps):
    """Run `run()` (each record's frame again, [(frame_num, planes)]) back
    to back `reps` times after one untimed run that counts the host waits;
    the dict of replay(). Raises when a frame of the last run differs from
    the live reconstruction."""
    dev = records[0]["org"][0].device
    with host_waits(dev) as sites:
        run()
    synchronize(dev)
    secs = []
    for _ in range(reps):
        synchronize(dev)
        t0 = time.perf_counter()
        out = run()
        synchronize(dev)
        secs.append(time.perf_counter() - t0)
    for fn, planes in out:
        if not all(np.array_equal(p.cpu().numpy(), q)
                   for p, q in zip(planes, recons[fn])):
            raise AssertionError(f"the replay of frame {fn} differs from "
                                 "the live reconstruction")
    n = len(records)
    return {"frames": n, "reps": reps, "seconds": secs,
            "device_fps": n / min(secs),
            "host_waits_per_frame": sum(sites.values()) / n,
            "host_wait_sites": {f"{a}:{b}": c for (a, b), c in
                                sorted(sites.items())}}


def replay(enc, recons, reps=3):
    """Replay the records of a recorded encode (`enc`, whose sequence
    returned `recons` in display order) back to back `reps` times after
    one untimed run that counts the host waits. Returns a dict: frames,
    the seconds of each timed run, device_fps (frames over the best run),
    the host waits per frame and their sites. Raises when a frame of the
    last run differs from the live reconstruction."""
    records = enc.device_record
    if not records:
        raise ValueError("the encode recorded no P or B frame")

    def run():
        refstate = {}
        return [(rec["frame_num"], replay_device_frame(rec, refstate))
                for rec in records]

    return _replayed(records, recons, run, reps)


def replay_intra(enc, recons, reps=3):
    """replay() for the I frames of a recorded encode (enc.intra_record):
    each frame's device work again, its reconstruction gated on the live
    one."""
    records = enc.intra_record
    if not records:
        raise ValueError("the encode recorded no device I frame")
    return _replayed(records, recons, lambda: [
        (rec["frame_num"], replay_intra_frame(rec)) for rec in records],
        reps)


class WaitCounted(Encoder):
    """An Encoder that counts, frame by frame, the calls that make the
    host wait for the card (utils/tracing.host_waits): `waits` holds one
    Counter of (file, line) -> calls per frame, in coding order."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.waits = []

    def encode_frame(self, w):
        with host_waits(self.device) as sites:
            super().encode_frame(w)
        self.waits.append(sites)


def live_counts(enc):
    """The P/B frames of a WaitCounted encode: their count, the host waits
    a frame (mean) with their sites (summed over the frames), the graph
    captures a frame (mean) and, frame by frame in coding order, the
    captures and their host ms (0 on the stage-wise path)."""
    pb = [i for i, ft in enumerate(enc.frame_times) if "final" in ft]
    sites = {}
    for i in pb:
        for (a, b), c in enc.waits[i].items():
            sites[f"{a}:{b}"] = sites.get(f"{a}:{b}", 0) + c
    n = max(len(pb), 1)
    return {"pb_frames": len(pb),
            "live_host_waits_per_pb_frame": sum(
                sum(enc.waits[i].values()) for i in pb) / n,
            "live_host_wait_sites": dict(sorted(sites.items())),
            "live_captures_per_pb_frame": sum(
                enc.frame_times[i].get("captures", 0) for i in pb) / n,
            "captures_by_pb_frame": [enc.frame_times[i].get("captures", 0)
                                     for i in pb],
            "capture_ms_by_pb_frame": [
                enc.frame_times[i].get("capture", 0.0) * 1e3 for i in pb]}


def intra_counts(enc):
    """The device I frames of a WaitCounted encode: their count, the host
    waits a frame (mean) with their sites (summed), and the mean ms of
    "search" and of "scan" + "filters" (Encoder.frame_times)."""
    ii = [i for i, ft in enumerate(enc.frame_times) if "tus" in ft]
    n = max(len(ii), 1)
    sites = {}
    for i in ii:
        for (a, b), c in enc.waits[i].items():
            sites[f"{a}:{b}"] = sites.get(f"{a}:{b}", 0) + c
    ft = [enc.frame_times[i] for i in ii]
    return {"i_frames": len(ii),
            "live_host_waits_per_i_frame": sum(
                sum(enc.waits[i].values()) for i in ii) / n,
            "live_host_wait_sites": dict(sorted(sites.items())),
            "search_ms": sum(t["search"] for t in ft) * 1e3 / n,
            "scan_filters_ms": sum(t["scan"] + t["filters"]
                                   for t in ft) * 1e3 / n,
            "emit_ms": sum(t["emit"] for t in ft) * 1e3 / n}


def measure(frames, fields, reps=3, device=None, out_path=os.devnull,
            fused=True):
    """Encode `frames` with EncoderParams.in_code(**fields), record=True
    and `fused` (the live encode's wall seconds in "encode_seconds", its
    host waits and captures by live_counts, the graph captures and their
    host ms over the encode), then replay(): its dict, with "intra":
    intra_counts() and replay_intra()."""
    dev = resolve_device(device)
    enc = WaitCounted(EncoderParams.in_code(num_frames=len(frames),
                                            **fields),
                      device=dev, record=True, fused=fused)
    s0 = dict(G.STATS)
    t0 = time.perf_counter()
    recons = enc.encode_sequence(frames, out_path)
    synchronize(dev)
    wall = time.perf_counter() - t0
    return {"encode_seconds": wall, "path": "fused" if fused else "eager",
            **live_counts(enc),
            "captures": G.STATS["captures"] - s0["captures"],
            "capture_ms": G.STATS["capture_ms"] - s0["capture_ms"],
            **replay(enc, recons, reps), "device": str(dev),
            "intra": {**intra_counts(enc),
                      **replay_intra(enc, recons, reps)}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4,
                    help="frames of the sequence (the first is an I frame)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cpu runs the kernels' plain versions")
    ap.add_argument("--path", default="both",
                    choices=("fused", "eager", "both"),
                    help="fused: Encoder(fused=True) (the default path); "
                    "eager: fused=False; both: fused, then eager")
    ap.add_argument("--input", default="4k", choices=("4k", "cif"),
                    help="4k: the 1920x1080 crop of test_4k.yuv (5 frames); "
                    "cif: test_cif.yuv (352x288, 10 frames)")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    src, sw, sh = INPUT_CIF if args.input == "cif" else INPUT_4K
    w, h = (sw, sh) if args.input == "cif" else (1920, 1080)
    frames = crop_yuv_frames(src, sw, sh, w, h, args.frames)
    paths = {"both": (True, False), "fused": (True,), "eager": (False,)}
    r = {"form": f"LDB {w}x{h}"}
    for fused in paths[args.path]:
        r["fused" if fused else "eager"] = measure(
            frames, dict(LDB_1080, width=w, height=h), args.reps,
            args.device, fused=fused)
    if resolve_device(args.device).type == "cuda":
        r["card"] = torch.cuda.get_device_name(0)
    s = json.dumps(r)
    if args.json:
        Path(args.json).write_text(s + "\n")
    print(s)


if __name__ == "__main__":
    main()
