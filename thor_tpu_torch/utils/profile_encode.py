"""Where a device encode's time goes on the card.

    python -m thor_tpu_torch.utils.profile_encode [--pb] [--eager]
        [--json out]

Encodes the top-left 1920x1080 crop of testdata/test_4k.yuv (QP 32,
deblocking, CLPF, block contexts). By default every frame is an I frame
(10 intra modes): three frames on the host clock for the stage times
(Encoder.frame_times), then one frame under torch.profiler, on the fused
path (Encoder(fused=True): enc/fused_intra.py's two CUDA graphs) and
then, in a second round, stage by stage (fused=False), each round with
its host waits an I frame by file:line and its search and scan +
filters ms (utils/device_encode_fps.intra_counts). With --pb the
sequence is the low-delay B form of LDB_PB below (I P P P, two references
from frame 2, bipred, encoder_speed 0): four frames on the host clock,
then the same four again with each frame under a profiler of its own, and
the last P frame's profile is the one reported; the P frames run on the
fused path (Encoder(fused=True), enc/fused.py's CUDA graphs) and then,
in a second round, stage by stage (fused=False), each round with its
host waits a P frame by file:line (utils/tracing.host_waits) and its
graph captures and their host ms, and the I frame's profile beside the
P frame's ("i_frame"); --eager runs the second round only. A
profile holds the device time by kernel, grouped into the port's
kernels, host<->device copies and PyTorch's own kernels, the number of
kernel launches, the host calls that queued work (a graph replay is
one), and the device's idle share of that frame's wall time. The
profiler slows the host down, so its wall time is longer than the
unprofiled frames'. Prints one JSON object. Needs a CUDA device; run it
from the repo's root.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import torch

from ..enc.encoder import Encoder, EncoderParams, crop_yuv_frames
from ..ops import graphs as G
from .device_encode_fps import WaitCounted, intra_counts, live_counts
from .profile_decode import profile_run

INPUT = ("testdata/test_4k.yuv", 3840, 2160)
W, H = 1920, 1080
INTRA = dict(intra_period=1, intra_rdo=1)
# the sequence header of LDB_medium_complexity_1080.bit (two references,
# bipred, deblocking, CLPF, block contexts, no tb / pb split, no delta-QP)
LDB_PB = dict(max_num_ref=2, enable_bipred=1, encoder_speed=0)


def crop_frames(n):
    return crop_yuv_frames(*INPUT, W, H, n)


def params(n, form):
    return EncoderParams(width=W, height=H, qp=32, num_frames=n,
                         device_encode=1, deblocking=1, clpf=1,
                         use_block_contexts=1, **form)


class ProfiledEncoder(Encoder):
    """An Encoder that runs every frame under a torch.profiler of its own
    and keeps, per frame, profile_run's (wall ms, device ms by group, top
    kernels, launches, host launch calls) in `profiles`."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.profiles = []

    def encode_frame(self, w):
        self.profiles.append(profile_run(
            lambda: super(ProfiledEncoder, self).encode_frame(w))[1:])


def summary(wall, groups, top, launches, calls):
    busy = sum(groups.values())
    return {"wall_ms": wall, "kernel_launches": launches,
            "host_launch_calls": calls,
            "device_ms_by_group": groups, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / wall),
            "top_kernels_ms_count_name": top}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pb", action="store_true",
                    help="the LDB-form I P P P encode, profiling a P frame")
    ap.add_argument("--eager", action="store_true",
                    help="the stage-wise round only")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_encode needs a CUDA device")
    form = LDB_PB if args.pb else INTRA
    n = 4 if args.pb else 3
    frames = crop_frames(n)
    out = {"card": torch.cuda.get_device_name(0),
           "form": "LDB I P P P" if args.pb else "all-intra"}
    rounds = (False,) if args.eager else (True, False)
    with tempfile.TemporaryDirectory() as tmp:
        out_path = str(Path(tmp) / "o.bit")
        Encoder(params(1, form)).encode_sequence(frames[:1], out_path)  # warm
        for fused in rounds:
            s0 = dict(G.STATS)
            enc = WaitCounted(params(n, form), fused=fused)
            enc.encode_sequence(frames, out_path)
            prof = ProfiledEncoder(params(n if args.pb else 1, form),
                                   fused=fused)
            prof.encode_sequence(frames if args.pb else frames[:1], out_path)
            r = {"stage_ms_per_frame_unprofiled": [
                    {k: (v * 1e3 if isinstance(v, float) else v)
                     for k, v in t.items()} for t in enc.frame_times],
                 **live_counts(enc),
                 "intra": intra_counts(enc),
                 "captures": G.STATS["captures"] - s0["captures"],
                 "capture_ms": G.STATS["capture_ms"] - s0["capture_ms"],
                 "profiled_frame": len(prof.profiles) - 1,
                 "launches_per_frame_profiled": [p[3] for p in prof.profiles],
                 "host_launch_calls_per_frame_profiled": [
                     p[4] for p in prof.profiles],
                 **summary(*prof.profiles[-1])}
            if args.pb:
                r["i_frame"] = summary(*prof.profiles[0])
            out["fused" if fused else "eager"] = r
    s = json.dumps(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(s + "\n")
    print(s)


if __name__ == "__main__":
    main()
