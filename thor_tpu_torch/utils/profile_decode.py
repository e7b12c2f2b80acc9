"""Where a decode's time goes on the card.

    python -m thor_tpu_torch.utils.profile_decode [stream.bit] [--json out]

The stream defaults to testdata/LDB_medium_complexity_1080.bit; give
testdata/RA16_high_efficiency_1080.bit for the path that synthesizes
interpolated references. Decodes the stream once to warm up, then:
  - times the host stages alone, frame by frame (C entropy parse, numpy
    input build), on the host clock;
  - decodes it again under torch.profiler (CPU + CUDA activities) and
    sums device time by kernel, grouped into the port's CUDA kernels,
    host<->device copies and PyTorch's own kernels (residual, filters,
    padding), against the decode's wall time.
Prints one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..bitstream.reader import BitReader, iter_frames
from ..codec.constants import MAX_REF_FRAMES
from ..dec.decoder import Decoder
from ..dec.inputs import build_frame_inputs
from ..dec.parse import SequenceHeader
from ..native import parse_frame, seqhdr_from_python

DEFAULT = "testdata/LDB_medium_complexity_1080.bit"


def host_stages(path):
    """Mean host ms per frame of the parse and the input build, run
    serially (the decoder overlaps them in threads)."""
    payloads = list(iter_frames(path))
    br = BitReader(payloads[0])
    seq = SequenceHeader.read(br)
    cs = seqhdr_from_python(seq)
    nums = [0] * MAX_REF_FRAMES
    pos, tp, tb = br.pos, 0.0, 0.0
    for p in payloads:
        t0 = time.perf_counter()
        nf = parse_frame(p, pos, cs, nums)
        t1 = time.perf_counter()
        build_frame_inputs(nf, seq, nums)
        tb += time.perf_counter() - t1
        tp += t1 - t0
        pos = 0
        nums = [nf.hdr.display_frame_num] + nums[:-1]
    n = len(payloads)
    return {"frames": n, "parse_ms_per_frame": tp / n * 1e3,
            "build_ms_per_frame": tb / n * 1e3}


def _group(name: str) -> str:
    if "mot_comp_kernel" in name:
        return "mot_comp + mot_comp_uv (csrc/interp_mc.cu)"
    if "me_walk_kernel" in name or "me_merge_kernel" in name:
        return "me_level (csrc/interp_me.cu)"
    if "mc_kernel" in name:
        return "mc_frame (csrc/mc.cu)"
    if "enc_intra_scan_kernel" in name:
        return "encode_scan (csrc/enc_intra_scan.cu)"
    if "intra_scan_kernel" in name:
        return "intra_scan (csrc/intra_scan.cu)"
    if "Memcpy" in name or "memcpy" in name:
        return "memcpy " + ("HtoD" if "HtoD" in name else
                            "DtoH" if "DtoH" in name else "other")
    return "PyTorch kernels"


def profile_run(run):
    """Runs `run()` under torch.profiler (CPU + CUDA activities), ending
    in a synchronize: (run's result, wall ms, device ms by group, the 12
    kernels with most device time as (ms, launches, name), launches)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups, kernels, launches = {}, [], 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if not us or e.key.startswith("aten::") or e.key.startswith("cuda"):
            continue
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        kernels.append((us / 1e3, e.count, e.key[:90]))
        launches += e.count
    kernels.sort(reverse=True)
    return result, wall, groups, kernels[:12], launches


def device_profile(path, dev):
    """(frames, wall ms of one decode, device ms by group, top kernels)."""
    n, wall, groups, top, _ = profile_run(
        lambda: sum(1 for _ in Decoder(device=dev).decode_stream(path)))
    return n, wall, groups, top


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("stream", nargs="?", default=DEFAULT)
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    sum(1 for _ in Decoder(device=dev).decode_stream(args.stream))  # warm
    host = host_stages(args.stream)
    n, wall, groups, top = device_profile(args.stream, dev)
    busy = sum(groups.values())
    out = {"stream": args.stream, "card": torch.cuda.get_device_name(0),
           "host": host, "profiled_frames": n, "wall_ms": wall,
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
