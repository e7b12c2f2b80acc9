"""Where a decode's time goes on the card.

    python -m thor_tpu_torch.utils.profile_decode [stream.bit] [--json out]

The stream defaults to testdata/LDB_medium_complexity_1080.bit; give
testdata/RA16_high_efficiency_1080.bit for the path that synthesizes
interpolated references. Decodes the stream once to warm up, then:
  - times the host stages alone, frame by frame (C entropy parse, numpy
    input build, the fused path's bucketing and packing), on the host
    clock;
  - decodes it again under torch.profiler (CPU + CUDA activities) and
    sums device time by kernel, grouped into the port's CUDA kernels,
    host<->device copies and PyTorch's own kernels (residual, filters,
    padding), against the decode's wall time, with the host calls that
    queued work a frame;
  - on a stream with interpolated references, the host calls of one
    interpolated reference, warm, through its CUDA graph
    (ops/interp_fused.run_interp, the Decoder's path) and stage by stage
    (ops/interp.interpolate_frames).
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
from ..dec.fused import bucket_inputs, pack_frame
from ..dec.inputs import build_frame_inputs
from ..dec.parse import SequenceHeader
from ..native import parse_frame, seqhdr_from_python
from .tracing import StageTimer, device_trace

DEFAULT = "testdata/LDB_medium_complexity_1080.bit"


def host_stages(path):
    """Mean host ms per frame of the parse, the input build and the fused
    path's bucketing and packing (dec/fused.py), run serially (the decoder
    overlaps them in threads)."""
    payloads = list(iter_frames(path))
    br = BitReader(payloads[0])
    seq = SequenceHeader.read(br)
    cs = seqhdr_from_python(seq)
    nums = [0] * MAX_REF_FRAMES
    pos = br.pos
    timer = StageTimer()
    for p in payloads:
        with timer.stage("parse"):
            nf = parse_frame(p, pos, cs, nums)
        with timer.stage("build"):
            cfg, inp, _ = build_frame_inputs(nf, seq, nums)
        with timer.stage("pack"):
            pack_frame(cfg, bucket_inputs(cfg, inp), seq.bipred)
        pos = 0
        nums = [nf.hdr.display_frame_num] + nums[:-1]
    n = len(payloads)
    return {"frames": n,
            "parse_ms_per_frame": timer.totals["parse"] / n * 1e3,
            "build_ms_per_frame": timer.totals["build"] / n * 1e3,
            "pack_ms_per_frame": timer.totals["pack"] / n * 1e3}


def _group(name: str) -> str:
    if "mot_comp_" in name:    # mot_comp_row_kernel, earlier mot_comp_kernel
        return "mot_comp + mot_comp_uv (csrc/interp_mc.cu)"
    if "me_walk_kernel" in name or "me_merge_kernel" in name:
        return "me_level (csrc/interp_me.cu)"
    if "mc_kernel" in name:
        return "mc_frame (csrc/mc.cu)"
    if "me_subpel_kernel" in name:
        return "subpel_search (csrc/me_subpel.cu)"
    if "enc_intra_scan_kernel" in name:
        return "encode_scan (csrc/enc_intra_scan.cu)"
    if "intra_scan_" in name:      # the scan and its unit-table kernel
        return "intra_scan (csrc/intra_scan.cu)"
    if "scan_init_kernel" in name or "scan_owner_kernel" in name:
        return "the scans' prologue (csrc/scan_common.cuh)"
    if "Memcpy" in name or "memcpy" in name:
        return "memcpy " + ("HtoD" if "HtoD" in name else
                            "DtoH" if "DtoH" in name else "other")
    return "PyTorch kernels"


# the host calls that queue work on the card, as the profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cuMemcpy", "cuMemset")


def _profiled(run):
    """(run's result, wall ms, key_averages()) of `run()` under
    torch.profiler (CPU + CUDA activities), ending in a synchronize."""
    with device_trace(None, "cuda") as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return result, wall, prof.key_averages()


def _device_events(averages):
    """(device us, count, name) of each kernel or copy the card ran."""
    for e in averages:
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        # CUPTI's own buffer requests show as device events: not launches
        if not us or e.key.startswith("aten::") or e.key.startswith("cuda") \
                or e.key == "Activity Buffer Request":
            continue
        yield us, e.count, e.key


def profile_run(run):
    """Runs `run()` under torch.profiler (CPU + CUDA activities), ending
    in a synchronize: (run's result, wall ms, device ms by group, the 12
    kernels with most device time as (ms, launches, name), the kernels
    and copies the card ran, the host calls that queued work
    (LAUNCH_CALLS: a CUDA graph's replay is one))."""
    result, wall, averages = _profiled(run)
    groups, kernels, launches = {}, [], 0
    for us, count, key in _device_events(averages):
        g = _group(key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        kernels.append((us / 1e3, count, key[:90]))
        launches += count
    kernels.sort(reverse=True)
    calls = sum(e.count for e in averages if e.key.startswith(LAUNCH_CALLS))
    return result, wall, groups, kernels[:12], launches, calls


def device_profile(path, dev):
    """(frames, wall ms of one decode, device ms by group, top kernels,
    host launch calls)."""
    n, wall, groups, top, _, calls = profile_run(
        lambda: sum(1 for _ in Decoder(device=dev).decode_stream(path)))
    return n, wall, groups, top, calls


def interp_launch_calls(path, dev):
    """{"fused": host launch calls of the stream's first interpolated
    reference through its graph (the copy in, the replay, the copy out),
    "eager": those of interpolate_frames}, warm; None for a stream with no
    interpolated reference, or for a decoder without that graph
    (tools/ab_decode.py runs this module on another tree's decoder)."""
    from ..ops.interp import interpolate_frames
    from .device_decode_fps import capture
    try:
        from ..ops.interp_fused import run_interp
    except ImportError:
        return None
    work, _ = capture(path, dev)
    args = next((f["interp"] for f in work if f["interp"]), None)
    if args is None:
        return None
    interpolate_frames(*args)
    torch.cuda.synchronize()
    return {"fused": profile_run(lambda: run_interp(dev, *args))[5],
            "eager": profile_run(lambda: interpolate_frames(*args))[5]}


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
    n, wall, groups, top, calls = device_profile(args.stream, dev)
    busy = sum(groups.values())
    out = {"stream": args.stream, "card": torch.cuda.get_device_name(0),
           "host": host, "profiled_frames": n, "wall_ms": wall,
           "launch_calls_per_frame": calls / n,
           "interp_launch_calls": interp_launch_calls(args.stream, dev),
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
