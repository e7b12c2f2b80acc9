"""Device-only decode throughput of a stream.

    python -m thor_tpu_torch.utils.device_decode_fps [stream.bit]
        [--reps N] [--device cpu] [--eager] [--json out]

Counterpart of thor_tpu's tools/device_decode_fps.py. A first pass
decodes the stream serially (the C parse, dec/inputs.build_frame_inputs)
and keeps, per frame, its inputs staged on the device, the reference
planes it reads and, on a frame that predicts from an interpolated
reference, the arguments of ops/interp.interpolate_frames. Then every
frame is dispatched again back to back as the Decoder dispatches it:
the interpolated reference where the frame needs it (kernels 3-5), then
the frame program (kernels 1 and 2): by default
ops/interp_fused.run_interp and dec/fused.run_frame (the references and
the packed inputs, bucketed, copied into the CUDA graphs of their
signatures, which are replayed; the first pass captures every
signature), with --eager ops/interp.interpolate_frames and
dec/reconstruct.reconstruct_frame; one wait for the device at the end.
The host's parse, input build and output copies are out of the clock:
the number is what the card sustains when the host keeps up.

Gate: the planes of the last timed repeat, in display order, equal the
stream's golden (testdata/<stream>_dec.yuv or _dec.sha256); the hash is
taken after the clock stops. Without that, no number is reported. The
calls that make the host wait for the card during one untimed repeat are
counted (utils/tracing.host_waits) and reported per frame with their
sites. Unlike thor_tpu's tool, RA / RA16 / HDB streams are replayed with
their interpolated references. Prints one JSON object; the stream
defaults to testdata/LDB_medium_complexity_1080.bit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from itertools import chain
from pathlib import Path

import torch

from ..bitstream.reader import BitReader, iter_frames
from ..codec.constants import MAX_REF_FRAMES, PAD_C, PAD_Y
from ..dec import fused as F
from ..dec.decoder import RefFrame, interp_pair, needs_interp
from ..dec.inputs import build_frame_inputs
from ..dec.parse import SequenceHeader
from ..dec.reconstruct import mc_luts, reconstruct_frame, to_device
from ..device import resolve_device, synchronize
from ..native import parse_frame, seqhdr_from_python
from ..ops import graphs as G, interp
from ..ops.interp_fused import run_interp, signature
from .tracing import host_waits

TESTDATA = Path(__file__).resolve().parents[2] / "testdata"
DEFAULT = str(TESTDATA / "LDB_medium_complexity_1080.bit")


def capture(path, dev, fused=True):
    """The first pass: decode serially and keep every frame's work as a
    dict {dfn, cfg, inp (on dev: with `fused` the bucketed PackedFrame,
    else the input dict), refs (per slot; None for the interpolated
    reference), interp (interpolate_frames' arguments or None)}, in
    decode order, with the stream's MC LUTs on dev."""
    payloads = iter_frames(str(path))
    first = next(payloads)
    br = BitReader(first)
    seq = SequenceHeader.read(br)
    cs = seqhdr_from_python(seq)
    H, W = seq.height, seq.width
    zero = RefFrame(*(torch.zeros((h + 2 * p, w + 2 * p), dtype=torch.uint8,
                                  device=dev)
                      for h, w, p in ((H, W, PAD_Y), (H // 2, W // 2, PAD_C),
                                      (H // 2, W // 2, PAD_C))), 0)
    refs = [zero] * MAX_REF_FRAMES
    luts = mc_luts(seq.bipred, dev)
    work = []
    pos = br.pos
    for payload in chain([first], payloads):
        nums = [r.frame_num for r in refs]
        nf = parse_frame(payload, pos, cs, nums)
        pos = 0
        cfg, inp, slots = build_frame_inputs(nf, seq, nums)
        fh = nf.hdr
        if fused:
            inp = F.pack_frame(cfg, F.bucket_inputs(cfg, inp), seq.bipred) \
                .to(dev)
        else:
            inp = to_device(inp, dev)
        f = {"dfn": fh.display_frame_num, "cfg": cfg, "inp": inp,
             "refs": [refs[r] if r >= 0 else None for r in slots],
             "interp": interp_pair(refs, fh) if needs_interp(fh) else None}
        work.append(f)
        _, padded = dispatch(f, luts)
        refs = [RefFrame(*padded, f["dfn"])] + refs[:-1]
    return work, luts


def dispatch(f, luts):
    """Queue one captured frame: its interpolated reference (kernels 3-5)
    where it needs one, then its frame program (graph replays of both for
    a PackedFrame). Returns reconstruct_frame's (planes, padded
    planes)."""
    refs = f["refs"]
    fused = isinstance(f["inp"], F.PackedFrame)
    if f["interp"] is not None:
        out = run_interp(f["inp"].buf.device, *f["interp"]) if fused \
            else interp.interpolate_frames(*f["interp"])
        ir = RefFrame(out[3], out[4], out[5], f["dfn"])
        refs = [ir if r is None else r for r in refs]
    if fused:
        return F.run_frame(f["inp"].buf.device, f["inp"], refs)
    return reconstruct_frame(f["cfg"], f["inp"], refs, luts)


def golden_of(path):
    """(kind, value) of a stream's golden: ("yuv", bytes) or ("sha256",
    hex digest)."""
    path = Path(path)
    yuv = path.with_name(path.stem + "_dec.yuv")
    if yuv.exists():
        return "yuv", yuv.read_bytes()
    return "sha256", path.with_name(path.stem + "_dec.sha256") \
        .read_text().split()[0]


def measure(path=DEFAULT, reps=3, device=None, fused=True):
    """Re-dispatch every frame of the stream back to back `reps` times
    after one untimed repeat that counts the host waits. Returns a dict:
    frames, the seconds of each timed repeat, device_fps (frames over the
    best repeat), the host waits per frame and their sites; with `fused`
    the frame signatures and the captures the first pass made (with their
    host ms, and the interpolated reference's signatures). Raises when
    the last repeat's planes differ from the golden."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    stats0 = dict(G.STATS)
    work, luts = capture(path, dev, fused)
    n = len(work)
    with host_waits(dev) as sites:
        for f in work:
            dispatch(f, luts)
    synchronize(dev)
    secs = []
    for _ in range(reps):
        synchronize(dev)
        t0 = time.perf_counter()
        out = [(f["dfn"], dispatch(f, luts)[0]) for f in work]
        synchronize(dev)
        secs.append(time.perf_counter() - t0)
    data = b"".join(p.cpu().numpy().tobytes()
                    for _, planes in sorted(out, key=lambda o: o[0])
                    for p in planes)
    kind, want = golden_of(path)
    got = data if kind == "yuv" else hashlib.sha256(data).hexdigest()
    if got != want:
        raise AssertionError(f"{path}: the replayed planes differ from the "
                             f"golden ({kind})")
    waits = sum(sites.values())
    return {"stream": str(path), "frames": n, "reps": reps,
            "seconds": secs, "device_fps": n / min(secs),
            "interp_frames": sum(f["interp"] is not None for f in work),
            "host_waits_per_frame": waits / n,
            "host_wait_sites": {f"{a}:{b}": c for (a, b), c in
                                sorted(sites.items())},
            "golden": kind, "device": str(dev), "fused": fused,
            "signatures": len({f["inp"].sig for f in work}) if fused
            else None,
            "interp_signatures": len({signature(*f["interp"])[0]
                                      for f in work if f["interp"]})
            if fused else None,
            "captures": G.STATS["captures"] - stats0["captures"],
            "capture_ms": G.STATS["capture_ms"] - stats0["capture_ms"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("stream", nargs="?", default=DEFAULT)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cpu runs the kernels' plain versions")
    ap.add_argument("--eager", action="store_true",
                    help="the frame program stage by stage, no CUDA graph")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    r = measure(args.stream, args.reps, args.device, not args.eager)
    if r["device"].startswith("cuda"):
        r["card"] = torch.cuda.get_device_name(0)
    s = json.dumps(r)
    if args.json:
        Path(args.json).write_text(s + "\n")
    print(s)


if __name__ == "__main__":
    main()
