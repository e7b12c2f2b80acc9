"""Benchmark: end-to-end 1080p decode and encode throughput on one CUDA card.

    python -m thor_tpu_torch.bench                  # every child: one line
    python -m thor_tpu_torch.bench --child decode   # one child: its JSON line

Counterpart of thor_tpu's bench.py, with its metric of record,
1080p_decode_e2e_fps: the committed 17-frame 1080p LDB golden
(testdata/LDB_medium_complexity_1080.bit) through the whole production
path (the C entropy parse and the input build on the host, the frame
program with kernels 1 and 2, the filters and the copy of every frame to
host memory), gated on the sha256 of its output. vs_baseline divides by
60, the 1080p60 real-time target of BASELINE.md. Each child runs in a
subprocess of its own under bench.py's time limit and prints one JSON line:
  - probe: the card's name and power limit (nvidia-smi); builds the native
    libraries and the CUDA kernels, so no timed child pays for nvcc;
  - decode: a decode hashed against the golden, then a timed one;
  - decode_verify: a decode against the golden that records every frame's
    checksum (dec/decoder.frame_digest_np), one warm and one timed
    `decode_stream(digest=True)` whose checksums, fetched inside the timed
    window, must equal the recorded ones;
  - decode_ra16: as decode, on the 1080p RA16 golden (kernels 3-5 make
    the interpolated references);
  - decode_device: utils/device_decode_fps on the LDB stream (each
    frame's staged inputs dispatched again back to back; gated there);
  - link: utils/link_profile at W*H*3/2 bytes, the floor the copy of
    decoded frames to the host sets;
  - synth: the 1080p synthetic inter frame (utils/synth) through the
    frame program, each frame ended by a fetch of its planes' sum, gated
    on the planes equal to the plain versions' on the CPU;
  - encode: the device encoder on 5 frames, twice in one process, the
    second timed, gated on the port's decoder reading the stream back to
    the encoder's reconstruction;
  - encode_device: utils/device_encode_fps on the same frames (the P
    frames' device work replayed; gated there).
Every child counts the kernels' launches and their plain versions'
calls over its run ("launches", "plain_calls"); the parent writes each
child's line to stderr.

The encoder's input and fields are not bench.py's (`encode_form`):
bench.py reads the reference encoder's config_LDB_low_complexity.txt,
which the repo does not hold, on the generated (uncommitted)
testdata/test_1080.yuv. This bench uses the
fields of utils/device_encode_fps.LDB_1080 (the sequence header of the
1080p LDB golden) on the top-left 1920x1080 crop of the committed
testdata/test_4k.yuv: frames 0-4, all five of the clip (bench.py
encodes 6).

Where it departs from bench.py on purpose: it never falls back to the
CPU. Without a card the probe fails, no other child runs, and the line
has "value": null. A child whose gate fails reports null in its fps keys
and its reason in "error"; so does a child that fails, runs out of time
or prints no JSON. The parent always prints exactly one JSON line, and
exits 0 only when every child that was not switched off (THOR_BENCH_VERIFY,
_RA16, _DEVICE, _LINK, _SYNTH, _ENCODE = "0", as bench.py reads them) ran
and passed its gate.

Each child is also a function with the 1080p inputs as defaults and
`device=None` (the card); the tests call them on the CPU at CIF size.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import native
from .dec.decoder import Decoder, frame_digest_np
from .dec.reconstruct import mc_luts, reconstruct_frame
from .device import resolve_device, synchronize
from .enc.encoder import Encoder, EncoderParams, crop_yuv_frames
from .ops import _build
from .ops import enc_intra as EI
from .ops import interp as TI
from .ops import intra as IT
from .ops import kernels as K
from .ops import mc as MC
from .ops import me_subpel as MS
from .utils import device_decode_fps, device_encode_fps
from .utils.link_profile import measure_link
from .utils.synth import build_synthetic_frame

ROOT = Path(__file__).resolve().parents[1]
TESTDATA = ROOT / "testdata"
BIT = TESTDATA / "LDB_medium_complexity_1080.bit"
RA16_BIT = TESTDATA / "RA16_high_efficiency_1080.bit"
BASELINE_FPS = 60.0             # 1080p60 real time (BASELINE.md)
ENCODE_FRAMES = 5               # all of testdata/test_4k.yuv
ENCODE_FORM = ("utils.device_encode_fps.LDB_1080 (the header of "
               "LDB_medium_complexity_1080.bit: qp 32, two references, "
               "bipred, deblocking, CLPF, block contexts) on frames 0-4 of "
               "the 1920x1080 crop of testdata/test_4k.yuv; bench.py: "
               "config_LDB_low_complexity.txt on 6 frames of "
               "testdata/test_1080.yuv")

KERNELS = ((MC.mc_frame, MC.mc_frame_plain),
           (IT.intra_scan, IT.intra_scan_plain),
           (TI.me_level, TI.me_level_plain),
           (TI.mot_comp, TI.mot_comp_plain),
           (TI.mot_comp_uv, TI.mot_comp_uv_plain),
           (EI.encode_scan, EI.encode_scan_plain),
           (K.rdoq_light, K._rdoq_light),
           (MS.subpel_search, MS._subpel))


# ---------------------------------------------------------------------------
# children: each returns one dict; fps keys are None where a gate failed,
# and "failed" then says which
# ---------------------------------------------------------------------------

def golden_sha256(bit) -> str:
    """The sha256 of a stream's golden decode (<stem>_dec.sha256, or the
    hash of <stem>_dec.yuv)."""
    kind, want = device_decode_fps.golden_of(bit)
    return want if kind == "sha256" else hashlib.sha256(want).hexdigest()


def _decode(bit, dev, collect):
    """(frames, sha256 of the output or None) of one decode."""
    h = hashlib.sha256() if collect else None
    n = 0
    for planes in Decoder(device=dev).decode_stream(str(bit)):
        n += 1
        if collect:
            for p in planes:
                h.update(p.tobytes())
    return n, (h.hexdigest() if collect else None)


def _gated(fps, ok, why):
    return {"fps": round(fps, 2) if ok else None,
            "failed": None if ok else why}


def child_probe(device=None):
    """The card's name and power limit; builds the native libraries and
    the CUDA kernels. Raises without a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the bench measures a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    for name in _build.CUDA_SOURCES:
        _build.cuda_library(name)
    native.lib()
    native.decide_lib()
    return {"backend": "cuda", "device": torch.cuda.get_device_name(dev),
            "power_limit": smi.rsplit(",", 1)[-1].strip(), "smi": smi,
            "build_s": round(time.perf_counter() - t0, 3)}


def child_decode(bit=BIT, want=None, device=None):
    """A decode hashed against the golden (`want`: its sha256, by default
    golden_sha256(bit)), then a timed decode."""
    dev = resolve_device(device)
    want = want or golden_sha256(bit)
    _, digest = _decode(bit, dev, True)
    synchronize(dev)
    t0 = time.perf_counter()
    n2, _ = _decode(bit, dev, False)
    synchronize(dev)
    dt = time.perf_counter() - t0
    ok = digest == want
    return {**_gated(n2 / dt, ok, "the output differs from the golden "
                     "sha256"), "frames": n2, "bit_exact": ok,
            "seconds": dt}


def child_decode_verify(bit=BIT, want=None, device=None):
    """A decode against the golden that records each frame's checksum,
    a warm digest decode, then a timed one whose checksums are fetched to
    the host inside the window and must equal the recorded ones."""
    dev = resolve_device(device)
    want = want or golden_sha256(bit)
    h = hashlib.sha256()
    want_digs = []
    for y, u, v in Decoder(device=dev).decode_stream(str(bit)):
        for p in (y, u, v):
            h.update(p.tobytes())
        want_digs.append(int(frame_digest_np(y, u, v)))
    sha_ok = h.hexdigest() == want
    list(Decoder(device=dev).decode_stream(str(bit), digest=True))
    synchronize(dev)
    t0 = time.perf_counter()
    got = [int(d) for d in Decoder(device=dev).decode_stream(str(bit),
                                                               digest=True)]
    dt = time.perf_counter() - t0
    ok = sha_ok and got == want_digs
    why = ("the output differs from the golden sha256" if not sha_ok else
           "the timed checksums differ from the golden-checked frames'")
    return {**_gated(len(got) / dt, ok, why), "frames": len(got),
            "verified": ok, "digests": got, "seconds": dt}


def child_decode_ra16(bit=RA16_BIT, want=None, device=None):
    """child_decode on the 1080p RA16 golden: kernels 3-5 make its
    interpolated references."""
    return child_decode(bit, want, device)


def child_decode_device(bit=BIT, device=None):
    """utils/device_decode_fps.measure, best of 3 rounds: raises where the
    replay differs from the golden."""
    r = device_decode_fps.measure(bit, 3, device)
    return {"fps": round(r["device_fps"], 2), "frames": r["frames"],
            "seconds": r["seconds"],
            "host_waits_per_frame": r["host_waits_per_frame"]}


def child_link(device=None):
    """utils/link_profile.measure_link of a 1080p frame; raises off the
    card."""
    return measure_link(1920 * 1080 * 3 // 2, device)


def child_synth(W=1920, H=1080, device=None):
    """The synthetic inter frame (two references) through the frame
    program: 2 frames, then the best of 3 rounds of 8 frames, each frame
    ended by a fetch of its planes' sum (bench.py's loop). Gate: the
    planes equal the plain versions' on the CPU."""
    dev = resolve_device(device)
    iters = 8
    cfg, inp, refs = build_synthetic_frame(W, H, device=dev)
    luts = mc_luts(0, dev)

    def frame():
        planes, _ = reconstruct_frame(cfg, inp, refs, luts)
        return planes

    def summed():
        return int(sum(p.sum() for p in frame()))

    got = frame()
    cpu = torch.device("cpu")
    cfg_c, inp_c, refs_c = build_synthetic_frame(W, H, device=cpu)
    want, _ = reconstruct_frame(cfg_c, inp_c, refs_c, mc_luts(0, cpu))
    ok = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    sums = {summed() for _ in range(2)}
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            sums.add(summed())
        best = min(best, time.perf_counter() - t0)
    ok = ok and len(sums) == 1
    return {**_gated(iters / best, ok, "the synthetic frame differs from "
                     "its plain versions"), "sum": min(sums),
            "equal_to_plain": ok}


def encode_frames():
    """The ENCODE_FRAMES frames of the 1920x1080 crop of
    testdata/test_4k.yuv."""
    return crop_yuv_frames(*device_encode_fps.INPUT_4K, 1920, 1080,
                           ENCODE_FRAMES)


def child_encode(frames=None, fields=None, device=None):
    """The device encoder on `frames` (default encode_frames()) with
    EncoderParams.in_code(**fields) (default LDB_1080), twice in one
    process, the second timed. Gate: the port's decoder reads the stream
    back to the encoder's reconstruction."""
    dev = resolve_device(device)
    frames = encode_frames() if frames is None else frames
    fields = device_encode_fps.LDB_1080 if fields is None else fields
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "bench.bit")

        def run():
            enc = Encoder(EncoderParams.in_code(
                **{**fields, "num_frames": len(frames)}), device=dev)
            synchronize(dev)
            t0 = time.perf_counter()
            recons = enc.encode_sequence(frames, out)
            synchronize(dev)
            return time.perf_counter() - t0, recons

        run()
        dt, recons = run()
        got = list(Decoder(device=dev).decode_stream(out))
        stream = Path(out).read_bytes()
    ok = len(got) == len(recons) and all(
        np.array_equal(a, b) for f, g in zip(recons, got)
        for a, b in zip(f, g))
    return {**_gated(len(frames) / dt, ok, "the stream does not decode to "
                     "the encoder's reconstruction"), "frames": len(frames),
            "decodes_back": ok, "bytes": len(stream),
            "sha256": hashlib.sha256(stream).hexdigest(), "seconds": dt}


def child_encode_device(frames=None, fields=None, device=None):
    """utils/device_encode_fps.measure on child_encode's frames and
    fields, best of 3 rounds: raises where a replayed frame differs from
    the live one."""
    device = resolve_device(device)
    frames = encode_frames() if frames is None else frames
    fields = device_encode_fps.LDB_1080 if fields is None else fields
    r = device_encode_fps.measure(frames, fields, 3, device)
    return {"fps": round(r["device_fps"], 2), "frames": r["frames"],
            "seconds": r["seconds"], "encode_seconds": r["encode_seconds"],
            "host_waits_per_frame": r["host_waits_per_frame"]}


CHILD_FNS = {"probe": child_probe, "decode": child_decode,
             "decode_verify": child_decode_verify,
             "decode_ra16": child_decode_ra16,
             "decode_device": child_decode_device, "link": child_link,
             "synth": child_synth, "encode": child_encode,
             "encode_device": child_encode_device}


def run_counted(name):
    """One child on the card with every kernel counter set to 0 just
    before and read just after; its dict with "launches" and
    "plain_calls"."""
    for k, p in KERNELS:
        k.launches = p.calls = 0
    out = CHILD_FNS[name]()
    out["launches"] = {k.__name__: k.launches for k, _ in KERNELS}
    out["plain_calls"] = {p.__name__: p.calls for _, p in KERNELS}
    return out


# ---------------------------------------------------------------------------
# the parent: never touches the device; one subprocess per child
# ---------------------------------------------------------------------------

PROBE_TIMEOUT = 900
# child, the variable that switches it off ("0"), its time limit in s
CHILDREN = (("decode", None, 2400),
            ("decode_verify", "THOR_BENCH_VERIFY", 2400),
            ("decode_ra16", "THOR_BENCH_RA16", 2400),
            ("decode_device", "THOR_BENCH_DEVICE", 1200),
            ("link", "THOR_BENCH_LINK", 900),
            ("synth", "THOR_BENCH_SYNTH", 900),
            ("encode", "THOR_BENCH_ENCODE", 2400),
            ("encode_device", "THOR_BENCH_ENCODE", 2400))


def _vs(fps):
    return None if fps is None else round(fps / BASELINE_FPS, 3)


# child -> the line's keys from its dict
KEYS = {
    "decode": lambda r: {"value": r["fps"], "vs_baseline": _vs(r["fps"]),
                         "bit_exact": r["bit_exact"], "frames": r["frames"]},
    "decode_verify": lambda r: {"decode_e2e_verify_fps": r["fps"],
                                "decode_verify_ok": r["verified"]},
    "decode_ra16": lambda r: {"ra16_1080_decode_fps": r["fps"],
                              "ra16_1080_bit_exact": r["bit_exact"]},
    "decode_device": lambda r: {"decode_device_fps": r["fps"],
                                "decode_device_vs_baseline": _vs(r["fps"])},
    "link": lambda r: {"link_floor_fps": r["link_floor_fps"],
                       "d2h_MBps": r["d2h_MBps"], "h2d_ms": r["h2d_ms"]},
    "synth": lambda r: {"synthetic_inter_device_fps": r["fps"]},
    "encode": lambda r: {"1080p_encode_e2e_fps": r["fps"]},
    "encode_device": lambda r: {"encode_device_fps": r["fps"],
                                "encode_device_vs_baseline": _vs(r["fps"])},
}
LINE_KEYS = ("metric", "value", "unit", "vs_baseline", "backend", "device",
             "power_limit", "bit_exact", "frames", "decode_e2e_verify_fps",
             "decode_verify_ok", "ra16_1080_decode_fps", "ra16_1080_bit_exact",
             "decode_device_fps", "decode_device_vs_baseline",
             "link_floor_fps", "d2h_MBps", "h2d_ms", "e2e_pct_of_link_floor",
             "synthetic_inter_device_fps", "1080p_encode_e2e_fps",
             "encode_device_fps", "encode_device_vs_baseline", "encode_form")


def _run_child(name, timeout, env):
    """Run `python -m thor_tpu_torch.bench --child <name>`; return (its
    dict, None) or (None, the reason it gave none)."""
    try:
        r = subprocess.run(
            [sys.executable, "-m", "thor_tpu_torch.bench", "--child", name],
            capture_output=True, text=True, timeout=timeout, env=env,
            cwd=str(ROOT))
    except subprocess.TimeoutExpired:
        return None, f"{name}: timeout after {timeout}s"
    if r.returncode != 0:
        tail = (r.stderr or r.stdout or "").strip().splitlines()[-3:]
        return None, f"{name}: rc={r.returncode}: " + " | ".join(tail)
    for line in reversed((r.stdout or "").strip().splitlines()):
        if line.strip().startswith("{"):
            try:
                return json.loads(line), None
            except json.JSONDecodeError:
                continue
    return None, f"{name}: no JSON in output"


def _log(*a):
    print("[bench]", *a, file=sys.stderr, flush=True)


def main(argv=None):
    """Run the children; print one JSON line; return the exit code (0:
    every child that was not switched off ran and passed its gate)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", choices=sorted(CHILD_FNS),
                    help="run one child on the card and print its line")
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(run_counted(args.child)), flush=True)
        return 0

    env = dict(os.environ)
    out = dict.fromkeys(LINE_KEYS)
    out.update(metric="1080p_decode_e2e_fps", unit="frames/s",
               backend="cuda", encode_form=ENCODE_FORM)
    notes = []
    probe, err = _run_child("probe", PROBE_TIMEOUT, env)
    if probe is None:
        notes.append(f"the probe found no usable CUDA card: {err}; no "
                     "child ran")
    else:
        _log("child probe", json.dumps(probe))
        out.update(device=probe["device"], power_limit=probe["power_limit"])
        for name, switch, timeout in CHILDREN:
            if switch and os.environ.get(switch, "1") == "0":
                continue
            t0 = time.perf_counter()
            r, err = _run_child(name, timeout, env)
            if r is None:
                notes.append(err)
                _log(f"child {name} failed after "
                     f"{time.perf_counter() - t0:.1f} s: {err}")
                continue
            _log("child", name, json.dumps(r))
            out.update(KEYS[name](r))
            if r.get("failed"):
                notes.append(f"{name}: {r['failed']}")
        if out["value"] and out["link_floor_fps"]:
            out["e2e_pct_of_link_floor"] = round(
                100.0 * out["value"] / out["link_floor_fps"], 1)
    if notes:
        out["error"] = "; ".join(notes)
    print(json.dumps(out), flush=True)
    return 1 if notes else 0


if __name__ == "__main__":
    sys.exit(main())
